#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases, one line each (the script stops with a non-zero exit at the first
phase that fails, and then prints no result line):

1. device: the ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile every CUDA kernel of the port from ``csrc/`` (one nvcc per
   source, all at once, sm_90a); each tensor-core kernel's (flash attention's
   and the grouped matmul's) and each RWKV-6 kernel's registers, spills,
   shared memory and resident blocks per SM, and each tensor-core kernel's
   count of TF32 tensor-core instructions in the SASS (``cuobjdump``; none
   fails the phase; the RWKV-6 kernels run on the CUDA cores); the bf16
   kernels' registers and spills, the count of bf16 ``HMMA``/``HGMMA`` in
   the flash and tile kernels' SASS (none fails the phase; the flash
   kernels and the tile kernel, on ``wgmma``, must show ``HGMMA``), no
   spill in the small-group ones, the tile kernel, nor the flash kernels at
   D = 64 and 128;
3. kernels: first the device time of the library's empty kernel, the
   launch floor under the latency-bound kernels; then hold each kernel
   against its plain PyTorch version on the card and time kernel, plain
   version, bound and (for attention) the
   ``scaled_dot_product_attention`` yardstick: GAE (its scan order printed)
   at the LM path's [32, 8], CartPole's [64, 8], an APPO rollout's [32, 4],
   [128, 4096], a ragged [33, 1001], T = 1 at [1, 8], [1000, 4] (eight
   tiles), MAML's [16, 2], the multi-agent [16, 4] and MBPO's synthetic
   [8, 128], each bitwise equal across two calls; V-trace at the IMPALA learner's
   [32, 16] and the many-lane learner's [32, 512], at [128, 4096], a ragged
   [33, 1001], trailing dims [16, 8, 2], T = 1, and with clips 2.0 / 0.5;
   the surrogate forward + autograd
   backward at [128, 151936] (the LM learner's vocabulary), CartPole's
   [256, 2], the APPO learner's [512, 2], the multi-agent PPO branch's
   [128, 2], [65536, 18], [16, 151937] (rows
   not 16-byte aligned), [8, 1024] (one chunk a row) and [3, 4097], with
   rows whose ratio is exactly 1 and rows exactly on the clip boundary, the
   forward bitwise equal across two calls, its grid and chunks printed and,
   at a vocabulary's width, ``torch.logsumexp`` over the same logits timed
   beside it (``logsumexp_ms``: one read of the same bytes, not the same
   function), the backward fed the forward's saved row logsumexp and
   entropy and timed alone;
   decode attention at the RLHF path's [8, 1, 20, 128] x
   W = 256 with a ragged per-lane mask and with a wrapped ring-buffer mask,
   GQA 40/8 at W = 4096, an all-invalid row (exact zeros) and a ragged W,
   each bitwise equal across two calls, with the splits and grid the
   wrapper chose; flash attention forward at
   the learner's [128, 256, 20, 128], the bootstrap's [256, 256, 20, 128],
   the prefill's sliding window, GQA 40/8 at S = 2048 with a 512 window and
   with a q_offset, a ragged S, and Phi-3.5-MoE's [2, 4096, 32/8, 128]; its
   backward at [128, 256, 20, 128], [4, 512, 20, 128], GQA [2, 1024, 40/8,
   128], Phi's [2, 4096, 32/8, 128], GQA 40/8 at S = 2048 with a 512 window
   and with a q_offset; both at D = 64 and D = 32 (GQA with a ragged S, a
   non-causal case with Sq != Sk, a window with a q_offset), each with the
   3xTF32 bound and the fp32 CUDA-core bound beside it; the RWKV-6
   recurrence forward and backward (gradients of r, k, v, w, u and the start state against autograd
   through the plain loop, and bitwise equal across two runs) at the
   pretraining path's [2, 4096, 64, 64] without and with a start state, a
   ragged T = 1000, with a start state at [2, 300, 8, 64], at narrow
   [4, 256, 8, 32] and [2, 512, 4, 16] heads, and with half the decays at
   the model's clip extremes (exp(-e^2) and exp(-e^-8)); the path-shape case
   read by both clocks before and after the profiler, with the card's SM
   clock, power and temperature beside them; the MoE grouped matmul and
   the dX and dW products of its backward (dW bitwise equal across two runs)
   at the path's two products ([20480, 4096] x [16, 4096, 6400] and
   [20480, 6400] x [16, 6400, 4096], beside ``torch.bmm`` and the einsums of
   ``GmmMatmul``'s backward they replace), ragged unequal groups (an empty
   one, groups summing past x's rows, rows past the last group), and a group
   that is not a multiple of 64, each with the 3xTF32 and the fp32 bound;
   each time of the Phi-3.5-MoE path's grouped-matmul and flash-backward
   cases read by both clocks before and after the profiler, with the card's
   SM clock, power and temperature beside them; flash forward and backward
   at Qwen3-14B's [2, 4096, 40/8, 128];
3b. threefry: the hash kernel (``csrc/threefry.cu``) bitwise equal to its
   plain int64 chain on the card and to the CPU, and across two calls,
   hashing counters at [8, 4] (PPO CartPole's resets), [1, 2], [8, 2],
   [256, 2], [4096, 2], PPO-LM's [8, 151936] and [1, 2^20], as bits and as
   split keys, and at keys read in place through a split's stride, and
   ``fold_in`` at [256] (one key or one word broadcast too); device ms, the
   plain chain's, and the bound (79 int32 operations a hash); one launch a
   hash through every ``repro_torch.prng`` draw; keyed token sampling at
   [8, 151936] timed beside ``torch.multinomial`` and PR 23's op chain;
4. learner parity: four PPO SGD steps on one CartPole batch on the card
   (kernels) and on the CPU (plain versions) from the same weights agree to
   1e-4;
5. main path 1: PPO on CartPole through ``WorkerSet.create`` ->
   ``Algorithm.from_plan("ppo")`` -> ``ITERS`` ``train()`` iterations with
   the configuration of ``examples/ppo_cartpole.py`` (2 workers, 8 envs x 64
   steps, 1024-row train batch, 4 SGD epochs of 256-row minibatches), launch
   counters zeroed just before and read just after, checked against what
   the configuration implies;
6. LM learner parity: one ``learn_on_batch`` (SGD, lr 1) of an
   ``LMTokenPolicy`` at a reduced width (d_model 256, 4 heads, 2 KV heads,
   ctx 64, 2 layers) on the card and on the CPU from the same weights
   agrees to 1e-4;
7. main path 2: PPO on a language model (``build_ppo_lm``) at Qwen1.5-4B's
   attention and vocabulary widths cut to 2 layers, through
   ``Algorithm.from_plan("ppo_lm")``, ``RLHF_ITERS`` ``train()`` iterations
   with KV-cache rollouts; counters zeroed just before and read just after
   and checked against the configuration, the decode-vs-forward logits gap,
   peak memory, seconds per iteration and the device's idle share, and the
   device ms per decode step of the KV-cache rewrite beside the decode
   attention kernel's, from a profile of one rollout;
8. V-trace learner parity: one ``learn_on_batch`` (SGD, lr 1) of an IMPALA
   worker on a 512-row batch concatenated from 4 samples, on the card and
   on the CPU from the same weights, agrees to 1e-4;
9. main path 3: IMPALA (``Algorithm.from_plan("impala")``) at the
   configuration of ``examples/impala_vtrace.py`` (3 workers x 4 envs x 32
   steps, 512-row train batch, ``num_async`` 2): asynchronous rollouts, a
   learner thread and the weight-broadcast gate, ``train()`` under a
   deadline until the learner has taken ``min_steps`` steps, the learner
   thread checked alive after every iteration, one profiled window, then
   ``stop()`` and no thread of the flow left alive; launches checked
   against the learner's own step count (V-trace once per step, no GAE);
10. main path 4: APPO (``Algorithm.from_plan("appo")``), the same with PPO
   workers (surrogate forward and backward once per learner step, GAE once
   per rollout the workers ran);
11. main path 5: IMPALA with many lanes: ``VectorizedRolloutWorker``s with
   256 lanes, 2 workers x 32 steps, 16,384-row train batch;
12. main path 6: A2C (``Algorithm.from_plan("a2c")``) at
   ``examples/quickstart.py``'s workers (2 'pg' workers, 4 CartPole envs x
   32 steps), after ``AverageGradients`` over two CUDA gradient trees from
   the thread backend's actors is checked exact: 6 ``train()`` iterations
   under a deadline, the last one profiled, result keys and counters as on
   the reference, every worker on the learner's weights after the
   broadcast, GAE launched exactly once a gradient (iterations x workers)
   and no other kernel;
13. main path 7: A3C on the same workers: GAE launched at least once an
   applied gradient, and at most once more a worker (gradients in flight);
14. off-policy learner parity: 8 ``learn_on_batch`` steps (SGD, lr 0.01) of
   a DQN and of a SAC learner on one replayed batch on the card and on the
   CPU from the same online and target weights (SAC with the same two
   noises a step injected) end with weights within 1e-4, and each step's
   stats agree to 1e-4 with a CPU twin given the card's weights before the
   step, ``td_error`` as host numpy; the stats along the two runs are
   printed beside them, not gated (they follow the weights' drift);
15. main path 8: DQN (``build_dqn``) at ``benchmarks/common.py``'s workers
   (2 workers, 4 envs x 16 steps, epsilon 0.2) with one replay buffer at
   ``examples/apex_dqn.py``'s settings (50,000 rows, batches of 64, 1,000
   rows before learning, prioritized), until the target network has synced
   twice; the buffer sampled and priorities updated, no kernel launched;
16. main path 9: Ape-X (``build_apex``) at ``examples/apex_dqn.py``'s
   configuration (3 workers on an epsilon ladder, 2 replay actors, target
   sync every 2,000 rows) until its learner thread has taken 40 steps, the
   thread checked alive after every ``train()``, a profiled window of at
   least 1 s, then ``stop()`` joins it and no thread of the flow is left;
17. main path 10: SAC (``build_sac``) on Pendulum (2 workers, 4 envs x 16
   steps, polyak 0.01) until the target has synced 8 times, losses finite;
18. flowcheck: ``audit_plans(device="cuda")`` over the port's 12 plans on
   CUDA workers: no error, and ``apex``, ``appo`` and ``impala`` each give
   exactly the reference's ``["unbounded-queue"]``;
19. pretraining learner parity: one ``learn_on_batch`` (SGD, lr 1) of the
   LM pretraining learner at the reduced configuration of RWKV-6 and of
   Phi-3.5-MoE (float32), on the card and on the CPU from the same weights,
   agrees to 1e-4, after checking that every token routes to the same
   experts on both devices;
20. main path 11: LM pretraining (``launch/train.py``: ``make_pretrain`` ->
   ``build_lm_flow`` -> ``Algorithm.from_plan``) of RWKV-6 7B at its
   published widths cut to 2 layers, 4 ``train()`` steps of 2 x 4,096
   tokens under a deadline, launches read per step and checked against the
   configuration (every other kernel 0), losses finite and within 0.5 of
   ln V + sigma^2 / 2 (uniform tokens under the initial logits), peak
   memory, seconds per step, tokens per second and the idle share of the
   profiled last step;
21. main path 12: the same for Phi-3.5-MoE 42B (16 experts, top-2) cut to 2
   layers;
21b. zoo parity: phase 19's learner parity at the reduced Qwen1.5-32B,
   Nemotron-4 15B, DeepSeek-V2-Lite, Jamba, LLaVA-NeXT and MusicGen (the
   routing probe on the MoE ones first);
21c. the model zoo's pretraining paths, each as phase 20 with ``ZOO_STEPS``
   steps and launches read per step against what its layers imply (MLA and
   Mamba launch no kernel): DeepSeek-V2-Lite 16B cut to its dense prologue +
   one MoE block (64 experts, top-6, 2 shared; MLA through the plain chunked
   attention), Jamba 52B cut to entries 2-3 of its block (Mamba + dense,
   attention + MoE with 16 experts of 14,336) at 1 x 4,096 tokens, LLaVA-NeXT
   34B (2 x (2,880 media + 1,216 text), the loss over text) and MusicGen
   large (2 x 4,096 x 4 codebooks), each at its published widths;
21d. the model zoo's serving paths: ``make_prefill_step`` on a 2 x 512
   prompt then 16 ``make_decode_step`` calls at published widths cut to 2
   layers (float32, MoE at capacity factor 8) for DeepSeek-V2-Lite (MLA's
   latent cache), Jamba (Mamba state, attention and MoE), RWKV-6 7B,
   Qwen1.5-32B with the int8 KV cache, Nemotron-4 15B, MusicGen (tokens [B,
   1, 4]) and LLaVA-NeXT (2,880 media before the prompt): each step's logits
   within 1e-4 x max |logits| of one full forward's, the int8 case's within
   0.05 of its float32 cache's run and its cache under 0.6 x the bytes,
   launches exact (flash once an attention layer in the prefill, decode
   attention once an attention layer a step, RWKV-6 once a layer in the
   prefill, the grouped matmul three times an MoE layer in the prefill and
   in each step);
22. plan learner parity, card vs CPU from the same weights: the
   multi-agent worker's ``learn_on_batch`` for ``"ppo_policy"`` (the
   surrogate kernels at [128, 2]) and ``"dqn_policy"`` (a replayed batch),
   8 SGD steps each, and the model-based worker's ``train_dynamics`` over
   both ensemble members, 8 steps: weights and stats within 1e-4 (stats
   absolute below 1, relative above); the synthetic rollout's core on
   injected actions at [8, 128], each step's columns within 1e-5, its
   advantages and returns (the GAE kernel on the card) within 1e-5 of the
   plain loop on the card's own columns and within 1e-4 of the CPU's;
23. main path 13: MAML (``build_maml``) at ``tests/test_plans.py``'s pg
   workers (2 remote, 2 envs x 16 steps, one inner step): 6 ``train()``
   iterations under a deadline, every remote worker on the meta weights
   after each, GAE launched twice a worker an iteration and no other kernel;
24. main path 14: MBPO (``build_mbpo``) at ``examples/mbpo_model_based.py``'s
   workers (4 envs x 32 steps, an ensemble of 2, synthetic rollouts of 8
   steps from 128 replayed states) and replay (256-row batches after 512
   rows, uniform, ``model_train_weight`` 2): GAE launched once a real and
   once a synthetic rollout, read from the counters, ``dyn_losses`` finite;
25. main path 15: the PPO+DQN composition (``build_multi_agent_ppo_dqn``)
   at ``benchmarks/common.py``'s multi-agent workers (2 workers, 4 CartPole
   agents, 2 a policy, 16 steps) with ``benchmarks/bench_multiagent.py``'s
   plan (PPO batches of 128, target sync every 500 rows, replay batches of
   32 after 64 rows): GAE once a rollout at [16, 4], the surrogate forward
   and backward once a PPO step, PPO info keyed by policy id, DQN's
   ``td_error`` host numpy, the replay filled; each of phases 23-25 reports
   the first iteration apart, the mean after it, the idle share of a
   profiled window and no flow thread alive after ``stop()``, and reads
   all 12 launch counters;
26. Fig 12 on the card, printed and not gated: PPO-only, DQN-only and
   composed iterations per second on the multi-agent workers, and the
   composed pair rate's fraction of 1 / (1 / r_ppo + 1 / r_dqn), as
   ``benchmarks/bench_multiagent.py`` computes it;
27. Fig 13b on the card, printed and not gated: steps trained per second of
   ``build_a3c`` and of the hand-written ``rl/lowlevel.py`` ``a3c_lowlevel``
   on ``benchmarks/common.py``'s pg workers, as
   ``benchmarks/bench_async_opt.py`` computes it;
28. keys: ``repro_torch.prng``'s splits, fold-ins, bits, uniforms and
   ``randint`` for 4,096 lane keys bitwise equal on the card and the CPU,
   ``categorical`` on identical logits picking identical actions at
   [4096, 2] and PPO-LM's [8, 151936], and keyed token sampling at that
   width timed beside the one-generator ``torch.multinomial`` it replaced;
29. serving: ``launch/serve.py``'s ``build_serving_tier`` on the card for
   the stateless, ac and ssm policies at 1 and 3 replicas, warmed by
   ``warm_replicas``, then ``open_loop_load`` at the CLI's defaults (200
   req/s, 200 requests, 8 lanes, 2 clients): req/s, lane steps/s, p50, p99
   and mean latency; ``benchmarks/bench_serve.py``'s four properties, each
   failing the phase (bit parity of the 3-replica stateless tier with one
   local dispatch, sticky pins through the SSM soak, 1 of 3 replicas killed
   under ``drop_shard`` dropping only in-flight requests and the tier healed
   to 2, p99 <= 100 x p50 + 50 ms); and the ac and ssm tiers at 3 replicas
   against one whole-batch dispatch (actions equal, log-probs and values
   within 1e-5, whether bitwise printed);
30. Mamba parity: ``SSMStatePolicy`` card vs CPU from the same weights and
   keys over 16 decode steps of 64 lanes: a step from the same state within
   1e-5, each device's own carried state within 1e-4 after 16 steps,
   actions equal throughout;
31. transformer learner parity: one ``learn_on_batch`` (SGD, lr 1) of a
   ``TransformerPolicy`` PPO learner on 512 rows, card vs CPU, within 1e-4;
32. main path 16: PPO with ``TransformerPolicy`` (d_model 64, 2 layers, 4
   tokens) on CartPole and ``inference="server"``: 2 workers of 8 lanes, 3
   replicas behind the sticky router, 5 ``train()`` iterations under a
   deadline, the last profiled; every launch count checked exactly against
   the routers' dispatches, the rollouts and the SGD steps (flash forward a
   layer for each dispatch, bootstrap and SGD step, flash backward a layer
   and the surrogate forward and backward for each SGD step, GAE for each
   rollout, every other kernel 0);
33. determinism: StubEnv + DummyPolicy, 2 workers x 4 lanes x 8 steps, 2
   rounds through ``ParallelRollouts`` on the card: the vectorized stream
   bitwise equal to ``PerEnvRolloutWorker``'s, and to the vectorized stream
   run on the CPU but for rewards, advantages and returns (tanh, the GAE
   kernel: within 1e-5); six threefry launches a vectorized step;
34. durability: PPO CartPole on vectorized workers (SGD) for 2 iterations,
   ``Algorithm.save``, 2 more; a fresh Algorithm ``restore``d runs the same
   2 with equal counters and losses within 1e-6, each remote worker's next
   sample bitwise equal; DQN with 2 replay actors restored with equal
   counters and replay stats, training on;
35. Qwen3-14B restart at bf16, the driver's dtype: ``launch/train.py``'s
   ``main`` with ``--arch qwen3-14b --layers 2 --checkpoint`` (2 steps of
   2 x 4,096 tokens), its file read back by ``restore_pytree``; then a
   learner's 2 steps, ``save_pytree`` of its parameters and optimizer state,
   2 more steps, and a fresh learner restored from the file holding every
   saved leaf bit for bit and giving the same 2 losses within 1e-5.
37. runtime across processes and hosts (under its own deadline): phase 33's
   stream through the thread backend, process children (pickle and
   shared-memory transports, started from the fork server) and a
   driver-managed host (socket frames), bitwise equal to phase 33's; phase
   5's PPO CartPole (2 workers, ``ITERS`` iterations) on the same four, each
   worker's first sample bitwise equal to the thread run's, the learner's
   weights within 1e-5 of it, the children's GAE and threefry launches read
   by RPC (``_ChildProbe``) and the driver's surrogate and threefry launches
   exactly what the configuration implies, CUDA tensors across each boundary
   bitwise on cuda:0; a process worker's OS process killed under
   ``restart`` (the replacement builds its CUDA context and the stream goes
   on) and the host killed under ``drop_shard`` (its 2 shards dropped,
   training goes on); no shared-memory segment left.  Printed, not gated:
   seconds to start a child (fork server and spawn) and to restart one,
   seconds per PPO iteration on each backend, bytes a batch and a weight
   sync put on the boundary, and the card's idle share (the driver's and
   the children's kernels, each process profiled by its own window);
38. learner group (``rl/learner_group.py``): phase 7's PPO-LM worker
   (Qwen1.5-4B widths, 2 layers) learns one rollout's batch once by its own
   ``learn_on_batch`` and once through ``ShardedLearnerGroup(microbatch=2)``
   from the same weights: stats and every weight within 1e-4, each one's
   peak memory and seconds printed, flash and surrogate launches exactly 2x
   the plain step's; ``num_learners=2`` clamps to the one card with the
   warning and trains; ``build_ppo(..., microbatch=2)`` trains PPO CartPole
   3 iterations (2 surrogate launches each way a SGD step); IMPALA's learner
   thread steps a ``microbatch=2`` group over whole length-32 traces (one
   V-trace launch a microbatch) and stops with the flow; DQN's ``td_error``
   comes back at the full length of a trimmed batch;
39. explain: ``Algorithm.explain()`` on PPO CartPole and on PPO-LM, priced
   at ``HW_H100``: both stepped rows priced, every kernel charge equal to
   its bound's formula (phases 3 and 3b) at the sizes it was priced at, and
   the rollout after each probe bitwise equal to one from a snapshot
   restored before it.  Phases 38-39 run before 37.

Phases 20-21 run a third pretraining path, Qwen3-14B (hf:Qwen/Qwen3-8B
family: d_model 5120, 40 heads, 8 KV heads, d_ff 17408, vocab 151936,
qk-norm) at its published widths cut to 2 layers, its flash launches checked
per step.  Every keyed path checks that it launched the threefry kernel
(PPO CartPole and PPO-LM exactly: 4 a rollout and 2 a step, and 9 a step,
plus 1 a SGD step); the pretraining paths launch none.

Phase 3 also holds the four bf16 kernels (bf16 operands, fp32 sums, the
output rounded once) against their plain versions within 2^-7 (atol = rtol),
each bitwise equal across two calls, with device ms, the bound (bytes at 2
an element, or one bf16 tensor-core pass at 989 TFLOP/s) and SDPA or
``torch.bmm`` at bf16: the flash forward at the bf16 serve prefills and at
the float32 cases' shapes (the PPO-LM learner's, GQA 40/8 windowed, with a
q_offset, ragged, Phi's, Qwen3-14B's, D = 64 and 32), decode attention at
the bf16 serve steps and at the float32 cases' masks, the tile kernel at
DeepSeek's and Jamba's prefill products, Phi's, the ragged groups and D
and F that are not multiples of 64, the small-group kernel at the decode
products and ragged groups; and every
bf16-taking wrapper refusing mixed and float16 operands on the card.
Phase 21e serves DeepSeek-V2-Lite, Jamba and Nemotron-4 at their own dtype,
bfloat16, as phase 21d at float32: launches exact (the bf16 kernels), each
step's logits within 5e-2 x max |logits| of a bf16 full forward's and
within 0.1 x of a float32 run of the same weights widened, both on the
decode run's expert choices (the forward's own held to them but at near
ties), prefill seconds, ms a step and peak memory printed (phase 21d has them
at float32); and RWKV-6 7B the same way, on the bf16 RWKV-6 forward.

Pretraining at bfloat16, the configurations' own dtype, which the driver
(``launch/train.py``) keeps as the reference's does; the float32 paths above
ask for float32 themselves.  Phase 3 holds the bf16 flash backward
(``flash_attention_bf16.cu``: P recomputed from the forward's fp32 logsumexp,
P and dS rounded to bf16 for their products, fp32 sums, each gradient
rounded once) at Qwen3-14B's, Phi's, LLaVA's, MusicGen's (D = 64) and Jamba's
learner shapes, a window and a q_offset, and RWKV-6 at bf16 (``rwkv6.cu``'s
bf16 kernels) at the learner's and the serve prefill's shapes and with half
the decays at the clip, to their plain versions per row (``GRAD_ROW_TOL``,
fixed from a CPU emulation of each kernel's roundings), bitwise equal across
two runs, with their bound at 989 TFLOP/s or 2 bytes an element and SDPA's
bf16 backward beside the flash backward; phase 2 fails on a stack frame or
spill of either at the paths' head sizes.  It times the bf16 dX and dW
einsums (no kernel: the reference's) at Phi's, DeepSeek's and Jamba's
learner products with cuBLAS's bf16 reduced-precision reductions off (the
driver's setting) and on, and their error against fp32 sums each way.
Phase 19b (``pretrain_parity_bf16``) runs phase 19's parity at bf16 for
RWKV-6, Phi-3.5-MoE, Qwen3-14B and DeepSeek-V2-Lite on the card's expert
choices (the CPU's own held to them but at near ties), each weight within 2
x ``PARITY_BF16_GAP`` x its leaf's largest update plus one bf16 ulp, the
learner's leaves bf16 after the weight sync; phases 20-21 run
``PRETRAIN_BF16_PATHS`` (Qwen3-14B, Phi-3.5-MoE, RWKV-6 7B, DeepSeek-V2-Lite,
published widths cut to 2 layers, 2 x 4,096 tokens, ``PRETRAIN_BF16_STEPS``
steps) with exact bf16 launches, bf16 parameters and float32 moments.  Phase
35's restart runs at bf16 (every restored leaf bitwise the saved one); phase
39 also prices a bf16 pretraining step through ``explain()``.

Phase 3 also holds the model zoo's path shapes: flash forward and backward
at LLaVA's [2, 4096, 56/8, 128], MusicGen's [2, 4096, 32/32, 64] and Jamba's
[1, 4096, 32/8, 128] and forward at each serving prefill; the grouped matmul
and its dX and dW at DeepSeek's [61440, 2048] x [64, 2048, 1408] and Jamba's
[10240, 4096] x [16, 4096, 14336] (up and down) and forward at their serving
products; decode attention at each serving case's heads and window; RWKV-6 at
the serving prefill's [2, 512, 64, 64].  Every phase prints its seconds, and
the run prints them all before its result lines.

Phase 3 also holds flash attention at that path's shapes, [B, 4, 2/2, 32]
for B = 8 and 16 (serve dispatches), 128 (the learner, forward and
backward) and 256 (the GAE bootstrap), beside SDPA and the launch floor; and
phase 7 prints PPO-LM's seconds per iteration with per-lane keyed sampling.
A profiler session that records no device time is retried up to 3 times
before a case reports CUDA events (``ms_from``).

``decode_attention``'s launch count is one per wrapper call, which is one
CUDA launch: the last block of each group merges the splits (the variant
that merges them in a second kernel lives in ``kernels/decode_variants.py``
and is never counted).

Then one JSON line with every kernel's launches, error, times, bound and
library time (at the first case's shape, and under ``cases_by_path`` at
each main path's own shape; ``ms``, ``plain_ms`` and ``library_ms`` are device
time by the profiler unless their ``*_from`` key says ``cuda_events``, the
``*call_ms`` beside them CUDA events per call on the stream), and last
``{"ok": true, "device": {...}}``.  Needs a CUDA device and the repo's
``src/`` beside this file; it imports nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import logging
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, non-tensor-core fp32,
# and TF32 on the tensor cores (dense).  The flash kernels run 3xTF32: three
# tensor-core products for each fp32 product.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# int32 operations outside the tensor cores: 64 INT32 lanes on each of the
# H100 SXM's 132 SMs at its 1,980 MHz boost clock (the Hopper white paper's
# per-SM unit counts; the clock the card reads under load in phase 3).  These
# are the ALU pipe's (shifts, logic, IADD3); the FMA pipe runs integer
# multiply-adds (IMAD) on 64 lanes more, and four schedulers issue 128
# instructions a clock an SM.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
TOL = 1e-5  # atol = rtol for kernel vs plain version, float32
# The bf16 kernels (flash forward, decode attention, the grouped matmul's two
# routes) against their plain versions (the same function in float32, rounded
# once): atol = rtol = one bf16 ulp at the output.  An attention output is a
# weighted mean of V rows, far below 1 in a long row, so there atol is one
# ulp at the row's largest output (_close_rows).  Their tensor-core bound is
# the H100 SXM's dense bf16 rate.
BF16_TOL = 2.0 ** -7
BF16_OPS_PER_S = 989e12
# The bf16 backward kernels (flash attention's, RWKV-6's) and the bf16
# RWKV-6 forward against their plain versions, per row (one head's D or N
# values: a query's dq, a key's dk or dv, a step's output or gradients):
# each element within GRAD_ROW_TOL x (m + its own |plain|), m the row's
# largest |plain| (at most 1 for the RWKV-6 output, as _close_rows; for a
# gradient the row's own scale, but at least 2^-8 of the tensor's largest
# |plain|: a row that cancels to zero in exact arithmetic, such as dq of a
# causal row that sees one key, keeps the rounding of dP - delta).  dq's
# limit adds the one error the design puts in on purpose, as
# FlashAttention-2's does: delta = rowsum(dO o O) from the bf16 O where the
# plain version's exact gradient uses the fp32 O, which moves dS_ij by
# P_ij (delta - delta_32) and so dq_i by at most scale x |delta_i -
# delta_32,i| x max |k| (_dq_allowance).  Fixed before any card run from a
# CPU emulation of each kernel's roundings (tests/test_torch_bf16_train_gates.py:
# within 0.7 of it at every shape there, a dropped 64-key tile or time step
# beyond it).
GRAD_ROW_TOL = 2.0 ** -7
# atol = rtol for attention gradients, kernel vs autograd through the plain
# version: each dK/dV element sums Sq * g terms, each dQ element Sk terms,
# in another order.
GRAD_TOL = 1e-4
LEARNER_TOL = 1e-4  # weights after SGD steps, card vs CPU

PPO_CONFIG = dict(
    num_workers=2, num_envs=8, rollout_len=64,
    train_batch_size=1024, num_sgd_iter=4, sgd_minibatch_size=256,
)
ITERS = 8  # train() iterations on the main path

# The RLHF path: Qwen1.5-4B's attention and vocabulary widths (the port's
# copy of src/repro/configs/qwen15_4b.py), cut to 2 layers; LMTokenPolicy
# fixes d_ff = 4 * d_model and has no QKV bias.
RLHF_LAYERS = 2
RLHF_ENV = dict(ctx=256, min_prompt=64, max_prompt=192, horizon=32)
RLHF_CONFIG = dict(
    num_workers=2, num_envs=8, rollout_len=32,
    train_batch_size=512, num_sgd_iter=1, sgd_minibatch_size=128,
)
RLHF_ITERS = 3
# Reduced width of the card-vs-CPU LM learner parity phase.
LM_PARITY = dict(vocab_size=512, ctx=64, d_model=256, n_layers=2, num_heads=4, num_kv_heads=2)

# The asynchronous paths: IMPALA at examples/impala_vtrace.py's configuration,
# APPO on the same graph with PPO workers, and IMPALA's many-lane scenario
# (build_impala's vector=N lanes per shard).  ``min_steps`` is the number of
# learner-thread steps each must reach.
ASYNC_PATHS = {
    "impala": dict(plan="impala", algo="vtrace", num_workers=3, num_envs=4, rollout_len=32,
                   train_batch_size=512, num_async=2, vector=0, min_steps=16),
    "appo": dict(plan="appo", algo="ppo", num_workers=3, num_envs=4, rollout_len=32,
                 train_batch_size=512, num_async=2, vector=0, min_steps=16),
    "impala_vector": dict(plan="impala", algo="vtrace", num_workers=2, num_envs=256,
                          rollout_len=32, train_batch_size=16384, num_async=2, vector=256,
                          min_steps=8),
}
# The LM pretraining paths (launch/train.py): each configuration at its
# published widths cut to 2 layers, 4,096 tokens per sequence (the repo's
# train_4k length) and a global batch of 2 (from 256) in 2 data shards.
PRETRAIN = dict(seq=4096, batch=2, data_shards=2, steps=4, layers=2)
PRETRAIN_PATHS = {"pretrain_rwkv6": "rwkv6-7b", "pretrain_phi": "phi3.5-moe-42b-a6.6b",
                  "pretrain_qwen3": "qwen3-14b"}
PRETRAIN_DEADLINE_S = 420  # per path, model init included
# The shapes those paths give their kernels (the path phases check them
# against the configurations): RWKV-6's r, k, v, w [B, T, H, N]; Phi's
# grouped matmul [E * B * C, D] x [E, D, F], C = ceil(1.25 * T * top_k / E)
# = 640 slots per expert and row; Phi's attention [B, S, H, KV, D].
RWKV6_PATH_SHAPE = (2, 4096, 64, 64)
MOE_GMM_UP = (20480, 4096, 6400, 16)  # [T, D, F, E] of the up and gate products
PHI_ATTENTION = (2, 4096, 32, 8, 128)
QWEN3_ATTENTION = (2, 4096, 40, 8, 128)  # Qwen3-14B's [B, S, H, KV, D]
# The model zoo's pretraining paths: each configuration at its published
# widths cut to 2 layers by launch/train.py's cut_layers (DeepSeek: its dense
# prologue + one MoE block; Jamba: entries 2-3 of its block, Mamba + dense
# and attention + MoE), 2 x 4,096 tokens a step (LLaVA: 2,880 media + 1,216
# text a sequence; MusicGen: 4 codebooks a position), ZOO_STEPS steps.
# Jamba's MoE layer alone holds 2.82 B parameters (45 GB with gradients and
# AdamW's moments), so it takes 1 x 4,096 tokens.
ZOO_PRETRAIN_PATHS = {"pretrain_deepseek": "deepseek-v2-lite-16b",
                      "pretrain_jamba": "jamba-v0.1-52b",
                      "pretrain_llava": "llava-next-34b",
                      "pretrain_musicgen": "musicgen-large"}
PRETRAIN_BATCH = {"pretrain_jamba": 1}
ZOO_STEPS = 3
# Their kernels' shapes: the grouped matmul's up product [E * B * C, D] x
# [E, D, F] with C = ceil(1.25 * T * top_k / E) (DeepSeek 480, Jamba 640),
# and flash attention's [B, S, H, KV, D].  MLA attention (DeepSeek) is the
# plain chunked path and launches no flash kernel.
DEEPSEEK_GMM_UP = (61440, 2048, 1408, 64)
JAMBA_GMM_UP = (10240, 4096, 14336, 16)
LLAVA_ATTENTION = (2, 4096, 56, 8, 128)
MUSICGEN_ATTENTION = (2, 4096, 32, 32, 64)
JAMBA_ATTENTION = (1, 4096, 32, 8, 128)
# The serving paths: make_prefill_step on a 2 x 512 prompt (LLaVA: 2,880
# media + 512 text), then 16 make_decode_step calls, each configuration at
# its published widths cut to 2 layers, float32, MoE at capacity factor 8
# (as the reference's decode test, so that decode and forward drop nothing);
# Qwen1.5-32B with the int8 KV cache.  The cache window holds the prompt and
# the 16 steps.
SERVE_ZOO = {"serve_deepseek": ("deepseek-v2-lite-16b", ""), "serve_jamba": ("jamba-v0.1-52b", ""),
             "serve_rwkv6": ("rwkv6-7b", ""), "serve_qwen32_int8": ("qwen1.5-32b", "int8"),
             "serve_nemotron": ("nemotron-4-15b", ""), "serve_musicgen": ("musicgen-large", ""),
             "serve_llava": ("llava-next-34b", "")}
SERVE = dict(batch=2, prompt=512, steps=16, layers=2, capacity_factor=8.0)
SERVE_REL_TOL = 1e-4  # decode logits vs the full forward's, x max |logits|
INT8_REL_TOL = 0.05  # int8-cache decode vs the float32 cache's (tests/test_perf_features.py)
INT8_BYTES = 0.6  # the int8 cache's bytes, at most this share of the float32 cache's
# atol = rtol for the grouped matmul against the loop over groups: each
# output element sums 4,096 to 6,400 products, in another order than cuBLAS.
GMM_TOL = 1e-4
# Phase 37 runs phase 5's PPO CartPole on each backend of the runtime (a
# driver-managed host for remote-socket); the kernels see phase 5's shapes.
RUNTIME_BACKENDS = ("thread", "process-pickle", "process-shm", "remote-socket")
RUNTIME_PATHS = tuple(b.replace("-", "_") for b in RUNTIME_BACKENDS)
# The serving paths' kernel shapes: flash in the prefill [B, S, H, KV, D]
# (LLaVA's S counts the media), decode attention [B, 1, H, KV, D, W] with W
# the prompt and the steps, RWKV-6 in the prefill [B, T, H, N], and the
# grouped matmul's up products in the prefill and in a decode step at
# capacity factor 8 (C = ceil(8 * S * top_k / E): 384 and 1 for DeepSeek,
# 512 and 1 for Jamba).
_W = SERVE["prompt"] + SERVE["steps"]
SERVE_PREFILL_ATTENTION = {"serve_jamba": (2, 512, 32, 8, 128), "serve_qwen32_int8": (2, 512, 40, 40, 128),
                           "serve_nemotron": (2, 512, 48, 8, 128), "serve_musicgen": (2, 512, 32, 32, 64),
                           "serve_llava": (2, 2880 + 512, 56, 8, 128)}
SERVE_DECODE_ATTENTION = {"serve_jamba": (2, 1, 32, 8, 128, _W), "serve_qwen32_int8": (2, 1, 40, 40, 128, _W),
                          "serve_nemotron": (2, 1, 48, 8, 128, _W), "serve_musicgen": (2, 1, 32, 32, 64, _W),
                          "serve_llava": (2, 1, 56, 8, 128, 2880 + _W)}
SERVE_RWKV6_SHAPE = (2, 512, 64, 64)
SERVE_GMM_UP = {"serve_deepseek": [(49152, 2048, 1408, 64), (128, 2048, 1408, 64)],
                "serve_jamba": [(16384, 4096, 14336, 16), (32, 4096, 14336, 16)]}
# GmmMatmul passes block_m = B*C, the rows of a group, at most 128: a decode
# step's 2 take the small-group kernel (csrc/moe_gmm_small.cu), the prefill's
# 768 and 1,024 the 128-row-tile kernel (csrc/moe_gmm.cu).
SERVE_GMM_DECODE = {path: ups[1] for path, ups in SERVE_GMM_UP.items()}


def _down(up) -> list:
    """The down product's [T, F, D, E] beside an up product's [T, D, F, E]."""
    return [up[0], up[2], up[1], up[3]]


# The shape each main path gives each kernel, where phase 3 checks it (a
# list of shapes where one path gives a kernel several).
PATH_SHAPES = {
    "gae": {"ppo_cartpole": [64, 8], "ppo_lm": [32, 8], "appo": [32, 4], "a2c": [32, 4],
            "a3c": [32, 4], "maml": [16, 2], "mbpo": [[32, 4], [8, 128]],
            "multi_agent_ppo_dqn": [16, 4], "ppo_transformer_server": [32, 8],
            **{f"ppo_cartpole_{b}": [64, 8] for b in RUNTIME_PATHS}},
    "vtrace": {"impala": [32, 16], "impala_vector": [32, 512]},
    "ppo_surrogate_fwd": {"ppo_cartpole": [256, 2], "ppo_lm": [128, 151936], "appo": [512, 2],
                          "multi_agent_ppo_dqn": [128, 2], "ppo_transformer_server": [128, 2],
                          **{f"ppo_cartpole_{b}": [256, 2] for b in RUNTIME_PATHS}},
    "ppo_surrogate_bwd": {"ppo_cartpole": [256, 2], "ppo_lm": [128, 151936], "appo": [512, 2],
                          "multi_agent_ppo_dqn": [128, 2], "ppo_transformer_server": [128, 2],
                          **{f"ppo_cartpole_{b}": [256, 2] for b in RUNTIME_PATHS}},
    "flash_attention_fwd": {"ppo_lm": [128, 256, 20, 20, 128], "pretrain_phi": list(PHI_ATTENTION),
                            "ppo_transformer_server": [[b, 4, 2, 2, 32] for b in (8, 16, 128, 256)],
                            "pretrain_qwen3": list(QWEN3_ATTENTION),
                            "pretrain_llava": list(LLAVA_ATTENTION),
                            "pretrain_musicgen": list(MUSICGEN_ATTENTION),
                            "pretrain_jamba": list(JAMBA_ATTENTION),
                            **{name: list(shape) for name, shape in SERVE_PREFILL_ATTENTION.items()}},
    "flash_attention_bwd": {"ppo_lm": [128, 256, 20, 20, 128], "pretrain_phi": list(PHI_ATTENTION),
                            "ppo_transformer_server": [128, 4, 2, 2, 32],
                            "pretrain_qwen3": list(QWEN3_ATTENTION),
                            "pretrain_llava": list(LLAVA_ATTENTION),
                            "pretrain_musicgen": list(MUSICGEN_ATTENTION),
                            "pretrain_jamba": list(JAMBA_ATTENTION)},
    "decode_attention": {name: list(shape) for name, shape in SERVE_DECODE_ATTENTION.items()},
    # The hash's output shapes: [L, n] random bits, [L, n, 2] split keys.
    # PPO CartPole's resets draw [8, 4] bits; PPO-LM samples [8, 151936];
    # IMPALA's 256 lanes split [256, 2, 2] a step.
    "threefry": {"ppo_cartpole": [8, 4], "ppo_lm": [8, 151936], "impala_vector": [256, 2, 2],
                 **{f"ppo_cartpole_{b}": [8, 4] for b in RUNTIME_PATHS}},
    "rwkv6_fwd": {"pretrain_rwkv6": list(RWKV6_PATH_SHAPE), "serve_rwkv6": list(SERVE_RWKV6_SHAPE)},
    "rwkv6_bwd": {"pretrain_rwkv6": list(RWKV6_PATH_SHAPE)},
    **{name: {path: [list(up), _down(up)] for path, up in (
        ("pretrain_phi", MOE_GMM_UP), ("pretrain_deepseek", DEEPSEEK_GMM_UP),
        ("pretrain_jamba", JAMBA_GMM_UP))}
       for name in ("moe_gmm", "moe_gmm_dx", "moe_gmm_dw")},
}
PATH_SHAPES["moe_gmm"].update({path: [list(ups[0]), _down(ups[0])]
                               for path, ups in SERVE_GMM_UP.items()})
PATH_SHAPES["moe_gmm_small"] = {path: [list(up), _down(up)]
                               for path, up in SERVE_GMM_DECODE.items()}
# The bf16 serving paths: DeepSeek-V2-Lite, Jamba and Nemotron-4 at their
# configurations' own dtype (bfloat16, every configuration's default), cut
# to 2 layers by cut_layers as their float32 cases, the same 2 x 512 prefill
# and 16 steps, weights made at bf16 by init_params from a seed.  Each step's
# logits (and the prefill's last) must be within SERVE_BF16_REL_TOL x max
# |logits| of one bf16 full forward's and within SERVE_BF16_F32_REL_TOL x max
# |logits| of a float32 run of the same weights widened, both runs taking
# the decode run's expert choices (tolerances fixed from CPU runs at reduced
# widths before any card run, PERF.md); the full forward's own choices must equal the
# decode run's but at near ties (the k-th and (k + 1)-th probabilities within
# ROUTE_NEAR_TIE of the larger).  They run the bf16 kernels at the float32
# cases' shapes.
SERVE_BF16 = {"serve_deepseek_bf16": "deepseek-v2-lite-16b", "serve_jamba_bf16": "jamba-v0.1-52b",
              "serve_nemotron_bf16": "nemotron-4-15b", "serve_rwkv6_bf16": "rwkv6-7b"}
SERVE_BF16_REL_TOL = 5e-2
SERVE_BF16_F32_REL_TOL = 1e-1
ROUTE_NEAR_TIE = 0.1
_BF16_CASE = {"serve_deepseek": "serve_deepseek_bf16", "serve_jamba": "serve_jamba_bf16",
              "serve_nemotron": "serve_nemotron_bf16"}
SERVE_BF16_PREFILL_ATTENTION = {_BF16_CASE[p]: SERVE_PREFILL_ATTENTION[p]
                                for p in ("serve_jamba", "serve_nemotron")}
SERVE_BF16_DECODE_ATTENTION = {_BF16_CASE[p]: SERVE_DECODE_ATTENTION[p]
                               for p in ("serve_jamba", "serve_nemotron")}
PATH_SHAPES["flash_attention_fwd_bf16"] = {p: list(s) for p, s in SERVE_BF16_PREFILL_ATTENTION.items()}
PATH_SHAPES["decode_attention_bf16"] = {p: list(s) for p, s in SERVE_BF16_DECODE_ATTENTION.items()}
# The bf16 decode shapes of the serve cases that have no bf16 run yet
# (Qwen1.5-32B's 40/40, MusicGen's D = 64, LLaVA's 56/8 at W 3,408): phase 3
# holds the bf16 decode kernel to its plain version there, SDPA beside it.
BF16_DECODE_NEXT = {p: SERVE_DECODE_ATTENTION[p] for p in ("serve_qwen32_int8", "serve_musicgen",
                                                           "serve_llava")}
PATH_SHAPES["moe_gmm_bf16"] = {_BF16_CASE[p]: [list(ups[0]), _down(ups[0])]
                               for p, ups in SERVE_GMM_UP.items()}
PATH_SHAPES["moe_gmm_small_bf16"] = {_BF16_CASE[p]: [list(up), _down(up)]
                                     for p, up in SERVE_GMM_DECODE.items()}
# The bf16 pretraining paths: launch/train.py at the configuration's own
# dtype, bfloat16 (the reference driver's), each at published widths cut to
# 2 layers, 2 x 4,096 tokens a step, PRETRAIN_BF16_STEPS steps, the kernels
# at the float32 paths' shapes: the bf16 flash forward and backward, the
# bf16 RWKV-6 forward and backward, the bf16 tile kernel (its dX and dW are
# the reference's two bf16 einsums, no kernel).  Jamba, LLaVA and MusicGen
# train at bf16 in the CPU tests; their flash backward shapes run in phase 3.
PRETRAIN_BF16_PATHS = {"pretrain_qwen3_bf16": "qwen3-14b", "pretrain_phi_bf16": "phi3.5-moe-42b-a6.6b",
                       "pretrain_rwkv6_bf16": "rwkv6-7b", "pretrain_deepseek_bf16": "deepseek-v2-lite-16b"}
PRETRAIN_BF16_STEPS = 3
# The bf16 learner parity (card vs CPU, one SGD step at lr 1 on the card's
# expert choices): each weight within 2 x PARITY_BF16_GAP x its leaf's
# largest update plus 2^-7 x its own |value| (one bf16 ulp: the rounding of
# w - g can flip where the two gradients differ by less than a rounding),
# and each statistic (loss, nll, aux) within 2 x PARITY_BF16_LOSS_GAP.
# PARITY_BF16_GAP is the reference's own largest bf16 vs float32 gradient
# gap over a leaf, as a share of the leaf's largest gradient, and
# PARITY_BF16_LOSS_GAP its largest bf16 vs float32 loss gap, at these
# reduced configurations on the CPU (0.018-0.037 and 8.5e-5 to 4.6e-4 at
# 2 x 64 tokens; tests/test_torch_bf16_train_models.py holds both).
PARITY_BF16_GAP = 0.04
PARITY_BF16_LOSS_GAP = 5e-4
PARITY_BF16_ARCHS = ("rwkv6-7b", "phi3.5-moe-42b-a6.6b", "qwen3-14b", "deepseek-v2-lite-16b")
PATH_SHAPES["flash_attention_bwd_bf16"] = {"pretrain_qwen3_bf16": list(QWEN3_ATTENTION),
                                           "pretrain_phi_bf16": list(PHI_ATTENTION)}
PATH_SHAPES["flash_attention_fwd_bf16"].update(PATH_SHAPES["flash_attention_bwd_bf16"])
PATH_SHAPES["rwkv6_fwd_bf16"] = {"pretrain_rwkv6_bf16": list(RWKV6_PATH_SHAPE),
                                 "serve_rwkv6_bf16": list(SERVE_RWKV6_SHAPE)}
PATH_SHAPES["rwkv6_bwd_bf16"] = {"pretrain_rwkv6_bf16": list(RWKV6_PATH_SHAPE)}
PATH_SHAPES["moe_gmm_bf16"].update({"pretrain_phi_bf16": [list(MOE_GMM_UP), _down(MOE_GMM_UP)],
                                    "pretrain_deepseek_bf16": [list(DEEPSEEK_GMM_UP),
                                                               _down(DEEPSEEK_GMM_UP)]})
ASYNC_DEADLINE_S = 300  # per async path: a wedged flow fails its phase
# The gradient paths (A2C, A3C) at examples/quickstart.py's workers: 2 'pg'
# workers of 4 CartPole envs x 32 steps.
GRADIENT_CONFIG = dict(num_workers=2, num_envs=4, rollout_len=32, iters=6)
GRADIENT_INFO_KEYS = {"loss", "batch_count"}
GRADIENT_COUNTERS = {"num_steps_sampled", "num_steps_trained"}
GRADIENT_PATHS = ("a2c", "a3c")
GRADIENT_DEADLINE_S = 120  # per gradient path
# The replay paths: DQN at benchmarks/common.py's workers with one buffer at
# examples/apex_dqn.py's settings, Ape-X at examples/apex_dqn.py's
# configuration, SAC on Pendulum at tests/test_plans.py's workers and buffer.
APEX_REPLAY = dict(capacity=50_000, sample_batch_size=64, learning_starts=1000, prioritized=True)
REPLAY_PATHS = {
    "dqn": dict(num_workers=2, num_envs=4, rollout_len=16, replay=APEX_REPLAY, replay_actors=1,
                plan={}, min_target_updates=2),
    "apex": dict(num_workers=3, num_envs=4, rollout_len=16, replay=APEX_REPLAY, replay_actors=2,
                 plan=dict(target_update_freq=2000), min_steps=40),
    "sac": dict(num_workers=2, num_envs=4, rollout_len=16, replay_actors=1, plan={},
                replay=dict(capacity=4096, sample_batch_size=16, learning_starts=32),
                min_target_updates=8),
}
REPLAY_DEADLINE_S = 120  # per replay path
DQN_INFO_KEYS = {"loss", "td_error", "mean_q"}
SAC_INFO_KEYS = {"loss", "td_error", "critic_loss", "actor_loss"}
REPLAY_COUNTERS = {"num_steps_sampled", "num_steps_trained", "num_target_updates",
                   "num_bytes_moved", "num_samples_dropped"}
# Recorded only once a producer finds a bounded window full.
TIMING_COUNTERS = {"num_credit_stalls", "credit_stall_time_s"}
OFFPOLICY_PARITY_STEPS = 8
OFFPOLICY_PARITY_LR = 0.01
ASYNC_PROFILE_S = 1.0  # the profiled window of train() calls lasts at least this
# The last three plans at their reference drivers' configurations: MAML at
# tests/test_plans.py's pg workers (2 remote, 2 envs x 16 steps, one inner
# step), MBPO at examples/mbpo_model_based.py's workers and replay, and the
# PPO+DQN composition at benchmarks/common.py's multi-agent workers (2
# workers, 4 agents, 16 steps) with benchmarks/bench_multiagent.py's plan and
# replay.
PLAN_PATHS = {
    "maml": dict(num_workers=2, num_envs=2, rollout_len=16, plan=dict(inner_steps=1), iters=6),
    "mbpo": dict(num_workers=2, num_envs=4, rollout_len=32, ensemble_size=2, synth_rollout_len=8,
                 synth_batch=128, plan=dict(model_train_weight=2), iters=6,
                 replay=dict(capacity=20000, sample_batch_size=256, learning_starts=512,
                             prioritized=False)),
    "multi_agent_ppo_dqn": dict(num_workers=2, num_agents=4, rollout_len=16, iters=12,
                                plan=dict(ppo_batch_size=128, dqn_target_update_freq=500),
                                replay=dict(capacity=20000, sample_batch_size=32,
                                            learning_starts=64)),
}
MA_MAPPING = {0: "ppo_policy", 1: "ppo_policy", 2: "dqn_policy", 3: "dqn_policy"}
PG_INFO_KEYS = {"loss", "pg_loss", "vf_loss", "entropy"}
# The composition's PPO info is keyed by policy id and its DQN info carries
# td_error beside the loss; both are checked with those taken off.
PLAN_INFO_KEYS = {"maml": PG_INFO_KEYS, "mbpo": PG_INFO_KEYS, "multi_agent_ppo_dqn": {"loss"}}
PLAN_COUNTERS = {"num_steps_sampled", "num_steps_trained", "num_target_updates",
                 "num_bytes_moved"}
PLAN_DEADLINE_S = 120  # per plan path
COMPOSITION_ITERS = 20  # benchmarks/bench_multiagent.py's run(iters=20)
ASYNC_OPT_ITERS = 40  # benchmarks/bench_async_opt.py's run(iters=40)
# The serving slice.  KEY_LANES lane keys for the card-vs-CPU bit check; the
# serve CLI's load defaults (launch/serve.py) for every tier; Mamba's parity
# over MAMBA_STEPS carried decode steps; and PPO with TransformerPolicy at its
# defaults (d_model 64, 2 layers, 4 tokens: 2 heads of 32) behind 3 replicas.
KEY_LANES = 4096
SERVE_LOAD = dict(rate_hz=200.0, num_requests=200, lanes_per_request=8, num_clients=2, seed=0)
SERVE_TIERS = [(p, r) for p in ("stateless", "ac", "ssm") for r in (1, 3)]
SERVE_PARITY_STEPS = 8
MAMBA_LANES = 64
MAMBA_STEPS = 16
TF_SERVE = dict(num_workers=2, num_envs=8, rollout_len=32, replicas=3, train_batch_size=512,
                num_sgd_iter=1, sgd_minibatch_size=128, iters=5)
TF_LAYERS = 2
TF_ATTENTION = (4, 2, 32)  # tokens, heads (= KV heads), head dim of the trunk
# The flash kernel's batch on that path: a serve dispatch's padded rows (8,
# or 16 when both workers' requests meet in one dispatch), the learner's
# minibatch and the GAE bootstrap's T x N rows.
TF_FLASH_FWD_B = (8, 16, 128, 256)
TF_FLASH_BWD_B = 128
TF_SERVE_DEADLINE_S = 180


class PhaseError(RuntimeError):
    pass


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds per call on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class _DeviceProfile:
    """``torch.profiler`` (CUPTI) over the kernels launched between
    ``start()`` and ``stop()``; ``stop()`` returns device microseconds by
    kernel name and leaves the count of each kernel's device records in
    ``records``.  On an H100, once the port's kernel library was loaded, a
    profiler session lost device records of kernels whose launches it
    recorded: the first kernel of a session, and now and then one later
    (``torch.bmm`` at the grouped matmul's shape read 7.7 ms per call over
    5 calls against 20.2 ms by CUDA events).  A short spin kernel launched
    first kept the first record (``_profiler_records`` counts the records
    both ways), so ``start()`` launches one and ``stop()`` leaves it out
    (``prime=False`` skips it); ``_per_call`` copes with the later ones."""

    PRIMER = "spin_kernel"  # the kernel of torch.cuda._sleep

    def __init__(self, prime: bool = True):
        self.prime = prime

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        if self.prime:
            torch.cuda._sleep(1000)

    def stop(self) -> dict:
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        out: dict = {}
        self.records: dict = {}
        for e in self.prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
                    and self.PRIMER not in e.key):
                out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total
                self.records[e.key] = self.records.get(e.key, 0) + e.count
        return out


def _profiler_records(fn, iters: int = 50) -> dict:
    """How many device records of ``fn``'s main kernel a profiler session
    kept over ``iters`` calls, started cold and primed as
    ``_DeviceProfile`` starts: the evidence for its primer."""
    import torch

    out = {"calls": iters}
    for name, prime in (("cold", False), ("primed", True)):
        fn()
        torch.cuda.synchronize()
        prof = _DeviceProfile(prime)
        prof.start()
        for _ in range(iters):
            fn()
        kernels = prof.stop()
        out[name] = prof.records[max(kernels, key=kernels.get)]
    return out


def _per_call(fn, iters: int) -> tuple:
    """Device microseconds per call of ``fn`` by kernel name over ``iters``
    calls, and how many device records the profiler lost.  A kernel with
    fewer records than its launches per call, round(records / iters) and
    at least 1, times ``iters`` lost the rest: its time per call is the
    mean of its records times those launches (a lost record leaves the mean
    as it was, where dividing the sum by ``iters`` would read it as a
    faster call).  Any other kernel's is its sum over ``iters``, so a kernel
    that does not run the same number of times in every call is not
    scaled up."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof = _DeviceProfile()
    prof.start()
    for _ in range(iters):
        fn()
    total = prof.stop()
    per_call, lost = {}, 0
    for name, us in total.items():
        n = prof.records[name]
        launches = max(1, round(n / iters))
        if n < launches * iters:
            per_call[name] = us / n * launches
            lost += launches * iters - n
        else:
            per_call[name] = us / iters
    return per_call, lost


def _device_ms(fn, iters: int = 50) -> tuple:
    """Mean device milliseconds per call, by the profiler's records of every
    kernel the call launched (``_per_call``), or None when it records no
    device time; and the records it lost."""
    per_call, lost = _per_call(fn, iters)
    total_us = sum(per_call.values())
    return (total_us / 1e3 if total_us > 0 else None), lost


PROFILE_RETRIES = 3  # new profiler sessions for a case whose session recorded nothing


def _device_ms_retried(fn, iters: int) -> tuple:
    """``_device_ms``, with up to ``PROFILE_RETRIES`` new sessions when a
    session returns no device record at all (on an H100 one such session
    once left a case with only its CUDA-event time): (ms or None, records
    lost, sessions retried)."""
    for retries in range(PROFILE_RETRIES + 1):
        ms, lost = _device_ms(fn, iters=iters)
        if ms is not None:
            break
    return ms, lost, retries


def _smi_sample() -> dict:
    """The card's SM clock (MHz), power draw (W) and temperature (C) now."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=60)
    fields = smi.stdout.strip().splitlines()[0].split(",") if smi.returncode == 0 else []
    return dict(zip(("clocks_sm", "power_draw", "temperature"),
                    (float(f) for f in fields))) if len(fields) == 3 else {}


# Seconds that ``_timings`` spends timing kernels and their plain versions,
# by the case function that called it: [kernel s, plain s, calls].  Phase 3
# prints them, to show where its time goes.
TIMING_SECONDS: dict = {}


def _timings(kernel, plain, plain_iters: int, kernel_iters: int = 200,
             plain_profile: bool = True, clocks: bool = False) -> dict:
    """Kernel and plain version: device ms per call (profiler) and ms per
    call on the stream (CUDA events, host launch cost included), the
    kernel's events read before (``call_ms``) and after (``call_ms_after``)
    its profiled calls.  ``ms`` is the device time where the profiler gives
    one, else the event time; ``ms_from`` and ``plain_ms_from`` say which
    ("profiler" or "cuda_events").  Kernels of tens of milliseconds take a
    smaller ``kernel_iters``; a plain version of thousands of launches a
    call is not profiled (``plain_profile``): its trace alone takes seconds
    to minutes, and it is timed by events without a warmup call.  A profiler session that records no device time is retried
    (``_device_ms_retried``; ``profile_retries`` counts the new sessions)
    before the event time stands in.  With ``clocks``, the card's SM clock,
    power draw and temperature before and after each of the kernel's three
    readings."""
    t0 = time.perf_counter()
    samples = [_smi_sample()] if clocks else []
    t = {"call_ms": _time_ms(kernel, iters=kernel_iters, warmup=min(10, kernel_iters))}
    samples += [_smi_sample()] if clocks else []
    t["device_ms"], t["records_lost"], t["profile_retries"] = _device_ms_retried(
        kernel, min(50, kernel_iters))
    samples += [_smi_sample()] if clocks else []
    t["call_ms_after"] = _time_ms(kernel, iters=kernel_iters, warmup=0)
    if clocks:
        t["clocks"] = samples + [_smi_sample()]
    # A plain version that is not profiled (thousands of launches a call) is
    # already warm from the case's check: no warmup call.
    t1 = time.perf_counter()
    t["plain_call_ms"] = _time_ms(plain, iters=plain_iters, warmup=2 if plain_profile else 0)
    t["plain_device_ms"], t["plain_records_lost"], t["plain_profile_retries"] = (
        _device_ms_retried(plain, plain_iters) if plain_profile else (None, None, 0))
    case = TIMING_SECONDS.setdefault(sys._getframe(1).f_code.co_name, [0.0, 0.0, 0])
    case[0] += t1 - t0
    case[1] += time.perf_counter() - t1
    case[2] += 1
    for key, device, call in (("ms", "device_ms", "call_ms"),
                              ("plain_ms", "plain_device_ms", "plain_call_ms")):
        profiled = t[device] is not None
        t[key] = t[device] if profiled else t[call]
        t[key + "_from"] = "profiler" if profiled else "cuda_events"
    return t


def _bound_ms(nbytes: int, nops: int, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _formula(name: str, key: dict) -> tuple:
    """(flops or int32 ops, bytes) of one launch of kernel ``name`` at the
    sizes ``key``: the one copy of the counts behind every bound of phases
    3 and 3b, which phase 39 holds against the cost walker's own copy
    (``distributed/hlo_cost.py``).  ``name`` and ``key`` are the walker's:
    a ``_bwd`` suffix names a kernel's backward."""
    base = name[:-4] if name.endswith("_bwd") else name
    bwd = name.endswith("_bwd")
    if base == "gae":
        tb, b = key["tb"], key["b"]
        return 8 * tb, (5 * tb + b) * 4
    if base == "vtrace":
        tb, b = key["tb"], key["b"]
        return 20 * tb, (5 * tb + b) * 4 + 2 * tb * 4  # six inputs read, two outputs written
    if base == "ppo_surrogate":
        B, A, row_in = key["b"], key["a"], 4 * 4 + 8  # four float [B] vectors, the int64 action
        if bwd:
            # In: logits, the row inputs, the saved lse and ent, four cotangents.
            return B * (16 * A + 40), B * (4 * A + row_in + 2 * 4 + 4 * 4) + B * (4 * A + 4 * 4)
        return B * (6 * A + 20), B * (4 * A + row_in) + B * 5 * 4  # pg, vf, ent, kl and lse out
    # ``es``: the operands' bytes an element where not 4 (the bf16 kernels: 2).
    es = key.get("es", 4)
    if base == "flash_attention":
        B, Sq, Sk, H, KV, D = (key[x] for x in ("b", "sq", "sk", "h", "kv", "d"))
        _, pairs = _visible_pairs(Sq, Sk, key["causal"], key["window"], key["q_offset"])
        if bwd:  # reads q, o, dO, lse, k, v; writes dq, dk, dv
            return 10 * B * H * D * pairs, (4 * B * Sq * H * D + 4 * B * Sk * KV * D) * es + B * H * Sq * 4
        return 4 * B * H * D * pairs, (2 * B * Sq * H * D + 2 * B * Sk * KV * D) * es + B * H * Sq * 4
    if base == "decode_attention":
        B, H, KV, D, n_valid = (key[x] for x in ("b", "h", "kv", "d", "n_valid"))
        return 4 * H * D * n_valid, (2 * B * H * D + 2 * n_valid * KV * D) * es + key["mask"]
    if base == "rwkv6":
        # The training forward reads r, k, v, w, u (and s0) and writes o,
        # the final state and the chunk-start states; the backward reads r,
        # k, v, w, u, dO, dS_T and the chunk-start states and writes dr, dk,
        # dv, dw, du (and dS_0).  Operations per (b, t, h), counting an FMA
        # as two: the forward's k v, S + u k v, r . (...) and w S + k v,
        # 7 N^2; the backward's recomputed update, 3 N^2, and its sums and
        # G update, 11 N^2.  u and the states stay fp32 at bf16.
        B, T, H, N = (key[x] for x in ("b", "t", "h", "n"))
        seq, st = B * T * H * N * es, B * H * N * N * 4
        ck = B * H * -(-T // key["chunk"]) * N * N * 4
        s0 = st if key["state"] else 0
        if bwd:
            return 14 * B * T * H * N * N, 9 * seq + 2 * H * N * 4 + st + ck + s0
        return 7 * B * T * H * N * N, 5 * seq + H * N * 4 + st + ck + s0
    if base in ("moe_gmm", "moe_gmm_dx", "moe_gmm_dw"):
        T, D, F, E = (key[x] for x in ("t", "d", "f", "e"))
        return 2 * T * D * F, es * (T * D + E * D * F + T * F)
    if base == "threefry_counts":
        lanes, n, xor = key["lanes"], key["n"], key["xor"]
        # 16 B a key read, 8 B a word (bits) or 16 B a key (keys) written
        return _threefry_ops(lanes * n, xor), 16 * lanes + lanes * n * (8 if xor else 16)
    if base == "threefry_fold_in":
        return _threefry_ops(key["lanes"], False), key["lanes"] * (16 + 8 + 16)
    raise PhaseError(f"no bound formula for kernel {name}")


def _tensor_core_bounds(nbytes: int, flops: int) -> dict:
    """The bound of the flash and grouped-matmul kernels on their route,
    3xTF32 (three TF32 tensor-core products per product), and the fp32
    CUDA-core bound of earlier PRs beside it as ``bound_fp32_ms``."""
    bound, by = _bound_ms(nbytes, 3 * flops, TF32_OPS_PER_S)
    return {"bound_ms": bound, "bound_by": by, "bound_fp32_ms": _bound_ms(nbytes, flops)[0],
            "bytes": nbytes, "flops": flops}


def _bf16_bounds(nbytes: int, flops: int) -> dict:
    """The bound of the bf16 tensor-core kernels: one bf16 pass a product,
    the flops at 989 TFLOP/s, or the bytes (2 an element)."""
    bound, by = _bound_ms(nbytes, flops, BF16_OPS_PER_S)
    return {"bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops}


def _keyed_launches(name: str, launches: dict, expect: dict) -> None:
    """Every rollout draw of a keyed path is a threefry hash: require the
    path to have launched the kernel, and take its count into ``expect``
    (the paths whose count phases 5, 7 and 33 check exactly set it
    themselves)."""
    _require(launches.get("threefry", 0) > 0, f"{name}: no threefry launch ({launches})")
    expect["threefry"] = launches["threefry"]


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _close(name: str, got, want, tol: float = TOL) -> float:
    import torch

    err = _max_err(got, want)
    ok = bool(torch.allclose(got, want, atol=tol, rtol=tol)) and bool(torch.isfinite(got).all())
    _require(ok, f"{name}: kernel disagrees with its plain version "
                 f"(max abs err {err:.3e}, tol {tol})")
    return err


def _row_ratio(got, want, tol: float, unit: bool = False, allowance=None) -> float:
    """The largest error of ``got`` against ``want`` over its limit, tol x
    (m + its own |want|) (+ ``allowance``, a row's), m the largest |want| of
    its row (the last axis): with ``unit`` at most 1, and an element of an
    all-zero row must be exactly zero; else at least 2^-8 x the largest
    |want| of the tensor."""
    import torch

    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs()
    m = want.abs().amax(-1, keepdim=True)
    m = m.clamp(max=1.0) if unit else m.clamp(min=2.0 ** -8 * float(want.abs().max()))
    limit = tol * (m + want.abs()) + (0 if allowance is None else allowance)
    return float(torch.where(err > 0, err / limit, torch.zeros_like(err)).max())


def _dq_allowance(k, dout, o, o32):
    """[B, Sq, H, 1]: the most the bf16 flash backward's delta, taken from
    the bf16 output ``o`` where the exact gradient has the fp32 ``o32``,
    moves a row of dq: scale x |rowsum(dO o (o - o32))| x the largest |k| of
    the row's kv head (dq_i = scale sum_j dS_ij k_j, and the moved delta
    shifts dS_ij by P_ij times its error, sum_j P_ij = 1)."""
    B, Sq, H, D = o.shape
    KV = k.shape[2]
    derr = (dout.float() * (o.float() - o32.float())).sum(-1).abs()  # [B, Sq, H]
    kmax = k.float().abs().amax(dim=(1, 3)).repeat_interleave(H // KV, dim=1)  # [B, H]
    return (derr * kmax[:, None, :] / D ** 0.5)[..., None]


def _close_rows(name: str, got, want, tol: float = BF16_TOL, unit: bool = True,
                allowance=None) -> tuple:
    """A bf16 kernel's output against its plain version: each element
    within ``tol`` x (m + its own |plain|), m the largest |plain| of its row
    (one head's D outputs), for attention outputs (``unit``) at most 1, so
    the limit follows the row's scale and is nowhere looser than atol = rtol
    = ``BF16_TOL``; an all-zero row must come out exactly zero.  Returns the
    max abs error and the largest error over its limit."""
    import torch

    got = got.float()
    err = (got - want.float()).abs()
    ratio = _row_ratio(got, want, tol, unit, allowance)
    ok = ratio <= 1.0 and bool(torch.isfinite(got).all())
    _require(ok, f"{name}: kernel disagrees with its plain version (max abs err "
                 f"{float(err.max()):.3e}, {ratio:.3f} x its limit)")
    return float(err.max()), ratio


# ----------------------------------------------------------------- phase 1
def phase_device() -> dict:
    import torch

    _require(torch.cuda.is_available(), "no CUDA device: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    _require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    print(
        f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} python={sys.version.split()[0]}"
    )
    return {"nvidia_smi": line}


# ----------------------------------------------------------------- phase 2
FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
# Rows of the streamed tile by D (forward, backward) and of a block's own
# tile, as flash_attention.cu's fwd_cols / bwd_cols / kRows, for the dynamic
# shared memory of its fwd_smem / dq_smem / dkdv_smem.
FLASH_COLS = {32: (64, 32), 64: (64, 32), 128: (16, 16)}
FLASH_ROWS = 64
# The grouped-matmul kernels of moe_gmm.cu (forward, dX, dW) and, as its
# kBM / kBN / kBK / kStages, their tiles: a staged K-major operand tile holds
# [rows][GMM_BK + 4] floats, an MN-major one [GMM_BK][cols + 8], and B's
# split big and small tiles GMM_TILE x GMM_BK floats each.
GMM_KERNELS = {"gmm_rows_kernelILb0E": "gmm_rows_kernel<false>",
               "gmm_rows_kernelILb1E": "gmm_rows_kernel<true>", "gmm_dw_kernel": "gmm_dw_kernel"}
GMM_TILE, GMM_BK, GMM_STAGES, GMM_THREADS = 128, 32, 4, 256
# The RWKV-6 kernels of rwkv6.cu (CUDA cores) and, as its kTile / kSub /
# kMarks, the forward's staged steps, the backward's sub-chunk steps and
# its kept sub-chunk start states; a block has N * N / 8 threads.
RWKV6_KERNELS = ("rwkv6_fwd_kernel", "rwkv6_bwd_kernel")
RWKV6_TILE, RWKV6_SUB, RWKV6_MARKS = 32, 16, 4
# The small-group kernels of moe_gmm_small.cu (CUDA cores): one per rows a
# chunk (RMAX), blocks of 256 threads with 4 x RMAX x 128 floats of shared
# memory.
GMM_SMALL_ROWS = (1, 2, 4, 8, 16)
GMM_SMALL_KERNELS = tuple(f"gmm_small_kernel<{r}>" for r in GMM_SMALL_ROWS)
# The bf16 kernels (flash_attention_bf16.cu, moe_gmm_bf16.cu and
# decode_attention_bf16.cu on the tensor cores; the bf16 kernel of
# moe_gmm_small.cu on the CUDA cores), by the names ``_bf16_kernel_name``
# gives their symbols.  The bf16 decode kernel runs its products on
# mma.sync (bf16 HMMA), one kernel a padded head dim (64, 128).
BF16_DECODE_KERNELS = ("decode_bf16_kernel<64>", "decode_bf16_kernel<128>")
BF16_TENSOR_CORE_KERNELS = (*(f"flash_fwd_bf16_kernel<{d}>" for d in (32, 64, 128)),
                            "gmm_tile_bf16_kernel",
                            *(f"flash_bwd_bf16_{k}_kernel<{d}>" for k in ("dkdv", "dq")
                              for d in (32, 64, 128)), *BF16_DECODE_KERNELS)
# The bf16 RWKV-6 kernels of rwkv6.cu (CUDA cores), the small-group bf16
# kernels of moe_gmm_small.cu, and the bf16 kernels that must hold no stack
# frame or spill: the flash forward and backward at the paths' head dims,
# the tile kernel, the decode kernels, RWKV-6 at every head size and the
# small-group kernels.
BF16_RWKV6_KERNELS = tuple(f"rwkv6_{k}_bf16_kernel<{n}>" for k in ("fwd", "bwd") for n in (16, 32, 64))
BF16_SMALL_KERNELS = tuple(f"gmm_small_bf16_kernel<{r}>" for r in GMM_SMALL_ROWS)
BF16_NO_SPILL = (*(f"flash_{k}_bf16{s}_kernel<{d}>" for k, s in (("fwd", ""), ("bwd", "_dkdv"),
                                                                   ("bwd", "_dq")) for d in (64, 128)),
                 "gmm_tile_bf16_kernel", *BF16_DECODE_KERNELS, *BF16_RWKV6_KERNELS,
                 *BF16_SMALL_KERNELS)
# The bf16 kernels redesigned for Hopper on warpgroup products (tiles that
# TMA lands swizzled): the flash kernels and the grouped matmul's tile
# kernel, each must show bf16 HGMMA in its SASS, not merely the warp-level
# HMMA of mma.sync.  The decode kernels' products take 16 rows: mma.sync.
BF16_HGMMA_KERNELS = tuple(k for k in BF16_TENSOR_CORE_KERNELS if k not in BF16_DECODE_KERNELS)
SM_SMEM_BYTES = 233472  # 228 KB of shared memory on an H100 SM; 1 KB more per block
SM_REGISTERS = 65536


def _kernel_name(symbol: str):
    """``flash_fwd_kernel<128>``, ``rwkv6_bwd_kernel<64>`` or
    ``gmm_rows_kernel<false>`` from a mangled kernel symbol of the flash,
    RWKV-6 or grouped-matmul sources, or None."""
    m = re.search(r"(" + "|".join(FLASH_KERNELS + RWKV6_KERNELS) + r")ILi(\d+)E", symbol)
    if m:
        return f"{m.group(1)}<{m.group(2)}>"
    return next((name for key, name in GMM_KERNELS.items() if key in symbol), None)


def _small_gmm_name(symbol: str):
    """``gmm_small_kernel<2>`` from a mangled kernel symbol of
    moe_gmm_small.cu, or None."""
    m = re.search(r"gmm_small_kernelILi(\d+)E", symbol)
    return f"gmm_small_kernel<{m.group(1)}>" if m else None


def _bf16_kernel_name(symbol: str):
    """``flash_fwd_bf16_kernel<128>``, ``gmm_tile_bf16_kernel``,
    ``gmm_small_bf16_kernel<2>`` or ``decode_bf16_kernel<128>`` from a
    mangled kernel symbol of the bf16 sources, or None."""
    for pattern, fmt in ((r"(flash_fwd_bf16_kernel|flash_bwd_bf16_dkdv_kernel|flash_bwd_bf16_dq_kernel"
                          r"|rwkv6_fwd_bf16_kernel|rwkv6_bwd_bf16_kernel|decode_bf16_kernel)ILi(\d+)E",
                          "{}<{}>"),
                         (r"(gmm_small_bf16_kernel)ILi(\d+)E", "{}<{}>")):
        m = re.search(pattern, symbol)
        if m:
            return fmt.format(*m.groups())
    return "gmm_tile_bf16_kernel" if "gmm_tile_bf16_kernel" in symbol else None


@functools.lru_cache(maxsize=None)
def _sass(library: str) -> str:
    """``cuobjdump -sass`` of the kernel library, or "" where the tool is not
    found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return ""
    sass = subprocess.run([tool, "-sass", library], capture_output=True, text=True, timeout=300)
    _require(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr.strip()[:500]}")
    return sass.stdout


def _bf16_kernel_usage(log: str, library: str) -> dict:
    """Each bf16 kernel's registers and spills (``ptxas -v``) and, for the
    tensor-core ones, the count of bf16 ``HMMA``/``HGMMA`` instructions in
    its SASS (none fails the phase, as does a stack frame or spill of a
    small-group kernel, as of its float32 twin)."""
    usage = _ptxas_usage(log, _bf16_kernel_name)
    want = BF16_TENSOR_CORE_KERNELS + BF16_SMALL_KERNELS + BF16_RWKV6_KERNELS
    _require(sorted(usage) == sorted(want), f"ptxas reported {sorted(usage)}, want {sorted(want)}")
    name = None
    for ln in _sass(library).splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = _bf16_kernel_name(m.group(1))
            name = name if name in BF16_TENSOR_CORE_KERNELS else None
            if name:
                usage[name].update(hmma=0, hmma_bf16=0, hgmma_bf16=0)
        elif name and "MMA" in ln:
            usage[name]["hmma"] += 1
            usage[name]["hmma_bf16"] += "BF16" in ln
            usage[name]["hgmma_bf16"] += "HGMMA" in ln and "BF16" in ln
    if _sass(library):
        for name in BF16_TENSOR_CORE_KERNELS:
            _require(usage[name].get("hmma_bf16", 0) > 0,
                     f"{name}: no bf16 HMMA/HGMMA instruction in its SASS ({usage[name]})")
        for name in BF16_HGMMA_KERNELS:
            _require(usage[name].get("hgmma_bf16", 0) > 0,
                     f"{name}: no bf16 HGMMA (wgmma) instruction in its SASS ({usage[name]})")
    for name in BF16_NO_SPILL:
        _require(usage[name].get("stack", 1) == 0 and usage[name].get("spill_stores", 1) == 0,
                 f"{name}: a stack frame or spills ({usage[name]}): a register array in local memory")
    return usage


def _kernel_smem(name: str) -> tuple:
    """Dynamic shared memory bytes and threads of a block of ``name``."""
    if name.startswith("rwkv6_"):
        n = int(name[:-1].split("<")[1])
        quads = n // 4
        if name.startswith("rwkv6_fwd"):
            floats = 2 * 4 * RWKV6_TILE * n + RWKV6_TILE * quads * n + 2 * RWKV6_TILE + n
        else:
            warps = n * n // 256
            floats = (RWKV6_MARKS * n * n + 2 * 5 * RWKV6_SUB * n + RWKV6_SUB * warps * n
                      + RWKV6_SUB * 3 * (n + 4) + 2 * 2 * RWKV6_SUB + n)
        return floats * 4, n * n // 8
    if name.startswith("gmm_"):
        k_major = GMM_TILE * (GMM_BK + 4)
        mn_major = GMM_BK * (GMM_TILE + 8)
        tiles = {"gmm_rows_kernel<false>": k_major + mn_major,
                 "gmm_rows_kernel<true>": 2 * k_major, "gmm_dw_kernel": 2 * mn_major}[name]
        return (GMM_STAGES * tiles + 2 * GMM_TILE * GMM_BK) * 4, GMM_THREADS
    kernel, D = name[:-1].split("<")
    fwd_cols, bwd_cols = FLASH_COLS[int(D)]
    if kernel == "flash_fwd_kernel":
        return (FLASH_ROWS + 4 * fwd_cols) * (int(D) + 4) * 4, 128
    dq = (2 * FLASH_ROWS + 4 * bwd_cols) * (int(D) + 4) * 4
    return (dq + 16 * bwd_cols if kernel == "flash_bwd_dkdv_kernel" else dq), 128


def _ptxas_usage(log: str, namer) -> dict:
    """Registers, stack and spills (``ptxas -v``) of each kernel to which
    ``namer`` gives a name from its mangled symbol (None: left out)."""
    usage: dict = {}
    name = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = namer(m.group(1))
            if name:
                usage[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            usage[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage


def _kernel_usage(log: str, library: str) -> dict:
    """Each flash, grouped-matmul and RWKV-6 kernel's registers and spills
    (``ptxas -v``), dynamic shared memory, resident blocks per SM by
    registers and shared memory, and, where ``cuobjdump`` is found, its count
    of TF32 ``HMMA``/``HGMMA`` instructions in the SASS (a flash or
    grouped-matmul kernel with none fails the phase: its products would not
    be on the tensor cores; the RWKV-6 kernels run on the CUDA cores)."""
    usage = _ptxas_usage(log, _kernel_name)
    for name, u in usage.items():
        smem, threads = _kernel_smem(name)
        regs_per_warp = -(-u.get("registers", 255) * 32 // 256) * 256
        u.update(smem_bytes=smem, blocks_per_sm=min(SM_REGISTERS // (threads // 32 * regs_per_warp),
                                                     SM_SMEM_BYTES // (smem + 1024), 16))
    _require(len(usage) == 18, f"ptxas reported {sorted(usage)}, want 3 flash kernels x 3 head "
                               "dims, 3 grouped-matmul kernels and 2 RWKV-6 kernels x 3 head sizes")
    if _sass(library):
        name = None
        for ln in _sass(library).splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                name = _kernel_name(m.group(1))
                if name and name.startswith("rwkv6_"):
                    name = None  # CUDA cores: no tensor-core count
                if name:
                    usage[name].update(hmma=0, hmma_tf32=0)
            elif name and "MMA" in ln:
                usage[name]["hmma"] += 1
                usage[name]["hmma_tf32"] += "TF32" in ln
        for name, u in usage.items():
            if name.startswith("rwkv6_"):
                continue
            _require(u.get("hmma_tf32", 0) > 0,
                     f"{name}: no TF32 HMMA/HGMMA instruction in its SASS ({u.get('hmma')} MMA)")
    return usage


def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    seconds = time.perf_counter() - t0
    info = build.build_info()
    usage = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
    for ln in usage:
        print(f"ptxas: {ln}")
    n_src = len(list(build.CSRC_DIR.glob("*.cu")))
    print(f"build: {n_src} sources in {seconds:.2f} s -> {info['path']}")
    log = info["log"] or (build.BUILD_DIR / "build.log").read_text()  # "" when cached
    memory_kernels = ("surrogate_fwd_map_kernel", "gae_kernel", "vtrace_kernel")
    memory = _ptxas_usage(log, lambda sym: next((n for n in memory_kernels if n in sym), None))
    for name, u in memory.items():
        print(f"memory-bound kernel {name}: {json.dumps(u)}")
    _require(sorted(memory) == sorted(memory_kernels), f"ptxas reported {sorted(memory)}, want "
                                                       f"{sorted(memory_kernels)}")
    small = _ptxas_usage(log, _small_gmm_name)
    for name, u in small.items():
        rows = int(name[:-1].split("<")[1])
        regs_per_warp = -(-u.get("registers", 255) * 32 // 256) * 256
        u.update(smem_bytes=4 * rows * 128 * 4,
                 blocks_per_sm=min(SM_REGISTERS // (8 * regs_per_warp), 8))
        print(f"CUDA-core kernel {name}: {json.dumps(u)}")
    _require(sorted(small) == sorted(GMM_SMALL_KERNELS),
             f"ptxas reported {sorted(small)}, want {sorted(GMM_SMALL_KERNELS)}")
    for name, u in {**memory, **small}.items():
        _require(u.get("stack", 1) == 0 and u.get("spill_stores", 1) == 0,
                 f"{name}: a stack frame or spills ({u}): a register array in local memory")
    usage = _kernel_usage(log, info["path"])
    rwkv6 = {name: u for name, u in usage.items() if name.startswith("rwkv6_")}
    tensor_core = {name: u for name, u in usage.items() if name not in rwkv6}
    for name, u in tensor_core.items():
        print(f"tensor-core kernel {name}: {json.dumps(u)}")
    for name, u in rwkv6.items():
        print(f"CUDA-core kernel {name}: {json.dumps(u)}")
    bf16 = _bf16_kernel_usage(log, info["path"])
    for name, u in bf16.items():
        print(f"bf16 kernel {name}: {json.dumps(u)}")
    return {"build_s": seconds, "tensor_core_kernels": tensor_core, "rwkv6_kernels": rwkv6,
            "memory_kernels": memory, "small_gmm_kernels": small, "bf16_kernels": bf16}


# ----------------------------------------------------------------- phase 3
# The plain GAE and V-trace loops issue ~10 launches a time step: from this
# many steps on they are timed by events, not profiled (on an H100 their
# traces took most of those cases' seconds).
LONG_SCAN = 128


def _gae_case(T: int, B: int, seed: int, plain_iters: int = 5) -> dict:
    import torch

    from repro_torch.kernels.advantages import gae_cuda
    from repro_torch.rl.advantages import gae

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = torch.randn((T, B), generator=g, device="cuda")
    v = torch.randn((T, B), generator=g, device="cuda")
    d = (torch.rand((T, B), generator=g, device="cuda") < 0.1).float()
    last = torch.randn((B,), generator=g, device="cuda")
    adv_k, ret_k = gae_cuda(r, v, d, last, gamma=0.99, lam=0.95)
    adv_2, ret_2 = gae_cuda(r, v, d, last, gamma=0.99, lam=0.95)
    adv_p, ret_p = gae(r, v, d, last, gamma=0.99, lam=0.95)
    torch.cuda.synchronize()
    err = max(_close(f"gae[{T},{B}] adv", adv_k, adv_p), _close(f"gae[{T},{B}] ret", ret_k, ret_p))
    _require(torch.equal(adv_k, adv_2) and torch.equal(ret_k, ret_2),
             f"gae[{T},{B}]: two calls differ (not bitwise repeatable)")
    ops, nbytes = _formula("gae", {"tb": T * B, "b": B})
    bound, by = _bound_ms(nbytes, ops)
    return {
        "shape": [T, B], "max_abs_err": err, "bitwise_repeatable": True, "bound_ms": bound,
        "bound_by": by, "bytes": nbytes, "library_ms": None,
        **_timings(lambda: gae_cuda(r, v, d, last), lambda: gae(r, v, d, last),
                   plain_iters=plain_iters, plain_profile=T < LONG_SCAN),
    }


def _vtrace_case(shape: tuple, seed: int, rho_clip: float = 1.0, c_clip: float = 1.0,
                 plain_iters: int = 5) -> dict:
    """V-trace kernel against its plain loop on time-major ``shape``: about
    10 % dones, log-ratios spread so rho lands below and above the clips,
    and every fifth element with target == behaviour log-prob exactly; two
    calls must agree bitwise."""
    import torch

    from repro_torch.kernels.advantages import vtrace_cuda
    from repro_torch.rl.advantages import vtrace

    g = torch.Generator(device="cuda").manual_seed(seed)
    blp = -2.0 * torch.rand(shape, generator=g, device="cuda") - 0.05
    tlp = blp + 0.8 * torch.randn(shape, generator=g, device="cuda")
    tlp.view(-1)[::5] = blp.view(-1)[::5]
    r = torch.randn(shape, generator=g, device="cuda")
    v = torch.randn(shape, generator=g, device="cuda")
    d = (torch.rand(shape, generator=g, device="cuda") < 0.1).float()
    last = torch.randn(shape[1:], generator=g, device="cuda")
    rho = torch.exp(tlp - blp)
    _require(bool((rho < min(rho_clip, c_clip)).any()) and bool((rho > max(rho_clip, c_clip)).any()),
             f"vtrace{list(shape)}: rho does not straddle the clips")
    kw = dict(gamma=0.99, rho_clip=rho_clip, c_clip=c_clip)
    vs_k, pg_k = vtrace_cuda(blp, tlp, r, v, d, last, **kw)
    vs_2, pg_2 = vtrace_cuda(blp, tlp, r, v, d, last, **kw)
    vs_p, pg_p = vtrace(blp, tlp, r, v, d, last, **kw)
    torch.cuda.synchronize()
    name = f"vtrace{list(shape)} clips {rho_clip}/{c_clip}"
    err = max(_close(f"{name} vs", vs_k, vs_p), _close(f"{name} pg_adv", pg_k, pg_p))
    _require(torch.equal(vs_k, vs_2) and torch.equal(pg_k, pg_2),
             f"{name}: two calls differ (not bitwise repeatable)")
    T, B = shape[0], math.prod(shape[1:])
    ops, nbytes = _formula("vtrace", {"tb": T * B, "b": B})
    bound, by = _bound_ms(nbytes, ops)
    return {
        "shape": list(shape), "rho_clip": rho_clip, "c_clip": c_clip, "max_abs_err": err,
        "bitwise_repeatable": True, "bound_ms": bound, "bound_by": by, "bytes": nbytes,
        "library_ms": None,
        **_timings(lambda: vtrace_cuda(blp, tlp, r, v, d, last, **kw),
                   lambda: vtrace(blp, tlp, r, v, d, last, **kw), plain_iters=plain_iters,
                   plain_profile=shape[0] < LONG_SCAN),
    }


def _surrogate_inputs(B: int, A: int, seed: int, clip_eps: float):
    """Random rows plus, at the top, rows with zero logits whose ratio is
    exactly 1 (the min() ties inside the clip band) and rows exactly on the
    hi and lo clip bounds: logits [30, 0, ...] with action 0 make logp
    exactly 0 (the exp sum rounds to 1), so the ratio is exp(-blp), and a
    searched blp pins it to the bound."""
    import torch

    from repro_torch.kernels.surrogate import ppo_surrogate_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = torch.randn((B, A), generator=g, device="cuda")
    actions = torch.randint(0, A, (B,), generator=g, device="cuda")
    values = torch.randn((B,), generator=g, device="cuda")
    adv = torch.randn((B,), generator=g, device="cuda")
    ret = torch.randn((B,), generator=g, device="cuda")
    n = max(B // 16, 1)
    logits[: 3 * n] = 0.0
    logits[n: 3 * n, 0] = 30.0
    actions[n: 3 * n] = 0
    logp = torch.log_softmax(logits, -1).gather(-1, actions[:, None])[:, 0]
    _require(bool((logp[n: 3 * n] == 0).all()), "boundary rows: logp is not exactly 0")
    blp = logp + 0.3 * torch.randn((B,), generator=g, device="cuda")
    blp[:n] = logp[:n]
    bounds = torch.tensor([1.0 + clip_eps, 1.0 - clip_eps], dtype=torch.float32, device="cuda")
    for k in (1, 2):
        target = bounds[k - 1]
        cand = -torch.log(target) + torch.arange(-64, 65, device="cuda") * 5e-9
        hit = torch.nonzero(torch.exp(-cand) == target)[:, 0]
        _require(hit.numel() > 0, f"no behaviour logp puts the ratio exactly on {float(target)}")
        blp[k * n: (k + 1) * n] = cand[hit[hit.numel() // 2]]
    kl = ppo_surrogate_plain(logits, values, actions, blp, adv, ret, clip_eps=clip_eps)[3]
    ratio = torch.exp(-kl)  # kl = blp - logp
    _require(bool((ratio[:n] == 1.0).all()), "ratio-1 rows are not exactly 1")
    for k in (1, 2):
        _require(bool((ratio[k * n: (k + 1) * n] == bounds[k - 1]).all()),
                 "boundary rows are not exactly on the clip bound")
    return logits, actions, values, blp, adv, ret


def _surrogate_case(B: int, A: int, seed: int, clip_eps: float = 0.2, plain_iters: int = 10) -> dict:
    import torch

    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.surrogate import (
        ppo_surrogate_cuda,
        ppo_surrogate_plain,
        surrogate_bwd_cuda,
        surrogate_fwd_cuda,
    )

    logits, actions, values, blp, adv, ret = _surrogate_inputs(B, A, seed, clip_eps)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cots = [torch.randn((B,), generator=g, device="cuda") for _ in range(4)]

    def run(fn):
        xs = [t.clone().requires_grad_(True) for t in (logits, values, blp, adv, ret)]
        terms = fn(xs[0], xs[1], actions, xs[2], xs[3], xs[4], clip_eps=clip_eps)
        grads = torch.autograd.grad(terms, xs, grad_outputs=cots)
        return [t.detach() for t in terms], grads

    terms_k, grads_k = run(ppo_surrogate_cuda)
    terms_p, grads_p = run(ppo_surrogate_plain)
    torch.cuda.synchronize()
    fwd_err = max(
        _close(f"surrogate[{B},{A}] {n}", k, p)
        for n, k, p in zip(("pg", "vf", "ent", "kl"), terms_k, terms_p)
    )
    bwd_err = max(
        _close(f"surrogate[{B},{A}] d{n}", k, p)
        for n, k, p in zip(("logits", "values", "blp", "adv", "ret"), grads_k, grads_p)
    )

    # Timing: the forward kernel alone, the backward kernel alone, and the
    # plain version's forward and its autograd backward.
    xs = [t.clone().requires_grad_(True) for t in (logits, values, blp, adv, ret)]
    plain_terms = ppo_surrogate_plain(xs[0], xs[1], actions, xs[2], xs[3], xs[4], clip_eps=clip_eps)

    def plain_fwd():
        with torch.no_grad():
            ppo_surrogate_plain(xs[0], xs[1], actions, xs[2], xs[3], xs[4], clip_eps=clip_eps)

    fwd_t = _timings(
        lambda: surrogate_fwd_cuda(logits, actions, values, blp, adv, ret, clip_eps),
        plain_fwd, plain_iters=plain_iters,
    )
    # The backward alone, fed the forward's saved row logsumexp and entropy;
    # the forward's five outputs must be bitwise equal across two calls.
    first = surrogate_fwd_cuda(logits, actions, values, blp, adv, ret, clip_eps)
    again = surrogate_fwd_cuda(logits, actions, values, blp, adv, ret, clip_eps)
    torch.cuda.synchronize()
    _require(all(torch.equal(a, b) for a, b in zip(first, again)),
             f"surrogate[{B},{A}] forward: two calls differ (not bitwise repeatable)")
    _, _, ent, _, lse = first
    bwd_t = _timings(
        lambda: surrogate_bwd_cuda(logits, actions, values, blp, adv, ret, lse, ent, *cots,
                                   clip_eps),
        lambda: torch.autograd.grad(plain_terms, xs, grad_outputs=cots, retain_graph=True),
        plain_iters=plain_iters,
    )

    fwd_ops, fwd_bytes = _formula("ppo_surrogate", {"b": B, "a": A})
    bwd_ops, bwd_bytes = _formula("ppo_surrogate_bwd", {"b": B, "a": A})
    fwd_bound = _bound_ms(fwd_bytes, fwd_ops)
    bwd_bound = _bound_ms(bwd_bytes, bwd_ops)
    shape = [B, A]
    chunks = load_library().ppo_surrogate_fwd_chunks(A)
    if chunks:
        # torch.logsumexp reads the same logits once: a yardstick of the
        # forward's bytes, not the same function (so not library_ms).
        lse_t = _library(lambda: torch.logsumexp(logits, dim=-1))
        fwd_t.update(logsumexp_ms=lse_t["library_ms"], logsumexp_call_ms=lse_t["library_call_ms"])
        print(f"  surrogate[{B},{A}] forward: grid (B, chunks) [{B}, {chunks}], {B * chunks} "
              f"blocks; torch.logsumexp {lse_t['library_ms']:.6f} ms")
    return {
        "fwd": {"shape": shape, "max_abs_err": fwd_err, "bitwise_repeatable": True,
                "chunks": chunks, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
                "bytes": fwd_bytes, "library_ms": None, **fwd_t},
        "bwd": {"shape": shape, "max_abs_err": bwd_err, "bound_ms": bwd_bound[0],
                "bound_by": bwd_bound[1], "bytes": bwd_bytes, "library_ms": None, **bwd_t},
    }


def _library(fn, iters: int = 20) -> dict:
    """The PyTorch library call's device ms per call by the profiler
    (``library_ms``, the clock of the kernels' ``ms``), its ms per call on
    the stream (CUDA events, ``library_call_ms``, beside the kernels'
    ``call_ms``), and which SDPA backend it took, read from the names of
    its kernels.  A session that records nothing is retried, as in
    ``_device_ms_retried``."""
    for retries in range(PROFILE_RETRIES + 1):
        kernels, lost = _per_call(fn, iters)
        total_us = sum(kernels.values())
        if total_us > 0:
            break
    names = " ".join(kernels).lower()
    backend = next(
        (b for key, b in (("flash", "flash"), ("fmha", "efficient"), ("cutlass", "efficient"),
                          ("cudnn", "cudnn")) if key in names),
        "math",
    )
    top = sorted(kernels, key=lambda k: -kernels[k])[:3]
    call_ms = _time_ms(fn, iters=iters, warmup=2)
    return {
        "library_ms": total_us / 1e3 if total_us > 0 else call_ms,
        "library_ms_from": "profiler" if total_us > 0 else "cuda_events",
        "library_call_ms": call_ms,
        "library_records_lost": lost,
        "library_profile_retries": retries,
        "library_backend": backend,
        "library_kernels": [k[:60] for k in top],
    }


def _randn(g, *shape):
    import torch

    return torch.randn(shape, generator=g, device="cuda")


def _decode_case(B: int, H: int, KV: int, D: int, W: int, mode: str, seed: int,
                 bf16: bool = False) -> dict:
    """``mode``: "ragged" (per-lane [B, W] lengths in [1, W]), "ring" (a
    wrapped ring buffer: lane b holds slots [start_b, start_b + len_b) mod W,
    not a prefix), "empty_row" (ragged, lane 1 has no valid slot and must
    give exact zeros) or "shared" (one [W] mask).  The kernel's output must
    be bitwise equal across two calls.  With ``bf16``, the bf16 kernel on
    the same inputs rounded to bf16, within ``_close_rows``' limit, its bytes
    at 2 an element and SDPA at bf16 beside it, its launch (cluster, stages,
    blocks) from ``bf16_decode_plan``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        bf16_decode_plan,
        decode_attention_cuda,
        decode_attention_plain,
        decode_splits,
        heads_per_block,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, kc, vc = _randn(g, B, 1, H, D), _randn(g, B, W, KV, D), _randn(g, B, W, KV, D)
    if bf16:
        q, kc, vc = q.bfloat16(), kc.bfloat16(), vc.bfloat16()
    pos = torch.arange(W, device="cuda")
    if mode == "shared":
        valid = pos < W - W // 7
    else:
        lens = torch.randint(1, W + 1, (B,), generator=g, device="cuda")
        valid = pos[None] < lens[:, None]
        if mode == "ring":
            start = torch.randint(1, W, (B,), generator=g, device="cuda")
            valid = (pos[None] - start[:, None]) % W < lens[:, None]
        if mode == "empty_row":
            valid[1] = False
    got = decode_attention_cuda(q, kc, vc, valid)
    again = decode_attention_cuda(q, kc, vc, valid)
    want = decode_attention_plain(q, kc, vc, valid)
    torch.cuda.synchronize()
    name = f"decode_attention{'_bf16' if bf16 else ''}[{B},1,{H},{D}] W={W} {mode}"
    _require(got.dtype == q.dtype, f"{name}: output {got.dtype} from {q.dtype} inputs")
    err, ratio = _close_rows(name, got, want) if bf16 else (_close(name, got, want), None)
    _require(torch.equal(got, again), f"{name}: two calls differ (not bitwise repeatable)")
    if mode == "empty_row":
        _require(bool((got[1] == 0).all()), "decode_attention: an all-invalid row is not exactly 0")
    g_ = H // KV
    if bf16:
        plan = bf16_decode_plan(B, KV, g_, D, W)
        launch = {"cluster": plan.cluster, "stages": plan.stages, "blocks": plan.blocks,
                  "smem": plan.smem}
        print(f"  {name}: clusters of {plan.cluster} (B, KV, head chunks of 16) "
              f"{[B, KV, -(-g_ // 16)]}, {plan.blocks} blocks, {plan.stages} stages, "
              f"{plan.smem} bytes of shared memory a block")
    else:
        splits = decode_splits(B, KV, g_, D, W)
        grid = [B, KV, -(-g_ // heads_per_block(g_)), splits]
        launch = {"splits": splits, "grid": grid}
        print(f"  {name}: splits {splits}, grid (B, KV, head chunks, splits) {grid}, "
              f"{math.prod(grid)} blocks")
    n_valid = int(valid.sum()) * (B if valid.dim() == 1 else 1)
    ops, nbytes = _formula("decode_attention", {"b": B, "h": H, "kv": KV, "d": D, "w": W,
                                                "n_valid": n_valid, "mask": valid.numel(),
                                                **({"es": 2} if bf16 else {})})
    bound, by = _bound_ms(nbytes, ops)
    mask = valid[None, None, None, :] if valid.dim() == 1 else valid[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    out = {
        "shape": [B, 1, H, KV, D, W], "mode": mode, "max_abs_err": err, "bitwise_repeatable": True,
        **({"err_over_limit": ratio} if bf16 else {}),
        **launch, "bound_ms": bound, "bound_by": by, "bytes": nbytes,
        **_timings(lambda: decode_attention_cuda(q, kc, vc, valid),
                   lambda: decode_attention_plain(q, kc, vc, valid), plain_iters=5),
    }
    if mode != "empty_row":  # SDPA's softmax over an empty row is NaN
        out.update(_library(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)))
    return out


def _plain_iters(kernel_iters: int) -> int:
    """Timed calls of an attention case's plain version: one at the large
    shapes (those whose kernel is timed over 20 calls or fewer, where the
    plain version takes tens of milliseconds a call), five elsewhere."""
    return 1 if kernel_iters <= 20 else 5


def _visible_pairs(Sq: int, Sk: int, causal: bool, window: int, q_offset: int):
    import torch

    q_pos = q_offset + torch.arange(Sq, device="cuda")
    k_pos = torch.arange(Sk, device="cuda")
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask, int(mask.sum())


def _sdpa(q, k, v, mask, simple_causal: bool):
    """The library yardstick: SDPA on the port's [B, S, heads, D] tensors."""
    import torch.nn.functional as F

    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if simple_causal:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _flash_fwd_case(B, Sq, Sk, H, KV, D, causal, window, q_offset, seed, kernel_iters=200,
                    bf16=False) -> dict:
    """The forward kernel against the plain version, timed beside SDPA; with
    ``bf16``, the bf16 kernel on the same inputs rounded to bf16, within
    ``_close_rows``' limit and bitwise equal across two calls, its bound one bf16
    tensor-core pass (``_bf16_bounds``) and SDPA at bf16 beside it."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_plain, flash_fwd_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _randn(g, B, Sq, H, D), _randn(g, B, Sk, KV, D), _randn(g, B, Sk, KV, D)
    if bf16:
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    name = f"flash_attention_fwd{'_bf16' if bf16 else ''}[{B},{Sq},{H}/{KV},{D}] Sk={Sk} {kw}"
    with torch.no_grad():
        got, _ = flash_fwd_cuda(q, k, v, causal, window, q_offset)
        want = flash_attention_plain(q, k, v, **kw)
        if bf16:
            again, _ = flash_fwd_cuda(q, k, v, causal, window, q_offset)
    torch.cuda.synchronize()
    if bf16:
        _require(got.dtype == torch.bfloat16, f"{name}: output {got.dtype}")
        err, ratio = _close_rows(name, got, want)
        _require(torch.equal(got, again), f"{name}: two calls differ (not bitwise repeatable)")
        del again
    else:
        err, ratio = _close(name, got, want), None
    del want
    mask, _ = _visible_pairs(Sq, Sk, causal, window, q_offset)
    flops, nbytes = _formula("flash_attention", {"b": B, "sq": Sq, "sk": Sk, "h": H, "kv": KV,
                                                 "d": D, **kw, **({"es": 2} if bf16 else {})})
    simple = causal and not window and not q_offset and Sq == Sk

    def plain():
        with torch.no_grad():
            flash_attention_plain(q, k, v, **kw)

    return {
        "shape": [B, Sq, H, KV, D], "Sk": Sk, **kw, "max_abs_err": err,
        **(_bf16_bounds(nbytes, flops) if bf16 else _tensor_core_bounds(nbytes, flops)),
        **({"bitwise_repeatable": True, "err_over_limit": ratio} if bf16 else {}),
        **_timings(lambda: flash_fwd_cuda(q, k, v, causal, window, q_offset), plain,
                   plain_iters=_plain_iters(kernel_iters),
                   kernel_iters=kernel_iters),
        **_library(lambda: _sdpa(q, k, v, mask, simple)),
    }


def _flash_bwd_case(B, Sq, Sk, H, KV, D, causal, window, q_offset, seed, kernel_iters=200,
                    clocks=False, bf16=False) -> dict:
    """Backward: gradients of the kernel's autograd.Function against torch
    autograd through the plain version (and bitwise equal across two runs),
    and the backward launch alone timed against the plain version's
    autograd backward and SDPA's, under the same mask; ``clocks`` as
    ``_timings``'.  With ``bf16``, the bf16 kernels on the inputs rounded to
    bf16 (and dO), each gradient within ``GRAD_ROW_TOL`` per row
    (``_close_rows``; dq's limit plus ``_dq_allowance``), the bound one bf16
    tensor-core pass a product and SDPA's bf16 backward beside it."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
        flash_bwd_cuda,
        flash_fwd_cuda,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _randn(g, B, Sq, H, D), _randn(g, B, Sk, KV, D), _randn(g, B, Sk, KV, D)
    dout = _randn(g, B, Sq, H, D)
    if bf16:
        q, k, v, dout = q.bfloat16(), k.bfloat16(), v.bfloat16(), dout.bfloat16()
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    name = f"flash_attention_bwd{'_bf16' if bf16 else ''}[{B},{Sq},{H}/{KV},{D}] Sk={Sk} {kw}"

    def grads(fn):
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*xs, **kw)
        return torch.autograd.grad(out, xs, dout, retain_graph=True), (out, xs)

    got, _ = grads(flash_attention_cuda)
    again, _ = grads(flash_attention_cuda)
    want, (plain_out, plain_xs) = grads(flash_attention_plain)
    torch.cuda.synchronize()
    o, lse = flash_fwd_cuda(q, k, v, causal, window, q_offset)
    ratio = None
    if bf16:
        _require(all(x.dtype == torch.bfloat16 for x in got), f"{name}: gradients {got[0].dtype}")
        with torch.no_grad():
            o32 = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        allow = [_dq_allowance(k, dout, o, o32), None, None]
        del o32
        rows = [_close_rows(f"{name} d{n}", a, b, GRAD_ROW_TOL, unit=False, allowance=c)
                for n, a, b, c in zip("qkv", got, want, allow)]
        err, ratio = max(r[0] for r in rows), max(r[1] for r in rows)
        del allow
    else:
        err = max(_close(f"{name} d{n}", a, b, GRAD_TOL) for n, a, b in zip("qkv", got, want))
    _require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
             f"{name}: gradients differ between two runs")
    del got, again, want
    mask, _ = _visible_pairs(Sq, Sk, causal, window, q_offset)
    flops, nbytes = _formula("flash_attention_bwd", {"b": B, "sq": Sq, "sk": Sk, "h": H, "kv": KV,
                                                     "d": D, **kw, **({"es": 2} if bf16 else {})})
    simple = causal and not window and not q_offset and Sq == Sk
    lib_xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = _sdpa(*lib_xs, mask, simple)
    return {
        "shape": [B, Sq, H, KV, D], "Sk": Sk, **kw, "max_abs_err": err, "deterministic": True,
        **(_bf16_bounds(nbytes, flops) if bf16 else _tensor_core_bounds(nbytes, flops)),
        **({"bitwise_repeatable": True, "err_over_limit": ratio} if bf16 else {}),
        **_timings(
            lambda: flash_bwd_cuda(q, k, v, o, lse, dout, causal, window, q_offset),
            lambda: torch.autograd.grad(plain_out, plain_xs, dout, retain_graph=True),
            plain_iters=_plain_iters(kernel_iters), kernel_iters=kernel_iters, clocks=clocks,
        ),
        **_library(lambda: torch.autograd.grad(lib_out, lib_xs, dout.transpose(1, 2), retain_graph=True)),
    }


def _rwkv6_inputs(B: int, T: int, H: int, N: int, seed: int, state: bool,
                  clip_share: float = 0.0):
    """r, k, v ~ N(0, 0.25); decays from the model's own law at its
    initial bias, w = exp(-exp(clip(-2 + 0.5 z, -8, 2))), with a share
    ``clip_share`` of them at the clip's extremes (half exp(-e^2) ~ 6.17e-4,
    half exp(-e^-8) ~ 0.99966), which the initial bias almost never
    reaches; u ~ N(0, 0.01); a start state ~ N(0, 1) when asked for."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (0.5 * _randn(g, B, T, H, N) for _ in range(3))
    logit = torch.clamp(-2.0 + 0.5 * _randn(g, B, T, H, N), -8.0, 2.0)
    if clip_share:
        z = torch.rand((B, T, H, N), generator=g, device="cuda")
        logit = torch.where(z < clip_share / 2, 2.0, torch.where(z < clip_share, -8.0, logit))
    w = torch.exp(-torch.exp(logit))
    u = 0.1 * _randn(g, H, N)
    s0 = _randn(g, B, H, N, N) if state else None
    return r, k, v, w, u, s0


def _rwkv6_case(B: int, T: int, H: int, N: int, seed: int, state: bool = False,
                chunk: int = 64, kernel_iters: int = 50, check_profiler: bool = False,
                clip_share: float = 0.0, clocks: bool = False, bf16: bool = False) -> dict:
    """Forward (out, final state) and the gradients of all inputs, with
    cotangents on the output and the final state, through the kernels'
    autograd.Function, against the plain loop in float64 (chunk-checkpointed,
    as the reference's oracle) and its autograd; the backward twice, for
    bitwise equal gradients.  The oracle runs in float64 because du sums
    B * T steps: at [2, 4096, 64, 64] on an H100 the float32 plain loop's
    own du is 6.8e-4 away from the oracle in places, more than the
    tolerance.  Times are of the float32 plain loop, its backward timed
    once (a second plain backward, about 5 s at that shape, is not run).
    With
    ``check_profiler``, also ``_profiler_records`` of the forward; with
    ``clocks``, the card's clocks beside each kernel reading.  With ``bf16``,
    the bf16 kernels on r, k, v, w and the output's cotangent rounded to
    bf16 (u, the states and their cotangent float32): the output and dr,
    dk, dv, dw against the oracle rounded to bf16 once, per row within
    ``GRAD_ROW_TOL`` (``_close_rows``; the output's row scale at most 1),
    the final state, du and the start state's gradient as the float32
    case's; the plain version timed is the bf16 one (float32 inside)."""
    import torch

    from repro_torch.kernels.rwkv6 import rwkv6_bwd_cuda, rwkv6_cuda, rwkv6_fwd_cuda, rwkv6_plain

    xs = list(_rwkv6_inputs(B, T, H, N, seed, state, clip_share))
    s0 = xs[5]
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cot_o, cot_s = _randn(g, B, T, H, N), _randn(g, B, H, N, N)
    if bf16:  # the streams and dO in bf16, u and the states float32
        xs[:4] = [x.bfloat16() for x in xs[:4]]
        cot_o = cot_o.bfloat16()
    name = (f"rwkv6{'_bf16' if bf16 else ''}[{B},{T},{H},{N}]"
            + (" with a start state" if state else "")
            + (f" with {clip_share} of the decays at the clip" if clip_share else ""))

    def grads(fn, dtype, **kw):
        """Through ``fn`` with every input in ``dtype`` (None: as made)."""
        ts = [(x if dtype is None else x.to(dtype)).clone().requires_grad_(True)
              for x in xs if x is not None]
        out, final = fn(*ts[:5], state=ts[5] if state else None, chunk=chunk, **kw)
        cots = (cot_o, cot_s) if dtype is None else (cot_o.to(dtype), cot_s.to(dtype))
        return (out, final), ts, torch.autograd.grad((out, final), ts, cots, retain_graph=True)

    own = None if bf16 else torch.float32
    (out_k, fin_k), _, got = grads(rwkv6_cuda, own)
    _, _, again = grads(rwkv6_cuda, own)
    (out_p, fin_p), _, want = grads(rwkv6_plain, torch.float64)
    torch.cuda.synchronize()
    names = ["r", "k", "v", "w", "u", "state"]
    ratio = None
    if bf16:
        _require(out_k.dtype == torch.bfloat16 and all(a.dtype == torch.bfloat16 for a in got[:4])
                 and got[4].dtype == torch.float32,
                 f"{name}: output {out_k.dtype}, gradients {[a.dtype for a in got]}")
        out_err, out_ratio = _close_rows(f"{name} out", out_k.detach(), out_p.detach().bfloat16(),
                                         GRAD_ROW_TOL, unit=True)
        fwd_err = max(out_err, _close(f"{name} final state", fin_k.detach().double(), fin_p.detach()))
        rows = [_close_rows(f"{name} d{n}", a, b.bfloat16(), GRAD_ROW_TOL, unit=False)
                for n, a, b in zip(names[:4], got[:4], want[:4])]
        bwd_err = max([r[0] for r in rows] + [_close(f"{name} d{n}", a.double(), b, GRAD_TOL)
                                              for n, a, b in zip(names[4:], got[4:], want[4:])])
        ratio = {"fwd": out_ratio, "bwd": max(r[1] for r in rows)}
    else:
        fwd_err = max(_close(f"{name} out", out_k.detach().double(), out_p.detach()),
                      _close(f"{name} final state", fin_k.detach().double(), fin_p.detach()))
        bwd_err = max(_close(f"{name} d{n}", a.double(), b, GRAD_TOL)
                      for n, a, b in zip(names, got, want))
    _require(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
             f"{name}: gradients differ between two runs")
    del got, again, out_k, fin_k, out_p, fin_p
    del want
    # The plain version's graph (float32, or the bf16 plain version), whose
    # backward is timed once below.
    plain_ts = [(x if own is None else x.to(own)).clone().requires_grad_(True)
                for x in xs if x is not None]
    out_p, fin_p = rwkv6_plain(*plain_ts[:5], state=plain_ts[5] if state else None, chunk=chunk)

    r, k, v, w, u = xs[:5]
    plain_graph = (out_p, fin_p)

    def plain_fwd():
        with torch.no_grad():
            rwkv6_plain(r, k, v, w, u, state=s0)

    _, _, ckpt = rwkv6_fwd_cuda(r, k, v, w, u, s0, chunk, True)
    fwd_t = _timings(lambda: rwkv6_fwd_cuda(r, k, v, w, u, s0, chunk, True), plain_fwd,
                     plain_iters=1, kernel_iters=kernel_iters, plain_profile=False, clocks=clocks)
    if check_profiler:
        fwd_t["profiler_records"] = _profiler_records(
            lambda: rwkv6_fwd_cuda(r, k, v, w, u, s0, chunk, True))
        print(f"profiler records of {name}'s forward: {fwd_t['profiler_records']}")
    bwd_t = _timings(
        lambda: rwkv6_bwd_cuda(r, k, v, w, u, cot_o, ckpt, cot_s, chunk, state),
        lambda: torch.autograd.grad(plain_graph, plain_ts, (cot_o, cot_s), retain_graph=True),
        plain_iters=1, kernel_iters=kernel_iters, plain_profile=False, clocks=clocks,
    )
    del plain_graph, plain_ts, out_p, fin_p

    key = {"b": B, "t": T, "h": H, "n": N, "state": state, "chunk": chunk,
           **({"es": 2} if bf16 else {})}
    fwd_ops, fwd_bytes = _formula("rwkv6", key)
    bwd_ops, bwd_bytes = _formula("rwkv6_bwd", key)
    fwd_bound = _bound_ms(fwd_bytes, fwd_ops)
    bwd_bound = _bound_ms(bwd_bytes, bwd_ops)
    shape = [B, T, H, N]
    common = {"shape": shape, "state": state, "chunk": chunk, "clip_share": clip_share,
              "library_ms": None}
    extra = ({"fwd": {"bitwise_repeatable": True, "err_over_limit": ratio["fwd"]},
              "bwd": {"err_over_limit": ratio["bwd"]}} if bf16 else {"fwd": {}, "bwd": {}})
    return {
        "fwd": {**common, "max_abs_err": fwd_err, "bound_ms": fwd_bound[0],
                "bound_by": fwd_bound[1], "bytes": fwd_bytes, **extra["fwd"], **fwd_t},
        "bwd": {**common, "max_abs_err": bwd_err, "deterministic": True, "bound_ms": bwd_bound[0],
                "bound_by": bwd_bound[1], "bytes": bwd_bytes, **extra["bwd"], **bwd_t},
    }


def _gmm_inputs(sizes: list, D: int, F: int, seed: int, tail: int):
    """x [T, D] and dy [T, F] N(0, 1) and w [E, D, F] N(0, 1/D), as the
    model's experts, so the forward's and dX's outputs are O(1); T is the
    groups' rows plus ``tail`` rows past the last group."""
    import torch

    E, T = len(sizes), sum(sizes) + tail
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, dy = _randn(g, T, D), _randn(g, T, F)
    w = _randn(g, E, D, F) / math.sqrt(D)
    return x, dy, w, torch.tensor(sizes, dtype=torch.int32, device="cuda")


def _gmm_library(sizes: list, fn) -> dict:
    """With equal groups, the PyTorch call on the same inputs that the
    grouped product replaces (``fn``), else None."""
    if len(set(sizes)) != 1:
        return {"library_ms": None}
    out = _library(fn, iters=5)
    out["library_backend"] = "cublas"
    return out


def _gmm_close(name: str, got, want, bf16: bool) -> float:
    """``_close`` at ``GMM_TOL``, or for bf16 outputs at ``BF16_TOL`` in float32."""
    if bf16:
        _require(got.dtype == want.dtype, f"{name}: output {got.dtype}, plain {want.dtype}")
        return _close(name, got.float(), want.float(), BF16_TOL)
    return _close(name, got, want, GMM_TOL)


def _gmm_case(sizes: list, D: int, F: int, seed: int, kernel_iters: int = 20,
              overrun: int = 0, tail: int = 0, bf16: bool = False) -> dict:
    """The grouped matmul against the loop over groups.  With ``overrun``,
    also the same groups over x cut by that many rows: groups that sum past
    x's end are cut there by both versions; with ``tail``, x has that many
    rows past the last group, which come out zero.  With ``bf16``, the bf16
    tile kernel on x and w rounded to bf16, bitwise equal across two calls,
    its bound one bf16 tensor-core pass and ``torch.bmm`` at bf16 beside
    it."""
    import torch

    from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_plain

    x, _, w, gs = _gmm_inputs(sizes, D, F, seed, tail)
    if bf16:
        x, w = x.bfloat16(), w.bfloat16()
    (T, _), E = x.shape, len(sizes)
    name = f"moe_gmm{'_bf16' if bf16 else ''} [{T}, {D}] x [{E}, {D}, {F}] groups {sizes[:6]}..."
    got = moe_gmm_cuda(x, w, gs)
    want = moe_gmm_plain(x, w, gs)
    if bf16:
        _require(torch.equal(got, moe_gmm_cuda(x, w, gs)),
                 f"{name}: two calls differ (not bitwise repeatable)")
    torch.cuda.synchronize()
    err = _gmm_close(name, got, want, bf16)
    del got, want
    if overrun:
        cut = x[: T - overrun]
        err = max(err, _gmm_close(f"{name} groups summing to {T} over {T - overrun} rows",
                                  moe_gmm_cuda(cut, w, gs), moe_gmm_plain(cut, w, gs), bf16))
    flops, nbytes = _formula("moe_gmm", {"t": T, "d": D, "f": F, "e": E,
                                         **({"es": 2} if bf16 else {})})
    path = sizes == [MOE_GMM_UP[0] // MOE_GMM_UP[3]] * MOE_GMM_UP[3] and not bf16
    return {
        "shape": [T, D, F, E], "groups": sizes, "tail": tail, "max_abs_err": err,
        **(_bf16_bounds(nbytes, flops) if bf16 else _tensor_core_bounds(nbytes, flops)),
        **({"bitwise_repeatable": True} if bf16 else {}),
        **_timings(lambda: moe_gmm_cuda(x, w, gs), lambda: moe_gmm_plain(x, w, gs),
                   plain_iters=3, kernel_iters=kernel_iters, clocks=path),
        **_gmm_library(sizes, lambda: torch.bmm(x.view(E, sizes[0], D), w)),
    }


def _gmm_small_case(sizes: list, D: int, F: int, seed: int, block_m: int,
                    kernel_iters: int = 20, overrun: int = 0, tail: int = 0,
                    bf16: bool = False) -> dict:
    """The small-group kernel (``moe_gmm_small_cuda`` at ``block_m``) against
    the loop over groups, twice (bitwise equal), with ``overrun`` and
    ``tail`` as ``_gmm_case``; timed beside the 128-row-tile kernel on the
    same inputs (``tile_ms``) and, with equal groups, ``torch.bmm``.  Its
    bound: the bytes, or the flops at the fp32 rate of the CUDA cores it
    runs on.  With ``bf16``, the bf16 kernels on x and w rounded to bf16,
    within ``BF16_TOL``, the bytes at 2 an element."""
    import torch

    from repro_torch.kernels.moe_gmm import (
        SMALL_COLS,
        moe_gmm_cuda,
        moe_gmm_plain,
        moe_gmm_small_cuda,
        small_chunks,
        small_rows,
    )

    x, _, w, gs = _gmm_inputs(sizes, D, F, seed, tail)
    if bf16:
        x, w = x.bfloat16(), w.bfloat16()
    (T, _), E = x.shape, len(sizes)
    name = (f"moe_gmm_small{'_bf16' if bf16 else ''} [{T}, {D}] x [{E}, {D}, {F}] groups "
            f"{sizes[:8]}... block_m {block_m}")
    got = moe_gmm_small_cuda(x, w, gs, block_m)
    again = moe_gmm_small_cuda(x, w, gs, block_m)
    want = moe_gmm_plain(x, w, gs)
    torch.cuda.synchronize()
    err = _gmm_close(name, got, want, bf16)
    _require(bool(torch.equal(got, again)), f"{name}: two calls differ (not bitwise repeatable)")
    del got, again, want
    if overrun:
        cut = x[: T - overrun]
        err = max(err, _gmm_close(f"{name}, groups summing to {T} over {T - overrun} rows",
                                  moe_gmm_small_cuda(cut, w, gs, block_m),
                                  moe_gmm_plain(cut, w, gs), bf16))
    # The work this run's groups need: an empty group reads no w_e, and the
    # tail's rows are written (zeros) but not read.
    used = sum(1 for s in sizes if s)
    es = 2 if bf16 else 4
    flops, nbytes = _formula("moe_gmm", {"t": T - tail, "d": D, "f": F, "e": used,
                                         **({"es": es} if bf16 else {})})
    nbytes += es * tail * F
    bound, by = _bound_ms(nbytes, flops)

    def tile():
        return moe_gmm_cuda(x, w, gs, block_m=128)

    # The chunks of D the wrapper splits into: those that fill the SMs' last wave.
    chunks = small_chunks(x.device, D, F, E, small_rows(block_m), bf16)
    tile_ms, _, _ = _device_ms_retried(tile, kernel_iters)
    tile_call_ms = _time_ms(tile, iters=kernel_iters, warmup=2)
    return {
        "shape": [T, D, F, E], "groups": sizes, "tail": tail, "block_m": block_m,
        "rows_a_chunk": small_rows(block_m), "chunks": chunks,
        "blocks": -(-F // SMALL_COLS) * (E * chunks + 1),
        "max_abs_err": err, "bitwise_repeatable": True, "bound_ms": bound, "bound_by": by,
        "bytes": nbytes, "flops": flops,
        **_timings(lambda: moe_gmm_small_cuda(x, w, gs, block_m), lambda: moe_gmm_plain(x, w, gs),
                   plain_iters=3, kernel_iters=kernel_iters),
        "tile_ms": tile_ms if tile_ms is not None else tile_call_ms,
        "tile_ms_from": "profiler" if tile_ms is not None else "cuda_events",
        "tile_call_ms": tile_call_ms,
        **_gmm_library(sizes, lambda: torch.bmm(x.view(E, sizes[0], D), w)),
    }


def _gmm_small_cases(bf16: bool = False) -> list:
    """The small-group kernel at the serving paths' decode products, up and
    down at block_m 2 (DeepSeek's up product, the path's shape, first); at
    groups of 1, 3 and 8 rows at DeepSeek's decode widths; and at 64 ragged
    groups of 0-8 rows with empty ones at those widths, alone, with groups
    past x's end, and with rows past the last group at F 1,412 (the last
    column slab one lane wide; at bf16, whose kernels take F a multiple of
    8, F 1,416, two lanes)."""
    out = []
    for seed, (T, D, F, E) in enumerate(SERVE_GMM_DECODE.values()):
        for d, f in ((D, F), (F, D)):
            out.append(_gmm_small_case([T // E] * E, d, f, 130 + seed, T // E, bf16=bf16))
    T, D, F, E = SERVE_GMM_DECODE["serve_deepseek"]
    for rows in (1, 3, 8):
        out.append(_gmm_small_case([rows] * E, D, F, 140 + rows, rows, bf16=bf16))
    ragged = [2, 0, 5, 1, 3, 0, 8, 2] * (E // 8)
    out += [_gmm_small_case(ragged, D, F, 150, 8, bf16=bf16),
            _gmm_small_case(ragged, D, F, 151, 8, overrun=6, bf16=bf16),
            _gmm_small_case(ragged, D, F + (8 if bf16 else 4), 152, 8, tail=5, bf16=bf16)]
    return out


def _gmm_bwd_case(sizes: list, D: int, F: int, seed: int, kernel_iters: int = 20,
                  overrun: int = 0, tail: int = 0, batch: int = PRETRAIN["batch"]) -> dict:
    """The backward products of the grouped matmul out = x @ w[e] against the
    loops over groups: dX = dy @ w[e]^T and dW[e] = x_e^T dy_e (twice: bitwise
    equal), with ``overrun`` and ``tail`` as ``_gmm_case``.  For dW, dy is
    scaled by 1 / sqrt(mean group size), so dW is O(1) as the other outputs.
    Each yardstick is the einsum of ``GmmMatmul``'s backward that the kernel
    replaces (``repro/models/moe.py:145``), on the [B, E, C, .] layout of
    the pretraining path (B = ``batch``)."""
    import torch

    from repro_torch.kernels.moe_gmm import (
        moe_gmm_dw_cuda,
        moe_gmm_dw_plain,
        moe_gmm_dx_cuda,
        moe_gmm_dx_plain,
    )

    x, dy, w, gs = _gmm_inputs(sizes, D, F, seed, tail)
    (T, _), E = x.shape, len(sizes)
    dyw = dy / math.sqrt(max(1, sum(sizes)) / E)
    name = f"[{T}, {D}] x [{E}, {D}, {F}] groups {sizes[:6]}..."
    dx_err = _close(f"moe_gmm_dx {name}", moe_gmm_dx_cuda(dy, w, gs), moe_gmm_dx_plain(dy, w, gs),
                    GMM_TOL)
    got = moe_gmm_dw_cuda(x, dyw, gs)
    _require(bool(torch.equal(got, moe_gmm_dw_cuda(x, dyw, gs))),
             f"moe_gmm_dw {name}: dW differs between two runs")
    dw_err = _close(f"moe_gmm_dw {name}", got, moe_gmm_dw_plain(x, dyw, gs), GMM_TOL)
    del got
    if overrun:
        n = T - overrun
        dx_err = max(dx_err, _close(f"moe_gmm_dx groups summing to {T} over {n} rows",
                                    moe_gmm_dx_cuda(dy[:n], w, gs), moe_gmm_dx_plain(dy[:n], w, gs),
                                    GMM_TOL))
        dw_err = max(dw_err, _close(f"moe_gmm_dw groups summing to {T} over {n} rows",
                                    moe_gmm_dw_cuda(x[:n], dyw[:n], gs),
                                    moe_gmm_dw_plain(x[:n], dyw[:n], gs), GMM_TOL))
    torch.cuda.synchronize()
    path = sizes == [MOE_GMM_UP[0] // MOE_GMM_UP[3]] * MOE_GMM_UP[3]
    flops, nbytes = _formula("moe_gmm_dx", {"t": T, "d": D, "f": F, "e": E})  # dW's alike
    common = {"shape": [T, D, F, E], "groups": sizes, "tail": tail,
              **_tensor_core_bounds(nbytes, flops)}
    dx_lib, dw_lib = {"library_ms": None}, {"library_ms": None}
    if len(set(sizes)) == 1:
        B = batch
        per_b = (E, B, sizes[0] // B)
        dy4 = dy.view(*per_b, F).transpose(0, 1).contiguous()
        x4 = x.view(*per_b, D).transpose(0, 1).contiguous()
        dx_lib = _gmm_library(sizes, lambda: torch.einsum("becn,ekn->beck", dy4, w))
        dw_lib = _gmm_library(sizes, lambda: torch.einsum("beck,becn->ekn", x4, dy4))
    return {
        "dx": {**common, "max_abs_err": dx_err, **dx_lib,
               **_timings(lambda: moe_gmm_dx_cuda(dy, w, gs), lambda: moe_gmm_dx_plain(dy, w, gs),
                          plain_iters=3, kernel_iters=kernel_iters, clocks=path)},
        "dw": {**common, "max_abs_err": dw_err, "deterministic": True, **dw_lib,
               **_timings(lambda: moe_gmm_dw_cuda(x, dyw, gs),
                          lambda: moe_gmm_dw_plain(x, dyw, gs),
                          plain_iters=3, kernel_iters=kernel_iters, clocks=path)},
    }


def _gmm_cases() -> dict:
    """The grouped matmul and its backward products at the pretraining
    path's two shapes, at ragged groups (an empty one, groups past x's end,
    rows past the last group) and with a group that is not a multiple of
    64."""
    T, D, F, E = MOE_GMM_UP
    ragged = [300, 0, 1000, 77, 129, 640, 1, 511]
    shapes = [([T // E] * E, D, F, 60, 10, 0, 0),  # up and gate products
              ([T // E] * E, F, D, 61, 10, 0, 0),  # down product
              (ragged, 1024, 1536, 62, 20, 600, 0),
              (ragged, 1024, 1536, 64, 20, 0, 250),
              ([1280, 1000, 1280, 1280], D, F, 63, 20, 0, 0)]
    out = {"moe_gmm": [], "moe_gmm_dx": [], "moe_gmm_dw": []}
    for sizes, d, f, seed, iters, overrun, tail in shapes:
        out["moe_gmm"].append(_gmm_case(sizes, d, f, seed, iters, overrun, tail))
        bwd = _gmm_bwd_case(sizes, d, f, seed + 10, iters, overrun, tail)
        out["moe_gmm_dx"].append(bwd["dx"])
        out["moe_gmm_dw"].append(bwd["dw"])
    return out


def _narrow_heads(case, seed: int) -> list:
    """Flash cases at D = 64 and D = 32 (tiles of other sizes than D = 128's):
    GQA with a ragged S, a non-causal one with Sq != Sk, and a window with a
    q_offset."""
    return [
        case(2, 1000, 1000, 16, 4, 64, True, 0, 0, seed),
        case(2, 777, 777, 8, 2, 32, True, 0, 0, seed + 1),
        case(2, 300, 500, 8, 2, 64, False, 0, 0, seed + 2),
        case(2, 300, 812, 8, 8, 32, True, 128, 512, seed + 3),
    ]


def _zoo_kernel_cases(out: dict) -> None:
    """The model zoo's path shapes, appended after each kernel's earlier
    cases: flash forward and backward at the LLaVA, MusicGen (D = 64) and
    Jamba (batch 1) learners and forward at each serving prefill; the grouped
    matmul and its dX and dW at DeepSeek's and Jamba's learner products (up
    and down) and forward at their serving prefill's products; the
    small-group kernel at their decode steps' (``_gmm_small_cases``);
    decode attention at each serving case's heads and window (one shared
    prefix mask, as the path's); RWKV-6 at the serving prefill."""
    t0 = time.perf_counter()
    for seed, (B, S, H, KV, D) in enumerate((LLAVA_ATTENTION, MUSICGEN_ATTENTION, JAMBA_ATTENTION)):
        out["flash_attention_fwd"].append(
            _flash_fwd_case(B, S, S, H, KV, D, True, 0, 0, 80 + seed, kernel_iters=20))
        out["flash_attention_bwd"].append(
            _flash_bwd_case(B, S, S, H, KV, D, True, 0, 0, 83 + seed, kernel_iters=10))
    for seed, (B, S, H, KV, D) in enumerate(SERVE_PREFILL_ATTENTION.values()):
        out["flash_attention_fwd"].append(
            _flash_fwd_case(B, S, S, H, KV, D, True, 0, 0, 86 + seed, kernel_iters=20))
    for seed, (B, _, H, KV, D, W) in enumerate(SERVE_DECODE_ATTENTION.values()):
        out["decode_attention"].append(_decode_case(B, H, KV, D, W, "shared", 91 + seed))
    serve = _rwkv6_case(*SERVE_RWKV6_SHAPE, 57, kernel_iters=20)
    out["rwkv6_fwd"].append(serve["fwd"])
    out["rwkv6_bwd"].append(serve["bwd"])
    learners = ((DEEPSEEK_GMM_UP, PRETRAIN["batch"]), (JAMBA_GMM_UP, PRETRAIN_BATCH["pretrain_jamba"]))
    for seed, ((T, D, F, E), batch) in enumerate(learners):
        for d, f in ((D, F), (F, D)):
            out["moe_gmm"].append(_gmm_case([T // E] * E, d, f, 100 + seed, kernel_iters=10))
            bwd = _gmm_bwd_case([T // E] * E, d, f, 110 + seed, kernel_iters=10, batch=batch)
            out["moe_gmm_dx"].append(bwd["dx"])
            out["moe_gmm_dw"].append(bwd["dw"])
    for seed, ups in enumerate(SERVE_GMM_UP.values()):
        T, D, F, E = ups[0]
        for d, f in ((D, F), (F, D)):
            out["moe_gmm"].append(_gmm_case([T // E] * E, d, f, 120 + 2 * seed, kernel_iters=10))
    out["moe_gmm_small"] = _gmm_small_cases()
    print(f"  the model zoo's kernel cases: {time.perf_counter() - t0:.1f} s")


def _gmm_bwd_einsums_case(up: tuple, batch: int, seed: int) -> dict:
    """The bf16 grouped products' backward on the card: the reference's two
    einsums (``models/moe.py``'s ``gmm_bwd_einsums``, no kernel) at a
    pretraining path's up and down products, [B, E, C, K] x [E, K, N],
    each against the float32-summed product rounded once (max abs error and
    ``_row_ratio`` at ``BF16_TOL``), with cuBLAS's bf16 reduced-precision
    reductions off (the port's setting, ``make_pretrain``) and on
    (PyTorch's default), timed each way by the profiler; the bound one bf16
    tensor-core pass of 2 T D F flops or the bytes at 2 an element."""
    import torch

    from repro_torch.models.moe import gmm_bwd_einsums

    T, D, F, E = up
    C = T // (E * batch)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    out = []
    try:
        for i, (k, n) in enumerate(((D, F), (F, D))):
            g = torch.Generator(device="cuda").manual_seed(seed + i)
            xe = _randn(g, batch, E, C, k).bfloat16()
            w = (_randn(g, E, k, n) / math.sqrt(k)).bfloat16()
            dy = _randn(g, batch, E, C, n).bfloat16()
            want_dx = torch.einsum("becn,ekn->beck", dy.float(), w.float()).bfloat16()
            want_dw = torch.einsum("beck,becn->ekn", xe.float(), dy.float()).bfloat16()
            flops, nbytes = _formula("moe_gmm_dx", {"t": T, "d": k, "f": n, "e": E, "es": 2})
            case = {"shape": [T, k, n, E], "batch": batch, **_bf16_bounds(nbytes, flops)}
            for reduced in (False, True):
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
                dx, dw = gmm_bwd_einsums(xe, w, dy)
                torch.cuda.synchronize()
                tag = "reduced" if reduced else "fp32_sums"
                case[tag] = {
                    "dx_err": _max_err(dx.float(), want_dx.float()),
                    "dw_err": _max_err(dw.float(), want_dw.float()),
                    "dx_err_over_ulp": _row_ratio(dx, want_dx, BF16_TOL),
                    "dw_err_over_ulp": _row_ratio(dw, want_dw, BF16_TOL),
                    "dx_ms": _library(lambda: torch.einsum("becn,ekn->beck", dy, w), iters=5),
                    "dw_ms": _library(lambda: torch.einsum("beck,becn->ekn", xe, dy), iters=5),
                }
                del dx, dw
            out.append(case)
            print(f"  gmm backward einsums bf16 {case['shape']} (batch {batch}): bound "
                  f"{case['bound_ms']:.5f} ms; fp32 sums dX {case['fp32_sums']['dx_ms']['library_ms']:.5f}"
                  f" / dW {case['fp32_sums']['dw_ms']['library_ms']:.5f} ms, err {case['fp32_sums']['dx_err']:.3e}"
                  f" / {case['fp32_sums']['dw_err']:.3e}; reduced-precision reductions dX "
                  f"{case['reduced']['dx_ms']['library_ms']:.5f} / dW {case['reduced']['dw_ms']['library_ms']:.5f}"
                  f" ms, err {case['reduced']['dx_err']:.3e} / {case['reduced']['dw_err']:.3e}")
            del xe, w, dy, want_dx, want_dw
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    return out


def _bf16_decode_threads(rounds: int = 200) -> dict:
    """The bf16 decode wrapper called from two threads at once, ``rounds``
    calls each, at two shapes whose blocks ask for different shared memory
    (Nemotron-4's serve step and LLaVA's step at W 3,408): no call raises,
    and every output is bitwise the same shape's output from one thread.
    The kernel's shared-memory limit is an attribute that every thread
    shares, so a limit set for one shape must not refuse the other's."""
    import torch

    from repro_torch.kernels.decode_attention import bf16_decode_plan, decode_attention_cuda

    shapes = ((2, 48, 8, 128, 528), (2, 56, 8, 128, 3408))
    g = torch.Generator(device="cuda").manual_seed(240)
    inputs = [(torch.randn((B, 1, H, D), generator=g, device="cuda").bfloat16(),
               torch.randn((B, W, KV, D), generator=g, device="cuda").bfloat16(),
               torch.randn((B, W, KV, D), generator=g, device="cuda").bfloat16(),
               torch.ones(W, dtype=torch.bool, device="cuda")) for B, H, KV, D, W in shapes]
    smem = [bf16_decode_plan(B, KV, H // KV, D, W).smem for B, H, KV, D, W in shapes]
    _require(smem[0] != smem[1], f"decode threads: both shapes ask for {smem[0]} bytes")
    want = [decode_attention_cuda(*x) for x in inputs]
    torch.cuda.synchronize()
    errors, unequal = [], [0, 0]

    def calls(i: int) -> None:
        try:
            for _ in range(rounds):
                if not torch.equal(decode_attention_cuda(*inputs[i]), want[i]):
                    unequal[i] += 1
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{shapes[i]}: {exc!r}")

    threads = [threading.Thread(target=calls, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    _require(not errors, f"decode threads: {errors}")
    _require(unequal == [0, 0], f"decode threads: outputs not bitwise one thread's: {unequal}")
    print(f"  bf16 decode from two threads: {rounds} calls each at {list(shapes)} "
          f"({smem} bytes of shared memory a block), every output bitwise one thread's")
    return {"shapes": [list(x) for x in shapes], "smem": smem, "rounds": rounds}


def _mixed_dtypes_refused() -> None:
    """Every bf16-taking wrapper raises on a CUDA call whose operands mix
    bfloat16 and float32 or are float16, and the bf16 decode wrapper on a
    head dim its kernel does not take (32), and launches nothing."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_bwd_cuda, flash_fwd_cuda
    from repro_torch.kernels.moe_gmm import moe_gmm_cuda, moe_gmm_small_cuda
    from repro_torch.kernels.rwkv6 import rwkv6_cuda

    g = torch.Generator(device="cuda").manual_seed(260)
    q, kv = _randn(g, 1, 64, 2, 64), _randn(g, 1, 64, 2, 64)
    x, w = _randn(g, 8, 64), _randn(g, 2, 64, 64)
    gs = torch.tensor([4, 4], dtype=torch.int32, device="cuda")
    valid = torch.ones(64, dtype=torch.bool, device="cuda")
    calls = {}
    for label, (q_, k_, x_, w_) in (("bf16 with float32", (q.bfloat16(), kv, x.bfloat16(), w)),
                                    ("float16", (q.half(), kv.half(), x.half(), w.half()))):
        calls.update({
            f"flash_fwd_cuda {label}": functools.partial(flash_fwd_cuda, q_, k_, k_, True, 0, 0),
            f"decode_attention_cuda {label}": functools.partial(
                decode_attention_cuda, q_[:, :1].contiguous(), k_, k_, valid),
            f"moe_gmm_cuda {label}": functools.partial(moe_gmm_cuda, x_, w_, gs),
            f"moe_gmm_small_cuda {label}": functools.partial(moe_gmm_small_cuda, x_, w_, gs, 4),
            f"flash_bwd_cuda {label}": functools.partial(
                flash_bwd_cuda, q_, k_, k_, q_, torch.zeros(1, 2, 64, device="cuda"), q_, True, 0, 0),
        })
    r = _randn(g, 1, 64, 2, 16)
    u = _randn(g, 2, 16)
    calls.update({
        "rwkv6_cuda bf16 r with float32 k, v, w": functools.partial(
            rwkv6_cuda, r.bfloat16(), r, r, r, u),
        "rwkv6_cuda bf16 u": functools.partial(rwkv6_cuda, *(r.bfloat16(),) * 4, u.bfloat16()),
        "rwkv6_cuda float16": functools.partial(rwkv6_cuda, *(r.half(),) * 4, u),
        "decode_attention_cuda bf16 at D = 32": functools.partial(
            decode_attention_cuda, r[:, :1].bfloat16().contiguous(), r.bfloat16(), r.bfloat16(),
            valid),
        "flash_bwd_cuda bf16 with a float32 o": functools.partial(
            flash_bwd_cuda, q.bfloat16(), q.bfloat16(), q.bfloat16(), q, torch.zeros(1, 2, 64, device="cuda"),
            q.bfloat16(), True, 0, 0),
    })
    counters = _all_counters()
    before = {c.name: c.value for c in counters}
    for label, call in calls.items():
        try:
            call()
        except ValueError:
            continue
        raise PhaseError(f"{label}: no error")
    _require({c.name: c.value for c in counters} == before, "a refused call launched a kernel")
    print(f"  mixed and unsupported dtypes refused: {len(calls)} CUDA calls raised, none launched")


def _bf16_kernel_cases(out: dict) -> None:
    """The four bf16 kernels, each at its serve paths' shapes first
    (``PATH_SHAPES``) and then at the shapes of this phase's float32 cases
    of the same kernel, so the two precisions sit side by side: the flash
    forward at the serve prefills, the PPO-LM learner's, GQA 40/8 with a
    window, with a q_offset and at a ragged S, Phi's and Qwen3-14B's, and at
    D = 64 and 32; decode attention at the serve steps' heads and window, at
    phase 3's masks and at ``BF16_DECODE_NEXT``'s shapes; the tile kernel at
    DeepSeek's and Jamba's prefill products, Phi's, the ragged groups and
    D = 1,000, F = 1,416 (TMA's edges); the small-group kernel at
    ``_gmm_small_cases``.  Then ``_mixed_dtypes_refused``."""
    t0 = time.perf_counter()
    flash = functools.partial(_flash_fwd_case, bf16=True)
    d = RLHF_ENV["ctx"]
    B, S, H, KV, D = PHI_ATTENTION
    out["flash_attention_fwd_bf16"] = [
        *(flash(b, s, s, h, kv, dd, True, 0, 0, 200 + i, kernel_iters=20)
          for i, (b, s, h, kv, dd) in enumerate(SERVE_BF16_PREFILL_ATTENTION.values())),
        flash(128, d, d, 20, 20, 128, True, 0, 0, 210),
        flash(2, 2048, 2048, 40, 8, 128, True, 512, 0, 211),
        flash(2, 1024, 2048, 40, 8, 128, True, 0, 1024, 212),
        flash(2, 1000, 1000, 40, 8, 128, True, 0, 0, 213),
        flash(B, S, S, H, KV, D, True, 0, 0, 214, kernel_iters=20),
        *_narrow_heads(flash, 215),
        flash(QWEN3_ATTENTION[0], QWEN3_ATTENTION[1], *QWEN3_ATTENTION[1:], True, 0, 0, 219,
              kernel_iters=20),
    ]
    decode = functools.partial(_decode_case, bf16=True)
    out["decode_attention_bf16"] = [
        *(decode(b, h, kv, dd, w, "shared", 220 + i)
          for i, (b, _, h, kv, dd, w) in enumerate(SERVE_BF16_DECODE_ATTENTION.values())),
        decode(8, 20, 20, 128, d, "ragged", 230),
        decode(8, 40, 8, 128, 4096, "ragged", 231),
        decode(4, 20, 20, 128, d, "empty_row", 232),
        decode(8, 40, 8, 128, 1000, "shared", 233),
        decode(8, 20, 20, 128, d, "ring", 234),
        *(decode(b, h, kv, dd, w, "shared", 235 + i)
          for i, (b, _, h, kv, dd, w) in enumerate(BF16_DECODE_NEXT.values())),
    ]
    gmm = functools.partial(_gmm_case, bf16=True)
    cases = []
    for seed, ups in enumerate(SERVE_GMM_UP.values()):
        T, D, F, E = ups[0]
        for dd, f in ((D, F), (F, D)):
            cases.append(gmm([T // E] * E, dd, f, 240 + 2 * seed, kernel_iters=10))
    T, D, F, E = MOE_GMM_UP
    ragged = [300, 0, 1000, 77, 129, 640, 1, 511]
    out["moe_gmm_bf16"] = cases + [
        gmm([T // E] * E, D, F, 250, 10), gmm([T // E] * E, F, D, 251, 10),
        gmm(ragged, 1024, 1536, 252, 20, 600, 0), gmm(ragged, 1024, 1536, 253, 20, 0, 250),
        gmm([1280, 1000, 1280, 1280], D, F, 254, 20),
        gmm(ragged, 1000, 1416, 257, 20, 600, 5),
    ]
    out["moe_gmm_small_bf16"] = _gmm_small_cases(bf16=True)
    # The bf16 pretraining paths' shapes: the flash backward at Qwen3-14B's,
    # Phi's, LLaVA's, MusicGen's (D = 64) and Jamba's learners, a window and
    # a q_offset; RWKV-6 at the learner's and the serve prefill's, and with
    # half the decays at the clip (the largest rounds to exactly 1.0 in
    # bf16); the tile kernel at DeepSeek's learner products.  The plain
    # versions are called once a timing.
    back = functools.partial(_flash_bwd_case, bf16=True, kernel_iters=10)
    out["flash_attention_bwd_bf16"] = [
        back(b, s, s, h, kv, dd, True, 0, 0, 270 + i) for i, (b, s, h, kv, dd) in enumerate(
            (QWEN3_ATTENTION, PHI_ATTENTION, LLAVA_ATTENTION, MUSICGEN_ATTENTION, JAMBA_ATTENTION))
    ] + [back(2, 2048, 2048, 40, 8, 128, True, 512, 0, 275),
         back(2, 1024, 2048, 40, 8, 128, True, 0, 1024, 276)]
    rw = functools.partial(_rwkv6_case, bf16=True, kernel_iters=20)
    rwkv = [rw(*RWKV6_PATH_SHAPE, 280), rw(*SERVE_RWKV6_SHAPE, 281),
            rw(2, 1024, 8, 64, 282, clip_share=0.5)]
    out["rwkv6_fwd_bf16"] = [c["fwd"] for c in rwkv]
    out["rwkv6_bwd_bf16"] = [c["bwd"] for c in rwkv]
    T, D, F, E = DEEPSEEK_GMM_UP
    out["moe_gmm_bf16"] += [gmm([T // E] * E, D, F, 255, 10), gmm([T // E] * E, F, D, 256, 10)]
    _bf16_decode_threads()
    _mixed_dtypes_refused()
    print(f"  the bf16 kernel cases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    einsums = {path: _gmm_bwd_einsums_case(up, batch, 290 + 2 * i) for i, (path, up, batch) in enumerate(
        (("pretrain_phi_bf16", MOE_GMM_UP, 2), ("pretrain_deepseek_bf16", DEEPSEEK_GMM_UP, 2),
         ("jamba", JAMBA_GMM_UP, PRETRAIN_BATCH["pretrain_jamba"])))}
    print(f"  the bf16 backward einsums: {time.perf_counter() - t0:.1f} s")
    return einsums


def _launch_floor() -> dict:
    """Device and event time of the library's empty kernel: the floor under
    the latency-bound kernels (GAE, V-trace, the surrogate at RL widths)."""
    import torch

    from repro_torch.kernels.build import check, load_library

    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        check(lib, lib.empty_launch(stream), "empty_launch")

    device_ms, lost = _device_ms(launch, iters=50)
    out = {"device_ms": device_ms, "records_lost": lost, "call_ms": _time_ms(launch)}
    print(f"launch floor (empty kernel): device_ms={device_ms} call_ms={out['call_ms']:.5f} "
          f"records_lost={lost}")
    return out


def phase_kernels() -> dict:
    """Every kernel at its main paths' shapes and at large ones; the first
    case of each kernel is its path's shape (the RLHF path's, and the IMPALA
    learner's for V-trace)."""
    print("  gae scan order: a warp per column (csrc/reverse_scan.cuh), the one gae.cu builds")
    # [16, 2]: MAML's rollouts; [16, 4]: the multi-agent rollouts; [8, 128]:
    # MBPO's synthetic rollouts ([32, 4], its real ones, is APPO's).
    gae_cases = [_gae_case(32, 8, 5), _gae_case(64, 8, 0), _gae_case(32, 4, 7),
                 _gae_case(128, 4096, 1), _gae_case(33, 1001, 2), _gae_case(1, 8, 3),
                 _gae_case(1000, 4, 9, plain_iters=3), _gae_case(16, 2, 15), _gae_case(16, 4, 16),
                 _gae_case(8, 128, 17)]
    print("  vtrace scan order: a warp per column (csrc/reverse_scan.cuh), the one vtrace.cu "
          "builds")
    # [129, 8]: a tile boundary (row 127's v_{t+1} and vs_{t+1} from the later tile);
    # c_clip 1.5: decays above 1 in the warp's composed maps.
    vtrace_cases = [_vtrace_case((32, 16), 40), _vtrace_case((32, 512), 41),
                    _vtrace_case((128, 4096), 42), _vtrace_case((33, 1001), 43),
                    _vtrace_case((16, 8, 2), 44), _vtrace_case((1, 64), 45),
                    _vtrace_case((32, 512), 46, rho_clip=2.0, c_clip=0.5),
                    _vtrace_case((129, 8), 47), _vtrace_case((1000, 4), 48, plain_iters=3),
                    _vtrace_case((1000, 4), 49, c_clip=1.5, plain_iters=3)]
    # [16, 151937]: rows not 16-byte aligned (scalar loads); [8, 1024]: one
    # chunk a row; [3, 4097]: a one-column last chunk; [128, 2]: the
    # multi-agent PPO branch.
    sur_cases = [_surrogate_case(128, 151936, 6, plain_iters=3), _surrogate_case(256, 2, 3),
                 _surrogate_case(512, 2, 8), _surrogate_case(65536, 18, 4),
                 _surrogate_case(16, 151937, 12, plain_iters=3), _surrogate_case(8, 1024, 13),
                 _surrogate_case(3, 4097, 14), _surrogate_case(128, 2, 18)]
    d = RLHF_ENV["ctx"]
    B, S, H, KV, D = PHI_ATTENTION
    _phi = (B, S, S, H, KV, D)
    out = {
        "gae": gae_cases,
        "vtrace": vtrace_cases,
        "ppo_surrogate_fwd": [c["fwd"] for c in sur_cases],
        "ppo_surrogate_bwd": [c["bwd"] for c in sur_cases],
        "decode_attention": [
            _decode_case(8, 20, 20, 128, d, "ragged", 10),
            _decode_case(8, 40, 8, 128, 4096, "ragged", 11),
            _decode_case(4, 20, 20, 128, d, "empty_row", 12),
            _decode_case(8, 40, 8, 128, 1000, "shared", 13),
            _decode_case(8, 20, 20, 128, d, "ring", 14),
        ],
        "flash_attention_fwd": [
            _flash_fwd_case(128, d, d, 20, 20, 128, True, 0, 0, 20),   # learner
            _flash_fwd_case(256, d, d, 20, 20, 128, True, 0, 0, 21),   # GAE bootstrap
            _flash_fwd_case(8, d, d, 20, 20, 128, True, d, 0, 22),     # prefill (window = ctx)
            _flash_fwd_case(2, 2048, 2048, 40, 8, 128, True, 512, 0, 23),
            _flash_fwd_case(2, 1024, 2048, 40, 8, 128, True, 0, 1024, 24),
            _flash_fwd_case(2, 1000, 1000, 40, 8, 128, True, 0, 0, 25),
        ],
        "flash_attention_bwd": [
            _flash_bwd_case(128, d, d, 20, 20, 128, True, 0, 0, 30),  # learner
            _flash_bwd_case(4, 512, 512, 20, 20, 128, True, 0, 0, 31),
            _flash_bwd_case(2, 1024, 1024, 40, 8, 128, True, 0, 0, 32),
            _flash_bwd_case(*_phi, True, 0, 0, 33, kernel_iters=10, clocks=True),  # Phi's learner
            _flash_bwd_case(2, 2048, 2048, 40, 8, 128, True, 512, 0, 34),  # sliding window
            _flash_bwd_case(2, 1024, 2048, 40, 8, 128, True, 0, 1024, 35),  # q_offset
            *_narrow_heads(_flash_bwd_case, 36),
        ],
    }
    _qwen3 = (QWEN3_ATTENTION[0], QWEN3_ATTENTION[1], *QWEN3_ATTENTION[1:])
    out["flash_attention_fwd"] += [
        _flash_fwd_case(*_phi, True, 0, 0, 26, kernel_iters=20),
        *_narrow_heads(_flash_fwd_case, 27),
        _flash_fwd_case(*_qwen3, True, 0, 0, 70, kernel_iters=20),  # Qwen3-14B's learner
    ]
    out["flash_attention_bwd"].append(
        _flash_bwd_case(*_qwen3, True, 0, 0, 71, kernel_iters=10))
    # TransformerPolicy's trunk on the server-inference PPO path.
    S, H, D = TF_ATTENTION
    out["flash_attention_fwd"] += [_flash_fwd_case(b, S, S, H, H, D, True, 0, 0, 60 + i)
                                   for i, b in enumerate(TF_FLASH_FWD_B)]
    out["flash_attention_bwd"].append(
        _flash_bwd_case(TF_FLASH_BWD_B, S, S, H, H, D, True, 0, 0, 64))
    rwkv6_cases = [
        _rwkv6_case(*RWKV6_PATH_SHAPE, 50, kernel_iters=20, check_profiler=True,
                    clocks=True),  # path shape
        _rwkv6_case(2, 1000, 64, 64, 51),  # ragged T
        _rwkv6_case(2, 300, 8, 64, 52, state=True),  # a start state
        _rwkv6_case(4, 256, 8, 32, 53, chunk=16),  # narrow heads
        _rwkv6_case(2, 1024, 64, 64, 54, state=True, kernel_iters=20),  # the path's heads, a start state
        _rwkv6_case(2, 512, 4, 16, 55),  # N = 16
        _rwkv6_case(2, 1024, 8, 64, 56, clip_share=0.5),  # decays at the clip's extremes
    ]
    out["rwkv6_fwd"] = [c["fwd"] for c in rwkv6_cases]
    out["rwkv6_bwd"] = [c["bwd"] for c in rwkv6_cases]
    out.update(_gmm_cases())
    _zoo_kernel_cases(out)
    einsums = _bf16_kernel_cases(out)
    for name, cases in out.items():
        tol = GRAD_TOL if name in ("flash_attention_bwd", "rwkv6_bwd") else TOL
        tol = GMM_TOL if name.startswith("moe_gmm") else tol
        tol = BF16_TOL if name.endswith("_bf16") else tol
        tol = ("2^-7 x (min(row max, 1) + |x|)"
               if name in ("flash_attention_fwd_bf16", "decode_attention_bf16", "rwkv6_fwd_bf16")
               else tol)
        tol = ("2^-7 x (row max (at least 2^-8 x the tensor's) + |x|), dq + _dq_allowance"
               if name in ("flash_attention_bwd_bf16", "rwkv6_bwd_bf16") else tol)
        for c in cases:
            lib = c.get("library_ms")
            lib_txt = f" library_ms={lib} ({c.get('library_backend')})" if lib is not None else ""
            fp32 = c.get("bound_fp32_ms")
            fp32_txt = f" bound_fp32_ms={fp32:.6f}" if fp32 is not None else ""
            print(
                f"kernel {name} {c['shape']}: max_abs_err={c['max_abs_err']:.3e} (tol {tol}"
                + (f", {c['err_over_limit']:.3f} x the limit" if "err_over_limit" in c else "") + ") "
                f"device_ms={c['device_ms']} call_ms={c['call_ms']:.5f} "
                f"call_ms_after={c['call_ms_after']:.5f} "
                f"plain_device_ms={c['plain_device_ms']} plain_call_ms={c['plain_call_ms']:.5f} "
                f"bound_ms={c['bound_ms']:.6f} ({c['bound_by']}){fp32_txt} "
                f"records_lost={c['records_lost']}{lib_txt}"
                + (f" profile_retries={c['profile_retries']}/{c['plain_profile_retries']}"
                   if c['profile_retries'] or c['plain_profile_retries'] else "")
                + (f" ms_from={c['ms_from']}" if c['ms_from'] != "profiler" else "")
            )
            if c.get("clocks"):
                print(f"  SM clock / power / temperature around its readings: "
                      f"{[tuple(x.values()) for x in c['clocks']]}")
            if "tile_ms" in c:
                print(f"  block_m {c['block_m']}: {c['rows_a_chunk']} rows a chunk, "
                      f"{c['chunks']} chunks of D, {c['blocks']} blocks; the 128-row-tile "
                      f"kernel on the same inputs "
                      f"{c['tile_ms']} ms ({c['tile_ms_from']})")
    out["gmm_bwd_einsums_bf16"] = einsums  # no kernel: the reference's einsums at bf16
    spent = sorted(TIMING_SECONDS.items(), key=lambda kv: -(kv[1][0] + kv[1][1]))
    print("  seconds timing kernels / their plain versions, by case function: " + ", ".join(
        f"{fn} {k:.1f} / {p:.1f} ({n} cases)" for fn, (k, p, n) in spent))
    return out


# ----------------------------------------------------------------- phase 4
def _make_worker(index: int, device: str):
    from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker

    return RolloutWorker(
        CartPole(),
        ActorCriticPolicy(4, 2, hidden=(64, 64), loss_kind="ppo", ent_coef=0.0),
        algo="ppo", num_envs=PPO_CONFIG["num_envs"], rollout_len=PPO_CONFIG["rollout_len"],
        seed=0, worker_index=index, device=device,
    )


def phase_learner_parity() -> dict:
    import numpy as np

    from repro_torch.core.operators import StandardizeFields
    from repro_torch.interop import params_to_numpy
    from repro_torch.rl import SampleBatch
    from repro_torch.tree import tree_leaves

    gpu, cpu = _make_worker(0, "cuda"), _make_worker(0, "cpu")
    cpu.set_weights(params_to_numpy(gpu.get_weights()))
    batch = SampleBatch.concat_samples([gpu.sample(), gpu.sample()])
    batch = StandardizeFields(["advantages"])(batch)
    rng = np.random.default_rng(0)
    mbs = list(batch.minibatches(PPO_CONFIG["sgd_minibatch_size"], rng))
    for mb in mbs:
        info_g, info_c = gpu.learn_on_batch(mb), cpu.learn_on_batch(mb)
    w_g = tree_leaves(params_to_numpy(gpu.get_weights()))
    w_c = tree_leaves(params_to_numpy(cpu.get_weights()))
    err = max(float(np.abs(a - b).max()) for a, b in zip(w_g, w_c))
    _require(err <= LEARNER_TOL, f"learner parity: card vs CPU weights differ by {err:.3e}")
    loss_err = max(abs(info_g[k] - info_c[k]) for k in info_g)
    _require(loss_err <= LEARNER_TOL, f"learner parity: stats differ by {loss_err:.3e}")
    print(f"learner parity: {len(mbs)} SGD steps on {batch.count} rows, card vs CPU "
          f"max weight err {err:.3e}, max stat err {loss_err:.3e} (tol {LEARNER_TOL})")
    return {"weight_err": err, "stat_err": loss_err}


# ----------------------------------------------------------------- phase 5
RESULT_KEYS = {"counters", "episodes", "gauges", "info", "latencies", "time_total_s", "timers"}
INFO_KEYS = {"loss", "pg_loss", "vf_loss", "entropy", "kl"}


def phase_main_path(counters: list) -> dict:
    import torch

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm

    cfg, iters = PPO_CONFIG, ITERS
    workers = WorkerSet.create(lambda i: _make_worker(i, "cuda"), cfg["num_workers"])
    rows = []
    with Algorithm.from_plan(
        "ppo", workers, train_batch_size=cfg["train_batch_size"],
        num_sgd_iter=cfg["num_sgd_iter"], sgd_minibatch_size=cfg["sgd_minibatch_size"],
    ) as algo:
        for c in counters:
            c.reset()
        t_all = time.perf_counter()
        for i in range(iters):
            prof = None
            if i == iters - 1:  # the last iteration runs under the profiler
                prof = _DeviceProfile()
                prof.start()
            t0 = time.perf_counter()
            result = algo.train()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if prof is not None:
                busy = prof.stop()
            info, ctr = result["info"], result["counters"]
            reward = result["episodes"]["episode_reward_mean"]
            rows.append({"iter": i, "seconds": dt, "reward": reward, "loss": info["loss"]})
            print(
                f"train {i}: steps_sampled={ctr['num_steps_sampled']} "
                f"steps_trained={ctr['num_steps_trained']} reward_mean={reward:.2f} "
                f"loss={info['loss']:.4f} kl={info['kl']:.5f} {dt:.3f} s "
                + " ".join(f"{c.name}={c.value}" for c in counters)
            )
            _require(set(result) == RESULT_KEYS, f"result keys {sorted(result)}")
            _require(set(info) == INFO_KEYS, f"info keys {sorted(info)}")
            _require(all(math.isfinite(info[k]) for k in INFO_KEYS), f"non-finite stats {info}")
        total = time.perf_counter() - t_all
        launches = {c.name: c.value for c in counters}
    busy_ms = sum(busy.values()) / 1e3
    ours = {k: v / 1e3 for k, v in busy.items() if "gae_kernel" in k or "surrogate_" in k}
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:5]
    # The profiled iteration runs slower than the others (tracing cost), so
    # the idle share is given against both its own wall time and the mean
    # of the unprofiled iterations after the first (warm-up) one.
    warm_ms = 1e3 * sum(r["seconds"] for r in rows[1:-1]) / max(len(rows) - 2, 1)
    profiled = {
        "wall_ms": dt * 1e3, "unprofiled_mean_ms": warm_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (dt * 1e3),
        "idle_share_vs_unprofiled": 1.0 - busy_ms / warm_ms,
        "port_kernels_ms": ours,
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
    }
    print(
        f"profile train {iters - 1}: wall {dt * 1e3:.1f} ms (unprofiled mean {warm_ms:.1f} ms), "
        f"device busy {busy_ms:.2f} ms, idle share {profiled['idle_share']:.4f} "
        f"({profiled['idle_share_vs_unprofiled']:.4f} vs unprofiled), port kernels {ours}"
    )
    steps = iters * cfg["train_batch_size"]
    _require(ctr["num_steps_sampled"] == steps and ctr["num_steps_trained"] == steps,
             f"counters {ctr} after {iters} iterations")
    samples_per_iter = cfg["train_batch_size"] // (cfg["num_envs"] * cfg["rollout_len"])
    sgd_steps = cfg["num_sgd_iter"] * (cfg["train_batch_size"] // cfg["sgd_minibatch_size"])
    # The non-vectorized worker hashes 4 times a rollout (its chain's split,
    # the split into step keys, their acting/env split, the env keys) and
    # twice a step (the categorical, CartPole's reset draw); each SGD step
    # once (the learner key the chain splits off).
    expect = {
        "gae": iters * samples_per_iter,
        "ppo_surrogate_fwd": iters * sgd_steps,
        "ppo_surrogate_bwd": iters * sgd_steps,
        "threefry": iters * (samples_per_iter * (4 + 2 * cfg["rollout_len"]) + sgd_steps),
    }
    _require(launches == expect, f"launches {launches}, expected {expect}")
    print(f"main path: {iters} train() iterations in {total:.3f} s, launches {launches}")
    return {"iterations": rows, "seconds": total, "launches": launches, "profile": profiled}


# ----------------------------------------------------------------- phase 6
def _lm_parity_worker(device: str):
    """The parity phase's worker.  It learns with SGD at lr 1, so the weight
    difference after one step is the gradient difference.  Adam's first
    step is lr * sign(g) wherever |g| >> eps, so any of the ~1M gradients
    whose true value lies within rounding of zero moves by 2 * lr apart on
    the two devices whatever the kernels do."""
    from repro_torch.optim import sgd
    from repro_torch.rl import LMTokenPolicy, TokenEnv, VectorizedRolloutWorker

    c = LM_PARITY
    env = TokenEnv(vocab_size=c["vocab_size"], ctx=c["ctx"], min_prompt=8, max_prompt=32, horizon=32)
    policy = LMTokenPolicy(ctx=c["ctx"], vocab_size=c["vocab_size"], d_model=c["d_model"],
                           n_layers=c["n_layers"], num_heads=c["num_heads"],
                           num_kv_heads=c["num_kv_heads"])
    return VectorizedRolloutWorker(env, policy, algo="ppo", num_envs=8, rollout_len=32,
                                   decode="cache", seed=0, optimizer=sgd(1.0), device=device)


def phase_lm_learner_parity() -> dict:
    import numpy as np

    from repro_torch.core.operators import StandardizeFields
    from repro_torch.interop import params_to_numpy
    from repro_torch.tree import tree_leaves

    gpu, cpu = _lm_parity_worker("cuda"), _lm_parity_worker("cpu")
    cpu.set_weights(params_to_numpy(gpu.get_weights()))
    batch = StandardizeFields(["advantages"])(gpu.sample())
    info_g, info_c = gpu.learn_on_batch(batch), cpu.learn_on_batch(batch)
    w_g = tree_leaves(params_to_numpy(gpu.get_weights()))
    w_c = tree_leaves(params_to_numpy(cpu.get_weights()))
    err = max(float(np.abs(a - b).max()) for a, b in zip(w_g, w_c))
    stat_err = max(abs(info_g[k] - info_c[k]) for k in info_g)
    _require(err <= LEARNER_TOL, f"LM learner parity: card vs CPU weights differ by {err:.3e}")
    _require(stat_err <= LEARNER_TOL, f"LM learner parity: stats differ by {stat_err:.3e}")
    print(f"LM learner parity: one learn_on_batch on {batch.count} rows at {LM_PARITY}, card vs "
          f"CPU max weight err {err:.3e}, max stat err {stat_err:.3e} (tol {LEARNER_TOL})")
    return {"weight_err": err, "stat_err": stat_err, "config": dict(LM_PARITY)}


# ----------------------------------------------------------------- phase 7
def _rlhf_worker(index: int, optimizer=None):
    from repro_torch.configs.qwen15_4b import CONFIG as QWEN
    from repro_torch.rl import LMTokenPolicy, TokenEnv, VectorizedRolloutWorker

    env = TokenEnv(vocab_size=QWEN.vocab_size, **RLHF_ENV)
    policy = LMTokenPolicy(
        ctx=RLHF_ENV["ctx"], vocab_size=QWEN.vocab_size, d_model=QWEN.d_model,
        n_layers=RLHF_LAYERS, num_heads=QWEN.num_heads, num_kv_heads=QWEN.num_kv_heads,
    )
    return VectorizedRolloutWorker(
        env, policy, algo="ppo", num_envs=RLHF_CONFIG["num_envs"],
        rollout_len=RLHF_CONFIG["rollout_len"], decode="cache", seed=0, worker_index=index,
        device="cuda", **({"optimizer": optimizer} if optimizer is not None else {}),
    )


def _rlhf_expected_launches() -> dict:
    """Launches per train() iteration implied by the RLHF configuration: with
    the sync TokenEnv every lane resets together, so a rollout prefills once
    per episode and decodes every other step; the GAE bootstrap runs one
    forward per sample and the learner one forward and one backward per SGD
    minibatch, each through every layer."""
    c, L = RLHF_CONFIG, RLHF_LAYERS
    _require(c["rollout_len"] % RLHF_ENV["horizon"] == 0, "rollout_len must be a multiple of horizon")
    samples = c["train_batch_size"] // (c["num_envs"] * c["rollout_len"])
    prefills = c["rollout_len"] // RLHF_ENV["horizon"]
    decodes = c["rollout_len"] - prefills
    sgd_steps = c["num_sgd_iter"] * (c["train_batch_size"] // c["sgd_minibatch_size"])
    # Threefry: nine hashes a vectorized step (the lane split, the
    # categorical, the env's two splits, TokenEnv's reset draw: a split and
    # two randints of two each) and one a SGD step (the learner key).
    return {
        "gae": samples,
        "ppo_surrogate_fwd": sgd_steps,
        "ppo_surrogate_bwd": sgd_steps,
        "threefry": samples * c["rollout_len"] * 9 + sgd_steps,
        "decode_attention": samples * decodes * L,
        "flash_attention_fwd": samples * (prefills + 1) * L + sgd_steps * L,
        "flash_attention_bwd": sgd_steps * L,
    }


def _split_times(worker) -> dict:
    """Seconds of one rollout (decode loop), its GAE bootstrap forward and
    one learner SGD step on ``worker``, each ended by a synchronize."""
    import torch

    from repro_torch.core.operators import StandardizeFields
    from repro_torch.rl.rollout_worker import assemble_fragments

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cols, t_roll = timed(worker._vrollout)
    cols, t_boot = timed(lambda: worker._postprocess_cols(worker.params, cols))
    cols.pop("completed")
    batch = StandardizeFields(["advantages"])(assemble_fragments(cols, worker._lane_base))
    mb = batch.slice(0, RLHF_CONFIG["sgd_minibatch_size"])
    _, t_learn = timed(lambda: worker.learn_on_batch(mb))
    return {"rollout_s": t_roll, "bootstrap_s": t_boot, "sgd_step_s": t_learn}


def _cache_update_profile(worker) -> dict:
    """Device ms per decode step of the KV-cache rewrite, beside the decode
    attention kernel's, from a profile of one rollout with shapes recorded.
    Each decode step writes the new row into every layer's K and V cache by
    a ``torch.where`` over the whole [B, W, KV, D] cache
    (``models/layers.py``, ``decode_attention_step``), as the functional
    reference does: the ``aten::where`` ops on a tensor of that shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    W = RLHF_ENV["ctx"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        torch.cuda._sleep(1000)  # the primer of _DeviceProfile
        worker._vrollout()
        torch.cuda.synchronize()
    where_us, wheres = 0.0, 0
    for e in prof.events():
        if e.name == "aten::where" and any(len(x) == 4 and x[1] == W for x in e.input_shapes):
            where_us += e.device_time_total
            wheres += 1
    attn_us, attn_records = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and (
                "decode_attention_kernel" in e.key or "decode_combine_kernel" in e.key):
            attn_us += e.self_device_time_total
            attn_records += e.count
    steps = wheres // (2 * RLHF_LAYERS)  # a K and a V update per layer and step
    _require(steps > 0 and wheres == 2 * RLHF_LAYERS * steps,
             f"cache update: {wheres} torch.where calls on the cache in one rollout")
    return {"decode_steps": steps, "where_calls": wheres,
            "cache_update_ms_per_step": where_us / 1e3 / steps,
            "decode_attention_ms_per_step": attn_us / 1e3 / steps,
            "decode_attention_records": attn_records}


def phase_rlhf(counters: list) -> dict:
    import torch

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm
    from repro_torch.launch.rlhf import parity_gap

    cfg, iters = RLHF_CONFIG, RLHF_ITERS
    per_iter = _rlhf_expected_launches()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    workers = WorkerSet.create(_rlhf_worker, cfg["num_workers"])
    init_s = time.perf_counter() - t_init
    rows = []
    try:
        with Algorithm.from_plan(
            "ppo_lm", workers, train_batch_size=cfg["train_batch_size"],
            num_sgd_iter=cfg["num_sgd_iter"], sgd_minibatch_size=cfg["sgd_minibatch_size"],
        ) as algo:
            for c in counters:
                c.reset()
            t_all = time.perf_counter()
            for i in range(iters):
                prof = None
                if i == iters - 1:  # the last iteration runs under the profiler
                    prof = _DeviceProfile()
                    prof.start()
                before = {c.name: c.value for c in counters}
                t0 = time.perf_counter()
                result = algo.train()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                if prof is not None:
                    busy = prof.stop()
                launched = {c.name: c.value - before[c.name] for c in counters}
                info, ctr = result["info"], result["counters"]
                rows.append({"iter": i, "seconds": dt, "loss": info["loss"], "launches": launched,
                             "reward": result["episodes"]["episode_reward_mean"]})
                print(
                    f"rlhf train {i}: steps_sampled={ctr['num_steps_sampled']} "
                    f"steps_trained={ctr['num_steps_trained']} loss={info['loss']:.4f} "
                    f"kl={info['kl']:.5f} entropy={info['entropy']:.4f} "
                    f"reward_mean={result['episodes']['episode_reward_mean']:.4f} {dt:.3f} s "
                    + " ".join(f"{k}={v}" for k, v in launched.items())
                )
                _require(set(result) == RESULT_KEYS, f"result keys {sorted(result)}")
                _require(set(info) == INFO_KEYS, f"info keys {sorted(info)}")
                _require(all(math.isfinite(info[k]) for k in INFO_KEYS), f"non-finite stats {info}")
                steps = (i + 1) * cfg["train_batch_size"]
                _require(ctr["num_steps_sampled"] == steps and ctr["num_steps_trained"] == steps,
                         f"counters {ctr} after {i + 1} iterations")
                _require(launched == per_iter,
                         f"iteration {i} launched {launched}, expected {per_iter}")
            total = time.perf_counter() - t_all
            launches = {c.name: c.value for c in counters}
            peak = torch.cuda.max_memory_allocated()
            lw = workers.local_worker()
            gap = parity_gap(lw)
            with torch.no_grad():
                logits, _ = lw.policy.logits_value(lw.params, lw.vstate.obs)
            scale = float(logits.abs().max())
            print(f"rlhf parity: decode-vs-forward max |logits gap| {gap:.3e}, max |forward "
                  f"logits| {scale:.3e}, limit {1e-4 * scale:.3e}")
            _require(gap <= 1e-4 * scale, f"decode-vs-forward gap {gap:.3e} > 1e-4 * {scale:.3e}")
            split = _split_times(lw)
            cache = _cache_update_profile(lw)
    finally:
        workers.stop()
    busy_ms = sum(busy.values()) / 1e3
    names = ("decode_attention", "flash_fwd", "flash_bwd", "surrogate_", "gae_kernel")
    ours = {k[:60]: v / 1e3 for k, v in busy.items() if any(n in k for n in names)}
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    warm_ms = 1e3 * sum(r["seconds"] for r in rows[1:-1]) / max(len(rows) - 2, 1)
    profiled = {
        "wall_ms": dt * 1e3, "unprofiled_mean_ms": warm_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (dt * 1e3),
        "idle_share_vs_unprofiled": 1.0 - busy_ms / warm_ms,
        "port_kernels_ms": ours,
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
    }
    print(
        f"rlhf profile train {iters - 1}: wall {dt * 1e3:.1f} ms (unprofiled {warm_ms:.1f} ms), "
        f"device busy {busy_ms:.2f} ms, idle share {profiled['idle_share']:.4f} "
        f"({profiled['idle_share_vs_unprofiled']:.4f} vs unprofiled); peak memory "
        f"{peak / 2**30:.2f} GiB; worker init {init_s:.2f} s; split {split}"
    )
    print(f"rlhf top device kernels (ms): {profiled['top_kernels_ms']}")
    print(f"rlhf decode step (profile of one rollout, {cache['decode_steps']} steps): KV-cache "
          f"update {cache['cache_update_ms_per_step']:.4f} ms per step "
          f"({cache['where_calls']} torch.where calls), decode attention "
          f"{cache['decode_attention_ms_per_step']:.4f} ms per step")
    print(f"rlhf main path: {iters} train() iterations in {total:.3f} s, launches {launches}; "
          f"seconds per iteration with per-lane keyed token sampling "
          f"{[round(r['seconds'], 3) for r in rows]} (PR 22, one generator a worker: 5.43-5.65 s)")
    return {"iterations": rows, "seconds": total, "launches": launches, "profile": profiled,
            "expected_per_iter": per_iter, "peak_memory_bytes": peak, "init_s": init_s,
            "parity_gap": gap, "max_abs_logit": scale, "split": split, "cache_update": cache}


# ----------------------------------------------------------------- phase 8
def _async_worker(index: int, device: str, cfg: dict, optimizer=None):
    """A CartPole worker of an async path: the example's 64x64 actor-critic
    with the V-trace loss (IMPALA) or the PPO loss (APPO)."""
    from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker, VectorizedRolloutWorker

    loss_kind = "vtrace" if cfg["algo"] == "vtrace" else "ppo"
    policy = ActorCriticPolicy(4, 2, hidden=(64, 64), loss_kind=loss_kind, ent_coef=0.01,
                               rollout_len=cfg["rollout_len"])
    cls = VectorizedRolloutWorker if cfg["vector"] else RolloutWorker
    kw = {"optimizer": optimizer} if optimizer is not None else {}
    return cls(CartPole(), policy, algo=cfg["algo"], num_envs=cfg["num_envs"],
               rollout_len=cfg["rollout_len"], seed=0, worker_index=index, device=device, **kw)


def phase_vtrace_learner_parity() -> dict:
    """One IMPALA learner step on the card (V-trace kernel) and on the CPU
    (plain loop) from the same weights, with SGD at lr 1 so the weight
    difference is the gradient difference (see phase 6)."""
    import numpy as np

    from repro_torch.interop import params_to_numpy
    from repro_torch.optim import sgd
    from repro_torch.rl import SampleBatch
    from repro_torch.tree import tree_leaves

    cfg = ASYNC_PATHS["impala"]
    gpu = _async_worker(0, "cuda", cfg, optimizer=sgd(1.0))
    cpu = _async_worker(0, "cpu", cfg, optimizer=sgd(1.0))
    cpu.set_weights(params_to_numpy(gpu.get_weights()))
    batch = SampleBatch.concat_samples([gpu.sample() for _ in range(4)])
    _require(batch.count == cfg["train_batch_size"], f"parity batch has {batch.count} rows")
    info_g, info_c = gpu.learn_on_batch(batch), cpu.learn_on_batch(batch)
    w_g = tree_leaves(params_to_numpy(gpu.get_weights()))
    w_c = tree_leaves(params_to_numpy(cpu.get_weights()))
    err = max(float(np.abs(a - b).max()) for a, b in zip(w_g, w_c))
    stat_err = max(abs(info_g[k] - info_c[k]) for k in info_g)
    _require(err <= LEARNER_TOL, f"V-trace learner parity: card vs CPU weights differ by {err:.3e}")
    _require(stat_err <= LEARNER_TOL, f"V-trace learner parity: stats differ by {stat_err:.3e}")
    print(f"V-trace learner parity: one learn_on_batch (SGD, lr 1) on {batch.count} rows, card "
          f"vs CPU max weight err {err:.3e}, max stat err {stat_err:.3e} (tol {LEARNER_TOL})")
    return {"weight_err": err, "stat_err": stat_err, "rows": batch.count}


# ------------------------------------------------------------ phases 9-11
class _Rollouts:
    """Count and host seconds of the rollouts (``sample()`` calls) the
    workers of one path ran, across their actor threads."""

    def __init__(self):
        self.count = 0
        self.seconds = 0.0
        self._lock = threading.Lock()

    def wrap(self, worker):
        sample = worker.sample

        def counted():
            t0 = time.perf_counter()
            out = sample()  # ends in a device-to-host copy
            with self._lock:
                self.count += 1
                self.seconds += time.perf_counter() - t0
            return out

        worker.sample = counted
        return worker


@contextlib.contextmanager
def _deadline(seconds: int, what: str):
    """Raise PhaseError in the main thread when ``seconds`` pass."""

    def expired(signum, frame):
        raise PhaseError(f"{what}: not done within its {seconds} s deadline")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


def phase_async(name: str, counters: list) -> dict:
    """One asynchronous main path: ``train()`` until the learner thread has
    taken ``min_steps`` steps, then a profiled window, then ``stop()``.
    Launches are read after ``stop()`` has joined every thread of the flow
    and checked against the learner's and the workers' own counts."""
    import torch

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm

    cfg = ASYNC_PATHS[name]
    rollouts = _Rollouts()
    thread_errors: dict = {}
    hook = threading.excepthook

    def record(args):
        thread_errors[args.thread.name] = repr(args.exc_value)
        hook(args)

    threads_before = set(threading.enumerate())
    threading.excepthook = record
    t_init = time.perf_counter()
    workers = WorkerSet.create(lambda i: rollouts.wrap(_async_worker(i, "cuda", cfg)),
                               cfg["num_workers"])
    plan_kw = dict(train_batch_size=cfg["train_batch_size"], num_async=cfg["num_async"])
    if cfg["vector"]:
        plan_kw["vector"] = cfg["vector"]
    algo = Algorithm.from_plan(cfg["plan"], workers, **plan_kw)
    init_s = time.perf_counter() - t_init
    learner = algo.resources["learner"]
    info_keys = INFO_KEYS if cfg["algo"] == "ppo" else INFO_KEYS - {"kl"}
    rows = []

    def train_once(i: int) -> dict:
        t0 = time.perf_counter()
        result = algo.train()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _require(learner.is_alive(), f"{name}: the learner thread died after iteration {i}: "
                                     f"{thread_errors.get(learner.name, 'no exception recorded')}")
        _require(set(result) == RESULT_KEYS, f"{name}: result keys {sorted(result)}")
        info, ctr = result["info"], result["counters"]
        if info:  # empty until the first learner result reaches the driver
            _require(set(info) == info_keys, f"{name}: info keys {sorted(info)}")
            _require(all(math.isfinite(info[k]) for k in info), f"{name}: non-finite stats {info}")
        reward = result["episodes"]["episode_reward_mean"]
        rows.append({"iter": i, "seconds": dt, "reward": reward, "loss": info.get("loss"),
                     "steps_sampled": ctr.get("num_steps_sampled", 0),
                     "steps_trained": ctr.get("num_steps_trained", 0),
                     "learner_steps": learner.num_steps})
        print(f"{name} train {i}: steps_sampled={rows[-1]['steps_sampled']} "
              f"steps_trained={rows[-1]['steps_trained']} learner_steps={learner.num_steps} "
              f"reward_mean={reward:.2f} loss={info.get('loss')} {dt:.3f} s "
              + " ".join(f"{c.name}={c.value}" for c in counters))
        return result

    def snapshot() -> dict:
        return {"t": time.perf_counter(), "learn_s": learner.learn_timer.total,
                "learn_n": learner.learn_timer.count, "roll_s": rollouts.seconds,
                "roll_n": rollouts.count, "trained": rows[-1]["steps_trained"] if rows else 0}

    try:
        with _deadline(ASYNC_DEADLINE_S, name):
            for c in counters:
                c.reset()
            t_all = time.perf_counter()
            result = train_once(0)
            warm = snapshot()  # the first iteration starts every thread: warm-up
            while learner.num_steps < cfg["min_steps"] or len(rows) < 3:
                result = train_once(len(rows))
            steady = snapshot()
            total = steady["t"] - t_all
            # The profiled window: whole train() calls lasting at least
            # ASYNC_PROFILE_S, so the learner and rollout threads' kernels
            # launched meanwhile are in it.
            steps0, trained0 = learner.num_steps, rows[-1]["steps_trained"]
            prof = _DeviceProfile()
            prof.start()
            t_prof = time.perf_counter()
            while time.perf_counter() - t_prof < ASYNC_PROFILE_S:
                result = train_once(len(rows))
            window = time.perf_counter() - t_prof
            window_steps = learner.num_steps - steps0
            window_trained = rows[-1]["steps_trained"] - trained0
            busy = prof.stop()
            _require(rows[-1]["steps_trained"] > 0, f"{name}: nothing trained")
    finally:
        algo.stop()
        threading.excepthook = hook
    _require(not learner.is_alive(), f"{name}: the learner thread is alive after stop()")
    # Dummy threads are the Python faces of native threads (the autograd
    # engine's device threads run the surrogate backward): not the flow's.
    left = [t.name for t in threading.enumerate() if t not in threads_before and t.is_alive()
            and not isinstance(t, threading._DummyThread)]
    _require(not left, f"{name}: threads of the flow alive after stop(): {left}")

    launches = {c.name: c.value for c in counters}
    steps = learner.num_steps
    received = rows[-1]["steps_sampled"] // (cfg["num_envs"] * cfg["rollout_len"])
    if cfg["algo"] == "vtrace":
        expect = {"gae": 0, "vtrace": steps, "ppo_surrogate_fwd": 0, "ppo_surrogate_bwd": 0}
    else:
        expect = {"gae": rollouts.count, "vtrace": 0,
                  "ppo_surrogate_fwd": steps, "ppo_surrogate_bwd": steps}
    _keyed_launches(name, launches, expect)
    _require(launches == expect, f"{name}: launches {launches}, expected {expect} "
                                 f"(learner steps {steps}, rollouts run {rollouts.count})")
    _require(rollouts.count >= received, f"{name}: {received} rollouts received but "
                                         f"{rollouts.count} run")
    busy_ms = sum(busy.values()) / 1e3
    ours = {k[:60]: v / 1e3 for k, v in busy.items()
            if any(n in k for n in ("vtrace_kernel", "gae_kernel", "surrogate_"))}
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    # The device's copies (V-trace's loss makes five [T, N] time-major
    # copies and one [N] bootstrap copy a learner step around its kernel):
    # ms and records by name, to set beside the port's kernels.
    copies = {k[:100]: {"ms": v / 1e3, "records": prof.records[k]} for k, v in busy.items()
              if "copy" in k.lower()}
    iters = [r["seconds"] for r in rows]
    profiled = {
        "window_s": window, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (window * 1e3),
        "learner_steps": window_steps, "steps_trained": window_trained,
        "port_kernels_ms": ours, "copy_kernels": copies,
        "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
    }
    # Where the time goes, over the unprofiled iterations after the first:
    # the learner thread's learn_on_batch time and the rollout threads'
    # sample time, each against the wall time of that stretch.
    d = {k: steady[k] - warm[k] for k in warm}
    split = {
        "wall_s": d["t"], "steps_trained_per_s": d["trained"] / d["t"],
        # The learner's own rate: the driver drains results behind it.
        "learner_rows_per_s": d["learn_n"] * cfg["train_batch_size"] / d["t"],
        "learner_steps": d["learn_n"], "learner_s": d["learn_s"],
        "learn_step_mean_s": d["learn_s"] / max(d["learn_n"], 1),
        "learner_busy_share": d["learn_s"] / d["t"], "rollouts": d["roll_n"],
        "rollout_s": d["roll_s"], "rollout_mean_s": d["roll_s"] / max(d["roll_n"], 1),
        "rollout_busy_share_per_worker": d["roll_s"] / cfg["num_workers"] / d["t"],
        "latencies": result["latencies"],
    }
    print(f"{name} profile: window {window:.3f} s, device busy {busy_ms:.2f} ms, idle share "
          f"{profiled['idle_share']:.4f}, {window_steps} learner steps, {window_trained} steps "
          f"trained; port kernels {ours}")
    print(f"{name} profile copies: {copies}")
    print(f"{name} top device kernels (ms): {profiled['top_kernels_ms']}")
    print(f"{name} split: {json.dumps(split)}")
    print(f"{name} main path: {len(rows)} train() iterations in {total:.3f} s (mean "
          f"{sum(iters) / len(iters):.4f} s, init {init_s:.2f} s), learner steps {steps}, "
          f"rollouts run {rollouts.count} (received {received}), "
          f"after the first iteration {split['learner_rows_per_s']:.1f} rows learned/s "
          f"(learner) and {split['steps_trained_per_s']:.1f} steps trained/s (driver), "
          f"launches {launches}; no flow thread alive after stop()")
    return {"config": dict(cfg), "iterations": rows, "seconds": total, "init_s": init_s,
            "launches": launches, "learner_steps": steps, "rollouts_run": rollouts.count,
            "rollouts_received": received, "profile": profiled, "split": split}


# ------------------------------------------------------------ phases 12-13
def _pg_worker(index: int, device: str):
    """A worker of the gradient paths: ``examples/quickstart.py``'s CartPole
    actor-critic with the 'pg' loss."""
    from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker

    cfg = GRADIENT_CONFIG
    return RolloutWorker(CartPole(), ActorCriticPolicy(4, 2), algo="pg", num_envs=cfg["num_envs"],
                         rollout_len=cfg["rollout_len"], seed=0, worker_index=index, device=device)


def _profiled_train(algo, check, min_s: float = 0.0) -> tuple:
    """Whole ``train()`` calls under the profiler, one or as many as last
    ``min_s``: (last result, wall s, device busy ms, port kernels' ms by
    name)."""
    import torch

    prof = _DeviceProfile()
    prof.start()
    t0 = time.perf_counter()
    while True:
        result = algo.train()
        check(result)
        if time.perf_counter() - t0 >= min_s:
            break
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    busy = prof.stop()
    ours = {k[:60]: v / 1e3 for k, v in busy.items()
            if any(n in k for n in ("vtrace_kernel", "gae_kernel", "surrogate_", "flash_"))}
    return result, dt, sum(busy.values()) / 1e3, ours


def _check_averaged_gradients(workers) -> None:
    """``AverageGradients`` over two CUDA gradient trees from the thread
    backend's actors: CUDA tensors out, equal to the mean taken here."""
    import torch

    from repro_torch.core.operators import AverageGradients
    from repro_torch.tree import tree_leaves

    actors = list(workers.remote_workers())
    items = [a.sync("compute_gradients", a.sync("sample")) for a in actors]
    avg, info = AverageGradients()(items)
    leaves = tree_leaves(avg)
    _require(all(g.is_cuda for g in leaves), "averaged gradients left the card")
    want = [sum(gs) / len(gs) for gs in zip(*(tree_leaves(g) for g, _ in items))]
    err = max(float((a - b).abs().max()) for a, b in zip(leaves, want))
    _require(err == 0.0, f"averaged gradients differ from their mean by {err:.3e}")
    _require(info["batch_count"] == sum(i["batch_count"] for _, i in items),
             f"averaged info {info}")


def phase_gradient_plan(name: str, counters: list) -> dict:
    """A2C (synchronous: gather, average, apply, broadcast) or A3C (each
    worker's gradients applied as they come) through
    ``Algorithm.from_plan``; the 'pg' workers end every rollout in GAE."""
    import torch

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm
    from repro_torch.interop import params_to_numpy
    from repro_torch.tree import tree_leaves

    cfg, iters = GRADIENT_CONFIG, GRADIENT_CONFIG["iters"]
    rows_per_grad = cfg["num_envs"] * cfg["rollout_len"]
    workers = WorkerSet.create(lambda i: _pg_worker(i, "cuda"), cfg["num_workers"])
    if name == "a2c":
        _check_averaged_gradients(workers)
    rows = []

    def check(result):
        _require(set(result) == RESULT_KEYS, f"{name}: result keys {sorted(result)}")
        _require(set(result["info"]) == GRADIENT_INFO_KEYS, f"{name}: info {result['info']}")
        _require(set(result["counters"]) == GRADIENT_COUNTERS,
                 f"{name}: counters {sorted(result['counters'])}")
        _require(math.isfinite(result["info"]["loss"]), f"{name}: loss {result['info']}")

    algo = Algorithm.from_plan(name, workers)
    try:
        with _deadline(GRADIENT_DEADLINE_S, name):
            for c in counters:
                c.reset()
            t_all = time.perf_counter()
            for i in range(iters - 1):
                t0 = time.perf_counter()
                result = algo.train()
                torch.cuda.synchronize()
                rows.append({"iter": i, "seconds": time.perf_counter() - t0,
                             "loss": result["info"]["loss"]})
                check(result)
            result, dt, busy_ms, ours = _profiled_train(algo, check)
            rows.append({"iter": iters - 1, "seconds": dt, "loss": result["info"]["loss"]})
            total = time.perf_counter() - t_all
            if name == "a2c":  # the broadcast leaves every worker on the learner's weights
                local = tree_leaves(params_to_numpy(workers.local_worker().get_weights()))
                for actor in workers.remote_workers():
                    remote = tree_leaves(params_to_numpy(actor.sync("get_weights")))
                    _require(all((a == b).all() for a, b in zip(local, remote)),
                             "a2c: a worker's weights differ from the learner's")
    finally:
        algo.stop()
    launches = {c.name: c.value for c in counters}
    ctr = result["counters"]
    applied = ctr["num_steps_trained"] // rows_per_grad
    _require(ctr["num_steps_sampled"] == ctr["num_steps_trained"], f"{name}: counters {ctr}")
    others = {k: v for k, v in launches.items() if k not in ("gae", "threefry")}
    _require(not any(others.values()), f"{name}: launches {launches}")
    _keyed_launches(name, launches, {})
    if name == "a2c":
        expect = iters * cfg["num_workers"]
        _require(applied == expect and launches["gae"] == expect,
                 f"a2c: launches {launches}, {applied} gradients applied, expected {expect}")
    else:
        _require(applied >= iters and applied <= launches["gae"] <= applied + cfg["num_workers"],
                 f"a3c: launches {launches} for {applied} gradients applied")
    warm = [r["seconds"] for r in rows[1:-1]]
    profile = {"wall_ms": dt * 1e3, "device_busy_ms": busy_ms,
               "idle_share": 1.0 - busy_ms / (dt * 1e3), "port_kernels_ms": ours}
    print(f"{name} main path: {iters} train() iterations in {total:.3f} s (unprofiled mean "
          f"{sum(warm) / len(warm):.4f} s), {applied} gradients applied, launches {launches}; "
          f"profiled iteration {dt * 1e3:.1f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{profile['idle_share']:.4f}, port kernels {ours}"
          + ("; AverageGradients over CUDA trees exact" if name == "a2c" else ""))
    return {"iterations": rows, "seconds": total, "unprofiled_mean_s": sum(warm) / len(warm),
            "launches": launches, "gradients_applied": applied, "profile": profile}


# ----------------------------------------------------------------- phase 14
def _dqn_worker(index: int, device: str, optimizer=None, epsilon: float = 0.2):
    """``benchmarks/common.py``'s DQN worker on CartPole."""
    from repro_torch.rl import CartPole, DQNPolicy, RolloutWorker

    cfg = REPLAY_PATHS["dqn"]
    kw = {"optimizer": optimizer} if optimizer is not None else {}
    return RolloutWorker(CartPole(), DQNPolicy(4, 2), algo="dqn", num_envs=cfg["num_envs"],
                         rollout_len=cfg["rollout_len"], seed=13, worker_index=index,
                         epsilon=epsilon, device=device, **kw)


def _sac_worker(index: int, device: str, optimizer=None):
    """``tests/test_plans.py``'s SAC worker on Pendulum."""
    from repro_torch.rl import Pendulum, RolloutWorker, SACPolicy

    cfg = REPLAY_PATHS["sac"]
    kw = {"optimizer": optimizer} if optimizer is not None else {}
    return RolloutWorker(Pendulum(), SACPolicy(3, 1), algo="sac", num_envs=cfg["num_envs"],
                         rollout_len=cfg["rollout_len"], seed=5, worker_index=index,
                         target_polyak=0.01, device=device, **kw)


def _stat_err(info_g: dict, info_c: dict, scale: dict = None) -> tuple:
    """The largest difference between two learners' stats (scalars or
    per-row arrays), relative to ``scale[k]`` (per row) where it is given and
    to the CPU's value otherwise, where that scale is above 1 in magnitude,
    and absolute below; and the largest absolute difference."""
    import numpy as np

    scale = scale or {}
    scaled = absolute = 0.0
    for k in info_g:
        diff = np.abs(np.asarray(info_g[k]) - info_c[k])
        absolute = max(absolute, float(diff.max()))
        ref = scale[k] if k in scale else np.abs(info_c[k])
        scaled = max(scaled, float((diff / np.maximum(1.0, ref)).max()))
    return scaled, absolute


def _acted_q(worker, algo: str, batch) -> "np.ndarray":
    """Each row's acted Q value under ``worker``'s online weights, as its
    loss computes it before the step (DQN's ``q_sa``, SAC's ``q1``): the
    operand of ``td_error`` beside its target."""
    import torch

    with torch.no_grad():
        obs = torch.as_tensor(batch["obs"], device=worker.device)
        actions = torch.as_tensor(batch["actions"], device=worker.device)
        if algo == "dqn":
            q = worker.policy.q_values(worker.params, obs)
            return q.gather(-1, actions.long()[:, None])[:, 0].cpu().numpy()
        if actions.dim() == 1:
            actions = actions[:, None]
        return worker.policy._q(worker.params["q1"], obs, actions).cpu().numpy()


def _tree_err(a, b) -> float:
    """The largest absolute difference between two weight trees."""
    import numpy as np

    from repro_torch.interop import params_to_numpy
    from repro_torch.tree import tree_leaves

    return max(float(np.abs(x - y).max())
               for x, y in zip(tree_leaves(params_to_numpy(a)), tree_leaves(params_to_numpy(b))))


def phase_offpolicy_learner_parity() -> dict:
    """DQN and SAC learners on the card and on the CPU from the same online
    and target weights, fed the same replayed batch (and, for SAC, the same
    two noises a step, injected) for ``OFFPOLICY_PARITY_STEPS`` steps of SGD.
    Gated within ``LEARNER_TOL``: the weights after the steps, and each
    step's stats against a CPU twin given the card's weights before that
    step (absolute below 1 and relative above: SAC's critic loss is of order
    1e2, where float32 carries about 1e-5 absolute).  Printed and recorded
    beside them, not gated: each step's stats against the CPU learner's own
    run, a ``td_error`` row relative to ``|q| + |target|``.  That reading
    follows the trajectory, not a step: SGD at lr 0.01 on SAC's losses of
    1e2-1e3 amplifies float32 rounding, so on an H100 the two runs' weights
    end 3.3e-05 apart and a row's q, both near 0.74, 2.6e-04 apart while a
    step's stats from the same weights agree to 2.5e-06; the weights gate
    holds that drift."""
    import numpy as np
    import torch

    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.optim import sgd
    from repro_torch.rl import ReplayBuffer

    out = {}
    def sync(dst, src):
        dst.set_weights(params_to_numpy(src.get_weights()))
        dst.target_params = params_from_numpy(params_to_numpy(src.target_params))

    for algo, make in (("dqn", _dqn_worker), ("sac", _sac_worker)):
        gpu, cpu, twin = (make(0, dev, optimizer=sgd(OFFPOLICY_PARITY_LR))
                          for dev in ("cuda", "cpu", "cpu"))
        sync(cpu, gpu)
        rb = ReplayBuffer(capacity=4096, sample_batch_size=64, learning_starts=64, seed=0)
        for _ in range(2):
            rb.add_batch(gpu.sample())
        batch = rb.replay()
        if algo == "sac":  # the same noises on every learner, two a step
            rng = np.random.default_rng(0)
            noises = [rng.standard_normal((batch.count, 1)).astype(np.float32)
                      for _ in range(2 * OFFPOLICY_PARITY_STEPS)]
            for w in (gpu, cpu, twin):
                it = iter(noises)
                w.policy.noise = lambda obs, gen, it=it: torch.from_numpy(next(it)).to(obs.device)
        run_err = run_abs = step_err = step_abs = 0.0
        for _ in range(OFFPOLICY_PARITY_STEPS):
            sync(twin, gpu)
            q_c = _acted_q(cpu, algo, batch)
            info_g, info_t = gpu.learn_on_batch(batch), twin.learn_on_batch(batch)
            info_c = cpu.learn_on_batch(batch)
            _require(isinstance(info_g["td_error"], np.ndarray),
                     f"{algo}: td_error is {type(info_g['td_error'])}, not host numpy")
            operands = {"td_error": np.abs(q_c) + np.abs(q_c - info_c["td_error"])}
            scaled, absolute = _stat_err(info_g, info_c, operands)
            run_err, run_abs = max(run_err, scaled), max(run_abs, absolute)
            scaled, absolute = _stat_err(info_g, info_t)
            step_err, step_abs = max(step_err, scaled), max(step_abs, absolute)
        err = _tree_err(gpu.params, cpu.params)
        target_err = _tree_err(gpu.target_params, cpu.target_params)
        _require(max(err, target_err) <= LEARNER_TOL,
                 f"{algo} learner parity: card vs CPU weights differ by {err:.3e} "
                 f"(target {target_err:.3e})")
        _require(step_err <= LEARNER_TOL,
                 f"{algo} learner parity: a step's stats from the same weights differ by "
                 f"{step_err:.3e}")
        print(f"{algo} learner parity: {OFFPOLICY_PARITY_STEPS} learn_on_batch steps (SGD, lr "
              f"{OFFPOLICY_PARITY_LR}) on one replayed batch of {batch.count} rows, card vs CPU "
              f"max weight err {err:.3e}, target err {target_err:.3e}; each step's stats from the "
              f"same weights: max err {step_err:.3e} (absolute {step_abs:.3e}); tol {LEARNER_TOL}; "
              f"not gated, stats along the two runs: max err {run_err:.3e} (td_error relative to "
              f"|q| + |target|, other stats relative above 1; absolute {run_abs:.3e}); td_error "
              "as host numpy")
        out[algo] = {"weight_err": err, "target_err": target_err, "stat_err": run_err,
                     "stat_abs_err": run_abs, "step_stat_err": step_err,
                     "step_stat_abs_err": step_abs, "rows": batch.count}
    return out


# ------------------------------------------------------------ phases 15-17
def _apex_worker(index: int, device: str):
    """``examples/apex_dqn.py``'s worker: its epsilon ladder over the
    workers."""
    from repro_torch.rl import CartPole, DQNPolicy, RolloutWorker

    cfg = REPLAY_PATHS["apex"]
    return RolloutWorker(CartPole(), DQNPolicy(4, 2), algo="dqn", num_envs=cfg["num_envs"],
                         rollout_len=cfg["rollout_len"], seed=0, worker_index=index,
                         epsilon=0.4 ** (1 + index), device=device)


def phase_replay_plan(name: str, counters: list) -> dict:
    """DQN, Ape-X or SAC through ``Algorithm.from_plan`` with replay actors,
    ``train()`` under a deadline until the path has trained (Ape-X: until
    its learner thread has taken ``min_steps`` steps), then ``stop()`` and
    no thread of the flow left alive.  None of these paths launches a kernel
    of the port: their losses are small MLP products and elementwise work."""
    import numpy as np
    import torch

    from repro_torch.core.actor import create_colocated
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm
    from repro_torch.rl import ReplayBuffer

    cfg = REPLAY_PATHS[name]
    make = {"dqn": _dqn_worker, "apex": _apex_worker, "sac": _sac_worker}[name]
    threads_before = set(threading.enumerate())
    t_init = time.perf_counter()
    workers = WorkerSet.create(lambda i: make(i, "cuda"), cfg["num_workers"])
    replay = create_colocated(lambda: ReplayBuffer(**cfg["replay"]), cfg["replay_actors"])
    algo = Algorithm.from_plan(name, workers, replay, **cfg["plan"])
    init_s = time.perf_counter() - t_init
    learner = algo.resources.get("learner")
    info_keys = SAC_INFO_KEYS if name == "sac" else DQN_INFO_KEYS
    rows = []

    def check(result):
        _require(set(result) == RESULT_KEYS, f"{name}: result keys {sorted(result)}")
        info = result["info"]
        if info:  # Ape-X's is empty until the learner's first result is drained
            _require(set(info) == info_keys, f"{name}: info keys {sorted(info)}")
            _require(isinstance(info["td_error"], np.ndarray), f"{name}: td_error not numpy")
            _require(all(math.isfinite(v) for k, v in info.items() if k != "td_error")
                     and np.isfinite(info["td_error"]).all(), f"{name}: non-finite stats")
        if learner is not None:
            _require(learner.is_alive(), f"{name}: the learner thread died")

    def done(result) -> bool:
        ctr = result["counters"]
        if learner is not None:
            return learner.num_steps >= cfg["min_steps"]
        return ctr.get("num_target_updates", 0) >= cfg["min_target_updates"]

    try:
        with _deadline(REPLAY_DEADLINE_S, name):
            for c in counters:
                c.reset()
            t_all = time.perf_counter()
            result = {"counters": {}}
            while not done(result):
                t0 = time.perf_counter()
                result = algo.train()
                torch.cuda.synchronize()
                rows.append({"iter": len(rows), "seconds": time.perf_counter() - t0,
                             "steps_trained": result["counters"].get("num_steps_trained", 0)})
                check(result)
            total = time.perf_counter() - t_all
            # Ape-X's train() returns as each learner result is drained:
            # its window spans ASYNC_PROFILE_S, as on the other async paths.
            result, dt, busy_ms, ours = _profiled_train(
                algo, check, ASYNC_PROFILE_S if learner is not None else 0.0)
            stats = [a.sync("stats") for a in replay]
            prios = [a.sync("get_state")["priorities"] for a in replay]
    finally:
        algo.stop()
    left = [t.name for t in threading.enumerate() if t not in threads_before and t.is_alive()
            and not isinstance(t, threading._DummyThread)]
    _require(not left, f"{name}: threads of the flow alive after stop(): {left}")
    if learner is not None:
        _require(not learner.is_alive(), f"{name}: the learner thread is alive after stop()")
    ctr = result["counters"]
    launches = {c.name: c.value for c in counters}
    _keyed_launches(name, launches, {})
    _require(not any(v for k, v in launches.items() if k != "threefry"),
             f"{name}: launches {launches}, expected no kernel but threefry")
    _require(ctr["num_steps_trained"] > 0, f"{name}: nothing trained: {ctr}")
    names = {k for k in ctr if not k.startswith("bytes_moved/")} - TIMING_COUNTERS
    _require(names <= REPLAY_COUNTERS, f"{name}: counters {sorted(ctr)}")
    sampled = sum(s["sampled"] for s in stats)
    _require(sampled > 0, f"{name}: the replay buffers sampled nothing: {stats}")
    # UpdateReplayPriorities moved priorities off the buffer's max-priority
    # default (1.0 at insertion) for the rows it trained on.
    updated = sum(int((p[:s["size"]] != p[:s["size"]].max()).sum()) for p, s in zip(prios, stats))
    _require(updated > 0, f"{name}: no replay priority was updated")
    if name != "apex":
        _require(ctr.get("num_target_updates", 0) >= cfg["min_target_updates"],
                 f"{name}: target updates {ctr}")
    profile = {"window_ms": dt * 1e3, "device_busy_ms": busy_ms,
               "idle_share": 1.0 - busy_ms / (dt * 1e3), "port_kernels_ms": ours}
    mean = sum(r["seconds"] for r in rows[1:]) / max(len(rows) - 1, 1)
    print(f"{name} main path: {len(rows)} train() iterations in {total:.3f} s (mean after the "
          f"first {mean:.4f} s, init {init_s:.2f} s), steps trained {ctr['num_steps_trained']}, "
          f"target updates {ctr.get('num_target_updates', 0)}"
          + (f", learner steps {learner.num_steps}" if learner is not None else "")
          + f"; replay {stats}, {updated} priorities updated; launches {launches}; profiled "
          f"window {dt * 1e3:.1f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{profile['idle_share']:.4f}; no flow thread alive after stop()")
    return {"iterations": rows, "seconds": total, "init_s": init_s, "mean_s": mean,
            "launches": launches, "counters": ctr, "replay": stats,
            "priorities_updated": updated, "profile": profile,
            "learner_steps": learner.num_steps if learner is not None else None}


# ----------------------------------------------------------------- phase 18
def phase_flowcheck() -> dict:
    """The flowcheck audit of the port's plans on CUDA workers: no error,
    and the three pinned warns of the reference."""
    from repro_torch.flow import PLAN_BUILDERS
    from repro_torch.flow.analysis import audit_plans

    t0 = time.perf_counter()
    results = audit_plans(device="cuda")
    _require(set(results) == set(PLAN_BUILDERS) and len(results) == 12,
             f"flowcheck: audited {sorted(results)}")
    errors = {n: [d.format() for d in ds if d.is_error] for n, ds in results.items()
              if any(d.is_error for d in ds)}
    _require(not errors, f"flowcheck: errors {errors}")
    for plan in ("apex", "appo", "impala"):
        _require([d.rule for d in results[plan]] == ["unbounded-queue"],
                 f"flowcheck: {plan} gives {[d.rule for d in results[plan]]}")
    warns = {n: [d.rule for d in ds] for n, ds in results.items() if ds}
    print(f"flowcheck: {len(results)} plans on CUDA workers, 0 errors, diagnostics {warns} "
          f"({time.perf_counter() - t0:.2f} s)")
    return {"plans": sorted(results), "diagnostics": warns}


# ------------------------------------------------------------ phase 19
def _pretrain_parity(arch: str, bf16: bool = False) -> dict:
    """One ``learn_on_batch`` (SGD at lr 1, so the weight difference is the
    gradient difference; see phase 6) of the pretraining learner on the card
    and on the CPU from the same weights, at ``arch``'s reduced
    configuration in float32 (within ``LEARNER_TOL``).  For an MoE one the
    experts every token routes to must first be the same on both devices:
    one flipped choice would make the weight comparison meaningless.  With
    ``bf16``, at the configuration's own dtype: the weights cross through
    ``params_to_numpy`` (which widens them) and the learner's leaves must
    stay bf16; both runs take the card's expert choices (``_Routing``), the
    CPU's own choices held to them but at near ties; each weight within 2 x
    ``PARITY_BF16_GAP`` x its leaf's largest update + 2^-7 x its |value|,
    each statistic within 2 x ``PARITY_BF16_LOSS_GAP``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import InputShape
    from repro_torch.core.spmd import SPMDLearnerWorker, SPMDTrainContext
    from repro_torch.data import make_batch
    from repro_torch.interop import params_to_numpy
    from repro_torch.launch.train import train_config
    from repro_torch.optim import sgd
    from repro_torch.tree import tree_leaves

    cfg = train_config(arch, smoke=True)
    if not bf16:
        cfg = dataclasses.replace(cfg, dtype="float32")
    gpu = SPMDLearnerWorker(SPMDTrainContext(cfg, sgd(1.0), device="cuda"))
    cpu = SPMDLearnerWorker(SPMDTrainContext(cfg, sgd(1.0), device="cpu"))
    cpu.set_weights(params_to_numpy(gpu.get_weights()))
    dtypes = sorted({str(p.dtype) for p in tree_leaves(cpu.params)})
    _require(dtypes == [f"torch.{cfg.dtype}"], f"pretrain parity ({arch}): the CPU learner's "
                                               f"leaves are {dtypes} after the weight sync")
    before = tree_leaves(params_to_numpy(cpu.get_weights()))
    batch = make_batch(cfg, InputShape("t", 64, 2, "train"), seed=0, step=0)
    routed, flips, forced = 0, [], (None, None)
    if cfg.moe is not None:
        def probe(worker, routing):
            tokens, labels = (torch.from_numpy(batch[k]).to(worker.ctx.device)
                              for k in ("tokens", "labels"))
            media = batch.get("media_emb")
            media = None if media is None else torch.from_numpy(media).to(worker.ctx.device)
            with torch.no_grad(), routing:
                worker.ctx.model.loss(worker.params, tokens, labels, media)
            return routing.calls

        on_gpu, on_cpu = probe(gpu, _Routing()), probe(cpu, _Routing())
        moe_layers = sum(s.mlp == "moe" for s in cfg.prologue + cfg.block_pattern * cfg.num_blocks)
        _require(len(on_gpu) == len(on_cpu) == moe_layers, "routing probe missed a layer")
        routed = sum(e.numel() for _, e in on_gpu)
        if bf16:
            decided = [(p.cpu(), e.cpu()) for p, e in on_gpu]
            flips = _route_flips(decided, [(p, e) for p, e in on_cpu], f"pretrain parity ({arch})")
            forced = ([e for _, e in on_gpu], [e for _, e in decided])
        else:
            n = sum(int((a[1].cpu() != b[1]).sum()) for a, b in zip(on_gpu, on_cpu))
            _require(n == 0, f"pretrain parity ({arch}): {n} expert choices differ between "
                             "card and CPU, so the weights cannot be compared")
        del on_gpu, on_cpu
    with _Routing(forced=forced[0]):
        info_g = gpu.learn_on_batch(batch)
    with _Routing(forced=forced[1]):
        info_c = cpu.learn_on_batch(batch)
    w_g = tree_leaves(params_to_numpy(gpu.get_weights()))
    w_c = tree_leaves(params_to_numpy(cpu.get_weights()))
    err = max(float(np.abs(a - b).max()) for a, b in zip(w_g, w_c))
    stat_err = max(abs(info_g[k] - info_c[k]) for k in info_g)
    if bf16:
        ratio = max(float((np.abs(a - b) / (2 * PARITY_BF16_GAP * float(np.abs(b - w0).max())
                                             + 2.0 ** -7 * np.abs(b) + 1e-30)).max())
                    for a, b, w0 in zip(w_g, w_c, before))
        stat_ratio = max(abs(info_g[k] - info_c[k]) / (2 * PARITY_BF16_LOSS_GAP) for k in info_g)
        _require(ratio <= 1.0, f"pretrain parity ({arch}, bf16): card vs CPU weights {ratio:.3f} "
                               f"x their limit (max err {err:.3e})")
        _require(stat_ratio <= 1.0, f"pretrain parity ({arch}, bf16): stats {stat_ratio:.3f} x "
                                    f"their limit ({info_g} vs {info_c})")
        _require(all(p.dtype == torch.bfloat16 for p in tree_leaves(gpu.params) + tree_leaves(cpu.params)),
                 f"pretrain parity ({arch}, bf16): a learner's leaf is not bf16 after its step")
        tol = f"{ratio:.3f} x the per-leaf limit, stats {stat_ratio:.3f} x theirs"
    else:
        _require(err <= LEARNER_TOL, f"pretrain parity ({arch}): card vs CPU weights differ by {err:.3e}")
        _require(stat_err <= LEARNER_TOL, f"pretrain parity ({arch}): stats differ by {stat_err:.3e}")
        tol = f"tol {LEARNER_TOL}"
    routing = (f"; {routed} expert choices" + (f" (the CPU's own flipped at near ties: {flips})"
                                               if bf16 else " identical")
               if cfg.moe is not None else "")
    print(f"pretrain learner parity ({cfg.name}, {cfg.dtype}): one learn_on_batch (SGD, lr 1) on "
          f"2 x 64 tokens, card vs CPU max weight err {err:.3e}, max stat err {stat_err:.3e} "
          f"({tol}){routing}; loss {info_g['loss']:.4f}")
    out = {"dtype": cfg.dtype, "weight_err": err, "stat_err": stat_err,
           "expert_choices_checked": routed}
    if bf16:
        out.update(err_over_limit=ratio, stat_err_over_limit=stat_ratio, route_flips=flips)
    return out


def phase_pretrain_parity() -> dict:
    """``_pretrain_parity`` at the reduced RWKV-6, Phi-3.5-MoE and Qwen3-14B."""
    return {arch: _pretrain_parity(arch) for arch in PRETRAIN_PATHS.values()}


def phase_pretrain_parity_bf16() -> dict:
    """``_pretrain_parity`` at bfloat16, the configurations' own dtype, at
    the reduced RWKV-6, Phi-3.5-MoE, Qwen3-14B and DeepSeek-V2-Lite."""
    return {arch: _pretrain_parity(arch, bf16=True) for arch in PARITY_BF16_ARCHS}


def phase_zoo_parity() -> dict:
    """``_pretrain_parity`` at the reduced configurations of the six
    architectures of the model zoo's slice: Qwen1.5-32B (QKV bias),
    Nemotron-4 (squared ReLU), DeepSeek-V2-Lite (MLA, shared experts),
    Jamba (Mamba, MoE), LLaVA-NeXT (media prepended) and MusicGen (four
    codebooks)."""
    t0 = time.perf_counter()
    out = {arch: _pretrain_parity(arch) for arch in (
        "qwen1.5-32b", "nemotron-4-15b", *ZOO_PRETRAIN_PATHS.values())}
    print(f"zoo parity: {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------- phases 20-21
def _pretrain_expected(cfg) -> dict:
    """Launches per train() step implied by the configuration, layer by
    layer (prologue, then the pattern of each block): each layer's forward
    once (no remat) and its backward once; a GQA attention layer runs flash
    forward and backward, MLA none (the plain chunked path), Mamba none; an
    RWKV-6 layer the RWKV-6 forward and backward; an MoE MLP three expert
    products (up, gate, down) with a gated MLP, two without, and the dX and
    dW products of each in the backward.  A bfloat16 configuration launches
    the bf16 kernels (the names with ``_bf16``) in their place, and its
    grouped products' dX and dW are the reference's bf16 einsums, no
    kernel."""
    expect: dict = {}
    bf16 = cfg.dtype == "bfloat16"

    def add(name, n):
        if bf16:
            if name in ("moe_gmm_dx", "moe_gmm_dw"):
                return
            name += "_bf16"
        expect[name] = expect.get(name, 0) + n

    for spec in cfg.prologue + cfg.block_pattern * cfg.num_blocks:
        if spec.kind == "rwkv6":
            add("rwkv6_fwd", 1)
            add("rwkv6_bwd", 1)
        if spec.kind == "attn" and cfg.mla is None:
            add("flash_attention_fwd", 1)
            add("flash_attention_bwd", 1)
        if spec.mlp == "moe":
            for name in ("moe_gmm", "moe_gmm_dx", "moe_gmm_dw"):
                add(name, 3 if cfg.activation == "silu" else 2)
    return expect


def _check_path_shapes(cfg, batch: int) -> None:
    """The shapes phase 3 held the kernels to are this path's own."""
    T = PRETRAIN["seq"]
    kinds = {s.kind for s in cfg.prologue + cfg.block_pattern}
    if "rwkv6" in kinds:
        s = cfg.ssm
        shape = (batch, T, cfg.d_model // s.head_dim, s.head_dim)
        _require(shape == RWKV6_PATH_SHAPE, f"{cfg.name}: RWKV-6 shape {shape} != {RWKV6_PATH_SHAPE}")
    if cfg.moe is not None:
        e = cfg.moe
        C = max(1, math.ceil(e.capacity_factor * T * e.top_k / e.num_experts))
        shape = (e.num_experts * batch * C, cfg.d_model, e.d_ff, e.num_experts)
        known = (MOE_GMM_UP, DEEPSEEK_GMM_UP, JAMBA_GMM_UP)
        _require(shape in known, f"{cfg.name}: grouped-matmul shape {shape} is none of {known}")
    if "attn" in kinds and cfg.mla is None:
        shape = (batch, T, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        known = (PHI_ATTENTION, QWEN3_ATTENTION, LLAVA_ATTENTION, MUSICGEN_ATTENTION, JAMBA_ATTENTION)
        _require(shape in known, f"{cfg.name}: attention shape {shape} is none of {known}")


def phase_pretrain(name: str, counters: list) -> dict:
    """One LM pretraining main path: ``launch/train.py``'s flow
    (``make_pretrain`` -> ``build_lm_flow`` -> ``Algorithm.from_plan``) at
    the configuration's widths cut to 2 layers, ``steps`` train() calls
    under a deadline, the last one profiled.  Launches are read per step and
    must be exactly what the configuration implies, every other kernel 0.
    The ``PRETRAIN_BF16_PATHS`` train at the configuration's own dtype,
    bfloat16, as the driver does; the others in float32, which they ask for
    (``dataclasses.replace(cfg, dtype="float32")``)."""
    import dataclasses

    import torch

    from repro_torch.flow import Algorithm
    from repro_torch.launch.train import make_pretrain, train_config
    from repro_torch.tree import tree_leaves

    batch = PRETRAIN_BATCH.get(name, PRETRAIN["batch"])
    steps = (ZOO_STEPS if name in ZOO_PRETRAIN_PATHS else
             PRETRAIN_BF16_STEPS if name in PRETRAIN_BF16_PATHS else PRETRAIN["steps"])
    c = dict(PRETRAIN, batch=batch, data_shards=min(batch, PRETRAIN["data_shards"]), steps=steps)
    cfg, cut = train_config({**PRETRAIN_PATHS, **ZOO_PRETRAIN_PATHS, **PRETRAIN_BF16_PATHS}[name],
                            layers=c["layers"], with_note=True)
    _require(cfg.dtype == "bfloat16", f"{name}: the driver's configuration is {cfg.dtype}")
    if name not in PRETRAIN_BF16_PATHS:
        cfg = dataclasses.replace(cfg, dtype="float32")
    print(f"{name}: {cut}, {cfg.dtype}")
    _check_path_shapes(cfg, c["batch"])
    expect = {k.name: 0 for k in counters}
    expect.update(_pretrain_expected(cfg))
    # The synthetic tokens are uniform, so the loss stays at the NLL of
    # uniform labels under the initial logits, ln V + sigma^2 / 2, with sigma
    # = 0.02 sqrt(d_model) the logits' spread (the head's init scale times
    # the unit-RMS final norm): 11.91 for RWKV-6 and 11.20 for Phi-3.5-MoE.
    # V is MusicGen's codebook size (each codebook's head is a V-way
    # softmax), and LLaVA's loss is over its text positions.
    loss0 = math.log(cfg.vocab_size) + (0.02 * math.sqrt(cfg.d_model)) ** 2 / 2
    tokens = c["seq"] * c["batch"]  # LLaVA's count its media positions
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    with _deadline(PRETRAIN_DEADLINE_S, name):
        t_init = time.perf_counter()
        learner, _, workers, spec = make_pretrain(
            cfg, c["seq"], c["batch"], c["data_shards"], c["steps"], device="cuda"
        )
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t_init
        n_params = sum(p.numel() for p in tree_leaves(learner.params))
        with Algorithm.from_plan(spec, workers) as algo:
            for k in counters:
                k.reset()
            for i in range(c["steps"]):
                prof = None
                if i == c["steps"] - 1:  # the last step runs under the profiler
                    prof = _DeviceProfile()
                    prof.start()
                before = {k.name: k.value for k in counters}
                t0 = time.perf_counter()
                result = algo.train()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                if prof is not None:
                    busy = prof.stop()
                launched = {k.name: k.value - before[k.name] for k in counters}
                info = result["info"]
                if i == 0:
                    dtypes = sorted({str(p.dtype) for p in tree_leaves(learner.params)})
                    moments = sorted({str(m.dtype) for m in tree_leaves(learner.opt_state.mu)})
                rows.append({"step": i, "seconds": dt, "tokens_per_s": tokens / dt, **info})
                print(f"{name} train {i}: loss={info['loss']:.4f} nll={info['nll']:.4f} "
                      f"aux={info['aux']:.5f} {dt:.3f} s {tokens / dt:.1f} tokens/s "
                      + " ".join(f"{k}={v}" for k, v in launched.items() if v))
                _require(set(info) == {"loss", "nll", "aux"}, f"{name}: info keys {sorted(info)}")
                _require(all(math.isfinite(v) for v in info.values()), f"{name}: non-finite {info}")
                _require(abs(info["loss"] - loss0) < 0.5,
                         f"{name}: loss {info['loss']:.4f} not within 0.5 of ln V + sigma^2/2 = "
                         f"{loss0:.4f}")
                _require(result["counters"]["num_steps_trained"] == (i + 1) * c["batch"],
                         f"{name}: counters {result['counters']} after {i + 1} steps")
                _require(launched == expect, f"{name}: step {i} launched {launched}, expected {expect}")
            launches = {k.name: k.value for k in counters}
        peak = torch.cuda.max_memory_allocated()
        del learner, workers, spec, algo
    gc.collect()
    torch.cuda.empty_cache()
    _require(peak < 80e9, f"{name}: peak memory {peak / 1e9:.2f} GB")
    busy_ms = sum(busy.values()) / 1e3
    names = ("rwkv6_", "gmm_", "flash_", "decode_attention")
    ours = {k[:60]: v / 1e3 for k, v in busy.items() if any(n in k for n in names)}
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    warm = [r["seconds"] for r in rows[1:-1]]
    warm_s = sum(warm) / len(warm)
    profiled = {
        "wall_ms": dt * 1e3, "unprofiled_mean_ms": warm_s * 1e3, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / (dt * 1e3), "idle_share_vs_unprofiled": 1.0 - busy_ms / (warm_s * 1e3),
        "port_kernels_ms": ours, "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
    }
    print(f"{name} profile step {c['steps'] - 1}: wall {dt * 1e3:.1f} ms (unprofiled {warm_s * 1e3:.1f} "
          f"ms), device busy {busy_ms:.2f} ms, idle share {profiled['idle_share']:.4f} "
          f"({profiled['idle_share_vs_unprofiled']:.4f} vs unprofiled); peak memory "
          f"{peak / 2**30:.2f} GiB; {n_params / 1e9:.3f} B parameters, init {init_s:.2f} s")
    print(f"{name} top device kernels (ms): {profiled['top_kernels_ms']}")
    want = [f"torch.{cfg.dtype}"]
    _require(dtypes == want and moments == ["torch.float32"],
             f"{name}: parameters {dtypes} (want {want}), AdamW's moments {moments}")
    print(f"{name} main path: {c['steps']} train() steps of {tokens} tokens, "
          f"{warm_s:.3f} s per step and {tokens / warm_s:.1f} tokens/s after the first "
          f"(steps 1-{c['steps'] - 2}), per-step launches {expect}; phase "
          f"{time.perf_counter() - t_init:.1f} s")
    return {"config": cfg.name, "dtype": cfg.dtype, "layers": cfg.num_layers, "cut": cut,
            "batch": c["batch"], "param_dtypes": dtypes, "moment_dtypes": moments,
            "params": n_params, "steps": rows, "phase_s": time.perf_counter() - t_init,
            "seconds_per_step": warm_s, "tokens_per_s": tokens / warm_s, "init_s": init_s,
            "launches": launches,
            "expected_per_step": expect, "peak_memory_bytes": peak, "profile": profiled}


# ------------------------------------------------------------ phase 21b
def _serve_expected(cfg, steps: int) -> dict:
    """Launches of one prefill and ``steps`` decode steps, layer by layer:
    flash forward once a GQA attention layer in the prefill, decode
    attention once a GQA attention layer a step (MLA attends in its latent
    space with plain einsums), the RWKV-6 forward once an RWKV-6 layer in
    the prefill (the decode step is plain, as the reference's), and the
    grouped matmul three (gated) or two times an MoE layer in the prefill and
    in each step: the prefill's on the 128-row-tile kernel, each step's on
    the small-group kernel (block_m = B*C = 2), which ``moe_gmm`` counts too.
    Mamba is plain throughout.  A bfloat16 configuration launches the bf16
    kernels (the names with ``_bf16``) in their place."""
    expect: dict = {}
    bf16 = "_bf16" if cfg.dtype == "bfloat16" else ""

    def add(name, n):
        name += bf16
        expect[name] = expect.get(name, 0) + n

    for spec in cfg.prologue + cfg.block_pattern * cfg.num_blocks:
        if spec.kind == "attn" and cfg.mla is None:
            add("flash_attention_fwd", 1)
            add("decode_attention", steps)
        if spec.kind == "rwkv6":
            add("rwkv6_fwd", 1)
        if spec.mlp == "moe":
            products = 3 if cfg.activation == "silu" else 2
            add("moe_gmm", products * (1 + steps))
            add("moe_gmm_small", products * steps)
    return expect


def _serve_run(model, params, tokens, media, steps: int, profile_last: bool = False) -> tuple:
    """``make_prefill_step`` on tokens[:, :-steps] (and the media), then
    ``steps`` ``make_decode_step`` calls on the rest: (the prefill's last
    logits, each step's logits, the final cache, prefill s, s per step).
    With ``profile_last`` the last step runs under ``_DeviceProfile`` and
    the tuple ends with its device microseconds by kernel name."""
    import torch

    from repro_torch.models import make_decode_step, make_prefill_step

    S = tokens.shape[1] - steps
    W = tokens.shape[1] + (0 if media is None else media.shape[1])
    prefill, decode = make_prefill_step(model, window=W), make_decode_step(model)
    t0 = time.perf_counter()
    batch = {"tokens": tokens[:, :S]}
    if media is not None:
        batch["media_emb"] = media
    first, cache = prefill(params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits = []
    prof = None
    for i in range(steps):
        if profile_last and i == steps - 1:
            torch.cuda.synchronize()
            prof = _DeviceProfile()
            prof.start()
        step_logits, cache = decode(params, cache, {"tokens": tokens[:, S + i:S + i + 1]})
        logits.append(step_logits[:, 0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out = first[:, 0], torch.stack(logits, dim=1), cache, t1 - t0, (t2 - t1) / steps
    return out + (prof.stop(),) if prof is not None else out


def phase_serve_zoo(name: str, counters: list) -> dict:
    """One serving path of the model zoo: the configuration at its published
    widths cut to 2 layers (``cut_layers``), float32, random weights from a
    seed on the card; ``make_prefill_step`` on a 2 x 512 prompt (LLaVA with
    2,880 media embeddings before it), then 16 ``make_decode_step`` calls,
    counters zeroed just before and read just after and checked against
    ``_serve_expected``, every other kernel 0.  Each step's logits (and the
    prefill's last) must be within 1e-4 x max |logits| of one full forward's
    at the same position.  The int8 case (Qwen1.5-32B) also decodes with the
    float32 cache, which the forward gate holds, and its logits must be
    within 0.05 (relative) of that run's, its cache under 0.6 x the bytes."""
    import dataclasses

    import torch

    from repro_torch.launch.train import train_config
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves

    arch, cache_dtype = SERVE_ZOO[name]
    c = SERVE
    t_phase = time.perf_counter()
    cfg, cut = train_config(arch, layers=c["layers"], with_note=True)
    cfg = dataclasses.replace(cfg, dtype="float32")  # the float32 serve cases; bf16 is phase 21e
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=c["capacity_factor"]))
    float_cfg = cfg
    cfg = dataclasses.replace(cfg, kv_cache_dtype=cache_dtype)
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = model.init_params(g)
        n_params = sum(p.numel() for p in tree_leaves(params))
        B, T = c["batch"], c["prompt"] + c["steps"]
        shape = (B, T, cfg.num_codebooks) if cfg.modality == "audio" else (B, T)
        tokens = torch.randint(0, cfg.vocab_size, shape, generator=g, device="cuda")
        media = None
        if cfg.modality == "vlm":
            media = torch.randn((B, cfg.num_media_tokens, cfg.d_model), generator=g, device="cuda")
        expect = {k.name: 0 for k in counters}
        expect.update(_serve_expected(cfg, c["steps"]))
        torch.cuda.synchronize()
        for k in counters:
            k.reset()
        first, logits, cache, prefill_s, step_s = _serve_run(model, params, tokens, media, c["steps"])
        launches = {k.name: k.value for k in counters}
        _require(launches == expect, f"{name}: launched {launches}, expected {expect}")
        M = 0 if media is None else media.shape[1]
        x, _ = model.forward(params, tokens, media)
        full = model._head(params, x[:, M + c["prompt"] - 1:])
        del x
        want = full[:, 1:] if cache_dtype != "int8" else None
        scale = float(full.abs().max())
        first_err = float((first - full[:, 0]).abs().max())
        out = {"config": cfg.name, "cut": cut, "params": n_params, "prefill_s": prefill_s,
               "decode_step_s": step_s, "launches": launches, "expected": expect}
        if cache_dtype == "int8":
            # The float32 cache's run is the one held to the forward; the
            # int8 run is held to it.
            f_first, f_logits, f_cache, _, _ = _serve_run(Model(float_cfg), params, tokens, media,
                                                          c["steps"])
            first_err = float((f_first - full[:, 0]).abs().max())
            want, int8_logits, logits = full[:, 1:], logits, f_logits
            int8_rel = float((int8_logits - f_logits).abs().max() / f_logits.abs().max())

            def nbytes(tree):
                return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

            share = nbytes(cache) / nbytes(f_cache)
            _require(int8_rel < INT8_REL_TOL, f"{name}: int8 decode {int8_rel:.4f} from the float32 "
                                              f"cache's (limit {INT8_REL_TOL})")
            _require(share < INT8_BYTES, f"{name}: the int8 cache is {share:.3f} of the float32 "
                                         f"cache's bytes (limit {INT8_BYTES})")
            out.update(int8_rel_err=int8_rel, int8_cache_share=share,
                       int8_cache_bytes=nbytes(cache), float_cache_bytes=nbytes(f_cache))
        step_err = float((logits - want).abs().max())
        finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(first).all())
    peak = torch.cuda.max_memory_allocated()
    tol = SERVE_REL_TOL * scale
    _require(finite, f"{name}: non-finite logits")
    _require(max(step_err, first_err) <= tol,
             f"{name}: decode vs forward logits differ by {max(step_err, first_err):.3e} "
             f"(limit {SERVE_REL_TOL} x max |logits| = {tol:.3e})")
    _require(peak < 80e9, f"{name}: peak memory {peak / 1e9:.2f} GB")
    out.update(max_abs_logits=scale, decode_vs_forward_err=step_err, prefill_vs_forward_err=first_err,
               rel_err=max(step_err, first_err) / scale, peak_memory_bytes=peak)
    del params, cache, logits, full, tokens, media, model
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    int8 = (f"; int8 cache {out['int8_rel_err']:.2e} from the float32 cache's, "
            f"{out['int8_cache_share']:.3f} of its bytes" if cache_dtype == "int8" else "")
    print(f"{name} ({cut}): {n_params / 1e9:.3f} B parameters; prefill of {B} x {c['prompt']}"
          + (f" (+{M} media)" if M else "") + f" {prefill_s * 1e3:.1f} ms, {c['steps']} decode steps "
          f"{step_s * 1e3:.2f} ms each; decode vs forward max err {step_err:.3e}, prefill "
          f"{first_err:.3e} (limit {tol:.3e}){int8}; launches {launches}; peak memory "
          f"{peak / 2**30:.2f} GiB; phase {out['phase_s']:.1f} s")
    return out


class _Routing:
    """While active, records every MoE routing decision of the port
    (``models/moe.py``'s ``route``: the probabilities and the experts, on
    the device), or, given ``forced``, makes each call take the next of those
    experts instead, weighted by its own probabilities.  A bf16 serve case
    holds its decode steps to other runs on the decode run's expert choices,
    so that a near tie in a router, which bf16 rounding can tip either way,
    does not decide the comparison."""

    def __init__(self, forced: list = None):
        self.forced = forced
        self.calls: list = []

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self._moe, route = moe, moe.route
        pending = iter(self.forced or [])

        def recorded(p, x, cfg):
            probs, top_p, top_e = route(p, x, cfg)
            if self.forced is not None:
                top_e = next(pending)
                top_p = torch.gather(probs, -1, top_e)
            self.calls.append((probs, top_e))
            return probs, top_p, top_e

        self._route = route
        moe.route = recorded
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def by_layer(self, S: int, steps: int) -> list:
        """A prefill's and ``steps`` decode steps' calls as one call per MoE
        layer over all S + steps positions: [(probs, experts)], each
        [B, S + steps, ...]."""
        import torch

        layers = len(self.calls) // (1 + steps)
        return [tuple(torch.cat([self.calls[layer + j * layers][i] for j in range(1 + steps)], 1)
                      for i in range(2)) for layer in range(layers)]


def _route_flips(decided: list, other: list, name: str) -> list:
    """The positions where ``other``'s expert choices (one call per MoE
    layer over every position, in order) differ from ``decided``'s and no
    earlier difference in the row reaches (a token's keys and values reach
    the row's later positions), each required to be a near tie in
    ``decided``'s probabilities: [(row, position, k-th, (k + 1)-th)]."""
    import torch

    _require(len(other) == len(decided), f"{name}: {len(other)} routing calls, want {len(decided)}")
    B, P = decided[0][1].shape[:2] if decided else (0, 0)
    earliest = [P] * B
    flips = []
    for (probs, experts), (_, experts_o) in zip(decided, other):
        k = experts.shape[-1]
        differ = (torch.sort(experts, -1).values != torch.sort(experts_o, -1).values).any(-1)
        for b, p in differ.nonzero().tolist():
            if p < earliest[b]:
                ranked = torch.sort(probs[b, p].float(), descending=True).values.tolist()
                flips.append((b, p, ranked[k - 1], ranked[k]))
                _require(ranked[k - 1] - ranked[k] <= ROUTE_NEAR_TIE * ranked[k - 1],
                         f"{name}: the forward routes row {b} position {p} to other experts than "
                         f"the decode run where its top-{k} margin is no near tie: {ranked}")
                earliest[b] = p
    return flips


def phase_serve_bf16(name: str, counters: list) -> dict:
    """One bf16 serving path (``SERVE_BF16``): the configuration at its own
    dtype, bfloat16, cut to 2 layers (``cut_layers``, as its float32 case),
    MoE at capacity factor 8, random bf16 weights from a seed on the card;
    ``make_prefill_step`` on a 2 x 512 prompt then 16 ``make_decode_step``
    calls, counters zeroed just before and read just after and checked
    against ``_serve_expected`` (the bf16 kernels), every other kernel 0.
    Then, on the decode run's expert choices (``_Routing``): one bf16 full
    forward, each step's logits (and the prefill's last) within
    ``SERVE_BF16_REL_TOL`` x max |logits| of it at the same position, after
    the forward's own choices are held to the decode run's but at near ties
    (``_route_flips``); and the same prefill and steps in float32 on the
    weights widened, within ``SERVE_BF16_F32_REL_TOL`` x max |logits|.
    For Jamba and Nemotron-4 (``SERVE_BF16_DECODE_ATTENTION``) the warm-up
    run before it profiles its second and last decode step at the serve
    run's window: the device busy ms of the step and the bf16 decode
    kernel's share of it are printed.
    Prefill seconds, ms a step and peak memory of the bf16 run are printed;
    the float32 serve case of phase 21d has them at float32 (the float32
    run here starts on a freshly emptied allocator and is not timed)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.train import cut_layers
    from repro_torch.models import Model
    from repro_torch.tree import tree_leaves, tree_map

    c = SERVE
    t_phase = time.perf_counter()
    cfg, cut = cut_layers(get_config(SERVE_BF16[name]), c["layers"])
    _require(cfg.dtype == "bfloat16", f"{name}: {cfg.name} is {cfg.dtype}, not bfloat16")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=c["capacity_factor"]))
    model = Model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, steps = c["batch"], c["prompt"], c["steps"]
    with torch.no_grad():
        params = model.init_params(g)
        dtypes = sorted({str(t.dtype) for t in tree_leaves(params)})
        n_params = sum(p.numel() for p in tree_leaves(params))
        tokens = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=g, device="cuda")
        expect = {k.name: 0 for k in counters}
        expect.update(_serve_expected(cfg, steps))
        # A short run first, so that the timed run does not pay for the first
        # bf16 cuBLAS calls of the process: a 16-token prefill and a step;
        # for Jamba and Nemotron-4 the whole prompt but two tokens and two
        # steps at the serve run's window, the second step profiled: the
        # device busy ms of a step and the bf16 decode kernel's share of it.
        step_profile = None
        if name in SERVE_BF16_DECODE_ATTENTION:
            *_, kernels = _serve_run(model, params, tokens, None, 2, profile_last=True)
            busy = sum(kernels.values()) / 1e3
            attn = sum(us for k, us in kernels.items() if "decode_bf16_kernel" in k) / 1e3
            top = sorted(kernels, key=lambda k: -kernels[k])[:5]
            step_profile = {"device_busy_ms": busy, "decode_attention_bf16_ms": attn,
                            "decode_attention_bf16_share": attn / busy if busy else None,
                            "top_kernels_ms": {k[:80]: kernels[k] / 1e3 for k in top}}
            print(f"{name}: one profiled decode step: device busy {busy:.4f} ms, the bf16 "
                  f"decode kernel {attn:.4f} ms of it ({attn / busy if busy else 0:.3f}); top "
                  f"kernels {json.dumps(step_profile['top_kernels_ms'])}")
        else:
            _serve_run(model, params, tokens[:, :17], None, 1)
        torch.cuda.synchronize()
        for k in counters:
            k.reset()
        with _Routing() as decode_routes:
            first, logits, cache, prefill_s, step_s = _serve_run(model, params, tokens, None, steps)
        launches = {k.name: k.value for k in counters}
        _require(launches == expect, f"{name}: launched {launches}, expected {expect}")
        cache_dtypes = sorted({str(t.dtype) for t in tree_leaves(cache)})
        del cache
        decided = decode_routes.by_layer(S, steps)
        with _Routing() as natural:
            model.forward(params, tokens)
        flips = _route_flips(decided, natural.calls, name)
        del natural
        with _Routing(forced=[experts for _, experts in decided]):
            x, _ = model.forward(params, tokens)
        full = model._head(params, x[:, S - 1:]).float()
        del x
        peak = torch.cuda.max_memory_allocated()
        first, logits = first.float(), logits.float()
        scale = float(full.abs().max())
        step_err = float((logits - full[:, 1:]).abs().max())
        first_err = float((first - full[:, 0]).abs().max())
        finite = bool(torch.isfinite(logits).all()) and bool(torch.isfinite(first).all())
        del full
        # The float32 run of the same weights, widened (exactly), on the
        # decode run's expert choices in its call order.
        params = tree_map(lambda t: t.float() if t.dtype == torch.bfloat16 else t, params)
        gc.collect()
        torch.cuda.empty_cache()
        model32 = Model(dataclasses.replace(cfg, dtype="float32"))
        with _Routing(forced=[experts for _, experts in decode_routes.calls]):
            f_first, f_logits, _, _, _ = _serve_run(model32, params, tokens, None, steps)
        f32_err = max(float((logits - f_logits.float()).abs().max()),
                      float((first - f_first.float()).abs().max()))
    tol, f32_tol = SERVE_BF16_REL_TOL * scale, SERVE_BF16_F32_REL_TOL * scale
    _require(finite, f"{name}: non-finite logits")
    _require(dtypes == ["torch.bfloat16", "torch.float32"] or dtypes == ["torch.bfloat16"],
             f"{name}: parameter dtypes {dtypes}")
    _require(max(step_err, first_err) <= tol,
             f"{name}: bf16 decode vs the bf16 forward's logits differ by "
             f"{max(step_err, first_err):.3e} (limit {SERVE_BF16_REL_TOL} x max |logits| = {tol:.3e})")
    _require(f32_err <= f32_tol, f"{name}: bf16 vs float32 logits differ by {f32_err:.3e} (limit "
                                 f"{SERVE_BF16_F32_REL_TOL} x max |logits| = {f32_tol:.3e})")
    _require(peak < 80e9, f"{name}: peak memory {peak / 1e9:.2f} GB")
    out = {"config": cfg.name, "cut": cut, "params": n_params, "param_dtypes": dtypes,
           "cache_dtypes": cache_dtypes, "prefill_s": prefill_s, "decode_step_s": step_s,
           "launches": launches, "expected": expect, "max_abs_logits": scale,
           "decode_vs_forward_err": step_err, "prefill_vs_forward_err": first_err,
           "rel_err": max(step_err, first_err) / scale, "f32_err": f32_err,
           "f32_rel_err": f32_err / scale, "route_flips": flips, "peak_memory_bytes": peak,
           **({"decode_step_profile": step_profile} if step_profile else {})}
    del params, logits, first, f_logits, f_first, tokens, model, model32, decided, decode_routes
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"{name} ({cut}): {n_params / 1e9:.3f} B parameters {dtypes}, caches {cache_dtypes}; "
          f"prefill of {B} x {S} {prefill_s * 1e3:.1f} ms, {steps} decode steps "
          f"{step_s * 1e3:.2f} ms each; decode vs the bf16 forward max "
          f"err {step_err:.3e}, prefill {first_err:.3e} (limit {tol:.3e}); vs float32 "
          f"{f32_err:.3e} (limit {f32_tol:.3e}); routing near ties the forward tipped "
          f"{flips}; launches {launches}; peak memory {peak / 2**30:.2f} GiB; phase "
          f"{out['phase_s']:.1f} s")
    return out


# ------------------------------------------------------------ phases 22-27
def _maml_worker(index: int, device: str):
    """``tests/test_plans.py``'s pg worker (``pg_ws``), the MAML path's."""
    from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker

    cfg = PLAN_PATHS["maml"]
    policy = ActorCriticPolicy(4, 2, loss_kind="pg", rollout_len=cfg["rollout_len"])
    return RolloutWorker(CartPole(), policy, algo="pg", num_envs=cfg["num_envs"],
                         rollout_len=cfg["rollout_len"], seed=3, worker_index=index, device=device)


def _mbpo_worker(index: int, device: str):
    """``examples/mbpo_model_based.py``'s worker: a dynamics ensemble of two,
    synthetic rollouts of 8 steps from 128 replayed states."""
    from repro_torch.rl import ActorCriticPolicy, CartPole, ModelBasedWorker

    cfg = PLAN_PATHS["mbpo"]
    return ModelBasedWorker(
        CartPole(), ActorCriticPolicy(4, 2, loss_kind="pg"), algo="pg", num_envs=cfg["num_envs"],
        rollout_len=cfg["rollout_len"], seed=0, worker_index=index,
        ensemble_size=cfg["ensemble_size"], synth_rollout_len=cfg["synth_rollout_len"],
        synth_batch=cfg["synth_batch"], device=device,
    )


def _multiagent_worker(index: int, device: str, optimizer=None):
    """``benchmarks/common.py``'s multi-agent worker: agents 0-1 act for a
    PPO policy, agents 2-3 for a DQN policy."""
    from repro_torch.rl import (
        ActorCriticPolicy,
        DQNPolicy,
        MultiAgentCartPole,
        MultiAgentRolloutWorker,
    )

    kw = {"optimizer": optimizer} if optimizer is not None else {}
    specs = {"ppo_policy": {"policy": ActorCriticPolicy(4, 2, loss_kind="ppo"), "algo": "ppo", **kw},
             "dqn_policy": {"policy": DQNPolicy(4, 2), "algo": "dqn", **kw}}
    cfg = PLAN_PATHS["multi_agent_ppo_dqn"]
    return MultiAgentRolloutWorker(
        MultiAgentCartPole(cfg["num_agents"], MA_MAPPING), specs, MA_MAPPING,
        rollout_len=cfg["rollout_len"], seed=17, worker_index=index, device=device,
    )


def phase_plan_learner_parity() -> dict:
    """Card against CPU from the same weights on the same batches: the
    multi-agent worker's ``learn_on_batch`` for each policy id
    (``OFFPOLICY_PARITY_STEPS`` SGD steps at ``OFFPOLICY_PARITY_LR``; the PPO
    policy's loss on the surrogate kernels at [128, 2]), the model-based
    worker's ``train_dynamics`` over both ensemble members (the same, SGD in
    place of its Adam, whose first steps are lr * sign(g)), weights and stats
    within ``LEARNER_TOL`` (stats absolute below 1, relative above); then its
    synthetic rollout's deterministic core on injected actions, each step's
    columns within ``TOL``, and its advantages and returns (the GAE kernel
    at [8, 128] on the card) within ``TOL`` of the plain loop on the card's
    own columns and within ``LEARNER_TOL`` of the CPU's."""
    import numpy as np
    import torch

    from repro_torch.core.operators import StandardizeFields
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.optim import sgd
    from repro_torch.rl import MultiAgentBatch, ReplayBuffer
    from repro_torch.rl.advantages import gae as plain_gae

    out = {}
    gpu, cpu = (_multiagent_worker(0, dev, optimizer=sgd(OFFPOLICY_PARITY_LR))
                for dev in ("cuda", "cpu"))
    cpu.set_weights(params_to_numpy(gpu.get_weights()))
    cpu.target_params = params_from_numpy(params_to_numpy(gpu.target_params))
    samples = [gpu.sample() for _ in range(4)]
    ppo = StandardizeFields(["advantages"])(MultiAgentBatch.concat_samples(samples))
    rb = ReplayBuffer(capacity=4096, sample_batch_size=32, learning_starts=32, seed=0)
    for s in samples:
        rb.add_batch(s.policy_batches["dqn_policy"])
    batches = {"ppo_policy": ppo.policy_batches["ppo_policy"], "dqn_policy": rb.replay()}
    for pid, batch in batches.items():
        stat_err = stat_abs = 0.0
        for _ in range(OFFPOLICY_PARITY_STEPS):
            info_g = gpu.learn_on_batch(batch, policy_id=pid)
            info_c = cpu.learn_on_batch(batch, policy_id=pid)
            if pid == "dqn_policy":
                _require(isinstance(info_g["td_error"], np.ndarray),
                         f"multi-agent {pid}: td_error is {type(info_g['td_error'])}, not numpy")
            scaled, absolute = _stat_err(info_g, info_c)
            stat_err, stat_abs = max(stat_err, scaled), max(stat_abs, absolute)
        err = _tree_err(gpu.params[pid], cpu.params[pid])
        _require(err <= LEARNER_TOL, f"multi-agent {pid} learner parity: weights differ by {err:.3e}")
        _require(stat_err <= LEARNER_TOL,
                 f"multi-agent {pid} learner parity: stats differ by {stat_err:.3e}")
        print(f"multi-agent {pid} learner parity: {OFFPOLICY_PARITY_STEPS} learn_on_batch steps "
              f"(SGD, lr {OFFPOLICY_PARITY_LR}) on {batch.count} rows, card vs CPU max weight err "
              f"{err:.3e}, max stat err {stat_err:.3e} (absolute {stat_abs:.3e}; tol {LEARNER_TOL})")
        out[pid] = {"weight_err": err, "stat_err": stat_err, "stat_abs_err": stat_abs,
                    "rows": batch.count}

    cfg = PLAN_PATHS["mbpo"]
    gpu, cpu = (_mbpo_worker(0, dev) for dev in ("cuda", "cpu"))
    cpu.set_weights(params_to_numpy(gpu.get_weights()))
    for w in (gpu, cpu):
        w.dyn_opt = sgd(OFFPOLICY_PARITY_LR)
    cpu.dyn_params = [params_from_numpy(params_to_numpy(p)) for p in gpu.dyn_params]
    for w in (gpu, cpu):
        w.dyn_opt_states = [w.dyn_opt.init(p) for p in w.dyn_params]
    rb = ReplayBuffer(capacity=4096, sample_batch_size=cfg["replay"]["sample_batch_size"],
                      learning_starts=256, prioritized=False, seed=0)
    for _ in range(2):
        rb.add_batch(gpu.sample())
    batch = rb.replay()
    stat_err = stat_abs = 0.0
    for _ in range(OFFPOLICY_PARITY_STEPS):
        info_g, info_c = gpu.train_dynamics(batch), cpu.train_dynamics(batch)
        for a, b in zip(gpu.dyn_losses, cpu.dyn_losses):
            scaled, absolute = _stat_err({"l": a}, {"l": b})
            stat_err, stat_abs = max(stat_err, scaled), max(stat_abs, absolute)
    err = max(_tree_err(g, c) for g, c in zip(gpu.dyn_params, cpu.dyn_params))
    _require(err <= LEARNER_TOL and stat_err <= LEARNER_TOL,
             f"train_dynamics parity: weights differ by {err:.3e}, losses by {stat_err:.3e}")
    print(f"train_dynamics parity: {OFFPOLICY_PARITY_STEPS} steps of both members (SGD, lr "
          f"{OFFPOLICY_PARITY_LR}) on {batch.count} replayed rows, card vs CPU max weight err "
          f"{err:.3e}, max loss err {stat_err:.3e} (tol {LEARNER_TOL})")
    out["train_dynamics"] = {"weight_err": err, "stat_err": stat_err, "stat_abs_err": stat_abs}

    # The synthetic core on the same weights, start rows and actions.
    cpu.dyn_params = [params_from_numpy(params_to_numpy(p)) for p in gpu.dyn_params]
    T, N, member = cfg["synth_rollout_len"], cfg["synth_batch"], 1
    start = batch["obs"][:N]
    actions = np.random.default_rng(0).integers(0, 2, (T, N))
    cols = {}
    for w in (gpu, cpu):
        acts = torch.as_tensor(actions, device=w.device)
        cols[w.device.type] = w.synth_rollout(
            w.params, w.dyn_params[member], torch.as_tensor(start, device=w.device),
            lambda t, logits, acts=acts: acts[t])
    card = {k: v.cpu() for k, v in cols["cuda"].items()}
    errs = {k: _close(f"synthetic rollout {k}", card[k], cols["cpu"][k])
            for k in ("obs", "next_obs", "rewards", "logp", "values")}
    # The GAE kernel against the plain loop on the card's own columns and
    # bootstrap; card against CPU, each advantage sums up to 8 discounted
    # steps of per-step differences held to TOL above, so it is held to the
    # learner's tolerance.
    last_value = gpu.policy.value(gpu.params, cols["cuda"]["next_obs"][-1]).cpu()
    adv_p, ret_p = plain_gae(card["rewards"], card["values"], card["dones"], last_value,
                             gpu.gamma, gpu.lam)
    for k, want in (("advantages", adv_p), ("returns", ret_p)):
        errs[k] = _close(f"synthetic rollout {k}, GAE kernel vs plain", card[k], want)
        errs[k + "_card_vs_cpu"] = _close(f"synthetic rollout {k}, card vs CPU", card[k],
                                          cols["cpu"][k], LEARNER_TOL)
    print(f"synthetic rollout core parity: [{T}, {N}] on injected actions, member {member}, card "
          f"vs CPU max abs err {json.dumps(errs)} (tol {TOL}; the GAE kernel's advantages and "
          f"returns against the plain loop on the card's columns, card vs CPU {LEARNER_TOL})")
    out["synth_rollout"] = errs
    return out


def phase_plan_path(name: str, counters: list) -> dict:
    """MAML, MBPO or the PPO+DQN composition through ``Algorithm.from_plan``
    on CUDA workers (thread backend), ``iters`` ``train()`` calls under a
    deadline, the first reported apart (the actor threads' first CUDA
    work), then one profiled (the composition's: as many as last
    ``ASYNC_PROFILE_S``, since its iterations are PPO or DQN steps);
    then ``stop()`` and no thread of the flow left alive.  Launches are read
    against what the path ran: MAML samples twice a remote worker an
    iteration; MBPO ends each real rollout and each synthetic rollout in
    GAE; the composition ends each rollout in GAE and takes one surrogate
    forward and backward a PPO step."""
    import numpy as np
    import torch

    from repro_torch.core.actor import create_colocated
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm
    from repro_torch.interop import params_to_numpy
    from repro_torch.rl import ReplayBuffer
    from repro_torch.tree import tree_leaves

    cfg = PLAN_PATHS[name]
    make = {"maml": _maml_worker, "mbpo": _mbpo_worker,
            "multi_agent_ppo_dqn": _multiagent_worker}[name]
    threads_before = set(threading.enumerate())
    t_init = time.perf_counter()
    workers = WorkerSet.create(lambda i: make(i, "cuda"), cfg["num_workers"])
    replay = (create_colocated(lambda: ReplayBuffer(**cfg["replay"]), 1) if "replay" in cfg
              else None)
    algo = Algorithm.from_plan(name, workers, *([replay] if replay else []), **cfg["plan"])
    init_s = time.perf_counter() - t_init
    steps = {"train": 0, "ppo": 0, "dqn": 0}

    def check(result):
        steps["train"] += 1
        _require(set(result) == RESULT_KEYS, f"{name}: result keys {sorted(result)}")
        info = result["info"]
        if name == "multi_agent_ppo_dqn":
            if "ppo_policy" in info:  # the PPO branch's info is keyed by policy id
                steps["ppo"] += 1
                info = info["ppo_policy"]
            else:
                steps["dqn"] += 1
                _require(isinstance(info["td_error"], np.ndarray)
                         and np.isfinite(info["td_error"]).all(), f"{name}: td_error {info}")
                info = {k: v for k, v in info.items() if k != "td_error"}
        _require(set(info) == PLAN_INFO_KEYS[name], f"{name}: info keys {sorted(info)}")
        _require(all(math.isfinite(v) for v in info.values()), f"{name}: non-finite stats {info}")

    rows = []
    try:
        with _deadline(PLAN_DEADLINE_S, name):
            for c in counters:
                c.reset()
            for i in range(cfg["iters"] - 1):
                t0 = time.perf_counter()
                result = algo.train()
                torch.cuda.synchronize()
                rows.append({"iter": i, "seconds": time.perf_counter() - t0})
                check(result)
            before = steps["train"]
            result, dt, busy_ms, ours = _profiled_train(
                algo, check, ASYNC_PROFILE_S if name == "multi_agent_ppo_dqn" else 0.0)
            window_trains = steps["train"] - before
            launches = {c.name: c.value for c in counters}
            ctr = result["counters"]
            extra = {}
            if name == "maml":  # the broadcast left every worker on the meta weights
                local = tree_leaves(params_to_numpy(workers.local_worker().get_weights()))
                for actor in workers.remote_workers():
                    remote = tree_leaves(params_to_numpy(actor.sync("get_weights")))
                    _require(all((a == b).all() for a, b in zip(local, remote)),
                             "maml: a worker's weights differ from the meta weights")
            if name == "mbpo":
                extra["dyn_losses"] = list(workers.local_worker().dyn_losses)
            if replay is not None:
                extra["replay"] = [a.sync("stats") for a in replay]
    finally:
        algo.stop()
    left = [t.name for t in threading.enumerate() if t not in threads_before and t.is_alive()
            and not isinstance(t, threading._DummyThread)]
    _require(not left, f"{name}: threads of the flow alive after stop(): {left}")
    _require(ctr["num_steps_trained"] > 0, f"{name}: nothing trained: {ctr}")
    names = {k for k in ctr if not k.startswith("bytes_moved/")} - TIMING_COUNTERS
    _require(names <= PLAN_COUNTERS, f"{name}: counters {sorted(ctr)}")

    expect = {c.name: 0 for c in counters}
    if name == "maml":
        # Each iteration samples twice a remote worker (before and after its
        # inner adaptation), and trains on the post-adaptation rows.
        iters = steps["train"]
        expect["gae"] = 2 * cfg["num_workers"] * iters
        _require(ctr["num_steps_trained"] == iters * cfg["num_workers"] * cfg["num_envs"]
                 * cfg["rollout_len"], f"maml: counters {ctr} after {iters} iterations")
    elif name == "mbpo":
        real = ctr["num_steps_sampled"] // (cfg["num_envs"] * cfg["rollout_len"])
        synthetic = ctr["num_steps_trained"] // (cfg["synth_batch"] * cfg["synth_rollout_len"])
        expect["gae"] = real + synthetic
        _require(synthetic == steps["train"], f"mbpo: {synthetic} synthetic batches in "
                                              f"{steps['train']} iterations")
        losses = extra["dyn_losses"]
        _require(len(losses) == cfg["ensemble_size"] and all(math.isfinite(v) for v in losses),
                 f"mbpo: dyn_losses {losses}")
    else:
        rollouts = ctr["num_steps_sampled"] // (cfg["num_agents"] * cfg["rollout_len"])
        expect.update(gae=rollouts, ppo_surrogate_fwd=steps["ppo"], ppo_surrogate_bwd=steps["ppo"])
        _require(steps["ppo"] > 0 and steps["dqn"] > 0
                 and steps["ppo"] + steps["dqn"] == steps["train"], f"{name}: steps {steps}")
        _require(ctr["num_steps_trained"] == steps["ppo"] * cfg["plan"]["ppo_batch_size"]
                 + steps["dqn"] * cfg["replay"]["sample_batch_size"],
                 f"{name}: counters {ctr} for {steps} training steps")
        _require(sum(s["added"] for s in extra["replay"]) > 0, f"{name}: replay {extra['replay']}")
    _keyed_launches(name, launches, expect)
    _require(launches == expect, f"{name}: launches {launches}, expected {expect}")
    first, after = rows[0]["seconds"], [r["seconds"] for r in rows[1:]]
    mean = sum(after) / len(after)
    profile = {"window_ms": dt * 1e3, "train_calls": window_trains, "device_busy_ms": busy_ms,
               "idle_share": 1.0 - busy_ms / (dt * 1e3), "port_kernels_ms": ours}
    print(f"{name} main path: {steps['train']} train() iterations (first {first:.4f} s, mean of "
          f"the next {len(after)} {mean:.4f} s, init {init_s:.2f} s; then {window_trains} under the "
          f"profiler), counters "
          f"{ {k: v for k, v in ctr.items() if not k.startswith('bytes_moved/')} }"
          + (f", PPO/DQN steps {steps}" if name == "multi_agent_ppo_dqn" else "")
          + (f", dyn_losses {extra['dyn_losses']}" if name == "mbpo" else "")
          + (f", replay {extra['replay']}" if replay is not None else "")
          + f"; launches {launches} (expected from the counters); profiled window "
          f"{dt * 1e3:.1f} ms, device busy {busy_ms:.3f} ms, idle share {profile['idle_share']:.4f}, "
          f"port kernels {ours}; no flow thread alive after stop()")
    return {"iterations": rows, "init_s": init_s, "first_s": first, "mean_s": mean,
            "launches": launches, "counters": ctr, "profile": profile, "steps": steps, **extra}


def _iters_per_s(it, iters: int, warmup: int = 12) -> float:
    """``benchmarks/bench_multiagent.py``'s rate: pulls per second after
    ``warmup`` pulls (until every branch has run)."""
    import torch

    src = iter(it)
    for _ in range(warmup):
        next(src)
    t0 = time.perf_counter()
    for _ in range(iters):
        next(src)
    torch.cuda.synchronize()
    return iters / (time.perf_counter() - t0)


def phase_composition() -> dict:
    """Fig 12 on the card, as ``benchmarks/bench_multiagent.py`` computes it:
    PPO-only and DQN-only sub-flows on the multi-agent workers, then the
    composed plan; the composed (PPO, DQN) pair rate against the ideal of
    time-sharing one driver, 1 / (1 / r_ppo + 1 / r_dqn).  Printed, not
    gated."""
    from repro_torch.core.actor import create_colocated
    from repro_torch.core.concurrency import Concurrently
    from repro_torch.core.operators import (
        ConcatBatches,
        ParallelRollouts,
        Replay,
        SelectExperiences,
        StandardizeFields,
        StoreToReplayBuffer,
        TrainOneStep,
        UpdateReplayPriorities,
        UpdateTargetNetwork,
    )
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm
    from repro_torch.rl import ReplayBuffer, SampleBatch

    cfg = PLAN_PATHS["multi_agent_ppo_dqn"]
    iters = COMPOSITION_ITERS

    def workers():
        return WorkerSet.create(lambda i: _multiagent_worker(i, "cuda"), cfg["num_workers"])

    def replay():
        return create_colocated(lambda: ReplayBuffer(**cfg["replay"]), 1)

    ws = workers()
    try:
        ppo = (ParallelRollouts(ws, mode="bulk_sync")
               .for_each(SelectExperiences(["ppo_policy"]))
               .for_each(ConcatBatches(cfg["plan"]["ppo_batch_size"]))
               .for_each(StandardizeFields(["advantages"]))
               .for_each(TrainOneStep(ws, policies=["ppo_policy"])))
        r_ppo = _iters_per_s(ppo, iters)
    finally:
        ws.stop()

    ws, rp = workers(), replay()
    try:
        def _flat(b):
            sel = SelectExperiences(["dqn_policy"])(b)
            return SampleBatch.concat_samples(list(sel.policy_batches.values()))

        store = ParallelRollouts(ws, mode="bulk_sync").for_each(_flat).for_each(
            StoreToReplayBuffer(rp))
        train = TrainOneStep(ws, policies=["dqn_policy"])

        def _train(pair):
            b, actor = pair
            return train(b), actor

        replay_op = (Replay(rp).zip_with_source_actor().for_each(_train)
                     .for_each(UpdateReplayPriorities())
                     .for_each(UpdateTargetNetwork(ws, cfg["plan"]["dqn_target_update_freq"])))
        r_dqn = _iters_per_s(Concurrently([store, replay_op], mode="round_robin",
                                          output_indexes=[1]), iters)
    finally:
        ws.stop()
        rp.stop()

    with Algorithm.from_plan("multi_agent_ppo_dqn", workers(), replay(), **cfg["plan"]) as algo:
        r_comb = _iters_per_s(algo, iters)
    ideal_pairs = 1.0 / (1.0 / r_ppo + 1.0 / r_dqn)
    pairs = r_comb / 2.0
    out = {"ppo_iters_per_s": r_ppo, "dqn_iters_per_s": r_dqn, "combined_pairs_per_s": pairs,
           "amdahl_ideal_pairs_per_s": ideal_pairs, "frac_of_ideal": pairs / ideal_pairs,
           "iters": iters}
    print(f"composition (Fig 12, bench_multiagent's arithmetic; not gated): PPO-only "
          f"{r_ppo:.2f} iters/s, DQN-only {r_dqn:.2f} iters/s, composed {pairs:.2f} pairs/s "
          f"against the ideal {ideal_pairs:.2f}: fraction {pairs / ideal_pairs:.3f}")
    return out


def phase_async_opt() -> dict:
    """Fig 13b on the card, as ``benchmarks/bench_async_opt.py`` computes it:
    steps trained per second of ``build_a3c`` through ``Algorithm.train()``
    and of the hand-written ``a3c_lowlevel`` loop on the same workers
    (``benchmarks/common.py``'s 2 pg workers), one warm-up iteration each.
    Printed, not gated."""
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm
    from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker
    from repro_torch.rl.lowlevel import a3c_lowlevel

    iters = ASYNC_OPT_ITERS

    def workers():
        return WorkerSet.create(lambda i: RolloutWorker(
            CartPole(), ActorCriticPolicy(4, 2, loss_kind="pg", rollout_len=32), algo="pg",
            num_envs=4, rollout_len=32, seed=11, worker_index=i, device="cuda"), 2)

    with Algorithm.from_plan("a3c", workers()) as algo:
        algo.train()
        t0 = time.perf_counter()
        for _ in range(iters):
            res = algo.train()
        flow = res["counters"]["num_steps_trained"] / (time.perf_counter() - t0)
    ws = workers()
    try:
        it = a3c_lowlevel(ws)
        next(it)
        t0 = time.perf_counter()
        for _ in range(iters):
            res = next(it)
        low = res["counters"]["num_steps_trained"] / (time.perf_counter() - t0)
    finally:
        ws.stop()
    print(f"async optimization (Fig 13b, bench_async_opt's arithmetic; not gated): build_a3c "
          f"{flow:.1f} steps/s, a3c_lowlevel {low:.1f} steps/s, flow / lowlevel {flow / low:.3f}")
    return {"flow_steps_per_s": flow, "lowlevel_steps_per_s": low, "flow_vs_lowlevel": flow / low,
            "iters": iters}


# ------------------------------------------------------------------- main
# ------------------------------------------------------------- phase 28
def phase_keys() -> dict:
    """Per-lane threefry keys (``repro_torch.prng``): for ``KEY_LANES`` lane
    keys, the splits, fold-ins, bits, uniforms and ``randint`` draws on the
    card equal the CPU's bit for bit, and ``categorical`` on identical
    logits picks identical actions (CartPole's two actions and the PPO-LM
    vocabulary); the per-step cost of keyed token sampling at PPO-LM's
    [8, 151936] is timed beside the one-generator ``torch.multinomial`` it
    replaced."""
    import torch

    from repro_torch import prng
    from repro_torch.configs.qwen15_4b import CONFIG as QWEN

    vocab = QWEN.vocab_size
    keys_c = prng.split(prng.key(23), KEY_LANES)
    keys_g = prng.split(prng.key(23, "cuda"), KEY_LANES)
    _require(torch.equal(keys_g.cpu(), keys_c), "prng: split(key) differs between card and CPU")
    lanes = torch.arange(KEY_LANES)
    draws = {
        "split": lambda k, d: prng.split(k, 2),
        "fold_in": lambda k, d: prng.fold_in(k[0], lanes.to(d)),
        "random_bits": lambda k, d: prng.random_bits(k, (8,)),
        "uniform": lambda k, d: prng.uniform(k, (8,)),
        "randint": lambda k, d: prng.randint(k, (), 0, 5),
    }
    for name, draw in draws.items():
        _require(torch.equal(draw(keys_g, "cuda").cpu(), draw(keys_c, "cpu")),
                 f"prng: {name} differs between card and CPU")
    gen = torch.Generator().manual_seed(24)
    out = {"lanes": KEY_LANES, "bitwise": sorted(draws)}
    for width, rows in ((2, KEY_LANES), (vocab, 8)):
        logits = torch.randn((rows, width), generator=gen)
        a_c = prng.categorical(keys_c[:rows], logits)
        a_g = prng.categorical(keys_g[:rows], logits.cuda())
        _require(torch.equal(a_g.cpu(), a_c), f"prng: categorical actions differ at [{rows}, {width}]")
        gumbel_err = _max_err(prng.gumbel(keys_g[:rows], (width,)).cpu(),
                              prng.gumbel(keys_c[:rows], (width,)))
        out[f"categorical_{rows}x{width}"] = {"actions_equal": True, "gumbel_max_abs_err": gumbel_err}
    logits = torch.randn((8, vocab), generator=gen).cuda()
    keys8 = keys_g[:8]
    sampler = torch.Generator(device="cuda").manual_seed(0)
    out["lm_sampling_ms"] = {
        "keyed_categorical": _time_ms(lambda: prng.categorical(keys8, logits), iters=50),
        "generator_multinomial": _time_ms(
            lambda: torch.multinomial(torch.softmax(logits, -1), 1, generator=sampler), iters=50),
    }
    print(f"keys: {KEY_LANES} lane keys, {', '.join(sorted(draws))} bitwise equal card vs CPU; "
          f"categorical actions equal at [{KEY_LANES}, 2] and [8, {vocab}] (gumbel max abs "
          f"err {out[f'categorical_8x{vocab}']['gumbel_max_abs_err']:.3e}); PPO-LM token "
          f"sampling per decode step at [8, {vocab}]: keyed "
          f"{out['lm_sampling_ms']['keyed_categorical']:.4f} ms, one-generator multinomial "
          f"{out['lm_sampling_ms']['generator_multinomial']:.4f} ms (CUDA events)")
    return out


# ------------------------------------------------------------- phase 29
def _three_clients_vs_whole(policy: str) -> dict:
    """Three clients, each with 8 lanes of its own, act concurrently through
    a 3-replica tier (``build_serving_tier``, sticky for the SSM) for
    ``SERVE_PARITY_STEPS`` steps; one replica with the same weights serves
    all 24 lanes as one batch a step from the same obs and keys.  Actions
    equal, log-probs and values within ``TOL``; whether bitwise is
    reported, not required (a replica's batch has another size than the
    whole batch, and cuBLAS may round a row differently at another size)."""
    import numpy as np

    from repro_torch.launch.serve import build_serving_tier

    lanes_per, clients = SERVE_LOAD["lanes_per_request"], 3
    n = lanes_per * clients
    router, actors = build_serving_tier(policy=policy, replicas=3, seed=7, device="cuda")
    _, (whole,) = build_serving_tier(policy=policy, replicas=1, seed=7, supervised=False,
                                     device="cuda")
    whole.set_weights(actors[0].sync("get_weights"))
    rng = np.random.RandomState(11)
    lanes = np.arange(n)
    max_diff, bitwise = 0.0, True
    try:
        for step in range(SERVE_PARITY_STEPS):
            obs = rng.randn(n, 4).astype(np.float32)
            keys = rng.randint(0, 2**31, size=(n, 2)).astype(np.uint32)
            got = [None] * clients
            barrier = threading.Barrier(clients)

            def client(c):
                sl = slice(c * lanes_per, (c + 1) * lanes_per)
                barrier.wait()
                got[c] = router.compute_actions(obs[sl], keys[sl], lanes[sl])

            threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            want = whole.compute_actions(obs, keys, lanes if whole.stateful else None)
            for j, w in enumerate(want):
                g = np.concatenate([r[j] for r in got])
                if j == 0:
                    _require(np.array_equal(g, w), f"serving {policy}: 3-replica actions differ "
                                                   f"from the whole batch at step {step}")
                    continue
                diff = float(np.abs(g - w).max())
                max_diff = max(max_diff, diff)
                bitwise = bitwise and np.array_equal(g, w)
                _require(np.allclose(g, w, atol=TOL, rtol=TOL),
                         f"serving {policy}: 3-replica logp/values differ from the whole batch "
                         f"by {diff:.3e} at step {step}")
        spread = [a.sync("stats")["num_requests"] for a in actors]
    finally:
        router.stop()
    return {"steps": SERVE_PARITY_STEPS, "max_abs_diff": max_diff, "bitwise": bitwise,
            "requests_per_replica": spread}


def phase_serving() -> dict:
    """The serving tier on the card (``launch/serve.py``): each policy
    (stateless, ac, ssm) at 1 and 3 replicas, warmed by ``warm_replicas``
    (every replica thread's first CUDA and cuBLAS work outside the window),
    then ``open_loop_load`` at the CLI's defaults; and
    ``benchmarks/bench_serve.py``'s four properties, each failing the
    phase: the 3-replica stateless tier bitwise equal to one local dispatch,
    sticky pins held through the 3-replica SSM soak, a kill of 1 of 3
    replicas under ``drop_shard`` dropping only in-flight requests and the
    tier healed to 2, and the 3-replica stateless soak's p99 <= 100 * p50 +
    50 ms with no drops.  Then the ac and ssm tiers at 3 replicas against
    one whole-batch dispatch (``_three_clients_vs_whole``)."""
    import numpy as np

    from repro_torch.launch.serve import build_serving_tier, open_loop_load, warm_replicas
    from repro_torch.rl import DummyPolicy, InferenceActor

    load = SERVE_LOAD
    lanes_n = load["lanes_per_request"] * load["num_clients"]
    tiers, props = {}, {}
    for policy, replicas in SERVE_TIERS:
        router, actors = build_serving_tier(policy=policy, replicas=replicas, seed=7,
                                            device="cuda")
        try:
            t0 = time.perf_counter()
            warm_replicas(router, lanes_n=lanes_n)
            warm_s = time.perf_counter() - t0
            res = open_loop_load(router, **load)
            if (policy, replicas) == ("ssm", 3):
                per_rep = [a.sync("stats")["num_lane_states"] for a in actors]
                stats = router.stats()
                props["sticky_pinning_ok"] = (sum(per_rep) == stats["num_pinned_lanes"] == lanes_n
                                              and stats["num_lane_repins"] == 0
                                              and stats["sticky"] is True)
            dispatches = [a.sync("stats")["num_dispatches"] for a in actors]
        finally:
            router.stop()
        _require(res["requests_ok"] == load["num_requests"] and res["requests_dropped"] == 0,
                 f"serving {policy} x{replicas}: {res}")
        tag = f"{policy}_r{replicas}"
        tiers[tag] = {**res, "warm_s": warm_s, "dispatches": dispatches}
        print(f"serving {tag}: {res['rps']:.1f} req/s, {res['lane_steps_per_s']:.1f} lane steps/s, "
              f"latency p50 {res['latency_p50_s'] * 1e3:.3f} ms p99 "
              f"{res['latency_p99_s'] * 1e3:.3f} ms mean {res['latency_mean_s'] * 1e3:.3f} ms "
              f"(offered {load['rate_hz']:.0f} req/s x {load['num_requests']}, "
              f"{load['lanes_per_request']} lanes, {load['num_clients']} clients; warm "
              f"{warm_s:.2f} s; dispatches per replica {dispatches})")
    tail = tiers["stateless_r3"]
    props["latency_tail_ok"] = (tail["latency_p99_s"] <= 100.0 * tail["latency_p50_s"] + 0.050
                                and tail["requests_dropped"] == 0)
    # Bit parity: the 3-replica stateless tier against one local dispatch.
    rng = np.random.RandomState(7)
    obs = rng.randn(load["lanes_per_request"], 4).astype(np.float32)
    keys = rng.randint(0, 2**31, size=(load["lanes_per_request"], 2)).astype(np.uint32)
    ref = InferenceActor(lambda: DummyPolicy(4, 2), seed=7, device="cuda").compute_actions(obs, keys)
    router, _ = build_serving_tier(policy="stateless", replicas=3, seed=7, device="cuda")
    try:
        warm_replicas(router, lanes_n=lanes_n)
        got = router.compute_actions(obs, keys)
    finally:
        router.stop()
    props["bit_parity_ok"] = all(np.array_equal(a, b) for a, b in zip(ref, got))
    # Kill 1 of 3 replicas mid-load under drop_shard.
    router, actors = build_serving_tier(policy="stateless", replicas=3,
                                        failure_policy="drop_shard", seed=7, device="cuda")
    try:
        warm_replicas(router, lanes_n=lanes_n)

        def kill_one():
            time.sleep(0.4 * load["num_requests"] / load["rate_hz"])
            actors[0].kill()

        killer = threading.Thread(target=kill_one)
        killer.start()
        res = open_loop_load(router, **load, on_failure="recover")
        killer.join()
        router.recover()  # a kill between dispatches trips nothing: heal explicitly
        stats = router.stats()
        props["replica_kill_recovery_ok"] = (
            stats["num_replicas_dropped"] == 1 and len(stats["replicas"]) == 2
            and res["requests_ok"] + res["requests_dropped"] == load["num_requests"]
            and res["requests_ok"] > 0)
        kill = {"requests_ok": res["requests_ok"], "requests_dropped": res["requests_dropped"],
                "replicas_after": len(stats["replicas"])}
    finally:
        router.stop()
    print(f"serving properties (benchmarks/bench_serve.py): {props}; the kill dropped "
          f"{kill['requests_dropped']} in-flight request(s), {kill['requests_ok']} served, "
          f"{kill['replicas_after']} replicas after; tail p99 {tail['latency_p99_s'] * 1e3:.3f} "
          f"ms <= 100 x p50 {tail['latency_p50_s'] * 1e3:.3f} ms + 50 ms")
    _require(all(props.values()) and len(props) == 4, f"serving properties {props}")
    whole = {policy: _three_clients_vs_whole(policy) for policy in ("ac", "ssm")}
    for policy, w in whole.items():
        print(f"serving {policy} x3 vs one whole-batch dispatch, {w['steps']} steps of 3 clients x "
              f"8 lanes: actions equal, max |logp/value diff| {w['max_abs_diff']:.3e} (tol {TOL}), "
              f"bitwise {w['bitwise']}; requests per replica {w['requests_per_replica']}")
    return {"tiers": tiers, "properties": props, "kill": kill, "vs_whole_batch": whole}


# ------------------------------------------------------------- phase 30
def phase_mamba_parity() -> dict:
    """``SSMStatePolicy`` (Mamba) on the card against the CPU from the same
    weights and lane keys, ``MAMBA_STEPS`` decode steps of ``MAMBA_LANES``
    lanes: each step from the CPU's state, actions equal and log-probs,
    values and the new state within ``TOL``; each device carrying its own
    state, actions equal every step and everything within
    ``LEARNER_TOL`` after the last."""
    import torch

    from repro_torch import prng
    from repro_torch.rl import SSMStatePolicy, VectorEnv
    from repro_torch.tree import tree_leaves, tree_map

    pol = SSMStatePolicy(4, 2)
    params_c = pol.init_params(torch.Generator().manual_seed(0))
    params_g = tree_map(lambda x: x.cuda(), params_c)
    s_c, s_g = pol.init_lane_state(MAMBA_LANES), pol.init_lane_state(MAMBA_LANES, "cuda")
    chain = prng.split(prng.key(5), MAMBA_LANES)
    gen = torch.Generator().manual_seed(6)
    step_err, carried = 0.0, {}

    def errs(a, b):
        return max(_max_err(x.cpu(), y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    with torch.no_grad():
        for t in range(MAMBA_STEPS):
            chain, keys = VectorEnv._split_lanes(chain)
            obs = torch.randn((MAMBA_LANES, 4), generator=gen)
            a_c, lp_c, v_c, s_c_next = pol.compute_actions_stateful(params_c, obs, keys, s_c)
            a_1, lp_1, v_1, s_1 = pol.compute_actions_stateful(
                params_g, obs.cuda(), keys.cuda(), tree_map(lambda x: x.cuda(), s_c))
            _require(torch.equal(a_1.cpu(), a_c), f"mamba: actions differ at step {t}")
            err = errs([lp_1, v_1, s_1], [lp_c, v_c, s_c_next])
            _require(err <= TOL, f"mamba: step {t} from the CPU's state differs by {err:.3e}")
            step_err = max(step_err, err)
            a_g, lp_g, v_g, s_g = pol.compute_actions_stateful(params_g, obs.cuda(), keys.cuda(), s_g)
            _require(torch.equal(a_g.cpu(), a_c), f"mamba: carried actions differ at step {t}")
            carried = {"logp_value": errs([lp_g, v_g], [lp_c, v_c]),
                       "state": errs(s_g, s_c_next)}
            s_c = s_c_next
    _require(max(carried.values()) <= LEARNER_TOL,
             f"mamba: after {MAMBA_STEPS} carried steps card vs CPU differ by {carried}")
    print(f"mamba parity: SSMStatePolicy, {MAMBA_LANES} lanes x {MAMBA_STEPS} steps, actions equal; "
          f"a step from the same state max err {step_err:.3e} (tol {TOL}); carried "
          f"{MAMBA_STEPS} steps: logp/value {carried['logp_value']:.3e}, state "
          f"{carried['state']:.3e} (tol {LEARNER_TOL})")
    return {"step_err": step_err, "carried": carried}


# ------------------------------------------------------------- phase 31
def _tf_worker(index: int, device: str, optimizer=None):
    """A worker of the server-inference path: ``TransformerPolicy`` at its
    defaults (d_model 64, 2 layers, 4 tokens: 2 heads of 32) on CartPole,
    the vectorized engine."""
    from repro_torch.rl import CartPole, TransformerPolicy, VectorizedRolloutWorker

    cfg = TF_SERVE
    return VectorizedRolloutWorker(CartPole(), TransformerPolicy(4, 2), algo="ppo",
                                   num_envs=cfg["num_envs"], rollout_len=cfg["rollout_len"],
                                   seed=0, worker_index=index, device=device, optimizer=optimizer)


def phase_transformer_learner_parity() -> dict:
    """One ``learn_on_batch`` (SGD, lr 1: the weight difference is the
    gradient difference) of a ``TransformerPolicy`` PPO learner on two
    samples' rows, on the card (flash forward and backward, the surrogate
    kernels) and on the CPU (plain versions) from the same weights: within
    ``LEARNER_TOL``.  Adam's first step, lr * sign(g), would turn the tiny
    gradients of ``pos`` into full-size steps of either sign."""
    from repro_torch.core.operators import StandardizeFields
    from repro_torch.interop import params_to_numpy
    from repro_torch.optim import sgd
    from repro_torch.rl import SampleBatch

    gpu, cpu = _tf_worker(0, "cuda", sgd(1.0)), _tf_worker(0, "cpu", sgd(1.0))
    cpu.set_weights(params_to_numpy(gpu.get_weights()))
    batch = StandardizeFields(["advantages"])(SampleBatch.concat_samples([gpu.sample(), gpu.sample()]))
    info_g, info_c = gpu.learn_on_batch(batch), cpu.learn_on_batch(batch)
    err = _tree_err(gpu.get_weights(), cpu.get_weights())
    stat_err, stat_abs = _stat_err(info_g, info_c)
    _require(err <= LEARNER_TOL and stat_err <= LEARNER_TOL,
             f"transformer learner parity: weights {err:.3e}, stats {stat_err:.3e}")
    print(f"transformer learner parity: one SGD step on {batch.count} rows, card vs CPU max weight "
          f"err {err:.3e}, stat err {stat_err:.3e} ({stat_abs:.3e} absolute) (tol {LEARNER_TOL})")
    return {"weight_err": err, "stat_err": stat_err, "stat_abs_err": stat_abs, "rows": batch.count}


def phase_transformer_server(counters: list) -> dict:
    """PPO with ``TransformerPolicy`` and decoupled inference: 2 CUDA workers
    of 8 CartPole lanes, ``inference="server"`` with 3 replicas behind the
    router (sticky, by the policy's lane-state protocol), ``iters``
    ``train()`` calls under a deadline, the last one profiled, then
    ``stop()`` and no flow thread left.  Launches are checked exactly
    against the path's own counters: each serve dispatch, each rollout's
    GAE bootstrap and each SGD step's forward run one flash forward a layer;
    each SGD step one flash backward a layer and one surrogate forward and
    backward; each rollout one GAE; every other kernel none."""
    import torch

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm

    cfg = TF_SERVE
    threads_before = set(threading.enumerate())
    t_init = time.perf_counter()
    workers = WorkerSet.create(lambda i: _tf_worker(i, "cuda"), cfg["num_workers"])
    algo = Algorithm.from_plan(
        "ppo", workers, train_batch_size=cfg["train_batch_size"], num_sgd_iter=cfg["num_sgd_iter"],
        sgd_minibatch_size=cfg["sgd_minibatch_size"], inference="server",
        inference_replicas=cfg["replicas"])
    init_s = time.perf_counter() - t_init
    ((nid, meta),) = algo.compiled._inference_meta.items()
    router = meta["router"]

    def check(result):
        info = result["info"]
        _require(set(result) == RESULT_KEYS, f"transformer server: result keys {sorted(result)}")
        _require(set(info) == INFO_KEYS and all(math.isfinite(info[k]) for k in INFO_KEYS),
                 f"transformer server: info {info}")

    rows = []
    try:
        with _deadline(TF_SERVE_DEADLINE_S, "transformer server"):
            for c in counters:
                c.reset()
            for i in range(cfg["iters"] - 1):
                t0 = time.perf_counter()
                result = algo.train()
                torch.cuda.synchronize()
                rows.append({"iter": i, "seconds": time.perf_counter() - t0})
                check(result)
            result, dt, busy_ms, ours = _profiled_train(algo, check)
            launches = {c.name: c.value for c in counters}
            stats = router.stats()
            ctr = result["counters"]
    finally:
        algo.stop()
    left = [t.name for t in threading.enumerate() if t not in threads_before and t.is_alive()
            and not isinstance(t, threading._DummyThread)]
    _require(not left, f"transformer server: threads of the flow alive after stop(): {left}")
    iters, layers = cfg["iters"], TF_LAYERS
    lanes = cfg["num_envs"] * cfg["rollout_len"]
    rollouts = ctr["num_steps_sampled"] // lanes
    sgd_steps = iters * cfg["num_sgd_iter"] * (cfg["train_batch_size"] // cfg["sgd_minibatch_size"])
    dispatches = [r["stats"]["num_dispatches"] for r in stats["replicas"]]
    _require(ctr["num_steps_trained"] == iters * cfg["train_batch_size"],
             f"transformer server: counters {ctr} after {iters} iterations")
    _require(stats["num_requests"] == rollouts * cfg["rollout_len"]
             and ctr[f"inference/{nid}/num_requests"] == stats["num_requests"]
             and len(dispatches) == cfg["replicas"] and stats["num_failures"] == 0,
             f"transformer server: router stats {stats} for {rollouts} rollouts")
    expect = {c.name: 0 for c in counters}
    expect.update(gae=rollouts, ppo_surrogate_fwd=sgd_steps, ppo_surrogate_bwd=sgd_steps,
                  flash_attention_fwd=layers * (sum(dispatches) + rollouts + sgd_steps),
                  flash_attention_bwd=layers * sgd_steps)
    _keyed_launches("transformer server", launches, expect)
    _require(launches == expect, f"transformer server: launches {launches}, expected {expect}")
    first, after = rows[0]["seconds"], [r["seconds"] for r in rows[1:]]
    mean = sum(after) / len(after)
    profile = {"wall_ms": dt * 1e3, "device_busy_ms": busy_ms,
               "idle_share": 1.0 - busy_ms / (dt * 1e3), "port_kernels_ms": ours}
    print(f"transformer server main path: {iters} train() iterations (first {first:.4f} s, mean of "
          f"the next {len(after)} {mean:.4f} s, init {init_s:.2f} s; the last profiled: wall "
          f"{dt * 1e3:.1f} ms, device busy {busy_ms:.3f} ms, idle share {profile['idle_share']:.4f}); "
          f"{rollouts} rollouts, {sgd_steps} SGD steps, {stats['num_requests']} requests in "
          f"{sum(dispatches)} dispatches (per replica {dispatches}); launches {launches} (expected "
          f"from the counters); port kernels {ours}; no flow thread alive after stop()")
    return {"iterations": rows, "init_s": init_s, "first_s": first, "mean_s": mean,
            "launches": launches, "counters": ctr, "profile": profile, "rollouts": rollouts,
            "sgd_steps": sgd_steps, "dispatches": dispatches, "requests": stats["num_requests"]}


# ------------------------------------------------------------ phase 3b
# The threefry kernel: counter hashing at these [lanes, counters] (both
# modes), fold_in over THREEFRY_FOLD_IN_LANES lanes.  THREEFRY_OPS is the
# int32 instructions of one hash as sm_90 issues them (csrc/threefry.cu's
# header): 20 rounds of an add, a funnel-shift rotate and an xor (60), the six
# injections into the second word (one add each, key and constant together),
# the last injection into the first word (the other five fold into the next
# round's add as one IADD3) and the parity word (one LOP3): 68.  Of them
# THREEFRY_ALU_OPS, the 20 rotations (SHF) and 21 LOP3, run on the ALU pipe
# alone; the 27 adds may issue on the FMA pipe as IMAD.IADD beside it (ptxas
# puts 18 there), and an SM issues 128 instructions a clock, twice the ALU
# pipe's 64.  So the least time of a hash at INT32_OPS_PER_S is the larger of
# 41 and 68 / 2 instructions: 41 (``_threefry_ops``).  The phase tallies the
# fold_in kernel's SASS beside it (``_threefry_sass``).  PR 23's keyed
# sampling at [8, 151936] took PR23_KEYED_SAMPLING_MS a decode step as the op
# chain (chip run 3 of PR 23, H100 80GB HBM3, 700 W).
THREEFRY_COUNTS = [(8, 2), (1, 2), (256, 2), (4096, 2), (8, 151936), (1, 2**20)]
THREEFRY_FOLD_IN_LANES = 256
THREEFRY_OPS = 68
THREEFRY_ALU_OPS = 41
PR23_KEYED_SAMPLING_MS = 3.1203


def _threefry_ops(hashes: int, xor: bool) -> float:
    """The int32 operations the bound charges ``hashes`` hashes at
    ``INT32_OPS_PER_S``: the ALU pipe's shifts and logic, or half of all the
    instructions (the issue rate), whichever is more; ``xor`` adds the LOP3
    that folds the two words into bits."""
    return hashes * max(THREEFRY_ALU_OPS + int(xor), (THREEFRY_OPS + int(xor)) / 2)


def _threefry_case(lanes: int, n: int, xor: bool, seed: int) -> dict:
    """The counter-hashing kernel against the plain int64 chain on the card
    and on the CPU: bitwise, and bitwise across two calls; device time,
    the plain chain's, and the bound (``_threefry_ops`` against 16 B a
    counter written for keys, 8 B for bits)."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import threefry as tf

    keys_c = prng.split(prng.key(seed), lanes)  # the plain version, on the CPU
    keys_g = keys_c.cuda()
    got = tf.hash_counts_cuda(keys_g, n, xor)
    again = tf.hash_counts_cuda(keys_g, n, xor)
    plain = tf.hash_counts_plain(keys_g, n, xor)
    cpu = tf.hash_counts_plain(keys_c, n, xor)
    torch.cuda.synchronize()
    shape = [lanes, n] if xor else [lanes, n, 2]
    _require(torch.equal(got, plain), f"threefry {shape}: kernel differs from the plain chain")
    _require(torch.equal(got, again), f"threefry {shape}: two calls differ")
    _require(torch.equal(got.cpu(), cpu), f"threefry {shape}: the card differs from the CPU")
    del got, again, plain, cpu
    bound_ops, nbytes = _formula("threefry_counts", {"lanes": lanes, "n": n, "xor": xor})
    ops = lanes * n * (THREEFRY_OPS + int(xor))
    bound, by = _bound_ms(nbytes, bound_ops, INT32_OPS_PER_S)
    big = lanes * n >= 2**20
    return {
        "shape": shape, "mode": "bits" if xor else "keys", "max_abs_err": 0.0, "bitwise": True,
        "bitwise_repeatable": True, "bound_ms": bound, "bound_by": by, "bytes": nbytes,
        "int32_ops": ops, "library_ms": None,
        **_timings(lambda: tf.hash_counts_cuda(keys_g, n, xor),
                   lambda: tf.hash_counts_plain(keys_g, n, xor), plain_iters=2 if big else 5),
    }


def _threefry_fold_in_case(lanes: int, seed: int) -> dict:
    import torch

    from repro_torch import prng
    from repro_torch.kernels import threefry as tf

    keys_c = prng.split(prng.key(seed), lanes)
    data_c = torch.arange(lanes) * 7919
    keys_g, data_g = keys_c.cuda(), data_c.cuda()
    got = tf.fold_in_cuda(keys_g, data_g)
    _require(torch.equal(got, tf.fold_in_cuda(keys_g, data_g)), "threefry fold_in: two calls differ")
    _require(torch.equal(got, tf.fold_in_plain(keys_g, data_g)),
             "threefry fold_in: kernel differs from the plain chain")
    _require(torch.equal(got.cpu(), tf.fold_in_plain(keys_c, data_c)),
             "threefry fold_in: the card differs from the CPU")
    # One key against many words and many keys against one word (stride 0).
    one = tf.fold_in_cuda(keys_g[0], data_g)
    _require(torch.equal(one.cpu(), tf.fold_in_plain(keys_c[0], data_c)),
             "threefry fold_in: one key over many words differs from the CPU")
    word = tf.fold_in_cuda(keys_g, 5)
    _require(torch.equal(word.cpu(), tf.fold_in_plain(keys_c, 5)),
             "threefry fold_in: many keys over one word differs from the CPU")
    bound_ops, nbytes = _formula("threefry_fold_in", {"lanes": lanes})
    bound, by = _bound_ms(nbytes, bound_ops, INT32_OPS_PER_S)
    return {
        "shape": [lanes], "mode": "fold_in", "max_abs_err": 0.0, "bitwise": True,
        "bitwise_repeatable": True, "bound_ms": bound, "bound_by": by, "bytes": nbytes,
        "int32_ops": lanes * THREEFRY_OPS, "library_ms": None,
        **_timings(lambda: tf.fold_in_cuda(keys_g, data_g),
                   lambda: tf.fold_in_plain(keys_g, data_g), plain_iters=5),
    }


def _threefry_sass() -> dict:
    """The opcodes of ``threefry_fold_in_kernel`` in the built library's SASS
    (``cuobjdump -sass``): one hash and its loads, stores and index
    arithmetic.  The kernel's integer instructions must number at least
    ``THREEFRY_OPS``, and its shifts and logic (``SHF``, ``PRMT`` for a
    rotation by 16 or 24, ``LOP3``) at least ``THREEFRY_ALU_OPS``: a bound
    that counted more than the card issues would flatter the kernel."""
    from repro_torch.kernels.build import build_info

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"read": False}
    sass = subprocess.run([tool, "-sass", build_info()["path"]], capture_output=True, text=True,
                          timeout=300)
    _require(sass.returncode == 0, f"cuobjdump -sass failed: {sass.stderr.strip()[:500]}")
    opcodes, inside = {}, False
    for ln in sass.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            inside = "threefry_fold_in_kernel" in m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", ln)
        if inside and m:
            opcodes[m.group(1)] = opcodes.get(m.group(1), 0) + 1
    alu = sum(n for op, n in opcodes.items()
              if op in ("IADD3", "VIADD", "IADD", "LOP3", "SHF", "PRMT", "LEA", "IMAD"))
    out = {"read": True, "instructions": sum(n for op, n in opcodes.items() if op != "NOP"),
           "shf": opcodes.get("SHF", 0), "prmt": opcodes.get("PRMT", 0),
           "iadd3": opcodes.get("IADD3", 0) + opcodes.get("VIADD", 0),
           "lop3": opcodes.get("LOP3", 0), "integer": alu, "opcodes": opcodes}
    _require(out["instructions"] > 0, "threefry: no SASS found for threefry_fold_in_kernel")
    _require(alu >= THREEFRY_OPS, f"threefry: the fold_in kernel issues {alu} integer "
                                  f"instructions, fewer than the bound's {THREEFRY_OPS} a hash")
    shift_logic = out["shf"] + out["prmt"] + out["lop3"]
    _require(shift_logic >= THREEFRY_ALU_OPS,
             f"threefry: the fold_in kernel issues {shift_logic} shifts and logic "
             f"instructions, fewer than the bound's {THREEFRY_ALU_OPS} a hash")
    return out


def phase_threefry(counter) -> dict:
    """The threefry kernel (``csrc/threefry.cu``) bitwise against its plain
    int64 chain on the card and on the CPU at ``THREEFRY_COUNTS`` in both
    modes and at strided keys, ``fold_in`` at ``THREEFRY_FOLD_IN_LANES``
    lanes; one launch a hash through every ``repro_torch.prng`` draw
    (``randint`` two: a split, then bits); keyed token sampling at PPO-LM's
    [8, 151936] beside ``torch.multinomial`` and PR 23's op chain."""
    import torch

    from repro_torch import prng
    from repro_torch.configs.qwen15_4b import CONFIG as QWEN
    from repro_torch.kernels import threefry as tf

    cases = [_threefry_case(lanes, n, xor, 100 + i)
             for i, (lanes, n) in enumerate(THREEFRY_COUNTS) for xor in (True, False)]
    # The first case is PPO CartPole's reset draw ([8, 4] bits), the shape
    # the kernels line reports first.
    cases.insert(0, _threefry_case(8, 4, True, 99))
    cases.append(_threefry_fold_in_case(THREEFRY_FOLD_IN_LANES, 120))
    # A split's halves are views with a row stride of 4 words: the kernel
    # reads them in place.
    both = prng.split(prng.split(prng.key(7, "cuda"), 64), 2)
    for half in (both[:, 0], both[:, 1]):
        _require(not half.is_contiguous(), "threefry: the strided case is contiguous")
        _require(torch.equal(tf.hash_counts_cuda(half, 3, False).cpu(),
                             tf.hash_counts_plain(half.cpu(), 3, False)),
                 "threefry: strided keys differ from the CPU")
    keys = prng.split(prng.key(8, "cuda"), 16)
    logits = torch.randn((16, 5), device="cuda")
    draws = {
        "split": (lambda: prng.split(keys, 3), 1),
        "fold_in": (lambda: prng.fold_in(keys[0], torch.arange(16, device="cuda")), 1),
        "random_bits": (lambda: prng.random_bits(keys, (2, 3)), 1),
        "uniform": (lambda: prng.uniform(keys, (4,), -0.05, 0.05), 1),
        "gumbel": (lambda: prng.gumbel(keys, (5,)), 1),
        "normal": (lambda: prng.normal(keys, (2,)), 1),
        "categorical": (lambda: prng.categorical(keys, logits), 1),
        "categorical_key": (lambda: prng.categorical_key(keys[0], logits), 1),
        "randint": (lambda: prng.randint(keys, (), 0, 7), 2),
    }
    launches = {}
    for name, (draw, want) in draws.items():
        counter.reset()
        draw()
        launches[name] = counter.value
        _require(counter.value == want, f"threefry: prng.{name} launched {counter.value} "
                                        f"kernels, expected {want}")
    counter.reset()
    vocab = QWEN.vocab_size
    keys8 = prng.split(prng.key(24, "cuda"), 8)
    lm_logits = torch.randn((8, vocab), device="cuda")
    sampler = torch.Generator(device="cuda").manual_seed(0)
    sampling = {
        "keyed_categorical": _time_ms(lambda: prng.categorical(keys8, lm_logits), iters=50),
        "generator_multinomial": _time_ms(
            lambda: torch.multinomial(torch.softmax(lm_logits, -1), 1, generator=sampler),
            iters=50),
        "pr23_op_chain": PR23_KEYED_SAMPLING_MS,
    }
    for c in cases:
        print(f"threefry {c['mode']} {c['shape']}: bitwise (card, CPU, two calls) "
              f"device_ms={c['device_ms']} call_ms={c['call_ms']:.5f} "
              f"plain_device_ms={c['plain_device_ms']} plain_call_ms={c['plain_call_ms']:.5f} "
              f"bound_ms={c['bound_ms']:.6f} ({c['bound_by']}) records_lost={c['records_lost']}"
              + (f" ms_from={c['ms_from']}" if c["ms_from"] != "profiler" else ""))
    print(f"threefry: one launch a hash ({launches}); strided keys read in place; keyed sampling "
          f"at [8, {vocab}] {sampling['keyed_categorical']:.4f} ms a decode step against "
          f"{sampling['generator_multinomial']:.4f} ms for torch.multinomial (CUDA events; the "
          f"op chain of PR 23: {PR23_KEYED_SAMPLING_MS} ms)")
    sass = _threefry_sass()
    if sass["read"]:
        print(f"threefry SASS (threefry_fold_in_kernel): {sass['instructions']} instructions, "
              f"{sass['integer']} integer ({sass['shf']} SHF, {sass['prmt']} PRMT, "
              f"{sass['iadd3']} IADD3/VIADD, "
              f"{sass['lop3']} LOP3) against the bound's {THREEFRY_OPS} a hash, "
              f"{THREEFRY_ALU_OPS} of them shifts and logic; {sass['opcodes']}")
    return {"cases": cases, "launches_per_draw": launches, "lm_sampling_ms": sampling,
            "sass": sass}


# ------------------------------------------------------------- phase 33
# The determinism phase: tests/test_rollout_determinism.py's workers.
DETERMINISM = dict(num_workers=2, num_envs=4, rollout_len=8, rounds=2, seed=21, max_steps=6)
# Columns the card holds bitwise to the CPU: all but the float columns that
# pass through tanh (StubEnv's reward: CUDA's tanhf against the CPU's) and the
# GAE kernel (held to TOL of the plain loop, its scan order differs).
CARD_CPU_FLOAT_COLUMNS = ("rewards", "advantages", "returns")


def _determinism_stream(kind: str, device: str, counter=None, backend="thread") -> tuple:
    """Phase 33's stream: ``kind`` ("vectorized" or "per_env") workers on
    ``device``, their remote actors on ``backend``; the threefry launches
    ``counter`` read over the rounds, where it is given."""
    from repro_torch.core.operators import ParallelRollouts
    from repro_torch.core.workers import WorkerSet

    c = DETERMINISM
    ws = WorkerSet.create(_RuntimeWorkers(kind, device), c["num_workers"], backend=backend)
    try:
        on = {a.backend_name for a in ws.remote_workers()}
        _require(on == {getattr(backend, "name", backend)}, f"determinism: workers on {on}")
        it = iter(ParallelRollouts(ws, mode="bulk_sync"))
        if counter is not None:
            counter.reset()
        stream = [next(it) for _ in range(c["rounds"])]
        launched = counter.value if counter is not None else None
    finally:
        ws.stop()
    return stream, launched


def phase_determinism(counter) -> dict:
    """StubEnv + DummyPolicy on the card (2 workers x 4 lanes x 8 steps, 2
    rounds through ``ParallelRollouts``): the vectorized stream bitwise equal
    to ``PerEnvRolloutWorker``'s, and to the vectorized stream run on the CPU
    (bitwise on every column but rewards, advantages and returns, within
    ``TOL``); the vectorized engine launches six hashes a step (the lane
    split, ``randint``'s two, the env's two splits and StubEnv's reset
    draw)."""
    import numpy as np

    c = DETERMINISM
    vec, launched = _determinism_stream("vectorized", "cuda", counter)
    _PHASE33_STREAM[:] = vec
    per, _ = _determinism_stream("per_env", "cuda")
    cpu, _ = _determinism_stream("vectorized", "cpu")
    expect = c["num_workers"] * c["rounds"] * c["rollout_len"] * 6
    _require(launched == expect, f"determinism: {launched} threefry launches, expected {expect}")
    float_err = 0.0
    for r, (a, b, h) in enumerate(zip(vec, per, cpu)):
        _require(set(a.keys()) == set(b.keys()) == set(h.keys()), f"determinism: columns {a.keys()}")
        for k in a:
            _require(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]),
                     f"determinism round {r}: {k} differs between vectorized and per-env")
            if k in CARD_CPU_FLOAT_COLUMNS:
                err = float(np.max(np.abs(a[k] - h[k])))
                float_err = max(float_err, err)
                _require(err <= TOL, f"determinism round {r}: {k} card vs CPU {err:.3e}")
            else:
                _require(np.array_equal(a[k], h[k]), f"determinism round {r}: {k} card vs CPU")
    rows = sum(b.count for b in vec)
    print(f"determinism: {c['rounds']} rounds of {c['num_workers']} workers x {c['num_envs']} "
          f"lanes x {c['rollout_len']} steps ({rows} rows): vectorized == per-env bitwise on the "
          f"card, == the CPU's bitwise but {', '.join(CARD_CPU_FLOAT_COLUMNS)} (max abs err "
          f"{float_err:.3e}); threefry launches {launched} (= 6 a step)")
    return {"rows": rows, "threefry_launches": launched, "card_cpu_float_max_abs_err": float_err}


# ------------------------------------------------------------- phase 34
# Durability on the card: PPO CartPole with vectorized workers, and DQN with
# 2 replay actors.  Algorithm.save keeps weights and flow state, as the
# reference's: neither optimizer moments (so PPO trains with SGD, whose
# state is a step count) nor operator state such as TrainOneStep's minibatch
# shuffle (so PPO takes one step on the whole batch, which is not shuffled).
DURABILITY_PPO = dict(num_workers=2, num_envs=8, rollout_len=32, train_batch_size=512,
                      num_sgd_iter=1, sgd_minibatch_size=0, iters=2, lr=0.01)
DURABILITY_DQN = dict(num_workers=1, num_envs=2, rollout_len=8, replay_actors=2, iters=4,
                      target_update_freq=128)
DURABILITY_LOSS_TOL = 1e-6


def phase_durability() -> dict:
    """``Algorithm.save``/``restore`` on the card.  PPO: 2 iterations,
    ``save``, 2 more; a fresh Algorithm on fresh workers ``restore``s and
    runs 2: equal counters, losses within 1e-6, then each remote worker's
    next sample bitwise equal and the local weights equal.  DQN with 2
    replay actors: 4 iterations, ``save``; a fresh Algorithm restored has
    the same counters and replay stats and trains on from them."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.actor import ActorPool
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm
    from repro_torch.optim import sgd
    from repro_torch.rl import (
        ActorCriticPolicy,
        CartPole,
        DQNPolicy,
        ReplayBuffer,
        RolloutWorker,
        VectorizedRolloutWorker,
    )
    from repro_torch.tree import tree_leaves

    p, d = DURABILITY_PPO, DURABILITY_DQN
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))

    def ppo_algo():
        def factory(i):
            return VectorizedRolloutWorker(
                CartPole(), ActorCriticPolicy(4, 2, loss_kind="ppo"), algo="ppo",
                num_envs=p["num_envs"], rollout_len=p["rollout_len"], optimizer=sgd(p["lr"]),
                seed=3, worker_index=i, device="cuda")

        ws = WorkerSet.create(factory, p["num_workers"])
        return Algorithm.from_plan("ppo", ws, train_batch_size=p["train_batch_size"],
                                   num_sgd_iter=p["num_sgd_iter"],
                                   sgd_minibatch_size=p["sgd_minibatch_size"]), ws

    def dqn_algo():
        def factory(i):
            return RolloutWorker(CartPole(), DQNPolicy(4, 2), algo="dqn", num_envs=d["num_envs"],
                                 rollout_len=d["rollout_len"], seed=11, worker_index=i,
                                 epsilon=0.3, device="cuda")

        ws = WorkerSet.create(factory, d["num_workers"])
        rp = ActorPool.from_targets([
            ReplayBuffer(capacity=2048, sample_batch_size=32, learning_starts=64, seed=5)
            for _ in range(d["replay_actors"])])
        return Algorithm.from_plan("dqn", ws, rp, target_update_freq=d["target_update_freq"]), rp

    try:
        algo, ws = ppo_algo()
        for _ in range(p["iters"]):
            algo.train()
        path = str(tmp / "ppo.npz")
        algo.save(path)
        after = [algo.train() for _ in range(p["iters"])]
        samples = [a.sync("sample") for a in ws.remote_workers()]
        weights = tree_leaves(ws.local_worker().get_weights())
        algo.stop()
        algo2, ws2 = ppo_algo()
        algo2.restore(path)
        again = [algo2.train() for _ in range(p["iters"])]
        samples2 = [a.sync("sample") for a in ws2.remote_workers()]
        weights2 = tree_leaves(ws2.local_worker().get_weights())
        algo2.stop()
        loss_err = 0.0
        for a, b in zip(after, again):
            _require(a["counters"] == b["counters"],
                     f"durability ppo: counters {b['counters']} != {a['counters']}")
            loss_err = max(loss_err, abs(a["info"]["loss"] - b["info"]["loss"]))
        _require(loss_err <= DURABILITY_LOSS_TOL, f"durability ppo: losses differ by {loss_err:.3e}")
        for s, t in zip(samples, samples2):
            _require(set(s.keys()) == set(t.keys()) and all(np.array_equal(s[k], t[k]) for k in s),
                     "durability ppo: the restored workers' next samples differ")
        w_err = max(_max_err(a, b) for a, b in zip(weights, weights2))
        _require(w_err <= DURABILITY_LOSS_TOL, f"durability ppo: weights differ by {w_err:.3e}")

        algo, rp = dqn_algo()
        for _ in range(d["iters"]):
            result = algo.train()
        path = str(tmp / "dqn.npz")
        algo.save(path)
        counters, stats = dict(result["counters"]), [a.sync("stats") for a in rp]
        algo.stop()
        algo2, rp2 = dqn_algo()
        algo2.restore(path)
        restored = dict(algo2._it.metrics.counters)
        stats2 = [a.sync("stats") for a in rp2]
        _require(all(restored.get(k) == v for k, v in counters.items()),
                 f"durability dqn: counters {restored} != {counters}")
        _require(stats2 == stats, f"durability dqn: replay stats {stats2} != {stats}")
        res = algo2.train()
        _require(res["counters"]["num_steps_sampled"] > counters["num_steps_sampled"],
                 f"durability dqn: no training after restore: {res['counters']}")
        algo2.stop()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    print(f"durability: PPO with vectorized workers restored after {p['iters']} iterations: "
          f"{p['iters']} more with equal counters, losses within {loss_err:.3e}, each remote "
          f"worker's next sample bitwise equal, weights within {w_err:.3e}; DQN with "
          f"{d['replay_actors']} replay actors restored with equal counters and replay stats "
          f"{stats}, and trains on")
    return {"ppo_loss_max_abs_err": loss_err, "ppo_weights_max_abs_err": w_err,
            "dqn_counters": counters, "dqn_replay_stats": stats}


# ------------------------------------------------------------- phase 36
QWEN3_RESTART = dict(arch="qwen3-14b", layers=2, seq=4096, batch=2, data_shards=2, steps=4)
QWEN3_RESTART_RTOL = 1e-5  # tests/test_durability.py's tolerance
QWEN3_RESTART_DEADLINE_S = 600  # the driver's run, two learners and 35 GB of files


def phase_qwen3_restart() -> dict:
    """Qwen3-14B at its published widths cut to 2 layers, 2 x 4,096 tokens
    a step, at the driver's dtype, its configuration's own: bfloat16 (the
    float32 checkpoint is phase 34's).  First the driver a user runs,
    ``python -m repro_torch.launch.train --arch qwen3-14b --layers 2 ...
    --checkpoint`` (its ``main``, 2 steps), whose file ``restore_pytree``
    must read.  Then the restart check of ``tests/test_durability.py``: a
    learner takes 2 steps, ``save_pytree`` writes its parameters and
    optimizer state (bf16 leaves widened to float32 in the file, exactly),
    it takes 2 more; a fresh learner restored from the file (copied into its
    own tensors) must hold every saved leaf bit for bit, its parameters
    bf16, and takes the same 2 steps with the same losses within 1e-5."""
    import tempfile

    import torch

    from repro_torch.checkpoint import restore_pytree, save_pytree
    from repro_torch.configs.base import InputShape
    from repro_torch.core.spmd import SPMDLearnerWorker, SPMDTrainContext
    from repro_torch.data import make_batch
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves

    q = QWEN3_RESTART
    cfg = train.train_config(q["arch"], layers=q["layers"])
    _require(cfg.dtype == "bfloat16", f"qwen3 restart: the driver's configuration is {cfg.dtype}")
    shape = InputShape("train", q["seq"], q["batch"], "train")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_qwen3_"))
    times = {}

    def learner():
        opt = train.pretrain_optimizer(q["steps"])
        return SPMDLearnerWorker(SPMDTrainContext(cfg, opt, device="cuda"), seed=0)

    def step(lw, s):
        loss = lw.learn_on_batch(make_batch(cfg, shape, seed=0, step=s))["loss"]
        torch.cuda.synchronize()
        return loss

    try:
        with _deadline(QWEN3_RESTART_DEADLINE_S, "qwen3 restart"):
            cli = str(tmp / "cli.npz")
            t0 = time.perf_counter()
            train.main(["--arch", q["arch"], "--layers", str(q["layers"]), "--seq", str(q["seq"]),
                        "--batch", str(q["batch"]), "--data-shards", str(q["data_shards"]),
                        "--steps", "2", "--checkpoint", cli])
            times["cli_s"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()

            ck = str(tmp / "ck.npz")
            a = learner()
            for s in range(2):
                step(a, s)
            t0 = time.perf_counter()
            save_pytree(ck, {"params": a.params, "opt": a.opt_state})
            times["save_s"] = time.perf_counter() - t0
            saved = [x.detach().clone() for x in tree_leaves({"params": a.params, "opt": a.opt_state})
                     if torch.is_tensor(x)]
            ref = [step(a, s) for s in (2, 3)]
            del a
            gc.collect()
            torch.cuda.empty_cache()

            b = learner()
            t0 = time.perf_counter()
            state = restore_pytree(ck, {"params": b.params, "opt": b.opt_state})
            times["restore_s"] = time.perf_counter() - t0
            b.params, b.opt_state = state["params"], state["opt"]
            restored = [x for x in tree_leaves(state) if torch.is_tensor(x)]
            bitwise = len(restored) == len(saved) and all(
                x.dtype == y.dtype and torch.equal(x.detach(), y) for x, y in zip(restored, saved))
            param_dtypes = sorted({str(x.dtype) for x in tree_leaves(b.params)})
            del saved, restored
            out = [step(b, s) for s in (2, 3)]
            ckpt_bytes = os.path.getsize(ck)
            os.remove(ck)
            # The driver's checkpoint holds the same tree.
            restore_pytree(cli, b.params)
            finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(b.params))
            cli_bytes = os.path.getsize(cli)
            del b, state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    _require(finite, "qwen3: the driver's checkpoint holds non-finite parameters")
    _require(param_dtypes == ["torch.bfloat16"], f"qwen3 restart: restored parameters {param_dtypes}")
    _require(bitwise, "qwen3 restart: a restored leaf is not the saved one bit for bit")
    rel = max(abs(x - y) / abs(y) for x, y in zip(out, ref))
    _require(rel <= QWEN3_RESTART_RTOL,
             f"qwen3 restart: losses {out} against {ref} (rel err {rel:.3e})")
    print(f"qwen3 restart ({cfg.dtype}; every restored leaf bitwise the saved one): losses "
          f"{ref} before, {out} after the restart (max rel err {rel:.3e}, "
          f"rtol {QWEN3_RESTART_RTOL}); checkpoint {ckpt_bytes / 2**30:.2f} GiB (save "
          f"{times['save_s']:.1f} s, restore {times['restore_s']:.1f} s); the driver's "
          f"--checkpoint {cli_bytes / 2**30:.2f} GiB read back ({times['cli_s']:.1f} s for its "
          f"2 steps)")
    return {"dtype": cfg.dtype, "restored_bitwise": bitwise, "param_dtypes": param_dtypes,
            "losses": ref, "restored_losses": out, "max_rel_err": rel, "bytes": ckpt_bytes,
            "cli_bytes": cli_bytes, **times}


# ------------------------------------------------------------- phase 38
LG_MICROBATCH = 2  # the learner group's microbatches on the card


class _Warnings(logging.Handler):
    """Collects the messages of one logger while attached."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def _lg_learn(learn, batch, counters: list) -> tuple:
    """One learn step: its stats, and its seconds, peak memory and launches
    (every count set to 0 just before the step, read just after)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    info = learn(batch)
    torch.cuda.synchronize()
    return info, {"seconds": time.perf_counter() - t0,
                  "peak_bytes": torch.cuda.max_memory_allocated(), "start_bytes": start,
                  "launches": {c.name: c.value for c in counters}}


def _lg_ppo_lm(counters: list) -> dict:
    """The PPO-LM learner at Qwen1.5-4B widths (phase 7's worker): one
    ``learn_on_batch`` of one rollout's batch through the worker and one
    through ``ShardedLearnerGroup(microbatch=2)``, from the same weights.
    SGD at lr 1, as phases 6, 8 and 19: the weight difference is then the
    gradient difference.  (Under the worker's Adam the first step moves a
    weight by about lr wherever its gradient is not 0, so a gradient of
    rounding size whose sign the summation order flips moves it 2 x lr
    apart: 5.888e-04 at lr 3e-4 on an H100.)"""
    import torch

    from repro_torch.core.operators import StandardizeFields
    from repro_torch.optim import sgd
    from repro_torch.rl import ShardedLearnerGroup
    from repro_torch.tree import tree_leaves

    k, L = LG_MICROBATCH, RLHF_LAYERS
    # One seed: the same weights.
    plain, grouped = _rlhf_worker(0, optimizer=sgd(1.0)), _rlhf_worker(0, optimizer=sgd(1.0))
    try:
        _require(all(torch.equal(a, b) for a, b in zip(tree_leaves(plain.params),
                                                        tree_leaves(grouped.params))),
                 "learner group: the two workers start from different weights")
        batch = StandardizeFields(["advantages"])(plain.sample())
        info_p, run_p = _lg_learn(plain.learn_on_batch, batch, counters)
        group = ShardedLearnerGroup(grouped, microbatch=k)
        info_g, run_g = _lg_learn(group.learn_on_batch, batch, counters)
        stat_err = max(abs(info_p[s] - info_g[s]) for s in INFO_KEYS)
        w_err = max(float((a - b).abs().max())
                    for a, b in zip(tree_leaves(plain.params), tree_leaves(grouped.params)))
    finally:
        del plain, grouped
        gc.collect()
        torch.cuda.empty_cache()
    step = {"flash_attention_fwd": L, "flash_attention_bwd": L, "ppo_surrogate_fwd": 1,
            "ppo_surrogate_bwd": 1, "threefry": 1}  # the learner key: one hash a step
    want_g = {n: (v if n == "threefry" else k * v) for n, v in step.items()}
    got_p = {n: run_p["launches"][n] for n in step}
    got_g = {n: run_g["launches"][n] for n in step}
    print(f"learner group ppo_lm: {batch.count} rows, plain loss {info_p['loss']:.6f} vs "
          f"microbatch={k} {info_g['loss']:.6f}; max stat err {stat_err:.3e}, max weight err "
          f"{w_err:.3e} (tol {LEARNER_TOL}); peak memory plain {run_p['peak_bytes'] / 2**30:.2f} "
          f"GiB, microbatch {run_g['peak_bytes'] / 2**30:.2f} GiB (from {run_p['start_bytes'] / 2**30:.2f} / "
          f"{run_g['start_bytes'] / 2**30:.2f} GiB at the step's start); seconds "
          f"{run_p['seconds']:.3f} / {run_g['seconds']:.3f}; launches plain {got_p}, "
          f"microbatch {got_g}")
    _require(stat_err <= LEARNER_TOL and w_err <= LEARNER_TOL,
             f"learner group ppo_lm: microbatch={k} differs from the plain step "
             f"(stats {stat_err:.3e}, weights {w_err:.3e})")
    _require(got_p == step, f"learner group ppo_lm: plain step launched {got_p}, expected {step}")
    _require(got_g == want_g, f"learner group ppo_lm: microbatch={k} launched {got_g}, "
                              f"expected {want_g}")
    return {"rows": batch.count, "stat_err": stat_err, "weight_err": w_err, "plain": run_p,
            "microbatch": run_g, "loss_plain": info_p["loss"], "loss_microbatch": info_g["loss"],
            "launches": got_g}  # the group's step alone: the plain one is phase 7's path


def _lg_clamp() -> dict:
    """``num_learners=2`` on one card: clamped to 1 with the warning, trains."""
    import torch

    from repro_torch.rl import ShardedLearnerGroup

    caught = _Warnings()
    log = logging.getLogger("repro_torch.rl.learner_group")
    log.addHandler(caught)
    try:
        w = _make_worker(0, "cuda")
        group = ShardedLearnerGroup(w, num_learners=2)
    finally:
        log.removeHandler(caught)
    info = group.learn_on_batch(w.sample())
    print(f"learner group clamp: num_learners=2 on {torch.cuda.device_count()} card(s) -> "
          f"{group.num_learners}; warning {caught.messages}; loss {info['loss']:.5f}")
    _require(group.num_learners == 1 and info["num_learners"] == 1,
             f"learner group: num_learners=2 kept {group.num_learners} learners on one card")
    _require(any("clamping" in m for m in caught.messages), "learner group: no clamp warning")
    _require(math.isfinite(info["loss"]), f"learner group clamp: loss {info['loss']}")
    return {"num_learners": group.num_learners, "warning": caught.messages}


def _lg_ppo_cartpole(counters: list) -> dict:
    """``build_ppo(..., microbatch=2)`` trains PPO CartPole for 3 iterations:
    every SGD step is 2 surrogate launches each way."""
    import torch

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm, build_ppo

    cfg, k, iters = PPO_CONFIG, LG_MICROBATCH, 3
    workers = WorkerSet.create(lambda i: _make_worker(i, "cuda"), cfg["num_workers"])
    spec = build_ppo(workers, train_batch_size=cfg["train_batch_size"],
                     num_sgd_iter=cfg["num_sgd_iter"],
                     sgd_minibatch_size=cfg["sgd_minibatch_size"], microbatch=k)
    rows = []
    with Algorithm.from_plan(spec, workers) as algo:
        for c in counters:
            c.reset()
        for i in range(iters):
            t0 = time.perf_counter()
            result = algo.train()
            torch.cuda.synchronize()
            info = result["info"]
            rows.append({"seconds": time.perf_counter() - t0, "loss": info["loss"],
                         "reward": result["episodes"]["episode_reward_mean"]})
            _require(info["microbatch"] == k and math.isfinite(info["loss"]),
                     f"learner group ppo: iteration {i} info {info}")
    launches = {c.name: c.value for c in counters}
    sgd = iters * cfg["num_sgd_iter"] * (cfg["train_batch_size"] // cfg["sgd_minibatch_size"])
    print(f"learner group ppo cartpole (microbatch={k}): {iters} iterations "
          f"{[round(r['seconds'], 3) for r in rows]} s, losses "
          f"{[round(r['loss'], 4) for r in rows]}, launches {launches}")
    for name in ("ppo_surrogate_fwd", "ppo_surrogate_bwd"):
        _require(launches[name] == k * sgd,
                 f"learner group ppo: {name} launched {launches[name]}, expected {k} x {sgd}")
    _require(launches["gae"] > 0, "learner group ppo: no GAE launch")
    return {"iterations": rows, "launches": launches}


def _lg_impala(counters: list) -> dict:
    """IMPALA's learner thread steps a ``microbatch=2`` group: each step
    tiles whole length-32 traces, one V-trace launch a microbatch."""
    import torch

    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm

    cfg, k, steps = ASYNC_PATHS["impala"], LG_MICROBATCH, 4
    workers = WorkerSet.create(lambda i: _async_worker(i, "cuda", cfg), cfg["num_workers"])
    algo = Algorithm.from_plan("impala", workers, train_batch_size=cfg["train_batch_size"],
                               num_async=cfg["num_async"], microbatch=k)
    learner = algo.resources["learner"]
    group = learner.learner_group
    try:
        for c in counters:
            c.reset()
        with _deadline(ASYNC_DEADLINE_S, "learner group impala"):
            while learner.num_steps < steps:
                algo.train()
                _require(learner.is_alive(), "learner group impala: the learner thread died")
    finally:
        algo.stop()
    torch.cuda.synchronize()
    launches = {c.name: c.value for c in counters}
    print(f"learner group impala (microbatch={k}): {group.num_steps} group steps, trace_len "
          f"{group.trace_len}, rows trimmed {group.num_rows_trimmed}, launches {launches}")
    _require(group.trace_len == cfg["rollout_len"] and group.microbatch == k,
             f"learner group impala: trace_len {group.trace_len}, microbatch {group.microbatch}")
    _require(launches["vtrace"] == k * group.num_steps,
             f"learner group impala: {launches['vtrace']} V-trace launches for "
             f"{group.num_steps} steps of {k} microbatches")
    _require(not learner.is_alive() and group._ranks is None,
             "learner group impala: the learner thread or its ranks outlived stop()")
    return {"steps": group.num_steps, "trimmed": group.num_rows_trimmed, "launches": launches}


def _lg_dqn_td_error() -> dict:
    """DQN's ``td_error`` comes back at the full batch's length after a
    trim (the neutral padding of the trimmed rows)."""
    import numpy as np

    from repro_torch.rl import ShardedLearnerGroup

    w = _dqn_worker(0, "cuda")
    batch = w.sample()
    ragged = batch.slice(0, batch.count - 3)
    group = ShardedLearnerGroup(w, microbatch=4)
    info = group.learn_on_batch(ragged)
    td = info["td_error"]
    print(f"learner group dqn: {ragged.count} rows, {group.num_rows_trimmed} trimmed, "
          f"td_error {td.shape}")
    _require(td.shape == (ragged.count,) and bool(np.isfinite(td).all()),
             f"learner group dqn: td_error {td.shape} for {ragged.count} rows")
    return {"rows": ragged.count, "trimmed": group.num_rows_trimmed}


def phase_learner_group(counters: list) -> dict:
    out = {"ppo_lm": _lg_ppo_lm(counters), "clamp": _lg_clamp(),
           "ppo_cartpole": _lg_ppo_cartpole(counters), "impala": _lg_impala(counters),
           "dqn": _lg_dqn_td_error()}
    return out


# ------------------------------------------------------------- phase 39
def _check_explain(plan: str, report, want_kernels: set) -> dict:
    """Every stepped row priced, and each kernel charge equal to its bound's
    formula at the sizes it was priced at."""
    rows = {r.node_id: r for r in report.rows}
    stepped = [r for r in report.rows if r.kind == "rollouts" or "TrainOneStep" in r.label]
    _require(len(stepped) == 2, f"explain {plan}: stepped rows {[r.node_id for r in stepped]}")
    seen = set()
    for r in stepped:
        _require(not r.note and r.flops > 0 and r.hbm_bytes > 0
                 and r.dominant in ("compute", "memory", "collective"),
                 f"explain {plan}: row {r.node_id} {r.note!r} flops {r.flops} dominant {r.dominant!r}")
        for name, agg in r.kernels.items():
            seen.add(name)
            ops = sum(n * _formula(name, key)[0] for key, n in agg["sizes"])
            nbytes = sum(n * _formula(name, key)[1] for key, n in agg["sizes"])
            got_ops = agg["int_ops"] if name.startswith("threefry") else agg["flops"]
            _require(abs(got_ops - ops) <= 1e-9 * max(ops, 1) and agg["bytes"] == nbytes,
                     f"explain {plan}: {r.node_id} {name} charged {got_ops} ops / {agg['bytes']} "
                     f"bytes, its bound's formula {ops} / {nbytes}")
        print(f"explain {plan} {r.node_id} ({r.kind}): flops {r.flops:.4e}, bytes "
              f"{r.hbm_bytes:.4e}, dominant {r.dominant}, kernel candidate {r.kernel_candidate}, "
              f"wall mean {r.wall_s_mean:.4f} s over {r.calls} calls; kernels "
              + ", ".join(f"{n} x{a['launches']}" for n, a in r.kernels.items()))
    _require(want_kernels <= seen, f"explain {plan}: kernels {sorted(seen)}, expected "
                                   f"{sorted(want_kernels)}")
    return {node: {"flops": r.flops, "bytes": r.hbm_bytes, "dominant": r.dominant,
                   "kernel_candidate": r.kernel_candidate,
                   "kernels": {n: {k: v for k, v in a.items() if k != "sizes"}
                               for n, a in r.kernels.items()}}
            for node, r in rows.items() if r in stepped}


def _probe_leaves_rollout(lw, algo) -> None:
    """``explain()`` changes nothing: the next rollout after it is bitwise
    the one a snapshot taken before it gives."""
    import numpy as np

    before = lw.get_state()
    algo.explain()
    probed = lw.sample()
    lw.set_state(before)
    again = lw.sample()
    for k in probed.keys():
        _require(np.array_equal(probed[k], again[k]),
                 f"explain: the rollout after the probe differs in {k}")


EXPLAIN_BF16_ARCHS = ("qwen3-14b", "rwkv6-7b", "phi3.5-moe-42b-a6.6b")


def _explain_pretrain_bf16(arch: str) -> dict:
    """``Algorithm.explain()`` on the pretraining flow (``make_pretrain``) at
    ``arch``'s reduced configuration at its own dtype, bfloat16, on the
    card after one step: the ``SPMDTrainStep`` row priced, each bf16 kernel
    of the step charged its bound's formula at 2 bytes an element, its bound
    at ``HW_H100``'s bf16 rate (989 TFLOP/s) printed."""
    import torch

    from repro_torch.distributed.hlo_analysis import HW_H100
    from repro_torch.flow import Algorithm
    from repro_torch.launch.train import make_pretrain, train_config

    cfg = train_config(arch, smoke=True)
    _require(cfg.dtype == "bfloat16" and HW_H100.bf16_flops == BF16_OPS_PER_S,
             f"explain {arch}: {cfg.dtype}, HW_H100 bf16 rate {HW_H100.bf16_flops}")
    learner, _, workers, spec = make_pretrain(cfg, 64, 2, 1, steps=4, device="cuda")
    with Algorithm.from_plan(spec, workers) as algo:
        algo.train()
        t0 = time.perf_counter()
        report = algo.explain()
        explain_s = time.perf_counter() - t0
    rows = [r for r in report.rows if r.label.endswith("SPMDTrainStep")]
    _require(len(rows) == 1 and not rows[0].note and rows[0].flops > 0,
             f"explain {arch}: pretraining rows {[(r.label, r.note) for r in rows]}")
    row, bounds = rows[0], {}
    for name, agg in row.kernels.items():
        ops = sum(n * _formula(name, key)[0] for key, n in agg["sizes"])
        nbytes = sum(n * _formula(name, key)[1] for key, n in agg["sizes"])
        _require(all(key.get("es") == 2 for key, _ in agg["sizes"]),
                 f"explain {arch}: {name} priced at {[key for key, _ in agg['sizes']]}")
        _require(abs(agg["flops"] - ops) <= 1e-9 * max(ops, 1) and agg["bytes"] == nbytes,
                 f"explain {arch}: {name} charged {agg['flops']} / {agg['bytes']}, its bound's "
                 f"formula {ops} / {nbytes}")
        bounds[name] = _bound_ms(nbytes, ops, BF16_OPS_PER_S)[0]
    del learner, workers, spec, algo
    gc.collect()
    torch.cuda.empty_cache()
    print(f"explain pretrain {arch} ({cfg.dtype}): flops {row.flops:.4e}, bytes "
          f"{row.hbm_bytes:.4e}, dominant {row.dominant}; kernels "
          + ", ".join(f"{n} x{a['launches']} (bound {bounds[n]:.6f} ms at 989 TFLOP/s)"
                      for n, a in row.kernels.items()) + f"; {explain_s:.2f} s")
    return {"flops": row.flops, "bytes": row.hbm_bytes, "dominant": row.dominant,
            "kernels": {n: {k: v for k, v in a.items() if k != "sizes"} for n, a in row.kernels.items()},
            "bound_ms_bf16": bounds, "explain_s": explain_s}


def phase_explain() -> dict:
    """``Algorithm.explain()`` on PPO CartPole and on PPO-LM (Qwen1.5-4B
    widths) on the card, priced at ``HW_H100``; then on the pretraining flow
    at bfloat16 (``_explain_pretrain_bf16``)."""
    import torch

    from repro_torch.core.workers import WorkerSet
    from repro_torch.distributed.hlo_analysis import HW_H100
    from repro_torch.flow import Algorithm

    out = {}
    cfg = PPO_CONFIG
    workers = WorkerSet.create(lambda i: _make_worker(i, "cuda"), cfg["num_workers"])
    with Algorithm.from_plan(
        "ppo", workers, train_batch_size=cfg["train_batch_size"],
        num_sgd_iter=cfg["num_sgd_iter"], sgd_minibatch_size=cfg["sgd_minibatch_size"],
    ) as algo:
        for _ in range(2):
            algo.train()
        t0 = time.perf_counter()
        report = algo.explain()
        explain_s = time.perf_counter() - t0
        _require(report.hw is HW_H100, f"explain: priced at {report.hw}")
        out["ppo"] = _check_explain("ppo", report, {"gae", "ppo_surrogate", "ppo_surrogate_bwd",
                                                    "threefry_counts"})
        out["ppo"]["explain_s"] = explain_s
        _probe_leaves_rollout(workers.local_worker(), algo)
    lm = RLHF_CONFIG
    workers = WorkerSet.create(_rlhf_worker, 1)
    try:
        with Algorithm.from_plan("ppo_lm", workers, train_batch_size=lm["num_envs"] * lm["rollout_len"],
                                 num_sgd_iter=1, sgd_minibatch_size=lm["sgd_minibatch_size"]) as algo:
            algo.train()
            t0 = time.perf_counter()
            report = algo.explain()
            explain_s = time.perf_counter() - t0
            out["ppo_lm"] = _check_explain(
                "ppo_lm", report, {"gae", "ppo_surrogate", "ppo_surrogate_bwd", "decode_attention",
                                   "flash_attention", "flash_attention_bwd", "threefry_counts"})
            out["ppo_lm"]["explain_s"] = explain_s
            _probe_leaves_rollout(workers.local_worker(), algo)
    finally:
        workers.stop()
        gc.collect()
        torch.cuda.empty_cache()
    print(f"explain: priced at {HW_H100.name} (ridge {HW_H100.ridge:.1f} FLOP/byte); seconds "
          f"ppo {out['ppo']['explain_s']:.2f}, ppo_lm {out['ppo_lm']['explain_s']:.2f}; the next "
          f"rollout after each probe bitwise equal to a restored snapshot's")
    out["pretrain_bf16"] = {arch: _explain_pretrain_bf16(arch) for arch in EXPLAIN_BF16_ARCHS}
    return out


# ------------------------------------------------------------- phase 37
# The runtime across processes and hosts, on the card: phase 33's stream and
# phase 5's PPO CartPole through the thread backend, process children (the
# pickle and shared-memory transports; started from the fork server) and a
# driver-managed host (socket frames), then chaos.  Every worker of a child
# is on the card; a child's launch counters are its own, read by RPC.
RUNTIME_HOST = "rollout-box"
RUNTIME_DEADLINE_S = 300
RUNTIME_WEIGHT_TOL = 1e-5  # the learner's weights after ITERS, against the thread run
RUNTIME_CHAOS_S = 120  # per chaos case: a stream that does not recover fails the phase
_PHASE33_STREAM: list = []  # phase 33's vectorized thread stream, for phase 37a


def _all_counters() -> list:
    from repro_torch.kernels.advantages import GAE_LAUNCHES, VTRACE_LAUNCHES
    from repro_torch.kernels.decode_attention import (
        DECODE_ATTENTION_BF16_LAUNCHES,
        DECODE_ATTENTION_LAUNCHES,
    )
    from repro_torch.kernels.flash_attention import (
        FLASH_BWD_BF16_LAUNCHES,
        FLASH_BWD_LAUNCHES,
        FLASH_FWD_BF16_LAUNCHES,
        FLASH_FWD_LAUNCHES,
    )
    from repro_torch.kernels.moe_gmm import (
        MOE_GMM_BF16_LAUNCHES,
        MOE_GMM_DW_LAUNCHES,
        MOE_GMM_DX_LAUNCHES,
        MOE_GMM_LAUNCHES,
        MOE_GMM_SMALL_BF16_LAUNCHES,
        MOE_GMM_SMALL_LAUNCHES,
    )
    from repro_torch.kernels.rwkv6 import (
        RWKV6_BWD_BF16_LAUNCHES,
        RWKV6_BWD_LAUNCHES,
        RWKV6_FWD_BF16_LAUNCHES,
        RWKV6_FWD_LAUNCHES,
    )
    from repro_torch.kernels.surrogate import SURROGATE_BWD_LAUNCHES, SURROGATE_FWD_LAUNCHES
    from repro_torch.kernels.threefry import THREEFRY_LAUNCHES

    return [GAE_LAUNCHES, VTRACE_LAUNCHES, SURROGATE_FWD_LAUNCHES, SURROGATE_BWD_LAUNCHES,
            DECODE_ATTENTION_LAUNCHES, FLASH_FWD_LAUNCHES, FLASH_BWD_LAUNCHES,
            RWKV6_FWD_LAUNCHES, RWKV6_BWD_LAUNCHES, MOE_GMM_LAUNCHES, MOE_GMM_SMALL_LAUNCHES,
            MOE_GMM_DX_LAUNCHES, MOE_GMM_DW_LAUNCHES, THREEFRY_LAUNCHES,
            FLASH_FWD_BF16_LAUNCHES, DECODE_ATTENTION_BF16_LAUNCHES, MOE_GMM_BF16_LAUNCHES,
            MOE_GMM_SMALL_BF16_LAUNCHES, FLASH_BWD_BF16_LAUNCHES, RWKV6_FWD_BF16_LAUNCHES,
            RWKV6_BWD_BF16_LAUNCHES]


class _ChildProbe:
    """A remote worker as its process or host holds it: every attribute is
    the worker's, and the script reads by RPC what only the child knows (its
    pid, its launch counters, its first samples, where the tensors it was
    sent landed).  Defined here, so that no method goes on the port's
    workers."""

    def __init__(self, worker, keep: int):
        self._worker = worker
        self._keep = keep
        self._kept: list = []
        self._profile = None

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.__dict__["_worker"], name)

    def sample(self):
        import numpy as np

        batch = self._worker.sample()
        if len(self._kept) < self._keep:
            self._kept.append({k: np.array(batch[k], copy=True) for k in batch.keys()})
        return batch

    def kept(self) -> list:
        return self._kept

    def pid(self) -> int:
        return os.getpid()

    def cuda_context(self) -> tuple:
        import torch

        initialised = torch.cuda.is_initialized()
        return initialised, torch.cuda.current_device() if initialised else None

    def launches(self) -> dict:
        return {c.name: c.value for c in _all_counters()}

    def reset_launches(self) -> None:
        for c in _all_counters():
            c.reset()

    def profile_start(self) -> None:
        self._profile = _DeviceProfile()
        self._profile.start()

    def profile_stop(self) -> float:
        """Device microseconds of this process's kernels since
        ``profile_start`` (the primer left out)."""
        busy, self._profile = self._profile.stop(), None
        return sum(busy.values())

    def echo(self, obj):
        return obj

    def devices(self, obj: dict) -> dict:
        return {k: str(v.device) for k, v in obj.items()}


class _RuntimeWorkers:
    """Phases 33 and 37's picklable worker factory: ``"ppo"`` is phase 5's
    worker, ``"vectorized"`` and ``"per_env"`` phase 33's StubEnv +
    DummyPolicy engines; remote indices come wrapped in a ``_ChildProbe``.
    A child re-imports this script as ``__mp_main__`` and never runs
    ``main()``, so the factory sets the float32 matmul flags that ``main()``
    sets in the driver."""

    def __init__(self, kind: str, device: str, keep: int = 1):
        self.kind = kind
        self.device = device
        self.keep = keep

    def __call__(self, index: int):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.kind == "ppo":
            worker = _make_worker(index, self.device)
        else:
            from repro_torch.rl import (
                DummyPolicy,
                PerEnvRolloutWorker,
                StubEnv,
                VectorizedRolloutWorker,
            )

            cls = VectorizedRolloutWorker if self.kind == "vectorized" else PerEnvRolloutWorker
            c = DETERMINISM
            worker = cls(StubEnv(max_steps=c["max_steps"]), DummyPolicy(4, 2), algo="pg",
                         num_envs=c["num_envs"], rollout_len=c["rollout_len"], seed=c["seed"],
                         worker_index=index, device=self.device)
        return worker if index == 0 else _ChildProbe(worker, self.keep)


def _runtime_backend(name: str):
    """(backend, host handle) for a row of RUNTIME_BACKENDS; the handle is
    the driver-managed host of ``remote-socket``."""
    from repro_torch.core import ProcessBackend, RemoteBackend, start_local_host

    if name == "thread":
        return "thread", None
    if name.startswith("process-"):
        return ProcessBackend(transport=name.split("-", 1)[1]), None
    handle = start_local_host()
    return RemoteBackend(address=handle.address), handle


def _child_launches(remotes, backend_name: str) -> dict:
    """The launches of the rollout children, summed once per process (a
    host's workers share one); empty on the thread backend, whose workers
    count in the driver."""
    if backend_name == "thread":
        return {}
    by_pid = {}
    for a in remotes:
        by_pid[a.sync("pid")] = a.sync("launches")
    out: dict = {}
    for launches in by_pid.values():
        for k, v in launches.items():
            out[k] = out.get(k, 0) + v
    return out


def _eps_worker(batch) -> int:
    from repro_torch.rl.rollout_worker import EPS_STRIDE, MAX_LANES

    return int(batch["eps_id"][0]) // EPS_STRIDE // MAX_LANES


def _pull_workers(it, want: set, what: str) -> None:
    """Pull batches until every worker index of ``want`` has fed one."""
    seen: set = set()
    t0 = time.perf_counter()
    while not want <= seen:
        _require(time.perf_counter() - t0 < RUNTIME_CHAOS_S, f"runtime restart: {what} ({seen})")
        seen.add(_eps_worker(next(it)))


def _runtime_start_s() -> dict:
    """Seconds from a process cell's construction to its first reply, with
    phase 5's worker built on the card in the child: the fork server's first
    child (the server itself starting), a second one, and ``spawn``."""
    import functools

    from repro_torch.core import ProcessBackend, VirtualActor

    out = {}
    for label, method in (("forkserver_first", None), ("forkserver", None), ("spawn", "spawn")):
        t0 = time.perf_counter()
        a = VirtualActor(factory=functools.partial(_RuntimeWorkers("ppo", "cuda"), 1),
                         backend=ProcessBackend(transport="shm", start_method=method))
        try:
            initialised, device = a.sync("cuda_context")
            out[label] = time.perf_counter() - t0
            _require(initialised and device == 0, f"runtime: a {label} child has no CUDA context")
        finally:
            a.stop()
    return out


def _runtime_stream(name: str) -> list:
    backend, handle = _runtime_backend(name)
    try:
        return _determinism_stream("vectorized", "cuda", backend=backend)[0]
    finally:
        if handle is not None:
            handle.stop()


def _runtime_ppo(name: str, counters: list, profile: bool = False) -> dict:
    """Phase 5's PPO CartPole for ITERS iterations with its rollout workers
    on ``name``'s backend (``remote-socket``: ``host=`` lowering onto a
    driver-managed host).  Returns the seconds per iteration, the workers'
    first samples, the learner's weights, the driver's and the children's
    launches, the bytes a batch and a weight sync put on the boundary, and
    (``profile``) the card's idle share over the last iteration, from the
    driver's and each child's device time."""
    import torch

    from repro_torch.core import ProcessBackend
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm, build_ppo

    cfg = PPO_CONFIG
    plan = dict(train_batch_size=cfg["train_batch_size"], num_sgd_iter=cfg["num_sgd_iter"],
                sgd_minibatch_size=cfg["sgd_minibatch_size"])
    factory = _RuntimeWorkers("ppo", "cuda")
    if name == "remote-socket":
        ws = WorkerSet.create(factory, cfg["num_workers"])
        spec = build_ppo(ws, host=RUNTIME_HOST, **plan)
        spec.declare_host(RUNTIME_HOST)
        algo = Algorithm.from_plan(spec, ws)
        _require(RUNTIME_HOST in algo.compiled.host_handles, "runtime: no driver-managed host")
    else:
        backend = "thread" if name == "thread" else ProcessBackend(transport=name.split("-", 1)[1])
        ws = WorkerSet.create(factory, cfg["num_workers"], backend=backend)
        algo = Algorithm.from_plan("ppo", ws, **plan)
    out: dict = {}
    try:
        remotes = ws.remote_workers()
        want_backend = {"thread": "thread", "remote-socket": "remote"}.get(name, "process")
        _require({a.backend_name for a in remotes} == {want_backend},
                 f"runtime {name}: workers on {[a.backend_name for a in remotes]}")
        for c in counters:
            c.reset()
        for a in remotes:
            a.sync("reset_launches")
        # One profiler window per process over the last iteration: the
        # driver's and, by RPC, each child's (a child's kernels run in its
        # own CUDA context, which the driver's profiler does not see).
        probes = list({a.sync("pid"): a for a in remotes}.values()) if name != "thread" else []
        seconds, busy, child_busy_us = [], None, []
        for i in range(ITERS):
            prof = None
            if profile and i == ITERS - 1:
                for a in probes:
                    a.sync("profile_start")
                prof = _DeviceProfile()
                prof.start()
            t0 = time.perf_counter()
            result = algo.train()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if prof is not None:
                busy = prof.stop()
                child_busy_us = [a.sync("profile_stop") for a in probes]
            _require(all(math.isfinite(v) for v in result["info"].values()),
                     f"runtime {name}: non-finite stats {result['info']}")
        driver = {c.name: c.value for c in counters}
        children = _child_launches(remotes, name)
        out.update(seconds=seconds, driver=driver, children=children,
                   kept=[a.sync("kept") for a in remotes],
                   weights=ws.local_worker().get_weights(), counters=result["counters"])
        if busy is not None:
            # Contexts of different processes time-slice on the card (no
            # MPS), so their kernels do not overlap and the busy times add.
            driver_ms, children_ms = sum(busy.values()) / 1e3, sum(child_busy_us) / 1e3
            out["idle_share"] = 1.0 - (driver_ms + children_ms) / (seconds[-1] * 1e3)
            out["driver_busy_ms"], out["children_busy_ms"] = driver_ms, children_ms
            out["profiled_processes"] = 1 + len(probes)
        if name != "thread":
            a = remotes[0]
            cell = a._cell
            w0 = dict(cell.wire_bytes)
            shm0 = dict(getattr(cell._decoder, "stats", {}))
            batch = a.sync("sample")
            shm = {k: v - shm0.get(k, 0) for k, v in getattr(cell._decoder, "stats", {}).items()}
            w1 = dict(cell.wire_bytes)
            weights = ws.local_worker().get_weights()
            a.sync("set_weights", weights)
            w2 = dict(cell.wire_bytes)
            out["bytes"] = {
                "batch_rows": batch.count, "batch_columns_bytes": batch.size_bytes(),
                "batch_wire_bytes": w1["received"] - w0["received"],
                "batch_shm_bytes": shm.get("bytes_shm", 0),
                "weight_sync_wire_bytes": w2["sent"] - w1["sent"],
                "weight_bytes": sum(t.numel() * t.element_size()
                                    for t in _tree_tensors(weights)),
            }
            # The tensor boundary on the card: CUDA tensors sent to the
            # child land there on cuda:0, and come back on cuda:0, bitwise.
            landed = a.sync("devices", dict(enumerate(_tree_tensors(weights))))
            _require(set(landed.values()) == {str(_tree_tensors(weights)[0].device)},
                     f"runtime {name}: tensors landed on {set(landed.values())}")
            back = a.sync("echo", weights)
            for got, sent in zip(_tree_tensors(back), _tree_tensors(weights)):
                _require(got.device == sent.device and torch.equal(got, sent),
                         f"runtime {name}: a CUDA tensor came back changed or moved")
            out["cuda_tensors_bitwise"] = True
    finally:
        algo.stop()
    return out


def _tree_tensors(tree) -> list:
    from repro_torch.tree import tree_leaves

    return tree_leaves(tree)


def _runtime_restart() -> dict:
    """Kill a process worker's OS process mid-stream under ``restart``: the
    supervisor starts a replacement child, which builds its CUDA context,
    and the stream goes on with both workers."""
    import signal as _signal

    from repro_torch.core import ProcessBackend
    from repro_torch.core.metrics import (
        NUM_SHARDS_DROPPED,
        NUM_WORKER_FAILURES,
        MetricsContext,
        set_metrics_for_thread,
    )
    from repro_torch.core.operators import ParallelRollouts
    from repro_torch.core.workers import WorkerSet

    ws = WorkerSet.create(_RuntimeWorkers("vectorized", "cuda"), 2, backend=ProcessBackend(transport="shm"),
                          max_restarts=2, backoff_base=0.0, failure_policy="restart")
    try:
        stream = ParallelRollouts(ws, mode="async", num_async=1)
        metrics = MetricsContext()
        set_metrics_for_thread(metrics)
        stream.metrics = metrics
        it = iter(stream)
        # The children build their CUDA contexts at their own pace: pull
        # until both have fed the stream.
        _pull_workers(it, {1, 2}, "both workers did not feed the stream")
        (victim,) = [a for a in ws.remote_workers() if a.name == "rollout-1"]
        old = victim.sync("pid")
        os.kill(old, _signal.SIGKILL)
        t0 = time.perf_counter()
        while True:
            _require(time.perf_counter() - t0 < RUNTIME_CHAOS_S,
                     "runtime restart: the killed worker never came back")
            b = next(it)
            if _eps_worker(b) == 1 and victim.num_restarts >= 1:
                break
        restart_s = time.perf_counter() - t0
        new = victim.sync("pid")
        initialised, _ = victim.sync("cuda_context")
        _require(new != old and initialised, f"runtime restart: pid {old} -> {new}, CUDA {initialised}")
        _pull_workers(it, {1, 2}, "the stream did not go on with both workers")
        _require(metrics.counters[NUM_WORKER_FAILURES] >= 1
                 and metrics.counters.get(NUM_SHARDS_DROPPED, 0) == 0,
                 f"runtime restart: counters {dict(metrics.counters)}")
        return {"restart_s": restart_s, "num_restarts": victim.num_restarts,
                "failures": metrics.counters[NUM_WORKER_FAILURES]}
    finally:
        ws.stop()
        set_metrics_for_thread(None)


def _runtime_machine_loss() -> dict:
    """Kill the driver-managed host of a rollout fragment under
    ``drop_shard``: its two shards are dropped and training goes on with
    the driver's two workers."""
    from repro_torch.core.metrics import NUM_SHARDS_DROPPED
    from repro_torch.core.operators import TrainOneStep
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm, FlowSpec

    ws_remote = WorkerSet.create(_RuntimeWorkers("vectorized", "cuda"), 2, failure_policy="drop_shard")
    ws_local = WorkerSet.create(_RuntimeWorkers("vectorized", "cuda"), 2, failure_policy="drop_shard")
    spec = FlowSpec("machine_loss")
    spec.declare_host(RUNTIME_HOST)
    remote = spec.rollouts(ws_remote, mode="async", num_async=1, failure_policy="drop_shard",
                           host=RUNTIME_HOST)
    local = spec.rollouts(ws_local, mode="async", num_async=1, failure_policy="drop_shard")
    out = spec.concurrently([remote, local], mode="async").for_each(TrainOneStep(ws_local))
    spec.set_output(out.report(ws_local))
    algo = Algorithm.from_plan(spec, ws_local, own_workers=False)
    try:
        result = algo.train()
        _require({a.backend_name for a in ws_remote.remote_workers()} == {"remote"},
                 "runtime machine loss: the fragment is not on its host")
        algo.compiled.host_handles[RUNTIME_HOST].kill()
        t0 = time.perf_counter()
        while result["counters"].get(NUM_SHARDS_DROPPED, 0) < 2:
            _require(time.perf_counter() - t0 < RUNTIME_CHAOS_S,
                     "runtime machine loss: the host's shards were never dropped")
            result = algo.train()
        drop_s = time.perf_counter() - t0
        before = result["counters"]["num_steps_trained"]
        for _ in range(3):
            result = algo.train()
        trained = result["counters"]["num_steps_trained"]
        _require(result["counters"][NUM_SHARDS_DROPPED] == 2 and trained > before
                 and ws_remote.num_healthy_workers() == 0 and ws_local.num_healthy_workers() == 2,
                 f"runtime machine loss: counters {result['counters']}")
        return {"shards_dropped": result["counters"][NUM_SHARDS_DROPPED], "drop_s": drop_s,
                "steps_trained_after": trained - before}
    finally:
        algo.stop()
        ws_remote.stop()
        ws_local.stop()


def phase_runtime(smi: str) -> dict:
    """Phase 37: the runtime across processes and hosts on the card (one
    chip, under its own deadline).

    a. phase 33's stream (2 workers x 4 lanes x 8 steps, 2 rounds) through
       the thread backend, process-pickle, process-shm and a driver-managed
       host: bitwise equal across the four and to phase 33's thread stream;
    b. phase 5's PPO CartPole (2 workers, ITERS iterations) on the same four:
       each worker's first sample bitwise equal to the thread run's, the
       learner's weights within RUNTIME_WEIGHT_TOL of it, the children's GAE
       and threefry launches (read by RPC) and the driver's surrogate and
       threefry launches exactly what the configuration implies, CUDA
       tensors across each boundary bitwise on cuda:0;
    c. chaos: a process worker killed under ``restart`` comes back with its
       CUDA context and the stream goes on; the host killed under
       ``drop_shard`` drops its 2 shards and training goes on; no
       shared-memory segment of this driver is left.

    Printed, not gated: seconds to start a child (fork server, spawn) and to
    restart one, seconds per PPO iteration on each backend, bytes a batch
    and a weight sync put on the boundary, the card's idle share under
    process-shm (the driver's and both children's device time)."""
    import numpy as np

    from repro_torch.core import list_segments
    from repro_torch.core.transport import SEGMENT_PREFIX

    cfg = PPO_CONFIG
    counters = _all_counters()
    record: dict = {"nvidia_smi": smi}
    with _deadline(RUNTIME_DEADLINE_S, "phase 37 (runtime across processes and hosts)"):
        t_phase = time.perf_counter()
        record["start_s"] = st = _runtime_start_s()
        print(f"runtime [{smi}]: child start {st['forkserver_first']:.3f} s (fork server's first, "
              f"the server starting), {st['forkserver']:.3f} s (fork server), {st['spawn']:.3f} s "
              f"(spawn)", flush=True)
        # a. the determinism stream
        _require(len(_PHASE33_STREAM) == DETERMINISM["rounds"], "runtime: phase 33's stream is missing")
        for name in RUNTIME_BACKENDS:
            for r, (a, b) in enumerate(zip(_runtime_stream(name), _PHASE33_STREAM)):
                _require(set(a.keys()) == set(b.keys()), f"runtime {name}: columns {a.keys()}")
                for k in b.keys():
                    _require(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]),
                             f"runtime {name} round {r}: {k} differs from phase 33's stream")
        record["stream_rows"] = sum(b.count for b in _PHASE33_STREAM)
        print(f"runtime [{smi}]: phase 33's stream ({record['stream_rows']} rows) bitwise equal on "
              f"{', '.join(RUNTIME_BACKENDS)}", flush=True)
        # b. PPO CartPole on each backend
        samples_per_iter = cfg["train_batch_size"] // (cfg["num_envs"] * cfg["rollout_len"])
        sgd_steps = cfg["num_sgd_iter"] * (cfg["train_batch_size"] // cfg["sgd_minibatch_size"])
        rollout_hashes = ITERS * samples_per_iter * (4 + 2 * cfg["rollout_len"])
        want_child = {"gae": ITERS * samples_per_iter, "threefry": rollout_hashes}
        want_driver = {"ppo_surrogate_fwd": ITERS * sgd_steps, "ppo_surrogate_bwd": ITERS * sgd_steps,
                       "threefry": ITERS * sgd_steps}
        runs, record["ppo"] = {}, {}
        for name in RUNTIME_BACKENDS:
            runs[name] = run = _runtime_ppo(
                name, counters, profile=name == "process-shm")
            driver = {k: v for k, v in run["driver"].items() if v}
            child = {k: v for k, v in run["children"].items() if v}
            total = {k: driver.get(k, 0) + child.get(k, 0) for k in {*driver, *child}}
            expect = {k: want_child.get(k, 0) + want_driver.get(k, 0)
                      for k in {*want_child, *want_driver}}
            _require(total == expect, f"runtime {name}: launches {total}, expected {expect}")
            if name != "thread":  # the rollouts ran in the children, the learner in the driver
                _require(child == want_child,
                         f"runtime {name}: children's launches {child}, expected {want_child}")
                _require(driver == want_driver,
                         f"runtime {name}: driver's launches {driver}, expected {want_driver}")
                ref = runs["thread"]
                for w, (got, want) in enumerate(zip(run["kept"], ref["kept"])):
                    _require(len(got) == len(want) == 1, f"runtime {name}: kept {len(got)} samples")
                    for k in want[0]:
                        _require(got[0][k].dtype == want[0][k].dtype
                                 and np.array_equal(got[0][k], want[0][k]),
                                 f"runtime {name}: worker {w + 1}'s first sample differs in {k}")
                run["weight_max_abs_err"] = err = max(
                    float((a - b).abs().max())
                    for a, b in zip(_tree_tensors(run["weights"]), _tree_tensors(ref["weights"])))
                _require(err <= RUNTIME_WEIGHT_TOL,
                         f"runtime {name}: learner weights {err:.3e} from the thread run's")
                _require(run["cuda_tensors_bitwise"], f"runtime {name}: CUDA tensors")
            record["ppo"][name] = p = {
                "s_per_iter": sum(run["seconds"][1:]) / (len(run["seconds"]) - 1),
                "first_iter_s": run["seconds"][0], "launches": total,
                "driver_launches": driver, "child_launches": child,
                **{k: run[k] for k in ("weight_max_abs_err", "bytes", "idle_share", "driver_busy_ms",
                                       "children_busy_ms", "profiled_processes")
                   if k in run}}
            _print_runtime_ppo(smi, name, p)
        # c. chaos on the card
        record["restart"] = _runtime_restart()
        print(f"runtime [{smi}]: a process worker killed under restart: replaced and serving again "
              f"in {record['restart']['restart_s']:.3f} s, its CUDA context built; the stream "
              f"went on with both workers", flush=True)
        record["machine_loss"] = ml = _runtime_machine_loss()
        leftover = list_segments(f"{SEGMENT_PREFIX}{os.getpid()}")
        _require(not leftover, f"runtime: shared-memory segments left: {leftover}")
        record["seconds"] = time.perf_counter() - t_phase
    print(f"runtime: host killed under drop_shard: {ml['shards_dropped']} shards dropped in "
          f"{ml['drop_s']:.3f} s, {ml['steps_trained_after']} rows trained after; no "
          f"shared-memory segment left; phase 37 took {record['seconds']:.1f} s")
    return record


def _print_runtime_ppo(smi: str, name: str, p: dict) -> None:
    extra = ""
    if "bytes" in p:
        b = p["bytes"]
        extra = (f"; a batch of {b['batch_rows']} rows ({b['batch_columns_bytes']} B of "
                 f"columns): {b['batch_wire_bytes']} B on the wire + {b['batch_shm_bytes']} "
                 f"B through shared memory; a weight sync ({b['weight_bytes']} B of "
                 f"tensors): {b['weight_sync_wire_bytes']} B on the wire")
    if "idle_share" in p:
        extra += (f"; the card's idle share {p['idle_share']:.4f} over the last iteration "
                  f"(busy {p['driver_busy_ms']:.2f} ms in the driver + "
                  f"{p['children_busy_ms']:.2f} ms in the children, "
                  f"{p['profiled_processes']} processes profiled)")
    err = f", weights {p['weight_max_abs_err']:.3e} from thread" if "weight_max_abs_err" in p else ""
    print(f"runtime [{smi}]: PPO CartPole on {name}: {p['s_per_iter']:.4f} s/iter after a "
          f"first of {p['first_iter_s']:.3f} s, launches {p['launches']} (children "
          f"{p['child_launches']}){err}{extra}", flush=True)


KERNEL_SITES = {
    "gae": ("src/repro_torch/kernels/csrc/gae.cu", "src/repro/kernels/advantages.py:59"),
    "vtrace": ("src/repro_torch/kernels/csrc/vtrace.cu", "src/repro/kernels/advantages.py:72"),
    "ppo_surrogate_fwd": ("src/repro_torch/kernels/csrc/surrogate.cu",
                          "src/repro/kernels/surrogate.py:58"),
    "ppo_surrogate_bwd": ("src/repro_torch/kernels/csrc/surrogate.cu",
                          "src/repro/kernels/surrogate.py:85"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:29"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:30"),
    # The TPU kernel has no backward: the reference learner differentiates
    # its oracle, jax.grad through ref.chunked_attention.
    "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/ref.py:58"),
    "rwkv6_fwd": ("src/repro_torch/kernels/csrc/rwkv6.cu", "src/repro/kernels/rwkv6.py:31"),
    # No TPU kernel either: the reference learner differentiates ref.rwkv6_ref.
    "rwkv6_bwd": ("src/repro_torch/kernels/csrc/rwkv6.cu", "src/repro/kernels/ref.py:128"),
    "moe_gmm": ("src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:24"),
    # The same TPU kernel at the small block_m of a decode step
    # (repro/models/moe.py:136).
    "moe_gmm_small": ("src/repro_torch/kernels/csrc/moe_gmm_small.cu",
                      "src/repro/kernels/moe_gmm.py:24"),
    # No TPU kernel: the reference's custom VJP computes both products of
    # the backward with einsums.
    "moe_gmm_dx": ("src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/models/moe.py:145"),
    "moe_gmm_dw": ("src/repro_torch/kernels/csrc/moe_gmm.cu", "src/repro/models/moe.py:145"),
    # No TPU kernel: the reference hashes in XLA, jax.random under vmap (its
    # VectorEnv's per-lane split here; every rollout draw is such a hash).
    "threefry": ("src/repro_torch/kernels/csrc/threefry.cu", "src/repro/rl/env.py:299"),
    # The same TPU kernels at bfloat16, the models' default dtype: bf16
    # operands widened, fp32 sums, the output rounded once.
    "flash_attention_fwd_bf16": ("src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
                                 "src/repro/kernels/flash_attention.py:30"),
    "decode_attention_bf16": ("src/repro_torch/kernels/csrc/decode_attention_bf16.cu",
                              "src/repro/kernels/decode_attention.py:29"),
    "moe_gmm_bf16": ("src/repro_torch/kernels/csrc/moe_gmm_bf16.cu",
                     "src/repro/kernels/moe_gmm.py:24"),
    "moe_gmm_small_bf16": ("src/repro_torch/kernels/csrc/moe_gmm_small.cu",
                           "src/repro/kernels/moe_gmm.py:24"),
    # The port-only backward at bf16: jax.grad through ref.chunked_attention
    # at bf16 in the reference.
    "flash_attention_bwd_bf16": ("src/repro_torch/kernels/csrc/flash_attention_bf16.cu",
                                 "src/repro/kernels/ref.py:58"),
    "rwkv6_fwd_bf16": ("src/repro_torch/kernels/csrc/rwkv6.cu", "src/repro/kernels/rwkv6.py:31"),
    "rwkv6_bwd_bf16": ("src/repro_torch/kernels/csrc/rwkv6.cu", "src/repro/kernels/ref.py:128"),
}


def _descendants(root: int) -> list:
    """Pids of the live (not zombie) processes under ``root``, from /proc."""
    children: dict = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = Path(f"/proc/{entry}/stat").read_text()
        except OSError:
            continue
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if state != "Z":
            children.setdefault(int(ppid), []).append(int(entry))
    out, todo = [], [root]
    while todo:
        for pid in children.get(todo.pop(), []):
            out.append(pid)
            todo.append(pid)
    return sorted(out)


def _stop_every_process() -> list:
    """Stop what the script started and return the pids that outlived it.

    Phase 37's children are stopped by their cells, but the fork server they
    came from and multiprocessing's resource tracker exit only after the
    script has (the server finalising the torch it preloaded), so they would
    still be running when it ends: stop them here and wait for them.  A
    process still under this one after that is killed, and reported."""
    if "repro_torch.core" in sys.modules:
        from repro_torch.core import ActorError, stop_helper_processes

        try:
            stop_helper_processes()
        except ActorError as exc:
            print(f"chip_smoke: {exc}", file=sys.stderr)
    left = _descendants(os.getpid())
    for pid in left:
        with contextlib.suppress(OSError):
            os.kill(pid, signal.SIGKILL)
    return left


PHASE_SECONDS: dict = {}  # wall seconds of each phase, in the order run


def _run(key: str, phase, *args):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[key] = time.perf_counter() - t0
    print(f"phase {key}: {PHASE_SECONDS[key]:.1f} s", flush=True)
    return out


def main() -> int:
    t_script = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write every measurement here as JSON")
    args = ap.parse_args()
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # The PPO-LM phase runs near the card's 80 GB: on an H100 two workers'
    # GAE bootstraps once found 13.86 GiB cached in unused blocks and no
    # room for a 2.5 GiB activation.  Growable segments return that space.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels.advantages import GAE_LAUNCHES, VTRACE_LAUNCHES
    from repro_torch.kernels.decode_attention import DECODE_ATTENTION_LAUNCHES
    from repro_torch.kernels.flash_attention import FLASH_BWD_LAUNCHES, FLASH_FWD_LAUNCHES
    from repro_torch.kernels.surrogate import SURROGATE_BWD_LAUNCHES, SURROGATE_FWD_LAUNCHES
    from repro_torch.kernels.threefry import THREEFRY_LAUNCHES

    every_counter = _all_counters()
    record: dict = {}
    try:
        record["device"] = _run("device", phase_device)
        record["build"] = _run("build", phase_build)
        record["launch_floor"] = _run("launch_floor", _launch_floor)
        record["kernels"] = _run("kernels", phase_kernels)
        record["threefry"] = _run("threefry", phase_threefry, THREEFRY_LAUNCHES)
        record["kernels"]["threefry"] = record["threefry"]["cases"]
        record["learner_parity"] = _run("learner_parity", phase_learner_parity)
        record["main_path"] = _run(
            "main_path", phase_main_path,
            [GAE_LAUNCHES, SURROGATE_FWD_LAUNCHES, SURROGATE_BWD_LAUNCHES, THREEFRY_LAUNCHES]
        )
        record["lm_learner_parity"] = _run("lm_learner_parity", phase_lm_learner_parity)
        record["rlhf"] = _run(
            "rlhf", phase_rlhf,
            [GAE_LAUNCHES, SURROGATE_FWD_LAUNCHES, SURROGATE_BWD_LAUNCHES,
             DECODE_ATTENTION_LAUNCHES, FLASH_FWD_LAUNCHES, FLASH_BWD_LAUNCHES, THREEFRY_LAUNCHES]
        )
        # The RLHF path peaks at about 74 GiB, and PyTorch's allocator keeps
        # it cached; a later phase's new actor thread creates its cuBLAS
        # handle outside that cache, and on an H100 it once failed there
        # (CUBLAS_STATUS_ALLOC_FAILED).  Release the cache, as the
        # pretraining phases do around themselves.
        gc.collect()
        torch.cuda.empty_cache()
        record["vtrace_learner_parity"] = _run("vtrace_learner_parity",
                                               phase_vtrace_learner_parity)
        for name in ASYNC_PATHS:
            record[name] = _run(
                name, phase_async, name,
                [GAE_LAUNCHES, VTRACE_LAUNCHES, SURROGATE_FWD_LAUNCHES,
                 SURROGATE_BWD_LAUNCHES, THREEFRY_LAUNCHES]
            )
        rl_counters = [GAE_LAUNCHES, VTRACE_LAUNCHES, SURROGATE_FWD_LAUNCHES,
                       SURROGATE_BWD_LAUNCHES, THREEFRY_LAUNCHES]
        for name in GRADIENT_PATHS:
            record[name] = _run(name, phase_gradient_plan, name, rl_counters)
        record["offpolicy_learner_parity"] = _run("offpolicy_learner_parity",
                                                  phase_offpolicy_learner_parity)
        for name in REPLAY_PATHS:
            record[name] = _run(name, phase_replay_plan, name, rl_counters)
        record["flowcheck"] = _run("flowcheck", phase_flowcheck)
        record["pretrain_parity"] = _run("pretrain_parity", phase_pretrain_parity)
        record["pretrain_parity_bf16"] = _run("pretrain_parity_bf16", phase_pretrain_parity_bf16)
        for name in (*PRETRAIN_PATHS, *PRETRAIN_BF16_PATHS):
            record[name] = _run(name, phase_pretrain, name, every_counter)
        t_zoo = time.perf_counter()
        record["zoo_parity"] = _run("zoo_parity", phase_zoo_parity)
        for name in ZOO_PRETRAIN_PATHS:
            record[name] = _run(name, phase_pretrain, name, every_counter)
        for name in SERVE_ZOO:
            record[name] = _run(name, phase_serve_zoo, name, every_counter)
        for name in SERVE_BF16:
            record[name] = _run(name, phase_serve_bf16, name, every_counter)
        record["zoo_slice_s"] = time.perf_counter() - t_zoo
        print(f"model zoo phases 21b-21d: {record['zoo_slice_s']:.1f} s")
        record["plan_learner_parity"] = _run("plan_learner_parity", phase_plan_learner_parity)
        for name in PLAN_PATHS:
            record[name] = _run(name, phase_plan_path, name, every_counter)
        record["composition"] = _run("composition", phase_composition)
        record["async_opt"] = _run("async_opt", phase_async_opt)
        t_serving = time.perf_counter()
        record["keys"] = _run("keys", phase_keys)
        record["serving"] = _run("serving", phase_serving)
        record["mamba_parity"] = _run("mamba_parity", phase_mamba_parity)
        record["transformer_learner_parity"] = _run("transformer_learner_parity",
                                                    phase_transformer_learner_parity)
        record["ppo_transformer_server"] = _run("ppo_transformer_server",
                                                phase_transformer_server, every_counter)
        record["serving_slice_s"] = time.perf_counter() - t_serving
        print(f"serving slice phases 28-32: {record['serving_slice_s']:.1f} s")
        t_durable = time.perf_counter()
        record["determinism"] = _run("determinism", phase_determinism, THREEFRY_LAUNCHES)
        record["durability"] = _run("durability", phase_durability)
        record["qwen3_restart"] = _run("qwen3_restart", phase_qwen3_restart)
        record["durability_slice_s"] = time.perf_counter() - t_durable
        print(f"determinism and durability phases 33-35: {record['durability_slice_s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        record["learner_group"] = _run("learner_group", phase_learner_group, every_counter)
        record["explain"] = _run("explain", phase_explain)
        # Each child of phase 37 holds its own CUDA context and allocator
        # cache beside the driver's: release what the earlier phases left.
        gc.collect()
        torch.cuda.empty_cache()
        try:
            record["runtime"] = _run("runtime", phase_runtime, record["device"]["nvidia_smi"])
        finally:
            gc.collect()
            torch.cuda.empty_cache()
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        left = _stop_every_process()
    if left:
        print(f"chip_smoke: FAILED: processes {left} were still running at the end "
              f"(killed)", file=sys.stderr)
        return 1
    print("processes: the fork server, the resource tracker and every child stopped; "
          "none left", flush=True)

    kernels = []
    paths = {"ppo_cartpole": record["main_path"]["launches"], "ppo_lm": record["rlhf"]["launches"],
             **{name: record[name]["launches"] for name in ASYNC_PATHS},
             **{name: record[name]["launches"] for name in (*GRADIENT_PATHS, *REPLAY_PATHS)},
             **{name: record[name]["launches"] for name in (*PRETRAIN_PATHS, *PRETRAIN_BF16_PATHS)},
             **{name: record[name]["launches"]
                for name in (*ZOO_PRETRAIN_PATHS, *SERVE_ZOO, *SERVE_BF16)},
             **{name: record[name]["launches"] for name in PLAN_PATHS},
             "ppo_transformer_server": record["ppo_transformer_server"]["launches"],
             **{f"learner_group_{p}": record["learner_group"][p]["launches"]
                for p in ("ppo_lm", "ppo_cartpole", "impala")},
             **{f"ppo_cartpole_{b.replace('-', '_')}": record["runtime"]["ppo"][b]["launches"]
                for b in RUNTIME_BACKENDS}}
    for name, (source, replaces) in KERNEL_SITES.items():
        path_case = record["kernels"][name][0]  # the path's shape comes first
        by_path = {p: n[name] for p, n in paths.items() if name in n}
        if name in ("moe_gmm", "moe_gmm_bf16"):  # its counter counts the small route's too
            small = name.replace("moe_gmm", "moe_gmm_small")
            by_path = {p: v - paths[p].get(small, 0) for p, v in by_path.items()}
        cases_by_path = {}
        for p, shapes in PATH_SHAPES.get(name, {}).items():
            picked = []
            for shape in shapes if isinstance(shapes[0], list) else [shapes]:
                c = next(c for c in record["kernels"][name] if c["shape"] == shape)
                picked.append({k: c.get(k) for k in ("shape", "max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "bound_fp32_ms",
                                                     "call_ms", "call_ms_after", "library_ms",
                                                     "library_call_ms")})
            cases_by_path[p] = picked if len(picked) > 1 else picked[0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in record["kernels"][name]),
            "ms": path_case["ms"], "plain_ms": path_case["plain_ms"],
            "ms_from": path_case["ms_from"], "plain_ms_from": path_case["plain_ms_from"],
            "bound_ms": path_case["bound_ms"], "bound_by": path_case["bound_by"],
            **({"bound_fp32_ms": path_case["bound_fp32_ms"]} if "bound_fp32_ms" in path_case else {}),
            "library_ms": path_case["library_ms"], "library_ms_from": path_case.get("library_ms_from"),
            "library_backend": path_case.get("library_backend"), "shape": path_case["shape"],
            "call_ms": path_case["call_ms"], "plain_call_ms": path_case["plain_call_ms"],
            "library_call_ms": path_case.get("library_call_ms"),
            "launch_floor_ms": record["launch_floor"]["device_ms"],
            **{k: path_case[k] for k in ("logsumexp_ms", "logsumexp_call_ms") if k in path_case},
            "cases_by_path": cases_by_path,
        })
    record["phase_seconds"] = PHASE_SECONDS
    print("phase seconds: " + json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
