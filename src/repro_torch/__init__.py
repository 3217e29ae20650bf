"""repro_torch: the PyTorch/CUDA port of ``repro`` (RLlib Flow).

It mirrors ``src/repro`` module for module and imports neither JAX nor
``repro``.  It carries the paper's Fig 10b PPO pipeline, PPO on a
language model, and the asynchronous IMPALA/APPO pipeline: the
actor/dataflow runtime (``core``), the FlowSpec IR with ``build_ppo``,
``build_ppo_lm``, ``build_impala``, ``build_appo`` and ``Algorithm``
(``flow``), the RL numerics and models (``rl``, ``models``, ``optim``) and
the hand-written CUDA kernels on those paths (``kernels``: GAE, V-trace,
the PPO surrogate forward and backward, decode and flash attention), and
the sharding rules, placement trees and cost walker of the sharded learner
group, ``Algorithm.explain`` and the dry run (``distributed``).
"""
