"""RLHF-style driver: PPO on a language model through the flow runtime
(PyTorch port of ``repro/launch/rlhf.py``).

    TokenEnv (prompts as resets, one action = one token)
      -> VectorizedRolloutWorker(decode='cache')   KV-cache generation
      -> build_ppo_lm FlowSpec                     same graph as build_ppo
      -> Algorithm.train()                         fine-tunes the LM policy

Rollouts generate through the per-lane KV cache (prefill once per episode,
then one ``ops.decode_attention`` step per token); the learner path runs the
flash-attention forward and backward.  ``--parity`` prints the max logits
gap between the two paths.  The stub reward is programmatic (fraction of
generated tokens equal to a target token).

Runs on the GPU unless ``--device cpu`` is given:
  PYTHONPATH=src python -m repro_torch.launch.rlhf --iters 5
  PYTHONPATH=src python -m repro_torch.launch.rlhf --device cpu --iters 2
  PYTHONPATH=src python -m repro_torch.launch.rlhf --decode forward   # no-cache A/B
  PYTHONPATH=src python -m repro_torch.launch.rlhf --dot              # graph only
"""

from __future__ import annotations

import argparse
import time


def make_rlhf_worker(
    worker_index: int,
    num_envs: int = 8,
    rollout_len: int = 16,
    vocab_size: int = 17,
    ctx: int = 32,
    horizon: int = 16,
    d_model: int = 32,
    n_layers: int = 2,
    decode: str = "cache",
    seed: int = 0,
    lr: float = 3e-3,
    device: str = "cuda",
):
    """One vectorized LM rollout worker over TokenEnv (shared with tests)."""
    from repro_torch.optim import adam
    from repro_torch.rl import LMTokenPolicy, TokenEnv, VectorizedRolloutWorker

    env = TokenEnv(vocab_size=vocab_size, ctx=ctx, horizon=horizon)
    policy = LMTokenPolicy(ctx=ctx, vocab_size=vocab_size, d_model=d_model, n_layers=n_layers)
    return VectorizedRolloutWorker(
        env, policy, algo="ppo", num_envs=num_envs, rollout_len=rollout_len,
        seed=seed, worker_index=worker_index, decode=decode,
        optimizer=adam(lr), device=device,
    )


def parity_gap(worker) -> float:
    """Max decode-vs-forward logits gap on the worker's current obs: prefill
    a cache holding tokens 0..L-2 (the newest token dropped, t forced to 0),
    then one true ``decode_step`` against the no-cache forward."""
    import torch

    from repro_torch import prng

    policy = worker.policy
    obs = worker.vstate.obs
    prev = obs.clone()
    prev[:, policy.ctx] -= 1
    prev[:, policy.ctx + 1] = 0
    keys = prng.split(prng.key(0, obs.device), obs.shape[0])
    with torch.no_grad():
        state = policy.init_lane_state(obs.shape[0], obs.device)
        _, _, _, state = policy.compute_actions_stateful(worker.params, prev, keys, state)
        return float(policy.decode_parity_gap(worker.params, obs, state))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--num-envs", type=int, default=8)
    ap.add_argument("--rollout-len", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=17)
    ap.add_argument("--ctx", type=int, default=32)
    ap.add_argument("--horizon", type=int, default=16)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--train-batch", type=int, default=256)
    ap.add_argument("--sgd-iters", type=int, default=4)
    ap.add_argument("--minibatch", type=int, default=64)
    ap.add_argument("--num-learners", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument(
        "--decode", default="cache", choices=("cache", "forward"),
        help="rollout path: per-lane KV cache vs full re-forward",
    )
    ap.add_argument(
        "--parity", action="store_true",
        help="print the decode-vs-forward max logits gap each iteration",
    )
    ap.add_argument("--dot", action="store_true", help="print the flow graph and exit")
    args = ap.parse_args()

    from repro_torch import flow
    from repro_torch.core.workers import WorkerSet

    def factory(i: int):
        return make_rlhf_worker(
            i, num_envs=args.num_envs, rollout_len=args.rollout_len,
            vocab_size=args.vocab, ctx=args.ctx, horizon=args.horizon,
            d_model=args.d_model, n_layers=args.layers, decode=args.decode,
            seed=args.seed, lr=args.lr, device=args.device,
        )

    ws = WorkerSet.create(factory, args.workers)
    algo = flow.Algorithm.from_plan(
        "ppo_lm", ws,
        train_batch_size=args.train_batch, num_sgd_iter=args.sgd_iters,
        sgd_minibatch_size=args.minibatch, num_learners=args.num_learners,
        decode=args.decode,
    )
    if args.dot:
        print(algo.to_dot())
        algo.stop()
        ws.stop()
        return

    t0 = time.time()
    tokens_per_iter = args.workers * args.num_envs * args.rollout_len
    try:
        for it in range(args.iters):
            res = algo.train()
            ep = res["episodes"]
            line = (
                f"iter {it:3d} reward {ep['episode_reward_mean']:.3f} "
                f"episodes {ep['episodes']:4d} "
                f"trained {res['counters'].get('num_steps_trained', 0):6d} "
                f"({tokens_per_iter / ((time.time() - t0) / (it + 1)):.0f} tok/s)"
            )
            if args.parity:
                line += f" parity_gap {parity_gap(ws.local_worker()):.2e}"
            print(line, flush=True)
    finally:
        algo.stop()
        ws.stop()


if __name__ == "__main__":
    main()
