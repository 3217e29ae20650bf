"""The learner group across the cards of one host: N NCCL ranks against one
card's learn step, from the same weights and batch.

    python -m repro_torch.rl.learner_group_cards [--learners 4]

Needs ``--learners`` CUDA cards.  Two paths, each learning with SGD at lr 1
(so a weight difference is a gradient difference): PPO CartPole (64 x 64
actor-critic, one 1,024-row batch, with and without ``microbatch=2``) and
PPO-LM at Qwen1.5-4B's widths cut to 2 layers (one 256-row rollout).  For
each it prints the largest stat and weight difference against the plain
step (held to 1e-4; exit 1 past it), the seconds of a second step of each
(the first builds the NCCL communicator), and card 0's peak memory during
the group's steps (the plain worker is freed before the group starts);
then it stops every rank and the fork server and fails if a process is
left.  A rank that stops makes the group's step raise within the group's
bounded wait (``learner_group._TIMEOUT``) instead of hanging.

On four H100s every comparison agrees (PPO-LM: weights 1.2e-05 apart).
Each stage prints a line to stderr as it starts, and the group logs its
set-up, so a failure shows where.
"""

from __future__ import annotations

import argparse
import gc
import json
import multiprocessing
import sys
import time
from typing import Any, Callable, Dict

import torch

TOL = 1e-4  # stats and weights, group vs one card's step

__all__ = ["main"]


def _cartpole(seed: int = 0):
    from repro_torch.optim import sgd
    from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker

    return RolloutWorker(
        CartPole(), ActorCriticPolicy(4, 2, hidden=(64, 64), loss_kind="ppo", ent_coef=0.0),
        algo="ppo", num_envs=8, rollout_len=64, seed=seed, optimizer=sgd(1.0), device="cuda",
    )


def _lm(seed: int = 0):
    from repro_torch.configs.qwen15_4b import CONFIG as QWEN
    from repro_torch.optim import sgd
    from repro_torch.rl import LMTokenPolicy, TokenEnv, VectorizedRolloutWorker

    env = TokenEnv(vocab_size=QWEN.vocab_size, ctx=256, min_prompt=64, max_prompt=192, horizon=32)
    policy = LMTokenPolicy(ctx=256, vocab_size=QWEN.vocab_size, d_model=QWEN.d_model, n_layers=2,
                           num_heads=QWEN.num_heads, num_kv_heads=QWEN.num_kv_heads)
    return VectorizedRolloutWorker(env, policy, algo="ppo", num_envs=8, rollout_len=32,
                                   decode="cache", seed=seed, optimizer=sgd(1.0), device="cuda")


def _timed(learn: Callable, batch: Any) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = learn(batch)
    torch.cuda.synchronize()
    return info, time.perf_counter() - t0


def _compare(name: str, make: Callable, batches: list, learners: int, microbatch: int) -> Dict:
    from repro_torch.rl import ShardedLearnerGroup
    from repro_torch.tree import tree_leaves

    def stage(what: str) -> None:
        print(f"{name} (microbatch={microbatch}): {what}", file=sys.stderr, flush=True)

    # One card's steps first, kept on the host; that worker is freed before
    # the group starts, so card 0 holds one worker's weights, not two.
    plain = make()
    stage("one card's step")
    info_p, _ = _timed(plain.learn_on_batch, batches[0])
    want = [t.detach().cpu() for t in tree_leaves(plain.params)]
    _, plain_s = _timed(plain.learn_on_batch, batches[1])
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    grouped = make()
    group = ShardedLearnerGroup(grouped, num_learners=learners, microbatch=microbatch)
    try:
        torch.cuda.reset_peak_memory_stats(0)
        stage("starting the ranks")
        t0 = time.perf_counter()
        group._start_ranks()
        start_s = time.perf_counter() - t0
        stage("the group's first step")
        info_g, first_s = _timed(group.learn_on_batch, batches[0])
        stat_err = max(abs(info_p[k] - info_g[k]) for k in info_p)
        w_err = max(float((a - b.to(a.device)).abs().max())
                    for a, b in zip(want, tree_leaves(grouped.params)))
        stage("the group's second step")
        _, group_s = _timed(group.learn_on_batch, batches[1])
        peak = torch.cuda.max_memory_allocated(0)
        ranks = sorted(p.name for p in multiprocessing.active_children()
                       if p.name.startswith("learner-rank"))
    finally:
        stage("stopping the ranks")
        group.close()
    row = {"path": name, "learners": group.num_learners, "microbatch": microbatch,
           "rows": batches[0].count, "stat_err": stat_err, "weight_err": w_err,
           "plain_s": plain_s, "group_s": group_s, "group_first_s": first_s, "start_s": start_s,
           "card0_peak_bytes": peak, "child_ranks": ranks}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--learners", type=int, default=4)
    args = ap.parse_args()
    if torch.cuda.device_count() < args.learners:
        print(f"learner_group_cards: {args.learners} cards needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import logging

    logging.basicConfig(stream=sys.stderr, format="%(asctime)s %(message)s")
    logging.getLogger("repro_torch.rl.learner_group").setLevel(logging.INFO)
    from repro_torch.core.executor import stop_helper_processes
    from repro_torch.core.operators import StandardizeFields
    from repro_torch.rl import SampleBatch

    standardize = StandardizeFields(["advantages"])
    rows = []
    try:
        source = _cartpole(seed=1)
        batches = [standardize(SampleBatch.concat_samples([source.sample(), source.sample()]))
                   for _ in range(2)]
        for k in (1, 2):
            rows.append(_compare("ppo_cartpole", _cartpole, batches, args.learners, k))
        print("ppo_lm: rollouts", file=sys.stderr, flush=True)
        source = _lm(seed=1)
        batches = [standardize(source.sample()) for _ in range(2)]
        del source
        rows.append(_compare("ppo_lm", _lm, batches, args.learners, 1))
    finally:
        stop_helper_processes()
    left = [p.pid for p in multiprocessing.active_children()]
    failed = [r["path"] for r in rows if r["stat_err"] > TOL or r["weight_err"] > TOL
              or r["learners"] != args.learners or len(r["child_ranks"]) != args.learners - 1]
    print(json.dumps({"ok": not failed and not left, "failed": failed, "left": left,
                      "device": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count()}))
    return 0 if not failed and not left else 1


if __name__ == "__main__":
    sys.exit(main())
