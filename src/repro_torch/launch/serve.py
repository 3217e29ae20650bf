"""Serving entrypoint: the production inference tier under open-loop load
(PyTorch port of ``repro/launch/serve.py``).

Builds the real serving stack — N supervised ``InferenceActor`` replicas
behind an ``InferenceRouter`` with a shared ``CreditGate`` — and drives it
with an **open-loop** synthetic load client: request arrival times are fixed
in advance at the configured rate, independent of completions, so a slow
server accumulates queueing delay instead of silently throttling the
workload (closed-loop clients hide tail latency; see the coordinated-
omission literature).  Latency is measured from the *scheduled* arrival to
completion, so queueing counts.

The replicas run on the card unless ``device="cpu"`` (``--device cpu``) is
given; with ``"cuda"`` and no card they raise.  ``chip_smoke.py`` drives
``build_serving_tier`` / ``warm_replicas`` / ``open_loop_load`` on the card;
this module's ``main`` is the human-facing CLI:

  PYTHONPATH=src python -m repro_torch.launch.serve --replicas 3 --policy ssm \
      --rate 200 --requests 400 --lanes 8 [--device cpu]
"""

from __future__ import annotations

import argparse
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.metrics import LatencyStat
from repro_torch.rl.inference import (
    CreditGate,
    InferenceActor,
    InferenceRouter,
    InferenceUnavailable,
)

__all__ = ["build_serving_tier", "warm_replicas", "open_loop_load", "main"]


def _policy_factory(policy: str, obs_dim: int, num_actions: int):
    if policy == "stateless":
        from repro_torch.rl.policy import DummyPolicy

        return lambda: DummyPolicy(obs_dim, num_actions)
    if policy == "ac":
        from repro_torch.rl.policy import ActorCriticPolicy

        return lambda: ActorCriticPolicy(obs_dim, num_actions)
    if policy == "ssm":
        from repro_torch.rl.stateful_policy import SSMStatePolicy

        return lambda: SSMStatePolicy(obs_dim, num_actions)
    raise ValueError(f"unknown policy {policy!r} (want 'stateless'|'ac'|'ssm')")


def build_serving_tier(
    policy: str = "stateless",
    replicas: int = 1,
    credits: Optional[int] = None,
    routing: str = "auto",
    failure_policy: str = "restart",
    max_batch: Optional[int] = None,
    seed: int = 0,
    obs_dim: int = 4,
    num_actions: int = 2,
    supervised: bool = True,
    device: Any = "cuda",
) -> Tuple[InferenceRouter, List[Any]]:
    """The serving stack the compile() lowering builds, standalone.

    Returns ``(router, actors)``: N replicas (``VirtualActor``-supervised
    when ``supervised``, bare in-process targets otherwise) on ``device``
    behind one router with a shared credit gate.  All replicas are seeded
    identically, so a stateless tier is bit-interchangeable
    replica-to-replica.
    """
    factory = _policy_factory(policy, obs_dim, num_actions)

    def make_target():
        return InferenceActor(factory, seed=seed, max_batch=max_batch, device=device)

    if supervised:
        from repro_torch.core.actor import VirtualActor

        actors: List[Any] = [
            VirtualActor(
                factory=make_target,
                name=f"serve-replica-{i}",
                max_restarts=1,
                backoff_base=0.0,
            )
            for i in range(replicas)
        ]
    else:
        actors = [make_target() for _ in range(replicas)]
    gate = CreditGate(credits if credits is not None else 2 * replicas)
    router = InferenceRouter(
        actors,
        credits=gate,
        sticky=None if routing == "auto" else routing == "sticky",
        failure_policy=failure_policy,
        name=f"serve-{policy}",
    )
    return router, actors


def warm_replicas(
    router: Any, lanes_n: int = 8, obs_dim: int = 4
) -> None:
    """Run every replica's dispatch once per batch shape outside the
    measured window.

    The actor pads dispatch batches to the next power of two, so warming the
    power-of-two shapes up to ``lanes_n`` on *each* replica covers every
    batch size the router can produce.  On the card that takes each replica
    thread's first CUDA and cuBLAS work (its handle, the kernels' first
    launches) out of the load; least-loaded ties would otherwise leave
    replicas 1..N-1 cold, paying it mid-load.  Warm lanes
    are negative — disjoint from any real lane — and their server-side
    state is reset afterwards, so routing and pinning state are untouched.
    """
    shapes = [1 << i for i in range(max(0, lanes_n - 1).bit_length() + 1)]
    for actor in getattr(router, "replicas", [router]):
        virtual = hasattr(actor, "call")
        for n in shapes:
            obs = np.zeros((n, obs_dim), np.float32)
            keys = np.zeros((n, 2), np.uint32)
            lanes = -1 - np.arange(n, dtype=np.int64)
            if virtual:
                ids = actor.sync("submit", obs, keys, lanes)
                while actor.sync("poll", ids) is None:
                    pass
                actor.sync("reset_lanes", lanes)
            else:
                ids = actor.submit(obs, keys, lanes)
                while actor.poll(ids) is None:
                    pass
                actor.reset_lanes(lanes)


def open_loop_load(
    router: Any,
    rate_hz: float = 200.0,
    num_requests: int = 200,
    lanes_per_request: int = 8,
    num_clients: int = 2,
    seed: int = 0,
    obs_dim: int = 4,
    on_failure: str = "recover",
) -> Dict[str, Any]:
    """Drive ``router`` with open-loop synthetic load; returns the summary.

    ``num_clients`` threads split a single arrival schedule (request k is
    *due* at ``k / rate_hz``); each client sleeps until its next request's
    due time and then issues it regardless of how many are still in flight
    — the open-loop discipline.  Per-request latency = completion time
    minus due time.  ``InferenceUnavailable`` is counted as a drop; with
    ``on_failure='recover'`` the client calls ``router.recover()`` and
    carries on (the soak/chaos path).
    """
    lat = LatencyStat(window=max(512, num_requests))
    lock = threading.Lock()
    counts = {"ok": 0, "dropped": 0}
    rng = np.random.RandomState(seed)
    obs_pool = rng.randn(64, lanes_per_request, obs_dim).astype(np.float32)
    keys_pool = rng.randint(0, 2**31, size=(64, lanes_per_request, 2)).astype(
        np.uint32
    )
    sticky = bool(getattr(router, "sticky", False))

    t_start = time.perf_counter()
    due = [t_start + k / rate_hz for k in range(num_requests)]

    def client(cid: int) -> None:
        # Client cid owns requests cid, cid+C, cid+2C... of the shared
        # schedule; its lanes are disjoint from other clients' lanes so
        # sticky routing sees a stable lane universe per client.
        lanes = np.arange(cid * lanes_per_request, (cid + 1) * lanes_per_request)
        for k in range(cid, num_requests, num_clients):
            now = time.perf_counter()
            if due[k] > now:
                time.sleep(due[k] - now)
            obs = obs_pool[k % len(obs_pool)]
            keys = keys_pool[k % len(keys_pool)]
            try:
                if sticky:
                    router.compute_actions(obs, keys, lanes)
                else:
                    router.compute_actions(obs, keys)
            except InferenceUnavailable:
                with lock:
                    counts["dropped"] += 1
                if on_failure == "recover" and hasattr(router, "recover"):
                    router.recover()
                continue
            done = time.perf_counter()
            with lock:
                counts["ok"] += 1
                lat.push(done - due[k])

    threads = [
        threading.Thread(target=client, args=(cid,), name=f"load-client-{cid}")
        for cid in range(num_clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    summary = lat.summary()
    return {
        "requests_ok": counts["ok"],
        "requests_dropped": counts["dropped"],
        "wall_s": wall,
        "rps": counts["ok"] / wall if wall else 0.0,
        "lane_steps_per_s": counts["ok"] * lanes_per_request / wall if wall else 0.0,
        "latency_mean_s": summary["mean"],
        "latency_p50_s": summary["p50"],
        "latency_p99_s": summary["p99"],
        "offered_rate_hz": rate_hz,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", default="stateless",
                    choices=("stateless", "ac", "ssm"))
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--credits", type=int, default=None)
    ap.add_argument("--routing", default="auto",
                    choices=("auto", "least_loaded", "sticky"))
    ap.add_argument("--max-batch", type=int, default=None,
                    help="admission-queue occupancy bound (continuous batching)")
    ap.add_argument("--rate", type=float, default=200.0, help="offered req/s")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--lanes", type=int, default=8, help="env lanes per request")
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="the replicas' device (cuda | cpu)")
    args = ap.parse_args()

    router, _actors = build_serving_tier(
        policy=args.policy,
        replicas=args.replicas,
        credits=args.credits,
        routing=args.routing,
        max_batch=args.max_batch,
        seed=args.seed,
        device=args.device,
    )
    try:
        # Warm each replica's dispatch (every reachable batch shape —
        # continuous batching can merge all clients' lanes into one
        # dispatch) outside the measured window.
        warm_replicas(router, lanes_n=args.lanes * args.clients)
        result = open_loop_load(
            router,
            rate_hz=args.rate,
            num_requests=args.requests,
            lanes_per_request=args.lanes,
            num_clients=args.clients,
            seed=args.seed,
        )
        print(
            f"{args.policy} x{args.replicas} replicas "
            f"(routing={'sticky' if router.sticky else 'least_loaded'}): "
            f"{result['requests_ok']} ok / {result['requests_dropped']} dropped "
            f"in {result['wall_s']:.2f}s = {result['rps']:.1f} req/s "
            f"({result['lane_steps_per_s']:.0f} lane steps/s)"
        )
        print(
            f"action latency: p50 {result['latency_p50_s'] * 1e3:.2f}ms  "
            f"p99 {result['latency_p99_s'] * 1e3:.2f}ms  "
            f"mean {result['latency_mean_s'] * 1e3:.2f}ms"
        )
        stats = router.stats()
        for rep in stats["replicas"]:
            q = rep.get("stats", {}).get("queue", {})
            print(
                f"  {rep['name']}: {rep.get('stats', {}).get('num_requests', 0)} "
                f"requests, occupancy mean {q.get('occupancy_mean', 0.0):.1f} "
                f"peak {q.get('occupancy_peak', 0.0):.0f}, admission p99 "
                f"{q.get('admission_wait_p99_s', 0.0) * 1e3:.2f}ms"
            )
    finally:
        router.stop()


if __name__ == "__main__":
    main()
