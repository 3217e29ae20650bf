"""Host cost of the keyed rollout paths on the GPU: milliseconds and CUDA
kernel launches of a rollout step, a keyed token sampling and a serve
dispatch, for this checkout's ``repro_torch`` or another's.

Every rollout draw of the port is a threefry hash (``repro_torch.prng``),
and the paths that draw them are bound by the launches the host issues, not
by the device.  This script times, on one card (CUDA events around
synchronised calls, after two warm-up calls), and counts the device records
of ``torch.profiler`` for one call of:

* ``RolloutWorker.sample`` of a PPO CartPole worker (8 envs x 64 steps) and
  ``VectorizedRolloutWorker.sample`` of the same (8 lanes), per step;
* the 256-lane IMPALA worker (``VectorizedRolloutWorker``, V-trace, 32
  steps), per step;
* ``RolloutWorker.sample`` of the replay paths' DQN worker on CartPole and
  SAC worker on Pendulum (4 envs x 16 steps), per step;
* ``prng.categorical`` over PPO-LM's [8, 151936] logits;
* one ``InferenceActor.compute_actions`` of 8 lanes, ``DummyPolicy`` and
  ``ActorCriticPolicy``.

Where the checkout has the threefry kernel (``kernels/threefry.py``), it
also reads the host microseconds of one DQN acting step and one CartPole
env step (their launches beside), and of one ``hash_counts_cuda`` call
against its parts: the bare ``ctypes`` launch of the same kernel, the
library's empty kernel, the stream lookup, the device context, the output's
``torch.empty``, and one int64 torch op.  A host microsecond here is the
mean of 2,000 calls issued back to back, then one synchronise.

Those are APIs every checkout since the serving slice has, so ``--src``
measures an older one; ``--ab DIR`` runs the script in the checkout DIR and
in this one, one process each, in the order DIR, this, this, DIR, and
prints one JSON line per run with the card's name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.keyed_steps [--ab DIR] [--out f.json]
    python src/repro_torch/kernels/keyed_steps.py --src DIR/src  # another checkout's

Needs a CUDA device (and nvcc, where the checkout's prng launches a kernel).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]


def _launches(fn) -> int:
    """Device records (kernels and copies) of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation)


def _seconds(fn, reps: int) -> float:
    """Mean seconds of ``fn`` over ``reps`` synchronised calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def _host_us(fn, reps: int = 2000) -> float:
    """Mean host microseconds of ``fn`` issued ``reps`` times, then one
    synchronise (the device keeps up: each call launches one small kernel
    or none)."""
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def _hash_costs() -> dict:
    """Host microseconds of one keyed DQN acting step, one CartPole env step
    and one ``hash_counts_cuda`` call beside its parts."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import threefry as tf
    from repro_torch.kernels.build import check, load_library
    from repro_torch.rl import CartPole, DQNPolicy, RolloutWorker

    dev = torch.device("cuda", torch.cuda.current_device())
    key = prng.key(1, dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((1, 2, 2), dtype=torch.int64, device=dev)
    words = torch.arange(8, dtype=torch.int64, device=dev)

    def bare():
        check(lib, lib.threefry_counts_launch(key.data_ptr(), 2, 1, 2, out.data_ptr(), 0, stream),
              "threefry_counts")

    def device_context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "hash_counts_cuda": lambda: tf.hash_counts_cuda(key, 2, False),
        "ctypes_launch_only": bare,
        "empty_kernel": lambda: check(lib, lib.empty_launch(stream), "empty_launch"),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "device_context": device_context,
        "torch_empty": lambda: torch.empty((1, 2, 2), dtype=torch.int64, device=dev),
        "int64_op": lambda: words & tf.MASK,
    }
    res = {f"{name}_us": _host_us(fn) for name, fn in parts.items()}
    w = RolloutWorker(CartPole(), DQNPolicy(4, 2), algo="dqn", num_envs=4, rollout_len=16,
                      epsilon=0.2, device="cuda")
    env_keys = prng.split(key, 4)
    action = torch.zeros(4, dtype=torch.int64, device=dev)
    steps = {"dqn_act": lambda: w._act(w.params, w.obs, key),
             "cartpole_env_step": lambda: w.env.step(w.env_state, action, env_keys)}
    for name, fn in steps.items():
        res[f"{name}_us"] = _host_us(fn, 500)
        res[f"{name}_launches"] = _launches(fn)
    return res


def measure(src: Path) -> dict:
    sys.path.insert(0, str(src))
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import prng
    from repro_torch.rl import (
        ActorCriticPolicy,
        CartPole,
        DQNPolicy,
        DummyPolicy,
        InferenceActor,
        Pendulum,
        RolloutWorker,
        SACPolicy,
        VectorizedRolloutWorker,
    )

    if not torch.cuda.is_available():
        raise SystemExit("keyed_steps: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = {"src": str(Path(repro_torch.__file__).resolve().parents[1]),
           "card": smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"}
    workers = {
        "ppo_cartpole_rollout": (lambda: RolloutWorker(
            CartPole(), ActorCriticPolicy(4, 2, loss_kind="ppo"), algo="ppo", num_envs=8,
            rollout_len=64, device="cuda"), 64),
        "vector_cartpole_rollout": (lambda: VectorizedRolloutWorker(
            CartPole(), ActorCriticPolicy(4, 2, loss_kind="ppo"), algo="ppo", num_envs=8,
            rollout_len=64, device="cuda"), 64),
        "impala_256_rollout": (lambda: VectorizedRolloutWorker(
            CartPole(), ActorCriticPolicy(4, 2, loss_kind="vtrace", rollout_len=32), algo="vtrace",
            num_envs=256, rollout_len=32, device="cuda"), 32),
        "dqn_rollout": (lambda: RolloutWorker(
            CartPole(), DQNPolicy(4, 2), algo="dqn", num_envs=4, rollout_len=16, epsilon=0.2,
            device="cuda"), 16),
        "sac_rollout": (lambda: RolloutWorker(
            Pendulum(), SACPolicy(3, 1), algo="sac", num_envs=4, rollout_len=16,
            target_polyak=0.01, device="cuda"), 16),
    }
    for name, (make, steps) in workers.items():
        w = make()
        s = _seconds(w.sample, 10)
        n = _launches(w.sample)
        out[name] = {"s_per_rollout": s, "ms_per_step": s / steps * 1e3,
                     "launches_per_rollout": n, "launches_per_step": n / steps}
    keys = prng.split(prng.key(24, "cuda"), 8)
    logits = torch.randn((8, 151936), device="cuda")
    sample = lambda: prng.categorical(keys, logits)  # noqa: E731
    out["keyed_sampling_lm"] = {"ms": _seconds(sample, 50) * 1e3, "launches": _launches(sample)}
    obs = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    lane_keys = prng.split(prng.key(3), 8).numpy().astype(np.uint32)
    for name, factory in (("dummy", lambda: DummyPolicy(4, 2)),
                          ("ac", lambda: ActorCriticPolicy(4, 2))):
        actor = InferenceActor(factory, device="cuda")
        dispatch = lambda: actor.compute_actions(obs, lane_keys)  # noqa: E731
        out[f"serve_dispatch_{name}"] = {"ms": _seconds(dispatch, 100) * 1e3,
                                         "launches": _launches(dispatch)}
    if importlib.util.find_spec("repro_torch.kernels.threefry") is not None:
        out["host_us"] = _hash_costs()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the src/ whose repro_torch to measure")
    ap.add_argument("--ab", default="", help="another checkout: runs DIR, this, this, DIR")
    ap.add_argument("--out", default="", help="also write the results here as JSON")
    args = ap.parse_args()
    if args.ab:
        runs = []
        for tag, src in (("other", Path(args.ab) / "src"), ("this", ROOT / "src"),
                         ("this", ROOT / "src"), ("other", Path(args.ab) / "src")):
            proc = subprocess.run([sys.executable, __file__, "--src", str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            runs.append({"tag": tag, **json.loads(proc.stdout.strip().splitlines()[-1])})
            print(json.dumps(runs[-1]), flush=True)
        result = {"runs": runs}
    else:
        result = measure(Path(args.src))
        print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
