"""Port-side copy of ``tests/chaos.py``: the deterministic chaos harness
over ``repro_torch``.

The reference's harness imports ``repro.rl.sample_batch`` (``chaos.py:35``),
which runs the ``repro.rl`` package init and so imports JAX in every child
process that unpickles one of its factories.  This copy builds its batches
with ``repro_torch.rl.sample_batch.SampleBatch`` (the same code) and imports
nothing but numpy and the port, and it is a module of its own rather than
part of ``test_torch_runtime.py``: a process or remote child imports the
module of the factory it unpickles, and a test module's ``pytest`` and
``hypothesis`` imports would cost every child about 1.4 s.

  * ``RaiseOnNth``  — raise on the nth call of a method (``sticky=True``
    keeps raising from the nth call on, simulating a dead worker).
  * ``Hang``        — block inside the nth call (event-released for thread
    backends; duration-bounded so suites cannot wedge).
  * ``SlowWorker``  — seeded per-call delays (straggler simulation).

``FaultInjector`` wraps *any* worker target and applies faults by method
name; ``ChaosFactory`` is a picklable factory wrapper so injected workers
run under ``ProcessBackend`` and ``RemoteBackend`` too.  ``StubWorker`` is a
numpy-only rollout worker implementing the full WorkerSet protocol with
outputs that are a pure function of (worker index, call number), equal to
the reference's ``chaos.StubWorker`` bit for bit.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.rl.sample_batch import SampleBatch

__all__ = [
    "Fault",
    "RaiseOnNth",
    "Hang",
    "SlowWorker",
    "FaultInjector",
    "ChaosFactory",
    "StubWorker",
    "make_stub_worker",
    "PacedWorker",
    "make_paced_worker",
    "kill_fragment",
]


class Fault:
    """Base class: ``apply(call_index, rng)`` runs before the real call."""

    method: str

    def apply(self, call_index: int, rng: np.random.Generator) -> None:  # pragma: no cover
        raise NotImplementedError


@dataclass
class RaiseOnNth(Fault):
    """Raise on the nth call of ``method`` (1-based).

    ``sticky=True`` raises on every call from the nth on — the deterministic
    stand-in for a permanently dead worker (drop-shard scenarios).  With
    ``sticky=False`` the worker "recovers" after the one failure, which is
    the restart-policy scenario (a supervisor rebuild also resets counts).
    """

    method: str
    n: int
    exc: type = RuntimeError
    message: str = "chaos"
    sticky: bool = False

    def apply(self, call_index: int, rng: np.random.Generator) -> None:
        if call_index == self.n or (self.sticky and call_index >= self.n):
            raise self.exc(f"{self.message}: {self.method}() call #{call_index}")


@dataclass
class Hang(Fault):
    """Block inside the nth call of ``method``.

    With a ``release`` event (thread backend) the hang ends when the test
    sets it; otherwise it sleeps ``duration`` seconds (process backend —
    events do not pickle — where the test typically kills the worker).
    """

    method: str
    n: int
    duration: float = 30.0
    sticky: bool = False
    release: Optional[threading.Event] = field(default=None, repr=False)

    def apply(self, call_index: int, rng: np.random.Generator) -> None:
        if call_index == self.n or (self.sticky and call_index >= self.n):
            if self.release is not None:
                self.release.wait(self.duration)
            else:
                time.sleep(self.duration)


@dataclass
class SlowWorker(Fault):
    """Seeded straggler: delay every call of ``method`` from ``first_call``
    on by an exponential draw from the injector's RNG (deterministic given
    the seed, because actor calls are serialized)."""

    method: str
    mean_delay: float = 0.005
    first_call: int = 1

    def apply(self, call_index: int, rng: np.random.Generator) -> None:
        if call_index >= self.first_call:
            time.sleep(float(rng.exponential(self.mean_delay)))


class FaultInjector:
    """Wrap a worker target; apply faults by method name + call count.

    Transparent for untouched methods/attributes.  The per-method call
    counters and the seeded RNG make every schedule reproducible; a
    supervisor restart rebuilds the injector via its factory, resetting
    counts (fresh worker semantics).
    """

    def __init__(self, target: Any, faults: List[Fault], seed: int = 0):
        self._target = target
        self._faults = list(faults)
        self._counts: Dict[str, int] = {}
        self._rng = np.random.default_rng(seed)

    def fault_counts(self) -> Dict[str, int]:
        """Per-method call counts (introspection for tests)."""
        return dict(self._counts)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        target = self.__dict__["_target"]
        attr = getattr(target, name)
        faults = [f for f in self.__dict__["_faults"] if f.method == name]
        if not callable(attr) or not faults:
            return attr
        counts, rng = self.__dict__["_counts"], self.__dict__["_rng"]

        def _wrapped(*args: Any, **kwargs: Any) -> Any:
            counts[name] = i = counts.get(name, 0) + 1
            for f in faults:
                f.apply(i, rng)
            return attr(*args, **kwargs)

        _wrapped.__name__ = name
        return _wrapped


@dataclass
class ChaosFactory:
    """Picklable per-index worker factory with fault plans.

    ``base(index)`` builds the real worker; workers whose index appears in
    ``faults_by_index`` are wrapped in a ``FaultInjector`` seeded by
    ``seed * 1000 + index``.  Being a module-level dataclass, it pickles —
    the ProcessBackend contract — as long as ``base`` and the faults do
    (avoid ``Hang(release=Event())`` for process workers).
    """

    base: Callable[[int], Any]
    faults_by_index: Dict[int, List[Fault]] = field(default_factory=dict)
    seed: int = 0

    def __call__(self, index: int) -> Any:
        worker = self.base(index)
        faults = self.faults_by_index.get(index)
        if not faults:
            return worker
        return FaultInjector(worker, faults, seed=self.seed * 1000 + index)


class StubWorker:
    """Deterministic numpy-only rollout worker (full WorkerSet protocol).

    Every output is a pure function of (worker index, per-method call
    count), so the thread/process backend matrix can assert *exact* equality
    of streams, and chaos tests can tell exactly which worker produced an
    item (``obs // 10_000_000``).
    """

    def __init__(self, index: int = 0, batch_size: int = 8):
        self.index = index
        self.batch_size = batch_size
        self.weights = np.zeros((2,), np.float32)
        self.target_weights = np.zeros((2,), np.float32)
        self._n_samples = 0
        self._n_trained = 0

    # ------------------------------------------------------------- sampling
    def sample(self) -> SampleBatch:
        self._n_samples += 1
        # 10_000_000 leaves ~100k samples of headroom before the call counter
        # would bleed into the worker-index field (free-running workers in the
        # supervision tests can clear 100 samples while a peer restarts).
        base = self.index * 10_000_000 + self._n_samples * 100
        obs = np.arange(self.batch_size, dtype=np.float64) + base
        return SampleBatch(
            {
                "obs": obs,
                "rewards": np.full((self.batch_size,), float(self.index), np.float32),
            }
        )

    def sample_with_count(self) -> Tuple[SampleBatch, int]:
        b = self.sample()
        return b, b.count

    # ------------------------------------------------------------- learning
    def learn_on_batch(self, batch: SampleBatch, policy_id: Any = None) -> Dict[str, Any]:
        self._n_trained += batch.count
        self.weights = self.weights + np.float32(1.0)
        return {"loss": float(np.asarray(batch["obs"]).mean()), "trained": self._n_trained}

    def compute_gradients(self, batch: SampleBatch) -> Tuple[Any, Dict[str, Any]]:
        grads = {"w": np.full((2,), np.asarray(batch["obs"]).mean(), np.float64)}
        return grads, {"loss": float(grads["w"][0]), "batch_count": batch.count}

    def apply_gradients(self, grads: Any) -> None:
        self.weights = self.weights - np.float32(1e-3) * grads["w"].astype(np.float32)

    # ------------------------------------------------------------ messaging
    def get_weights(self) -> np.ndarray:
        return self.weights

    def set_weights(self, weights: np.ndarray) -> None:
        self.weights = np.asarray(weights, np.float32).copy()

    def update_target(self) -> None:
        self.target_weights = self.weights.copy()

    def episode_stats(self) -> Dict[str, float]:
        return {"episode_reward_mean": float(self.index), "episodes": self._n_samples}


class PacedWorker:
    """Driver-paced fault injection: fails exactly when the test says so.

    Call-count faults (``RaiseOnNth``) reset on every supervisor rebuild —
    a fresh target has fresh counters — so they cannot express "one failure
    per wall-clock window", which is what the ``restart_window_s`` budget
    semantics need.  Here the *driver* decides each failure:
    ``tick(fail=True)`` raises, anything else succeeds, independent of how
    many times the supervisor has rebuilt the target.
    """

    def __init__(self, index: int = 0):
        self.index = index
        self.ticks = 0

    def tick(self, fail: bool = False) -> int:
        self.ticks += 1
        if fail:
            raise RuntimeError(f"chaos: paced failure (tick #{self.ticks})")
        return self.ticks


def make_paced_worker(index: int) -> PacedWorker:
    """Module-level (hence picklable) PacedWorker factory."""
    return PacedWorker(index)


def kill_fragment(compiled: Any, host: str) -> Any:
    """Machine-loss injection: kill the OS process hosting a fragment.

    ``compiled`` is a ``CompiledFlow`` (``algo.compiled``) that owns
    driver-managed hosts; terminating the named host's process kills every
    actor rehomed onto it at once — the multi-host analogue of a sticky
    ``RaiseOnNth`` node loss, except nothing driver-side is warned first:
    in-flight RPCs fail with a dead socket, exactly like a machine falling
    off the network.  Returns the (now dead) host handle.
    """
    handle = compiled.host_handles[host]
    handle.kill()
    return handle


# The backend matrix of the reference's ``tests/conftest.py``: thread,
# process + pickle pipe, process + shared memory (children from the port's
# fork server).
BACKEND_MATRIX = ["thread", "process-pickle", "process-shm"]


def make_backend(param: str) -> Any:
    """Map a matrix param to a ``WorkerSet.create`` backend argument."""
    if param == "thread":
        return "thread"
    from repro_torch.core import ProcessBackend

    _, transport = param.split("-", 1)
    return ProcessBackend(transport=transport)


def make_stub_worker(index: int) -> StubWorker:
    """Module-level (hence picklable) StubWorker factory."""
    return StubWorker(index)


def expected_obs_base(index: int, nth_sample: int) -> int:
    """The obs offset StubWorker.sample() produces for a given call."""
    return index * 10_000_000 + nth_sample * 100


def make_vec_dummy_worker(index: int) -> Any:
    """Module-level (hence picklable) vectorized StubEnv + DummyPolicy
    worker on the CPU (2 lanes x 8 steps, seed 13)."""
    from repro_torch.rl import DummyPolicy, StubEnv, VectorizedRolloutWorker

    return VectorizedRolloutWorker(
        StubEnv(max_steps=6), DummyPolicy(4, 2), algo="pg",
        num_envs=2, rollout_len=8, seed=13, worker_index=index, device="cpu",
    )


class TensorWorker:
    """A target whose weights are torch tensors (``device``: where they
    live), for the tensor boundary: ``echo`` returns its argument, and
    ``devices`` names the device of every tensor it was given."""

    def __init__(self, index: int = 0, device: str = "cpu"):
        import torch

        self.index = index
        g = torch.Generator().manual_seed(index)
        self.weights = {
            "w": torch.randn(64, 32, generator=g).to(device),
            "b": torch.zeros(32).to(device),
        }

    def get_weights(self) -> Dict[str, Any]:
        return {k: v.detach().clone() for k, v in self.weights.items()}

    def set_weights(self, weights: Dict[str, Any]) -> None:
        for k, v in weights.items():
            self.weights[k].copy_(v)

    def echo(self, obj: Any) -> Any:
        return obj

    def devices(self, obj: Any) -> List[str]:
        import torch

        out: List[str] = []

        def visit(x: Any) -> None:
            if isinstance(x, torch.Tensor):
                out.append(str(x.device))
            elif isinstance(x, dict):
                for v in x.values():
                    visit(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    visit(v)

        visit(obj)
        return out


def make_tensor_worker(index: int) -> TensorWorker:
    """Module-level (hence picklable) TensorWorker factory on the CPU."""
    return TensorWorker(index)


def make_ppo_worker(index: int) -> Any:
    """Module-level PPO CartPole worker on the CPU (2 envs x 16 steps,
    seed 3): crosses process and host boundaries by pickle, so it must not
    close over test-local state."""
    from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker

    return RolloutWorker(
        CartPole(),
        ActorCriticPolicy(4, 2, loss_kind="ppo", rollout_len=16),
        algo="ppo", num_envs=2, rollout_len=16, seed=3, worker_index=index, device="cpu",
    )


def make_stub_dummy_vectorized(index: int) -> Any:
    """The determinism suite's vectorized worker on the CPU: StubEnv +
    DummyPolicy, 4 lanes x 8 steps, seed 21 (``tests/test_rollout_determinism.py``)."""
    from repro_torch.rl import DummyPolicy, StubEnv, VectorizedRolloutWorker

    return VectorizedRolloutWorker(
        StubEnv(max_steps=6), DummyPolicy(4, 2), algo="pg",
        num_envs=4, rollout_len=8, seed=21, worker_index=index, device="cpu",
    )


def make_stub_dummy_per_env(index: int) -> Any:
    """``make_stub_dummy_vectorized``'s per-env counterpart."""
    from repro_torch.rl import DummyPolicy, PerEnvRolloutWorker, StubEnv

    return PerEnvRolloutWorker(
        StubEnv(max_steps=6), DummyPolicy(4, 2), algo="pg",
        num_envs=4, rollout_len=8, seed=21, worker_index=index, device="cpu",
    )
