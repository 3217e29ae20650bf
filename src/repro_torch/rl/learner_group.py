"""Sharded learner group: data-parallel ``learn_on_batch`` over ranks
(PyTorch port of ``repro/rl/learner_group.py``).

The paper's thesis is that the dataflow layer and the numerical concerns
compose independently (§3, Fig 5): ``TrainOneStep`` / ``LearnerThread`` call
``learn_on_batch`` and never care *how* the update executes.  This module
scales that update out: the same dataflow plan drives one device or a
data-parallel group of learners; the execution mapping changes, the graph
does not.

Where the reference lowers the step onto a ``jax.Mesh`` as one SPMD
program, the port runs torch's own idiom, one process per device:

  * **ranks** — rank 0 is the worker itself, in the driver's process; ranks
    1..N-1 are child processes started from the port's fork server (never
    by a fork after CUDA).  Each child receives the worker's learner
    half (``core.transport.dumps``): the policy, the shapes and dtypes of
    the parameter and target trees (their values arrive by each step's
    broadcast), and the learner's seed.  They form a process group of their
    own (gloo for a CPU worker, NCCL for a CUDA worker, one card a rank)
    over a ``FileStore`` in a fresh directory, so no fixed port is taken;
    ``rl/learner_group_cards.py`` holds 4 NCCL ranks against one card's
    step.  Every wait of a step is bounded (``_TIMEOUT``): a rank that
    stops, fails or never joins makes the step raise, and the group stops
    all its ranks (the next step starts new ones).
  * **a step** — rank 0 trims the batch, sends each child its rows, and
    broadcasts the worker's current parameters (and the target network,
    for the losses that read it) from one flat buffer it keeps, which the
    reduce reuses.  Every rank computes the gradient of
    each of its microbatches, weighted by its share of rows; the weighted
    gradients are summed onto rank 0, which applies the optimizer once.
    So the worker stays the one owner of the weights, and any write into
    them (``set_weights``, a restore) reaches every rank at the next step.
  * **gradient microbatch accumulation** — the rows are split into
    ``microbatch`` slices and the mean of their gradients is applied once:
    a global batch beyond one device's memory costs activations of one
    microbatch only.  On one device this is the whole group (the H100's
    path: a CUDA worker's learners clamp to the visible cards).
  * **donated buffers** — ``donate_params`` is accepted for the
    reference's signature and changes nothing: the update always builds
    new tensors, which keeps a ``get_weights`` on another thread whole;
    ``get_weights`` clones and ``set_weights`` copies.

Loss parity: with equal global batch, mean-reduced losses and gradients are
equal (to float tolerance) between 1 rank, N ranks and any microbatch
factor, because each rank's loss is a mean over its rows and its gradient
enters with weight rows / rows-of-the-microbatch.  A trace-structured loss
(V-trace) splits each microbatch between ranks in whole traces.  The
reference splits the step key per microbatch for keyed losses; the port's
one keyed learner loss (SAC) draws its noise from the learner's generator
(a deliberate difference), so the worker's chain advances once a step, as
the reference's does.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import shutil
import tempfile
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.rl.rollout_worker import _value_and_grad
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any

__all__ = ["ShardedLearnerGroup"]

logger = logging.getLogger(__name__)

# Host-side metadata columns that never reach a rank: batch_indices feed
# replay priority updates, eps_id labels fragments.
_HOST_COLUMNS = ("batch_indices", "eps_id")

# How long a collective may wait for a rank before the group fails.
_TIMEOUT = datetime.timedelta(seconds=300)


class _Leaf:
    """A weight's shape and dtype: what a child rank builds its copy from
    (its values arrive by the step's broadcast)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape: Tuple[int, ...], dtype: str):
        self.shape, self.dtype = shape, dtype

    @staticmethod
    def of(t: torch.Tensor) -> "_Leaf":
        return _Leaf(tuple(t.shape), str(t.dtype).split(".", 1)[1])

    def empty(self, device: torch.device) -> torch.Tensor:
        return torch.empty(self.shape, dtype=getattr(torch, self.dtype), device=device)


class _RankHost:
    """A child rank's copy of the worker's learner half: the attributes the
    worker's ``_loss_for`` reads."""

    def __init__(self, policy: Any, algo: str, generator: torch.Generator):
        self.policy = policy
        self.algo = algo
        self._gen = generator


def _accumulate(
    loss_for: Callable,
    params: PyTree,
    target: PyTree,
    micro: Sequence[Optional[Dict[str, torch.Tensor]]],
    weights: Sequence[float],
):
    """Σ_i w_i ∇loss(micro_i) as a list of leaves (None if every slice is
    empty), the w-weighted loss and scalar stats, and each slice's per-row
    stats (td_error) as host arrays."""
    acc: Optional[List[torch.Tensor]] = None
    loss = None
    scalars: Dict[str, torch.Tensor] = {}
    rows: List[Dict[str, np.ndarray]] = []
    for cols, w in zip(micro, weights):
        if cols is None:
            rows.append({})
            continue
        grads, l, aux = _value_and_grad(lambda p: loss_for(p, target, cols), params)
        grads = tree_leaves(grads)
        if acc is None:
            acc = grads if w == 1.0 else torch._foreach_mul(grads, w)
        else:
            torch._foreach_add_(acc, grads, alpha=w)
        loss = l * w if loss is None else loss + l * w
        per_row = {}
        for name, v in aux.items():
            if v.dim() == 0:
                scalars[name] = v * w if name not in scalars else scalars[name] + v * w
            else:
                per_row[name] = v.reshape(-1).cpu().numpy()
        rows.append(per_row)
    stats = {}
    if loss is not None:
        names = list(scalars)
        values = torch.stack([loss, *(scalars[n] for n in names)]).tolist()
        stats = {"loss": values[0], **dict(zip(names, values[1:]))}
    return acc, stats, rows


# ----------------------------------------------------------------- collectives
def _process_group(device: torch.device, store_path: str, rank: int, world: int) -> Any:
    """The group's own process group (not torch's default one): gloo for a
    CPU worker, NCCL for a CUDA one, each given ``_TIMEOUT``.  NCCL's
    watchdog aborts a collective that outlives it; it is told to abort the
    communicator only (``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``), not to take
    the driver's process down, so the step raises instead."""
    import torch.distributed as dist

    store = dist.FileStore(store_path, world)
    if device.type == "cuda":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = _TIMEOUT
        key = "TORCH_NCCL_ASYNC_ERROR_HANDLING"
        before = os.environ.get(key)
        os.environ[key] = "2"  # read once, as the group is built
        try:
            return dist.ProcessGroupNCCL(store, rank, world, opts)
        finally:
            if before is None:
                del os.environ[key]
            else:
                os.environ[key] = before
    opts = dist.ProcessGroupGloo._Options()
    opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
    opts._timeout = _TIMEOUT
    return dist.ProcessGroupGloo(store, rank, world, opts)


def _wait(work: Any, cuda: bool) -> None:
    """Wait for a collective, at most ``_TIMEOUT``.  Gloo's wait holds its
    own timeout and raises; an NCCL collective runs on the card, so its
    completion is polled from the host and a collective that a rank never
    joins raises ``TimeoutError`` here."""
    if cuda:
        deadline = time.monotonic() + _TIMEOUT.total_seconds()
        while not work.is_completed():
            if time.monotonic() > deadline:
                raise TimeoutError(f"learner group: a collective waited {_TIMEOUT} for a rank")
            time.sleep(0.0005)
    work.wait()


class _FlatBuffer:
    """One flat buffer for a tree's leaves, reused by every step's broadcast
    and reduce (a step then holds one extra copy of the weights, not one a
    collective)."""

    def __init__(self, like: Sequence[torch.Tensor]):
        self.like = list(like)
        self.flat = torch.empty(sum(t.numel() for t in like), dtype=like[0].dtype,
                                device=like[0].device)

    def fill(self, leaves: Optional[Sequence[torch.Tensor]]) -> torch.Tensor:
        """The buffer holding ``leaves`` one after another (zeros for None)."""
        with torch.no_grad():
            if leaves is None:
                self.flat.zero_()
            else:
                torch.cat([t.detach().reshape(-1) for t in leaves], out=self.flat)
        return self.flat

    def views(self) -> List[torch.Tensor]:
        out, i = [], 0
        for t in self.like:
            out.append(self.flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return out


def _broadcast_into(pg: Any, buf: _FlatBuffer, leaves: Sequence[torch.Tensor], rank: int) -> None:
    """Rank 0's values of ``leaves`` into every rank's ``leaves``."""
    if not leaves:
        return
    flat = buf.fill(leaves) if rank == 0 else buf.flat
    _wait(pg.broadcast([flat]), flat.is_cuda)
    if rank != 0:
        with torch.no_grad():
            for t, v in zip(leaves, buf.views()):
                t.copy_(v)


def _reduce_to_root(pg: Any, buf: _FlatBuffer, acc: Optional[List[torch.Tensor]]):
    """Σ over ranks of each rank's ``acc`` (zeros where None), on rank 0, as
    views of ``buf``."""
    import torch.distributed as dist

    flat = buf.fill(acc)
    opts = dist.ReduceOptions()
    opts.rootRank = 0
    _wait(pg.reduce([flat], opts), flat.is_cuda)
    return buf.views()


def _rank_device(device: str, rank: int) -> torch.device:
    d = torch.device(device)
    if d.type != "cuda":
        return d
    return torch.device("cuda", ((d.index or 0) + rank) % torch.cuda.device_count())


def _rank_main(conn: Any, rank: int, world: int, store_path: str, seed: int) -> None:
    """A child rank: take the learner half from the pipe, answer None (or
    what failed), join the group, then serve steps until the driver sends
    None (or the pipe closes)."""
    from repro_torch.core.executor import _recv, _send

    try:
        spec = _recv(conn)  # host tensors: nothing lands on another rank's card
        device = _rank_device(spec["device"], rank)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        host = _RankHost(spec["policy"], spec["algo"], gen)
        params = tree_map(lambda leaf: leaf.empty(device), spec["params"])
        target = tree_map(lambda leaf: leaf.empty(device), spec["target"])
    except BaseException as exc:  # a rank that never joins would hang the group
        _send(conn, exc)
        conn.close()
        return
    _send(conn, None)
    pg = _process_group(device, store_path, rank, world)
    loss_for = spec["loss_for"]
    p_leaves, t_leaves = tree_leaves(params), tree_leaves(target)
    p_buf = _FlatBuffer(p_leaves)
    t_buf = _FlatBuffer(t_leaves) if t_leaves else None
    while True:
        try:
            msg = _recv(conn)
        except (EOFError, OSError):
            break
        if msg is None:
            break
        micro, weights, with_target = msg
        try:
            _broadcast_into(pg, p_buf, p_leaves, rank)
            if with_target:
                _broadcast_into(pg, t_buf, t_leaves, rank)
        except BaseException:  # the group failed: the driver raises and stops every rank
            break
        error, acc, stats, rows = None, None, {}, []
        try:
            micro = [None if m is None else {k: torch.as_tensor(v, device=device)
                                             for k, v in m.items()} for m in micro]
            acc, stats, rows = _accumulate(
                lambda p, t, b: loss_for(host, p, t, b), params, target, micro, weights
            )
        except BaseException as exc:  # the reduce below must still run
            error = exc
        try:
            _reduce_to_root(pg, p_buf, acc)
        except BaseException:
            break
        _send(conn, (error, stats, rows))
    conn.close()


class _Ranks:
    """Ranks 1..N-1 of a group: their processes, pipes and the group's
    store directory."""

    def __init__(self, worker: Any, world: int):
        from repro_torch.core.executor import mp_context
        from repro_torch.core.transport import dumps

        device = _worker_device(worker)
        self.failed = False
        self.dir = tempfile.mkdtemp(prefix="repro_torch_learners_")
        store_path = os.path.join(self.dir, "store")
        seed = worker._gen.initial_seed() if hasattr(worker, "_gen") else 0
        half = dumps({
            "device": str(device),
            "policy": worker.policy,
            "algo": getattr(worker, "algo", None),
            "loss_for": type(worker)._loss_for,
            # On the host, so each rank builds them on its own device.
            # Shapes only: every step broadcasts the weights a rank reads.
            "params": tree_map(_Leaf.of, worker.params),
            "target": tree_map(_Leaf.of, worker.target_params),
        })
        ctx = mp_context(None)  # the fork server: never a fork after CUDA
        logger.info("learner group: starting %d ranks (%d bytes each)", world - 1, len(half))
        self.procs, self.conns = [], []
        for rank in range(1, world):
            parent, child = ctx.Pipe()
            # Each rank's generator starts from its own seed, so no two
            # ranks draw the same learner noise.
            proc = ctx.Process(
                target=_rank_main,
                args=(child, rank, world, store_path, (seed * 1_000_003 + rank) % (1 << 63)),
                daemon=True,
                name=f"learner-rank-{rank}",
            )
            proc.start()
            child.close()
            self.procs.append(proc)
            self.conns.append(parent)
        self._finalizer = weakref.finalize(self, _Ranks._shutdown, self.procs, self.conns, self.dir)
        try:
            for conn in self.conns:  # by value: tensors cross as host bytes
                conn.send_bytes(half)
            for error in self.receive():  # each rank's set-up
                if error is not None:
                    raise error
            logger.info("learner group: %d ranks set up; joining the group", world - 1)
            self.pg = _process_group(device, store_path, 0, world)
            self.params = _FlatBuffer(tree_leaves(worker.params))
            target = tree_leaves(worker.target_params)
            self.target = _FlatBuffer(target) if target else None
        except BaseException:
            self._finalizer()
            raise

    def send(self, msgs: Sequence[Any]) -> None:
        from repro_torch.core.executor import _send

        for conn, msg in zip(self.conns, msgs):
            _send(conn, msg)

    def receive(self) -> List[Any]:
        """Each rank's reply, waiting at most ``_TIMEOUT`` in all."""
        from repro_torch.core.executor import _recv

        deadline = time.monotonic() + _TIMEOUT.total_seconds()
        out = []
        for rank, conn in enumerate(self.conns, start=1):
            try:
                if not conn.poll(max(deadline - time.monotonic(), 0.0)):
                    raise TimeoutError(f"learner rank {rank} gave no reply in {_TIMEOUT}")
                out.append(_recv(conn))
            except (EOFError, OSError):
                raise RuntimeError(f"learner rank {rank} died during a step") from None
        return out

    def close(self) -> None:
        """Stop every rank; after a failed step, abort the group's
        communicator first, so that no collective is left waiting."""
        pg = getattr(self, "pg", None)
        if self.failed and pg is not None and hasattr(pg, "abort"):
            try:
                pg.abort()
            except Exception:
                pass
        self._finalizer()

    @staticmethod
    def _shutdown(procs: List[Any], conns: List[Any], directory: str) -> None:
        from repro_torch.core.executor import _send

        for conn in conns:
            try:
                _send(conn, None)
            except Exception:
                pass
        for proc in procs:
            proc.join(timeout=10.0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5.0)
        for conn in conns:
            conn.close()
        shutil.rmtree(directory, ignore_errors=True)


def _worker_device(worker: Any) -> torch.device:
    device = getattr(worker, "device", None)
    if device is not None:
        return torch.device(device)
    return tree_leaves(worker.params)[0].device


class ShardedLearnerGroup:
    """Data-parallel learn step over ``num_learners`` ranks.

    ``worker`` must expose the learner half of the worker protocol —
    ``policy``, ``params``, ``target_params``, ``opt_state``, ``optimizer``,
    its key chain, and the pure ``_loss_for(params, target_params, batch)``
    (``RolloutWorker`` does).  The group keeps the worker canonical: after
    every step the worker's params/opt state are the updated values, so
    ``get_weights``/``sync_weights`` see fresh weights.  Child ranks start
    at the first step and stop with ``close()`` (the owning operator's
    teardown, ``Algorithm.stop()``), or with
    ``core.stop_helper_processes()``.
    """

    def __init__(
        self,
        worker: Any,
        num_learners: int = 0,
        microbatch: int = 0,
        donate_params: bool = False,
    ):
        requested = num_learners if num_learners > 0 else 1
        device = _worker_device(worker)
        if device.type == "cuda":
            visible = torch.cuda.device_count()
            if requested > visible:
                logger.warning(
                    "learner group: %d learners requested but only %d devices "
                    "visible; clamping", requested, visible,
                )
            requested = min(requested, visible)
        # A CPU worker's learners are gloo ranks: it gets the ones it asks for.
        self.num_learners = requested
        self.microbatch = max(microbatch, 1)
        self.donate_params = donate_params
        self.worker = worker
        # Trace-structured losses (v-trace) reshape rows back into
        # contiguous length-T traces: trimming, microbatch slicing and the
        # split between ranks must then happen in whole-trace units or the
        # reshape fails (or worse, regroups rows across trace boundaries).
        policy = getattr(worker, "policy", None)
        self.trace_len = (
            max(int(getattr(policy, "rollout_len", 0)), 1)
            if getattr(policy, "loss_kind", None) == "vtrace"
            else 1
        )
        self.num_steps = 0
        self.num_rows_trimmed = 0
        self._ranks: Optional[_Ranks] = None

    # --------------------------------------------------- transport boundary
    def shard_batch(self, batch: Any) -> Tuple[Dict[str, np.ndarray], int]:
        """Host columns -> the step's row layout.

        The global row count must tile evenly: each of the ``microbatch``
        slices must split across ``num_learners`` ranks, and for
        trace-structured losses every slice must hold whole length-T traces
        (batch-major rows keep traces contiguous, so tail-trimming in
        T-multiples preserves them).  Surplus rows are trimmed (counted in
        ``num_rows_trimmed``) rather than padded — padding would silently
        bias mean-reduced losses.  With ``microbatch=k`` columns come back
        as [k, rows/k, ...] (host arrays, host-only columns left out).
        """
        # rows-per-microbatch must divide by trace_len (loss reshape) and
        # the total by num_learners (even rank shards): k * lcm(n, T).
        tile = self.microbatch * math.lcm(self.num_learners, self.trace_len)
        count = batch.count if hasattr(batch, "count") else len(next(iter(batch.values())))
        usable = (count // tile) * tile
        if usable == 0:
            raise ValueError(
                f"batch of {count} rows cannot tile {self.num_learners} "
                f"learners x {self.microbatch} microbatches"
            )
        self.num_rows_trimmed += count - usable
        k = self.microbatch
        out = {}
        for name, col in batch.items():
            if name in _HOST_COLUMNS:
                continue
            col = np.asarray(col)[:usable]
            if k > 1:
                col = col.reshape((k, usable // k) + col.shape[1:])
            out[name] = col
        return out, usable

    def _rank_bounds(self, rows: int) -> List[Tuple[int, int]]:
        """Each rank's [start, end) within a microbatch of ``rows`` rows:
        equal shares, or, for a trace-structured loss, whole traces as
        evenly as they go."""
        n, t = self.num_learners, self.trace_len
        units = rows // t
        return [((r * units) // n * t, ((r + 1) * units) // n * t) for r in range(n)]

    # -------------------------------------------------------------- learning
    def learn_on_batch(self, batch: Any, policy_id: Optional[str] = None) -> Dict[str, Any]:
        cols, usable = self.shard_batch(batch)
        count = batch.count if hasattr(batch, "count") else usable
        k, n = self.microbatch, self.num_learners
        rows = usable // k
        bounds = self._rank_bounds(rows)
        weights = [(b - a) / (rows * k) for a, b in bounds]

        def micro_of(rank: int) -> List[Optional[Dict[str, np.ndarray]]]:
            a, b = bounds[rank]
            if a == b:
                return [None] * k
            return [{name: (c[i] if k > 1 else c)[a:b] for name, c in cols.items()}
                    for i in range(k)]

        w = self.worker
        w._next_key()  # the reference's learner key: the chain advances alike
        with_target = getattr(w, "algo", None) in ("dqn", "sac")
        ranks = self._start_ranks() if n > 1 else None
        device = _worker_device(w)

        def own_step():
            micro = [None if m is None else {
                name: torch.as_tensor(v if v.flags.writeable else np.array(v), device=device)
                for name, v in m.items()} for m in micro_of(0)]
            return _accumulate(w._loss_for, w.params, w.target_params, micro, [weights[0]] * k)

        if ranks is None:
            grads, stats, own_rows = own_step()
            replies = [(None, stats, own_rows)]
        else:
            try:
                grads, replies = self._group_step(ranks, own_step, [
                    (micro_of(r), [weights[r]] * k, with_target) for r in range(1, n)])
            except BaseException:
                # A rank that stopped, failed or never joined: no rank of
                # this group is left waiting; the next step starts new ones.
                ranks.failed = True
                self.close()
                raise

        it = iter(grads)
        w.params, w.opt_state = w.optimizer.apply(
            w.params, tree_map(lambda _p: next(it), w.params), w.opt_state
        )
        self.num_steps += 1
        # Replay the worker's own per-update side effects (SAC polyak
        # target tracking — skipping it would train against a frozen
        # target forever, silently).
        if hasattr(w, "_post_update"):
            w._post_update()
        return self._info(replies, count)

    def _group_step(self, ranks: "_Ranks", own_step: Callable, msgs: List[Any]):
        """One step across the ranks: the rows out, the weights broadcast,
        every rank's gradient, their sum on rank 0.  Raises whatever a rank
        raised, or where a rank died or a wait ran out."""
        w = self.worker
        ranks.send(msgs)
        _broadcast_into(ranks.pg, ranks.params, tree_leaves(w.params), 0)
        if msgs[0][2]:  # with the target network
            _broadcast_into(ranks.pg, ranks.target, tree_leaves(w.target_params), 0)
        error, acc, stats, own_rows = None, None, {}, []
        try:
            acc, stats, own_rows = own_step()
        except BaseException as exc:  # the children's reduce must still run
            error = exc
        grads = _reduce_to_root(ranks.pg, ranks.params, acc)
        replies = [(error, stats, own_rows)] + ranks.receive()
        for rank_error, _, _ in replies:
            if rank_error is not None:
                raise rank_error
        return grads, replies

    def _info(self, replies: List[Tuple[Any, Dict[str, float], List[Dict]]], count: int):
        info: Dict[str, Any] = {}
        for _, stats, _ in replies:
            for name, v in stats.items():
                info[name] = info.get(name, 0.0) + v
        per_row = {}
        for i in range(self.microbatch):
            for _, _, rows in replies:
                if i < len(rows):
                    for name, v in rows[i].items():
                        per_row.setdefault(name, []).append(v)
        for name, parts in per_row.items():
            td = np.concatenate(parts)
            if td.size < count:
                # Trimmed rows got no update; consumers zip td_error with
                # the *full* batch (UpdateReplayPriorities against
                # batch_indices), so pad with the mean magnitude — a
                # neutral priority, not an artificial zero or max.
                fill = float(np.mean(np.abs(td))) if td.size else 0.0
                td = np.concatenate([td, np.full(count - td.size, fill, td.dtype)])
            info[name] = td
        info["num_learners"] = self.num_learners
        info["microbatch"] = self.microbatch
        return info

    def _start_ranks(self) -> _Ranks:
        if self._ranks is None:
            self._ranks = _Ranks(self.worker, self.num_learners)
        return self._ranks

    def close(self) -> None:
        """Stop the child ranks (idempotent; a later step starts new ones)."""
        if self._ranks is not None:
            self._ranks.close()
            self._ranks = None

    # ----------------------------------------------------- worker protocol
    def get_weights(self) -> PyTree:
        return self.worker.get_weights()

    def set_weights(self, weights: PyTree) -> None:
        # Copies into the worker's own tensors; every rank reads them at
        # the next step's broadcast.
        self.worker.set_weights(weights)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"ShardedLearnerGroup(learners={self.num_learners}, "
            f"microbatch={self.microbatch}, steps={self.num_steps})"
        )
