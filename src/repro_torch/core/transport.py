"""The data plane (PyTorch port of ``repro/core/transport.py``): pluggable
inter-process transports, the tensor boundary and the credit primitives.

A ``ProcessBackend`` moves *control* off the driver; this module moves the
*data*.  Three transports carry an RPC's payload between a producing child
(or remote host) and the consuming driver:

  * ``PickleTransport``       -- the baseline: payloads ride the RPC pipe.
  * ``SharedMemoryTransport`` -- ``SampleBatch`` numpy columns are written
    once into ``multiprocessing.shared_memory`` **ring segments** by the
    producing process; the pipe carries a *header-only* control message
    (segment name + column dtype/shape/offset table).  The consumer maps the
    segment and builds zero-copy numpy views.  Reclaim is **refcounted**:
    every decoded batch holds a lease on its segment, and only when the last
    view dies is the segment name queued back to the producer (piggybacked
    on the next RPC), which marks the slot free for reuse.  Non-array
    payloads -- and batches below ``threshold`` bytes, where header overhead
    beats the copy saved -- fall back to the pipe.
  * ``SocketTransport``       -- the inter-host plane of ``core.remote``:
    length-prefixed frames (``encode_frame``/``FrameDecoder``) with each
    batch's columns packed into one contiguous blob.

The tensor boundary (port-only).  Batches are numpy on the host, but
weights, gradients and some results are torch tensors, often on the card.
``import torch`` registers torch's reducers with
``multiprocessing.reduction.ForkingPickler``, which ``Connection.send``
uses: a CUDA tensor would cross by CUDA IPC handle and a CPU tensor by file
descriptor, each kept alive by the sender and piling up descriptors.  So
every endpoint of the port pickles with ``dumps``/``loads`` instead: a
``torch.Tensor`` anywhere in a message crosses as host bytes (a numpy array
plus its dtype, shape and device string) and is rebuilt on the receiving
side on the device it left.  No torch reducer and no CUDA IPC is used, on
any of the three transports.

Credit-based backpressure lives here too (``CreditPool``): ``gather_async``
acquires a credit per dispatched-but-unconsumed item and releases it as the
consumer drains results (starved shards backfill FIFO); the queue operators
(``Enqueue``/learner queues) use their bounded queue capacity as the window
with an overflow policy.  Both replace open-loop buffering with a bounded,
observable window (credit stalls + occupancy are recorded into the shared
metrics context; see ``core.metrics``).

Segment lifecycle & crash safety: segment names are prefixed with a
per-cell, per-generation token (``rpt<pid>x<cell>g<gen>``; ``SEGMENT_PREFIX``
is not the reference's ``rfl``, so neither package's sweep or lease
sanitizer, which match names by prefix, ever sees the other's).  The producer
unlinks its segments on graceful shutdown; the *consumer* side additionally
sweeps ``/dev/shm`` for its prefix on ``close()``/``kill()``, so a worker
killed mid-transfer leaks nothing.  Both sides unregister their mappings
from the ``multiprocessing`` resource tracker because lifetime is managed
here, not at interpreter exit.
"""

from __future__ import annotations

import glob
import io
import itertools
import os
import pickle
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Transport",
    "PickleTransport",
    "SharedMemoryTransport",
    "SocketTransport",
    "TRANSPORTS",
    "resolve_transport",
    "CreditPool",
    "OverflowPolicy",
    "list_segments",
    "SEGMENT_PREFIX",
    "SANITIZER",
    "ShmLeaseViolation",
    "sanitize_enabled",
    "encode_frame",
    "FrameDecoder",
    "FrameError",
    "dumps",
    "loads",
]

# --------------------------------------------------------------------------
# The tensor boundary: every message of every endpoint is pickled here
# --------------------------------------------------------------------------
# Dtypes numpy holds as they are; any other (bfloat16, ...) crosses as its
# raw bytes and is viewed back on the receiving side.
_NUMPY_DTYPES = frozenset(
    (
        torch.float16, torch.float32, torch.float64, torch.int8, torch.int16,
        torch.int32, torch.int64, torch.uint8, torch.bool, torch.complex64,
        torch.complex128,
    )
)


def _tensor_from_wire(
    array: np.ndarray, dtype: str, shape: Tuple[int, ...], device: str, requires_grad: bool
) -> torch.Tensor:
    """Rebuild a tensor that crossed as host bytes, on the device it left."""
    if not array.flags.writeable:
        array = array.copy()
    t = torch.from_numpy(array)
    want = getattr(torch, dtype)
    if t.dtype != want:  # a raw-bytes dtype: view the uint8 buffer back
        t = t.view(want)
    t = t.reshape(shape).to(device)
    if requires_grad:
        t.requires_grad_(True)
    return t


def _tensor_to_wire(t: torch.Tensor) -> Tuple[Any, ...]:
    host = t.detach().to("cpu").contiguous()
    if host.dtype in _NUMPY_DTYPES:
        array = host.numpy()
    else:
        array = host.reshape(-1).view(torch.uint8).numpy()
    dtype = str(t.dtype).split(".", 1)[1]
    return (array, dtype, tuple(t.shape), str(t.device), bool(t.requires_grad))


class _BoundaryPickler(pickle.Pickler):
    """A plain pickler whose only change is the tensor rule: a tensor (a
    ``Parameter`` included) reduces to host bytes, never to torch's storage
    reducers."""

    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor):
            return _tensor_from_wire, _tensor_to_wire(obj)
        return NotImplemented


def dumps(obj: Any) -> bytes:
    """Pickle one message for a process or host boundary (the tensor rule)."""
    buf = io.BytesIO()
    _BoundaryPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def loads(data: bytes) -> Any:
    """Unpickle a message from ``dumps``; tensors land on their devices."""
    return pickle.loads(data)


_SHM_ALIGN = 64  # column offsets aligned for safe dtype views + cache lines
SEGMENT_PREFIX = "rpt"  # every process cell's segment names start with it


_quiet_cls: Any = None


def _quiet_shm_class() -> Any:
    """A SharedMemory whose ``__del__`` cannot spew ``BufferError``.

    A mapping still referenced by numpy views at GC time must simply stay
    mapped (the views keep the memory alive); the stock ``__del__`` prints
    an ignored-exception traceback instead.  Lifetime is managed explicitly
    by ``_Attachment``/``ShmWriter`` — this only silences the destructor.
    """
    global _quiet_cls
    if _quiet_cls is None:
        from multiprocessing import shared_memory

        class _QuietSharedMemory(shared_memory.SharedMemory):
            def __del__(self):
                try:
                    super().__del__()
                except BufferError:
                    pass

            def unlink(self):
                with _tracker_untracked():
                    super().unlink()

        _quiet_cls = _QuietSharedMemory
    return _quiet_cls


# Resource-tracker silencing.  Segment lifetime is owned by this module
# (producer ring + consumer prefix sweep), and the tracker's process-exit
# cleanup actively fights that ownership: both create and attach register a
# name, every unlink unregisters it, and with a child and the driver both
# touching the same name the shared tracker's set goes unbalanced — yielding
# KeyError tracebacks and bogus "leaked shared_memory" warnings.  The port's
# children are started by forkserver or spawn, and either way they share the
# driver's tracker process (its descriptor is handed down), so both sides
# must stay silent towards it.
#
# The silencing is a THREAD-LOCAL flag honored by permanently-installed
# wrappers, never a patch-under-lock: a lock held across a fork (the
# forkserver forks, and so may user code) would be inherited locked (owner
# thread gone) and deadlock the child's first shared-memory call.  A thread
# cannot fork while inside its own ``_tracker_untracked`` block, so the flag
# is fork-consistent by construction.
_tracker_silence = threading.local()
_tracker_patched = False
_patch_lock = threading.Lock()  # guards wrapper install only (no syscalls)


def _ensure_tracker_wrappers() -> None:
    global _tracker_patched
    if _tracker_patched:
        return
    with _patch_lock:
        if _tracker_patched:
            return
        from multiprocessing import resource_tracker

        orig_register = resource_tracker.register
        orig_unregister = resource_tracker.unregister

        def register(name: str, rtype: str) -> None:
            if rtype == "shared_memory" and getattr(_tracker_silence, "on", False):
                return
            orig_register(name, rtype)

        def unregister(name: str, rtype: str) -> None:
            if rtype == "shared_memory" and getattr(_tracker_silence, "on", False):
                return
            orig_unregister(name, rtype)

        resource_tracker.register = register
        resource_tracker.unregister = unregister
        _tracker_patched = True


if hasattr(os, "register_at_fork"):
    # Defensive: a fork racing the (brief) wrapper install must not leave
    # the child with a locked install lock.
    os.register_at_fork(after_in_child=lambda: globals().__setitem__("_patch_lock", threading.Lock()))


class _tracker_untracked:
    """Context manager: shared_memory calls on THIS thread skip the tracker."""

    def __enter__(self) -> "_tracker_untracked":
        _ensure_tracker_wrappers()
        self._prev = getattr(_tracker_silence, "on", False)
        _tracker_silence.on = True
        return self

    def __exit__(self, *exc: Any) -> None:
        _tracker_silence.on = self._prev


def _open_shm(name: str, create: bool = False, size: int = 0) -> Any:
    cls = _quiet_shm_class()
    with _tracker_untracked():
        if create:
            return cls(name=name, create=True, size=size)
        return cls(name=name)


def list_segments(prefix: str) -> List[str]:
    """Live /dev/shm segment names starting with ``prefix`` (leak checks)."""
    if not os.path.isdir("/dev/shm"):
        return []
    return sorted(os.path.basename(p) for p in glob.glob(f"/dev/shm/{prefix}*"))


def _unlink_by_name(name: str) -> None:
    """Destroy a segment by name, tolerating it being already gone.

    POSIX unlinks by name, without attaching: a producer killed between
    creating a segment and sizing it leaves a segment of 0 bytes, and
    attaching to that fails (``mmap`` of an empty file), so an
    attach-then-unlink sweep would leak it for good.  The tracker is not
    told: this module never registers a name with it.  Elsewhere the
    segment is attached and unlinked, a lost race raising
    ``FileNotFoundError``, which is the success case.
    """
    try:
        import _posixshmem
    except ImportError:  # not POSIX: attach, then unlink
        try:
            seg = _open_shm(name)
            seg.close()
            seg.unlink()
        except Exception:
            pass
        return
    try:
        _posixshmem.shm_unlink("/" + name)
    except FileNotFoundError:
        pass


# --------------------------------------------------------------------------
# Dynamic analysis: the shm lease sanitizer (TRANSPORT_SANITIZE=1)
# --------------------------------------------------------------------------
def sanitize_enabled() -> bool:
    """True when the environment opts into lease sanitizing."""
    return os.environ.get("TRANSPORT_SANITIZE", "").lower() in ("1", "true", "on")


class ShmLeaseViolation(AssertionError):
    """A lease acquire/release invariant was broken (sanitizer finding)."""


class _LeaseSanitizer:
    """Process-wide ledger of shm segment lease acquire/release pairs.

    The reclaim protocol is refcounted: every decoded batch holds one
    reader-side lease on its mapped segment (``_Attachment.add_lease``),
    dropped exactly once when the last view dies (``_SegmentToken.__del__``),
    and the writer's per-segment ring refcount decrements once per released
    batch ref.  This sanitizer turns those invariants into a checker the
    test suite runs under ``TRANSPORT_SANITIZE=1``:

      * double-release — a lease dropped more often than acquired, or a
        writer ring ref released below zero / for a never-created segment;
      * leaked lease  — a lease still live at epoch end (one test), after
        the epoch's garbage is collected;
      * leaked segment — a ``/dev/shm`` entry under the runtime's prefix
        surviving epoch teardown.

    Scope: the ledger is per-process, so it audits every endpoint living in
    the driver (readers for worker->driver data, plus any writer built
    in-process by tests/benchmarks).  Writers inside child processes check
    their own ring refcounts but report to their own copy of the ledger,
    which no one collects — child-side violations surface indirectly, as
    driver-side leaks of the segments involved.

    Hooks are gated on ``self.enabled`` (a plain attribute read) so the
    default path stays free; ``begin_epoch``/``end_epoch`` are driven by the
    autouse fixture in ``tests/conftest.py``.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.enabled = False
        self._epoch = "<no epoch>"
        # id(attachment) -> [segment name, live lease count]; entries are
        # dropped at zero so id reuse after GC cannot corrupt the ledger.
        self._live: Dict[int, List[Any]] = {}
        self._violations: List[str] = []

    # ------------------------------------------------------------ lifecycle
    def begin_epoch(self, tag: str) -> None:
        """Start a fresh ledger (one epoch = one test)."""
        with self._lock:
            self._epoch = tag
            self._live.clear()
            self._violations.clear()
            self.enabled = True

    def end_epoch(self, prefix: str = SEGMENT_PREFIX) -> None:
        """Close the epoch: collect garbage, then fail on any violation.

        Two ``gc.collect`` passes let release tokens queued behind reference
        cycles die before the leak check; segments under ``prefix`` still in
        ``/dev/shm`` after that are leaks too (a stopped runtime sweeps its
        own prefix on close).
        """
        import gc

        if not self.enabled:
            return
        gc.collect()
        gc.collect()
        with self._lock:
            self.enabled = False
            problems = list(self._violations)
            problems += [
                f"leaked lease: segment {seg} still has {n} live lease(s)"
                for seg, n in self._live.values()
                if n > 0
            ]
            self._live.clear()
            self._violations.clear()
            epoch = self._epoch
        leftover = list_segments(prefix)
        problems += [f"leaked /dev/shm segment: {name}" for name in leftover]
        for name in leftover:  # clean up so one leak doesn't fail every test after
            _unlink_by_name(name)
        if problems:
            raise ShmLeaseViolation(
                f"shm lease sanitizer ({epoch}): {len(problems)} violation(s)\n"
                + "\n".join("  " + p for p in problems)
            )

    # ---------------------------------------------------------------- hooks
    def lease_acquired(self, att: Any, segment: str) -> None:
        with self._lock:
            entry = self._live.setdefault(id(att), [segment, 0])
            entry[1] += 1

    def lease_dropped(self, att: Any, segment: str) -> None:
        with self._lock:
            entry = self._live.get(id(att))
            if entry is None:
                self._violations.append(
                    f"double-release: lease on segment {segment} dropped "
                    "with no live lease outstanding"
                )
                return
            entry[1] -= 1
            if entry[1] <= 0:
                del self._live[id(att)]

    def violation(self, message: str) -> None:
        with self._lock:
            self._violations.append(message)


SANITIZER = _LeaseSanitizer()


# --------------------------------------------------------------------------
# Overflow policies (shared by Enqueue / learner queues)
# --------------------------------------------------------------------------
class OverflowPolicy:
    """What a bounded producer does when its window/queue is full.

    BLOCK       -> wait for a credit/slot, recording stall time.
    DROP_NEWEST -> reject the incoming item (count it dropped).
    DROP_OLDEST -> evict the oldest buffered item to admit the new one.
    """

    BLOCK = "block"
    DROP_NEWEST = "drop_newest"
    DROP_OLDEST = "drop_oldest"
    ALL = frozenset((BLOCK, DROP_NEWEST, DROP_OLDEST))

    @classmethod
    def validate(cls, policy: str) -> str:
        if policy not in cls.ALL:
            raise ValueError(
                f"unknown overflow policy {policy!r}; expected one of {sorted(cls.ALL)}"
            )
        return policy


class CreditPool:
    """A bounded pool of in-flight credits (the backpressure primitive).

    Producers ``try_acquire()`` before dispatching an item and ``release()``
    when the consumer has taken it; a ``None`` capacity means unbounded
    (always grants).  Thread-safe; resizable mid-stream (elastic shards).
    """

    def __init__(self, capacity: Optional[int]):
        if capacity is not None and capacity < 1:
            raise ValueError("credit capacity must be >= 1 (or None for unbounded)")
        self._capacity = capacity
        self._outstanding = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> Optional[int]:
        return self._capacity

    @property
    def outstanding(self) -> int:
        return self._outstanding

    def resize(self, capacity: Optional[int]) -> None:
        with self._lock:
            self._capacity = capacity

    def try_acquire(self, n: int = 1) -> bool:
        with self._lock:
            if self._capacity is not None and self._outstanding + n > self._capacity:
                return False
            self._outstanding += n
            return True

    def release(self, n: int = 1) -> None:
        with self._lock:
            self._outstanding = max(0, self._outstanding - n)


# --------------------------------------------------------------------------
# Wire format (header-only control messages)
# --------------------------------------------------------------------------
class _ColumnRef:
    """One column inside a segment: everything needed to rebuild the view."""

    __slots__ = ("key", "dtype", "shape", "offset", "nbytes")

    def __init__(self, key: str, dtype: str, shape: Tuple[int, ...], offset: int, nbytes: int):
        self.key = key
        self.dtype = dtype
        self.shape = shape
        self.offset = offset
        self.nbytes = nbytes

    def __getstate__(self):
        return (self.key, self.dtype, self.shape, self.offset, self.nbytes)

    def __setstate__(self, state):
        self.key, self.dtype, self.shape, self.offset, self.nbytes = state


class _ShmBatchRef:
    """Header standing in for one SampleBatch: segment name + column table."""

    __slots__ = ("segment", "columns", "nbytes", "created_at")

    def __init__(self, segment: str, columns: List[_ColumnRef], nbytes: int, created_at: Any):
        self.segment = segment
        self.columns = columns
        self.nbytes = nbytes
        self.created_at = created_at

    def __getstate__(self):
        return (self.segment, self.columns, self.nbytes, self.created_at)

    def __setstate__(self, state):
        self.segment, self.columns, self.nbytes, self.created_at = state


class _ShmMultiRef:
    """MultiAgentBatch header: per-policy batch refs (or inline fallbacks)."""

    __slots__ = ("policy_refs",)

    def __init__(self, policy_refs: Dict[str, Any]):
        self.policy_refs = policy_refs

    def __getstate__(self):
        return self.policy_refs

    def __setstate__(self, state):
        self.policy_refs = state


class _ShmPayload:
    """Top-level wire marker: ``tree`` contains at least one shm ref.

    ``retired`` carries segment names the writer destroyed since the last
    shm message (ring recycling), so the reader can drop its now-dead
    attachments instead of keeping the unlinked pages mapped forever.
    """

    __slots__ = ("tree", "retired")

    def __init__(self, tree: Any, retired: Tuple[str, ...] = ()):
        self.tree = tree
        self.retired = retired

    def __getstate__(self):
        return (self.tree, self.retired)

    def __setstate__(self, state):
        self.tree, self.retired = state


# --------------------------------------------------------------------------
# Reader-side lease plumbing (refcounted reclaim)
# --------------------------------------------------------------------------
class _Attachment:
    """One mapped segment on the consumer side, refcounted by live leases.

    The mapping must outlive every numpy view into it; it is closed only
    when the reader has discarded it *and* the last lease token has died —
    never while a view could still dereference the buffer.
    """

    __slots__ = ("shm", "live", "discarded", "lock", "raw")

    def __init__(self, shm: Any):
        self.shm = shm
        self.live = 0
        self.discarded = False
        self.lock = threading.Lock()
        # One buffer export per attachment; per-message decodes view this.
        self.raw = np.frombuffer(shm.buf, dtype=np.uint8)

    def add_lease(self) -> None:
        if SANITIZER.enabled:
            SANITIZER.lease_acquired(self, self.shm.name)
        with self.lock:
            self.live += 1

    def drop_lease(self) -> None:
        if SANITIZER.enabled:
            SANITIZER.lease_dropped(self, self.shm.name)
        with self.lock:
            self.live -= 1
            close_now = self.discarded and self.live <= 0
        if close_now:
            self._close()

    def discard(self) -> None:
        with self.lock:
            self.discarded = True
            close_now = self.live <= 0
        if close_now:
            self._close()

    def _close(self) -> None:
        self.raw = None  # release the cached buffer export first
        try:
            self.shm.close()
        except Exception:
            pass


class _SegmentToken:
    """Queues its segment name for reclaim when the last view dies.

    The token is attached to the bottom array of every decoded batch; numpy
    base chains keep it alive through arbitrary slicing, so reclaim can never
    race a reader still holding (a view of) the batch.  It also keeps the
    attachment mapped until that point.
    """

    __slots__ = ("segment", "releases", "attachment")

    def __init__(self, segment: str, releases: "deque", attachment: _Attachment):
        self.segment = segment
        self.releases = releases
        self.attachment = attachment

    def __del__(self):
        try:
            self.releases.append(self.segment)
            self.attachment.drop_lease()
        except Exception:
            pass


class _SegArray(np.ndarray):
    """ndarray subclass able to carry the segment token in its ``__dict__``."""


# --------------------------------------------------------------------------
# Endpoints
# --------------------------------------------------------------------------
class _Segment:
    __slots__ = ("shm", "name", "capacity", "refs", "raw")

    def __init__(self, shm: Any, name: str, capacity: int):
        self.shm = shm
        self.name = name
        self.capacity = capacity
        self.refs = 0  # in-flight batch refs the consumer has not released
        # Cached flat view for column writes: one buffer export per segment
        # lifetime instead of one per message.
        self.raw = np.frombuffer(shm.buf, dtype=np.uint8)


def _eligible_batch(batch: Any) -> bool:
    cols = getattr(batch, "_data", None)
    if not isinstance(cols, dict) or not cols:
        return False
    return all(
        isinstance(v, np.ndarray) and not v.dtype.hasobject for v in cols.values()
    )


def _align(n: int) -> int:
    return (n + _SHM_ALIGN - 1) & ~(_SHM_ALIGN - 1)


class ShmWriter:
    """Producer endpoint: owns the segment ring, encodes payloads.

    ``encode`` walks one RPC result (depth-limited through tuples/lists/
    dicts and ``MultiAgentBatch``), and when the eligible batches in it total
    at least ``threshold`` bytes, copies their columns into one free ring
    segment and substitutes header refs.  ``reclaim`` returns released
    segments to the free list; a full ring falls back to the pipe rather
    than block or grow without bound.
    """

    def __init__(
        self,
        prefix: str,
        threshold: int = 16 * 1024,
        min_segment: int = 1 << 20,
        max_segments: int = 16,
    ):
        self.prefix = prefix
        self.threshold = threshold
        self.min_segment = min_segment
        self.max_segments = max_segments
        self._segments: Dict[str, _Segment] = {}
        self._seq = itertools.count()
        self._retired: List[str] = []  # destroyed names the reader hasn't heard
        # All names ever destroyed: releases for these are in-flight races
        # (legitimate), anything else reaching reclaim() is a sanitizer
        # violation.  Bounded by segments_created, which the ring keeps small.
        self._destroyed: set = set()
        self.stats: Dict[str, int] = {
            "messages": 0,
            "shm_batches": 0,
            "bytes_shm": 0,
            "fallbacks": 0,
            "segments_created": 0,
        }

    # ------------------------------------------------------------ ring mgmt
    def _acquire(self, nbytes: int) -> Optional[_Segment]:
        free = [s for s in self._segments.values() if s.refs == 0]
        fitting = [s for s in free if s.capacity >= nbytes]
        if fitting:
            return min(fitting, key=lambda s: s.capacity)
        if len(self._segments) >= self.max_segments:
            # Recycle a too-small free segment into a bigger one if we can;
            # otherwise the ring is saturated -> pipe fallback (bounded).
            if not free:
                return None
            victim = max(free, key=lambda s: s.capacity)
            self._destroy(victim)
        return self._create(nbytes)

    def _create(self, nbytes: int) -> Optional[_Segment]:
        capacity = max(self.min_segment, 1 << max(12, int(nbytes - 1).bit_length()))
        name = f"{self.prefix}s{next(self._seq)}"
        try:
            shm = _open_shm(name, create=True, size=capacity)
        except FileExistsError:
            _unlink_by_name(name)
            try:
                shm = _open_shm(name, create=True, size=capacity)
            except Exception:
                return None
        except Exception:
            return None
        seg = _Segment(shm, name, capacity)
        self._segments[name] = seg
        self.stats["segments_created"] += 1
        return seg

    def _destroy(self, seg: _Segment) -> None:
        self._segments.pop(seg.name, None)
        self._retired.append(seg.name)
        self._destroyed.add(seg.name)
        seg.raw = None  # release the cached buffer export first
        try:
            seg.shm.close()
        except Exception:
            pass
        try:
            seg.shm.unlink()
        except Exception:
            pass

    def reclaim(self, names: List[str]) -> None:
        for n in names or ():
            seg = self._segments.get(n)
            if seg is not None and seg.refs > 0:
                seg.refs -= 1
            elif SANITIZER.enabled:
                # A release for a recycled segment is a legitimate race (the
                # ring destroyed it while the ref was in flight); anything
                # else is a refcount bug the silent ignore used to hide.
                if seg is not None:
                    SANITIZER.violation(
                        f"double-release: writer ring ref for segment {n} "
                        "released below zero"
                    )
                elif n not in self._destroyed:
                    SANITIZER.violation(
                        f"double-release: writer received a release for "
                        f"segment {n} it never created"
                    )

    def rollback(self, payload: Any) -> None:
        """Undo the refcounts of an encoded payload that never reached the
        consumer (pipe send failed): the consumer cannot release them.  The
        retirement notices ride again on the next message."""
        if not isinstance(payload, _ShmPayload):
            return
        self._retired.extend(payload.retired)
        refs: List[Any] = []
        _collect_refs(payload.tree, refs, 0)
        self.reclaim([r.segment for r in {id(r): r for r in refs}.values()])

    @property
    def num_segments(self) -> int:
        return len(self._segments)

    def segments_in_use(self) -> int:
        return sum(1 for s in self._segments.values() if s.refs > 0)

    # --------------------------------------------------------------- encode
    def encode(self, obj: Any) -> Any:
        self.stats["messages"] += 1
        collected: List[Any] = []
        _collect_batches(obj, collected, 0)
        # Dedup by identity: one ref (and one refcount) per distinct batch.
        batches = [b for b in {id(b): b for b in collected}.values() if _eligible_batch(b)]
        # Footprint must mirror the write loop exactly: offsets advance by
        # _align(col.nbytes) per column (offsets stay aligned), so the
        # per-COLUMN aligned sum is the capacity actually consumed.
        total = sum(
            _align(int(v.nbytes)) for b in batches for v in b._data.values()
        )
        if not batches or total < self.threshold:
            return obj
        seg = self._acquire(total)
        if seg is None:
            self.stats["fallbacks"] += 1
            return obj
        refs: Dict[int, _ShmBatchRef] = {}
        offset = 0
        for b in batches:
            cols: List[_ColumnRef] = []
            for k, v in b._data.items():
                v = np.ascontiguousarray(v)
                seg.raw[offset : offset + v.nbytes] = v.reshape(-1).view(np.uint8)
                cols.append(_ColumnRef(k, v.dtype.str, v.shape, offset, v.nbytes))
                offset = _align(offset + v.nbytes)
            refs[id(b)] = _ShmBatchRef(
                seg.name, cols, int(sum(c.nbytes for c in cols)),
                getattr(b, "created_at", None),
            )
        seg.refs += len(refs)
        self.stats["shm_batches"] += len(refs)
        self.stats["bytes_shm"] += total
        retired, self._retired = tuple(self._retired), []
        return _ShmPayload(_substitute(obj, refs, 0), retired)

    def close(self) -> None:
        for seg in list(self._segments.values()):
            self._destroy(seg)


def _collect_batches(obj: Any, out: List[Any], depth: int) -> None:
    if depth > 3:
        return
    if hasattr(obj, "_data") and hasattr(obj, "count"):  # SampleBatch-shaped
        out.append(obj)
        return
    pb = getattr(obj, "policy_batches", None)
    if isinstance(pb, dict):  # MultiAgentBatch
        for b in pb.values():
            _collect_batches(b, out, depth + 1)
        return
    if isinstance(obj, (tuple, list)):
        for x in obj:
            _collect_batches(x, out, depth + 1)
    elif isinstance(obj, dict):
        for x in obj.values():
            _collect_batches(x, out, depth + 1)


def _collect_refs(obj: Any, out: List[Any], depth: int) -> None:
    if depth > 4:
        return
    if isinstance(obj, _ShmBatchRef):
        out.append(obj)
    elif isinstance(obj, _ShmMultiRef):
        for v in obj.policy_refs.values():
            _collect_refs(v, out, depth + 1)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _collect_refs(x, out, depth + 1)
    elif isinstance(obj, dict):
        for x in obj.values():
            _collect_refs(x, out, depth + 1)


def _substitute(obj: Any, refs: Dict[int, _ShmBatchRef], depth: int) -> Any:
    if depth > 3:
        return obj
    if id(obj) in refs:
        return refs[id(obj)]
    pb = getattr(obj, "policy_batches", None)
    if isinstance(pb, dict):
        return _ShmMultiRef(
            {k: _substitute(v, refs, depth + 1) for k, v in pb.items()}
        )
    if isinstance(obj, tuple):
        return tuple(_substitute(x, refs, depth + 1) for x in obj)
    if isinstance(obj, list):
        return [_substitute(x, refs, depth + 1) for x in obj]
    if isinstance(obj, dict):
        return {k: _substitute(v, refs, depth + 1) for k, v in obj.items()}
    return obj


class ShmReader:
    """Consumer endpoint: maps segments, decodes headers into zero-copy
    views, queues refcount releases, and sweeps segments on close."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._attachments: Dict[str, Any] = {}  # name -> SharedMemory
        self._releases: "deque[str]" = deque()
        self.stats: Dict[str, int] = {"shm_batches": 0, "bytes_shm": 0}

    # --------------------------------------------------------------- decode
    def decode(self, payload: Any) -> Any:
        if not isinstance(payload, _ShmPayload):
            return payload
        for name in payload.retired:
            # The writer recycled this segment: drop our mapping (it closes
            # when the last outstanding lease dies).
            att = self._attachments.pop(name, None)
            if att is not None:
                att.discard()
        return self._decode_tree(payload.tree, 0, {})

    def _decode_tree(self, obj: Any, depth: int, memo: Dict[int, Any]) -> Any:
        if depth > 4:
            return obj
        if isinstance(obj, _ShmBatchRef):
            # Memoized by ref identity: a batch appearing twice in one
            # message decodes to one object with one release token, so the
            # writer's single refcount can never be released twice.
            if id(obj) not in memo:
                memo[id(obj)] = self._materialize(obj)
            return memo[id(obj)]
        if isinstance(obj, _ShmMultiRef):
            from repro_torch.rl.sample_batch import MultiAgentBatch

            return MultiAgentBatch(
                {k: self._decode_tree(v, depth + 1, memo) for k, v in obj.policy_refs.items()}
            )
        if isinstance(obj, tuple):
            return tuple(self._decode_tree(x, depth + 1, memo) for x in obj)
        if isinstance(obj, list):
            return [self._decode_tree(x, depth + 1, memo) for x in obj]
        if isinstance(obj, dict):
            return {k: self._decode_tree(v, depth + 1, memo) for k, v in obj.items()}
        return obj

    def _attach(self, name: str) -> _Attachment:
        att = self._attachments.get(name)
        if att is None:
            att = _Attachment(_open_shm(name))
            self._attachments[name] = att
        return att

    def _materialize(self, ref: _ShmBatchRef) -> Any:
        from repro_torch.rl.sample_batch import SampleBatch

        att = self._attach(ref.segment)
        att.add_lease()
        base = att.raw.view(_SegArray)
        base._token = _SegmentToken(ref.segment, self._releases, att)
        cols: Dict[str, np.ndarray] = {}
        for c in ref.columns:
            arr = (
                base[c.offset : c.offset + c.nbytes]
                .view(np.dtype(c.dtype))
                .reshape(c.shape)
            )
            # The segment is leased read-only to this consumer: an in-place
            # write would alias the ring slot, so surface it as an error.
            arr.flags.writeable = False
            cols[c.key] = arr
        batch = SampleBatch(cols)
        if ref.created_at is not None:
            batch.created_at = ref.created_at
        self.stats["shm_batches"] += 1
        self.stats["bytes_shm"] += ref.nbytes
        return batch

    # -------------------------------------------------------------- reclaim
    def drain_releases(self) -> List[str]:
        out: List[str] = []
        while True:
            try:
                out.append(self._releases.popleft())
            except IndexError:
                return out

    def close(self, unlink: bool = True) -> None:
        """Discard all mappings (each closes when its last lease dies); with
        ``unlink`` also sweep /dev/shm for this prefix, covering segments a
        killed producer never cleaned up.  Unlinking while leases are still
        mapped is safe on POSIX: the memory lives until the last view dies."""
        for att in self._attachments.values():
            att.discard()
        names = set(self._attachments)
        self._attachments.clear()
        if unlink:
            for name in names | set(list_segments(self.prefix)):
                _unlink_by_name(name)


class _IdentityEndpoint:
    """Pickle-pipe baseline: payloads pass through to the Connection."""

    prefix = ""
    stats: Dict[str, int] = {}

    def encode(self, obj: Any) -> Any:
        return obj

    def decode(self, obj: Any) -> Any:
        return obj

    def reclaim(self, names: List[str]) -> None:
        pass

    def rollback(self, payload: Any) -> None:
        pass

    def drain_releases(self) -> List[str]:
        return []

    def close(self, unlink: bool = True) -> None:
        pass


# --------------------------------------------------------------------------
# Length-prefixed frame codec (the inter-host wire; core.remote + chaos)
# --------------------------------------------------------------------------
_FRAME_HEADER = 8  # big-endian u64 body length
_FRAME_MAX = 1 << 32  # 4 GiB: anything larger is a corrupt/hostile header


class FrameError(RuntimeError):
    """The byte stream violated the framing protocol (corrupt header)."""


def encode_frame(obj: Any) -> bytes:
    """One message -> one length-prefixed frame (u64 big-endian + pickle,
    with ``dumps``'s tensor rule).

    The frame is self-delimiting, so frames can be concatenated on a TCP
    stream and recovered by ``FrameDecoder`` regardless of how the kernel
    splits them into reads.
    """
    import struct

    body = dumps(obj)
    if len(body) > _FRAME_MAX:
        raise FrameError(f"frame body of {len(body)} bytes exceeds protocol max")
    return struct.pack("!Q", len(body)) + body


class FrameDecoder:
    """Incremental frame parser: feed arbitrary chunks, get whole messages.

    TCP delivers a byte stream, not messages — one ``recv`` may carry half a
    header, three frames, or a header and part of a body.  ``feed`` buffers
    whatever arrives and yields each message exactly once, as soon as its
    last byte is in.  Pure function of the byte stream: no socket, no
    threads, so the round-trip property is testable byte-split by byte-split
    (``tests/test_transport_properties.py``).
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)

    def feed(self, chunk: bytes) -> List[Any]:
        import struct

        self._buf.extend(chunk)
        out: List[Any] = []
        while len(self._buf) >= _FRAME_HEADER:
            (size,) = struct.unpack_from("!Q", self._buf)
            if size > _FRAME_MAX:
                raise FrameError(f"frame header claims {size} bytes (max {_FRAME_MAX})")
            if len(self._buf) < _FRAME_HEADER + size:
                break
            body = bytes(self._buf[_FRAME_HEADER : _FRAME_HEADER + size])
            del self._buf[: _FRAME_HEADER + size]
            out.append(loads(body))
        return out


class _SocketBatchRef:
    """One SampleBatch flattened for the socket wire: column table + blob.

    Columns are packed contiguously (aligned like the shm layout) into one
    ``bytes`` blob so the frame pickles a single buffer instead of N arrays;
    ``created_at`` rides alongside so cross-fragment latency stamps survive
    the hop exactly as they do across the shm plane.
    """

    __slots__ = ("columns", "blob", "created_at")

    def __init__(self, columns: List[_ColumnRef], blob: bytes, created_at: Any):
        self.columns = columns
        self.blob = blob
        self.created_at = created_at

    def __getstate__(self):
        return (self.columns, self.blob, self.created_at)

    def __setstate__(self, state):
        self.columns, self.blob, self.created_at = state


class SocketWriter:
    """Producer endpoint for the socket plane: batches -> column-blob refs.

    Unlike ``ShmWriter`` there is no shared segment and no lease protocol —
    the bytes are copied onto the wire — so ``reclaim``/``rollback`` are
    no-ops and the endpoint is stateless beyond its stats.
    """

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.stats: Dict[str, int] = {"messages": 0, "socket_batches": 0, "bytes_socket": 0}

    def encode(self, obj: Any) -> Any:
        self.stats["messages"] += 1
        collected: List[Any] = []
        _collect_batches(obj, collected, 0)
        batches = [b for b in {id(b): b for b in collected}.values() if _eligible_batch(b)]
        if not batches:
            return obj
        refs: Dict[int, _SocketBatchRef] = {}
        for b in batches:
            cols: List[_ColumnRef] = []
            parts: List[bytes] = []
            offset = 0
            for k, v in b._data.items():
                v = np.ascontiguousarray(v)
                parts.append(v.tobytes())
                cols.append(_ColumnRef(k, v.dtype.str, v.shape, offset, v.nbytes))
                pad = _align(v.nbytes) - v.nbytes
                if pad:
                    parts.append(b"\x00" * pad)
                offset = _align(offset + v.nbytes)
            blob = b"".join(parts)
            refs[id(b)] = _SocketBatchRef(cols, blob, getattr(b, "created_at", None))
            self.stats["socket_batches"] += 1
            self.stats["bytes_socket"] += len(blob)
        return _substitute(obj, refs, 0)  # type: ignore[arg-type]

    def reclaim(self, names: List[str]) -> None:
        pass

    def rollback(self, payload: Any) -> None:
        pass

    def drain_releases(self) -> List[str]:
        return []

    def close(self, unlink: bool = True) -> None:
        pass


class SocketReader:
    """Consumer endpoint: rebuilds read-only column views over the blob."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.stats: Dict[str, int] = {"socket_batches": 0, "bytes_socket": 0}

    def decode(self, payload: Any) -> Any:
        return self._decode_tree(payload, 0, {})

    def _decode_tree(self, obj: Any, depth: int, memo: Dict[int, Any]) -> Any:
        if depth > 4:
            return obj
        if isinstance(obj, _SocketBatchRef):
            if id(obj) not in memo:
                memo[id(obj)] = self._materialize(obj)
            return memo[id(obj)]
        if isinstance(obj, _ShmMultiRef):
            from repro_torch.rl.sample_batch import MultiAgentBatch

            return MultiAgentBatch(
                {k: self._decode_tree(v, depth + 1, memo) for k, v in obj.policy_refs.items()}
            )
        if isinstance(obj, tuple):
            return tuple(self._decode_tree(x, depth + 1, memo) for x in obj)
        if isinstance(obj, list):
            return [self._decode_tree(x, depth + 1, memo) for x in obj]
        if isinstance(obj, dict):
            return {k: self._decode_tree(v, depth + 1, memo) for k, v in obj.items()}
        return obj

    def _materialize(self, ref: _SocketBatchRef) -> Any:
        from repro_torch.rl.sample_batch import SampleBatch

        base = np.frombuffer(ref.blob, dtype=np.uint8)  # bytes -> read-only view
        cols: Dict[str, np.ndarray] = {}
        for c in ref.columns:
            cols[c.key] = (
                base[c.offset : c.offset + c.nbytes]
                .view(np.dtype(c.dtype))
                .reshape(c.shape)
            )
        batch = SampleBatch(cols)
        if ref.created_at is not None:
            batch.created_at = ref.created_at
        self.stats["socket_batches"] += 1
        self.stats["bytes_socket"] += len(ref.blob)
        return batch

    def reclaim(self, names: List[str]) -> None:
        pass

    def rollback(self, payload: Any) -> None:
        pass

    def drain_releases(self) -> List[str]:
        return []

    def close(self, unlink: bool = True) -> None:
        pass


# --------------------------------------------------------------------------
# Transport specs (picklable configuration shipped into the child)
# --------------------------------------------------------------------------
class Transport:
    """Picklable spec describing how RPC payloads cross a process boundary.

    ``server_endpoint(prefix)`` is built in the producing (child) process,
    ``client_endpoint(prefix)`` in the consuming (driver) process; the pair
    shares only the name ``prefix`` and the control messages on the pipe.
    """

    name = "abstract"

    def server_endpoint(self, prefix: str) -> Any:
        raise NotImplementedError

    def client_endpoint(self, prefix: str) -> Any:
        raise NotImplementedError


class PickleTransport(Transport):
    """Baseline: every payload is pickled through the RPC pipe."""

    name = "pickle"

    def server_endpoint(self, prefix: str) -> _IdentityEndpoint:
        return _IdentityEndpoint()

    def client_endpoint(self, prefix: str) -> _IdentityEndpoint:
        return _IdentityEndpoint()


class SharedMemoryTransport(Transport):
    """Zero-copy data plane over ``multiprocessing.shared_memory`` rings."""

    name = "shm"

    def __init__(
        self,
        threshold: int = 16 * 1024,
        min_segment: int = 1 << 20,
        max_segments: int = 16,
    ):
        self.threshold = threshold
        self.min_segment = min_segment
        self.max_segments = max_segments

    def server_endpoint(self, prefix: str) -> ShmWriter:
        return ShmWriter(
            prefix,
            threshold=self.threshold,
            min_segment=self.min_segment,
            max_segments=self.max_segments,
        )

    def client_endpoint(self, prefix: str) -> ShmReader:
        return ShmReader(prefix)


class SocketTransport(Transport):
    """Inter-host data plane: payloads ride length-prefixed socket frames.

    The endpoint pair mirrors the shm transport's API (encode/decode/
    reclaim/rollback/drain_releases/close), so ``core.remote`` drives it
    exactly the way ``ProcessCell`` drives its transport — but the payload
    crosses a TCP stream (``encode_frame``/``FrameDecoder``), not a pipe,
    and batch columns travel as one contiguous blob per batch.  Shm refs
    must never reach this transport: a segment name is meaningless on
    another machine (the ``cross-host-placement`` flowcheck rule enforces
    the corresponding graph-level invariant).
    """

    name = "socket"

    def server_endpoint(self, prefix: str) -> SocketWriter:
        return SocketWriter(prefix)

    def client_endpoint(self, prefix: str) -> SocketReader:
        return SocketReader(prefix)


TRANSPORTS: Dict[str, Callable[[], Transport]] = {
    "pickle": PickleTransport,
    "shm": SharedMemoryTransport,
    "socket": SocketTransport,
}


def resolve_transport(transport: Any) -> Transport:
    """None -> SharedMemoryTransport (the fast default; it falls back to the
    pipe per-message); str -> registry lookup; instance passthrough."""
    if transport is None:
        return SharedMemoryTransport()
    if isinstance(transport, Transport):
        return transport
    if isinstance(transport, str):
        if transport not in TRANSPORTS:
            raise ValueError(
                f"unknown transport {transport!r}; known: {sorted(TRANSPORTS)}"
            )
        return TRANSPORTS[transport]()
    raise TypeError(f"transport must be None, str, or Transport (got {transport!r})")
