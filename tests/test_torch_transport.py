"""The port's data plane, held against the reference's transport suites.

The port's copies of ``tests/test_transport.py`` and
``tests/test_transport_properties.py`` over ``repro_torch.core.transport``:
shared-memory endpoint round trips, fallbacks, ring reuse and refcount
reclaim; the StubWorker stream byte-identical across thread, process-pickle
and process-shm; kills mid-transfer that leak no ``/dev/shm`` segment; the
``SampleBatch`` algebra and the socket frame codec under hypothesis.

Port-only:

* the tensor boundary: a tensor crosses every transport as host bytes and
  lands, bitwise, on the device it left (here the CPU; ``chip_smoke.py``
  holds CUDA tensors on the card); no message carries torch's
  multiprocessing reducers; 200 weight syncs through process-pickle and
  process-shm leave the driver's open file descriptors unchanged;
* the frame codec across packages: the port's ``FrameDecoder`` reads the
  reference's ``encode_frame`` of plain numpy payloads, and the reverse;
* ``SampleBatch.concat_samples`` of one schema round-trips, and parts of
  differing schemas raise ``TypeError`` naming the column, where the
  reference promotes dtypes (its ``test_concat_then_reslice_recovers_parts``
  fails on exactly that);
* the lease sanitizer of the port's transport, driven directly.
"""

import functools
import gc
import os

import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis", reason="property-based tests need hypothesis")
from hypothesis import given, settings, strategies as st

import torch_chaos as chaos
from conftest import DeterministicClock
from repro_torch.core import ProcessBackend, VirtualActor, WorkerSet, list_segments
from repro_torch.core.operators import ParallelRollouts
from repro_torch.core.transport import (
    SANITIZER,
    FrameDecoder,
    PickleTransport,
    SharedMemoryTransport,
    ShmLeaseViolation,
    ShmReader,
    ShmWriter,
    SocketTransport,
    dumps,
    encode_frame,
    loads,
    resolve_transport,
)
from repro_torch.rl.rollout_worker import EPS_STRIDE, MAX_LANES, assemble_fragments
from repro_torch.rl.sample_batch import MultiAgentBatch, SampleBatch
from repro_torch.tree import tree_leaves

wait_until = DeterministicClock.wait_until

BACKEND_MATRIX = chaos.BACKEND_MATRIX
make_backend = chaos.make_backend
TRANSPORTS = ["pickle", "shm"]
BIG = 8192  # 96KB payloads: well above the shm threshold
big_stub_factory = functools.partial(chaos.StubWorker, batch_size=BIG)


# Segment-name prefixes of this file start with ``PT``, which holds this
# process's id: ``list_segments``, the reader's sweep and the sanitizer match
# by prefix, so no other run of these suites (another xdist worker, or another
# checkout's run on the same machine) can see, unlink or count these names,
# and no prefix of the reference's transport suites may match them either.
PT = f"pt{os.getpid()}x"


def pipe_trip(obj):
    """Simulate the control-message hop (the pipe's pickling)."""
    return loads(dumps(obj))


@pytest.fixture
def endpoints():
    writer = ShmWriter(PT + "shm", threshold=1024)
    reader = ShmReader(PT + "shm")
    yield writer, reader
    reader.close()
    writer.close()
    assert list_segments(PT + "shm") == [], "endpoint fixture leaked segments"


# ================================================================ endpoints
def test_roundtrip_preserves_dtypes_shapes_values(endpoints):
    writer, reader = endpoints
    batch = SampleBatch(
        {
            "obs": np.arange(4096, dtype=np.float64).reshape(512, 8),
            "actions": np.arange(512, dtype=np.int32),
            "dones": np.zeros(512, dtype=bool),
            "bytes": np.full((512,), 7, dtype=np.uint8),
        }
    )
    out = reader.decode(pipe_trip(writer.encode(batch)))
    assert set(out.keys()) == set(batch.keys())
    for k in batch:
        assert out[k].dtype == batch[k].dtype and out[k].shape == batch[k].shape
        np.testing.assert_array_equal(out[k], batch[k])
    assert out.created_at == batch.created_at


def test_small_batches_fall_back_to_pipe(endpoints):
    writer, reader = endpoints
    batch = SampleBatch({"obs": np.arange(4, dtype=np.float32)})
    wire = writer.encode(batch)
    assert wire is batch
    assert reader.decode(pipe_trip(wire))["obs"].tolist() == batch["obs"].tolist()


def test_non_batch_payloads_pass_through(endpoints):
    writer, reader = endpoints
    for payload in ({"a": 1}, "text", 7, None, [1, 2], (3, "x")):
        assert reader.decode(pipe_trip(writer.encode(payload))) == payload


def test_object_dtype_columns_fall_back(endpoints):
    writer, _ = endpoints
    batch = SampleBatch({"obs": np.array([{"d": 1}, {"d": 2}], dtype=object)})
    assert writer.encode(batch) is batch


def test_tuple_and_multiagent_payloads(endpoints):
    writer, reader = endpoints
    b1 = SampleBatch({"obs": np.arange(2048, dtype=np.float64)})
    mab = MultiAgentBatch(
        {
            "ppo": SampleBatch({"obs": np.arange(2048, dtype=np.float32)}),
            "dqn": SampleBatch({"obs": np.arange(2048, dtype=np.int64)}),
        }
    )
    out_b1, out_mab, tag = reader.decode(pipe_trip(writer.encode((b1, mab, "tag"))))
    np.testing.assert_array_equal(out_b1["obs"], b1["obs"])
    assert tag == "tag"
    assert isinstance(out_mab, MultiAgentBatch)
    for pid in ("ppo", "dqn"):
        np.testing.assert_array_equal(out_mab.policy_batches[pid]["obs"], mab.policy_batches[pid]["obs"])


def test_ring_reuse_and_refcount_reclaim(endpoints):
    writer, reader = endpoints
    held = reader.decode(pipe_trip(writer.encode(SampleBatch({"obs": np.arange(4096, dtype=np.float64)}))))
    held_view = held["obs"][10:20]
    first_segment = writer.num_segments
    snapshots = []
    del held
    gc.collect()
    for i in range(6):
        b = reader.decode(pipe_trip(writer.encode(
            SampleBatch({"obs": np.full(4096, float(i), dtype=np.float64)})
        )))
        snapshots.append(b["obs"][0])
        del b
        gc.collect()
        writer.reclaim(reader.drain_releases())
    assert snapshots == [float(i) for i in range(6)]
    np.testing.assert_array_equal(held_view, np.arange(10, 20, dtype=np.float64))
    del held_view
    gc.collect()
    writer.reclaim(reader.drain_releases())
    assert writer.segments_in_use() == 0
    assert writer.num_segments <= first_segment + 2


def test_saturated_ring_falls_back_instead_of_growing():
    writer = ShmWriter(PT + "sat", threshold=64, max_segments=2)
    reader = ShmReader(PT + "sat")
    batches = [
        reader.decode(pipe_trip(writer.encode(SampleBatch({"obs": np.arange(1024, dtype=np.float64)}))))
        for _ in range(5)  # reader never releases: ring saturates at 2
    ]
    assert writer.num_segments <= 2
    assert writer.stats["fallbacks"] >= 3
    for b in batches:
        np.testing.assert_array_equal(b["obs"], np.arange(1024, dtype=np.float64))
    del batches
    gc.collect()
    reader.close()
    writer.close()
    assert list_segments(PT + "sat") == []


def test_capacity_sizing_matches_write_layout():
    writer = ShmWriter(PT + "cap", threshold=1, min_segment=4096)
    reader = ShmReader(PT + "cap")
    try:
        for rows in (507, 508, 509, 510, 511, 512):
            batch = SampleBatch(
                {
                    "obs": np.arange(rows, dtype=np.float64),
                    "a": np.arange(rows, dtype=np.uint8)[:rows],
                    "b": np.ones(rows, dtype=np.uint8),
                }
            )
            out = reader.decode(pipe_trip(writer.encode(batch)))
            for k in batch:
                np.testing.assert_array_equal(out[k], batch[k])
            del out
            gc.collect()
            writer.reclaim(reader.drain_releases())
    finally:
        reader.close()
        writer.close()


def test_reader_drops_attachments_for_retired_segments():
    writer = ShmWriter(PT + "ret", threshold=1, min_segment=4096, max_segments=1)
    reader = ShmReader(PT + "ret")
    try:
        def trip(rows):
            out = reader.decode(pipe_trip(writer.encode(SampleBatch({"obs": np.zeros(rows, np.float64)}))))
            del out
            gc.collect()
            writer.reclaim(reader.drain_releases())

        trip(256)
        trip(256)
        for _ in range(2):
            trip(4096)
        assert writer.stats["segments_created"] == 2
        assert set(reader._attachments) <= set(writer._segments)
        assert len(reader._attachments) == 1
    finally:
        reader.close()
        writer.close()
        assert list_segments(PT + "ret") == []


def test_learner_copies_read_only_shared_memory_columns(endpoints):
    """A batch decoded from shared memory has read-only columns (views into
    a ring slot); the learner's CPU tensors are copies, never aliases."""
    from repro_torch.rl.rollout_worker import _device_batch

    writer, reader = endpoints
    batch = reader.decode(pipe_trip(writer.encode(
        SampleBatch({"obs": np.arange(4096.0), "eps_id": np.arange(4096)})
    )))
    assert not batch["obs"].flags.writeable
    cols = _device_batch(batch, torch.device("cpu"))
    assert set(cols) == {"obs"}  # eps_id is a host column
    assert not np.shares_memory(cols["obs"].numpy(), batch["obs"])
    np.testing.assert_array_equal(cols["obs"].numpy(), batch["obs"])
    del batch, cols
    gc.collect()
    writer.reclaim(reader.drain_releases())


@pytest.mark.skipif(not os.path.isdir("/dev/shm"), reason="needs POSIX shared memory")
def test_sweep_unlinks_a_segment_its_producer_never_sized():
    """A producer killed between creating a segment and sizing it leaves 0
    bytes under its name; attaching to that fails, so the reader's sweep
    unlinks by name (the reference's attach-then-unlink leaks it)."""
    import _posixshmem

    fd = _posixshmem.shm_open(f"/{PT}unsizeds0", os.O_CREAT | os.O_RDWR, mode=0o600)
    os.close(fd)
    try:
        assert list_segments(PT + "unsized") == [PT + "unsizeds0"]
        ShmReader(PT + "unsized").close(unlink=True)
        assert list_segments(PT + "unsized") == []
    finally:
        try:
            _posixshmem.shm_unlink(f"/{PT}unsizeds0")
        except FileNotFoundError:
            pass


def test_resolve_transport():
    assert isinstance(resolve_transport(None), SharedMemoryTransport)
    assert isinstance(resolve_transport("pickle"), PickleTransport)
    assert isinstance(resolve_transport("socket"), SocketTransport)
    t = SharedMemoryTransport(threshold=1)
    assert resolve_transport(t) is t
    with pytest.raises(ValueError, match="unknown transport"):
        resolve_transport("carrier-pigeon")
    with pytest.raises(TypeError):
        resolve_transport(42)


def test_lease_sanitizer_passes_a_clean_epoch_and_catches_a_leak():
    """The port's sanitizer, driven directly: a round trip whose batch dies
    closes clean; a lease still held at the epoch's end is reported."""
    SANITIZER.begin_epoch("clean")
    writer, reader = ShmWriter(PT + "san", threshold=1), ShmReader(PT + "san")
    out = reader.decode(pipe_trip(writer.encode(SampleBatch({"obs": np.arange(64.0)}))))
    del out
    gc.collect()
    writer.reclaim(reader.drain_releases())
    reader.close()
    writer.close()
    SANITIZER.end_epoch(PT + "san")

    SANITIZER.begin_epoch("leak")
    writer, reader = ShmWriter(PT + "san", threshold=1), ShmReader(PT + "san")
    held = reader.decode(pipe_trip(writer.encode(SampleBatch({"obs": np.arange(64.0)}))))
    with pytest.raises(ShmLeaseViolation, match="leaked lease"):
        SANITIZER.end_epoch(PT + "san")
    del held
    gc.collect()
    reader.close()
    writer.close()
    assert list_segments(PT + "san") == []


# =========================================================== backend matrix
def _take_big(param, n=8):
    ws = WorkerSet.create(big_stub_factory, 2, backend=make_backend(param))
    try:
        it = ParallelRollouts(ws, mode="raw").gather_sync()
        return [np.asarray(b["obs"]).copy() for b in it.take(n)]
    finally:
        ws.stop()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("backend_param", BACKEND_MATRIX)
def test_large_batch_stream_identical_across_backends(backend_param):
    """The thread stream is byte-identical under both process transports,
    and equal to the reference's thread stream."""
    import chaos as ref_chaos
    import repro.core as rc

    ref_ws = rc.WorkerSet.create(
        functools.partial(ref_chaos.StubWorker, batch_size=BIG), 2, backend="thread"
    )
    try:
        want = [np.asarray(b["obs"]).copy() for b in rc.ParallelRollouts(ref_ws, mode="raw").gather_sync().take(8)]
    finally:
        ref_ws.stop()
    ref = _take_big("thread")
    got = _take_big(backend_param)
    assert len(ref) == len(got) == len(want)
    for r, g, w in zip(ref, got, want):
        np.testing.assert_array_equal(r, g)
        np.testing.assert_array_equal(g, w)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_kill_mid_transfer_reclaims_segments(transport):
    """Terminate a worker process mid-stream: the driver sweeps its
    segments and the stream keeps flowing from the survivor."""
    ws = WorkerSet.create(
        big_stub_factory, 2, backend=ProcessBackend(transport=transport), failure_policy="drop_shard",
    )
    prefixes = [a._cell._prefix_base for a in ws.remote_workers()]
    it = iter(ParallelRollouts(ws, mode="async", num_async=2))
    first = [next(it) for _ in range(4)]
    assert all(b.count == BIG for b in first)
    victim = ws.remote_workers()[0]
    prefix = victim._cell._prefix_base
    victim.kill()
    survivors = [next(it) for _ in range(8)]
    by_worker = [int(np.asarray(b["obs"])[0]) // 10_000_000 for b in survivors]
    assert by_worker.count(1) <= 2
    assert set(by_worker[-3:]) == {2}, "stream did not shrink to the survivor"
    del first, survivors, it
    gc.collect()
    assert list_segments(prefix) == [], "killed worker leaked shm segments"
    ws.stop()
    for p in prefixes:
        assert list_segments(p) == []


@pytest.mark.timeout(120)
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_drop_shard_via_injected_fault_under_transport(transport):
    factory = chaos.ChaosFactory(
        big_stub_factory,
        {1: [chaos.RaiseOnNth("sample", n=3, sticky=True, message="mid-transfer")]},
        seed=11,
    )
    ws = WorkerSet.create(
        factory, 2, backend=ProcessBackend(transport=transport), failure_policy="drop_shard",
    )
    prefixes = [a._cell._prefix_base for a in ws.remote_workers()]
    stream = ParallelRollouts(ws, mode="async", num_async=1)
    it = iter(stream)
    got = []
    assert wait_until(
        lambda: stream.metrics.counters["num_shards_dropped"] >= 1 or got.append(next(it)),
        timeout=30.0, interval=0.0,
    )
    assert stream.metrics.counters["num_shards_dropped"] == 1
    after = [next(it) for _ in range(6)]
    by_worker = [int(np.asarray(b["obs"])[0]) // 10_000_000 for b in got + after]
    assert by_worker.count(1) <= 2
    assert by_worker[-4:] == [2, 2, 2, 2] or by_worker[-3:] == [2, 2, 2]
    del got, after, it
    gc.collect()
    ws.stop()
    for prefix in prefixes:
        assert list_segments(prefix) == []


@pytest.mark.timeout(120)
def test_worker_restart_does_not_leak_generations():
    ws = WorkerSet.create(
        big_stub_factory, 1, backend=ProcessBackend(transport="shm"), max_restarts=1, backoff_base=0.0,
    )
    actor = ws.remote_workers()[0]
    prefix = actor._cell._prefix_base
    b = actor.sync("sample")
    del b
    gc.collect()
    actor.kill()
    actor.restart(timeout=10.0)
    b2 = actor.sync("sample")
    assert b2.count == BIG
    live = list_segments(prefix)
    assert all("g2" in name.split(prefix)[-1] for name in live), live
    del b2
    gc.collect()
    ws.stop()
    assert list_segments(prefix) == []


@pytest.mark.timeout(120)
def test_port_segments_never_match_the_reference_prefix():
    """The port's process cells name their segments under ``rpt``, not the
    reference's ``rfl``: the reference's sweep and lease sanitizer match by
    prefix and, run beside the port, would count (and unlink) live port
    segments as leaks."""
    from repro.core.transport import list_segments as ref_list_segments

    ws = WorkerSet.create(big_stub_factory, 1, backend=ProcessBackend(transport="shm"))
    try:
        (actor,) = ws.remote_workers()
        batch = actor.sync("sample")  # holds a live segment of the cell
        prefix = actor._cell._prefix_base
        live = list_segments(prefix)
        assert prefix.startswith("rpt") and live
        assert not set(live) & set(ref_list_segments("rfl"))
        del batch
        gc.collect()
    finally:
        ws.stop()


@pytest.mark.timeout(120)
def test_weight_sync_and_learning_under_shm():
    ws = WorkerSet.create(big_stub_factory, 2, backend=ProcessBackend(transport="shm"))
    prefixes = [a._cell._prefix_base for a in ws.remote_workers()]
    batch = ws.remote_workers()[0].sync("sample")
    assert ws.local_worker().learn_on_batch(batch)["trained"] == BIG
    ws.sync_weights()
    w = ws.remote_workers()[1].sync("get_weights")
    np.testing.assert_array_equal(np.asarray(w), ws.local_worker().get_weights())
    del batch
    gc.collect()
    ws.stop()
    for p in prefixes:
        assert list_segments(p) == []


# ========================================================= tensor boundary
def _tensor_payload():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(5, 3, generator=g),
        "f64": torch.randn(4, generator=g, dtype=torch.float64),
        "i64": torch.arange(7),
        "bool": torch.tensor([True, False]),
        "bf16": torch.randn(6, generator=g).to(torch.bfloat16),
        "scalar": torch.tensor(2.5),
        "empty": torch.empty(0, 4),
        "strided": torch.arange(12.0).reshape(3, 4).t(),
        "param": torch.nn.Parameter(torch.ones(3)),
        "nested": [torch.zeros(2), (torch.ones(1, dtype=torch.int32), "tag")],
        "array": np.arange(3.0),
    }


def _assert_same(got, want):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor)
        assert got.dtype == want.dtype and got.shape == want.shape and got.device == want.device
        assert got.requires_grad == want.requires_grad
        assert torch.equal(got.detach(), want.detach())
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_dumps_carries_tensors_as_host_bytes_never_torch_reducers():
    """A tensor crosses as a numpy array plus dtype, shape and device: the
    message names no torch reducer (torch's ForkingPickler one would carry
    a file descriptor or a CUDA IPC handle)."""
    from multiprocessing.reduction import ForkingPickler

    payload = _tensor_payload()
    data = dumps(payload)
    assert b"torch.multiprocessing" not in data and b"rebuild_" not in data
    assert b"_tensor_from_wire" in data
    assert b"torch.multiprocessing" in bytes(ForkingPickler.dumps(torch.zeros(3)))
    _assert_same(loads(data), payload)
    _assert_same(FrameDecoder().feed(encode_frame(payload))[0], payload)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("backend_param", ["process-pickle", "process-shm", "remote-socket"])
def test_tensors_arrive_bitwise_on_the_device_they_left(backend_param):
    """Through each transport, tensors in arguments and results arrive
    bitwise, with their dtype, shape and device (the CPU here)."""
    from repro_torch.core import RemoteBackend, start_local_host

    handle = None
    if backend_param == "remote-socket":
        handle = start_local_host()
        backend = RemoteBackend(address=handle.address)
    else:
        backend = make_backend(backend_param)
    a = VirtualActor(factory=functools.partial(chaos.make_tensor_worker, 1), backend=backend)
    try:
        payload = _tensor_payload()
        _assert_same(a.sync("echo", payload), payload)
        assert set(a.sync("devices", payload)) == {"cpu"}
        w = a.sync("get_weights")
        _assert_same(w, chaos.TensorWorker(1).get_weights())
        a.sync("set_weights", {k: v + 1 for k, v in w.items()})
        _assert_same(a.sync("get_weights"), {k: v + 1 for k, v in w.items()})
        assert a._cell.wire_bytes["sent"] > 0 and a._cell.wire_bytes["received"] > 0
    finally:
        a.stop()
        if handle is not None:
            handle.stop()


def _open_fds():
    return len(os.listdir("/proc/self/fd"))


@pytest.mark.skipif(not os.path.isdir("/proc/self/fd"), reason="needs /proc/self/fd")
@pytest.mark.timeout(180)
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_200_weight_syncs_leave_the_driver_fds_unchanged(transport):
    """200 broadcasts of a PPO worker's torch weights to 2 process workers
    open no descriptor in the driver (torch's reducers would pass one per
    CPU tensor), and every remote ends with the local weights."""
    ws = WorkerSet.create(chaos.make_ppo_worker, 2, backend=ProcessBackend(transport=transport))
    try:
        ws.sync_weights()  # warm: both children built, pipes open
        gc.collect()
        before = _open_fds()
        local = ws.local_worker()
        for i in range(200):
            if i % 50 == 0:  # move the weights so that each sync carries new values
                with torch.no_grad():
                    for t in tree_leaves(local.params):
                        t.add_(0.01)
            ws.sync_weights()
        gc.collect()
        assert _open_fds() == before
        want = local.get_weights()
        for a in ws.remote_workers():
            _assert_same(a.sync("get_weights"), want)
    finally:
        ws.stop()


# ============================================== frame codec across packages
PLAIN_PAYLOADS = [
    {"obs": np.arange(12, dtype=np.float32).reshape(3, 4), "step": 7},
    ("sample", np.array([1, 2, 3], np.int64), None, True),
    [np.zeros((0, 2), np.float64), "x" * 100, {"nested": np.ones(5, np.uint8)}],
]


def _plain_equal(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, dict):
        return set(a) == set(b) and all(_plain_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_plain_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_frames_cross_between_the_packages_both_ways():
    """The wire format is the reference's: its frames decode in the port and
    the port's frames of plain numpy payloads decode in the reference, byte
    split or whole."""
    from repro.core.transport import FrameDecoder as RefDecoder
    from repro.core.transport import encode_frame as ref_encode

    ref_stream = b"".join(ref_encode(p) for p in PLAIN_PAYLOADS)
    port_stream = b"".join(encode_frame(p) for p in PLAIN_PAYLOADS)
    assert port_stream == ref_stream  # same pickle of the same plain objects
    for stream, decoder in ((ref_stream, FrameDecoder()), (port_stream, RefDecoder())):
        out = []
        for i in range(0, len(stream), 37):
            out.extend(decoder.feed(stream[i : i + 37]))
        assert len(out) == len(PLAIN_PAYLOADS)
        assert all(_plain_equal(a, b) for a, b in zip(out, PLAIN_PAYLOADS))
        assert decoder.pending_bytes == 0


# ========================================== concat_samples: one schema only
def test_concat_samples_raises_on_mixed_schemas_naming_the_column():
    a = SampleBatch({"obs": np.zeros((2, 3), np.float32), "act": np.zeros(2, np.int32)})
    with pytest.raises(TypeError, match="'act'.*int32.*int64"):
        SampleBatch.concat_samples([a, SampleBatch({"obs": np.zeros((1, 3), np.float32),
                                                    "act": np.zeros(1, np.int64)})])
    with pytest.raises(TypeError, match="'obs'.*trailing shape"):
        SampleBatch.concat_samples([a, SampleBatch({"obs": np.zeros((1, 4), np.float32),
                                                    "act": np.zeros(1, np.int32)})])
    with pytest.raises(TypeError, match="'act' is only in part 0"):
        SampleBatch.concat_samples([a, SampleBatch({"obs": np.zeros((1, 3), np.float32)})])
    with pytest.raises(TypeError, match="'extra' is only in part 1"):
        SampleBatch.concat_samples([a, SampleBatch({"obs": np.zeros((1, 3), np.float32),
                                                    "act": np.zeros(1, np.int32),
                                                    "extra": np.zeros(1)})])
    # Empty parts carry no schema and are skipped, as before.
    out = SampleBatch.concat_samples([SampleBatch(), a, a])
    assert out.count == 4 and out["act"].dtype == np.int32


def test_reference_promotes_mixed_dtypes_where_the_port_raises():
    """The deliberate difference, shown: float32 + int32 parts come out
    float64 from the reference; the port names the column instead."""
    from repro.rl.sample_batch import SampleBatch as RefBatch

    parts = [{"c": np.ones(2, np.float32)}, {"c": np.ones(3, np.int32)}]
    assert RefBatch.concat_samples([RefBatch(p) for p in parts])["c"].dtype == np.float64
    with pytest.raises(TypeError, match="'c'"):
        SampleBatch.concat_samples([SampleBatch(p) for p in parts])


# ============================================ properties (hypothesis)
DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_]


@st.composite
def batches(draw, min_rows=1, max_rows=64):
    n = draw(st.integers(min_value=min_rows, max_value=max_rows))
    n_cols = draw(st.integers(min_value=1, max_value=4))
    data = {}
    for i in range(n_cols):
        dtype = draw(st.sampled_from(DTYPES))
        extra = draw(st.sampled_from([(), (3,), (2, 2)]))
        shape = (n,) + extra
        rng = np.random.default_rng(draw(st.integers(min_value=0, max_value=2**31 - 1)))
        if dtype == np.bool_:
            col = rng.integers(0, 2, size=shape).astype(bool)
        elif np.issubdtype(dtype, np.floating):
            col = rng.standard_normal(shape).astype(dtype)
        else:
            col = rng.integers(-100, 100, size=shape).astype(dtype)
        data[f"c{i}"] = col
    return SampleBatch(data)


def assert_batches_equal(a, b):
    assert set(a.keys()) == set(b.keys())
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def schema(b):
    return {k: (b[k].dtype, b[k].shape[1:]) for k in b.keys()}


@given(batches(), st.data())
@settings(max_examples=50, deadline=None)
def test_slice_concat_roundtrip(batch, data):
    cut = data.draw(st.integers(min_value=0, max_value=batch.count))
    left, right = batch.slice(0, cut), batch.slice(cut, batch.count)
    assert left.count + right.count == batch.count
    back = SampleBatch.concat_samples([left, right])
    assert_batches_equal(batch, back)
    assert back.created_at == batch.created_at


@given(st.lists(batches(max_rows=16), min_size=1, max_size=5))
@settings(max_examples=50, deadline=None)
def test_concat_then_reslice_recovers_parts(parts):
    """The reference's property over parts of ONE schema (it filters on
    the key set only, and fails on promoted dtypes); parts of another
    schema raise ``TypeError``."""
    one = [b for b in parts if schema(b) == schema(parts[0])]
    merged = SampleBatch.concat_samples(one)
    assert merged.count == sum(b.count for b in one)
    start = 0
    for b in one:
        assert_batches_equal(merged.slice(start, start + b.count), b)
        start += b.count
    if len(one) < len(parts):
        with pytest.raises(TypeError, match="concat_samples: column"):
            SampleBatch.concat_samples(parts)


@given(st.lists(st.integers(min_value=0, max_value=3), min_size=1, max_size=40))
@settings(max_examples=50, deadline=None)
def test_split_by_episode_partitions(eps_ids):
    eps = np.asarray(sorted(eps_ids))
    batch = SampleBatch({"eps_id": eps, "obs": np.arange(len(eps), dtype=np.float32)})
    episodes = batch.split_by_episode()
    assert sum(e.count for e in episodes) == batch.count
    for e in episodes:
        assert len(set(e["eps_id"].tolist())) == 1
    assert_batches_equal(batch, SampleBatch.concat_samples(episodes))


@st.composite
def rollout_cols(draw):
    T = draw(st.integers(min_value=2, max_value=8))
    B = draw(st.integers(min_value=1, max_value=4))
    rng = np.random.default_rng(draw(st.integers(min_value=0, max_value=2**31 - 1)))
    worker = draw(st.integers(min_value=0, max_value=3))
    dones = rng.random((T, B)) < 0.3
    eps_count = np.zeros((T, B), np.int32)
    eps_count[1:] = np.cumsum(dones[:-1], axis=0).astype(np.int32)
    cols = {
        "obs": rng.standard_normal((T, B, 3)).astype(np.float32),
        "rewards": rng.standard_normal((T, B)).astype(np.float32),
        "dones": dones.astype(np.float32),
        "actions": rng.integers(0, 2, (T, B)).astype(np.int32),
        "eps_count": eps_count,
    }
    lane_base = worker * MAX_LANES + np.arange(B, dtype=np.int64)
    return cols, lane_base, T, B


@given(rollout_cols())
@settings(max_examples=50, deadline=None)
def test_assembler_preserves_traces_and_dtypes(data):
    cols, lane_base, T, B = data
    batch = assemble_fragments(cols, lane_base)
    assert batch.count == T * B
    assert batch["eps_id"].dtype == np.int64
    time_major_obs = cols["obs"].swapaxes(0, 1)
    for lane in range(B):
        trace = batch["eps_id"][lane * T : (lane + 1) * T]
        assert np.all(np.diff(trace) >= 0)
        assert np.all(trace // EPS_STRIDE == lane_base[lane])
        np.testing.assert_array_equal(batch["obs"][lane * T : (lane + 1) * T], time_major_obs[lane])
    for k in ("obs", "rewards", "dones", "actions"):
        assert batch[k].dtype == cols[k].dtype


@given(rollout_cols())
@settings(max_examples=50, deadline=None)
def test_assembler_episode_split_concat_roundtrip(data):
    cols, lane_base, _T, _B = data
    batch = assemble_fragments(cols, lane_base)
    frags = batch.split_by_episode()
    assert sum(f.count for f in frags) == batch.count
    for f in frags:
        assert len(np.unique(f["eps_id"])) == 1
        assert f.created_at == batch.created_at
    back = SampleBatch.concat_samples(frags)
    assert_batches_equal(batch, back)
    assert back.created_at == batch.created_at


@given(rollout_cols(), st.data())
@settings(max_examples=50, deadline=None)
def test_assembler_shard_respects_trace_boundaries(data, sdata):
    cols, lane_base, T, B = data
    batch = assemble_fragments(cols, lane_base)
    n = sdata.draw(st.sampled_from([d for d in range(1, B + 1) if B % d == 0]), label="shards")
    shards = batch.shard(n)
    lanes_per = B // n
    for s_i, sh in enumerate(shards):
        assert sh.count == lanes_per * T
        assert sh.created_at == batch.created_at
        for j in range(lanes_per):
            lane = s_i * lanes_per + j
            np.testing.assert_array_equal(
                sh["eps_id"][j * T : (j + 1) * T], batch["eps_id"][lane * T : (lane + 1) * T]
            )
        for k in batch:
            assert sh[k].dtype == batch[k].dtype
    assert_batches_equal(batch, SampleBatch.concat_samples(shards))


@given(batches(), st.booleans())
@settings(max_examples=50, deadline=None)
def test_encode_decode_preserves_everything(batch, as_tuple):
    writer = ShmWriter(PT + "hyp1", threshold=1)
    reader = ShmReader(PT + "hyp1")
    try:
        payload = (batch, {"n": batch.count}) if as_tuple else batch
        wire = loads(dumps(writer.encode(payload)))
        out = reader.decode(wire)
        out_batch = out[0] if as_tuple else out
        assert_batches_equal(batch, out_batch)
        if as_tuple:
            assert out[1] == {"n": batch.count}
    finally:
        del out, out_batch, wire
        gc.collect()
        reader.close()
        writer.close()
        assert list_segments(PT + "hyp1") == []


@given(st.lists(batches(max_rows=16), min_size=1, max_size=4), st.data())
@settings(max_examples=30, deadline=None)
def test_reclaim_never_corrupts_held_batches(parts, data):
    writer = ShmWriter(PT + "hyp2", threshold=1, max_segments=3)
    reader = ShmReader(PT + "hyp2")
    held = {}
    try:
        for i, b in enumerate(parts):
            out = reader.decode(loads(dumps(writer.encode(b))))
            held[i] = (b, out)
            if data.draw(st.booleans(), label=f"release_{i}"):
                del held[i]
                gc.collect()
            writer.reclaim(reader.drain_releases())
        for original, decoded in held.values():
            assert_batches_equal(original, decoded)
    finally:
        held.clear()
        gc.collect()
        reader.close()
        writer.close()
        assert list_segments(PT + "hyp2") == []


def chunked(blob, cuts):
    points = sorted({c % (len(blob) + 1) for c in cuts})
    pieces, start = [], 0
    for p in points:
        if p > start:
            pieces.append(blob[start:p])
            start = p
    pieces.append(blob[start:])
    return [p for p in pieces if p]


@given(
    st.lists(
        st.one_of(
            st.integers(min_value=-(2**40), max_value=2**40),
            st.text(max_size=32),
            st.binary(max_size=64),
            st.dictionaries(st.text(max_size=8), st.integers(), max_size=4),
            st.tuples(st.text(max_size=8), st.integers(), st.booleans()),
        ),
        min_size=1,
        max_size=6,
    ),
    st.lists(st.integers(min_value=0, max_value=2**16), max_size=24),
)
@settings(max_examples=100, deadline=None)
def test_frame_roundtrip_over_arbitrary_splits(objs, cuts):
    stream = b"".join(encode_frame(o) for o in objs)
    dec = FrameDecoder()
    out = []
    for piece in chunked(stream, cuts):
        out.extend(dec.feed(piece))
    assert out == objs
    assert dec.pending_bytes == 0


@given(batches(), st.lists(st.integers(min_value=0, max_value=2**20), max_size=16))
@settings(max_examples=50, deadline=None)
def test_socket_transport_roundtrip_preserves_batches(batch, cuts):
    spec = SocketTransport()
    writer = spec.server_endpoint(PT + "sock")
    reader = spec.client_endpoint(PT + "sock")
    stream = encode_frame(writer.encode((batch, {"n": batch.count})))
    dec = FrameDecoder()
    frames = []
    for piece in chunked(stream, cuts):
        frames.extend(dec.feed(piece))
    assert len(frames) == 1
    out_batch, info = reader.decode(frames[0])
    assert_batches_equal(batch, out_batch)
    assert info == {"n": batch.count}
    assert out_batch.created_at == batch.created_at
    for k in out_batch:
        assert not out_batch[k].flags.writeable


@given(rollout_cols())
@settings(max_examples=30, deadline=None)
def test_socket_transport_preserves_assembled_traces(data):
    cols, lane_base, _T, _B = data
    batch = assemble_fragments(cols, lane_base)
    spec = SocketTransport()
    writer = spec.server_endpoint(PT + "socktrace")
    out = spec.client_endpoint(PT + "socktrace").decode(writer.encode(batch))
    assert_batches_equal(batch, out)
    assert out.created_at == batch.created_at
    frags_in, frags_out = batch.split_by_episode(), out.split_by_episode()
    assert len(frags_in) == len(frags_out)
    for a, b in zip(frags_in, frags_out):
        assert_batches_equal(a, b)


@given(batches())
@settings(max_examples=30, deadline=None)
def test_decoded_views_are_readonly(batch):
    writer = ShmWriter(PT + "hyp3", threshold=1)
    reader = ShmReader(PT + "hyp3")
    try:
        out = reader.decode(loads(dumps(writer.encode(batch))))
        if writer.stats["shm_batches"]:
            for k in out:
                assert not out[k].flags.writeable
                with pytest.raises((ValueError, RuntimeError)):
                    out[k][...] = 0
    finally:
        del out
        gc.collect()
        reader.close()
        writer.close()


@given(st.lists(st.sampled_from([torch.float32, torch.float64, torch.int64, torch.int32,
                                 torch.bool, torch.bfloat16, torch.float16]), min_size=1, max_size=4),
       st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=30, deadline=None)
def test_tensor_boundary_roundtrip_property(dtypes, seed):
    """Any mix of tensor dtypes and shapes survives ``dumps``/``loads`` and
    the socket frames bitwise."""
    g = torch.Generator().manual_seed(seed)
    payload = []
    for i, dt in enumerate(dtypes):
        shape = [(3,), (2, 5), (0,), ()][i % 4]
        t = (torch.rand(shape, generator=g) * 100).to(dt)
        payload.append(t)
    _assert_same(loads(dumps(payload)), payload)
    _assert_same(FrameDecoder().feed(encode_frame(payload))[0], payload)
