"""``Algorithm.explain()`` on the port (``tests/test_explain.py``'s seven
tests), the cost walker's slice-aware bytes
(``test_perf_features.py::test_walker_slice_aware_bytes``), and the kernel
ops priced at their bounds' formulas on the CPU.

The report keys rows by the *fused* FlowSpec node ids — the same ids as
the reference's report for the same plan — joins the live ``train()``
metrics, and flags memory-bound stages as kernel candidates, all without
changing worker state (the probes run under snapshot/restore).  Kernel
charges are compared exactly with the formulas ``chip_smoke.py`` bounds
each kernel by.
"""

import json

import numpy as np
import pytest
import torch

import repro_torch.core as c
from repro_torch.distributed.hlo_analysis import HW_H100
from repro_torch.distributed.hlo_cost import analyze_step
from repro_torch.flow import Algorithm, ExplainReport, StageCost
from repro_torch.rl import ActorCriticPolicy, CartPole, RolloutWorker
from repro_torch.tree import tree_leaves

NUM_ENVS, ROLLOUT_LEN = 2, 16


def _worker(i, rollout_len=ROLLOUT_LEN, seed=3):
    return RolloutWorker(
        CartPole(), ActorCriticPolicy(4, 2, loss_kind="ppo"), algo="ppo",
        num_envs=NUM_ENVS, rollout_len=rollout_len, seed=seed, worker_index=i, device="cpu",
    )


@pytest.fixture(scope="module")
def trained_ppo():
    ws = c.WorkerSet.create(_worker, 2)
    algo = Algorithm.from_plan(
        "ppo", ws, train_batch_size=64, num_sgd_iter=2, sgd_minibatch_size=32
    )
    for _ in range(2):
        algo.train()
    report = algo.explain()
    yield algo, report
    algo.stop()


def test_rows_keyed_by_fused_node_ids(trained_ppo):
    algo, report = trained_ppo
    assert isinstance(report, ExplainReport)
    spec_ids = set(algo.compiled.spec.nodes)
    assert [r.node_id for r in report.rows] == list(algo.compiled.spec.nodes)
    assert all(r.node_id in spec_ids for r in report.rows)


def test_static_cost_attributed_to_stepped_stages(trained_ppo):
    _, report = trained_ppo
    by_kind = {r.kind: r for r in report.rows}
    rollouts = by_kind["rollouts"]
    train = next(r for r in report.rows if "TrainOneStep" in r.label)
    for r in (rollouts, train):
        assert r.note == ""  # pricing succeeded, no degraded row
        assert r.flops > 0 and r.hbm_bytes > 0
        assert r.dominant in ("compute", "memory", "collective")


def test_memory_bound_stage_flagged_as_kernel_candidate(trained_ppo):
    """The tiny CartPole MLP is far below the H100's fp32 ridge (20
    FLOP/byte): at least one stage must be memory-bound and flagged."""
    _, report = trained_ppo
    assert HW_H100.ridge == pytest.approx(67e12 / 3.35e12)
    candidates = report.kernel_candidates()
    assert len(candidates) >= 1
    assert all(r.dominant == "memory" for r in candidates)
    assert all(r.flops / r.hbm_bytes < HW_H100.ridge for r in candidates)


def test_live_metrics_joined(trained_ppo):
    _, report = trained_ppo
    rollouts = next(r for r in report.rows if r.kind == "rollouts")
    train = next(r for r in report.rows if "TrainOneStep" in r.label)
    # Data plane: bytes flowed out of the rollouts node during train().
    assert rollouts.bytes_moved > 0
    # Wall time: the learn timer and the per-node gather timer both joined.
    assert train.calls == 2 and train.wall_s_total > 0
    assert rollouts.calls == 2 and rollouts.wall_s_total > 0


def test_explain_probe_is_side_effect_free(trained_ppo):
    """A second explain() must not advance worker env/RNG state, and the
    next rollout is the one a snapshot restored before it gives."""
    algo, _ = trained_ppo
    lw = algo.workers.local_worker()
    before = lw.get_state()
    weights = lw.get_weights()
    algo.explain()
    after = lw.get_state()
    np.testing.assert_array_equal(before["obs"], after["obs"])
    np.testing.assert_array_equal(before["ep_returns"], after["ep_returns"])
    np.testing.assert_array_equal(before["key"], after["key"])
    for w0, w1 in zip(tree_leaves(weights), tree_leaves(lw.get_weights())):
        assert torch.equal(w0, w1)
    probed = lw.sample()
    lw.set_state(before)
    again = lw.sample()
    lw.set_state(after)
    for k in probed.keys():
        np.testing.assert_array_equal(probed[k], again[k])


def test_json_round_trip_and_table(trained_ppo):
    _, report = trained_ppo
    doc = json.loads(report.to_json())
    assert doc["plan"] == "ppo"
    assert doc["hw"] == "nvidia-h100-sxm"
    assert len(doc["stages"]) == len(report.rows)
    assert set(doc["kernel_candidates"]) == {
        r.node_id for r in report.kernel_candidates()
    }
    # Every dataclass field survives the round trip.
    assert set(doc["stages"][0]) == set(StageCost("x", "y", "z").row())
    table = report.table()
    for r in report.rows:
        assert r.node_id in table


def test_opaque_stage_degrades_to_metrics_only():
    """A worker that cannot be priced yields a noted row, not an error."""
    from repro_torch.core.metrics import MetricsContext
    from repro_torch.flow.explain import explain_flow
    from repro_torch.flow.plans import build_ppo

    ws = c.WorkerSet.create(lambda i: _worker(i, rollout_len=8, seed=0), 1)
    try:
        compiled = build_ppo(ws, train_batch_size=16).compile()

        class _Opaque:
            def local_worker(self):
                raise RuntimeError("no local worker here")

        report = explain_flow(compiled, _Opaque(), MetricsContext())
        rollouts = next(r for r in report.rows if r.kind == "rollouts")
        assert "static cost unavailable" in rollouts.note
        assert rollouts.flops == 0.0
        compiled.stop()
    finally:
        ws.stop()


def test_rows_match_the_reference_reports_nodes(trained_ppo):
    """The same plan's report in the reference has the same node ids,
    kinds and labels, and prices the same two stages."""
    from repro.core.workers import WorkerSet as JaxWorkerSet
    from repro.flow import Algorithm as JaxAlgorithm
    from repro.rl import ActorCriticPolicy as JaxPolicy
    from repro.rl import CartPole as JaxCartPole
    from repro.rl import RolloutWorker as JaxWorker

    def jax_worker(i):
        return JaxWorker(JaxCartPole(), JaxPolicy(4, 2, loss_kind="ppo"), algo="ppo",
                         num_envs=NUM_ENVS, rollout_len=ROLLOUT_LEN, seed=3, worker_index=i)

    _, report = trained_ppo
    with JaxAlgorithm.from_plan("ppo", JaxWorkerSet.create(jax_worker, 2), train_batch_size=64,
                                num_sgd_iter=2, sgd_minibatch_size=32) as ref:
        ref.train()
        want = ref.explain()
    assert [(r.node_id, r.kind, r.label) for r in report.rows] == [
        (r.node_id, r.kind, r.label) for r in want.rows
    ]
    assert [bool(r.flops) for r in report.rows] == [bool(r.flops) for r in want.rows]


def test_kernel_ops_priced_at_their_bound_formulas(trained_ppo):
    """The rollout's GAE and the learn step's surrogate forward and backward
    are each one op, charged the FLOPs and bytes ``chip_smoke.py`` bounds
    them by (GAE: 8 TB FLOPs, (5 TB + B) x 4 bytes; surrogate [B, A]:
    B (6A + 20) and B (16A + 40) FLOPs)."""
    _, report = trained_ppo
    rollouts = next(r for r in report.rows if r.kind == "rollouts")
    train = next(r for r in report.rows if "TrainOneStep" in r.label)
    T, B = ROLLOUT_LEN, NUM_ENVS
    assert rollouts.kernels["gae"] == {
        "launches": 1, "flops": 8 * T * B, "bytes": (5 * T * B + B) * 4, "int_ops": 0.0,
        "sizes": [[{"tb": T * B, "b": B}, 1]]}
    rows, A = T * B, 2  # the probe batch: one sample of the local worker
    row_in = 4 * 4 + 8
    assert train.kernels["ppo_surrogate"] == {
        "launches": 1, "flops": rows * (6 * A + 20),
        "bytes": rows * (4 * A + row_in) + rows * 5 * 4, "int_ops": 0.0,
        "sizes": [[{"b": rows, "a": A}, 1]]}
    assert train.kernels["ppo_surrogate_bwd"] == {
        "launches": 1, "flops": rows * (16 * A + 40),
        "bytes": rows * (4 * A + row_in + 2 * 4 + 4 * 4) + rows * (4 * A + 4 * 4), "int_ops": 0.0,
        "sizes": [[{"b": rows, "a": A}, 1]]}
    # The rollout's threefry hashes are priced too (bytes and int32 ops).
    assert rollouts.kernels["threefry_counts"]["launches"] > 0
    assert rollouts.kernels["threefry_counts"]["flops"] == 0.0


def test_walker_slice_aware_bytes():
    """A loop that reads one row of a stack a step must charge row bytes,
    not the full stack, per iteration (a view moves nothing)."""
    T, d = 64, 128

    def f(stack):
        out = torch.zeros(())
        for i in range(T):
            row = stack[i]
            out = out + torch.sum(row)
        return out

    cost, _ = analyze_step(f, torch.empty(T, d))
    full_stack_per_step = T * d * 4 * T  # what naive accounting would charge
    assert cost.hbm_bytes < full_stack_per_step / 4
    assert cost.by_op["sum"][2] == pytest.approx(T * (d * 4 + 4))


def test_walker_execute_mode_prices_forward_only():
    """``execute=True`` runs a kernel for real and charges its forward
    formula; where the kernel's input requires grad it raises, since the
    backward would run after the walker, unpriced."""
    from repro_torch.distributed.hlo_cost import flash_costs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_plain

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 4), generator=g) for _ in range(3))
    with torch.no_grad():
        cost, out = analyze_step(ops.flash_attention, q, k, v, execute=True)
    torch.testing.assert_close(out, flash_attention_plain(q, k, v), rtol=0, atol=0)
    (charge,) = cost.kernels
    key = dict(b=1, sq=8, sk=8, h=2, kv=2, d=4, causal=True, window=0, q_offset=0)
    assert (charge.name, charge.key) == ("flash_attention", key)
    assert (charge.flops, charge.bytes) == flash_costs(**key)[0][:2]
    with pytest.raises(NotImplementedError, match="flash_attention's backward"):
        analyze_step(ops.flash_attention, q.requires_grad_(True), k, v, execute=True)


def test_walker_prices_one_scan_chunk_per_chunk():
    """On fake tensors ``chunked_scan`` runs its first chunk and the walker
    prices it once a chunk, its recomputed forward and backward too: the
    count of every chunk run, within the ops that stand in for the chunks'
    concatenation (one op, 5 % of the bytes here)."""
    from repro_torch.distributed import hlo_cost
    from repro_torch.models import scan_utils

    w = torch.randn(8, requires_grad=True)
    x = torch.randn(512, 2, 8, requires_grad=True)

    def train(x, w):
        def step(h, inp):
            h = h * w + inp
            return h, h

        h, ys = scan_utils.chunked_scan(step, torch.zeros(2, 8), x, chunk=128)
        return torch.autograd.grad(ys.sum() + h.sum(), [x, w])

    shortcut, _ = hlo_cost.analyze_step(train, x, w)

    class _NoWalker:  # the same steps with every chunk run
        LOCAL = type("L", (), {"walker": None})()

    real = scan_utils._cost
    scan_utils._cost = _NoWalker
    try:
        every, _ = hlo_cost.analyze_step(train, x, w)
    finally:
        scan_utils._cost = real
    assert abs(shortcut.num_ops - every.num_ops) <= 2
    assert shortcut.flops == every.flops
    assert abs(shortcut.hbm_bytes - every.hbm_bytes) <= 0.05 * every.hbm_bytes
