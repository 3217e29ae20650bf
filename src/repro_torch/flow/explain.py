"""``Algorithm.explain()``: roofline-driven per-stage cost attribution
(PyTorch port of ``repro/flow/explain.py``).

Each FlowSpec node of a compiled flow is attributed three cost sources:

  * **static** — the node's step is run once under the cost walker
    (``repro_torch.distributed.hlo_cost.analyze_step``, on fake tensors
    where it can: see below) and priced with the roofline terms
    (``repro_torch.distributed.hlo_analysis.roofline``): FLOPs, bytes,
    collective bytes, and the dominant bottleneck at the target hardware's
    peak rates (``HW_H100`` by default).  Two node kinds carry a step:
    ``rollouts`` (the local worker's env+policy rollout) and any
    ``for_each`` node holding a ``TrainOneStep`` stage (the worker's
    gradient step and optimizer apply) or the LM pretraining flow's
    ``SPMDTrainStep`` (``launch/train.py``: the learner's loss, gradient and
    optimizer step on the last batch it learned on, a port-only row; the
    reference's report leaves that stage unpriced).  Each hand-written kernel the step
    dispatches is one op, priced at its bound's formula, and listed in the
    row's ``kernels``.
  * **live** — the shared ``MetricsContext`` joined by node id: wall time
    from the canonical operator timers (``sample`` / ``learn``), data-plane
    bytes moved out of the node (``bytes_moved/<node-id>`` counters, keyed
    by *fused* node id at lowering time — the same ids this report uses),
    and current queue occupancy for enqueue/dequeue nodes.
  * **verdict** — a stage whose roofline is memory-bound is flagged as a
    *kernel candidate*: its arithmetic intensity is below the hardware's
    ridge (67e12 / 3.35e12 = 20 FLOP/byte on the H100 in fp32), so fusing
    its element-wise chain into one CUDA kernel over the batch (the
    ``kernels/`` recipe) turns memory round trips into on-chip traffic.

The probe leaves the workers as they were: the rollout probe and the
learn-stage probe batch run between a ``get_state`` and a ``set_state`` of
the local worker.  The probe batch is one real ``sample()`` on the
worker's device; the learn step is priced on fake tensors, and so is the
rollout, except one whose control flow branches on its data (the LM
policy's prefill-or-decode choice), which is priced on a real run on the
worker's device under that snapshot.  Stages that cannot be priced (an
opaque worker) degrade to metrics-only rows with a ``note`` — the report
never raises because one stage is opaque.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from torch._subclasses.fake_tensor import DataDependentOutputException

from repro_torch.core.metrics import (
    BYTES_MOVED_PREFIX,
    GATHER_TIMER_PREFIX,
    LEARN_ON_BATCH_TIMER,
    QUEUE_OCCUPANCY_PREFIX,
    SAMPLE_TIMER,
    MetricsContext,
)
from repro_torch.distributed.hlo_analysis import HW_H100, Hardware, collective_bytes, roofline
from repro_torch.distributed.hlo_cost import OpCost, analyze_step

__all__ = ["StageCost", "ExplainReport", "explain_flow"]


@dataclasses.dataclass
class StageCost:
    """One FlowSpec node's attributed cost (static + live + verdict)."""

    node_id: str
    label: str
    kind: str
    # Static (walker) terms; zero when the node carries no step.
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    # The hand-written kernels the step launches: name -> {"launches",
    # "flops", "bytes", "int_ops"} summed over its launches, and "sizes":
    # [the sizes a launch was priced at, launches at them].
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(default_factory=dict)
    # Live metrics joined by node id / canonical timer.
    wall_s_total: float = 0.0
    wall_s_mean: float = 0.0
    calls: int = 0
    bytes_moved: int = 0
    queue_occupancy: Optional[float] = None
    # Serving-tier join: populated for source nodes running
    # inference='server' — CreditGate contention on the request path plus
    # the router's continuous-batching occupancy/admission-latency gauges
    # (published under ``inference/<node-id>/`` by the router probe).
    credit_stalls: int = 0
    credit_stall_time_s: float = 0.0
    serve_replicas: Optional[float] = None
    serve_occupancy_mean: Optional[float] = None
    serve_admission_p99_s: Optional[float] = None
    # Verdict.
    kernel_candidate: bool = False
    note: str = ""

    def row(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ExplainReport:
    """Per-stage cost rows plus the hardware model they were priced against."""

    plan: str
    hw: Hardware
    rows: List[StageCost]

    def kernel_candidates(self) -> List[StageCost]:
        return [r for r in self.rows if r.kernel_candidate]

    def to_json(self) -> str:
        doc = {
            "plan": self.plan,
            "hw": self.hw.name,
            "stages": [r.row() for r in self.rows],
            "kernel_candidates": [r.node_id for r in self.kernel_candidates()],
        }
        return json.dumps(doc, indent=2, sort_keys=True)

    def table(self) -> str:
        hdr = (
            "| node | kind | flops | hbm_bytes | dominant | wall_mean_s | "
            "calls | bytes_moved | kernel? |\n|---|---|---|---|---|---|---|---|---|"
        )
        lines = [hdr]
        for r in self.rows:
            lines.append(
                "| {id} | {kind} | {f} | {b} | {dom} | {w} | {c} | {mv} | {k} |".format(
                    id=r.node_id,
                    kind=r.kind,
                    f=f"{r.flops:.2e}" if r.flops else "-",
                    b=f"{r.hbm_bytes:.2e}" if r.hbm_bytes else "-",
                    dom=r.dominant or "-",
                    w=f"{r.wall_s_mean:.2e}" if r.calls else "-",
                    c=r.calls or "-",
                    mv=r.bytes_moved or "-",
                    k="yes" if r.kernel_candidate else "",
                )
            )
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.table()


def _is_train_stage(stage: Any) -> bool:
    fn = getattr(stage, "fn", None)
    label = getattr(stage, "label", "")
    return type(fn).__name__ == "TrainOneStep" or "TrainOneStep" in label or (
        label == "SPMDTrainStep")


def _has_train_stage(node: Any) -> bool:
    return node.kind == "for_each" and any(
        _is_train_stage(s) for s in node.params.get("stages", ())
    )


def _snapshot(lw: Any) -> Any:
    return lw.get_state() if hasattr(lw, "get_state") else None


def _rollout_cost(workers: Any) -> OpCost:
    """The walker's cost of one rollout of the local worker; its state is
    restored after, so the next real rollout is the one it would have been."""
    lw = workers.local_worker()
    if hasattr(lw, "_vrollout"):  # the vectorized engine: rollout, then GAE
        def rollout():
            return lw._postprocess_cols(lw.params, lw._vrollout())
    else:
        rollout = lw._rollout
    snapshot = _snapshot(lw)
    try:
        try:
            return analyze_step(rollout)[0]
        except DataDependentOutputException:
            # The rollout branches on its data (the LM policy prefills a
            # fresh lane, else decodes): price a real run instead.
            if snapshot is not None:
                lw.set_state(snapshot)
            return analyze_step(rollout, execute=True)[0]
    finally:
        if snapshot is not None:
            lw.set_state(snapshot)


def _learn_cost(workers: Any) -> OpCost:
    """The walker's cost of one learn step of the local worker: the loss,
    its gradient and the optimizer apply, on a batch of one ``sample()``.

    The probe batch is drawn under a state snapshot/restore, so the
    worker's env state and key chain are untouched; its weights are never
    assigned, only read.
    """
    from repro_torch.rl.rollout_worker import _device_batch

    lw = workers.local_worker()
    if hasattr(lw, "ctx"):  # the pretraining learner (core/spmd.py)
        return _spmd_learn_cost(lw)
    snapshot = _snapshot(lw)
    try:
        batch = _device_batch(lw.sample(), lw.device)

        def step():
            grads, _loss, _aux = lw._grads(batch)
            return lw.optimizer.apply(lw.params, grads, lw.opt_state)

        return analyze_step(step)[0]
    finally:
        if snapshot is not None:
            lw.set_state(snapshot)


def _spmd_learn_cost(lw: Any) -> OpCost:
    """The walker's cost of one step of the pretraining learner on the last
    batch it learned on: the loss, its gradient and the optimizer's
    functional apply (the step's in-place apply computes the same), on fake
    tensors."""
    import numpy as np
    import torch

    from repro_torch.tree import tree_leaves, tree_map

    if lw.last_batch is None:
        raise ValueError("the learner has learned on no batch yet")
    batch = {k: torch.from_numpy(np.asarray(v)).to(lw.ctx.device) for k, v in lw.last_batch.items()}
    model, opt = lw.ctx.model, lw.ctx.optimizer

    def step():
        loss, _ = model.loss(lw.params, batch["tokens"], batch["labels"],
                             media_emb=batch.get("media_emb"))
        grads = iter(torch.autograd.grad(loss, tree_leaves(lw.params)))
        return opt.apply(lw.params, tree_map(lambda _: next(grads), lw.params), lw.opt_state)

    return analyze_step(step)[0]


def _attribute_static(row: StageCost, cost: OpCost, hw: Hardware) -> None:
    rl = roofline(
        arch="stage",
        shape=row.node_id,
        mesh_name="local",
        chips=1,
        cost={"flops": cost.flops, "bytes accessed": cost.hbm_bytes},
        coll=collective_bytes(cost),
        model_flops=cost.flops,
        hw=hw,
    )
    row.flops = rl.op_flops
    row.hbm_bytes = rl.op_bytes
    row.coll_bytes = rl.coll_bytes
    row.compute_s = rl.compute_s
    row.memory_s = rl.memory_s
    row.collective_s = rl.collective_s
    row.dominant = rl.dominant
    row.kernel_candidate = rl.dominant == "memory"
    for k in cost.kernels:
        agg = row.kernels.setdefault(
            k.name, {"launches": 0, "flops": 0.0, "bytes": 0.0, "int_ops": 0.0, "sizes": []}
        )
        agg["launches"] += 1
        agg["flops"] += k.flops
        agg["bytes"] += k.bytes
        agg["int_ops"] += k.int_ops
        for entry in agg["sizes"]:
            if entry[0] == k.key:
                entry[1] += 1
                break
        else:
            agg["sizes"].append([k.key, 1])


def explain_flow(
    compiled: Any,
    workers: Any,
    metrics: MetricsContext,
    hw: Hardware = HW_H100,
) -> ExplainReport:
    """Build the per-stage cost report for one compiled flow.

    ``compiled`` is a ``CompiledFlow`` (its *fused* spec's node ids are the
    keys the data-plane metrics were recorded under); ``metrics`` is the
    live ``MetricsContext`` of the algorithm's iterator — run a few
    ``train()`` steps first if you want the wall-time columns populated.
    """
    # Pull-based publishers (the serving tier's router probes) only write on
    # save(); run them so the join below sees current serving gauges even if
    # no train() result was pulled since the last request.
    getattr(metrics, "run_probes", lambda: None)()
    spec = compiled.spec
    rows: List[StageCost] = []
    for node in spec.nodes.values():
        if node.kind == "for_each":
            label = " | ".join(s.label for s in node.params.get("stages", ()))
        else:
            label = node.label
        row = StageCost(node_id=node.id, label=label, kind=node.kind)

        # Live join (always available, even when pricing fails).
        moved = metrics.counters.get(BYTES_MOVED_PREFIX + node.id)
        if moved:
            row.bytes_moved = int(moved)
        occ = metrics.gauges.get(QUEUE_OCCUPANCY_PREFIX + node.id)
        if occ is not None:
            row.queue_occupancy = float(occ)
        # Serving-tier join: the router probe publishes under
        # inference/<node-id>/ (see InferenceRouter.metrics_probe).
        serve = f"inference/{node.id}/"
        row.credit_stalls = int(metrics.counters.get(serve + "credit_stalls", 0))
        row.credit_stall_time_s = float(
            metrics.gauges.get(serve + "credit_stall_time_s", 0.0)
        )
        reps = metrics.gauges.get(serve + "replicas")
        if reps is not None:
            row.serve_replicas = float(reps)
            row.serve_occupancy_mean = metrics.gauges.get(serve + "occupancy_mean")
            row.serve_admission_p99_s = metrics.gauges.get(
                serve + "admission_wait_p99_s"
            )
        # Wall-time join, most specific key first: the per-node gather timer
        # (recorded by gather_sync under this node's id), then the canonical
        # operator timers (``sample`` from the low-level ports, ``learn``
        # from TrainOneStep).
        timer_keys: List[str] = [GATHER_TIMER_PREFIX + node.id]
        if node.kind == "rollouts":
            timer_keys.append(SAMPLE_TIMER)
        elif _has_train_stage(node):
            timer_keys = [LEARN_ON_BATCH_TIMER]
        for timer_key in timer_keys:
            if timer_key in metrics.timers:
                t = metrics.timers[timer_key]
                row.wall_s_total = t.total
                row.wall_s_mean = t.mean
                row.calls = t.count
                break

        # Static attribution for nodes carrying a step.
        try:
            if node.kind == "rollouts":
                _attribute_static(row, _rollout_cost(workers), hw)
            elif _has_train_stage(node):
                _attribute_static(row, _learn_cost(workers), hw)
        except Exception as exc:  # degrade, never fail the whole report
            row.note = f"static cost unavailable: {exc!r}"
        rows.append(row)
    return ExplainReport(plan=spec.name, hw=hw, rows=rows)
