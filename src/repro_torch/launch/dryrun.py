"""Multi-pod dry run: place and price every (arch x input shape x mesh)
(PyTorch port of ``repro/launch/dryrun.py``).

For each combination this starts a ``"fake"`` process group of 256 (or 512)
ranks in this one process (a fresh one a combination, destroyed after it
with DTensor's caches, so a row is the same alone or after any other,
failed or not), builds the production mesh over it, places the
params, optimizer state, cache and batch by ``distributed/specs.py`` as
DTensors of fake tensors (``FakeTensorMode``: nothing is allocated and
nothing runs on any device), runs the train / prefill / decode step once
under the cost walker and ``CommDebugMode``, and records:

  * bytes per device: the local shards of everything placed (the
    counterpart of ``memory_analysis``'s argument bytes; activations and
    temporaries are not counted);
  * FLOPs and bytes of rank 0's local ops (``distributed/hlo_cost.py``),
    times the chips, as the reference globalises its per-device module;
  * collective counts (``CommDebugMode``) and bytes (the walker) by kind;
  * the derived roofline terms at ``HW_H100``.

The reference's row names what it counted after HLO; the port writes what
it counts under names that say so: ``hlo_flops`` -> ``op_flops``,
``hlo_bytes`` -> ``op_bytes``, ``raw_cost_flops`` (XLA's own
``cost_analysis``) -> ``walker_ops`` (the aten ops priced),
``unknown_trip_counts`` (while loops the walker could not count) ->
``kernel_launches`` (the hand-written kernels priced at their formula;
the port's loops run, and a chunked time scan on fake tensors is priced
as its first chunk once a chunk, so there are no trip counts to recover), and
``memory_analysis`` -> ``placed_bytes`` (the placed trees by kind).  The
model states the reference's layouts (``shard``, ``shard_map``, ``dense``
under the axis rules), so rank 0's local shapes are the ones GSPMD gives
the reference; the FLOPs then sit within 0.10-1.15x of the reference's
``hlo_flops`` on every row (``PERF.md`` section 6).  An op with no
DTensor sharding rule makes that row ``ok: false`` and names the op; the
sweep goes on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch musicgen-large --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  # the port's rows beside the reference's (its jsonl from ``python -m repro.launch.dryrun``)
  PYTHONPATH=src python -m repro_torch.launch.dryrun --compare REFERENCE.jsonl PORT.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config
from repro_torch.distributed.hlo_analysis import HW_H100, collective_bytes, roofline
from repro_torch.distributed.hlo_cost import CostMode
from repro_torch.distributed.sharding import DEFAULT_RULES, AxisRules, axis_rules_context
from repro_torch.distributed.specs import (
    batch_specs,
    cache_specs,
    opt_state_specs,
    param_specs,
    tree_shardings,
)
from repro_torch.launch.input_specs import (
    abstract_cache,
    abstract_params,
    decode_window_for,
    eval_shape,
    fake_mode,
    input_specs,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model, make_decode_step, make_prefill_step, make_train_step
from repro_torch.optim import adamw, linear_warmup_cosine
from repro_torch.tree import tree_leaves, tree_map_with_path

__all__ = ["compare", "model_flops", "run_one", "init_fake_group", "release_fake_group", "main"]


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train, 2·N·D prefill, 2·N_active·B decode."""
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch  # one decode step


def init_fake_group(world_size: int) -> None:
    """A fresh ``"fake"`` process group of ``world_size`` ranks in this
    process (rank 0): its collectives return at once and move nothing.  Any
    earlier group is destroyed first, with DTensor's caches (see
    ``release_fake_group``)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    release_fake_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def release_fake_group() -> None:
    """Destroy the default process group, if any, and clear DTensor's
    caches.  Those caches key sharding decisions, tensor metadata and
    redistribution plans by layouts that hold a mesh, and a cached answer
    hands back that mesh: a later combination would reach a destroyed
    group through it, or a mask buffer left by a failed step.  So each
    combination starts from nothing and gives the same row alone as after
    any other, failed or not."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    try:
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor import _redistribute
        from torch.distributed.tensor._collective_utils import MeshTopoInfo
    except ImportError:  # pragma: no cover - a torch without DTensor
        return
    prop = DTensor._op_dispatcher.sharding_propagator
    caches = [
        getattr(prop, "propagate_op_sharding", None),
        getattr(prop, "_propagate_tensor_meta_cached", None),
        getattr(_redistribute, "_gen_transform_infos", None),
        getattr(MeshTopoInfo, "build_from_mesh", None),
    ]
    for cache in caches:
        if hasattr(cache, "cache_clear"):
            cache.cache_clear()
    if hasattr(_redistribute, "clear_redistribute_planner_cache"):
        _redistribute.clear_redistribute_planner_cache()


def _place(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` as a DTensor by its sharding (NamedTuples and
    non-tensor leaves, such as an optimizer's step count, kept)."""
    flat = iter(tree_leaves(shardings))
    return tree_map_with_path(
        lambda _path, x: next(flat).distribute(x) if isinstance(x, torch.Tensor) else (
            next(flat) and x), tree)


def _local_bytes(tree: Any) -> int:
    total = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            local = x.to_local() if hasattr(x, "to_local") else x
            total += local.numel() * local.element_size()
    return total


def _overridden(cfg: Any, overrides: Optional[Dict[str, Any]]) -> Any:
    if not overrides:
        return cfg
    plain = {k: v for k, v in overrides.items() if "." not in k}
    nested = {k: v for k, v in overrides.items() if "." in k}
    if plain:
        cfg = dataclasses.replace(cfg, **plain)
    for k, v in nested.items():
        field, sub = k.split(".", 1)
        inner = getattr(cfg, field)
        if inner is not None:
            cfg = dataclasses.replace(cfg, **{field: dataclasses.replace(inner, **{sub: v})})
    return cfg


def run_one(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    overrides: Optional[Dict[str, Any]] = None,
    tag: str = "",
) -> Dict[str, Any]:
    """Place and price one combination on a fake group of its own, which is
    gone when it returns or raises."""
    init_fake_group(512 if multi_pod else 256)
    try:
        return _price(arch, shape_name, multi_pod, overrides, tag)
    finally:
        release_fake_group()


def _price(arch: str, shape_name: str, multi_pod: bool, overrides: Optional[Dict[str, Any]],
           tag: str) -> Dict[str, Any]:
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    # Every path of the port is float32, whatever the configuration says.
    cfg = _overridden(dataclasses.replace(get_config(arch), dtype="float32"), overrides)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = mesh.size()
    rules = AxisRules(DEFAULT_RULES, mesh)
    model = Model(cfg)
    t0 = time.time()

    placed: Dict[str, int] = {}
    with fake_mode(), axis_rules_context(rules):
        params_shape = abstract_params(model)
        pspecs = param_specs(params_shape, rules)
        params = _place(params_shape, tree_shardings(mesh, pspecs))
        batch_shape = input_specs(cfg, shape)
        batch = _place(batch_shape, tree_shardings(mesh, batch_specs(batch_shape, rules)))
        placed["params"], placed["batch"] = _local_bytes(params), _local_bytes(batch)

        if shape.kind == "train":
            opt = adamw(linear_warmup_cosine(3e-4, 200, 10_000), weight_decay=0.1)
            opt_shape = eval_shape(opt.init, params_shape)
            ospecs = opt_state_specs(opt_shape, pspecs, rules)
            opt_state = _place(opt_shape, tree_shardings(mesh, ospecs))
            placed["opt_state"] = _local_bytes(opt_state)
            for p in tree_leaves(params):
                p.requires_grad_(True)
            step = make_train_step(model, opt)
            args = (params, opt_state, batch)
        elif shape.kind == "prefill":
            step = make_prefill_step(model, window=0)
            args = (params, batch)
        else:  # decode
            window = decode_window_for(cfg, shape)
            cache_shape = abstract_cache(model, shape.global_batch, window)
            cache = _place(cache_shape, tree_shardings(mesh, cache_specs(cache_shape, rules)))
            placed["cache"] = _local_bytes(cache)
            step = make_decode_step(model)
            args = (params, cache, batch)
        # The model makes some tensors of its own (positions, masks, rope
        # tables): DTensor takes them as replicated on the mesh.
        with implicit_replication(), CommDebugMode() as comm, CostMode() as walker:
            step(*args)
    cost = walker.cost
    bytes_per_dev = float(sum(placed.values()))

    # Walker numbers are rank 0's, per device; globalise for the table.
    glob = {"flops": cost.flops * chips, "bytes accessed": cost.hbm_bytes * chips}
    coll = {k: v * chips for k, v in collective_bytes(cost).items()}
    rl = roofline(arch, shape_name, mesh_name, chips, glob, coll, model_flops(cfg, shape),
                  hw=HW_H100, bytes_per_device=bytes_per_dev)
    row = rl.row()
    row.update(
        {
            "tag": tag,
            "ok": True,
            "hw": HW_H100.name,
            "compile_s": round(time.time() - t0, 1),
            "placed_bytes": placed,
            "collectives": coll,
            "collective_counts": {str(k): v for k, v in comm.get_comm_counts().items()},
            "walker_ops": cost.num_ops,
            "kernel_launches": len(cost.kernels),
        }
    )
    print(
        f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
        f"time={row['compile_s']}s flops={row['op_flops']:.3e} "
        f"coll={row['coll_bytes']:.3e}B dominant={row['dominant']}"
    )
    print(f"  placed bytes per device: {placed}")
    print(f"  walker: flops={glob['flops']} bytes={glob['bytes accessed']} ops={cost.num_ops}")
    return row


def _failure(arch: str, shape: str, multi_pod: bool, exc: BaseException) -> Dict[str, Any]:
    """The row of a combination that failed, naming the op that had no
    DTensor sharding rule where that was the cause."""
    text = f"{type(exc).__name__}: {exc}"
    row = {
        "arch": arch,
        "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "ok": False,
        "error": text[:2000],
    }
    # The op DTensor was dispatching when it failed (its dispatcher's
    # ``op_call``), or the redistribution it was in, else the first op the
    # message names.
    tb, op = exc.__traceback__, None
    while tb is not None:
        frame = tb.tb_frame
        call = frame.f_locals.get("op_call")
        if call is not None:
            op = str(call)
        elif op is None and frame.f_code.co_name == "_redistribute_backward":
            op = "DTensor redistribute (backward)"
        tb = tb.tb_next
    if op is None:
        found = re.search(r"(?:propagation failed for|Operator) ((?:aten|prims)\.[\w.]+)", text) \
            or re.search(r"\b((?:aten|prims|_c10d_functional|c10d)\.[\w.]+)", text)
        op = found.group(1) if found else None
    if op is not None:
        row["op"] = op
    return row


_KINDS = (("all-gather", "AG"), ("all-reduce", "AR"), ("reduce-scatter", "RS"),
          ("all-to-all", "A2A"), ("collective-permute", "CP"))


def compare(reference_path: str, port_path: str) -> str:
    """A markdown table of the port's rows beside the reference's
    (``python -m repro.launch.dryrun``'s jsonl), a line a combination: for
    each mesh, the FLOPs (port / reference and their ratio), the collective
    bytes by kind (port / reference) and the dominant term.  The last row
    of a combination in each file counts."""

    def rows(path: str) -> Dict[tuple, Dict[str, Any]]:
        with open(path) as f:
            return {(r["arch"], r["shape"], r["mesh"]): r for r in map(json.loads, f)}

    def cell(p: Optional[Dict[str, Any]], r: Optional[Dict[str, Any]]) -> str:
        if not (p and r and p.get("ok") and r.get("ok")):
            return (f"port ok={p.get('ok') if p else None} {p.get('op', '') if p else ''}; "
                    f"reference ok={r.get('ok') if r else None}")
        coll = ", ".join(
            f"{short} {p['collectives'].get(kind, 0):.3g} / {r['collectives'].get(kind, 0):.3g}"
            for kind, short in _KINDS
            if p["collectives"].get(kind, 0) or r["collectives"].get(kind, 0))
        return (f"**{p['op_flops'] / r['hlo_flops']:.2f}** {p['op_flops']:.3g} / "
                f"{r['hlo_flops']:.3g}; {coll}; {p['dominant'][:4]} / {r['dominant'][:4]}")

    ref, port = rows(reference_path), rows(port_path)
    meshes = ("16x16", "2x16x16")
    out = ["| arch | shape | " + " | ".join(meshes) + " |", "|---|---|---|---|"]
    for arch, shape in sorted({k[:2] for k in port}):
        cells = [cell(port.get((arch, shape, m)), ref.get((arch, shape, m))) for m in meshes]
        out.append(f"| {arch} | {shape} | " + " | ".join(cells) + " |")
    return "\n".join(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="dryrun_torch.jsonl")
    ap.add_argument("--tag", default="")
    ap.add_argument("--compare", nargs=2, metavar=("REFERENCE_JSONL", "PORT_JSONL"),
                    help="print the port's rows beside the reference's and exit")
    ap.add_argument(
        "--override",
        action="append",
        default=[],
        help="cfg overrides, e.g. --override shard_residuals=False",
    )
    args = ap.parse_args()
    if args.compare:
        print(compare(*args.compare))
        return 0
    overrides: Dict[str, Any] = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = json.loads(v.lower()) if v.lower() in ("true", "false") else (
            int(v) if v.lstrip("-").isdigit() else v
        )

    archs = list(ARCHITECTURES) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    failures = 0
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    try:
                        row = run_one(arch, shape, mp, overrides=overrides, tag=args.tag)
                    except Exception as e:
                        failures += 1
                        row = _failure(arch, shape, mp, e)
                        print(f"[dryrun] {arch} x {shape}: FAIL {e}", file=sys.stderr)
                        traceback.print_exc()
                    f.write(json.dumps(row) + "\n")
                    f.flush()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
