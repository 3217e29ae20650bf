"""The port's dry run (``tests/test_dryrun_smoke.py`` on ``repro_torch``).

``python -m repro_torch.launch.dryrun`` runs as a subprocess with its own
timeout: it starts a ``"fake"`` process group of 256 ranks, which must live
in a process of its own.  One combination, ``musicgen-large`` x
``decode_32k`` on the 16 x 16 mesh, is placed and priced: the row must
hold FLOPs > 0 and a dominant term at the H100's rates.
"""

import json
import os
import subprocess
import sys

import pytest

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.timeout(300)
def test_dryrun_single_combination(tmp_path):
    out = tmp_path / "dr.jsonl"
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "musicgen-large", "--shape", "decode_32k",
         "--mesh", "single", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=280,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    row = json.loads(out.read_text().strip().splitlines()[-1])
    assert row["ok"]
    assert row["op_flops"] > 0 and row["op_bytes"] > 0
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["hw"] == "nvidia-h100-sxm" and row["chips"] == 256 and row["mesh"] == "16x16"
    # The analytic model FLOPs are the reference's for the same config: 2 N_active B
    # a decode step (``repro.launch.dryrun.model_flops``; that module is not
    # imported here, as it sets XLA_FLAGS for the whole process).
    shape = JAX_SHAPES["decode_32k"]
    want = 2.0 * jax_get_config("musicgen-large").active_param_count() * shape.global_batch
    assert row["model_flops"] == pytest.approx(want)
    # The cache is placed over the mesh: each device holds 1/256 of it.
    assert 0 < row["placed_bytes"]["cache"] < row["bytes_per_device"]
    # The cache's window is split over 'model', so each layer's decode
    # attention is the window-split softmax in plain ops (its products at
    # least the model's), not one kernel launch a layer.
    assert row["kernel_launches"] == 0 and row["op_flops"] > row["model_flops"]
    assert row["collective_counts"] and row["collectives"]["total"] > 0


def test_failed_row_names_the_op():
    from repro_torch.launch.dryrun import _failure

    exc = RuntimeError("Sharding propagation failed for aten.bmm.default(Spec(f32[4, 8]))")
    row = _failure("jamba-v0.1-52b", "train_4k", False, exc)
    assert row["ok"] is False and row["mesh"] == "16x16" and row["op"] == "aten.bmm.default"


# The port's rows in one process: a row of each family that DTensor once
# refused (the vocab-sharded embedding's backward, batched products over a
# size read from data), and a row priced again after a row on the other mesh
# and a row that failed.
_PORT_ROWS = r"""
import json
import torch.distributed as dist
from repro_torch.launch import dryrun
from repro_torch.models import layers

KEYS = ("arch", "shape", "mesh", "ok", "op_flops", "op_bytes", "coll_bytes", "collectives",
        "dominant", "kernel_launches")

def row(arch, shape, multi=False):
    r = dryrun.run_one(arch, shape, multi)
    return {k: r[k] for k in KEYS}

out = {"priced": [row(a, s) for a, s in (
    ("qwen1.5-4b", "train_4k"), ("rwkv6-7b", "decode_32k"), ("qwen1.5-4b", "decode_32k"))]}
row("rwkv6-7b", "decode_32k", multi=True)
merge, calls = layers.merge_heads, [0]

def failing(x):
    calls[0] += 1
    if calls[0] == 3:  # mid-step, DTensors placed and DTensor's caches filled
        raise RuntimeError("injected failure")
    return merge(x)

layers.merge_heads = failing
try:
    dryrun.run_one("qwen1.5-4b", "decode_32k", False)
    out["failed"] = False
except RuntimeError:
    out["failed"] = True
layers.merge_heads = merge
out["again"] = row("qwen1.5-4b", "decode_32k")
out["group_left"] = dist.is_initialized()
print(json.dumps(out))
"""

# Two more rows in a process of their own, beside the one above.
_MORE_ROWS = r"""
import json
from repro_torch.launch import dryrun

print(json.dumps({"priced": [dryrun.run_one(a, s, False) for a, s in (
    ("deepseek-v2-lite-16b", "train_4k"), ("phi3.5-moe-42b-a6.6b", "long_500k"))]}))
"""

# The reference's rows for the two comparisons (``repro.launch.dryrun``; the
# module sets XLA's host device count as it is imported).
_REFERENCE_ROWS = r"""
import json
from repro.launch.dryrun import run_one

rows = [run_one(a, s, False) for a, s in (("qwen1.5-4b", "decode_32k"),
                                          ("phi3.5-moe-42b-a6.6b", "long_500k"))]
print(json.dumps({f"{r['arch']} {r['shape']}": r["hlo_flops"] for r in rows}))
"""


@pytest.mark.timeout(600)
def test_dryrun_prices_the_refused_families_like_the_reference(tmp_path):
    """Four subprocesses at once: the port's rows above (two processes), the
    Qwen1.5-4B decode row alone (``python -m repro_torch.launch.dryrun``),
    and the reference's two rows.  Every row is priced; a row gives the same numbers
    alone, after a row on the other mesh and after a failed row, which
    leaves no process group behind; Qwen1.5-4B ``decode_32k`` and
    Phi-3.5-MoE ``long_500k``, once the rows furthest from the reference's
    FLOPs, are within 3x of the reference's ``hlo_flops``."""
    env = dict(os.environ, PYTHONPATH=SRC)
    alone_out = tmp_path / "alone.jsonl"
    procs = {
        "port": subprocess.Popen([sys.executable, "-c", _PORT_ROWS], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "more": subprocess.Popen([sys.executable, "-c", _MORE_ROWS], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "alone": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen1.5-4b",
             "--shape", "decode_32k", "--mesh", "single", "--out", str(alone_out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "reference": subprocess.Popen(
            [sys.executable, "-c", _REFERENCE_ROWS],
            env=dict(env, JAX_PLATFORMS="cpu",
                     DRYRUN_XLA_FLAGS="--xla_force_host_platform_device_count=256"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    done = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=560)
        assert proc.returncode == 0, (name, stderr[-3000:])
        done[name] = stdout
    port = json.loads(done["port"].strip().splitlines()[-1])
    reference = json.loads(done["reference"].strip().splitlines()[-1])
    alone = json.loads(alone_out.read_text().strip().splitlines()[-1])
    more = json.loads(done["more"].strip().splitlines()[-1])

    for row in port["priced"] + more["priced"]:
        assert row["ok"] and row["op_flops"] > 0 and row["op_bytes"] > 0, row
        assert row["dominant"] in ("compute", "memory", "collective")
    priced = {f"{r['arch']} {r['shape']}": r for r in port["priced"] + more["priced"]}
    for name, hlo_flops in reference.items():
        ratio = priced[name]["op_flops"] / hlo_flops
        assert 0.05 < ratio <= 3.0, (name, ratio)

    assert port["failed"] and not port["group_left"]
    first = priced["qwen1.5-4b decode_32k"]
    for other in (port["again"], alone):
        for key in ("op_flops", "op_bytes", "coll_bytes", "collectives", "kernel_launches"):
            assert other[key] == first[key], key


def test_compare_prints_port_beside_reference(tmp_path):
    """``--compare`` prints a line a combination, each mesh's FLOP ratio,
    both FLOP counts and the collective bytes by kind, and names a row
    that failed."""
    from repro_torch.launch.dryrun import compare

    ref = tmp_path / "ref.jsonl"
    port = tmp_path / "port.jsonl"
    base = {"arch": "qwen1.5-4b", "shape": "decode_32k", "ok": True, "dominant": "memory"}
    ref.write_text("\n".join(json.dumps(dict(base, mesh=m, hlo_flops=2e12,
                                             collectives={"all-gather": 4e11}))
                             for m in ("16x16", "2x16x16")))
    port.write_text("\n".join([
        json.dumps(dict(base, mesh="16x16", op_flops=3e12, collectives={"all-gather": 2e11})),
        json.dumps({"arch": "qwen1.5-4b", "shape": "decode_32k", "mesh": "2x16x16", "ok": False,
                    "op": "aten.bmm.default"})]))
    table = compare(str(ref), str(port)).splitlines()
    assert len(table) == 3 and table[2].startswith("| qwen1.5-4b | decode_32k |")
    assert "**1.50** 3e+12 / 2e+12; AG 2e+11 / 4e+11; memo / memo" in table[2]
    assert "port ok=False aten.bmm.default; reference ok=True" in table[2]
