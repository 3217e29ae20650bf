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
    assert row["kernel_launches"] == 48  # one decode-attention launch a layer
    assert row["collective_counts"] and row["collectives"]["total"] > 0


def test_failed_row_names_the_op():
    from repro_torch.launch.dryrun import _failure

    exc = RuntimeError("Sharding propagation failed for aten.bmm.default(Spec(f32[4, 8]))")
    row = _failure("jamba-v0.1-52b", "train_4k", False, exc)
    assert row["ok"] is False and row["mesh"] == "16x16" and row["op"] == "aten.bmm.default"
