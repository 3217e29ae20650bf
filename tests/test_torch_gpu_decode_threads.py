"""The bf16 decode-attention wrapper called from two threads at once, on the
card: the kernel's shared-memory limit is an attribute that every thread
shares, so one thread's launch at a shape whose blocks ask for less must not
refuse another's at a shape that asks for more.  Marked ``gpu``: it skips
without a CUDA device, and runs on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu_decode_threads.py
"""

import importlib.util
from pathlib import Path

import pytest
import torch


@pytest.mark.gpu
def test_bf16_decode_from_two_threads():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 decode kernel has no CPU path")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    result = chip_smoke._bf16_decode_threads(rounds=500)
    assert result["smem"][0] != result["smem"][1]
