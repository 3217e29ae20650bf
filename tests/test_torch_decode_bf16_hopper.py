"""The bf16 decode-attention kernel of ``csrc/decode_attention_bf16.cu`` as it
is laid out for Hopper, and the float32 small-group kernel's split of D,
checked on the CPU.

* The decode kernel's schedule, emulated in float32 with the kernel's
  roundings: ``bf16_decode_plan``'s clusters, each rank a run of the
  window's 64-slot tiles, a tile with no valid slot never loaded, each
  consumer warp 16 slots of a tile (skipped when all 16 are invalid), the
  per-tile mask, S from bf16 products summed in fp32 and scaled into the
  exp2 domain, P rounded to bf16 for P V while l sums the unrounded
  weights, the warps' states merged in warp order and the ranks' in rank
  order, the output rounded to bf16 once.  The emulation is held against
  the plain version within ``chip_smoke.py``'s per-row gate and against the
  reference's Pallas kernel in interpret mode within the reference's bf16
  tolerance.
* ``bf16_decode_plan``: every rank holds a tile, the cluster is portable,
  shared memory fits a block, the grid keeps to the SMs' blocks, and the
  serve steps' shares land in one round trip.
* The replaced design (``kernels/variants/decode_attention_bf16_simt.cu``)
  takes the float32 kernel's parameter list, with which
  ``decode_variants --bf16`` binds it, and is not linked.
* ``chip_smoke.py``'s phase-2 lists name the decode kernels the source
  defines.
* The float32 small-group kernel's split: chunks of D's block steps that
  cover D once, their fp32 partials added in chunk order, against
  ``moe_gmm_plain``; the wrapper takes it only at the shapes where it timed
  faster.

Inputs are made with numpy from a seed.
"""

import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.kernels import build, decode_variants, moe_gmm
from repro_torch.kernels.decode_attention import (
    BF16_MAX_CLUSTER,
    BF16_MAX_STAGES,
    BF16_ROWS,
    BF16_TILE,
    BLOCK_SMEM,
    SM_SMEM,
    SMS,
    bf16_decode_plan,
    bf16_decode_smem,
    decode_attention_plain,
)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BF = torch.bfloat16
LOG2E = 1.4426950408889634
NEG = -1e30
WARPS = 4  # consumer warps, 16 slots of a tile each
ATTENTION_TOL = 2e-2  # tests/test_kernels.py's bf16 tolerance for attention
MARGIN = 0.7  # the emulation's largest error over the card's per-row gate, at most
SOURCE = build.CSRC_DIR / "decode_attention_bf16.cu"


# ------------------------------------------------- the kernel's schedule
def _rank_tiles(tiles: int, cluster: int, rank: int) -> range:
    return range(rank * tiles // cluster, (rank + 1) * tiles // cluster)


def _emulate(q, k, v, valid, cluster=None):
    """The bf16 kernel's order of arithmetic in float32 -> [B, 1, H, D] bf16,
    and the tiles it loads."""
    B, _, H, D = q.shape
    W, KV = k.shape[1], k.shape[2]
    g = H // KV
    plan = bf16_decode_plan(B, KV, g, D, W, cluster)
    if valid.dim() == 1:
        valid = valid[None].expand(B, W)
    scale_log2 = torch.tensor(1.0 / math.sqrt(D) * LOG2E, dtype=torch.float32)
    pad = plan.tiles * BF16_TILE - W
    mask = torch.cat([valid, torch.zeros(B, pad, dtype=torch.bool)], 1)
    kf = torch.cat([k.float(), torch.zeros(B, pad, KV, D)], 1)  # TMA's zeros past W
    vf = torch.cat([v.float(), torch.zeros(B, pad, KV, D)], 1)
    out = torch.zeros(B, 1, H, D)
    loaded = 0
    for b in range(B):
        for kvh in range(KV):
            for j0 in range(0, g, BF16_ROWS):
                nh = min(BF16_ROWS, g - j0)
                h0 = kvh * g + j0
                qg = q[b, 0, h0:h0 + nh].float()
                ranks = []
                for rank in range(plan.cluster):
                    warps = [(torch.full((nh,), NEG), torch.zeros(nh), torch.zeros(nh, D))
                             for _ in range(WARPS)]
                    for t in _rank_tiles(plan.tiles, plan.cluster, rank):
                        word = mask[b, t * BF16_TILE:(t + 1) * BF16_TILE]
                        if not word.any():
                            continue  # a tile with no valid slot is never loaded
                        loaded += 1
                        for w in range(WARPS):
                            lo = t * BF16_TILE + 16 * w
                            bits = mask[b, lo:lo + 16]
                            if not bits.any():
                                continue
                            m, l, acc = warps[w]
                            s = (qg @ kf[b, lo:lo + 16, kvh].T) * scale_log2
                            s = torch.where(bits[None], s, torch.full_like(s, -math.inf))
                            mx = torch.maximum(m, s.max(-1).values)
                            alpha = torch.exp2(m - mx)
                            p = torch.exp2(s - mx[:, None])
                            l = l * alpha + p.sum(-1)
                            acc = acc * alpha[:, None] + p.to(BF).float() @ vf[b, lo:lo + 16, kvh]
                            warps[w] = (mx, l, acc)
                    mb = torch.stack([m for m, _, _ in warps]).max(0).values
                    lb, ab = torch.zeros(nh), torch.zeros(nh, D)
                    for m, l, acc in warps:  # warp order
                        f = torch.exp2(m - mb)
                        lb = lb + f * l
                        ab = ab + f[:, None] * acc
                    ranks.append((mb, lb, ab))
                mx = torch.stack([m for m, _, _ in ranks]).max(0).values
                lt, o = torch.zeros(nh), torch.zeros(nh, D)
                for m, l, acc in ranks:  # rank order
                    f = torch.exp2(m - mx)
                    lt = lt + f * l
                    o = o + f[:, None] * acc
                safe = torch.where(lt > 0, lt, torch.ones_like(lt))
                out[b, 0, h0:h0 + nh] = torch.where((lt > 0)[:, None], o / safe[:, None],
                                                    torch.zeros_like(o))
    return out.to(BF), loaded


def _inputs(B, H, KV, D, W, mode, seed):
    """bf16 q and caches and chip_smoke's masks: "ragged" per-lane lengths in
    [1, W], "ring" a wrapped ring buffer, "empty_row" ragged with lane 1
    empty, "shared" one [W] mask of the first W - W // 7 slots."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF)
               for s in ((B, 1, H, D), (B, W, KV, D), (B, W, KV, D)))
    pos = np.arange(W)
    if mode == "shared":
        valid = pos < W - W // 7
    else:
        lens = rng.integers(1, W + 1, (B, 1))
        valid = pos[None] < lens
        if mode == "ring":
            start = rng.integers(1, W, (B, 1))
            valid = (pos[None] - start) % W < lens
        if mode == "empty_row":
            valid[1] = False
    return q, k, v, torch.from_numpy(np.ascontiguousarray(valid))


# B, H, KV, D, W, mask: g = 1, 4, 6, 7, 8; D = 64 and 128 (and 96, padded to
# 128); W off the tile; the serve steps at reduced B.
CASES = [
    (2, 4, 4, 128, 200, "ragged"),          # g 1, W off the tile
    (2, 8, 2, 64, 130, "ring"),             # g 4, D 64
    (1, 48, 8, 128, 528, "shared"),         # Nemotron-4's step at B 1: g 6
    (1, 32, 8, 128, 528, "shared"),         # Jamba's step at B 1: g 4
    (2, 14, 2, 128, 300, "empty_row"),      # g 7
    (2, 16, 2, 96, 257, "ragged"),          # g 8, D 96
    (1, 56, 8, 128, 1000, "ring"),          # LLaVA's heads, a ring over W 1,000
    (1, 32, 32, 64, 528, "shared"),         # MusicGen's step at B 1: g 1, D 64
    (3, 40, 2, 64, 96, "ragged"),           # g 20: two chunks of heads
]


def _case_id(c):
    return "-".join(map(str, c))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_emulated_schedule_within_the_gate(case):
    B, H, KV, D, W, mode = case
    q, k, v, valid = _inputs(B, H, KV, D, W, mode, seed=sum(case[:5]))
    got, loaded = _emulate(q, k, v, valid)
    want = decode_attention_plain(q, k, v, valid)
    ratio = chip_smoke._row_ratio(got, want, chip_smoke.BF16_TOL, unit=True)
    assert ratio <= MARGIN, ratio
    if mode == "empty_row":
        assert bool((got[1] == 0).all())
    # Every tile with a valid slot is loaded once by each chunk of heads,
    # and no other.
    mask = valid if valid.dim() == 2 else valid[None].expand(B, W)
    tiles = -(-W // BF16_TILE)
    with_valid = sum(bool(mask[b, t * BF16_TILE:(t + 1) * BF16_TILE].any())
                     for b in range(B) for t in range(tiles))
    assert loaded == with_valid * KV * -(-(H // KV) // BF16_ROWS)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_emulated_schedule_at_every_cluster(cluster):
    """``decode_variants --bf16 --sweep``'s clusters, ranks without a tile
    (16 ranks over 9 tiles) included, give the same output within the gate."""
    q, k, v, valid = _inputs(1, 12, 2, 128, 528, "ragged", seed=cluster)
    got, _ = _emulate(q, k, v, valid, cluster)
    want = decode_attention_plain(q, k, v, valid)
    assert chip_smoke._row_ratio(got, want, chip_smoke.BF16_TOL, unit=True) <= MARGIN


@pytest.mark.parametrize("case", [c for c in CASES if c[4] % 64 == 0 or c[4] in (96, 300)],
                         ids=_case_id)
def test_emulated_schedule_matches_pallas(case):
    B, H, KV, D, W, mode = case
    q, k, v, valid = _inputs(B, H, KV, D, W, mode, seed=sum(case[:5]))
    got, _ = _emulate(q, k, v, valid)
    to_jax = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    block_w = 64 if W % 64 == 0 else W
    want = decode_attention_pallas(to_jax(q), to_jax(k), to_jax(v), jnp.asarray(valid.numpy()),
                                   block_w=block_w, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    err = float((got.float() - want).abs().max())
    assert torch.allclose(got.float(), want, atol=ATTENTION_TOL, rtol=ATTENTION_TOL), err


# ------------------------------------------------------------- the plan
PLAN_SHAPES = [(B, KV, g, D, W) for B in (1, 2, 8) for KV in (1, 8, 40) for g in (1, 4, 6, 7, 20)
               for D in (64, 96, 128) for W in (1, 63, 64, 65, 528, 1000, 3408, 4096, 32768)]


def test_plan_every_rank_a_tile_portable_cluster_and_shared_memory():
    for shape in PLAN_SHAPES:
        B, KV, g, D, W = shape
        plan = bf16_decode_plan(*shape)
        assert plan.cluster in (1, 2, 4, 8), shape
        assert plan.tiles == -(-W // BF16_TILE)
        assert plan.cluster <= plan.tiles, shape
        assert all(len(_rank_tiles(plan.tiles, plan.cluster, r)) >= 1
                   for r in range(plan.cluster)), shape
        assert plan.per_rank == max(len(_rank_tiles(plan.tiles, plan.cluster, r))
                                    for r in range(plan.cluster))
        assert 1 <= plan.stages <= min(BF16_MAX_STAGES, plan.per_rank), shape
        assert plan.smem == bf16_decode_smem(plan.dp, plan.stages, plan.per_rank) <= BLOCK_SMEM
        assert plan.blocks == B * KV * -(-g // BF16_ROWS) * plan.cluster
        per_sm = -(-plan.blocks // SMS)
        if plan.cluster > 1:  # a cluster of more than one keeps to two blocks an SM
            assert per_sm <= 2 and per_sm * (plan.smem + 1024) <= SM_SMEM, shape
        if plan.cluster > 4:
            assert 2 * (plan.smem + 1024) <= SM_SMEM, shape


@pytest.mark.parametrize("cluster", range(1, BF16_MAX_CLUSTER + 1))
def test_forced_plans_fit_a_block(cluster):
    for shape in [(2, 8, 6, 128, 528), (8, 8, 5, 128, 4096), (2, 8, 7, 128, 3408)]:
        plan = bf16_decode_plan(*shape, cluster=cluster)
        assert plan.cluster == cluster and plan.smem <= BLOCK_SMEM
    with pytest.raises(ValueError):
        bf16_decode_plan(2, 8, 6, 128, 528, cluster=BF16_MAX_CLUSTER + 1)


def test_serve_steps_plans():
    """The serve steps' shares land at once (as many stages as tiles): one
    round trip of K and V a block, in one wave."""
    for name, (B, _, H, KV, D, W) in {**chip_smoke.SERVE_BF16_DECODE_ATTENTION,
                                      **chip_smoke.BF16_DECODE_NEXT}.items():
        plan = bf16_decode_plan(B, KV, H // KV, D, W)
        assert plan.blocks <= SMS, name
        # Qwen1.5-32B's 40/40 (80 groups, one block each: 9 tiles through 6
        # stages) and LLaVA's W 3,408 (14 tiles a rank through 6) cycle a ring.
        if name not in ("serve_qwen32_int8", "serve_llava"):
            assert plan.stages == plan.per_rank, name
    nemotron = bf16_decode_plan(2, 8, 6, 128, 528)
    assert (nemotron.cluster, nemotron.blocks, nemotron.stages) == (8, 128, 2)


def test_plan_constants_match_the_source():
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kTile") == BF16_TILE
    assert const("kRows") == BF16_ROWS
    assert const("kMaxStages") == BF16_MAX_STAGES
    assert const("kMaxCluster") == BF16_MAX_CLUSTER
    assert const("kBlockSmem") == BLOCK_SMEM
    assert const("kConsumers") == WARPS
    # The layout's sizes in the source, term by term.
    assert "1024 + static_cast<size_t>(stages) * kStage + kMerged + kStats + kQ + 8 * per_rank +" in text
    assert "16 * stages" in text


# ------------------------------------------- the variant and phase 2
def _launch_params(src, entry):
    found = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src.read_text())
    assert found, f"{entry} not in {src.name}"
    return [" ".join(p.split()[:-1]) for p in found.group(1).split(",")]


def test_simt_variant_takes_the_float32_launch_arguments():
    want = _launch_params(build.CSRC_DIR / "decode_attention.cu", "decode_attention_launch")
    assert _launch_params(decode_variants.SIMT_SOURCE, decode_variants.SIMT_ENTRY) == want
    assert len(want) == len(build._SIGNATURES["decode_attention_launch"])
    shipped = _launch_params(SOURCE, "decode_attention_bf16_launch")
    assert len(shipped) == len(build._SIGNATURES["decode_attention_bf16_launch"])


def test_simt_variant_is_not_linked():
    src = decode_variants.SIMT_SOURCE
    assert src.parent.name == "variants" and src.exists()
    assert src.name not in {p.name for p in build._sources()}
    for p in build._sources():
        assert decode_variants.SIMT_ENTRY not in p.read_text(), p.name
    # The float32 source keeps its one entry point; the bf16 one is the new source's.
    assert "decode_attention_bf16_launch" not in (build.CSRC_DIR / "decode_attention.cu").read_text()


def test_phase2_gates_the_decode_kernels():
    assert set(chip_smoke.BF16_DECODE_KERNELS) == {"decode_bf16_kernel<64>", "decode_bf16_kernel<128>"}
    assert set(chip_smoke.BF16_DECODE_KERNELS) <= set(chip_smoke.BF16_TENSOR_CORE_KERNELS)
    assert set(chip_smoke.BF16_DECODE_KERNELS) <= set(chip_smoke.BF16_NO_SPILL)
    assert not set(chip_smoke.BF16_DECODE_KERNELS) & set(chip_smoke.BF16_HGMMA_KERNELS)
    text = SOURCE.read_text()
    assert re.search(r"template <int DP>\s*__global__ void __launch_bounds__\([^)]*\)\s*"
                     r"decode_bf16_kernel\(", text)
    for name in chip_smoke.BF16_DECODE_KERNELS:
        dp = name[:-1].split("<")[1]
        symbol = f"_ZN57_GLOBAL__N__8d938ab4_24_decode_attention_bf16_cu_3fac11f118decode_bf16_kernelILi{dp}EEEv"
        assert chip_smoke._bf16_kernel_name(symbol) == name


# ---------------------------------- the float32 small-group kernel's split
WAVE = 528  # blocks of the float32 kernel at RMAX 2 an H100 holds: 132 SMs x 4
STEP = 32  # depths a block step reads (4 a warp, 8 warps)


def _pick_chunks(D, F, E, wave=WAVE):
    """moe_gmm_small.cu's pick_chunks at a wave of ``wave`` blocks."""
    pairs = E * -(-F // 128)
    whole = pairs if pairs % wave == 0 else pairs - pairs % wave
    rest = pairs - whole
    c = max(1, min(8, wave // rest if rest else 1))
    return min(c, -(-D // STEP))


def _chunk_ranges(D, chunks):
    steps = -(-D // STEP)
    return [(c * steps // chunks * STEP, min(D, (c + 1) * steps // chunks * STEP))
            for c in range(chunks)]


@pytest.mark.parametrize("E,D,F", [(64, 2048, 1408), (16, 4096, 14336), (64, 1408, 2048),
                                   (16, 14336, 4096)])
def test_f32_split_chunks_cover_d_and_add_in_order(E, D, F):
    chunks = _pick_chunks(D, F, E)
    assert chunks == {(64, 2048, 1408): 3, (16, 4096, 14336): 2}.get((E, D, F), 1)
    ranges = _chunk_ranges(D, chunks)
    assert ranges[0][0] == 0 and ranges[-1][1] == D
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    # At a reduced width with the same chunk boundaries' rule: the fp32
    # partials of each chunk, added in chunk order, against the plain loop.
    rng = np.random.default_rng(E + D)
    d, f, e = D // 16, 64, 4
    x = torch.from_numpy(rng.standard_normal((2 * e, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((e, d, f)).astype(np.float32)) / math.sqrt(d)
    sizes = torch.full((e,), 2, dtype=torch.int32)
    want = moe_gmm.moe_gmm_plain(x, w, sizes)
    got = torch.zeros_like(want)
    for g in range(e):
        rows = slice(2 * g, 2 * g + 2)
        for lo, hi in _chunk_ranges(d, chunks):
            got[rows] += x[rows, lo:hi] @ w[g, lo:hi]
    assert torch.allclose(got, want, atol=chip_smoke.GMM_TOL, rtol=chip_smoke.GMM_TOL)


def test_f32_split_only_a_partial_last_wave():
    # Pairs that fill whole waves keep D whole: Jamba's and DeepSeek's down
    # products, and any product of exactly one wave.
    assert _pick_chunks(14336, 4096, 16) == _pick_chunks(1408, 2048, 64) == 1
    assert _pick_chunks(4096, 128 * 33, 16) == 1  # 16 x 33 = 528 pairs, one wave
    # One pair past a whole wave: that pair alone is split, as far as 8
    # chunks and D's block steps allow.
    assert _pick_chunks(4096, 128, WAVE + 1) == 8
    assert _pick_chunks(64, 128, WAVE + 1) == 2
    # A partial wave of half the blocks: two chunks a pair.
    assert _pick_chunks(4096, 128, WAVE // 2) == 2
