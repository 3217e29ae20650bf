"""The bf16 grouped-matmul kernels as they are laid out for Hopper, checked
on the CPU.

* The tile kernel (``csrc/moe_gmm_bf16.cu``): its walk of 128 x 128 output
  tiles, emulated in float32 on bf16 inputs.  Each persistent block takes
  tiles blockIdx.x, + gridDim.x, ...; a tile's rows start at its group's own
  row (``tile_at``, from the wrapper's ``_offsets``), rows past T and depths
  or columns past D or F read zeros, each K tile of 64 is summed from zero
  and added into the running sum, the output is rounded once, and a tile
  writes only its group's rows; the tiles past the last group write the
  zeros past it.  The emulation is held against ``moe_gmm_plain`` within
  phase 3's gate (2^-7, atol = rtol) and against the reference's Pallas
  kernel in interpret mode within its own 5e-2, and every output element is
  written exactly once.
* The small-group kernel (``csrc/moe_gmm_small.cu``'s bf16 kernel): its
  work units (the full waves' (group, slab) pairs whole, the last wave's
  split into chunks of D) cover every (expert, column, depth) exactly once,
  and the last unit of a split pair to take the ticket merges the chunks'
  fp32 partials in chunk order, so the bits do not depend on which unit
  arrives last.
* The designs that were replaced (``kernels/variants/``) take the shipped
  entry points' parameter lists, so ``moe_gmm_variants --bf16`` binds them
  with their ctypes signatures, and are not linked into the library; the
  tile kernel is gated in phase 2 for ``HGMMA`` and spills, the small-group
  bf16 kernels for spills.

Inputs are made with numpy from a seed.
"""

import importlib.util
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.moe_gmm import moe_gmm_pallas
from repro_torch.kernels import build, moe_gmm_variants
from repro_torch.kernels.moe_gmm import ROW_TILE, SMALL_COLS, _offsets, moe_gmm_plain

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BF = torch.bfloat16
BM, BN, BK = ROW_TILE, 128, 64  # the tile kernel's kBM, kBN, kBK
SMALL_STEP = 64  # depths of w a small-group block reads a step at bf16 (8 warps x 8)
GATE = chip_smoke.BF16_TOL
PALLAS_TOL = 5e-2  # tests/test_kernels.py's bf16 tolerance for the grouped matmul


def _inputs(sizes, D, F, tail, seed):
    rng = np.random.default_rng(seed)
    T = sum(sizes) + tail
    x = torch.from_numpy(rng.standard_normal((T, D), dtype=np.float32)).to(BF)
    w = torch.from_numpy((rng.standard_normal((len(sizes), D, F)) / np.sqrt(D)).astype(np.float32)).to(BF)
    return x, w, torch.tensor(sizes, dtype=torch.int32)


# ------------------------------------------------------------ tile kernel
def _tile_at(tile, ends, tile_ends, nc):
    """(row0, rows, col0, group) of a tile as the kernel's ``tile_at``
    finds it; group -1 for the zeros past the last group."""
    E = len(ends)
    used = tile_ends[E - 1] * nc
    if tile >= used:
        return ends[E - 1] + (tile - used) // nc * BM, BM, (tile - used) % nc * BN, -1
    g = 0
    while tile >= tile_ends[g] * nc:
        g += 1
    t_begin = tile_ends[g - 1] if g else 0
    row_tiles = tile_ends[g] - t_begin
    local = tile - t_begin * nc
    row0 = (ends[g - 1] if g else 0) + local % row_tiles * BM
    return row0, min(BM, ends[g] - row0), local // row_tiles * BN, g


def _emulate_tile(x, w, group_sizes, grid=5):
    """The tile kernel's output and how many times each element was written,
    its persistent blocks walking the tiles in turn."""
    (T, D), (E, _, F) = x.shape, w.shape
    ends, tile_ends = (t.tolist() for t in _offsets(group_sizes, T))
    nc = -(-F // BN)
    n_tiles = (tile_ends[E - 1] + -(-(T - ends[E - 1]) // BM)) * nc
    xp = torch.zeros((T + BM, -(-D // BK) * BK))  # reads past T or D give zeros
    xp[:T, :D] = x.float()
    wp = torch.zeros((E, xp.shape[1], nc * BN))   # and past D or F, within the expert
    wp[:, :D, :F] = w.float()
    out = torch.full((T, F), float("nan"))
    writes = torch.zeros((T, F), dtype=torch.int32)
    for block in range(grid):
        for tile in range(block, n_tiles, grid):
            row0, rows, col0, g = _tile_at(tile, ends, tile_ends, nc)
            rows, cols = min(rows, T - row0), min(BN, F - col0)
            if g < 0:
                out[row0:row0 + rows, col0:col0 + cols] = 0.0
                writes[row0:row0 + rows, col0:col0 + cols] += 1
                continue
            acc = torch.zeros((BM, BN))
            for k0 in range(0, D, BK):  # each K tile from zero, then added
                acc += xp[row0:row0 + BM, k0:k0 + BK] @ wp[g, k0:k0 + BK, col0:col0 + BN]
            out[row0:row0 + rows, col0:col0 + cols] = acc[:rows, :cols]
            writes[row0:row0 + rows, col0:col0 + cols] += 1
    return out.to(BF), writes


# sizes, D, F, rows past the last group, rows cut off x's end
TILE_CASES = [
    pytest.param([300, 0, 1000, 77, 129, 640, 1, 511], 1024, 1536, 0, 0, id="ragged-empty"),
    pytest.param([300, 0, 1000, 77, 129, 640, 1, 511], 1000, 1416, 250, 0, id="edges-tail"),
    pytest.param([300, 0, 1000, 77, 129, 640, 1, 511], 1000, 1416, 0, 600, id="edges-cut-at-T"),
    pytest.param([1, 2], 64, 64, 0, 0, id="tiny"),
    pytest.param([0, 0, 5], 72, 136, 3, 0, id="empty-first-groups"),
    pytest.param([256, 128, 384], 192, 200, 130, 0, id="aligned-tail"),
]


@pytest.mark.parametrize("sizes,D,F,tail,cut", TILE_CASES)
def test_emulated_tile_walk_within_the_gate(sizes, D, F, tail, cut):
    x, w, gs = _inputs(sizes, D, F, tail, sum(sizes) + D + F)
    x = x[: x.shape[0] - cut]
    got, writes = _emulate_tile(x, w, gs)
    want = moe_gmm_plain(x, w, gs)
    assert bool((writes == 1).all()), "an output element written other than once"
    assert torch.allclose(got.float(), want.float(), atol=GATE, rtol=GATE), \
        float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("grid", [1, 3, 7, 132])
def test_tile_walk_writes_every_element_once_for_any_grid(grid):
    x, w, gs = _inputs([130, 0, 7, 300], 64, 264, 140, grid)
    _, writes = _emulate_tile(x, w, gs, grid)
    assert bool((writes == 1).all())


# Groups that are multiples of the reference's block_m, as its kernel needs.
PALLAS_CASES = [
    pytest.param([128, 0, 256, 128], 64, 128, 128, 64, id="tiles-empty"),
    pytest.param([24, 0, 40, 8, 16], 72, 136, 8, 136, id="block8-edges"),
    pytest.param([256, 128], 200, 192, 128, 64, id="d-not-64"),
]


@pytest.mark.parametrize("sizes,D,F,block_m,block_n", PALLAS_CASES)
def test_emulated_tile_walk_matches_pallas(sizes, D, F, block_m, block_n):
    x, w, gs = _inputs(sizes, D, F, 0, 7 + D + F)
    got, _ = _emulate_tile(x, w, gs)
    f32 = (x.float().numpy(), w.float().numpy())
    want = moe_gmm_pallas(jnp.asarray(f32[0].astype(ml_dtypes.bfloat16)),
                          jnp.asarray(f32[1].astype(ml_dtypes.bfloat16)), jnp.asarray(gs.numpy()),
                          block_m=block_m, block_n=block_n, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert torch.allclose(got.float(), want, atol=PALLAS_TOL, rtol=PALLAS_TOL), \
        float((got.float() - want).abs().max())


# ------------------------------------------------------ small-group kernel
WAVE = 528  # blocks an H100 holds at once at RMAX 2 (132 SMs x 4)


def _whole(pairs, wave):
    """The pairs of the full waves, one unit each (``whole_pairs``)."""
    return pairs if pairs % wave == 0 else pairs - pairs % wave


def _units(E, D, F, chunks, wave=WAVE):
    """(unit, pair, chunk, group, first column, depths [d0, d1)) of every
    work unit, as the kernel derives them from blockIdx.x: the full waves'
    pairs whole, then the rest split into ``chunks``."""
    slabs = -(-F // SMALL_COLS)
    steps = -(-D // SMALL_STEP)
    whole = E * slabs if chunks == 1 else _whole(E * slabs, wave)
    for unit in range(whole + (E * slabs - whole) * chunks):
        if unit < whole:
            pair, chunk, d0, d1 = unit, 0, 0, D
        else:
            pair, chunk = whole + (unit - whole) // chunks, (unit - whole) % chunks
            d0 = chunk * steps // chunks * SMALL_STEP
            d1 = min(D, (chunk + 1) * steps // chunks * SMALL_STEP)
        yield unit, pair, chunk, pair // slabs, pair % slabs * SMALL_COLS, d0, d1


# The kernel takes at most one chunk a block step of depths (pick_chunks).
COVER_CASES = [(E, D, F, chunks, wave) for E, D, F in ((64, 2048, 1408), (64, 1408, 2048),
                                                        (16, 4096, 14336), (16, 14336, 4096),
                                                        (3, 1000, 1416), (2, 8, 8))
               for chunks in (1, 2, 3, 5, 8) for wave in (WAVE, 7)
               if chunks <= -(-D // SMALL_STEP)]


@pytest.mark.parametrize("E,D,F,chunks,wave", COVER_CASES)
def test_small_units_cover_every_expert_column_and_depth_once(E, D, F, chunks, wave):
    cover = np.zeros((E, -(-F // SMALL_COLS), D), np.int32)
    for _, _, _, e, col0, d0, d1 in _units(E, D, F, chunks, wave):
        assert d0 % SMALL_STEP == 0 and d0 < d1
        cover[e, col0 // SMALL_COLS, d0:d1] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("E,D,F,chunks,units", [
    (64, 2048, 1408, 3, 1056),   # DeepSeek up: 528 whole, then 176 pairs in 3
    (16, 4096, 14336, 2, 2000),  # Jamba up: 1,584 whole, then 208 in 2
    (64, 1408, 2048, 1, 1024),   # the down products: whole
    (16, 14336, 4096, 1, 512),
])
def test_small_last_wave_split_at_the_decode_products(E, D, F, chunks, units):
    pairs = E * -(-F // SMALL_COLS)
    rest = pairs - _whole(pairs, WAVE)
    assert max(1, min(8, WAVE // rest)) == chunks  # pick_chunks
    assert len(list(_units(E, D, F, chunks))) == units


def _emulate_small(x, w, group_sizes, chunks, wave, order):
    """The small-group kernel's output with units finishing in ``order``:
    each unit's fp32 partial over its depths, then the ticket, and the last
    unit of a (group, slab) adds the partials in chunk order.  Returns the
    output, the mergers and the tickets left."""
    (T, D), (E, _, F) = x.shape, w.shape
    ends = np.minimum(np.cumsum(group_sizes.numpy()), T)
    slabs = -(-F // SMALL_COLS)
    units = list(_units(E, D, F, chunks, wave))
    work = torch.zeros((chunks, T, F))
    tickets = np.zeros(E * slabs, np.int64)
    out = torch.zeros((T, F), dtype=BF)
    mergers = []
    whole = E * slabs if chunks == 1 else _whole(E * slabs, wave)
    for unit in order:
        _, pair, chunk, e, col0, d0, d1 = units[unit]
        begin, end = (ends[e - 1] if e else 0), ends[e]
        if begin == end:
            continue
        cols = slice(col0, min(F, col0 + SMALL_COLS))
        sums = x[begin:end, d0:d1].float() @ w[e, d0:d1, cols].float()
        if unit < whole:
            out[begin:end, cols] = sums.to(BF)
            continue
        work[chunk, begin:end, cols] = sums
        tickets[pair] += 1
        if tickets[pair] == chunks:  # atomicAdd returned chunks - 1: the last
            tickets[pair] = 0
            mergers.append(pair)
            total = torch.zeros((end - begin, cols.stop - cols.start))
            for c in range(chunks):
                total += work[c, begin:end, cols]
            out[begin:end, cols] = total.to(BF)
    return out, mergers, tickets


@pytest.mark.parametrize("chunks,wave", [(2, 5), (3, 7), (5, 100)])
def test_small_merge_gives_the_same_bits_whichever_unit_is_last(chunks, wave):
    sizes = [2, 0, 3, 2]
    x, w, gs = _inputs(sizes, 320, 264, 0, chunks)
    n = len(list(_units(len(sizes), 320, 264, chunks, wave)))
    rng = np.random.default_rng(chunks)
    orders = [list(range(n)), list(range(n))[::-1]] + [list(rng.permutation(n)) for _ in range(4)]
    runs = [_emulate_small(x, w, gs, chunks, wave, order) for order in orders]
    assert runs[0][1], "no pair was split"
    for out, mergers, tickets in runs:
        assert torch.equal(out, runs[0][0])
        assert sorted(mergers) == sorted(set(mergers)) and (tickets == 0).all()
    want = moe_gmm_plain(x, w, gs)
    assert torch.allclose(runs[0][0].float(), want.float(), atol=GATE, rtol=GATE)


# ----------------------------------------------------- variants and phase 2
def _source_text(src: Path) -> str:
    return re.sub(r'#include "([^"]+)"', lambda m: _source_text(src.parent / m.group(1)),
                  src.read_text())


def _launch_params(src, entry):
    """The parameter types of the C entry point ``entry`` in ``src``."""
    found = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", _source_text(src))
    assert found, f"{entry} not in {src.name}"
    return [" ".join(p.split()[:-1]) for p in found.group(1).split(",")]


VARIANTS = [(kind, name) for kind, table in (("tile", moe_gmm_variants.BF16_TILE_VARIANTS),
                                             ("small", moe_gmm_variants.BF16_SMALL_VARIANTS))
            for name in sorted(table)]


@pytest.mark.parametrize("kind,name", VARIANTS, ids=lambda v: str(v))
def test_moe_bf16_variants_take_the_shipped_launch_arguments(kind, name):
    table = (moe_gmm_variants.BF16_TILE_VARIANTS if kind == "tile"
             else moe_gmm_variants.BF16_SMALL_VARIANTS)
    src, entry, _ = table[name]
    like = moe_gmm_variants.BF16_ENTRY[kind]
    shipped = moe_gmm_variants.TILE_BF16 if kind == "tile" else moe_gmm_variants.SMALL_BF16
    want = _launch_params(shipped, like)
    assert _launch_params(src, entry) == want
    assert len(want) == len(build._SIGNATURES[like])


@pytest.mark.parametrize("src", sorted({s for table in (moe_gmm_variants.BF16_TILE_VARIANTS,
                                                        moe_gmm_variants.BF16_SMALL_VARIANTS)
                                        for s, _, _ in table.values()}), ids=lambda p: p.name)
def test_moe_bf16_variants_are_not_linked(src):
    linked = {p.name for p in build._sources()}
    if src.parent == build.CSRC_DIR:
        assert src.name in linked
    else:
        assert src.parent.name == "variants" and src.exists() and src.name not in linked


def test_variant_edits_each_apply_once():
    for src, _, edits in moe_gmm_variants.BF16_TILE_VARIANTS.values():
        text = src.read_text()
        for old, _ in edits:
            assert text.count(old) == 1, old


def test_redesigned_gmm_kernels_are_gated_for_hgmma_and_spills():
    assert "gmm_tile_bf16_kernel" in chip_smoke.BF16_HGMMA_KERNELS
    assert "gmm_tile_bf16_kernel" in chip_smoke.BF16_TENSOR_CORE_KERNELS
    no_spill = set(chip_smoke.BF16_NO_SPILL)
    assert {"gmm_tile_bf16_kernel", *chip_smoke.BF16_SMALL_KERNELS} <= no_spill


def test_units_and_tiles_match_the_sources():
    """The emulations' constants are the kernels' own."""
    tile = (build.CSRC_DIR / "moe_gmm_bf16.cu").read_text()
    for name, value in (("kBM", BM), ("kBN", BN), ("kBK", BK)):
        assert re.search(rf"constexpr int {name} = {value};", tile), name
    small = (build.CSRC_DIR / "moe_gmm_small.cu").read_text()
    assert re.search(rf"constexpr int kCols = {SMALL_COLS};", small)
    assert "static constexpr int kDepth = 8;" in small and "constexpr int kWarps = 8;" in small
    assert list(itertools.islice(_units(1, 8, 8, 1), 2)) == [(0, 0, 0, 0, 0, 0, 8)]
