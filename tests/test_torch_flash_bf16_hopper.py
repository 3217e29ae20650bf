"""The bf16 flash-attention kernels of ``csrc/flash_attention_bf16.cu`` as
they are laid out for Hopper, checked on the CPU.

* The kernels' schedules, emulated in float32 with the kernels' roundings:
  the forward's 128-query blocks over 128-key tiles (from ``key_range`` and
  ``tile_span``), each tile's P V summed from zero and folded in as
  O = alpha (O + P_{j-1} V_{j-1}) one tile late, P rounded to bf16 and the
  row sum of the unrounded weights; the backward's dK/dV blocks of 128 keys
  over 64-query tiles of each of a group's query heads (``query_range``)
  and its dQ blocks of 128 queries over 64-key tiles.  The emulated forward
  is held against the reference's Pallas kernel in interpret mode (the
  reference's bf16 tolerance) and against the plain version within the
  card's per-row gate; the emulated backward against autograd through the
  plain version within ``chip_smoke.GRAD_ROW_TOL``'s gate.  The tiles each
  block visits cover every visible (query, key) pair exactly once.
* The design that was replaced (``kernels/variants/``) takes the shipped
  entry points' parameter lists, so ``flash_variants --bf16`` binds it
  with their ctypes signatures.
* ``chip_smoke.py``'s phase-2 lists name kernels that the sources define,
  and its symbol parser maps each one's mangled name back to that name, so
  a renamed kernel cannot drop out of the spill and ``HGMMA`` gates.

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

from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import build, flash_variants
from repro_torch.kernels.flash_attention import flash_attention_plain

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

BF = torch.bfloat16
BLOCK = 128  # rows a block owns: queries (forward, dQ) or keys (dK/dV)
FWD_COLS = 128  # keys of a forward tile
BWD_COLS = 64  # rows of a streamed backward tile
ATTENTION_TOL = 2e-2  # tests/test_kernels.py's bf16 tolerance for attention
MARGIN = 0.7  # the emulation's largest error over the card's per-row gate, at most


# ------------------------------------------------- the kernels' index math
def _visible(geo, qi, kj):
    Sq, Sk, causal, window, q_offset = geo
    qp = q_offset + qi
    ok = (qi < Sq) & (kj < Sk)
    if causal:
        ok &= kj <= qp
    if window:
        ok &= kj > qp - window
    return ok


def _key_range(geo, r0, r1):
    Sq, Sk, causal, window, q_offset = geo
    k_end = min(Sk, q_offset + r1) if causal else Sk
    k_begin = max(0, q_offset + r0 - window + 1) if window else 0
    return k_begin, k_end


def _query_range(geo, c0, c1):
    Sq, Sk, causal, window, q_offset = geo
    r_begin = max(0, c0 - q_offset) if causal else 0
    r_end = min(Sq, c1 - 1 + window - q_offset) if window else Sq
    return r_begin, r_end


NONE = -0x40000000  # an empty range's bound (kNone)


def _key_bounds(geo, qi):
    """The keys [lo, hi) query row qi sees (key_bounds: the forward's and
    dQ's masks)."""
    Sq, Sk, causal, window, q_offset = geo
    qp = q_offset + qi
    lo = qp - window + 1 if window else NONE
    hi = NONE if qi >= Sq else (min(Sk, qp + 1) if causal else Sk)
    return lo, hi


def _query_bounds(geo, kj):
    """The query rows [lo, hi) that see key kj (query_bounds: dK/dV's mask)."""
    Sq, Sk, causal, window, q_offset = geo
    lo = kj - q_offset if causal else NONE
    hi = NONE if kj >= Sk else (min(Sq, kj - q_offset + window) if window else Sq)
    return lo, hi


def _tile_span(begin, end, bn):
    first = begin // bn
    return first, (-(-end // bn) - first if end > begin else 0)


def _fwd_tiles(geo, q0):
    """The key tiles [k0, k0 + FWD_COLS) the forward block at q0 visits."""
    first, n = _tile_span(*_key_range(geo, q0, min(q0 + BLOCK, geo[0])), FWD_COLS)
    return [(first + j) * FWD_COLS for j in range(n)]


def _dq_tiles(geo, q0):
    first, n = _tile_span(*_key_range(geo, q0, min(q0 + BLOCK, geo[0])), BWD_COLS)
    return [(first + j) * BWD_COLS for j in range(n)]


def _dkdv_tiles(geo, k0):
    """The query tiles [r0, r0 + BWD_COLS) the dK/dV block at k0 streams
    (for each query head of its group)."""
    first, n = _tile_span(*_query_range(geo, k0, min(k0 + BLOCK, geo[1])), BWD_COLS)
    return [(first + j) * BWD_COLS for j in range(n)]


# [Sq, Sk, causal, window, q_offset]
GEOMETRIES = [
    (256, 256, True, 0, 0),
    (1000, 1000, True, 0, 0),
    (384, 384, True, 128, 0),
    (300, 700, True, 0, 400),
    (200, 300, False, 0, 0),
    (129, 129, True, 64, 0),
    (64, 512, True, 100, 448),
    (512, 512, False, 200, 0),
]


@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "-".join(map(str, g)))
def test_tiles_cover_every_visible_pair_once(geo):
    Sq, Sk = geo[0], geo[1]
    qi = torch.arange(Sq)[:, None]
    kj = torch.arange(Sk)[None, :]
    vis = _visible(geo, qi, kj)
    for tiles_of, block_rows, step, rows_are_queries in (
            (_fwd_tiles, Sq, FWD_COLS, True), (_dq_tiles, Sq, BWD_COLS, True),
            (_dkdv_tiles, Sk, BWD_COLS, False)):
        seen = torch.zeros(Sq, Sk, dtype=torch.int32)
        for b0 in range(0, block_rows, BLOCK):
            for c0 in tiles_of(geo, b0):
                if rows_are_queries:
                    seen[b0:b0 + BLOCK, c0:c0 + step] += 1
                else:
                    seen[c0:c0 + step, b0:b0 + BLOCK] += 1
        assert bool((seen[vis] == 1).all()), tiles_of.__name__
        assert int(seen.max()) <= 1, tiles_of.__name__


@pytest.mark.parametrize("geo", GEOMETRIES, ids=lambda g: "-".join(map(str, g)))
def test_row_bounds_are_the_visibility(geo):
    """A lane masks a tile against its rows' visible range [lo, hi), which
    must be exactly the visible keys of a query (forward, dQ) and the
    visible queries of a key (dK/dV), past the ragged edges too."""
    Sq, Sk = geo[0], geo[1]
    qi = torch.arange(Sq + BLOCK)[:, None]
    kj = torch.arange(Sk + BLOCK)[None, :]
    vis = _visible(geo, qi, kj)
    lo, hi = (torch.tensor(x)[:, None] for x in zip(*(_key_bounds(geo, q) for q in range(Sq + BLOCK))))
    assert torch.equal(vis, (kj >= lo) & (kj < hi))
    lo, hi = (torch.tensor(x)[None, :] for x in zip(*(_query_bounds(geo, k) for k in range(Sk + BLOCK))))
    assert torch.equal(vis, (qi >= lo) & (qi < hi))


# ------------------------------------------------------ emulated schedules
def _tensor(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(BF)


def _emulate_fwd(q, k, v, causal, window, q_offset):
    """The forward kernel's order of arithmetic in float32: (o bf16, lse)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    geo = (Sq, Sk, causal, window, q_offset)
    c = 1.0 / math.sqrt(D) * math.log2(math.e)
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.zeros(B, Sq, H, D)
    lse = torch.zeros(B, H, Sq)
    for h in range(H):
        kv = h // (H // KV)
        for q0 in range(0, Sq, BLOCK):
            rows = torch.arange(q0, q0 + BLOCK)
            qb = torch.zeros(B, BLOCK, D)
            qb[:, :min(BLOCK, Sq - q0)] = qf[:, q0:q0 + BLOCK, h]
            m = torch.full((B, BLOCK), -math.inf)
            l = torch.zeros(B, BLOCK)
            acc = torch.zeros(B, BLOCK, D)
            prev = None  # (P_{j-1} rounded to bf16, V_{j-1})
            for k0 in _fwd_tiles(geo, q0):
                cols = torch.arange(k0, k0 + FWD_COLS)
                kt, vt = torch.zeros(B, FWD_COLS, D), torch.zeros(B, FWD_COLS, D)
                n = max(0, min(FWD_COLS, Sk - k0))
                kt[:, :n], vt[:, :n] = kf[:, k0:k0 + n, kv], vf[:, k0:k0 + n, kv]
                s = torch.einsum("bqd,bkd->bqk", qb, kt)
                s = torch.where(_visible(geo, rows[:, None], cols[None, :]), s,
                                torch.full_like(s, -math.inf))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.where(m == -math.inf, torch.zeros_like(m), torch.exp2((m - m_new) * c))
                ms = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new * c)
                p = torch.exp2(s * c - ms[..., None])
                l = l * alpha + p.sum(-1)
                if prev is not None:  # O = alpha (O + P_{j-1} V_{j-1}), the product from zero
                    acc = (acc + torch.einsum("bqk,bkd->bqd", *prev)) * alpha[..., None]
                m = m_new
                prev = (p.to(BF).float(), vt)
            if prev is not None:
                acc = acc + torch.einsum("bqk,bkd->bqd", *prev)
            inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
            r = min(BLOCK, Sq - q0)
            o[:, q0:q0 + r, h] = (acc * inv[..., None])[:, :r]
            lse[:, h, q0:q0 + r] = torch.where(
                l > 0, (m * c + torch.log2(l)) * math.log(2), torch.full_like(l, math.inf))[:, :r]
    return o.to(BF), lse


def _emulate_bwd(q, k, v, o, lse, dout, causal, window, q_offset):
    """The backward kernels' order of arithmetic in float32: (dq, dk, dv) bf16."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    g = H // KV
    geo = (Sq, Sk, causal, window, q_offset)
    scale = 1.0 / math.sqrt(D)
    c = scale * math.log2(math.e)
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    delta = (gf * o.float()).sum(-1).permute(0, 2, 1)  # [B, H, Sq], from the bf16 O and dO
    lse2 = lse * math.log2(math.e)

    def rows(x, r0, n, head):  # rows [r0, r0 + n) of x[:, :, head], zeros past the end
        out = torch.zeros(B, n, *x.shape[3:])
        m = max(0, min(n, x.shape[1] - r0))
        out[:, :m] = x[:, r0:r0 + m, head]
        return out

    def vec(x, r0, n):  # [B, n] of a [B, S] row vector, zeros past the end
        out = torch.zeros(B, n)
        m = max(0, min(n, x.shape[1] - r0))
        out[:, :m] = x[:, r0:r0 + m]
        return out

    dk = torch.zeros(B, Sk, KV, D)
    dv = torch.zeros(B, Sk, KV, D)
    for kvh in range(KV):
        for k0 in range(0, Sk, BLOCK):
            keys = torch.arange(k0, k0 + BLOCK)
            kb, vb = rows(kf, k0, BLOCK, kvh), rows(vf, k0, BLOCK, kvh)
            dk_acc, dv_acc = torch.zeros(B, BLOCK, D), torch.zeros(B, BLOCK, D)
            for h in range(kvh * g, kvh * g + g):
                for r0 in _dkdv_tiles(geo, k0):
                    queries = torch.arange(r0, r0 + BWD_COLS)
                    qt, gt = rows(qf, r0, BWD_COLS, h), rows(gf, r0, BWD_COLS, h)
                    st = torch.einsum("bkd,bqd->bkq", kb, qt)
                    dpt = torch.einsum("bkd,bqd->bkq", vb, gt)
                    pt = torch.exp2(st * c - vec(lse2[:, h], r0, BWD_COLS)[:, None, :])
                    pt = torch.where(_visible(geo, queries[None, :], keys[:, None]), pt,
                                     torch.zeros_like(pt))
                    dst = pt * (dpt - vec(delta[:, h], r0, BWD_COLS)[:, None, :])
                    dv_acc = dv_acc + torch.einsum("bkq,bqd->bkd", pt.to(BF).float(), gt)
                    dk_acc = dk_acc + torch.einsum("bkq,bqd->bkd", dst.to(BF).float(), qt)
            n = min(BLOCK, Sk - k0)
            dk[:, k0:k0 + n, kvh] = (dk_acc * scale)[:, :n]
            dv[:, k0:k0 + n, kvh] = dv_acc[:, :n]
    dq = torch.zeros(B, Sq, H, D)
    for h in range(H):
        kvh = h // g
        for q0 in range(0, Sq, BLOCK):
            queries = torch.arange(q0, q0 + BLOCK)
            qb, gb = rows(qf, q0, BLOCK, h), rows(gf, q0, BLOCK, h)
            lq, dq_delta = vec(lse2[:, h], q0, BLOCK), vec(delta[:, h], q0, BLOCK)
            dq_acc = torch.zeros(B, BLOCK, D)
            for c0 in _dq_tiles(geo, q0):
                keys = torch.arange(c0, c0 + BWD_COLS)
                kt, vt = rows(kf, c0, BWD_COLS, kvh), rows(vf, c0, BWD_COLS, kvh)
                p = torch.exp2(torch.einsum("bqd,bkd->bqk", qb, kt) * c - lq[..., None])
                p = torch.where(_visible(geo, queries[:, None], keys[None, :]), p, torch.zeros_like(p))
                ds = p * (torch.einsum("bqd,bkd->bqk", gb, vt) - dq_delta[..., None])
                dq_acc = dq_acc + torch.einsum("bqk,bkd->bqd", ds.to(BF).float(), kt)
            n = min(BLOCK, Sq - q0)
            dq[:, q0:q0 + n, h] = (dq_acc * scale)[:, :n]
    return dq.to(BF), dk.to(BF), dv.to(BF)


# [B, Sq, Sk, H, KV, D, causal, window, q_offset]
CASES = [
    (1, 256, 256, 4, 2, 64, True, 0, 0),
    (1, 200, 200, 2, 1, 128, True, 0, 0),
    (1, 384, 384, 2, 2, 32, True, 128, 0),
    (1, 128, 384, 4, 2, 64, True, 0, 256),
    (2, 130, 200, 2, 2, 64, False, 0, 0),
]


def _case(case):
    B, Sq, Sk, H, KV, D, causal, window, q_offset = case
    rng = np.random.default_rng(sum(case[:6]) + window + q_offset)
    q, k, v = _tensor(rng, B, Sq, H, D), _tensor(rng, B, Sk, KV, D), _tensor(rng, B, Sk, KV, D)
    dout = _tensor(rng, B, Sq, H, D)
    return (q, k, v, dout), dict(causal=causal, window=window, q_offset=q_offset)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_forward_schedule_within_the_gate(case):
    (q, k, v, _), kw = _case(case)
    got, lse = _emulate_fwd(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    ratio = chip_smoke._row_ratio(got, want, chip_smoke.BF16_TOL, unit=True)
    assert ratio <= MARGIN, ratio
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(q.shape[2] // k.shape[2], dim=2)) / math.sqrt(q.shape[3])
    Sq, Sk = q.shape[1], k.shape[1]
    vis = _visible((Sq, Sk, kw["causal"], kw["window"], kw["q_offset"]),
                   torch.arange(Sq)[:, None], torch.arange(Sk)[None, :])
    want_lse = torch.logsumexp(torch.where(vis, s, torch.full_like(s, -math.inf)), dim=-1)
    assert torch.allclose(lse, want_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("case", [c for c in CASES if not c[8] and c[1] == c[2] and c[1] % 64 == 0],
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_forward_schedule_matches_pallas(case):
    (q, k, v, _), kw = _case(case)
    got, _ = _emulate_fwd(q, k, v, **kw)
    to_jax = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    want = flash_attention_pallas(to_jax(q), to_jax(k), to_jax(v), causal=kw["causal"],
                                  window=kw["window"], block_q=64, block_k=64, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    err = float((got.float() - want).abs().max())
    assert torch.allclose(got.float(), want, atol=ATTENTION_TOL, rtol=ATTENTION_TOL), err


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_backward_schedule_within_the_gate(case):
    (q, k, v, dout), kw = _case(case)
    o, lse = _emulate_fwd(q, k, v, **kw)
    got = _emulate_bwd(q, k, v, o, lse, dout, **kw)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(flash_attention_plain(*xs, **kw), xs, dout)
    with torch.no_grad():
        o32 = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    allow = [chip_smoke._dq_allowance(k, dout, o, o32), None, None]
    ratios = [chip_smoke._row_ratio(a, b, chip_smoke.GRAD_ROW_TOL, allowance=c)
              for a, b, c in zip(got, want, allow)]
    assert max(ratios) <= MARGIN, ratios


# ------------------------------------------------ variants and phase 2
def _source_text(src: Path) -> str:
    """``src`` with the sources it includes by relative path inlined."""
    return re.sub(r'#include "([^"]+)"', lambda m: _source_text(src.parent / m.group(1)),
                  src.read_text())


def _launch_params(src, entry):
    """The parameter types of the C entry point ``entry`` in ``src``."""
    found = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", _source_text(src))
    assert found, f"{entry} not in {src.name}"
    return [" ".join(p.split()[:-1]) for p in found.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(flash_variants.BF16_VARIANTS))
def test_flash_bf16_variants_take_the_shipped_launch_arguments(name):
    """``flash_variants --bf16`` binds every design's entry points with the
    shipped ones' ctypes signatures."""
    src, fwd, bwd = flash_variants.BF16_VARIANTS[name]
    shipped = build.CSRC_DIR / "flash_attention_bf16.cu"
    for entry, like in zip((fwd, bwd), flash_variants.BF16_ENTRY):
        want = _launch_params(shipped, like)
        assert _launch_params(src, entry) == want
        assert len(want) == len(build._SIGNATURES[like])


@pytest.mark.parametrize("name", sorted(set(flash_variants.BF16_VARIANTS) - {"shipped"}))
def test_flash_bf16_variants_are_not_linked(name):
    src = flash_variants.BF16_VARIANTS[name][0]
    assert src.parent.name == "variants" and src.exists()
    assert src.name not in {p.name for p in build._sources()}


_KERNEL = re.compile(r"(template\s*<([^>]*)>\s*)?__global__\s+void\s+"
                     r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def _defined_kernels() -> dict:
    """Kernel name -> number of template parameters, over csrc/*.cu."""
    found = {}
    for src in build._sources():
        for m in _KERNEL.finditer(src.read_text()):
            found[m.group(3)] = len(m.group(2).split(",")) if m.group(2) else 0
    return found


PHASE2_NAMES = sorted(set(chip_smoke.BF16_TENSOR_CORE_KERNELS + chip_smoke.BF16_NO_SPILL
                          + chip_smoke.BF16_HGMMA_KERNELS))


@pytest.mark.parametrize("name", PHASE2_NAMES)
def test_phase2_names_are_kernels_the_sources_define(name):
    base, _, args = name.partition("<")
    args = args.rstrip(">").split(",") if args else []
    assert _defined_kernels().get(base) == len(args), (name, _defined_kernels().get(base))
    # The parser of ptxas's and cuobjdump's symbols gives the name back.
    symbol = f"_ZN12_GLOBAL__N_1{len(base)}{base}" + (
        "I" + "".join(f"Li{a}E" for a in args) + "E" if args else "") + "Ev"
    assert chip_smoke._bf16_kernel_name(symbol) == name


def test_redesigned_flash_kernels_are_gated_for_hgmma_and_spills():
    flash = {f"flash_{k}_kernel<{d}>" for k in ("fwd_bf16", "bwd_bf16_dkdv", "bwd_bf16_dq")
             for d in (32, 64, 128)}
    assert set(chip_smoke.BF16_HGMMA_KERNELS) == flash | {"gmm_tile_bf16_kernel"}
    assert {n for n in flash if not n.endswith("<32>")} <= set(chip_smoke.BF16_NO_SPILL)
