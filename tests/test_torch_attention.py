"""Parity of the port's attention kernels' plain versions with the JAX
package on the CPU.

The CUDA kernels (``csrc/decode_attention.cu``, ``csrc/flash_attention.cu``)
run only on the GPU, where ``chip_smoke.py`` holds them against these plain
versions; here the plain versions are held against the reference's Pallas
kernels in interpret mode and its pure-jnp oracles, on inputs made with
numpy from a seed.  Tolerances: 1e-5 (abs and rel) for outputs, 1e-4 for
gradients (sums over every query row of a key run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import chunked_attention, decode_attention_ref
from repro_torch.kernels import build, decode_variants, flash_variants, ops
from repro_torch.kernels.decode_attention import (
    DECODE_ATTENTION_LAUNCHES,
    MIN_SPLIT_SLOTS,
    SMS,
    decode_attention_cuda,
    decode_attention_plain,
    decode_splits,
    heads_per_block,
    resident_blocks,
)
from repro_torch.kernels.flash_attention import (
    FLASH_BWD_LAUNCHES,
    FLASH_FWD_LAUNCHES,
    flash_attention_cuda,
    flash_attention_plain,
)

TOL = 1e-5
GRAD_TOL = 1e-4


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(B, Sq, Sk, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return _normal(rng, B, Sq, H, D), _normal(rng, B, Sk, KV, D), _normal(rng, B, Sk, KV, D)


# ------------------------------------------------------------ flash attention
# (B, Sq, Sk, H, KV, D, causal, window, q_offset, block): MHA / GQA / MQA,
# causal and not, sliding windows, a query offset into a longer key range,
# and 8-row tiles so the Pallas kernel visits several K tiles per row.
FLASH_CASES = [
    (2, 16, 16, 4, 4, 8, True, 0, 0, 128),
    (2, 16, 16, 4, 2, 8, False, 0, 0, 128),
    (1, 16, 16, 4, 1, 8, True, 5, 0, 128),
    (2, 16, 16, 4, 2, 8, False, 6, 0, 128),
    (1, 8, 24, 4, 2, 8, True, 0, 16, 128),
    (1, 32, 32, 2, 1, 8, True, 12, 0, 8),
]


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,q_offset,block", FLASH_CASES)
def test_flash_plain_matches_pallas_and_chunked_reference(
    B, Sq, Sk, H, KV, D, causal, window, q_offset, block
):
    q, k, v = _qkv(B, Sq, Sk, H, KV, D, seed=Sq * 31 + H * 7 + KV + window)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), **kw)
    pallas = flash_attention_pallas(
        *map(jnp.asarray, (q, k, v)), block_q=block, block_k=block, interpret=True, **kw
    )
    oracle = chunked_attention(*map(jnp.asarray, (q, k, v)), chunk=8, **kw)
    _close(got, pallas, name="vs pallas")
    _close(got, oracle, name="vs chunked_attention")


@pytest.mark.parametrize(
    "B,Sq,Sk,H,KV,D,causal,window,q_offset",
    [(2, 12, 12, 4, 2, 8, True, 0, 0), (1, 8, 20, 4, 1, 8, True, 6, 12), (2, 10, 10, 2, 2, 8, False, 0, 0)],
)
def test_flash_plain_gradient_matches_jax_grad_of_chunked_reference(
    B, Sq, Sk, H, KV, D, causal, window, q_offset
):
    q, k, v = _qkv(B, Sq, Sk, H, KV, D, seed=B + Sq + Sk + window)
    cot = _normal(np.random.default_rng(99), B, Sq, H, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def f(q, k, v):
        return jnp.sum(chunked_attention(q, k, v, chunk=4, **kw) * cot)

    grads_j = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention_plain(*xs, **kw)
    grads_t = torch.autograd.grad(out, xs, torch.from_numpy(cot))
    for name, g_t, g_j in zip("qkv", grads_t, grads_j):
        _close(g_t, g_j, GRAD_TOL, name=f"d{name}")


def test_flash_plain_rows_without_a_visible_key_are_zero():
    """The kernels re-mask the probabilities, so a query row that sees no key
    gives zeros (the reference averages uniformly there); every row that
    sees a key agrees with the reference."""
    q, k, v = _qkv(1, 8, 8, 2, 2, 8, seed=4)
    # Non-causal, window 3, queries at positions 6..13 against keys 0..7: a
    # query at position p sees keys k > p - 3, so positions 10..13 see none.
    out = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=False, window=3, q_offset=6)
    oracle = np.asarray(chunked_attention(*map(jnp.asarray, (q, k, v)), causal=False, window=3, q_offset=6))
    visible = (np.arange(8)[None, :] > (6 + np.arange(8))[:, None] - 3).any(axis=1)
    assert visible.tolist() == [True, True, True, True, False, False, False, False]
    np.testing.assert_array_equal(out[:, ~visible].numpy(), 0.0)
    _close(out[:, visible], oracle[:, visible])


# ----------------------------------------------------------- decode attention
def _decode_inputs(B, W, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return _normal(rng, B, 1, H, D), _normal(rng, B, W, KV, D), _normal(rng, B, W, KV, D)


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (4, 1)])
def test_decode_plain_matches_pallas_and_reference_with_shared_mask(H, KV):
    q, kc, vc = _decode_inputs(3, 16, H, KV, 8, seed=H * 10 + KV)
    valid = np.arange(16) <= 9
    got = decode_attention_plain(*map(torch.from_numpy, (q, kc, vc, valid)))
    args = [jnp.asarray(x) for x in (q, kc, vc, valid)]
    _close(got, decode_attention_pallas(*args, interpret=True), name="vs pallas")
    _close(got, decode_attention_ref(*args), name="vs ref")


def test_decode_plain_per_lane_mask_and_all_invalid_row():
    q, kc, vc = _decode_inputs(4, 16, 4, 2, 8, seed=7)
    lens = np.array([16, 1, 0, 9])  # lane 2 has an empty cache
    valid = np.arange(16)[None, :] < lens[:, None]
    got = decode_attention_plain(*map(torch.from_numpy, (q, kc, vc, valid)))
    args = [jnp.asarray(x) for x in (q, kc, vc, valid)]
    _close(got, decode_attention_pallas(*args, interpret=True), name="vs pallas")
    _close(got, decode_attention_ref(*args), name="vs ref")
    np.testing.assert_array_equal(got[2].numpy(), 0.0)
    # A [W] mask is the [B, W] mask with every row equal.
    shared = np.arange(16) < 5
    a = decode_attention_plain(*map(torch.from_numpy, (q, kc, vc, shared)))
    b = decode_attention_plain(*map(torch.from_numpy, (q, kc, vc, np.broadcast_to(shared, (4, 16)).copy())))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# The CUDA kernel's order of arithmetic, emulated in float32: the window cut
# into `splits` equal splits; in each, warp w of 8 walks the split's valid
# slots w, w + 8, ... in groups of U (the kernel's rows in flight per warp),
# one online-softmax rescale per group; the warps' states merged in warp
# order, then the splits' in split order (a split with no valid slot carries
# m = -1e30, l = 0).  Held against the Pallas kernel and the oracle, the
# emulation shows that splitting and merging keep the reference's answer.
WARPS = 8


def _unroll(g: int) -> int:
    """``unroll_for`` of ``csrc/decode_attention.cu`` for D <= 128."""
    return 4 if heads_per_block(g) <= 4 else 2


def _merge(states):
    m = torch.stack([s[0] for s in states])  # [n, g]
    mx = m.max(dim=0).values
    f = torch.exp(m - mx)
    lt = sum(s[1] * f[i] for i, s in enumerate(states))
    acc = sum(s[2] * f[i][:, None] for i, s in enumerate(states))
    return mx, lt, acc


def _split_decode(q, kc, vc, valid, splits):
    B, _, H, D = q.shape
    W, KV = kc.shape[1], kc.shape[2]
    g = H // KV
    U = _unroll(g)
    valid = valid if valid.dim() == 2 else valid[None].expand(B, W)
    scale = torch.tensor(1.0 / np.sqrt(D), dtype=torch.float32)
    split_len = -(-W // splits)
    out = torch.zeros_like(q)
    for b in range(B):
        for kvh in range(KV):
            qs = q[b, 0, kvh * g:(kvh + 1) * g]
            split_states = []
            for s in range(splits):
                w0, w1 = s * split_len, min(W, (s + 1) * split_len)
                warp_states = []
                for warp in range(WARPS):
                    slots = [w for w in range(w0 + warp, w1, WARPS) if valid[b, w]]
                    m = torch.full((g,), -1e30)
                    lt, acc = torch.zeros(g), torch.zeros(g, D)
                    for i in range(0, len(slots), U):
                        grp = slots[i:i + U]
                        sc = (qs @ kc[b, grp, kvh].T) * scale
                        m_new = torch.maximum(m, sc.max(dim=-1).values)
                        alpha = torch.exp(m - m_new)
                        p = torch.exp(sc - m_new[:, None])
                        lt = lt * alpha + p.sum(dim=-1)
                        acc = acc * alpha[:, None] + p @ vc[b, grp, kvh]
                        m = m_new
                    warp_states.append((m, lt, acc))
                split_states.append(_merge(warp_states))
            _, lt, acc = _merge(split_states)
            res = acc / torch.where(lt > 0, lt, 1.0)[:, None]
            out[b, 0, kvh * g:(kvh + 1) * g] = torch.where((lt > 0)[:, None], res, 0.0)
    return out


SPLIT_W = 64


def _split_masks(kind: str) -> np.ndarray:
    """[2, 64] masks: "prefix" (ragged lengths), "ring" (a wrapped ring
    buffer, not a prefix), "empty_split" (lane 0 valid only at both ends,
    so every middle split is empty), "all_invalid" (lane 0 has no valid
    slot and must give exact zeros)."""
    pos = np.arange(SPLIT_W)
    if kind == "prefix":
        return pos[None, :] < np.array([40, 7])[:, None]
    if kind == "ring":
        start, length = np.array([50, 10]), np.array([30, 20])
        return (pos[None, :] - start[:, None]) % SPLIT_W < length[:, None]
    if kind == "empty_split":
        return np.stack([(pos < 5) | (pos >= 60), (pos >= 20) & (pos < 30)])
    assert kind == "all_invalid"
    return np.stack([np.zeros(SPLIT_W, bool), pos < 33])


_SPLIT_REF_CACHE: dict = {}


def _split_case(H, KV, kind):
    """Inputs of one case and the Pallas kernel's and the oracle's answers,
    computed once for all the splits."""
    key = (H, KV, kind)
    if key not in _SPLIT_REF_CACHE:
        q, kc, vc = _decode_inputs(2, SPLIT_W, H, KV, 16, seed=H + KV)
        valid = _split_masks(kind)
        args = [jnp.asarray(x) for x in (q, kc, vc, valid)]
        _SPLIT_REF_CACHE[key] = ((q, kc, vc, valid),
                                 np.asarray(decode_attention_pallas(*args, interpret=True)),
                                 np.asarray(decode_attention_ref(*args)))
    return _SPLIT_REF_CACHE[key]


@pytest.mark.parametrize("kind", ["prefix", "ring", "empty_split", "all_invalid"])
@pytest.mark.parametrize("H,KV", [(20, 20), (40, 8)])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_decode_emulation_matches_pallas_and_reference(splits, H, KV, kind):
    inputs, pallas, ref = _split_case(H, KV, kind)
    got = _split_decode(*map(torch.from_numpy, inputs), splits)
    _close(got, pallas, name="vs pallas")
    _close(got, ref, name="vs ref")
    if kind == "all_invalid":
        np.testing.assert_array_equal(got[0].numpy(), 0.0)
    if kind == "empty_split" and splits > 2:
        split_len = -(-SPLIT_W // splits)
        assert not inputs[3][0, split_len:2 * split_len].any()  # a split with no valid slot


@pytest.mark.parametrize(
    "B,KV,g,D,W",
    [(8, 20, 1, 128, 256), (8, 8, 5, 128, 4096), (8, 8, 5, 128, 1000), (4, 20, 1, 128, 256),
     (1, 1, 1, 128, 1), (1, 8, 4, 128, 32768), (64, 32, 1, 128, 2048), (2, 4, 8, 256, 100),
     (3, 2, 3, 64, 65), (1, 2, 1, 256, 4096)],
)
def test_decode_splits_fill_one_wave_within_the_window(B, KV, g, D, W):
    splits = decode_splits(B, KV, g, D, W)
    assert 1 <= splits <= W
    groups = B * KV * -(-g // heads_per_block(g))
    capacity = SMS * resident_blocks(g, D)  # one wave of resident blocks
    # The most splits that fit one wave, each at least MIN_SPLIT_SLOTS long.
    assert splits == 1 or (groups * splits <= capacity and W // splits >= MIN_SPLIT_SLOTS)
    assert groups * (splits + 1) > capacity or W // (splits + 1) < MIN_SPLIT_SLOTS
    if (B, KV, g, D, W) == (8, 20, 1, 128, 256):  # the RLHF path: 2 splits, 320 blocks
        assert (splits, groups * splits) == (2, 320)
    if (B, KV, g, D, W) == (8, 8, 5, 128, 4096):  # GQA 40/8: 4 splits, 256 blocks
        assert (splits, groups * splits) == (4, 256)


# ------------------------------------------------------------------ wrappers
def test_attention_wrappers_refuse_cpu_tensors_and_ops_dispatch_by_device():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 8, 2, 2, 32, seed=1))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    qd, kc, vc = map(torch.from_numpy, _decode_inputs(2, 8, 2, 2, 32, seed=2))
    valid = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(qd, kc, vc, valid)
    counts = [c.value for c in (FLASH_FWD_LAUNCHES, FLASH_BWD_LAUNCHES, DECODE_ATTENTION_LAUNCHES)]
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*xs, causal=True)
    out.sum().backward()
    torch.testing.assert_close(out, flash_attention_plain(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(
        ops.decode_attention(qd, kc, vc, valid), decode_attention_plain(qd, kc, vc, valid), rtol=0, atol=0
    )
    assert [c.value for c in (FLASH_FWD_LAUNCHES, FLASH_BWD_LAUNCHES, DECODE_ATTENTION_LAUNCHES)] == counts


# ------------------------------------------------ precision of the kernels
# The CUDA flash kernels multiply on the tensor cores in 3xTF32: each fp32
# operand x is split into big = tf32(x) (to nearest) and small = x - big,
# which the tensor cores read truncated to TF32, and small*big + big*small +
# big*big is summed in fp32.  Here that arithmetic is emulated in PyTorch on
# the CPU, against an fp64 oracle, to show why the kernels take it and not
# one TF32 pass: the first keeps the forward's 1e-5 tolerance, with small
# rounded to nearest (cvt.rna.tf32.f32) or truncated as in the kernels, and
# the second does not.
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: on the 13 low mantissa bits of the
    bit pattern (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float32 truncated to TF32: how the tensor cores read an fp32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, small=_tf32) -> torch.Tensor:
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = small(a - a_big), small(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def _mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _tf32(a) @ _tf32(b)


def _attention_with(mm, q, k, v, mask):
    """Causal attention forward with its two products (Q K^T and P V) by
    ``mm``, the softmax in fp32."""
    s = mm(q, k.transpose(-1, -2)) * (1.0 / np.sqrt(q.shape[-1]))
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, -1e30)), dim=-1)
    return mm(p, v)


def test_tf32_rounding_emulation():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10  # TF32's spacing at 1
    cases = {1 + ulp / 4: 1.0, 1 + ulp / 2: 1 + ulp, 1 + 3 * ulp / 4: 1 + ulp, -(1 + ulp / 2): -(1 + ulp)}
    for x, want in cases.items():
        assert _tf32(one * x).item() == want, x
    x = torch.from_numpy(_normal(np.random.default_rng(0), 4096))
    rel = ((_tf32(x) - x).abs() / x.abs()).max().item()
    assert 2.0 ** -12 < rel <= 2.0 ** -11
    assert torch.equal(_tf32(_tf32(x)), _tf32(x))
    assert ((x - _tf32_toward_zero(x)) * x.sign() >= 0).all()
    assert ((_tf32_toward_zero(x) - x).abs() / x.abs()).max().item() <= 2.0 ** -10


@pytest.mark.parametrize("small", ["nearest", "toward_zero"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [256, 512])
def test_3xtf32_attention_products_keep_fp32_tolerance_and_one_tf32_pass_does_not(D, S, small):
    q, k, v = (torch.from_numpy(x[0].transpose(1, 0, 2).copy()) for x in _qkv(1, S, S, 2, 2, D, seed=D + S))
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool))
    oracle = _attention_with(torch.matmul, q.double(), k.double(), v.double(), mask)
    round_small = _tf32 if small == "nearest" else _tf32_toward_zero
    three = _attention_with(lambda a, b: _mm_3xtf32(a, b, round_small), q, k, v, mask)
    one = _attention_with(_mm_1xtf32, q, k, v, mask)
    _close(three, oracle, name=f"3xTF32, small rounded {small}")
    err_one = (one.double() - oracle).abs().max().item()
    assert err_one > 10 * TOL, f"one TF32 pass came within {err_one:.2e} of fp64"


@pytest.mark.parametrize("name", sorted(flash_variants.VARIANTS))
def test_flash_variants_edit_the_shipped_source(name):
    """``python -m repro_torch.kernels.flash_variants`` builds each variant by
    replacing text of ``csrc/flash_attention.cu``: each text must be there
    once, or the variant would not be the one its name says."""
    text = (build.CSRC_DIR / "flash_attention.cu").read_text()
    for old, new in flash_variants.VARIANTS[name]:
        assert text.count(old) == 1, old
        assert new != old


@pytest.mark.parametrize("name", sorted(decode_variants.VARIANTS))
def test_decode_variants_edit_the_shipped_source(name):
    """``python -m repro_torch.kernels.decode_variants`` builds the ring and
    two-launch variants by editing ``csrc/decode_attention.cu``, which holds
    the float32 kernel alone (the bf16 kernel is its own source): each text
    it replaces must be there once."""
    text = (build.CSRC_DIR / "decode_attention.cu").read_text()
    assert "decode_attention_bf16" not in text.replace("decode_attention_bf16.cu", "")
    for old, new in decode_variants.VARIANTS[name]:
        assert text.count(old) == 1, old
        assert new != old
