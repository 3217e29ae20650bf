"""Parity of the port's prefill and decode with the JAX package on the CPU,
for every layer kind: GQA attention (with QKV bias, and with squared ReLU),
the int8 KV cache, MLA's latent cache, RWKV-6, Mamba, Jamba's Mamba +
attention + MoE window, MoE, audio (four codebooks) and VLM (media
prepended).  Also the copies of the reference's
``tests/test_arch_smoke.py::test_decode_matches_forward`` and
``tests/test_perf_features.py::test_int8_kv_cache_decode_accuracy``, the
step builders, and ``chunked_scan``.

Weights are made by the reference and carried over as numpy; tokens and
media embeddings are made with numpy from a seed.  Logits are held within
1e-4 x max |logits| of the reference's, and every cache leaf within 1e-4 x
its max magnitude; int8 codes within 1 of the reference's (XLA's division
may round the other way), their bfloat16 scales equal when quantizing the
same K/V.  MoE layers run at capacity factor 8, as the reference's decode
test, so both sides drop nothing.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import Model as JaxModel
from repro.models.layers import _quantize_kv as jax_quantize_kv
from repro.models.scan_utils import chunked_scan as jax_chunked_scan
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import Model, make_decode_step, make_prefill_step
from repro_torch.models.layers import _dequantize_kv, _quantize_kv
from repro_torch.models.scan_utils import chunked_scan, scan
from repro_torch.tree import tree_leaves

REL = 1e-4
# kind -> (architecture, replacements of its reduced configuration)
KINDS = {
    "attn": ("qwen1.5-32b", {}),
    "relu2": ("nemotron-4-15b", {}),
    "int8": ("qwen1.5-32b", {"kv_cache_dtype": "int8"}),
    "mla": ("deepseek-v2-lite-16b", {}),
    "rwkv6": ("rwkv6-7b", {}),
    "mamba": ("jamba-v0.1-52b", {}),
    "hybrid": ("jamba-v0.1-52b", {"block_pattern": "jamba[2:4]"}),
    "moe": ("phi3.5-moe-42b-a6.6b", {}),
    "audio": ("musicgen-large", {}),
    "vlm": ("llava-next-34b", {}),
}


def _cfg(module, arch, **kw):
    cfg = dataclasses.replace(module(arch), dtype="float32")
    if kw.get("block_pattern") == "jamba[2:4]":
        # The chip's 2-layer Jamba window: (mamba, dense), (attn, moe).
        kw["block_pattern"] = get_config(arch).block_pattern[2:4]
    cfg = dataclasses.replace(cfg, **kw)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    return cfg


@functools.lru_cache(maxsize=None)
def _pair(kind):
    arch, kw = KINDS[kind]
    model_j = JaxModel(_cfg(jax_reduced_config, arch, **kw))
    model_t = Model(_cfg(reduced_config, arch, **kw))
    params = jax.tree_util.tree_map(np.asarray, model_j.init_params(jax.random.PRNGKey(1)))
    return model_j, model_t, params


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.num_codebooks) if cfg.modality == "audio" else (B, S)
    tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    media = None
    if cfg.modality == "vlm":
        media = rng.standard_normal((B, cfg.num_media_tokens, cfg.d_model)).astype(np.float32)
    return tokens, media


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _rel_close(got, want, name):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max()) + 1e-9
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{name}: max err {err:.3e} > {REL} x {scale:.3e}"


def _caches_close(cache_t, cache_j, name):
    leaves_j = jax.tree_util.tree_leaves_with_path(cache_j)
    leaves_t = tree_leaves(cache_t)
    assert len(leaves_j) == len(leaves_t), name
    for (path, b), a in zip(leaves_j, leaves_t):
        where = f"{name} {jax.tree_util.keystr(path)}"
        assert tuple(a.shape) == tuple(b.shape), where
        if b.dtype == jnp.int8:  # codes: one apart where the division rounds otherwise
            assert a.dtype == torch.int8, where
            assert int(np.abs(a.numpy().astype(np.int32) - np.asarray(b, np.int32)).max()) <= 1, where
        elif b.dtype == jnp.bfloat16:
            assert a.dtype == torch.bfloat16, where
            _rel_close(a, np.asarray(b, np.float32), where)
        else:
            _rel_close(a, b, where)


@pytest.mark.parametrize("kind", list(KINDS))
def test_prefill_and_decode_match_reference(kind):
    model_j, model_t, params = _pair(kind)
    cfg = model_t.cfg
    p_t = params_from_numpy(params)
    B, S, T = 2, 12, 3
    tokens, media = _inputs(cfg, B, S + T, seed=len(kind))
    W = S + T + (0 if media is None else media.shape[1])
    media_j = None if media is None else jnp.asarray(media)
    media_t = None if media is None else torch.from_numpy(media)
    logits_j, cache_j = model_j.prefill(params, jnp.asarray(tokens[:, :S]), media_emb=media_j, window=W)
    with torch.no_grad():
        logits_t, cache_t = model_t.prefill(p_t, torch.from_numpy(tokens[:, :S]), media_emb=media_t,
                                            window=W)
    _rel_close(logits_t, logits_j, f"{kind} prefill logits")
    _caches_close(cache_t, cache_j, f"{kind} prefill cache")
    if kind == "int8":
        for name in ("k", "v"):
            c_t, c_j = cache_t["blocks"]["0"], cache_j["blocks"]["0"]
            deq_t = _dequantize_kv(c_t[f"{name}_q"], c_t[f"{name}_s"], torch.float32)
            deq_j = np.asarray(c_j[f"{name}_q"], np.float32) * np.asarray(c_j[f"{name}_s"], np.float32)
            step = np.asarray(c_j[f"{name}_s"], np.float32)  # one code
            assert (np.abs(deq_t.numpy() - deq_j) <= step * 1.01 + 1e-7).all(), name
    for k in range(S, S + T):
        logits_j, cache_j = model_j.decode_step(params, cache_j, jnp.asarray(tokens[:, k:k + 1]))
        with torch.no_grad():
            logits_t, cache_t = model_t.decode_step(p_t, cache_t, torch.from_numpy(tokens[:, k:k + 1]))
        _rel_close(logits_t, logits_j, f"{kind} decode logits at {k}")
        _caches_close(cache_t, cache_j, f"{kind} decode cache at {k}")
    assert int(cache_t["pos"]) == int(cache_j["pos"]) == W


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_kv_codes_and_bf16_scales_equal_the_reference(seed):
    x = np.random.default_rng(seed).standard_normal((2, 9, 4, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the scale's 1e-8 floor
    q_j, s_j = jax_quantize_kv(jnp.asarray(x))
    q_t, s_t = _quantize_kv(torch.from_numpy(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.bfloat16
    np.testing.assert_array_equal(s_t.float().numpy(), np.asarray(s_j, np.float32))
    diff = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j, np.int32))
    assert diff.max() <= 1 and diff.mean() < 1e-2


# -------------------------------------------- the reference's own checks
@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v2-lite-16b", "rwkv6-7b",
                                  "jamba-v0.1-52b", "musicgen-large", "llava-next-34b"])
def test_decode_matches_forward(arch):
    """``tests/test_arch_smoke.py::test_decode_matches_forward`` on the port
    (plus LLaVA, its media prepended): a decode step after a prefill gives
    the full forward's last logits, rel < 2e-3 as there."""
    cfg = _cfg(reduced_config, arch)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(2))
    B, S = 2, 16
    tokens, media = _inputs(cfg, B, S, seed=2)
    tokens = torch.from_numpy(tokens)
    media = None if media is None else torch.from_numpy(media)
    with torch.no_grad():
        x, _ = model.forward(params, tokens, media)
        full = model._head(params, x)
        _, cache = model.prefill(params, tokens[:, : S - 1], media_emb=media,
                                 window=S + (0 if media is None else media.shape[1]))
        dec, _ = model.decode_step(params, cache, tokens[:, S - 1 : S])
    a, b = full[:, -1].numpy(), dec[:, 0].numpy()
    rel = np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)
    assert rel < 2e-3, rel


def test_int8_kv_cache_decode_accuracy():
    """``tests/test_perf_features.py::test_int8_kv_cache_decode_accuracy`` on
    the port: int8 decode within 0.05 of the float32 cache's, the cache
    under 0.6 x its bytes."""
    cfg = dataclasses.replace(reduced_config("qwen1.5-32b"), dtype="float32")
    cfgq = dataclasses.replace(cfg, kv_cache_dtype="int8")
    m, mq = Model(cfg), Model(cfgq)
    params = m.init_params(torch.Generator().manual_seed(2))
    B, S = 2, 16
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        _, cache = m.prefill(params, tokens[:, : S - 1], window=S)
        dec, _ = m.decode_step(params, cache, tokens[:, S - 1 : S])
        _, cacheq = mq.prefill(params, tokens[:, : S - 1], window=S)
        decq, cq2 = mq.decode_step(params, cacheq, tokens[:, S - 1 : S])
    a, b = dec.numpy(), decq.numpy()
    rel = np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)
    assert rel < 0.05, rel
    assert cq2["blocks"]["0"]["k_q"].dtype == torch.int8

    def nbytes(c):
        return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(c))

    assert nbytes(cq2) < 0.6 * nbytes(cache)


def test_step_builders_are_prefill_and_decode():
    _, model, params = _pair("vlm")
    p_t = params_from_numpy(params)
    tokens, media = (torch.from_numpy(a) for a in _inputs(model.cfg, 2, 9, seed=3))
    batch = {"tokens": tokens[:, :8], "media_emb": media}
    with torch.no_grad():
        logits, cache = make_prefill_step(model, window=32)(p_t, batch)
        want, want_cache = model.prefill(p_t, tokens[:, :8], media_emb=media, window=32)
        torch.testing.assert_close(logits, want, rtol=0, atol=0)
        assert int(cache["pos"]) == 8 + model.cfg.num_media_tokens
        step, _ = make_decode_step(model)(p_t, cache, {"tokens": tokens[:, 8:9]})
        want_step, _ = model.decode_step(p_t, want_cache, tokens[:, 8:9])
    torch.testing.assert_close(step, want_step, rtol=0, atol=0)


# ------------------------------------------------------------ chunked_scan
def _step(c, x):
    h = torch.tanh(c["h"] * x["a"] + x["b"])
    return {"h": h}, (h.sum(-1), h * 0.5)


def _jax_step(c, x):
    h = jnp.tanh(c["h"] * x["a"] + x["b"])
    return {"h": h}, (h.sum(-1), h * 0.5)


@pytest.mark.parametrize("T,chunk", [(64, 16), (60, 16), (16, 16), (48, 1)])
def test_chunked_scan_matches_the_plain_scan_and_the_reference(T, chunk):
    """Chunked (T a multiple of chunk) or the plain scan (60 % 16, T <=
    chunk, chunk 1), as the reference's; gradients equal with and without
    remat."""
    rng = np.random.default_rng(T + chunk)
    a, b = (rng.standard_normal((T, 3, 5)).astype(np.float32) * 0.5 for _ in range(2))
    h0 = rng.standard_normal((3, 5)).astype(np.float32)
    hj, (sj, yj) = jax_chunked_scan(_jax_step, {"h": jnp.asarray(h0)},
                                    {"a": jnp.asarray(a), "b": jnp.asarray(b)}, chunk=chunk)
    runs = []
    for remat in (True, False):
        xs = {"a": torch.from_numpy(a).requires_grad_(True), "b": torch.from_numpy(b)}
        h = torch.from_numpy(h0).requires_grad_(True)
        ht, (st, yt) = chunked_scan(_step, {"h": h}, xs, chunk=chunk, remat=remat)
        for got, want in ((ht["h"], hj["h"]), (st, sj), (yt, yj)):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
        loss = (ht["h"] ** 2).sum() + (st * yt.sum(-1)).sum()
        runs.append(torch.autograd.grad(loss, [h, xs["a"]]))
        hp, (sp, yp) = scan(_step, {"h": torch.from_numpy(h0)}, {k: v.detach() for k, v in xs.items()})
        torch.testing.assert_close(hp["h"], ht["h"].detach(), rtol=0, atol=0)
    for g_remat, g_plain in zip(*runs):
        torch.testing.assert_close(g_remat, g_plain, rtol=0, atol=0)


def test_mamba_scan_in_chunks_matches_reference_with_gradients():
    """Mamba over T = 256 (two chunks of 128, each checkpointed, its
    elementwise work done a chunk at a time) against the reference's
    ``mamba_apply``, output and gradients within 1e-4."""
    from repro.models import ssm as jax_ssm
    from repro_torch.models import ssm

    cfg = _cfg(reduced_config, "jamba-v0.1-52b")
    cfg_j = _cfg(jax_reduced_config, "jamba-v0.1-52b")
    params = jax.tree_util.tree_map(np.asarray, jax_ssm.mamba_init(jax.random.PRNGKey(4), cfg_j))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 256, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def f(p, xx):
        return jnp.sum(jax_ssm.mamba_apply(p, xx, cfg_j) * cot)

    want, (gp_j, gx_j) = jax.value_and_grad(f, argnums=(0, 1))(params, jnp.asarray(x))
    p_t = params_from_numpy(params)
    names = sorted(p_t)
    for name in names:
        p_t[name].requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = torch.sum(ssm.mamba_apply(p_t, xt, cfg) * torch.from_numpy(cot))
    grads = torch.autograd.grad(got, [p_t[n] for n in names] + [xt])
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    _rel_close(grads[-1], gx_j, "dx")
    for name, g in zip(names, grads):
        _rel_close(g, gp_j[name], f"d{name}")
