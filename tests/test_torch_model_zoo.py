"""Parity of the port's model zoo with the JAX package on the CPU: the ten
architectures' configurations, the new parameter trees carried across by
``repro_torch.interop``, ``Model.loss`` and its gradients for each of the
ten at its reduced configuration, ``train_config``'s cut to a number of
layers, and the pretraining CLI on the six architectures this slice adds.

Weights are made by the reference and carried over as numpy; batches come
from the port's data pipeline (media embeddings for LLaVA, four codebooks
for MusicGen).  Tolerance 1e-4 (abs and rel) on the loss and on every
gradient leaf, in float32.  Prefill and decode are held in
``test_torch_model_zoo_serve.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as JAX_ARCHITECTURES
from repro.configs import reduced_config as jax_reduced_config
from repro.models import Model as JaxModel
from repro_torch.configs import ARCHITECTURES, InputShape, get_config, reduced_config
from repro_torch.data import make_batch
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.tree import tree_leaves

TOL = 1e-4
NEW = ["qwen1.5-32b", "nemotron-4-15b", "deepseek-v2-lite-16b", "jamba-v0.1-52b",
       "llava-next-34b", "musicgen-large"]
ALL = sorted(JAX_ARCHITECTURES)
SEQ, BATCH = 32, 2


def _close(got, want, tol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference model, port model, reference params as numpy) at the
    reduced configuration in float32 (made once an architecture; callers
    carry the numpy tree into fresh tensors)."""
    cfg_j = dataclasses.replace(jax_reduced_config(arch), dtype="float32")
    cfg_t = dataclasses.replace(reduced_config(arch), dtype="float32")
    model_j = JaxModel(cfg_j)
    return model_j, Model(cfg_t), _numpy(model_j.init_params(jax.random.PRNGKey(0)))


# ------------------------------------------------------------ configurations
def test_architectures_are_the_reference_ten():
    assert list(ARCHITECTURES) == list(JAX_ARCHITECTURES)


@pytest.mark.parametrize("arch", NEW)
def test_full_config_equals_the_reference_field_by_field(arch):
    ours, ref = dataclasses.asdict(get_config(arch)), dataclasses.asdict(JAX_ARCHITECTURES[arch])
    assert ours == ref
    assert dataclasses.asdict(reduced_config(arch)) == dataclasses.asdict(jax_reduced_config(arch))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-v0.1-52b", "musicgen-large"])
def test_interop_carries_the_new_trees(arch):
    """MLA's up-projections [lora, H, n], Mamba's A_log / D / conv_w, the
    codebook embeddings [K, V, d] and the audio head round-trip bitwise, and
    the port's own init makes the reference's shapes and dtypes."""
    model_j, model_t, params = _pair(arch)
    carried = params_to_numpy(params_from_numpy(params))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params), tree_leaves(carried)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    own = params_to_numpy(model_t.init_params(torch.Generator().manual_seed(0)))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params), tree_leaves(own)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
    cfg = model_t.cfg
    if cfg.mla is not None:
        m = cfg.mla
        attn = carried["blocks"]["0"]["attn"]
        assert attn["w_uk"].shape == (cfg.num_blocks, m.kv_lora_rank, cfg.num_heads, m.nope_head_dim)
        assert attn["w_uv"].shape == (cfg.num_blocks, m.kv_lora_rank, cfg.num_heads, m.v_head_dim)
    if cfg.ssm is not None:
        mamba = carried["blocks"]["0"]["attn"]
        d_in = cfg.ssm.expand * cfg.d_model
        assert mamba["A_log"].shape == (cfg.num_blocks, d_in, cfg.ssm.d_state)
        assert mamba["D"].shape == (cfg.num_blocks, d_in)
        assert mamba["conv_w"].shape == (cfg.num_blocks, cfg.ssm.d_conv, d_in)
    if cfg.modality == "audio":
        K, V = cfg.num_codebooks, cfg.vocab_size
        assert carried["embed"].shape == (K, V, cfg.d_model)
        assert carried["lm_head"].shape == (cfg.d_model, K * V)


# -------------------------------------------------------------- loss, grads
@pytest.mark.parametrize("arch", ALL)
def test_loss_and_gradients_match_reference(arch):
    model_j, model_t, params = _pair(arch)
    cfg = model_t.cfg
    batch = make_batch(cfg, InputShape("t", SEQ, BATCH, "train"), seed=0, step=0)
    media = batch.get("media_emb")
    assert (media is not None) == (cfg.modality == "vlm")

    def loss_j(p):
        return model_j.loss(p, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]),
                            media_emb=None if media is None else jnp.asarray(media))

    (want, parts_j), grads_j = jax.value_and_grad(loss_j, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    p_t = params_from_numpy(params)
    leaves = tree_leaves(p_t)
    for leaf in leaves:
        leaf.requires_grad_(True)
    got, parts_t = model_t.loss(p_t, torch.from_numpy(batch["tokens"]),
                                torch.from_numpy(batch["labels"]),
                                media_emb=None if media is None else torch.from_numpy(media))
    _close(got.detach(), want, name="loss")
    for key in ("nll", "aux"):
        _close(parts_t[key].detach(), parts_j[key], name=key)
    grads_t = torch.autograd.grad(got, leaves)
    for (path, g_j), g_t in zip(jax.tree_util.tree_leaves_with_path(grads_j), grads_t):
        _close(g_t, g_j, name=jax.tree_util.keystr(path))


def test_vlm_loss_skips_media_positions_and_audio_logits_are_per_codebook():
    _, model_t, params = _pair("llava-next-34b")
    p_t = params_from_numpy(params)
    cfg = model_t.cfg
    batch = make_batch(cfg, InputShape("t", SEQ, BATCH, "train"), seed=1, step=0)
    tokens, labels, media = (torch.from_numpy(batch[k]) for k in ("tokens", "labels", "media_emb"))
    assert tokens.shape == (BATCH, SEQ - cfg.num_media_tokens)
    x, _ = model_t.forward(p_t, tokens, media)
    assert x.shape == (BATCH, SEQ, cfg.d_model)
    logits = model_t._head(p_t, x[:, cfg.num_media_tokens:])
    nll = torch.nn.functional.cross_entropy(logits.reshape(-1, cfg.vocab_size), labels.reshape(-1).long(),
                                            ignore_index=-100)
    _, parts = model_t.loss(p_t, tokens, labels, media)
    _close(parts["nll"], nll, 1e-5, name="nll over text positions")

    _, audio, params = _pair("musicgen-large")
    cfg = audio.cfg
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, 8, cfg.num_codebooks),
                           generator=torch.Generator().manual_seed(0))
    x, _ = audio.forward(params_from_numpy(params), tokens)
    assert audio._head(params_from_numpy(params), x).shape == (BATCH, 8, cfg.num_codebooks, cfg.vocab_size)


# ------------------------------------------------------------ layer cuts
def test_train_config_cut_keeps_a_prologue():
    cfg = train.train_config("deepseek-v2-lite-16b", layers=2)
    full = get_config("deepseek-v2-lite-16b")
    assert (cfg.num_layers, cfg.num_blocks) == (2, 1)
    assert cfg.prologue == full.prologue and cfg.block_pattern == full.block_pattern
    # The cut keeps the configuration's widths and its own dtype, bf16.
    assert (cfg.d_model, cfg.mla, cfg.moe, cfg.dtype) == (full.d_model, full.mla, full.moe, full.dtype)
    cfg = train.train_config("deepseek-v2-lite-16b", layers=5)
    assert (cfg.num_layers, cfg.num_blocks) == (5, 4)
    with pytest.raises(ValueError):
        train.train_config("deepseek-v2-lite-16b", layers=1)


def test_train_config_cut_takes_the_first_window_with_every_kind():
    full = get_config("jamba-v0.1-52b")
    cfg, note = train.train_config("jamba-v0.1-52b", layers=2, with_note=True)
    assert cfg.block_pattern == full.block_pattern[2:4]
    assert [(s.kind, s.mlp) for s in cfg.block_pattern] == [("mamba", "dense"), ("attn", "moe")]
    assert (cfg.num_layers, cfg.num_blocks, cfg.d_model, cfg.ssm) == (2, 1, 4096, full.ssm)
    assert "entries 2-3" in note
    assert train.pattern_window(full.block_pattern, 4) == 0
    assert train.train_config("jamba-v0.1-52b", layers=16).block_pattern == full.block_pattern
    with pytest.raises(ValueError):
        train.train_config("jamba-v0.1-52b", layers=1)  # one entry cannot hold both kinds
    with pytest.raises(ValueError):
        train.train_config("jamba-v0.1-52b", layers=12)  # not whole blocks


@pytest.mark.parametrize("arch", NEW)
def test_train_cli_smoke_runs_each_new_architecture(arch, capsys):
    train.main(["--arch", arch, "--device", "cpu", "--smoke", "--steps", "2", "--batch", "2",
                "--seq", "32"])
    out = capsys.readouterr().out
    assert f"{arch}-smoke" in out and "step    1 loss" in out
    losses = [float(line.split("loss ")[1].split()[0]) for line in out.splitlines() if " loss " in line]
    assert len(losses) == 2 and all(np.isfinite(losses))


# ------------------------------------------- the layouts stated, one device
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-7b", "deepseek-v2-lite-16b",
                                  "qwen1.5-4b"])
def test_sharding_annotations_change_nothing_on_one_device(arch):
    """The reference's ``shard`` calls in the SSM and MoE layers, and the
    layouts the port states with ``shard_map`` and ``dense``, compute
    nothing on one device: under axis rules bound to a 1 x 1 mesh (every
    placement replicated, no DTensor) the loss and every gradient are
    bitwise those without rules (Mamba, MoE, RWKV-6, MLA, GQA attention)."""
    from repro_torch.distributed.sharding import (
        DEFAULT_RULES, AxisRules, axis_rules_context, make_mesh)

    _, model_t, params = _pair(arch)
    batch = make_batch(model_t.cfg, InputShape("t", SEQ, BATCH, "train"), seed=0, step=0)
    media = batch.get("media_emb")

    def run():
        p_t = params_from_numpy(params)
        leaves = tree_leaves(p_t)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss, _ = model_t.loss(p_t, torch.from_numpy(batch["tokens"]),
                               torch.from_numpy(batch["labels"]),
                               media_emb=None if media is None else torch.from_numpy(media))
        return [loss.detach(), *torch.autograd.grad(loss, leaves)]

    plain = run()
    with axis_rules_context(AxisRules(DEFAULT_RULES, make_mesh((1, 1), ("data", "model"), "cpu"))):
        ruled = run()
    assert len(plain) == len(ruled)
    for a, b in zip(plain, ruled):
        assert torch.equal(a, b)
