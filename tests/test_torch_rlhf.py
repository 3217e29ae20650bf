"""Parity of the port's RLHF slice (``build_ppo_lm``: TokenEnv, the
transformer, LMTokenPolicy, VectorizedRolloutWorker) with the JAX package on
the CPU.

Inputs and weights are made with numpy or by the JAX package from a seed and
carried into the port with ``interop``; the port runs with ``device="cpu"``,
so its kernels' plain versions serve the path.  Sampling differs between the
two packages' generators, so actions are injected and only deterministic
functions are compared.  Tolerances: 1e-5 (abs and rel) for the forward
numerics (hidden states, logits, caches, env steps), 1e-4 for values and
log-probs read along an episode, for gradients, and for weights after SGD
steps.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JaxLayerSpec
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.core.operators import TrainOneStep as JaxTrainOneStep
from repro.models.transformer import Model as JaxModel
from repro.models.transformer import _fit_window as jax_fit_window
from repro.rl.lm_policy import LMTokenPolicy as JaxLMTokenPolicy
from repro.rl.token_env import TokenEnv as JaxTokenEnv
from repro.rl.token_env import TokenEnvState as JaxTokenEnvState
from repro_torch import prng
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core.operators import TrainOneStep
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch.rlhf import make_rlhf_worker
from repro_torch.models.transformer import Model, _fit_window
from repro_torch.rl import (
    EPS_STRIDE,
    MAX_LANES,
    ActorCriticPolicy,
    CartPole,
    InferenceActor,
    InferenceClient,
    LMTokenPolicy,
    SampleBatch,
    TokenEnv,
    TokenEnvState,
    VectorizedRolloutWorker,
    make_obs,
)
from repro_torch.tree import tree_leaves

TOL = 1e-5
EPISODE_TOL = 1e-4
LEARNER_TOL = 1e-4


def _close(got, want, tol=TOL, name=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol, err_msg=name)


def _tree_close(got, want, tol, name=""):
    got_l = tree_leaves(params_to_numpy(got))
    want_l = jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for i, (g, w) in enumerate(zip(got_l, want_l)):
        _close(g, w, tol, name=f"{name} leaf {i}")


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(heads, kv, d_model=32, layers=2):
    kw = dict(
        name="chain-test", arch_type="dense", num_layers=layers, d_model=d_model,
        num_heads=heads, num_kv_heads=kv, d_ff=64, vocab_size=32, head_dim=d_model // heads,
        dtype="float32",
    )
    return (
        JaxModelConfig(block_pattern=(JaxLayerSpec(kind="attn", mlp="dense"),), **kw),
        ModelConfig(block_pattern=(LayerSpec(kind="attn", mlp="dense"),), **kw),
    )


def _models(heads, kv, seed):
    cfg_j, cfg_t = _cfgs(heads, kv)
    model_j, model_t = JaxModel(cfg_j), Model(cfg_t)
    params = _numpy(model_j.init_params(jax.random.PRNGKey(seed)))
    return model_j, model_t, params


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("heads,kv", [(4, 4), (4, 2), (4, 1)])
def test_forward_and_prefill_match_reference(heads, kv):
    model_j, model_t, params = _models(heads, kv, seed=heads + kv)
    tokens = np.random.default_rng(kv).integers(0, 32, (2, 12)).astype(np.int32)
    p_t = params_from_numpy(params)
    h_j, _ = model_j.forward(params, jnp.asarray(tokens))
    h_t, _ = model_t.forward(p_t, torch.from_numpy(tokens))
    _close(h_t, h_j, name="forward hidden")
    lg_j, cache_j, hid_j = model_j.prefill(params, jnp.asarray(tokens), window=16, with_hidden=True)
    lg_t, cache_t, hid_t = model_t.prefill(p_t, torch.from_numpy(tokens), window=16, with_hidden=True)
    _close(lg_t, lg_j, name="prefill logits")
    _close(hid_t, hid_j, name="prefill hidden")
    assert int(cache_t["pos"]) == int(cache_j["pos"]) == 12
    assert tuple(cache_t["blocks"]["0"]["k"].shape) == (2, 2, 16, kv, 32 // heads)
    for name in ("k", "v"):
        _close(cache_t["blocks"]["0"][name], cache_j["blocks"]["0"][name], name=f"cache {name}")


def test_prefill_decode_chain_matches_reference_and_forward():
    """Generation through the KV cache tracks the reference's decode step by
    step, and the port's own no-cache forward (the reference's 2e-3 gate)."""
    model_j, model_t, params = _models(4, 2, seed=8)
    p_t = params_from_numpy(params)
    B, S, T = 2, 10, 6
    tokens = np.random.default_rng(8).integers(0, 32, (B, S + T)).astype(np.int32)
    _, cache_j = model_j.prefill(params, jnp.asarray(tokens[:, :S]), window=S + T)
    _, cache_t = model_t.prefill(p_t, torch.from_numpy(tokens[:, :S]), window=S + T)
    for k in range(S, S + T):
        dec_j, cache_j = model_j.decode_step(params, cache_j, jnp.asarray(tokens[:, k:k + 1]))
        dec_t, cache_t = model_t.decode_step(p_t, cache_t, torch.from_numpy(tokens[:, k:k + 1]))
        _close(dec_t, dec_j, name=f"decode logits at {k}")
        x, _ = model_t.forward(p_t, torch.from_numpy(tokens[:, :k + 1]))
        full = model_t._head(p_t, x[:, -1:])
        rel = float((full - dec_t).abs().max() / (full.abs().max() + 1e-9))
        assert rel < 2e-3, (k, rel)
    _close(cache_t["blocks"]["0"]["k"], cache_j["blocks"]["0"]["k"], name="cache after chain")


@pytest.mark.parametrize("S,W", [(24, 16), (7, 16), (16, 16)])
def test_fit_window_and_clamped_prefill_then_decode(S, W):
    x = np.random.default_rng(S).standard_normal((2, S, 3, 4)).astype(np.float32)
    _close(_fit_window(torch.from_numpy(x), W), jax_fit_window(jnp.asarray(x), W), name="fit_window")
    model_j, model_t, params = _models(4, 2, seed=9)
    p_t = params_from_numpy(params)
    tokens = np.random.default_rng(9).integers(0, 32, (2, S + 1)).astype(np.int32)
    _, cache_j = model_j.prefill(params, jnp.asarray(tokens[:, :S]), window=W)
    _, cache_t = model_t.prefill(p_t, torch.from_numpy(tokens[:, :S]), window=W)
    dec_j, _ = model_j.decode_step(params, cache_j, jnp.asarray(tokens[:, S:S + 1]))
    dec_t, _ = model_t.decode_step(p_t, cache_t, torch.from_numpy(tokens[:, S:S + 1]))
    _close(dec_t, dec_j, name="decode after clamp")


def _feature_config(feature):
    """The small model of ``_cfgs(4, 2)`` with one feature of the model zoo."""
    import dataclasses

    from repro_torch.configs.base import MLAConfig, MoEConfig, SSMConfig

    _, cfg = _cfgs(4, 2)
    return dataclasses.replace(cfg, **{
        "mamba": dict(block_pattern=(LayerSpec(kind="mamba", mlp="dense"),),
                      ssm=SSMConfig(kind="mamba", d_state=4)),
        "audio": dict(modality="audio", num_codebooks=2),
        "vlm": dict(modality="vlm", num_media_tokens=3),
        "moe": dict(block_pattern=(LayerSpec(kind="attn", mlp="moe"),),
                    moe=MoEConfig(num_experts=2, d_ff=8)),
        "rwkv6": dict(block_pattern=(LayerSpec(kind="rwkv6", mlp="dense"),),
                      ssm=SSMConfig(kind="rwkv6", head_dim=8)),
        "int8": dict(kv_cache_dtype="int8"),
        "mla": dict(mla=MLAConfig(kv_lora_rank=16, rope_head_dim=8, nope_head_dim=8, v_head_dim=8)),
        "hybrid": dict(block_pattern=(LayerSpec(kind="mamba", mlp="dense"), LayerSpec(kind="attn", mlp="moe")),
                       ssm=SSMConfig(kind="mamba", d_state=4), moe=MoEConfig(num_experts=2, d_ff=8)),
    }[feature])


@pytest.mark.parametrize("feature", ["mamba", "audio", "vlm", "moe", "rwkv6", "int8", "mla", "hybrid"])
def test_unported_model_features_raise(feature):
    """Each feature this test once found unported (raising
    ``NotImplementedError``) now builds, prefills and decodes: the prefill's
    cache has ``init_cache``'s structure and shapes, and two decode steps give
    finite logits of the modality's shape."""
    cfg = _feature_config(feature)
    model = Model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    B, S, W = 2, 4, 8
    shape = (B, S + 2, cfg.num_codebooks) if cfg.modality == "audio" else (B, S + 2)
    tokens = torch.randint(0, cfg.vocab_size, shape, generator=torch.Generator().manual_seed(1))
    media = torch.randn((B, cfg.num_media_tokens, cfg.d_model)) if cfg.modality == "vlm" else None
    empty = model.init_cache(B, W)
    with torch.no_grad():
        logits, cache = model.prefill(params, tokens[:, :S], media_emb=media, window=W)
        for k in (S, S + 1):
            logits, cache = model.decode_step(params, cache, tokens[:, k:k + 1])
            assert torch.isfinite(logits).all()
    want = (B, 1, cfg.num_codebooks, cfg.vocab_size) if cfg.modality == "audio" else (B, 1, cfg.vocab_size)
    assert tuple(logits.shape) == want
    assert int(cache["pos"]) == S + 2 + cfg.num_media_tokens * (media is not None)
    got_l, empty_l = tree_leaves(cache), tree_leaves(empty)
    assert [(tuple(a.shape), a.dtype) for a in got_l] == [(tuple(a.shape), a.dtype) for a in empty_l]


@pytest.mark.parametrize("num_envs", [1, 3])
def test_per_env_worker_over_a_token_env_acts_as_the_reference(num_envs):
    """``LMTokenPolicy.act`` (the per-env ``RolloutWorker``'s acting): a
    rollout over a ``TokenEnv`` from the reference's weights and key chain
    takes the reference's actions and observations, with values, advantages
    and returns within 1e-5.  Log-probs equal the reference's within 1e-5
    for one env.  For several, the reference's ``act`` reads every env's
    log-prob from env 0's distribution (its ``take_along_axis`` broadcasts a
    [1, 1, N] index over [1, N, V]); the port's are each env's own, checked
    against the port's logits."""
    from repro.rl.rollout_worker import RolloutWorker as JaxRolloutWorker
    from repro_torch.rl import RolloutWorker

    env_kw = dict(vocab_size=17, ctx=16, min_prompt=3, max_prompt=6, horizon=6)
    pol_kw = dict(vocab_size=17, ctx=16, d_model=32, n_layers=2, num_heads=4, num_kv_heads=2)
    kw = dict(algo="ppo", num_envs=num_envs, rollout_len=8, seed=5, worker_index=1)
    w_j = JaxRolloutWorker(JaxTokenEnv(**env_kw), JaxLMTokenPolicy(**pol_kw), **kw)
    w_t = RolloutWorker(TokenEnv(**env_kw), LMTokenPolicy(**pol_kw), device="cpu", **kw)
    w_t.set_weights(_numpy(w_j.get_weights()))
    b_j, b_t = w_j.sample(), w_t.sample()
    assert len(b_t["actions"]) == num_envs * 8
    for col in ("actions", "obs", "rewards", "dones"):
        np.testing.assert_array_equal(np.asarray(b_t[col]), np.asarray(b_j[col]), err_msg=col)
    for col in ("values", "advantages", "returns") + (("logp",) if num_envs == 1 else ()):
        _close(np.asarray(b_t[col]), b_j[col], TOL, name=col)
    obs = torch.as_tensor(np.asarray(b_t["obs"]))
    with torch.no_grad():
        logits, _ = w_t.policy.logits_value(w_t.params, obs)
    own = torch.log_softmax(logits, -1).gather(-1, torch.as_tensor(np.asarray(b_t["actions"]))[:, None].long())
    _close(np.asarray(b_t["logp"]), own[:, 0].numpy(), TOL, name="logp under each env's own logits")


# -------------------------------------------------------------- TokenEnv
@pytest.mark.parametrize("sync", [True, False])
def test_token_env_step_raw_matches_reference(sync):
    ctx, N = 12, 5
    rng = np.random.default_rng(3)
    length = np.array([4, 5, 6, 7, 11], np.int32)
    tokens = np.where(np.arange(ctx)[None] < length[:, None], rng.integers(2, 11, (N, ctx)), 0)
    fields = (
        tokens.astype(np.int32), length, np.full(N, 4, np.int32),
        np.array([0, 1, 2, 3, 5], np.int32), np.array([False, False, True, False, False]),
    )
    actions = np.array([3, 1, 5, 1, 3], np.int32)  # EOS on lanes 1 and 3
    env_j = JaxTokenEnv(vocab_size=11, ctx=ctx, min_prompt=2, max_prompt=4, horizon=6, sync=sync)
    env_t = TokenEnv(vocab_size=11, ctx=ctx, min_prompt=2, max_prompt=4, horizon=6, sync=sync)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    out_j = jax.vmap(env_j.step_raw)(JaxTokenEnvState(*map(jnp.asarray, fields)), jnp.asarray(actions), keys)
    out_t = env_t.step_raw(TokenEnvState(*map(torch.from_numpy, fields)), torch.from_numpy(actions),
                           torch.from_numpy(np.asarray(keys).astype(np.int64)))
    for a, b in zip(out_t[0], out_j[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for i, name in enumerate(("obs", "reward", "terminated", "truncated"), start=1):
        _close(out_t[i].float(), np.asarray(out_j[i], np.float32), name=name)


def test_token_env_reset_and_obs_layout():
    env = TokenEnv(vocab_size=11, ctx=24, min_prompt=3, max_prompt=8, horizon=16)
    st, obs = env.reset(prng.split(prng.key(0), 64))
    assert tuple(obs.shape) == (64, env.obs_dim) and obs.dtype == torch.float32
    assert int(st.prompt_len.min()) >= 3 and int(st.prompt_len.max()) <= 8
    inside = torch.arange(24)[None] < st.prompt_len[:, None]
    assert bool((st.tokens[inside] >= 2).all()) and bool((st.tokens[~inside] == 0).all())
    torch.testing.assert_close(make_obs(st.tokens, st.length, st.t), obs, rtol=0, atol=0)
    with pytest.raises(ValueError, match="overrun"):
        TokenEnv(ctx=16, max_prompt=8, horizon=16)


# ----------------------------------------------------------- LMTokenPolicy
def _policies(ctx=16, vocab=11, d_model=16, n_layers=1, seed=11):
    pol_j = JaxLMTokenPolicy(ctx=ctx, vocab_size=vocab, d_model=d_model, n_layers=n_layers)
    pol_t = LMTokenPolicy(ctx=ctx, vocab_size=vocab, d_model=d_model, n_layers=n_layers)
    return pol_j, pol_t, _numpy(pol_j.init_params(jax.random.PRNGKey(seed)))


def _token_obs(rng, B, ctx, vocab, lo=3, hi=12):
    length = rng.integers(lo, hi, B).astype(np.int32)
    tokens = np.where(np.arange(ctx)[None] < length[:, None], rng.integers(2, vocab, (B, ctx)), 0)
    t = rng.integers(0, 4, B).astype(np.int32)
    return np.asarray(make_obs(*map(torch.from_numpy, (tokens.astype(np.int32), length, t))))


def test_lm_policy_logits_value_matches_reference():
    pol_j, pol_t, params = _policies()
    obs = _token_obs(np.random.default_rng(0), 6, 16, 11).reshape(2, 3, 18)  # [T, N, D]
    lg_j, v_j = jax.jit(pol_j.logits_value)(params, jnp.asarray(obs))
    lg_t, v_t = pol_t.logits_value(params_from_numpy(params), torch.from_numpy(obs))
    _close(lg_t, lg_j, name="logits")
    _close(v_t, v_j, name="value")
    _close(pol_t.value(params_from_numpy(params), torch.from_numpy(obs)), v_j, name="value only")


def test_lm_policy_stateful_episode_matches_reference_with_injected_actions():
    """Along a live episode (prefill step, then decodes), the port's stateful
    values and the log-probs of the actions it samples match the reference's
    stateful values and its no-cache forward's log-probs of the same
    actions; from the same lane keys both sample the same tokens; the lane
    state keeps the [B, num_blocks, ...] layout."""
    env_j = JaxTokenEnv(vocab_size=11, ctx=16, min_prompt=3, max_prompt=6, horizon=8)
    env_t = TokenEnv(vocab_size=11, ctx=16, min_prompt=3, max_prompt=6, horizon=8)
    pol_j, pol_t, params = _policies(n_layers=2)
    p_t = params_from_numpy(params)
    B = 3
    sts_j, obs_j = jax.vmap(env_j.reset)(jax.random.split(jax.random.PRNGKey(12), B))
    sts_t = TokenEnvState(*(torch.from_numpy(np.array(x)) for x in sts_j))
    obs_t = torch.from_numpy(np.array(obs_j))
    state_j, state_t = pol_j.init_lane_state(B), pol_t.init_lane_state(B)
    assert tuple(state_t["blocks"]["0"]["k"].shape) == (B, 2, 16, 2, 8)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    keys_t = torch.from_numpy(np.asarray(keys).astype(np.int64))
    stateful_j = jax.jit(pol_j.compute_actions_stateful)
    logits_value_j = jax.jit(pol_j.logits_value)
    for i in range(env_t.horizon):
        a_t, lp_t, v_t, state_t = pol_t.compute_actions_stateful(p_t, obs_t, keys_t, state_t)
        a_j, _, v_j, state_j = stateful_j(params, jnp.asarray(obs_t.numpy()), keys, state_j)
        np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j), err_msg=f"tokens at step {i}")
        logits_f, _ = logits_value_j(params, jnp.asarray(obs_t.numpy()))
        lp_f = jax.nn.log_softmax(logits_f)[jnp.arange(B), jnp.asarray(a_t.numpy())]
        _close(v_t, v_j, EPISODE_TOL, name=f"value at step {i}")
        _close(lp_t, lp_f, EPISODE_TOL, name=f"logp at step {i}")
        sts_t, obs_t, _, term, _ = env_t.step_raw(sts_t, a_t, keys_t)
    assert bool(term.all())  # sync horizon
    for name in ("k", "v"):
        _close(state_t["blocks"]["0"][name], state_j["blocks"]["0"][name], EPISODE_TOL, name=name)
    gap = float(pol_t.decode_parity_gap(p_t, obs_t, state_t))
    assert gap < 1e-4, gap


def test_lm_policy_self_heals_after_state_loss():
    pol_j, pol_t, params = _policies()
    p_t = params_from_numpy(params)
    obs = torch.from_numpy(_token_obs(np.random.default_rng(2), 2, 16, 11))
    obs[:, 17] = 3.0  # mid-episode: t > 0, yet the fresh state has pos 0
    _, _, v_stale, state = pol_t.compute_actions_stateful(
        p_t, obs, prng.split(prng.key(0), 2), pol_t.init_lane_state(2)
    )
    _, v_f = pol_j.logits_value(params, jnp.asarray(obs.numpy()))
    _close(v_stale, v_f, EPISODE_TOL, name="re-prefilled value")
    torch.testing.assert_close(state["pos"], obs[:, 16].to(torch.int32), rtol=0, atol=0)


def _lm_batch(n, ctx, vocab, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    obs = _token_obs(rng, n, ctx, vocab)
    return SampleBatch(
        obs=obs, actions=rng.integers(0, vocab, n).astype(np.int32), rewards=f32(n),
        dones=(rng.random(n) < 0.1).astype(np.float32), logp=-np.abs(f32(n)) - 2.0,
        values=f32(n), next_obs=obs, advantages=f32(n), returns=f32(n),
    )


def test_lm_policy_loss_and_grads_match_reference():
    pol_j, pol_t, params = _policies(n_layers=2)
    batch = _lm_batch(24, 16, 11, seed=5)
    (loss_j, aux_j), grads_j = jax.jit(jax.value_and_grad(pol_j.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    p_t = params_from_numpy(params)
    leaves = [p.requires_grad_(True) for p in tree_leaves(p_t)]
    loss_t, aux_t = pol_t.loss(p_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads_t = torch.autograd.grad(loss_t, leaves)
    _close(loss_t, loss_j, LEARNER_TOL, name="loss")
    for k in aux_j:
        _close(aux_t[k], aux_j[k], LEARNER_TOL, name=k)
    for i, (g, w) in enumerate(zip(grads_t, jax.tree_util.tree_leaves(grads_j))):
        _close(g, w, LEARNER_TOL, name=f"grad leaf {i}")


# ---------------------------------------------------------------- worker
SAMPLE_COLUMNS = {
    "obs", "actions", "rewards", "dones", "terminateds", "truncateds", "logp", "values",
    "next_obs", "advantages", "returns", "eps_id",
}


def _worker(i=0, **kw):
    kw = {**dict(num_envs=4, rollout_len=8, d_model=16, n_layers=1, device="cpu"), **kw}
    return make_rlhf_worker(i, **kw)


def test_vector_worker_sample_columns_and_eps_id():
    w = _worker(2, rollout_len=20)
    assert w.decode == "cache"
    b = w.sample()
    assert set(b.keys()) == SAMPLE_COLUMNS and b.count == 4 * 20
    assert b["obs"].shape == (80, 34) and b["obs"].dtype == np.float32
    assert np.isfinite(b["advantages"]).all()
    np.testing.assert_allclose(b["returns"], b["advantages"] + b["values"], atol=1e-5)
    # Horizon 16 inside a 20-step rollout: each lane ends one episode.
    lane = np.repeat(np.arange(4), 20)
    count = np.tile((np.arange(20) >= 16).astype(np.int64), 4)
    np.testing.assert_array_equal(b["eps_id"], (2 * MAX_LANES + lane) * EPS_STRIDE + count)
    np.testing.assert_array_equal(b["terminateds"].reshape(4, 20)[:, 15], 1.0)
    assert w.episode_stats()["fragments_dropped"] == 0.0


def test_vector_worker_state_round_trip_is_bit_stable():
    w1 = _worker()
    w1.sample()
    state = w1.get_state()
    assert set(state) >= {"generator", "vstate", "act_rng", "lane_state"}
    assert state["lane_state"]["blocks"]["0"]["k"].shape == (4, 1, 32, 2, 8)  # [B, blocks, ...]
    ref = w1.sample()
    w2 = _worker(seed=5)
    w2.set_weights(w1.get_weights())
    w2.set_state(state)
    got = w2.sample()
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


def test_vector_worker_decode_reconfigure_and_fallback():
    w = _worker()
    assert w.configure_vectorization(decode="forward")["decode"] == "forward"
    b_fwd = w.sample()
    assert w.configure_vectorization(decode="cache")["decode"] == "cache"
    b_cache = w.sample()
    assert b_fwd.count == b_cache.count == 32
    assert w.configure_vectorization(vector=2)["vector"] == 2
    assert w.sample().count == 16
    with pytest.raises(ValueError, match="decode"):
        w.configure_vectorization(decode="bogus")
    with pytest.raises(ValueError, match="stateful"):
        VectorizedRolloutWorker(CartPole(), ActorCriticPolicy(4, 2), num_envs=2, rollout_len=4,
                                decode="cache", device="cpu")
    plain = VectorizedRolloutWorker(CartPole(), ActorCriticPolicy(4, 2), num_envs=2,
                                    rollout_len=4, device="cpu")
    assert plain.configure_vectorization(decode="cache")["decode"] == "forward"
    assert plain.sample().count == 8
    # inference='server' without a client falls back to local acting; with
    # one, the worker samples through the serving tier.
    assert plain.configure_vectorization(inference="server")["inference"] == "local"
    client = InferenceClient(InferenceActor(lambda: ActorCriticPolicy(4, 2), device="cpu"))
    served = VectorizedRolloutWorker(CartPole(), ActorCriticPolicy(4, 2), num_envs=2,
                                     rollout_len=4, inference="server", inference_client=client,
                                     device="cpu")
    assert served.sample().count == 8
    assert client.actor.stats()["num_requests"] == 4


def test_rlhf_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_rlhf_worker(0, num_envs=2, rollout_len=4, d_model=16, n_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorizedRolloutWorker(TokenEnv(), LMTokenPolicy(ctx=32, vocab_size=17), decode="cache")


# --------------------------------------------------------------- learner
class _LocalOnly:
    def __init__(self, worker):
        self._w = worker

    def local_worker(self):
        return self._w

    def sync_weights(self):
        pass


def test_train_one_step_matches_reference():
    from repro.launch.rlhf import make_rlhf_worker as jax_make_rlhf_worker

    kw = dict(num_envs=2, rollout_len=4, d_model=16, n_layers=2)
    w_j = jax_make_rlhf_worker(0, **kw)
    w_t = make_rlhf_worker(0, device="cpu", **kw)
    w_t.set_weights(_numpy(w_j.get_weights()))
    batch = _lm_batch(48, 32, 17, seed=6)
    _, info_j = JaxTrainOneStep(_LocalOnly(w_j), num_sgd_iter=2, sgd_minibatch_size=24)(batch.copy())
    _, info_t = TrainOneStep(_LocalOnly(w_t), num_sgd_iter=2, sgd_minibatch_size=24)(batch.copy())
    assert set(info_t) == set(info_j)
    for k in info_j:
        _close(info_t[k], info_j[k], LEARNER_TOL, name=k)
    _tree_close(w_t.get_weights(), _numpy(w_j.get_weights()), LEARNER_TOL, name="weights")


# ------------------------------------------------------------ end to end
def _result_shape(result):
    return {
        "keys": set(result),
        "info": set(result["info"]),
        "episodes": set(result["episodes"]),
        "counters": {k: v for k, v in result["counters"].items() if "bytes" not in k},
    }


def test_algorithm_ppo_lm_matches_reference_result_dict():
    from repro.core.workers import WorkerSet as JaxWorkerSet
    from repro.flow import Algorithm as JaxAlgorithm
    from repro.launch.rlhf import make_rlhf_worker as jax_make_rlhf_worker
    from repro_torch.core.workers import WorkerSet
    from repro_torch.flow import Algorithm

    kw = dict(num_envs=2, rollout_len=8, horizon=8, d_model=16, n_layers=1)
    plan = dict(train_batch_size=32, num_sgd_iter=2, sgd_minibatch_size=16)
    shapes = []
    for make_set, algo_cls, factory in (
        (WorkerSet.create, Algorithm, lambda i: make_rlhf_worker(i, device="cpu", **kw)),
        (JaxWorkerSet.create, JaxAlgorithm, lambda i: jax_make_rlhf_worker(i, **kw)),
    ):
        ws = make_set(factory, 2)
        algo = algo_cls.from_plan("ppo_lm", ws, **plan)
        try:
            assert "decode=cache" in algo.to_dot()
            results = [algo.train() for _ in range(2)]
        finally:
            algo.stop()
            ws.stop()
        shapes.append([_result_shape(r) for r in results])
        assert all(np.isfinite(r["info"]["loss"]) for r in results)
    assert shapes[0] == shapes[1]
    assert shapes[0][1]["counters"]["num_steps_trained"] == 2 * 32


def test_build_ppo_lm_validates_decode_and_sharded_learners_raise():
    from repro_torch import flow
    from repro_torch.core.workers import WorkerSet

    ws = WorkerSet.create(lambda i: _worker(i, num_envs=2, rollout_len=4), 1)
    try:
        with pytest.raises(ValueError, match="decode"):
            flow.build_ppo_lm(ws, decode="bogus")
        # The sharded learner is ported: the LM learner trains on 2 gloo ranks.
        with flow.Algorithm.from_plan("ppo_lm", ws, num_learners=2, train_batch_size=8,
                                      sgd_minibatch_size=8) as algo:
            info = algo.train()["info"]
        assert info["num_learners"] == 2 and np.isfinite(info["loss"])
    finally:
        ws.stop()


def test_rlhf_launch_dot_smoke(monkeypatch, capsys):
    from repro_torch.launch import rlhf

    monkeypatch.setattr(
        sys, "argv",
        ["rlhf", "--dot", "--device", "cpu", "--workers", "1", "--num-envs", "2",
         "--rollout-len", "4", "--d-model", "16", "--layers", "1"],
    )
    rlhf.main()
    out = capsys.readouterr().out
    assert "digraph" in out and "decode=cache" in out
