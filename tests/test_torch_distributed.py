"""The port's sharding rules, placement trees, input specs and meshes
against the JAX package (``tests/test_distributed.py``'s distributed half,
and ``test_perf_features.py::test_spmd_learner_worker_trains``).

Specs are compared entry for entry with the reference's PartitionSpecs on
the same (16, 16) and (2, 16, 16) mesh shapes; the production mesh, which
needs a ``"fake"`` process group of 256 ranks, is built in a process of its
own.  Losses are held finite, as the reference's tests hold them.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.distributed.sharding import DEFAULT_RULES as JAX_RULES
from repro.distributed.sharding import AxisRules as JaxAxisRules
from repro.distributed.specs import cache_specs as jax_cache_specs
from repro.distributed.specs import param_specs as jax_param_specs
from repro.models import Model as JaxModel
from repro_torch.configs import INPUT_SHAPES, get_config, reduced_config
from repro_torch.distributed.hlo_cost import analyze_step
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    AxisRules,
    P,
    axis_rules_context,
    logical_spec,
    make_data_mesh,
    shard,
)
from repro_torch.distributed.specs import (
    Layout,
    cache_specs,
    opt_state_specs,
    param_specs,
)
from repro_torch.launch.input_specs import abstract_cache, abstract_params, decode_window_for, input_specs
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import Model, make_train_step
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["qwen3-14b", "deepseek-v2-lite-16b", "jamba-v0.1-52b", "rwkv6-7b", "musicgen-large"]


class FakeMesh:
    """Stand-in exposing mesh_dim_names/shape without a process group."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


def test_axis_rules_divisibility_drop():
    rules = AxisRules(DEFAULT_RULES, FakeMesh((16, 16), ("data", "model")))
    # 40 heads do not divide the 16-way model axis -> replicated.
    assert rules.resolve(["heads"], shape=[40]) == P(None)
    assert rules.resolve(["heads"], shape=[32]) == P("model")
    # batch maps to data (pod absent on single-pod mesh)
    assert rules.resolve(["batch"], shape=[256]) == P("data")


def test_axis_rules_multi_pod_batch():
    rules = AxisRules(DEFAULT_RULES, FakeMesh((2, 16, 16), ("pod", "data", "model")))
    spec = rules.resolve(["batch"], shape=[256])
    assert spec == P(("pod", "data"))
    # batch=1 (long_500k): nothing divides -> replicated
    assert rules.resolve(["batch"], shape=[1]) == P(None)


def test_axis_rules_no_double_axis_use():
    rules = AxisRules(DEFAULT_RULES, FakeMesh((16, 16), ("data", "model")))
    spec = rules.resolve(["d_ff", "vocab"], shape=[1024, 512])
    # 'model' can only be used once per spec.
    assert spec == P("model", None)


def test_logical_spec_and_shard_without_rules_are_noops():
    x = torch.ones(4, 2)
    assert logical_spec("batch", None) == P(None, None)
    assert shard(x, "batch", None) is x
    with axis_rules_context(AxisRules(DEFAULT_RULES, make_local_mesh("cpu"))):
        assert logical_spec("batch", "heads") == P("data", "model")  # no 'pod' axis
        assert shard(x, "batch", None) is x  # a plain tensor: no mesh distributes it


def _paths_and_entries(tree, is_jax):
    if is_jax:
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        return [tuple(spec) for _, spec in flat]
    return [tuple(layout.spec) for layout in tree_leaves(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_cover_all_leaves_and_match_reference(arch):
    """Every leaf gets a spec, and each equals the reference's for the
    same leaf on the same mesh shapes."""
    for shape, names in (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))):
        model = Model(reduced_config(arch))
        shapes = abstract_params(model)
        specs = param_specs(shapes, AxisRules(DEFAULT_RULES, FakeMesh(shape, names)))
        assert len(tree_leaves(shapes)) == len(tree_leaves(specs))
        assert all(isinstance(s, Layout) for s in tree_leaves(specs))
        jshapes = jax.eval_shape(JaxModel(jax_reduced_config(arch)).init_params,
                                 jax.random.PRNGKey(0))

        class JMesh:
            axis_names = names
            devices = np.zeros(shape)

        jspecs = jax_param_specs(jshapes, JaxAxisRules(JAX_RULES, JMesh()))
        assert _paths_and_entries(specs, False) == _paths_and_entries(jspecs, True)


@pytest.mark.parametrize("arch", ["qwen3-14b", "musicgen-large", "rwkv6-7b"])
def test_cache_specs_match_reference(arch):
    cfg = get_config(arch)
    window = decode_window_for(cfg, INPUT_SHAPES["decode_32k"])
    mesh = FakeMesh((16, 16), ("data", "model"))
    got = cache_specs(abstract_cache(Model(cfg), 128, window), AxisRules(DEFAULT_RULES, mesh))

    class JMesh:
        axis_names = ("data", "model")
        devices = np.zeros((16, 16))

    jcache = jax.eval_shape(lambda: JaxModel(jax_get_config(arch)).init_cache(128, window))
    want = jax_cache_specs(jcache, JaxAxisRules(JAX_RULES, JMesh()))
    assert _paths_and_entries(got, False) == _paths_and_entries(want, True)


def test_opt_state_specs_mirror_params():
    from repro_torch.launch.input_specs import eval_shape
    from repro_torch.optim import adamw

    cfg = reduced_config("qwen3-14b")
    rules = AxisRules(DEFAULT_RULES, FakeMesh((16, 16), ("data", "model")))
    pshape = abstract_params(Model(cfg))
    pspecs = param_specs(pshape, rules)
    ospecs = opt_state_specs(eval_shape(adamw(1e-3).init, pshape), pspecs, rules)
    assert ospecs.mu is pspecs and ospecs.nu is pspecs
    assert ospecs.step.spec == P()


def test_input_specs_shapes():
    cfg = get_config("llava-next-34b")
    spec = input_specs(cfg, INPUT_SHAPES["train_4k"])
    assert spec["tokens"].shape == (256, 4096 - cfg.num_media_tokens)
    assert spec["media_emb"].shape == (256, cfg.num_media_tokens, cfg.d_model)
    aud = input_specs(get_config("musicgen-large"), INPUT_SHAPES["decode_32k"])
    assert aud["tokens"].shape == (128, 1, 4)
    assert aud["tokens"].dtype == torch.int32


def test_decode_window_policy():
    assert decode_window_for(get_config("qwen3-14b"), INPUT_SHAPES["decode_32k"]) == 32768
    assert decode_window_for(get_config("qwen3-14b"), INPUT_SHAPES["long_500k"]) == 8192
    assert decode_window_for(get_config("rwkv6-7b"), INPUT_SHAPES["long_500k"]) == 1


def test_abstract_trees_allocate_nothing():
    """Published widths described as fake tensors: qwen3-14b's 14.8 B
    parameters cost no memory."""
    params = abstract_params(Model(get_config("qwen3-14b")))
    n = sum(p.numel() for p in tree_leaves(params))
    assert n > 14e9
    assert all(type(p).__name__ == "FakeTensor" for p in tree_leaves(params))


def test_hlo_cost_walker_loop_flops():
    """The reference's scan-trip-count test: a loop of 7 [64, 64] matmuls
    costs 7 of them (the port's loops run, so every trip is counted)."""

    def f(x, w):
        for _ in range(7):
            x = x @ w
        return x

    s = torch.empty(64, 64)
    cost, _ = analyze_step(f, s, s)
    assert cost.flops == pytest.approx(2 * 64**3 * 7, rel=0.01)


def test_local_mesh_train_step_runs():
    """End-to-end: reduced model under a (1, 1) mesh with the rules bound."""
    from repro_torch.optim import adam

    cfg = reduced_config("qwen3-14b")
    model = Model(cfg)
    mesh = make_local_mesh("cpu")
    assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    rules = AxisRules(DEFAULT_RULES, mesh)
    with axis_rules_context(rules):
        params = model.init_params(torch.Generator().manual_seed(0))
        for p in tree_leaves(params):
            p.requires_grad_(True)
        opt = adam(1e-4)
        step = make_train_step(model, opt)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
        _, _, m = step(params, opt.init(params), {"tokens": tokens, "labels": tokens})
        assert np.isfinite(float(m["loss"]))


def test_spmd_train_context_shardings_replicate_on_one_device():
    from torch.distributed.tensor import Replicate

    from repro_torch.core.spmd import SPMDTrainContext
    from repro_torch.optim import adamw

    ctx = SPMDTrainContext(reduced_config("qwen3-14b"), adamw(1e-3), device="cpu")
    p_shard, o_shard = ctx.shardings()
    params = abstract_params(ctx.model)
    assert len(tree_leaves(p_shard)) == len(tree_leaves(params))
    for s in tree_leaves(p_shard) + tree_leaves(o_shard):
        assert s.mesh is ctx.mesh and s.placements == (Replicate(), Replicate())
    assert len(tree_leaves(o_shard.mu)) == len(tree_leaves(params))


def test_spmd_learner_worker_trains():
    from repro_torch.configs.base import InputShape
    from repro_torch.core.spmd import SPMDLearnerWorker, SPMDTrainContext
    from repro_torch.data import make_batch
    from repro_torch.optim import adamw

    cfg = reduced_config("qwen3-14b")
    ctx = SPMDTrainContext(cfg, adamw(1e-3), device="cpu", mesh=make_local_mesh("cpu"))
    lw = SPMDLearnerWorker(ctx)
    shape = InputShape("t", 32, 2, "train")
    losses = [lw.learn_on_batch(make_batch(cfg, shape, 0, s))["loss"] for s in range(3)]
    assert all(np.isfinite(l) for l in losses)


def test_make_data_mesh_refuses_more_than_visible():
    assert tuple(make_data_mesh(1, "cpu").shape) == (1,)
    with pytest.raises(ValueError):
        make_data_mesh(4, "cpu")  # no process group: one CPU device visible
    with pytest.raises(ValueError):
        make_data_mesh(torch.cuda.device_count() + 1, "cuda")


_PRODUCTION_CHILD = r"""
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import DEFAULT_RULES, AxisRules, shard, axis_rules_context
from repro_torch.distributed.specs import param_specs, tree_shardings
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.launch.input_specs import abstract_params, fake_mode
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.tree import tree_leaves

init_fake_group(512)
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    rules = AxisRules(DEFAULT_RULES, mesh)
    params = abstract_params(Model(get_config("qwen3-14b")))
    shardings = tree_shardings(mesh, param_specs(params, rules))
    with fake_mode(), axis_rules_context(rules):
        wq = shardings["blocks"]["0"]["attn"]["wq"].distribute(params["blocks"]["0"]["attn"]["wq"])
        x = shardings["embed"].distribute(params["embed"])
        y = shard(x, None, None)
    out["multi" if multi else "single"] = {
        "size": mesh.size(), "names": list(mesh.mesh_dim_names),
        "wq_global": list(wq.shape), "wq_local": list(wq.to_local().shape),
        "embed_placements": [str(p) for p in x.placements],
        "resharded": [str(p) for p in y.placements],
    }
print(json.dumps(out))
"""


@pytest.mark.timeout(300)
def test_production_meshes_place_dtensors_under_the_fake_group():
    """16 x 16 and 2 x 16 x 16 meshes over a ``"fake"`` group of 512 ranks
    (in a process of its own): params land as DTensors sharded fsdp x
    tensor, and ``shard`` redistributes a DTensor to its logical spec."""
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", _PRODUCTION_CHILD], env=env,
                          capture_output=True, text=True, timeout=280)
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    single, multi = rows["single"], rows["multi"]
    assert single["size"] == 256 and single["names"] == ["data", "model"]
    assert multi["size"] == 512 and multi["names"] == ["pod", "data", "model"]
    # qwen3-14b wq [blocks, 5120, 40 * 128]: fsdp 16-way on data, heads 16-way on model.
    blocks, d, hq = single["wq_global"]
    assert single["wq_local"] == [blocks, d // 16, hq // 16]
    # embed [vocab, d]: vocab on model, fsdp (d) on data.
    assert single["embed_placements"] == ["S(1)", "S(0)"]
    assert single["resharded"] == ["R", "R"]
