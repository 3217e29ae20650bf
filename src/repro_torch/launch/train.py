"""LM pretraining driver: the paper's dataflow model driving the learner's
step (PyTorch port of ``repro/launch/train.py``).

The training loop IS a dataflow graph (ppo-shaped, minus the RL loss),
declared as a ``FlowSpec`` and run through the ``Algorithm`` facade on the
thread backend:

    data actors -> par_source -> batch_across_shards -> merge
                -> learner step (one synchronous fragment, core/spmd.py)
                -> report

Data pipeline shards are actors; the learner's ``learn_on_batch`` is the
step.  Kernels on the path: RWKV-6 layers run ``ops.rwkv6`` (forward and
backward kernels), MoE layers ``ops.moe_gmm`` and GQA attention layers
``ops.flash_attention``; MLA attention and Mamba layers are plain torch, as
in the reference.  The driver trains at the configuration's own dtype, as
the reference's does: bfloat16 for every architecture (weights drawn in
float32 and cast, the loss in float32, bf16 gradients, AdamW's moments in
float32), and prints it.  On the card the bf16 kernels run (flash forward
and backward, RWKV-6 forward and backward, the grouped matmul's forward;
its dX and dW are the reference's two bf16 einsums), and cuBLAS's bf16
products sum in fp32 as the reference's do (``make_pretrain``).

Runs on the GPU unless ``--device cpu`` is given; ``--layers`` cuts the
configuration's depth and keeps its widths (``cut_layers``: a prologue
stays, and a pattern longer than the cut becomes its first window with every
layer kind, e.g. Jamba's entries 2-3, Mamba + dense and attention + MoE); ``--checkpoint PATH`` saves the
learner's parameters there after the run (``repro_torch.checkpoint``, .npz
keyed by tree path, which the JAX package's ``restore_pytree`` reads too):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b --layers 2 \\
      --seq 4096 --batch 2 --data-shards 2 --steps 4 --checkpoint ckpt/qwen3.npz
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3.5-moe-42b-a6.6b \\
      --device cpu --smoke --steps 2 --batch 2 --seq 32
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Tuple

import numpy as np


def build_lm_flow(workers, pipes):
    """The LM pretrain dataflow as a declarative graph."""
    from repro_torch.core.metrics import get_metrics
    from repro_torch.flow import FlowSpec, pure

    spec = FlowSpec("lm_pretrain")

    def _merge(shards):
        return {k: np.concatenate([s[k] for s in shards], axis=0) for k in shards[0]}

    @pure
    def _train(batch):  # dict batches (no .count/.minibatches)
        info = workers.local_worker().learn_on_batch(batch)
        get_metrics().counters["num_steps_trained"] += batch["tokens"].shape[0]
        return batch, info

    data_op = (
        spec.par_source(pipes, lambda p: p.sample(), name="TokenPipeline")
        .batch_across_shards()
        .for_each(pure(_merge), label="MergeShards")
    )
    spec.set_output(data_op.for_each(_train, label="SPMDTrainStep").report())
    return spec


def pattern_window(pattern: tuple, n: int) -> int:
    """Start of the first window of ``n`` consecutive entries of ``pattern``
    that holds every layer kind and every MLP kind the pattern has."""
    kinds = {s.kind for s in pattern}, {s.mlp for s in pattern}
    for start in range(len(pattern) - n + 1):
        window = pattern[start:start + n]
        if ({s.kind for s in window}, {s.mlp for s in window}) == kinds:
            return start
    raise ValueError(f"no {n} consecutive entries of {pattern} hold every layer and MLP kind")


def cut_layers(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers, its widths kept: a prologue stays
    whole and the blocks are cut so that prologue + pattern x blocks ==
    ``layers``; a pattern longer than what is left becomes its first window
    that holds every layer and MLP kind (``pattern_window``), one block.
    Returns (the configuration, a line that says what was taken)."""
    n = layers - len(cfg.prologue)
    if n < 1:
        raise ValueError(f"{cfg.name}: cannot cut to {layers} layers (prologue {len(cfg.prologue)})")
    pattern = cfg.block_pattern
    taken = f"{n // len(pattern)} x its {len(pattern)}-layer block" if len(pattern) <= n else ""
    if len(pattern) > n:
        start = pattern_window(pattern, n)
        pattern = pattern[start:start + n]
        taken = f"entries {start}-{start + n - 1} of its {len(cfg.block_pattern)}-layer block"
    elif n % len(pattern):
        raise ValueError(f"{cfg.name}: cannot cut to {layers} layers "
                         f"(pattern of {len(pattern)} after a prologue of {len(cfg.prologue)})")
    kinds = " ".join(f"{s.kind}/{s.mlp}" for s in cfg.prologue + pattern * (n // len(pattern)))
    note = (f"{cfg.name} cut to {layers} layers: "
            + (f"its prologue of {len(cfg.prologue)} + " if cfg.prologue else "")
            + f"{taken} [{kinds}]")
    return dataclasses.replace(cfg, num_layers=layers, block_pattern=pattern), note


def train_config(arch: str, smoke: bool = False, layers: int = 0, with_note: bool = False):
    """The configuration the driver trains: ``arch`` (reduced with
    ``smoke``), cut to ``layers`` layers when given (``cut_layers``), at its
    own dtype (``get_config``'s, as the reference's driver); with
    ``with_note``, (the configuration, ``cut_layers``' line or "")."""
    from repro_torch.configs import get_config, reduced_config

    cfg = reduced_config(arch) if smoke else get_config(arch)
    note = ""
    if layers:
        cfg, note = cut_layers(cfg, layers)
    return (cfg, note) if with_note else cfg


def pretrain_optimizer(steps: int, lr: float = 3e-4):
    """The reference driver's optimizer: AdamW under a warmup-cosine
    schedule, with global-norm clipping."""
    from repro_torch.optim import adamw, chain_clip_by_global_norm, linear_warmup_cosine

    return chain_clip_by_global_norm(
        adamw(linear_warmup_cosine(lr, 20, max(steps, 100)), weight_decay=0.1), max_norm=1.0
    )


def make_pretrain(
    cfg,
    seq: int,
    batch: int,
    data_shards: int,
    steps: int,
    lr: float = 3e-4,
    device: Any = "cuda",
) -> Tuple[Any, Any, Any, Any]:
    """The learner, the data actors, the worker set and the flow spec of one
    pretraining run, with the reference driver's optimizer
    (``pretrain_optimizer``).  On the card it turns off cuBLAS's
    reduced-precision reductions in bf16 products
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``),
    so that they sum in fp32 as the reference's do; it changes no other
    setting."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.core.actor import ActorPool
    from repro_torch.core.spmd import SPMDLearnerWorker, SPMDTrainContext
    from repro_torch.core.workers import WorkerSet
    from repro_torch.data import TokenPipeline

    shape = InputShape("train", seq, batch, "train")
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    learner = SPMDLearnerWorker(
        SPMDTrainContext(cfg, pretrain_optimizer(steps, lr), device=device), seed=0
    )
    pipes = ActorPool.from_targets(
        [TokenPipeline(cfg, shape, seed=0, host_id=i, num_hosts=data_shards)
         for i in range(data_shards)],
        name="data",
    )
    workers = WorkerSet(learner, pipes)
    return learner, pipes, workers, build_lm_flow(workers, pipes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--layers", type=int, default=0, help="cut the config to this many layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-shards", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--checkpoint", default="", help="save the learner's parameters here (.npz)")
    ap.add_argument("--dot", action="store_true", help="print the flow graph and exit")
    args = ap.parse_args(argv)

    from repro_torch.flow import Algorithm

    cfg, note = train_config(args.arch, args.smoke, args.layers, with_note=True)
    if note:
        print(note, flush=True)
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, dtype {cfg.dtype} "
          f"(the configuration's own), device {args.device}", flush=True)
    learner, pipes, workers, spec = make_pretrain(
        cfg, args.seq, args.batch, args.data_shards, args.steps, lr=args.lr, device=args.device
    )
    if args.dot:
        print(spec.to_dot())
        return

    t0 = time.time()
    with Algorithm.from_plan(spec, workers) as algo:
        for step in range(args.steps):
            res = algo.train()
            loss = res["info"].get("loss", float("nan"))
            if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
                print(
                    f"step {step:4d} loss {loss:.4f} "
                    f"({(time.time() - t0) / (step + 1):.2f}s/step)",
                    flush=True,
                )
        if args.checkpoint:
            from repro_torch.checkpoint import save_pytree

            save_pytree(args.checkpoint, learner.params)
            print(f"saved checkpoint to {args.checkpoint}", flush=True)


if __name__ == "__main__":
    main()
