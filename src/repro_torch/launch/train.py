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
backward kernels), MoE layers ``ops.moe_gmm`` and attention layers
``ops.flash_attention``.  Every kernel of the port is float32, so the driver
trains in float32 whatever the configuration's dtype says (and prints so).

Runs on the GPU unless ``--device cpu`` is given; ``--layers`` cuts the
configuration's depth and keeps its widths:
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b --layers 2 \\
      --seq 4096 --batch 2 --data-shards 2 --steps 4
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


def train_config(arch: str, smoke: bool = False, layers: int = 0):
    """The configuration the driver trains: ``arch`` (reduced with
    ``smoke``), cut to ``layers`` layers when given, in float32."""
    from repro_torch.configs import get_config, reduced_config

    cfg = reduced_config(arch) if smoke else get_config(arch)
    if layers:
        if cfg.prologue or layers % len(cfg.block_pattern):
            raise ValueError(f"{cfg.name}: cannot cut to {layers} layers")
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return dataclasses.replace(cfg, dtype="float32")


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
    pretraining run, with the reference driver's optimizer: AdamW under a
    warmup-cosine schedule, with global-norm clipping."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.actor import ActorPool
    from repro_torch.core.spmd import SPMDLearnerWorker, SPMDTrainContext
    from repro_torch.core.workers import WorkerSet
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import adamw, chain_clip_by_global_norm, linear_warmup_cosine

    optimizer = chain_clip_by_global_norm(
        adamw(linear_warmup_cosine(lr, 20, max(steps, 100)), weight_decay=0.1), max_norm=1.0
    )
    shape = InputShape("train", seq, batch, "train")
    learner = SPMDLearnerWorker(SPMDTrainContext(cfg, optimizer, device=device), seed=0)
    pipes = ActorPool.from_targets(
        [TokenPipeline(cfg, shape, seed=0, host_id=i, num_hosts=data_shards)
         for i in range(data_shards)],
        name="data",
    )
    workers = WorkerSet(learner, pipes)
    return learner, pipes, workers, build_lm_flow(workers, pipes)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--layers", type=int, default=0, help="cut the config to this many layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--data-shards", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--dot", action="store_true", help="print the flow graph and exit")
    args = ap.parse_args(argv)
    if args.checkpoint:
        raise NotImplementedError("checkpointing is not ported to repro_torch yet")

    from repro_torch.flow import Algorithm

    cfg = train_config(args.arch, args.smoke, args.layers)
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, dtype float32 "
          f"(the port's kernels are float32), device {args.device}", flush=True)
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


if __name__ == "__main__":
    main()
