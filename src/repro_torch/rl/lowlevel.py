"""Low-level actor/RPC-style algorithm implementations (the paper's baseline;
PyTorch port of ``repro/rl/lowlevel.py``, the same code on the port's
actors, metrics and workers).

These mirror RLlib's pre-Flow implementations (paper Listings A2 / A4):
dataflow and control flow intermixed, manual future bookkeeping, manual
timers and weight-sync tracking.  They exist to reproduce the paper's two
comparisons:

  * Table 2 — lines of code vs. the plans in ``repro_torch/flow/plans.py``
  * Fig 13 — throughput parity of the dataflow executor vs. hand-written
    loops (``chip_smoke.py`` sets ``a3c_lowlevel`` beside ``build_a3c`` on
    the same workers on the card)

The numerical code (policies, workers) is IDENTICAL to what the plans use —
only the distributed execution layer differs, matching the paper's setup.
"""

from __future__ import annotations

import random
import time
from typing import Any, Dict, Iterator

from repro_torch.core.actor import ActorPool, wait
from repro_torch.core.metrics import TimerStat
from repro_torch.core.workers import WorkerSet
from repro_torch.rl.sample_batch import SampleBatch

__all__ = ["a3c_lowlevel", "apex_lowlevel", "sync_sample_lowlevel"]


def a3c_lowlevel(workers: WorkerSet) -> Iterator[Dict[str, Any]]:
    """Paper Listing A2: manual async gradient loop."""
    # Create timers
    apply_timer = TimerStat()
    wait_timer = TimerStat()
    dispatch_timer = TimerStat()

    # Create training information
    num_steps_sampled = 0
    num_steps_trained = 0

    # Get weights from the local rollout actor
    local_worker = workers.local_worker()
    weights = local_worker.get_weights()

    # type: Dict[future, actor]
    pending_gradients = {}

    # Get the remote rollout actors
    remote_workers = workers.remote_workers()

    # Issue gradient computation tasks
    for worker in remote_workers:
        # Set weight on remote rollout actor
        worker.call("set_weights", weights)
        # Sample then kick off gradient computation on the worker
        future = worker.apply(lambda w: w.compute_gradients(w.sample()))
        # Map the future to the rollout actor
        pending_gradients[future] = worker

    # Training loop
    while pending_gradients:
        # Record the time to wait for a gradient
        with wait_timer:
            futures = list(pending_gradients.keys())
            # Wait for one actor to complete
            ready, _ = wait(futures, num_returns=1)
            future = ready[0]

        # Get the gradient and training info
        gradient, info = future.result()

        # Pop the used gradient from the map
        worker = pending_gradients.pop(future)

        # Check the validity of the gradient
        if gradient is not None:
            # Record the time for the gradient application
            with apply_timer:
                # Apply the gradient on the local worker
                local_worker.apply_gradients(gradient)
            # Record the metrics from the worker
            num_steps_sampled += info.get("batch_count", 0)
            num_steps_trained += info.get("batch_count", 0)

        # Record the time to set new weights and relaunch
        with dispatch_timer:
            # Get the weights from the local rollout actor
            weights = local_worker.get_weights()
            # Set weights on the rollout actor
            worker.call("set_weights", weights)
            # Launch gradient computation task on the worker
            future = worker.apply(lambda w: w.compute_gradients(w.sample()))
            # Map the new future to the corresponding worker
            pending_gradients[future] = worker

        yield {
            "counters": {
                "num_steps_sampled": num_steps_sampled,
                "num_steps_trained": num_steps_trained,
            },
            "timers": {
                "wait": wait_timer.mean,
                "apply": apply_timer.mean,
                "dispatch": dispatch_timer.mean,
            },
        }


def apex_lowlevel(
    workers: WorkerSet,
    replay_actors: ActorPool,
    target_update_freq: int = 2500,
    max_weight_sync_delay: int = 400,
    sample_queue_depth: int = 2,
    replay_queue_depth: int = 4,
) -> Iterator[Dict[str, Any]]:
    """Paper Listing A4: manual Ape-X with task pools and a learner thread."""
    from repro_torch.core.learner_thread import LearnerThread

    local_worker = workers.local_worker()
    learner = LearnerThread(local_worker)
    learner.start()

    timers = {
        k: TimerStat()
        for k in [
            "put_weights", "get_samples", "sample_processing",
            "replay_processing", "update_priorities", "train", "sample",
        ]
    }
    num_weight_syncs = 0
    num_samples_dropped = 0
    num_steps_sampled = 0
    num_steps_trained = 0
    steps_since_update: Dict[int, int] = {}
    last_target_update = 0

    # Kick off replay tasks on the replay actors
    replay_tasks = {}
    for actor in replay_actors:
        for _ in range(replay_queue_depth):
            replay_tasks[actor.call("replay")] = actor

    # Kick off async background sampling on the rollout actors
    weights = local_worker.get_weights()
    sample_tasks = {}
    for worker in workers.remote_workers():
        worker.call("set_weights", weights)
        steps_since_update[worker.actor_id] = 0
        for _ in range(sample_queue_depth):
            sample_tasks[worker.apply(lambda w: w.sample_with_count())] = worker

    while True:
        start = time.time()
        sample_timesteps, train_timesteps = 0, 0

        # --- sampling / replay-store path
        with timers["sample_processing"]:
            completed = [f for f in list(sample_tasks) if f.done()]
            for future in completed:
                worker = sample_tasks.pop(future)
                sample_batch, count = future.result()
                sample_timesteps += count
                # Send the batch to a random replay actor
                random.choice(list(replay_actors)).call("add_batch", sample_batch)
                steps_since_update[worker.actor_id] += count
                # Update weights on the rollout worker if stale
                if steps_since_update[worker.actor_id] >= max_weight_sync_delay:
                    if learner.weights_updated:
                        learner.weights_updated = False
                        with timers["put_weights"]:
                            weights = local_worker.get_weights()
                        worker.call("set_weights", weights)
                        num_weight_syncs += 1
                    steps_since_update[worker.actor_id] = 0
                # Kick off another sample request
                sample_tasks[worker.apply(lambda w: w.sample_with_count())] = worker

        # --- replay -> learner path
        with timers["replay_processing"]:
            for future in [f for f in list(replay_tasks) if f.done()]:
                actor = replay_tasks.pop(future)
                replay_tasks[actor.call("replay")] = actor
                if learner.inqueue.full():
                    num_samples_dropped += 1
                else:
                    with timers["get_samples"]:
                        samples = future.result()
                    if samples is not None:
                        learner.inqueue.put((samples, actor))

        # --- priority updates from the learner out-queue
        with timers["update_priorities"]:
            while not learner.outqueue.empty():
                actor, batch, info = learner.outqueue.get()
                if actor is not None and "batch_indices" in batch:
                    import numpy as np

                    actor.call(
                        "update_priorities",
                        batch["batch_indices"],
                        np.abs(info.get("td_error", np.ones(batch.count))),
                    )
                train_timesteps += batch.count
                if num_steps_trained - last_target_update >= target_update_freq:
                    local_worker.update_target()
                    last_target_update = num_steps_trained

        num_steps_sampled += sample_timesteps
        num_steps_trained += train_timesteps
        time_delta = time.time() - start
        timers["sample"].push(time_delta)
        timers["sample"].push_units_processed(sample_timesteps)

        yield {
            "counters": {
                "num_steps_sampled": num_steps_sampled,
                "num_steps_trained": num_steps_trained,
                "num_weight_syncs": num_weight_syncs,
                "num_samples_dropped": num_samples_dropped,
            },
            "learner": learner,
        }


def sync_sample_lowlevel(workers: WorkerSet) -> Iterator[SampleBatch]:
    """Hand-written bulk-synchronous sampling loop (Fig 13a baseline)."""
    while True:
        futures = [w.apply(lambda t: t.sample()) for w in workers.remote_workers()]
        batches = [f.result() for f in futures]
        yield SampleBatch.concat_samples(batches)
