"""The port's warn-once fallback latches are per-compile, not per-process
(``tests/test_warn_once.py``).

``TrainOneStep._warned_fallback`` must not suppress its sharded-fallback
warning forever once set: a deepcopy at compile time would copy the latched
flag along, and operators that can't be deep-copied (a live WorkerSet) are
*shared* across every compile of the spec.  ``CompiledFlow._instantiate``
re-arms the latch through the ``reset_warnings()`` protocol."""

import logging
import threading

from repro_torch.core.operators import TrainOneStep
from repro_torch.flow.compile import CompiledFlow
from repro_torch.flow.spec import StageSpec


class _SharedWorkers:
    """Stub WorkerSet whose lock makes deepcopy fail -> shared instance."""

    def __init__(self):
        self._lock = threading.Lock()

    def local_worker(self):
        return object()

    def sync_weights(self):
        pass


class _CopyableWorkers:
    def local_worker(self):
        return object()

    def sync_weights(self):
        pass


def _warn_count(caplog):
    return sum(
        "falling back" in r.getMessage() for r in caplog.records
    )


def test_warn_fallback_is_once_per_instance(caplog):
    op = TrainOneStep(_SharedWorkers(), num_learners=2)
    lw = object()  # no _loss_for -> sharded path warns
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.operators"):
        op._warn_fallback(lw, "no pure loss")
        op._warn_fallback(lw, "no pure loss")
    assert _warn_count(caplog) == 1


def test_warn_fallback_reemits_after_recompile_shared_instance(caplog):
    """The deepcopy-failed path: _instantiate falls back to the SAME
    instance, so without reset_warnings() a second compile would inherit
    the latched flag and never warn again."""
    op = TrainOneStep(_SharedWorkers(), num_learners=2)
    lw = object()
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.operators"):
        op._warn_fallback(lw, "first compile")
    assert _warn_count(caplog) == 1

    fn = CompiledFlow._instantiate(None, StageSpec(fn=op, label="train"))
    assert fn is op  # lock killed the deepcopy -> shared instance

    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.operators"):
        fn._warn_fallback(lw, "second compile")
        fn._warn_fallback(lw, "second compile")
    assert _warn_count(caplog) == 1  # re-armed: warns once again


def test_warn_fallback_fresh_in_deepcopied_instance(caplog):
    """The deepcopy-survived path: the copy must start with the latch
    re-armed even when the original already warned."""
    op = TrainOneStep(_CopyableWorkers(), num_learners=2)
    op._warned_fallback = True  # original already latched
    fn = CompiledFlow._instantiate(None, StageSpec(fn=op, label="train"))
    assert fn is not op
    assert fn._warned_fallback is False
    with caplog.at_level(logging.WARNING, logger="repro_torch.core.operators"):
        fn._warn_fallback(object(), "fresh compile")
    assert _warn_count(caplog) == 1
    # ... and the original's latch is untouched by the copy's reset.
    assert op._warned_fallback is True


def test_reset_warnings_protocol():
    op = TrainOneStep(_SharedWorkers(), num_learners=2)
    op._warned_fallback = True
    op.reset_warnings()
    assert op._warned_fallback is False
