"""repro_torch.distributed: logical-axis sharding rules, DTensor placement
trees for params / optimizer state / caches / batches, and the cost model
(``hlo_cost``: FLOPs and bytes of the aten ops a step dispatches;
``hlo_analysis``: roofline terms at H100 rates)."""

from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    AxisRules,
    axis_rules_context,
    get_axis_rules,
    logical_spec,
    shard,
)

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "axis_rules_context",
    "get_axis_rules",
    "logical_spec",
    "shard",
]
