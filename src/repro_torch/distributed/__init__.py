"""Logical-axis sharding rules over ``torch.distributed`` device meshes."""

from .sharding import (DEFAULT_RULES, AxisRules, axis_index, axis_rules, constrain,
                       current_rules, is_sharded, local_apply, placements_for, tree_shardings)

__all__ = ["DEFAULT_RULES", "AxisRules", "axis_index", "axis_rules", "constrain",
           "current_rules", "is_sharded", "local_apply", "placements_for", "tree_shardings"]
