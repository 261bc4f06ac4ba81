"""Logical-axis sharding rules over ``torch.distributed`` device meshes."""

from .sharding import (DEFAULT_RULES, AxisRules, axis_index, axis_rules, block_index,
                       constrain, current_rules, exchange, gather_blocks, gather_columns,
                       is_sharded, local_apply, mesh_axes, placements_for, tree_shardings)

__all__ = ["DEFAULT_RULES", "AxisRules", "axis_index", "axis_rules", "block_index",
           "constrain", "current_rules", "exchange", "gather_blocks", "gather_columns",
           "is_sharded", "local_apply", "mesh_axes", "placements_for", "tree_shardings"]
