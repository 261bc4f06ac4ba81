from .ops import (
    pack_bpl_np,
    pack_ppoly_grid,
    pack_ppolys_np,
    ppoly_eval,
    ppoly_first_crossing,
    ppoly_min_eval,
)
from .ref import (
    PAD_START,
    ppoly_eval_ref,
    ppoly_first_crossing_ref,
    ppoly_min_eval_ref,
)

__all__ = [
    "ppoly_eval", "ppoly_eval_ref",
    "ppoly_min_eval", "ppoly_min_eval_ref",
    "ppoly_first_crossing", "ppoly_first_crossing_ref",
    "pack_bpl_np", "pack_ppolys_np", "pack_ppoly_grid",
    "PAD_START",
]
