"""AdamW of the training path, with the reference's arithmetic."""

from .adamw import OptConfig, adamw_init, adamw_update, opt_state_axes

__all__ = ["OptConfig", "adamw_init", "adamw_update", "opt_state_axes"]
