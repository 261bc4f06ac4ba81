from .ops import flash_attention
from .ref import attention_ref, flash_error, flash_failures

__all__ = ["flash_attention", "attention_ref", "flash_error", "flash_failures"]
