from .ops import wkv6
from .ref import wkv_chunked_ref, wkv_recurrent_ref

__all__ = ["wkv6", "wkv_chunked_ref", "wkv_recurrent_ref"]
