"""Carrying the reference package's model parameters across.

The reference keeps parameters as a nested dict of arrays; ``np.asarray``
of each leaf gives numpy arrays, with bf16 leaves as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses: those cross as their 16-bit patterns.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .common import ModelConfig
from .transformer import DecoderLM

__all__ = ["params_from_arrays", "tensor_from_array"]


def tensor_from_array(a: Any, device: torch.device) -> torch.Tensor:
    """A numpy-convertible array as a tensor of the same dtype and bits."""
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_arrays(tree: dict, cfg: ModelConfig,
                       device: "str | torch.device | None" = None) -> DecoderLM:
    """The reference's parameter tree (stacked scan groups) as a :class:`DecoderLM`."""
    dev = resolve_device(device)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return tensor_from_array(node, dev)

    return DecoderLM(cfg, rec(tree))
