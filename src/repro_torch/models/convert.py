"""Carrying model parameters between the port and the reference's layout.

The reference keeps parameters as a nested dict of arrays, the leaves of a
scanned block stacked on a leading group axis of length ``n_groups``;
``np.asarray`` of each leaf gives numpy arrays, with bf16 leaves as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: those cross as
their 16-bit patterns.  :func:`params_from_arrays` builds a
:class:`DecoderLM` from such a tree; :func:`params_to_arrays` is its
inverse.  :func:`to_reference_tree` and :func:`load_reference_tree` do the
same for anything aligned with ``model.parameters()`` (gradients, an
optimizer's moments), for the checkpoints.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from .common import ModelConfig
from .transformer import DecoderLM

__all__ = ["array_from_tensor", "load_reference_tree", "params_from_arrays",
           "params_to_arrays", "reference_layout", "tensor_from_array",
           "to_reference_tree"]


def tensor_from_array(a: Any, device: torch.device) -> torch.Tensor:
    """A numpy-convertible array as a tensor of the same dtype and bits."""
    a = np.array(a)                   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def array_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy, a bf16 tensor as its 16-bit pattern
    (``uint16``): the form the reference's checkpoints store bf16 in."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_arrays(tree: dict, cfg: ModelConfig,
                       device: "str | torch.device | None" = None) -> DecoderLM:
    """The reference's parameter tree (stacked scan groups) as a :class:`DecoderLM`."""
    dev = resolve_device(device)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return tensor_from_array(node, dev)

    return DecoderLM(cfg, rec(tree))


def reference_layout(model: DecoderLM) -> dict[str, list[int]]:
    """The ``"/"``-joined path of each leaf of the reference's parameter tree
    -> the positions in ``list(model.parameters())`` of the tensors that make
    it: a block leaf's ``n_groups`` layer slices, group 0 first (layer
    ``g * period + i`` is slice ``g`` of ``blocks/pos{i}/...``), or the one
    tensor of a leaf outside the blocks."""
    period = model.cfg.period
    out: dict[str, list[int]] = {}
    for j, (name, _p) in enumerate(model.named_parameters()):
        parts = name.split(".")
        if parts[0] == "blocks":
            parts = ["blocks", f"pos{int(parts[1]) % period}", *parts[2:]]
        out.setdefault("/".join(parts), []).append(j)
    return out


def to_reference_tree(model: DecoderLM, tensors: list,
                      leaf: Callable = array_from_tensor) -> dict:
    """``tensors`` aligned with ``model.parameters()`` as the reference's
    nested tree: ``leaf`` of each tensor (by default a host numpy copy), the
    layer slices of a block leaf restacked on a leading group axis.  The
    parameters need not be views of one stacked tensor any more."""
    tree: dict = {}
    for path, idx in reference_layout(model).items():
        vals = [leaf(tensors[j]) for j in idx]
        stack = np.stack if isinstance(vals[0], np.ndarray) else torch.stack
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = stack(vals) if parents and parents[0] == "blocks" else vals[0]
    return tree


def params_to_arrays(model: DecoderLM) -> dict:
    """The inverse of :func:`params_from_arrays`: the model's parameters as
    the reference's tree of numpy arrays in its stacked ``(G, ...)``
    layout, bf16 as its 16-bit pattern (``uint16``)."""
    return to_reference_tree(model, list(model.parameters()))


@torch.no_grad()
def load_reference_tree(model: DecoderLM, tree: dict, tensors: list) -> None:
    """Copy a reference-layout tree of tensors (what
    :func:`to_reference_tree` makes, e.g. restored from a checkpoint) into
    ``tensors``, aligned with ``model.parameters()``, in place."""
    for path, idx in reference_layout(model).items():
        node = tree
        for p in path.split("/"):
            node = node[p]
        if path.startswith("blocks/"):
            for g, j in enumerate(idx):
                tensors[j].copy_(node[g])
        else:
            tensors[idx[0]].copy_(node)
