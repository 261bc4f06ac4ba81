"""Model weights drawn from the seed on the device, in the port's parameter
layout: a nested dict whose ``blocks.pos{i}`` leaves (``i`` a layer's place
in the family's period of layers) carry a leading axis over the periods.

The leaves are the embedding, the output head and the final norm, which
every family has, and the blocks' leaves that the family's module lists
(``bench/reference/<family>.py`` ``layout``). Every bf16 leaf is a view of
one flat buffer filled by a few large ``randn`` calls and then scaled leaf
by leaf (std ``1/sqrt(fan_in)`` for matrices); the float32 leaves are views
of a second buffer, ones (norms), seeded normals, or values the family's
module writes (a published initialisation).
"""

from __future__ import annotations

import math
from types import ModuleType

import torch

from .seeds import derive

_DRAW = 1 << 30          # elements per randn call


def layout(family: ModuleType, m: dict) -> list[tuple]:
    """(path, shape, kind, init) of every leaf: ``kind`` is "bf16" (the
    served type) or "f32"; ``init`` a std (0: ones) or a function that
    fills the leaf in place."""
    D, V = m["d_model"], m["vocab_size"]
    return [("embed", (V, D), "bf16", 1 / math.sqrt(V)),
            ("lm_head", (D, V), "bf16", 1 / math.sqrt(D)),
            ("final_norm", (D,), "f32", 0.0),
            *family.layout(m)]


def make_weights(family: ModuleType, m: dict, seed: int, device: torch.device,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """The parameter tree for ``--seed``; the same seed and device give the
    same numbers. ``dtype`` is the matrices' type (bf16 as served; float32
    only for small CPU tests)."""
    leaves = layout(family, m)
    sizes = {"bf16": 0, "f32": 0}
    for _, shape, kind, _ in leaves:
        sizes[kind] += math.prod(shape)
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights"))
    flat = {"bf16": torch.empty(sizes["bf16"], dtype=dtype, device=device),
            "f32": torch.ones(sizes["f32"], dtype=torch.float32, device=device)}
    for start in range(0, sizes["bf16"], _DRAW):
        flat["bf16"][start:start + _DRAW].normal_(generator=gen)
    tree: dict = {}
    offset = {"bf16": 0, "f32": 0}
    for path, shape, kind, init in leaves:
        n = math.prod(shape)
        leaf = flat[kind][offset[kind]:offset[kind] + n].view(shape)
        offset[kind] += n
        if callable(init):
            init(leaf)
        elif kind == "bf16":
            leaf.mul_(init)
        elif init:
            leaf.normal_(0.0, init, generator=gen)
        node = tree
        *parents, name = path.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree
