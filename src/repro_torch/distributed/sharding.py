"""Logical-axis sharding rules (MaxText-style) over a ``DeviceMesh``.

The reference's ``distributed/sharding.py`` with DTensor placements in place
of GSPMD's ``PartitionSpec``: model code names the axes of parameters and
activations logically ("embed", "ffn", "heads", "experts", "batch", ...), a
rule table maps each logical name to zero or more *mesh* axes, and the
active :class:`AxisRules` resolves names to a spec, silently dropping
mappings that do not divide the dimension (so one rule table serves all ten
architectures) or that name axes absent from the current mesh (so the same
model code runs on one card, a pod or two pods).

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per tensor
dimension, ``None`` (replicated), one mesh-axis name, or a tuple of them;
trailing ``None`` dropped.  :meth:`AxisRules.placements_for` turns it into
one ``Shard``/``Replicate`` placement per mesh dimension, which is what a
``DTensor`` takes.

Parallelism coverage, as in the reference:
  * DP   — "batch" -> ("pod", "data")
  * FSDP — "embed" -> "data"  (ZeRO-3: parameters + optimizer state sharded
            over the data axis; DTensor inserts the all-gathers)
  * TP   — "ffn"/"heads"/"vocab" -> "model" (Megatron-style)
  * EP   — "experts" -> "model"
  * SP   — "seq" -> "model" for long-context activations (optional rule)
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Any

import torch

__all__ = ["DEFAULT_RULES", "AxisRules", "axis_rules", "constrain",
           "current_rules", "local_apply", "placements_for", "tree_shardings"]

# default rule table: logical name -> tuple of candidate mesh axes
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "embed": ("data",),          # FSDP / ZeRO-3
    "ffn": ("model",),           # Megatron TP
    "heads": ("model",),
    "kv": (),                    # small GQA kv projections: replicate
    "experts": ("model",),       # expert parallelism
    "layers": (),                # stacked groups: never sharded
    "seq": (),                   # flip to ("model",) for sequence parallelism
    "act_embed": (),
    "kv_seq": (),                # decode kv caches: shard over data when B>1
    "cache_heads": ("model",),
    "cache_batch": ("pod", "data"),
}

_tls = threading.local()


def _mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or ``mesh.shape`` itself where
    that is already such a dict (a stand-in that carries no devices)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


@dataclass
class AxisRules:
    mesh: Any
    rules: dict[str, tuple[str, ...]] = field(default_factory=lambda: dict(DEFAULT_RULES))

    def spec_for(self, axes: tuple[str | None, ...],
                 shape: tuple[int, ...] | None = None) -> tuple:
        """Resolve logical axes to a spec, checking divisibility."""
        mshape = _mesh_shape(self.mesh)
        out: list = []
        used: set[str] = set()
        for i, name in enumerate(axes):
            if name is None:
                out.append(None)
                continue
            picked: list[str] = []
            for ax in self.rules.get(name, ()):
                if ax not in mshape or ax in used:
                    continue
                dim = shape[i] if shape is not None else None
                cur = math.prod(mshape[a] for a in picked)
                if dim is not None and dim % (cur * mshape[ax]) != 0:
                    continue
                picked.append(ax)
            used.update(picked)
            if not picked:
                out.append(None)
            elif len(picked) == 1:
                out.append(picked[0])
            else:
                out.append(tuple(picked))
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements_for(self, axes: tuple[str | None, ...],
                       shape: tuple[int, ...] | None = None) -> tuple:
        """The spec of ``axes`` as DTensor placements, one per mesh
        dimension: ``Shard(d)`` where tensor dimension d names that mesh
        axis, ``Replicate()`` elsewhere.  A dimension split over several
        mesh axes is split in mesh order, the reference's major-to-minor."""
        from torch.distributed.tensor import Replicate, Shard

        spec = self.spec_for(tuple(axes), shape)
        owner: dict[str, int] = {}
        for d, entry in enumerate(spec):
            for ax in (entry,) if isinstance(entry, str) else entry or ():
                owner[ax] = d
        return tuple(Shard(owner[ax]) if ax in owner else Replicate()
                     for ax in self.mesh.mesh_dim_names)


@contextlib.contextmanager
def axis_rules(mesh, overrides: dict[str, tuple[str, ...]] | None = None):
    prev = getattr(_tls, "rules", None)
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    _tls.rules = AxisRules(mesh=mesh, rules=rules)
    try:
        yield _tls.rules
    finally:
        _tls.rules = prev


def current_rules() -> AxisRules | None:
    return getattr(_tls, "rules", None)


def placements_for(axes: tuple[str | None, ...], shape: tuple[int, ...]) -> tuple:
    """:meth:`AxisRules.placements_for` under the active rules."""
    r = current_rules()
    if r is None:
        raise RuntimeError("placements_for needs an active axis_rules context")
    return r.placements_for(axes, shape)


def constrain(x: torch.Tensor, axes: tuple[str | None, ...],
              shape: tuple[int, ...] | None = None) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` against the active
    rules: a ``DTensor`` is redistributed to the placements of ``axes``;
    outside a rules context, or on a plain tensor, ``x`` comes back as it
    is.  ``shape`` is what the rules test divisibility against where it is
    not ``x.shape``: a dimension of heads x head_dim that is about to be
    split into its heads divides as its head count does (GSPMD splits
    unevenly where it must; DTensor refuses)."""
    r = current_rules()
    if r is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    placements = r.placements_for(tuple(axes), tuple(shape or x.shape))
    y = x.redistribute(r.mesh, placements)
    return _PinGrad.apply(y, placements) if y.requires_grad else y


class _PinGrad(torch.autograd.Function):
    """Identity forward; the backward redistributes the incoming gradient
    to the forward's placements, as GSPMD constrains a cotangent to its
    primal's sharding.  DTensor's eager backward would carry a partial sum
    (the residual stream's gradient, summed from the next layer's
    model-parallel products) on into the products before it, which then
    run replicated over the model axis."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = tuple(placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def local_apply(fn, args: tuple, axes: tuple, out_like: tuple):
    """``fn(*args)`` computed shard by shard, for a function that is local
    to the sharded dimensions (attention and the wkv recurrence are local to
    each batch row and head).  Under active rules, with a ``DTensor`` among
    ``args``, each argument is redistributed to the placements of its
    logical ``axes``, ``fn`` runs on the local shards, and output i takes
    the placements of argument ``out_like[i]``: no communication inside
    ``fn``, as GSPMD partitions the reference's einsums.  DTensor's own
    propagation would reshape across sharded dimensions and gather or
    reduce whole score and decay tensors instead.  Otherwise ``fn(*args)``.
    """
    r = current_rules()
    if r is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    placed = []
    for a, ax in zip(args, axes, strict=True):
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, r.mesh, [Replicate()] * len(r.mesh.shape),
                                   run_check=False)
        placed.append(a.redistribute(r.mesh, r.placements_for(ax, tuple(a.shape))))
    outs = fn(*(a.to_local() for a in placed))
    single = isinstance(outs, torch.Tensor)
    wrapped = tuple(DTensor.from_local(o, r.mesh, placed[i].placements, run_check=False)
                    for o, i in zip((outs,) if single else outs, out_like, strict=True))
    return wrapped[0] if single else wrapped


def _is_axes(a) -> bool:
    return isinstance(a, tuple) and all(isinstance(e, (str, type(None))) for e in a)


def tree_shardings(axes_tree, shapes_tree):
    """Map parallel (axes, shapes) trees (dicts and lists) to placements."""
    r = current_rules()
    if r is None:
        raise RuntimeError("tree_shardings requires an active axis_rules context")

    def rec(a, s):
        if _is_axes(a):
            return r.placements_for(a, tuple(s.shape))
        if isinstance(a, dict):
            return {k: rec(a[k], s[k]) for k in a}
        return [rec(x, y) for x, y in zip(a, s)]

    return rec(axes_tree, shapes_tree)
