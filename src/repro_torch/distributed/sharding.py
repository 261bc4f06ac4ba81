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

__all__ = ["DEFAULT_RULES", "AxisRules", "axis_index", "axis_rules", "block_index",
           "constrain", "current_rules", "exchange", "gather_blocks", "gather_columns",
           "is_sharded", "local_apply", "mesh_axes", "placements_for", "tree_shardings"]

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


def is_sharded(x: torch.Tensor) -> bool:
    """Whether ``x`` is a ``DTensor`` under active rules: the dry-run on a
    mesh, where a step may take the reference's form of a product instead
    of the plain program's (one card, or counting on a 1x1 mesh)."""
    if current_rules() is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def axis_index(name: str) -> int:
    """This rank's coordinate along mesh axis ``name`` of the active rules'
    mesh: the reference's ``jax.lax.axis_index`` in a ``shard_map`` body."""
    return current_rules().mesh.get_local_rank(name)


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


def local_apply(fn, args: tuple, axes: tuple, out_like: tuple,
                reduce_over: str | None = None):
    """``fn(*args)`` computed shard by shard, for a function that is local
    to the sharded dimensions (attention and the wkv recurrence are local to
    each batch row and head).  Under active rules, with a ``DTensor`` among
    ``args``, each argument is redistributed to the placements of its
    logical ``axes``, ``fn`` runs on the local shards, and output i takes
    the placements of argument ``out_like[i]``, or ``out_like[i]`` itself
    where that is a tuple of placements: no communication inside ``fn``
    beyond what it issues itself (:func:`exchange`), as GSPMD partitions the
    reference's einsums.  DTensor's own propagation would reshape across
    sharded dimensions and gather or reduce whole score and decay tensors
    instead.  With ``reduce_over`` (a mesh axis that output i is replicated
    over), each rank's output is its partial sum, all-reduced over that
    axis: the reference's ``psum`` at the end of a ``shard_map`` body.
    Otherwise ``fn(*args)``.

    The gradient of an argument replicated over a mesh axis along which the
    ranks compute different things (some argument or output is split or
    summed over it) is each rank's partial sum, as GSPMD transposes a
    replicated operand of a partitioned product.
    """
    r = current_rules()
    if r is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    placed = []
    for a, ax in zip(args, axes, strict=True):
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, r.mesh, [Replicate()] * len(r.mesh.shape),
                                   run_check=False)
        placed.append(a.redistribute(r.mesh, r.placements_for(ax, tuple(a.shape))))
    wants = [placed[i].placements if isinstance(i, int) else tuple(i) for i in out_like]
    k = None if reduce_over is None else r.mesh.mesh_dim_names.index(reduce_over)
    varied = {d for pl in [a.placements for a in placed] + wants
              for d, p in enumerate(pl) if not p.is_replicate()} | ({k} - {None})
    outs = fn(*(a.to_local(grad_placements=[Partial() if d in varied and p.is_replicate()
                                            else p for d, p in enumerate(a.placements)])
                for a in placed))
    single = isinstance(outs, torch.Tensor)
    wrapped = []
    for o, want in zip((outs,) if single else outs, wants, strict=True):
        if k is None:
            wrapped.append(DTensor.from_local(o, r.mesh, want, run_check=False))
            continue
        partial = (*want[:k], Partial(), *want[k + 1:])
        wrapped.append(DTensor.from_local(o, r.mesh, partial, run_check=False)
                       .redistribute(r.mesh, want))
    return wrapped[0] if single else tuple(wrapped)


def mesh_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (``None``, a name or a tuple of
    names), major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _group(name: str):
    mesh = current_rules().mesh
    return mesh, mesh.mesh_dim_names.index(name)


def exchange(send: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
    """All-to-all over the mesh axes ``axes`` (major to minor), from inside
    a :func:`local_apply` body: ``send``'s leading dimension holds one block
    for each rank of the axes (in mesh order); block i of the result is the
    one rank i sent here.  One all-to-all a mesh axis, each of the whole
    buffer, differentiable (the transpose is the reverse exchange)."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd

    mesh = current_rules().mesh
    sizes = [mesh.size(_group(a)[1]) for a in axes]
    out = send.reshape(*sizes, *send.shape[1:])
    for i, a in enumerate(axes):
        moved = all_to_all_single_autograd(out.movedim(i, 0).contiguous(), None, None,
                                           _group(a))
        out = moved.movedim(0, i)
    return out.reshape(send.shape)


def gather_blocks(t: torch.Tensor, axes: tuple[str, ...]) -> torch.Tensor:
    """``t`` of every rank of the mesh axes ``axes`` concatenated along
    dimension 0 in mesh order, from inside a :func:`local_apply` body (an
    all-gather; for indices, which carry no gradient)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = current_rules().mesh
    placements = [Shard(0) if a in axes else Replicate() for a in mesh.mesh_dim_names]
    return DTensor.from_local(t, mesh, placements, run_check=False).full_tensor()


def gather_columns(t: torch.Tensor, axis: str, ranges: list[tuple[int, int]],
                   width: int) -> torch.Tensor:
    """Columns ``ranges[i]`` (global indices ``[lo, hi)`` of the last
    dimension) for this rank, rank i of mesh axis ``axis``, from inside a
    :func:`local_apply` body, where ``t`` holds this rank's block of a
    ``width``-column tensor split evenly over ``axis``, or all of it.
    Each rank sends the others only the columns they ask for, in one
    all-to-all (none where no rank needs another's), as GSPMD's
    collective-permutes move the halo of a dimension split unevenly;
    differentiable (the transpose sends the columns' gradients back)."""
    mesh, dim = _group(axis)
    me = mesh.get_local_rank(axis)
    lo, hi = ranges[me]
    w = t.shape[-1]
    if w == width:                                   # whole on every rank
        return t[..., lo:hi]
    from torch.distributed._functional_collectives import all_to_all_single_autograd

    def part(src: int, dst: int) -> tuple[int, int]:
        """The global columns rank ``src`` sends rank ``dst``."""
        a, b = max(ranges[dst][0], src * w), min(ranges[dst][1], (src + 1) * w)
        return (a, b) if b > a and src != dst else (0, 0)

    n = len(ranges)
    if not any(part(s, d)[1] for s in range(n) for d in range(n)):
        return t[..., lo - me * w:hi - me * w]
    cols = t.movedim(-1, 0)
    sends = [part(me, d) for d in range(n)]
    send = torch.cat([cols[a - me * w:b - me * w] for a, b in sends])
    recv_sizes = [b - a for a, b in (part(s, me) for s in range(n))]
    recv = all_to_all_single_autograd(send.contiguous(), recv_sizes,
                                      [b - a for a, b in sends], (mesh, dim))
    pieces = list(recv.split(recv_sizes))
    own = max(lo, me * w), min(hi, (me + 1) * w)
    pieces[me] = cols[own[0] - me * w:own[1] - me * w]
    return torch.cat([q for q in pieces if q.shape[0]]).movedim(0, -1)


def block_index(axes: tuple[str, ...]) -> int:
    """This rank's index among the ranks of the mesh axes ``axes`` (mesh
    order, major to minor)."""
    mesh = current_rules().mesh
    i = 0
    for a in axes:
        i = i * mesh.size(_group(a)[1]) + mesh.get_local_rank(a)
    return i


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
