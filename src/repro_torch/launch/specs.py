"""Input stand-ins and step builders for every (architecture × shape) cell,
for the dry-run and the perf model.

The reference's ``launch/specs.py``: ``ShapeDtypeStruct`` stand-ins become
``meta`` tensors (shapes and dtypes, no memory), each with its logical axes
tree beside it, and the jitted step bodies become eager functions with the
same steps: ``loss_fn``, ``loss.backward()``, the microbatch loop and
:func:`repro_torch.optim.adamw_update` for training; ``prefill``;
``decode_step``.  ``lower_cell`` becomes :func:`count_cell`: it builds a
``DTensor`` per leaf over the mesh (placements from the active
``axis_rules``), with :class:`repro_torch.perfmodel.opcount.Counted` local
shards, runs the step once, and returns the per-device counts.

The port's optimizer state is aligned with ``DecoderLM.parameters()`` (one
tensor per layer), so :func:`opt_specs_tree` lists its leaves in that order,
each with the axes of its parameter's stacked leaf less the ``layers`` axis.

Parameters are stored as the rules place them, "embed" over "data" (FSDP,
ZeRO-3), and each step first gathers them to their compute placement, the
same rules without that mapping (:func:`_unshard`): the all-gathers GSPMD
inserts for the reference.  Where the kv heads divide the "model" axis, the
kv projections' compute placement splits their columns over it as the
query heads' are split (GSPMD carries the head split of the reshape back
onto them).  The expert stacks stay as stored until their
MoE form places them.  The training step's gradients come back as
partial sums over the data axis, and the optimizer's update of the stored
(sharded) parameters reduce-scatters them.  Left to itself, DTensor would
gather a decode step's whole batch instead and reduce partial products.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs import ShapeSpec
from ..distributed import AxisRules, current_rules, placements_for
from ..models import transformer as T
from ..models.attention import kv_heads_split
from ..models.common import ModelConfig, param_axes, param_shapes_concrete, param_specs
from ..optim import OptConfig, adamw_update, opt_state_axes
from ..perfmodel.opcount import OpCounter, OpReport

__all__ = ["Cell", "batch_specs", "cache_specs", "count_cell", "make_cell",
           "make_decode_cell", "make_prefill_cell", "make_train_cell",
           "opt_specs_tree", "param_specs_tree"]

_MOMENTS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> tuple[dict, dict]:
    """(meta tensor tree, logical-axes tree) for a data batch."""
    B, S = shape.global_batch, shape.seq_len
    S_in = 1 if shape.kind == "decode" else S
    specs: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    if cfg.frontend == "audio":
        specs["embeddings"] = _meta((B, S_in, cfg.d_model), cfg.torch_dtype)
        axes["embeddings"] = ("batch", "seq", "act_embed")
        if shape.kind == "train":
            specs["labels"] = _meta((B, S_in, cfg.n_codebooks), torch.int32)
            axes["labels"] = ("batch", "seq", None)
    else:
        specs["tokens"] = _meta((B, S_in), torch.int32)
        axes["tokens"] = ("batch", "seq")
        if shape.kind == "train":
            specs["labels"] = _meta((B, S_in), torch.int32)
            axes["labels"] = ("batch", "seq")
    if cfg.mrope_sections is not None:
        specs["positions"] = _meta((3, B, S_in), torch.int32)
        axes["positions"] = (None, "batch", "seq")
    return specs, axes


def cache_specs(cfg: ModelConfig, shape: ShapeSpec) -> tuple[dict, dict]:
    return (T.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta"),
            T.cache_axes(cfg))


def param_specs_tree(cfg: ModelConfig) -> tuple[dict, dict]:
    return param_shapes_concrete(cfg), param_axes(cfg)


def _layer_param_axes(cfg: ModelConfig) -> list[tuple[torch.Size, torch.dtype, tuple]]:
    """(shape, dtype, axes) of each of ``DecoderLM(cfg, ...).parameters()``
    in order: a block parameter is its stacked leaf's slice, whose axes are
    the leaf's less the leading ``layers``."""
    flat = {p: s.axes for p, s in param_specs(cfg).items()}
    model = T.DecoderLM(cfg, param_shapes_concrete(cfg))
    out = []
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            key = ".".join(["blocks", f"pos{int(parts[1]) % cfg.period}", *parts[2:]])
            out.append((p.shape, p.dtype, flat[key][1:]))
        else:
            out.append((p.shape, p.dtype, flat[name]))
    return out


def opt_specs_tree(cfg: ModelConfig, opt: OptConfig) -> tuple[dict, dict]:
    """The AdamW state of :func:`repro_torch.optim.adamw_init` for
    ``DecoderLM(cfg, ...).parameters()``, as meta tensors, and its axes."""
    leaves = _layer_param_axes(cfg)
    mdt = _MOMENTS[opt.moment_dtype]
    shapes = {"m": [_meta(s, mdt) for s, _, _ in leaves],
              "v": [_meta(s, mdt) for s, _, _ in leaves],
              "step": _meta((), torch.int32)}
    return shapes, opt_state_axes([a for _, _, a in leaves])


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

@dataclass
class Cell:
    """Everything needed to count one (arch × shape) cell on a mesh."""
    fn: Callable
    args: tuple            # meta tensor trees
    axes: tuple            # logical-axes trees, one per argument


def _micro_batches(batch: dict, n: int) -> list[dict]:
    """``batch`` split into ``n`` microbatches along its batch axis (axis 1
    of M-RoPE positions, axis 0 of the rest)."""
    parts = {k: torch.chunk(v, n, dim=1 if k == "positions" else 0)
             for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def _unshard(params: dict, axes: dict, cfg: ModelConfig, whole_table: bool = False) -> dict:
    """Each ``DTensor`` parameter redistributed from its stored placement to
    its compute placement (the active rules with "embed" unmapped); plain
    tensors, and the expert stacks, as they are: each MoE form places those
    itself (the global form keeps D split over "data", as GSPMD keeps the
    reference's, the expert-parallel forms gather them in their local
    body).  ``whole_table`` also gathers the embedding table
    over the vocabulary: DTensor cannot take the gradient of a lookup in a
    vocab-sharded table (its masked partial sum meets a plain one)."""
    r = current_rules()
    if r is None:
        return params
    from torch.distributed.tensor import DTensor

    compute = AxisRules(r.mesh, {**r.rules, "embed": ()})
    if kv_heads_split(cfg):
        compute.rules["kv"] = r.rules["cache_heads"]

    def rec(t, a, path):
        if isinstance(t, dict):
            return {k: rec(t[k], a[k], path + (k,)) for k in t}
        if not isinstance(t, DTensor) or "experts" in a:
            return t
        if whole_table and path == ("embed",):
            a = (None,) * t.dim()
        return t.redistribute(r.mesh, compute.placements_for(a, tuple(t.shape)))

    return rec(params, axes, ())


def make_train_cell(cfg: ModelConfig, shape: ShapeSpec, opt: OptConfig | None = None,
                    grad_accum: int = 1) -> Cell:
    """``grad_accum > 1`` splits the global batch into microbatches run one
    after the other, their gradients summed before one optimizer update —
    the standard activation-memory lever (per-microbatch activations shrink
    by the accumulation factor; weight traffic is unchanged)."""
    opt = opt or OptConfig()

    def train_step(params, opt_state, batch):
        model = T.DecoderLM(cfg, _unshard(params, paxes, cfg, whole_table=True))
        model.requires_grad_(True)
        work = list(model.parameters())
        if grad_accum == 1:
            loss = T.loss_fn(model, cfg, batch)
            loss.backward()
            grads = [p.grad for p in work]
        else:
            lsum = 0.0
            for mb in _micro_batches(batch, grad_accum):
                micro = T.loss_fn(model, cfg, mb)
                micro.backward()
                lsum = lsum + micro.detach()
            grads = [(p.grad / grad_accum).float() for p in work]
            loss = lsum / grad_accum
        # the update goes to the stored parameters, layer slices of the
        # stacked leaves in the model's order
        stored = list(T.DecoderLM(cfg, params).parameters())
        _, _, metrics = adamw_update(grads, opt_state, stored, opt)
        metrics["loss"] = loss.detach()
        return stored, opt_state, metrics

    pshape, paxes = param_specs_tree(cfg)
    oshape, oaxes = opt_specs_tree(cfg, opt)
    bshape, baxes = batch_specs(cfg, shape)
    return Cell(fn=train_step, args=(pshape, oshape, bshape), axes=(paxes, oaxes, baxes))


def make_prefill_cell(cfg: ModelConfig, shape: ShapeSpec) -> Cell:
    def prefill_step(params, batch):
        with torch.no_grad():
            return T.prefill(T.DecoderLM(cfg, _unshard(params, paxes, cfg)), cfg, batch)

    pshape, paxes = param_specs_tree(cfg)
    bshape, baxes = batch_specs(cfg, shape)
    return Cell(fn=prefill_step, args=(pshape, bshape), axes=(paxes, baxes))


def make_decode_cell(cfg: ModelConfig, shape: ShapeSpec) -> Cell:
    """One decode step at the last position of a ``seq_len`` context (the
    reference traces the position; the port's step takes it as an int)."""
    def decode_step(params, cache, batch):
        with torch.no_grad():
            return T.decode_step(T.DecoderLM(cfg, _unshard(params, paxes, cfg)), cfg, cache,
                                 batch, shape.seq_len - 1)

    pshape, paxes = param_specs_tree(cfg)
    cshape, caxes = cache_specs(cfg, shape)
    bshape, baxes = batch_specs(cfg, shape)
    return Cell(fn=decode_step, args=(pshape, cshape, bshape), axes=(paxes, caxes, baxes))


def make_cell(cfg: ModelConfig, shape: ShapeSpec) -> Cell:
    if shape.kind == "train":
        return make_train_cell(cfg, shape)
    if shape.kind == "prefill":
        return make_prefill_cell(cfg, shape)
    return make_decode_cell(cfg, shape)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _is_axes(a) -> bool:
    return isinstance(a, tuple) and all(isinstance(e, (str, type(None))) for e in a)


def _dtensor(meta: torch.Tensor, axes: tuple, mesh, counter: OpCounter):
    """A DTensor of ``meta``'s global shape and dtype whose local shard is a
    counted meta tensor, placed as the active rules place ``axes``."""
    from torch.distributed.tensor import DTensor, Shard

    placements = placements_for(axes, tuple(meta.shape))
    local = list(meta.shape)
    for size, pl in zip(mesh.shape, placements):
        if isinstance(pl, Shard):
            local[pl.dim] //= size          # spec_for only keeps divisors
    shard = counter.wrap(_meta(local, meta.dtype))
    return DTensor.from_local(shard, mesh, placements, run_check=False,
                              shape=meta.shape, stride=meta.stride())


def _build(tree, axes, mesh, counter: OpCounter):
    if isinstance(tree, torch.Tensor):
        if not _is_axes(axes):
            raise ValueError(f"axes {axes!r} for a tensor leaf")
        if mesh.size() == 1:     # every placement whole: the plain program
            return counter.wrap(_meta(tree.shape, tree.dtype))
        return _dtensor(tree, axes, mesh, counter)
    if isinstance(tree, dict):
        return {k: _build(tree[k], axes[k], mesh, counter) for k in tree}
    return [_build(t, a, mesh, counter) for t, a in zip(tree, axes, strict=True)]


def count_cell(cell: Cell, mesh, track_sizes: frozenset = frozenset()) -> OpReport:
    """Run ``cell.fn`` once on DTensors over ``mesh`` (an ``axis_rules``
    context for it must be active) and return rank 0's per-device counts.
    Plain tensors the step makes (positions, masks) count as replicated.  On
    a mesh of one card (:func:`repro_torch.launch.mesh.make_host_mesh`) the
    arguments are plain counted tensors: DTensor would add nothing there."""
    from torch.distributed.tensor.experimental import implicit_replication

    rules = current_rules()
    if rules is None or rules.mesh is not mesh:
        raise RuntimeError("count_cell needs an active axis_rules context on its mesh")
    counter = OpCounter(track_sizes)
    args = [_build(t, a, mesh, counter) for t, a in zip(cell.args, cell.axes)]
    with implicit_replication():
        cell.fn(*args)
    return counter.report()


def local_bytes(tree, axes, mesh) -> float:
    """Per-device bytes of a meta tensor tree placed as the active rules
    place ``axes`` (no tensor is made)."""
    if isinstance(tree, torch.Tensor):
        spec = current_rules().spec_for(axes, tuple(tree.shape))
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        div = math.prod(sizes[ax] for e in spec if e is not None
                        for ax in ((e,) if isinstance(e, str) else e))
        return tree.numel() * tree.element_size() / div
    if isinstance(tree, dict):
        return sum(local_bytes(tree[k], axes[k], mesh) for k in tree)
    return sum(local_bytes(t, a, mesh) for t, a in zip(tree, axes))
