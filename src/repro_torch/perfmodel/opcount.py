"""Per-device FLOPs, bytes and collective bytes of a step, counted as it runs.

The port's twin of the reference's ``perfmodel/hlo.py``, which walks the
compiled per-device program (post-GSPMD HLO text).  PyTorch has no such
program: a step runs op by op.  So the step runs once on ``DTensor``s whose
local shards are :class:`Counted` tensors: a wrapper subclass over a
``meta`` tensor, whose ``__torch_dispatch__`` sees exactly what one device
executes after DTensor's sharding propagation, the local aten ops and the
``_c10d_functional`` collectives, and counts them before running each on
the meta tensors (shapes only, no memory, no device).

* **flops**: 2·M·N·K per ``mm``/``addmm`` and 2·B·M·N·K per
  ``bmm``/``baddbmm``; elementwise ops are not counted, as the reference's
  dot-walk counts only dots.
* **bytes**: operand plus result bytes of every op that moves data; views
  (an op whose results alias its inputs), ``empty`` and the collectives'
  bookkeeping are free, and ``copy_`` does not read what it overwrites.
  This is eager execution's traffic model, each op a round trip to device
  memory, as fusion boundaries are the reference's.
* **collective bytes**: the operand bytes of each collective, under the
  reference's HLO names ("all-gather", "reduce-scatter", ...).
* **tracked bytes**: the bytes of tensors whose size is one of
  ``track_sizes`` (attention scores, for the flash estimate).

Every iteration of a Python loop is dispatched and counted, so there is no
trip-count correction to make (``n_while`` is 0).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import torch

__all__ = ["CollectiveStats", "Counted", "OpCounter", "OpReport", "collective_stats"]

#: _c10d_functional op -> the reference's HLO collective name
COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}

_MM = {"mm", "addmm"}
_BMM = {"bmm", "baddbmm"}
#: ops that move no data: allocation without a write, and views the schema
#: does not mark as aliasing
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_unsafe_view", "lift_fresh"}
#: in-place ops that overwrite their first argument without reading it
_OVERWRITE = {"copy_", "fill_", "zero_"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class OpReport:
    flops: float = 0.0
    bytes: float = 0.0
    tracked_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: dict = field(default_factory=dict)
    collective_counts: dict = field(default_factory=dict)
    bytes_by_op: dict = field(default_factory=dict)
    n_ops: int = 0
    n_while: int = 0

    def as_dict(self) -> dict:
        """The reference's ``HloReport.as_dict()`` keys, and ``n_ops``."""
        return {
            "flops": self.flops, "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "collective_by_op": dict(self.collective_by_op),
            "collective_counts": dict(self.collective_counts),
            "n_while": self.n_while, "n_ops": self.n_ops,
        }


class OpCounter:
    """Running totals of the ops that reach :class:`Counted` tensors."""

    def __init__(self, track_sizes: frozenset = frozenset()):
        self.track_sizes = frozenset(track_sizes)
        self.flops = 0.0
        self.bytes = 0.0
        self.tracked = 0.0
        self.n_ops = 0
        self.bytes_by_op: dict[str, float] = defaultdict(float)
        self.coll: dict[str, float] = defaultdict(float)
        self.coll_counts: dict[str, float] = defaultdict(float)

    def wrap(self, t: torch.Tensor) -> "Counted":
        """A meta tensor as a counted local shard."""
        return Counted(t, self)

    def record(self, func, args, ins: list, outs: list) -> None:
        """Count one op: ``args`` its unwrapped positional arguments, ``ins``
        and ``outs`` the tensors it reads and returns."""
        self.n_ops += 1
        name = func.__name__.split(".")[0]
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            kind = COLLECTIVE_OPS.get(name)
            if kind is not None:
                self.coll[kind] += sum(_nbytes(a) for a in ins)
                self.coll_counts[kind] += 1
            return
        if name in _MM:
            a, b = args[-2], args[-1]
            self.flops += 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
        elif name in _BMM:
            a, b = args[-2], args[-1]
            self.flops += 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        if name in _FREE or _is_view(func):
            return
        if name in _OVERWRITE:
            ins = ins[1:]
        moved = sum(_nbytes(a) for a in ins) + sum(_nbytes(o) for o in outs)
        self.bytes += moved
        self.bytes_by_op[name] += moved
        if self.track_sizes:
            self.tracked += sum(_nbytes(t) for t in ins + outs
                                if _nbytes(t) in self.track_sizes)

    def report(self) -> OpReport:
        return OpReport(flops=self.flops, bytes=self.bytes, tracked_bytes=self.tracked,
                        collective_bytes=sum(self.coll.values()),
                        collective_by_op=dict(self.coll),
                        collective_counts=dict(self.coll_counts),
                        bytes_by_op=dict(self.bytes_by_op), n_ops=self.n_ops)


def _is_view(func) -> bool:
    """Every result aliases an input and nothing is written: a view."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


class Counted(torch.Tensor):
    """A meta tensor whose ops are counted by ``counter`` as they run."""

    elem: torch.Tensor
    counter: OpCounter

    @staticmethod
    def __new__(cls, elem: torch.Tensor, counter: OpCounter):
        if elem.device.type != "meta":
            raise ValueError(f"Counted wraps meta tensors, not {elem.device.type}")
        out = torch.Tensor._make_wrapper_subclass(
            cls, elem.shape, strides=elem.stride(), storage_offset=elem.storage_offset(),
            dtype=elem.dtype, device=elem.device, requires_grad=elem.requires_grad)
        out.elem = elem
        out.counter = counter
        return out

    def __repr__(self) -> str:
        return f"Counted({tuple(self.shape)}, {self.dtype})"

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        # hand-rolled (un)wrapping: arguments are tensors, scalars and flat
        # lists of them, and pytree's generality costs most of a count
        kwargs = kwargs or {}
        found: list[Counted] = []
        ins: list[torch.Tensor] = []

        def un(x):
            if isinstance(x, torch.Tensor):
                if isinstance(x, Counted):
                    found.append(x)
                    x = x.elem
                ins.append(x)
                return x
            if type(x) in (list, tuple):
                return type(x)(un(e) for e in x)
            return x

        uargs = tuple(un(a) for a in args)
        ukwargs = {k: un(v) for k, v in kwargs.items()}
        counter = found[0].counter
        out = func(*uargs, **ukwargs)
        # an in-place op returns its (mutated) argument: the same wrapper
        given = {id(a.elem): a for a in found}
        outs: list[torch.Tensor] = []

        def wrap(x):
            if isinstance(x, torch.Tensor):
                outs.append(x)
                if x.device.type != "meta":
                    return x
                mine = given.get(id(x))
                return Counted(x, counter) if mine is None else mine
            if type(x) in (list, tuple):
                return type(x)(wrap(e) for e in x)
            return x

        res = wrap(out)
        counter.record(func, uargs, ins, outs)
        return res


@dataclass
class CollectiveStats:
    total_bytes: float = 0.0
    by_op: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"total_bytes": self.total_bytes, "by_op": self.by_op,
                "counts": self.counts}


def collective_stats(report: OpReport) -> CollectiveStats:
    return CollectiveStats(total_bytes=report.collective_bytes,
                           by_op=report.collective_by_op,
                           counts=report.collective_counts)
