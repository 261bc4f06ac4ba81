"""Process model — BottleMod Sect. 2.

A :class:`Process` bundles the *process-specific* functions of the paper:

* data requirement functions  ``R_Dk(n)``   (Sect. 2.2.1),
* resource requirement functions ``R_Rl(p)`` (Sect. 2.2.2, piecewise-linear,
  jumps allowed for "burst" resources),
* output functions ``O_m(p)``               (Sect. 2.4),
* the total progress ``p_end`` at which the process finishes.

The *execution-specific* input functions (``I_Dk(t)`` data, ``I_Rl(t)``
resource rate — Sect. 2.3) are supplied separately at solve time, preserving
the paper's separation of concerns between task author and execution
environment.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .ppoly import PPoly


@dataclass
class DataDep:
    """One data input: ``R_Dk`` maps bytes available -> max progress."""

    requirement: PPoly

    @staticmethod
    def stream(input_size: float, total_progress: float) -> "DataDep":
        """'stream' of Fig. 1(a): progress proportional to bytes read."""
        return DataDep(PPoly.linear(0.0, total_progress / input_size, start=0.0))

    @staticmethod
    def burst(input_size: float, total_progress: float) -> "DataDep":
        """'burst' of Fig. 1(a): all input needed before any progress."""
        return DataDep(PPoly.step([0.0, input_size], [0.0, total_progress]))


@dataclass
class ResourceDep:
    """One resource: ``R_Rl`` maps progress -> cumulative resource needed.

    Restricted to piecewise-linear (paper Sect. 4); jump discontinuities model
    'burst' resources (Fig. 1(b)) that must be absorbed before progress
    continues.
    """

    requirement: PPoly

    def __post_init__(self):
        if self.requirement.coeffs.shape[1] > 2:
            raise ValueError(
                "resource requirement functions must be piecewise-linear "
                "(paper Sect. 4 restriction)"
            )

    @staticmethod
    def stream(total_amount: float, total_progress: float) -> "ResourceDep":
        """'stream' of Fig. 1(b): resource consumed evenly over progress."""
        return ResourceDep(PPoly.linear(0.0, total_amount / total_progress))

    @staticmethod
    def burst_at(progress_point: float, amount: float, total_progress: float) -> "ResourceDep":
        """Resource jump of ``amount`` that must be absorbed when progress
        crosses ``progress_point`` (generalized 'burst' of Fig. 1(b); the
        figure's case is ``progress_point = 0``)."""
        pp = max(progress_point, 1e-9 * max(total_progress, 1.0))
        return ResourceDep(PPoly.step([0.0, pp], [0.0, amount]))


@dataclass
class Process:
    """A BottleMod process (paper Sect. 2)."""

    name: str
    data: dict[str, DataDep] = field(default_factory=dict)
    resources: dict[str, ResourceDep] = field(default_factory=dict)
    outputs: dict[str, PPoly] = field(default_factory=dict)
    total_progress: float = 1.0

    def identity_output(self, name: str = "out") -> "Process":
        """Attach the identity output ``O(p) = p`` (paper Sect. 5.2)."""
        self.outputs[name] = PPoly.linear(0.0, 1.0)
        return self
