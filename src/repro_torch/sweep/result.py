"""Back-compat shim: ``SweepResult`` is the unified analysis ``Report``.

The sweep-specific result type was folded into the single
:class:`repro_torch.analysis.report.Report` that every query of a compiled
workflow returns (scalar solve, batched sweep, what-if). This module keeps
the old names importable.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch.analysis.report import BottleneckRow, Report

#: deprecated alias — use :class:`repro_torch.analysis.report.Report`
SweepResult = Report


def _pack_f32(bpl: Any) -> tuple[np.ndarray, np.ndarray]:
    """BPL (float64 numpy) -> (starts, coeffs) float32 for the curve-query
    kernels."""
    return bpl.kernel_args()


__all__ = ["BottleneckRow", "Report", "SweepResult", "_pack_f32"]
