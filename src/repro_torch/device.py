"""Device and dtype policy of the torch port.

Every entry point takes ``device=``.  ``None`` means the CUDA card: the
port is written for the GPU, and a machine without one raises instead of
quietly running the plain CPU versions.  The CPU is used only when the
caller asks for it (``device="cpu"``), as the CPU test-suite does.

Precision follows the reference package: the sweep engine's state is
float64 (its tolerances are those of the scalar solver), the batched curve
queries run in float32.
"""

from __future__ import annotations

import torch

__all__ = ["ENGINE_DTYPE", "QUERY_DTYPE", "resolve_device"]

#: the fused sweep engine's working type
ENGINE_DTYPE = torch.float64
#: the curve-query kernels' working type
QUERY_DTYPE = torch.float32


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> the CUDA card; raises when the requested card is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and no CUDA device "
            "is available; pass device='cpu' to run the plain CPU versions")
    return dev
