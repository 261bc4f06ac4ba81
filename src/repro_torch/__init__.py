"""BottleMod on PyTorch: the compile -> prepare -> sweep -> Report path of the
analysis front door, with the batched curve queries as CUDA kernels.

    from repro_torch.analysis import compile_workflow
    plan = compile_workflow(workflow)          # on the CUDA card
    plan = compile_workflow(workflow, device="cpu")   # plain CPU versions

Subpackages keep the layout and names of the reference package ``repro``.
The engine works in float64 and the curve queries in float32
(:mod:`repro_torch.device`).
"""

from .device import ENGINE_DTYPE, QUERY_DTYPE, resolve_device

__all__ = ["ENGINE_DTYPE", "QUERY_DTYPE", "resolve_device"]
