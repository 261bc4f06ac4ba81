"""Three-term roofline model over a dry-run cell's per-device counts.

Hardware constants of one NVIDIA H100 SXM5 80GB (the part that reports
itself as "NVIDIA H100 80GB HBM3" with a 700 W power limit), from NVIDIA's
H100 Tensor Core GPU datasheet:
  * 989.4 TFLOP/s bf16 dense (the datasheet's 1,979 assumes 2:4 sparsity)
  * 3.35 TB/s HBM3 bandwidth
  * 80 GB HBM3 (fit criterion, reported not enforced)
  * 50 GB/s per card for collectives: the production mesh of 256 cards
    spans 32 nodes of 8, so most of its collective bytes cross InfiniBand
    NDR (400 Gb/s, one adapter per card), not NVLink's 900 GB/s within a
    node.  The collective term divides by this rate.

Terms (seconds, per step, per card — the per-device program's numbers):
  compute    = FLOPs / peak_FLOPs
  memory     = bytes / HBM_bw
  collective = collective_bytes / link_bw

MODEL_FLOPS uses the 6·N·D convention (6·N_active·D for MoE) so the
useful-compute ratio exposes remat/dispatch overheads.
"""

from __future__ import annotations

from ..configs import ShapeSpec
from ..models.common import ModelConfig

__all__ = ["HBM_BW", "HBM_BYTES", "LINK_BW", "PEAK_FLOPS",
           "model_flops", "roofline_terms"]

PEAK_FLOPS = 989.4e12        # bf16 dense / card
HBM_BW = 3.35e12             # bytes/s / card
LINK_BW = 50e9               # bytes/s / card, InfiniBand NDR between nodes
HBM_BYTES = 80e9             # H100 SXM5 80GB


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); backward included for training."""
    n = cfg.active_params() if cfg.n_experts else cfg.n_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def roofline_terms(*, cfg: ModelConfig, shape: ShapeSpec, n_chips: int,
                   flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float) -> dict:
    t_compute = flops_per_device / PEAK_FLOPS
    t_memory = bytes_per_device / HBM_BW
    t_collective = collective_bytes_per_device / LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_collective}
    dominant = max(terms, key=terms.get)
    bound = max(t_compute, t_memory, t_collective)
    mf = model_flops(cfg, shape)
    hlo_global = flops_per_device * n_chips
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "step_lower_bound_s": bound,
        "model_flops_global": mf,
        "hlo_flops_global": hlo_global,
        "useful_flops_ratio": (mf / hlo_global) if hlo_global else 0.0,
        "roofline_fraction": (mf / n_chips / PEAK_FLOPS) / bound if bound else 0.0,
        "hw": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "ici_bw": LINK_BW,
               "hbm_bytes": HBM_BYTES, "chips": n_chips},
    }
