"""AdamW over lists of tensors, with the reference's arithmetic.

The reference's ``optim/adamw.py`` step for step: a global-norm clip in
float32, a linear warmup ``lr * min(step / warmup, 1)``, bias correction,
weight decay inside the update of every leaf, the update in float32 cast to
the parameter's dtype, and the moments kept in ``moment_dtype``
(``"bfloat16"`` halves the optimizer state).  ``torch.optim.AdamW`` is not
this: it updates a bf16 parameter in bf16 and orders the operations
otherwise.

The state is ``{"m": [...], "v": [...], "step": int32 scalar}``, its lists
aligned with the parameters; :func:`adamw_update` updates the parameters
and the state in place.  :func:`opt_state_axes` gives the state's logical
axes, for the dry-run's sharded state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" = compressed moments
    warmup_steps: int = 100


def adamw_init(params: list[torch.Tensor], cfg: OptConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, step 0."""
    mdt = _MOMENT_DTYPES[cfg.moment_dtype]
    dev = params[0].device if params else None
    return {"m": [torch.zeros(p.shape, dtype=mdt, device=p.device) for p in params],
            "v": [torch.zeros(p.shape, dtype=mdt, device=p.device) for p in params],
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_axes(axes_tree):
    """Logical axes for the optimizer state (mirrors the parameter axes)."""
    return {"m": axes_tree, "v": axes_tree, "step": ()}


def _schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def adamw_update(grads: list[torch.Tensor], opt_state: dict,
                 params: list[torch.Tensor], cfg: OptConfig):
    """One AdamW step: ``params``, ``opt_state["m"]``, ``["v"]`` and
    ``["step"]`` are updated in place.  Returns ``(params, opt_state,
    {"grad_norm", "lr"})`` as the reference does, the metrics as float32
    scalar tensors."""
    step = opt_state["step"].add_(1)
    gsq = sum(torch.sum(torch.square(g.float())) for g in grads)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = _schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(params, grads, opt_state["m"], opt_state["v"]):
        gf = g.float() * scale
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        mh = mf / bc1
        vh = vf / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
