"""Plain PyTorch versions of the RWKV-6 wkv recurrence (data-dependent decay).

:func:`wkv_recurrent_ref` is the token-by-token oracle; :func:`wkv_chunked_ref`
the chunked parallel form, which is the CPU path of :func:`.ops.wkv6` and the
version the CUDA kernel is held against on the card.  Both follow the
reference package's ``models/rwkv.py`` term for term; ``models/rwkv.py`` of
this package re-exports them under the reference's names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "wkv_chunked_ref", "wkv_recurrent_ref"]

CHUNK = 32


def wkv_recurrent_ref(r, k, v, w, u, s0):
    """Token-by-token oracle.  r/k/v/w: (B, L, H, N); u: (H, N);
    s0: (B, H, N, N) mapping k-dim -> v-dim.  Returns (y, s_final)."""
    s = s0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]      # (B,H,N)
        kv = kt[..., :, None] * vt[..., None, :]                 # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rt, s + u[None, :, :, None] * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, 1), s


def wkv_chunked_ref(r, k, v, w, u, s0, chunk: int = CHUNK):
    """Chunked parallel form in float32; same signature and semantics as
    the oracle.  A ragged L is padded to a chunk multiple with r = k = v = 0
    and w = 1 (log-decay 0), which leaves y and the final state unchanged.

    Within a chunk the pairwise decay is taken in log space,
    ``exp(min(cume[t] - cum[s], 0))`` masked to s < t, never as a ratio of
    two exps (which overflows for near-zero decays); the state advances by
    ``exp(total - cum)``, also <= 1.
    """
    B, L, H, N = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    pad = (-L) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (L + pad) // chunk
    rc, kc, vc, wc = (a.reshape(B, nc, chunk, H, N) for a in (r, k, v, w))
    u = u.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    s = s0.float()
    ys = []
    for c in range(nc):
        rt, kt, vt, wt = rc[:, c], kc[:, c], vc[:, c], wc[:, c]   # (B,C,H,N)
        lw = torch.log(torch.clamp(wt, min=1e-30))
        cum = torch.cumsum(lw, 1)                                 # inclusive
        cume = cum - lw                                           # exclusive
        r_dec = rt * torch.exp(cume)                              # r_t prod_{i<t} w_i
        y_inter = torch.einsum("bchn,bhnm->bchm", r_dec, s)
        diff = cume[:, :, None] - cum[:, None, :]                 # (B,C,C,H,N)
        W = torch.where(tri[None, :, :, None, None],
                        torch.exp(torch.clamp(diff, max=0.0)), 0.0)
        att = torch.einsum("bchn,bcdhn,bdhn->bhcd", rt, W, kt)   # (B,H,C,C)
        diag = torch.einsum("bchn,hn,bchn->bch", rt, u, kt)       # (B,C,H)
        ys.append(y_inter + torch.einsum("bhcd,bdhm->bchm", att, vt)
                  + diag[..., None] * vt)
        total = cum[:, -1]                                        # (B,H,N)
        k_fut = kt * torch.exp(total[:, None] - cum)              # total - cum <= 0
        s = torch.exp(total)[..., None] * s + torch.einsum("bchn,bchm->bhnm", k_fut, vt)
    return torch.cat(ys, 1)[:, :L], s
