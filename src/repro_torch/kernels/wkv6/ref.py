"""Plain PyTorch versions of the RWKV-6 wkv recurrence (data-dependent decay).

:func:`wkv_recurrent_ref` is the token-by-token oracle; :func:`wkv_chunked_ref`
the chunked parallel form, which is the CPU path of :func:`.ops.wkv6` and the
version the CUDA kernels are held against on the card.  Both follow the
reference package's ``models/rwkv.py`` term for term; ``models/rwkv.py`` of
this package re-exports them under the reference's names.

:func:`wkv_two_phase_ref` follows the arithmetic of the CUDA chunked route
step by step (phase 1 per chunk, the state scan, 16-token sub-chunks with a
reference point each, products in 3xTF32), so that the CPU tests can hold
that decomposition against the two above.  Nothing on the main path calls
it; ``python -m repro_torch.kernels.wkv6.precision`` prints its error with
plain TF32 and with 3xTF32 products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["CHUNK", "SUB", "wkv_chunked_ref", "wkv_recurrent_ref",
           "wkv_two_phase_ref"]

CHUNK = 32
SUB = 16       # tokens per sub-chunk of the chunked route


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


def _tf32(x):
    """x with the low 13 of its 23 mantissa bits zeroed: what a TF32 operand
    of the tensor cores keeps (the kernel zeroes them the same way)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm(a, b, passes: int):
    """a @ b with TF32 operands and float32 sums: ``passes`` = 3 is 3xTF32
    (hi.hi + hi.lo + lo.hi, hi = tf32(x), lo = tf32(x - hi)), as the kernel
    computes it; 1 is plain TF32."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    if passes != 3:
        raise ValueError(f"passes {passes}, expected 1 or 3")
    return (_tf32(a - ah) @ bh + ah @ _tf32(b - bh)) + ah @ bh


def wkv_two_phase_ref(r, k, v, w, u, s0, chunk: int = CHUNK, passes: int = 3):
    """The chunked route of ``csrc/wkv6.cu`` in plain PyTorch; the signature
    and semantics of :func:`wkv_chunked_ref`, ``chunk`` a multiple of 16.

    Phase 1, per (b, h, chunk): the log-decay cumsum; the intra-chunk
    attention with its diagonal 16 x 16 sub-blocks in the exact pairwise
    form and its off-diagonal sub-blocks as a product ``q . kk^T`` factored
    about ``ref`` = cume at the first token of the later sub-chunk (both
    exponents <= 0); ``y_intra = att . v`` with the bonus on att's diagonal;
    ``r_dec = r exp(cume)``, ``dS = (k exp(total - cum))^T . v`` and
    ``exp(total)``.  Phase 2, serial over chunks: ``y = y_intra + r_dec .
    S``, ``S <- exp(total) S + dS``.  Every product goes through
    :func:`_mm` with ``passes``.
    """
    if chunk % SUB:
        raise ValueError(f"chunk {chunk} is not a multiple of {SUB}")
    B, L, H, N = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    pad = (-L) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    nc = (L + pad) // chunk
    # (B, H, nc, C, N): one tile per (b, h, chunk)
    r, k, v, w = (a.reshape(B, nc, chunk, H, N).permute(0, 3, 1, 2, 4)
                  for a in (r, k, v, w))
    u = u.float()
    lw = torch.log(torch.clamp(w, min=1e-30))
    cum = torch.cumsum(lw, 3)
    cume = cum - lw
    total = cum[..., -1, :]                                       # (B,H,nc,N)

    # phase 1
    r_dec = r * torch.exp(cume)
    k_fut = k * torch.exp(total[..., None, :] - cum)
    dS = _mm(k_fut.transpose(-1, -2), v, passes)                  # (B,H,nc,N,N)
    att = r.new_zeros(B, H, nc, chunk, chunk)
    tri = torch.tril(torch.ones((SUB, SUB), dtype=torch.bool, device=r.device), -1)
    diag = torch.einsum("bhctn,hn,bhctn->bhct", r, u, k)
    for i in range(chunk // SUB):
        ti = slice(SUB * i, SUB * (i + 1))
        diff = cume[..., ti, None, :] - cum[..., None, ti, :]      # (...,16,16,N)
        W = torch.where(tri[:, :, None], torch.exp(torch.clamp(diff, max=0.0)), 0.0)
        att[..., ti, ti] = (torch.einsum("bhctn,bhctsn,bhcsn->bhcts", r[..., ti, :], W,
                                         k[..., ti, :])
                            + torch.diag_embed(diag[..., ti]))
        if i:
            ref = cume[..., SUB * i, None, :]
            q = r[..., ti, :] * torch.exp(torch.clamp(cume[..., ti, :] - ref, max=0.0))
            kk = k[..., :SUB * i, :] * torch.exp(torch.clamp(ref - cum[..., :SUB * i, :],
                                                             max=0.0))
            att[..., ti, :SUB * i] = _mm(q, kk.transpose(-1, -2), passes)
    y_intra = _mm(att, v, passes)                                 # (B,H,nc,C,N)

    # phase 2
    s = s0.float()
    ys = []
    for c in range(nc):
        ys.append(y_intra[:, :, c] + _mm(r_dec[:, :, c], s, passes))
        s = torch.exp(total[:, :, c])[..., None] * s + dS[:, :, c]
    y = torch.stack(ys, 2).permute(0, 2, 3, 1, 4).reshape(B, nc * chunk, H, N)
    return y[:, :L], s

