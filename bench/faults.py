"""Faults planted under the timed path: each breaks one function of the
program the way a faulty change could, and a run with it must come out not
correct. The CPU tests plant them at smoke size
(``bench/tests/test_bench_faults.py``); the card test and
``calibrate.py --fault`` plant them at a cell's own size.

    with planted("wkv6_state_dropped", limit):
        ... drive a run ...
"""

from __future__ import annotations

import contextlib
import copy

import torch


def _program():
    from .harness.core import program

    program()                            # the checkout's src on sys.path
    from repro_torch.models import attention, rwkv, transformer
    return transformer, attention, rwkv


def half_batch(x: torch.Tensor) -> torch.Tensor:
    """The first half's rows kept, the second half given their mean."""
    out = x.clone()
    h = out.shape[0] // 2
    out[h:] = out[:h].mean(dim=0, keepdim=True)
    return out


def _answer_altered(limit: float):
    T, _, _ = _program()
    orig = T.prefill

    def broken(params, cfg, batch):
        out = orig(params, cfg, batch).clone()
        out[:, 7] += 2 * limit
        return out
    return [(T, "prefill", broken)]


def _prefill_half_batch(limit: float):
    T, _, _ = _program()
    orig = T.prefill
    return [(T, "prefill", lambda p, cfg, b: half_batch(orig(p, cfg, b)))]


def _token_altered(limit: float):
    T, _, _ = _program()
    orig = T.decode_step

    def broken(params, cfg, cache, batch, pos):
        logits, cache = orig(params, cfg, cache, batch, pos)
        logits = logits.clone()
        logits[0, 11] += 1e3                     # row 0's token becomes 11
        return logits, cache
    return [(T, "decode_step", broken)]


def _decode_half_batch(limit: float):
    T, _, _ = _program()
    orig = T.decode_step

    def broken(params, cfg, cache, batch, pos):
        logits, cache = orig(params, cfg, cache, batch, pos)
        return half_batch(logits), cache
    return [(T, "decode_step", broken)]


def _state_unchanged(limit: float):
    """A decode step that returns its cache as it found it (a copy of the
    cache takes the step's writes): smoke size only."""
    T, _, _ = _program()
    orig = T.decode_step

    def broken(params, cfg, cache, batch, pos):
        logits, _ = orig(params, cfg, copy.deepcopy(cache), batch, pos)
        return logits, cache
    return [(T, "decode_step", broken)]


def _wkv6_state_dropped(limit: float):
    """The wkv6 call with the state carried between its chunks zeroed: each
    chunk of each row runs as a row of its own from a zero state (the first
    chunk from the call's ``s0``), through the program's own kernel."""
    _, _, R = _program()
    orig = R.wkv6

    def broken(r, k, v, w, u, s0, *, chunk=32, compute_dtype=torch.float32):
        B, L, H, N = r.shape
        n = L // chunk
        if n * chunk != L:
            raise ValueError(f"length {L} is not a whole number of chunks of {chunk}")
        s = torch.zeros((B, n, H, N, N), dtype=torch.float32, device=s0.device)
        s[:, 0] = s0
        split = [x.float().reshape(B * n, chunk, H, N) for x in (r, k, v, w)]
        y, s_fin = orig(*split, u, s.reshape(B * n, H, N, N), chunk=chunk,
                        compute_dtype=compute_dtype)
        return y.reshape(B, L, H, N), s_fin.reshape(B, n, H, N, N)[:, -1]
    return [(R, "wkv6", broken)]


def _attention_diagonal_block(limit: float):
    """Causal attention limited to the diagonal blocks of 128 positions
    (of a quarter of the sequence below 512): the kernel on the card, the
    plain path on the CPU, each run on the blocks as a batch of their own."""
    _, A, _ = _program()

    def limited(orig):
        def broken(q, k, v, **kw):
            B, H, S, D = q.shape
            blk = 128 if S >= 512 else S // 4
            n = S // blk
            if n * blk != S:
                raise ValueError(f"length {S} is not a whole number of blocks of {blk}")

            def split(x):
                return (x.reshape(B, x.shape[1], n, blk, D).transpose(1, 2)
                        .reshape(B * n, x.shape[1], blk, D))
            o = orig(split(q), split(k), split(v), **kw)
            return o.reshape(B, n, H, blk, D).transpose(1, 2).reshape(B, H, S, D)
        return broken
    return [(A, "flash_attention", limited(A.flash_attention)),
            (A, "_dense_attention", limited(A._dense_attention))]


#: name -> (the cells' modes it applies to, the families it applies to or
#: None for all, the patches it makes for a limit)
FAULTS = {
    "answer_altered": (("prefill",), None, _answer_altered),
    "prefill_half_batch": (("prefill",), None, _prefill_half_batch),
    "token_altered": (("decode",), None, _token_altered),
    "decode_half_batch": (("decode",), None, _decode_half_batch),
    "state_unchanged": (("decode",), None, _state_unchanged),
    "wkv6_state_dropped": (("prefill",), ("rwkv6",), _wkv6_state_dropped),
    "attention_diagonal_block": (("prefill",), ("dense_gqa",), _attention_diagonal_block),
}
#: the faults inside a kernel's call, which the card test plants at the
#: cells' own size
KERNEL_FAULTS = ("wkv6_state_dropped", "attention_diagonal_block")


def applies(name: str, cell: dict, config: dict) -> bool:
    modes, families, _ = FAULTS[name]
    return cell["mode"] in modes and (families is None or config["reference"] in families)


@contextlib.contextmanager
def planted(name: str, limit: float):
    """The program with fault ``name`` planted for the block's length."""
    patches = FAULTS[name][2](limit)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, new in patches:
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in saved:
            setattr(obj, attr, old)
