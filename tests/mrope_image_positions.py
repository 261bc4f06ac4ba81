"""The M-RoPE positions of an image prompt, for the port's tests.

A copy of ``chip_smoke.py``'s builder, kept here once for every test that
feeds qwen2-vl distinct (t, h, w) streams.  It imports no JAX, so the
card's tests can use it on a machine without one.
"""

import torch


def mrope_positions(B: int, S: int, text: int, grid: tuple[int, int], device=None):
    """(3, B, S) M-RoPE positions of an image prompt as Qwen2-VL numbers it:
    ``text`` text tokens (t = h = w = i), a gh x gw grid of patches (t =
    text, h = text + row, w = text + column), then text again from text +
    max(gh, gw) on, the three streams equal."""
    gh, gw = grid
    n = gh * gw
    patch = torch.arange(n)
    head = torch.arange(text)
    tail = text + max(gh, gw) + torch.arange(S - text - n)
    t = torch.cat([head, torch.full((n,), text), tail])
    h = torch.cat([head, text + patch // gw, tail])
    w = torch.cat([head, text + patch % gw, tail])
    return torch.stack([t, h, w])[:, None].expand(3, B, S).to(device)
