"""Seeds derived from ``--seed``: one independent stream per use."""

from __future__ import annotations

import hashlib
import random


def derive(seed: int, *tags: object) -> int:
    """A 63-bit seed for ``(seed, *tags)``; any whole ``seed``."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def spread_rows(rng: random.Random, B: int, n: int) -> list[int]:
    """``n`` rows of a batch of ``B`` drawn with ``rng``, spread over the
    batch: the rows fall into ``min(n, B)`` contiguous strata of near-equal
    size and each stratum gives one pick; past ``B`` picks every row is
    taken again in turn. So ``n >= B`` takes every row, and any contiguous
    half of the batch holds about half of the picks."""
    k = min(n, B)
    edges = [B * i // k for i in range(k + 1)]
    first = [rng.randrange(edges[i], edges[i + 1]) for i in range(k)]
    return [first[j % k] for j in range(n)]
