"""The one traffic generator: every input a cell's loop feeds, drawn from
``--seed`` by the parameters in the cell's file (``bench/cells/<cell>.json``).

* prompts: ``pool`` batches of ``batch`` x ``seq`` token ids, uniform over
  the vocabulary, drawn on the device in one call; call ``i`` of a prefill
  loop takes batch ``i % pool``.
* decode start tokens: ``batch`` ids per round of a decode loop.
* the decode cache's first ``prefix`` positions: seeded bf16 keys and
  values of unit variance, one draw per layer and tensor, the same for the
  program and for the reference, which draws them again.
"""

from __future__ import annotations

import torch

from .seeds import derive


def prompts(seed: int, pool: int, batch: int, seq: int, vocab: int,
            device: torch.device) -> torch.Tensor:
    """(pool, batch, seq) int64 token ids."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "prompts"))
    return torch.randint(0, vocab, (pool, batch, seq), generator=gen, device=device)


def start_tokens(seed: int, round_: int, batch: int, vocab: int) -> torch.Tensor:
    """(batch, 1) int64 token ids that open decode round ``round_``, on the
    host."""
    gen = torch.Generator()
    gen.manual_seed(derive(seed, "start", round_))
    return torch.randint(0, vocab, (batch, 1), generator=gen)


def prefix_kv(seed: int, layer: int, which: str, shape: tuple[int, ...],
              dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The cached keys (``which="k"``) or values (``"v"``) of one layer at
    the first positions: ``shape`` = (batch, kv heads, prefix, head_dim)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "cache", layer, which))
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)
