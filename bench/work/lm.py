"""Operations and least bytes of the language-model calls the cells time.

Everything is computed from the widths of a configuration file's ``model``
object (``bench/configs/<name>.json``), never from the program. What
differs between model families (the layers' weights, the mixer's kernel
calls, a decode step's cache traffic) is counted by the family's own
module, ``bench/reference/<family>.py``, beside its reference, over the
whole model: ``matrix_params`` (every matrix weight of every layer, all
experts included), ``active_matrix_params`` (those one token's products
meet: ``top_k`` of ``n_experts``), ``vector_params`` (every layer's
vectors), ``kernel_calls`` and ``decode_cache``. So a family whose period
mixes layer kinds, or whose tokens meet some experts only, counts itself;
this file composes those counts into whole calls. An operation is one
multiply or one add (a multiply-add counts 2). Counts are of the work the
call needs for its result: a prefill needs the logits of the last position
only, so the output projection is counted for B rows, whatever the program
computes besides. Least bytes count each input read once and each output
written once; a decode step is counted as reading every expert's weights,
as a batch of many sequences routes some token to each.
"""

from __future__ import annotations

from types import ModuleType

from .peaks import BF16_FLOPS, HBM_BYTES_S

BF16 = 2
F32 = 4


def param_count(fam: ModuleType, m: dict) -> int:
    """Every parameter: layers (every expert), embedding, output head and
    final norm."""
    D, V = m["d_model"], m["vocab_size"]
    return fam.matrix_params(m) + fam.vector_params(m) + 2 * V * D + D


def prefill_call(fam: ModuleType, m: dict, B: int, S: int) -> float:
    """Operations of one prefill call of B prompts of S tokens to the last
    position's logits: every layer's products over B S tokens, the mixers'
    calls, the output head over B rows."""
    D, V = m["d_model"], m["vocab_size"]
    ops = 2 * fam.active_matrix_params(m) * B * S + 2 * D * V * B
    ops += sum(n * o for n, o, _ in fam.kernel_calls(m, B, S).values())
    return float(ops)


def decode_step(fam: ModuleType, m: dict, B: int, pos: int) -> float:
    """Operations of one decode step of B sequences whose new token sits at
    position ``pos``."""
    D, V = m["d_model"], m["vocab_size"]
    ops = 2 * fam.active_matrix_params(m) * B + 2 * D * V * B
    return float(ops + fam.decode_cache(m, B, pos)[0])


def decode_step_bytes(fam: ModuleType, m: dict, B: int, pos: int) -> float:
    """Least bytes of one decode step at position ``pos``: every weight but
    the embedding read once (bf16 matrices, every expert's among them;
    float32 vectors), B embedding rows, and the cache traffic the family
    counts."""
    D, V = m["d_model"], m["vocab_size"]
    weights = (BF16 * (fam.matrix_params(m) + D * V)
               + F32 * (fam.vector_params(m) + D))
    return float(weights + BF16 * B * D + fam.decode_cache(m, B, pos)[1])


def bound_s(ops: float, nbytes: float, peak_flops: float = BF16_FLOPS) -> float:
    """The least time: the larger of operations at ``peak_flops`` and bytes
    at the HBM rate."""
    return max(ops / peak_flops, nbytes / HBM_BYTES_S)


__all__ = ["bound_s", "decode_step", "decode_step_bytes", "param_count", "prefill_call"]
