"""decode.kv_useful: the cache positions that hold a token over those the
decode attention reads, summed over the traced steps' ``attn`` spans
(the ``kv_valid`` and ``kv_read`` counts ``attn_decode`` gives them from
the positions it hands its core), in percent. A decode core
that read only valid positions would read 100. Reads
``repro_torch.runtime.spans`` for the last ``len(traced_positions)``
``decode_step`` roots only; silent where the program has no spans or the
slice recorded none."""


def _records(n: int, root: str) -> list:
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return []
    return spans.finished(n, root)


def read(ctx):
    n = len(ctx.layer.get("traced_positions") or ())
    attn = [r for r in (_records(n, "decode_step") if n else []) if r.name == "attn"]
    read_ = sum(r.counts["kv_read"] for r in attn)
    if not read_:
        return None
    return 100.0 * sum(r.counts["kv_valid"] for r in attn) / read_
