"""Serving launcher: batched prefill + decode with a shared KV/state cache.

``python -m repro_torch.launch.serve --arch rwkv6-1.6b --no-smoke``

A miniature serving loop: a batch of requests is prefilled token by token
through the cached decode path (the KV cache of the attention families, the
token-shift and wkv state of RWKV-6, the conv window and ssm state of
Mamba), then decoded greedily, one token a
step.  The BottleMod progress monitor times the decode steps.  Runs on the
CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config, list_archs
from ..device import resolve_device
from ..models import transformer as T
from ..models.common import init_params
from ..runtime.monitor import ProgressMonitor


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list_archs(), default="rwkv6-1.6b",
                    help="model (default rwkv6-1.6b)")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="use the smoke config (default); --no-smoke loads "
                         "the full architecture config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None, *, params: T.DecoderLM | None = None) -> dict:
    """Run the loop; returns what it printed as a dict, plus the prompts,
    the continuations and the logits after the last prompt token.

    ``params``: a model to serve instead of ``init_params(cfg, seed=0)``,
    of the chosen architecture; its own config is served, so a model cut
    in depth (``dataclasses.replace(cfg, n_layers=...)``) serves at its
    depth.
    """
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if params is not None:
        if params.cfg.name != cfg.name:
            raise ValueError(f"params are a {params.cfg.name} model, not "
                             f"{cfg.name}")
        cfg = params.cfg
    if cfg.frontend == "audio":
        raise SystemExit("serve demo uses token models; pick a non-audio arch")
    model = params if params is not None else T.DecoderLM(cfg, init_params(cfg, 0, dev))
    B = args.requests
    ctx = args.prompt_len + args.gen_len

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(B, args.prompt_len)).astype(np.int32)
    toks = torch.as_tensor(prompts, device=dev)

    with torch.inference_mode():
        cache = T.init_cache(cfg, B, ctx, dev)
        mon = ProgressMonitor().start()
        _sync(dev)
        t0 = time.perf_counter()
        # prefill via repeated decode (the cache-building path)
        logits = None
        for t in range(args.prompt_len):
            logits, cache = T.decode_step(model, cfg, cache, {"tokens": toks[:, t:t + 1]}, t)
        prompt_logits = logits.float().cpu()
        generated = []
        for t in range(args.prompt_len, ctx):
            tok = torch.argmax(logits, dim=-1)[:, None]
            generated.append(tok.cpu().numpy())
            logits, cache = T.decode_step(model, cfg, cache, {"tokens": tok}, t)
            mon.record_step(t)
        _sync(dev)
        wall = time.perf_counter() - t0
    gen = np.concatenate(generated, axis=1)
    tok_s = B * gen.shape[1] / wall
    step_ms = float(np.median(mon.durations)) * 1e3
    sample = gen[0][:12].tolist()
    print(f"[serve] {B} requests, prompt {args.prompt_len}, generated {gen.shape[1]} tokens each")
    print(f"[serve] wall {wall:.2f}s, {tok_s:.1f} tok/s, median decode step {step_ms:.1f} ms")
    print(f"[serve] sample continuation: {sample}")
    return {"arch": cfg.name, "device": str(dev), "requests": B,
            "prompt_len": args.prompt_len, "generated": gen.shape[1],
            "wall_s": wall, "tok_s": tok_s, "median_step_ms": step_ms,
            "sample": sample, "prompts": prompts, "continuations": gen,
            "prompt_logits": prompt_logits}


if __name__ == "__main__":
    main()
