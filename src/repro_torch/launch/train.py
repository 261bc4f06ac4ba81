"""Training launcher: ``python -m repro_torch.launch.train [--arch <id>] [--smoke]``.

Runs the fault-tolerant trainer (auto-resume, async checkpoints, straggler
monitor) on the CUDA card unless ``--device cpu`` is given.  The default
``--arch 100m`` trains a ~100M-parameter dense model in float32; ``--smoke``
uses an architecture's reduced config.  Kill it and run it again with the
same ``--ckpt-dir``: it resumes.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from ..configs import get_config, get_smoke_config, list_archs
from ..models.common import ModelConfig
from ..optim import OptConfig
from ..runtime.trainer import Trainer, TrainerConfig, data_config_for


def preset_100m() -> ModelConfig:
    """~100M-parameter llama-style dense model (the e2e example target)."""
    return ModelConfig(
        name="dense-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32000, head_dim=64,
        dtype="float32",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list_archs() + ["100m"], default="100m")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_train "
                         "under the temporary directory)")
    ap.add_argument("--moment-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Train; prints the summary and returns it (with the losses)."""
    args = build_parser().parse_args(argv)
    if args.arch == "100m":
        cfg = preset_100m()
    else:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_train")
    tr = Trainer(cfg,
                 TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                               ckpt_dir=ckpt_dir),
                 opt_cfg=OptConfig(moment_dtype=args.moment_dtype),
                 data_cfg=data_config_for(cfg, args.seq, args.batch),
                 device=args.device)
    summary = tr.run()
    nice = {k: v for k, v in summary.items() if k != "losses"}
    print("[train] summary:", json.dumps(nice, indent=1))
    return {"arch": cfg.name, "device": str(tr.device), **summary}


if __name__ == "__main__":
    main()
