"""End-to-end example on PyTorch: train a decoder LM with the port's substrate.

    PYTHONPATH=src python examples/train_lm_torch.py                  # ~15M params, on the card
    PYTHONPATH=src python examples/train_lm_torch.py --large          # ~100M params
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

The twin of ``examples/train_lm.py`` on ``repro_torch``: the synthetic
pipeline with background prefetch, AdamW with compressed (bf16) moments,
async atomic checkpoints with auto-resume, and the BottleMod progress
monitor (straggler events).  Kill it mid-run and run it again: it resumes.
"""

import argparse
import json
import os
import tempfile

from repro_torch.data import DataConfig
from repro_torch.launch.train import preset_100m
from repro_torch.models.common import ModelConfig
from repro_torch.optim import OptConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def small_cfg() -> ModelConfig:
    return ModelConfig(name="dense-15m", family="dense", n_layers=4, d_model=256,
                       n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=8192,
                       head_dim=32, dtype="float32")


ap = argparse.ArgumentParser()
ap.add_argument("--large", action="store_true", help="~100M-parameter preset")
ap.add_argument("--steps", type=int, default=120)
ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
args = ap.parse_args()

cfg = preset_100m() if args.large else small_cfg()
print(f"[example] training {cfg.name}: ~{cfg.n_params() / 1e6:.0f}M params")

trainer = Trainer(
    cfg,
    TrainerConfig(steps=args.steps, ckpt_every=40, log_every=10,
                  ckpt_dir=os.path.join(tempfile.gettempdir(),
                                        f"repro_torch_example_{cfg.name}")),
    opt_cfg=OptConfig(moment_dtype="bfloat16"),   # compressed optimizer state
    data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=8),
    device=args.device,
)
summary = trainer.run()
if summary["losses"]:
    print("[example] loss:", round(summary["loss_first"], 3), "->",
          round(summary["loss_last"], 3))
print("[example] summary:", json.dumps({k: v for k, v in summary.items()
                                        if k != "losses"}, indent=1))
if summary["losses"] and summary["loss_last"] >= summary["loss_first"]:
    raise SystemExit("training must reduce loss")
