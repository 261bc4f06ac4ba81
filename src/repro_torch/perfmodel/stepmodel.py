"""BottleMod step model — the paper's technique applied to a training step.

Every dry-run cell yields three roofline resource demands per training step
(FLOPs, HBM bytes, collective bytes).  This module turns them into a
BottleMod *workflow* (paper Sect. 3.4):

    host data pipeline ──▶ train-step process ──▶ async checkpoint writer

* the **data process** produces batches at the host pipeline rate (its
  "resource" is host CPU seconds, exactly like the paper's download
  processes use link bytes);
* the **step process** consumes one batch of data per step (stream data
  requirement) and three resources — tensor-core FLOPs, HBM bytes and
  collective bytes — whose requirement functions are linear with the
  per-step demands and whose input functions are the hardware rates (an
  H100's, :mod:`.roofline`, unless the inputs name others).  BottleMod's
  min-rule (eq. 9) *is* the roofline max, but time-structured: warmup,
  stalls and input starvation appear as bottleneck segments;
* the **checkpoint process** consumes step outputs every ``ckpt_every``
  steps and is rate-limited by storage bandwidth — if it can't keep up,
  BottleMod shows checkpointing as the binding resource.

The reference's ``perfmodel/stepmodel.py`` over the port's numpy ``core``;
the resource names stay the reference's ("mxu_flops", "hbm_bytes",
"ici_bytes") so that reports read the same in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import DataDep, PPoly, Process, ResourceDep, Workflow
from ..core.bottleneck import bottleneck_report, potential_gains
from .roofline import HBM_BW, LINK_BW, PEAK_FLOPS

__all__ = ["StepModelInputs", "StepPrediction", "build_step_workflow",
           "from_dryrun_record", "predict"]


@dataclass(frozen=True)
class StepModelInputs:
    flops_per_step: float            # per device
    hbm_bytes_per_step: float        # per device
    coll_bytes_per_step: float       # per device
    n_steps: int = 100
    data_rate_steps_per_s: float = 10.0   # host pipeline throughput
    data_buffer_steps: float = 2.0        # prefetch depth
    ckpt_every: int = 0                   # 0 = no checkpointing
    ckpt_bytes: float = 0.0               # per checkpoint (per host)
    ckpt_bw: float = 2e9                  # bytes/s to stable storage
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    ici_bw: float = LINK_BW


def build_step_workflow(m: StepModelInputs) -> Workflow:
    wf = Workflow()
    n = float(m.n_steps)

    # -- host data pipeline: produces `n` batches, rate-limited --------------
    data = Process("data_pipeline",
                   data={"dataset": DataDep.stream(n, n)},
                   resources={"host_cpu": ResourceDep.stream(n / m.data_rate_steps_per_s, n)},
                   total_progress=n).identity_output()
    wf.add(data, resources={"host_cpu": PPoly.constant(1.0)})
    # the dataset is fully available from the start
    wf.set_data_input("data_pipeline", "dataset", PPoly.constant(n))

    # -- device step process ----------------------------------------------------
    step = Process(
        "train_step",
        data={"batches": DataDep.stream(n, n)},
        resources={
            "mxu_flops": ResourceDep.stream(m.flops_per_step * n, n),
            "hbm_bytes": ResourceDep.stream(m.hbm_bytes_per_step * n, n),
            "ici_bytes": ResourceDep.stream(m.coll_bytes_per_step * n, n),
        },
        total_progress=n).identity_output()
    wf.add(step, resources={
        "mxu_flops": PPoly.constant(m.peak_flops),
        "hbm_bytes": PPoly.constant(m.hbm_bw),
        "ici_bytes": PPoly.constant(m.ici_bw),
    })
    wf.connect("data_pipeline", "train_step", "batches")

    # -- checkpoint writer -------------------------------------------------------
    if m.ckpt_every and m.ckpt_bytes > 0:
        n_ckpt = int(np.floor(m.n_steps / m.ckpt_every))
        if n_ckpt >= 1:
            total = n_ckpt * m.ckpt_bytes
            # progress metric = bytes written; each completed multiple of
            # ``ckpt_every`` steps unlocks one more checkpoint's bytes
            xs = [0.0] + [float(i * m.ckpt_every) for i in range(1, n_ckpt + 1)]
            ys = [0.0] + [float(i * m.ckpt_bytes) for i in range(1, n_ckpt + 1)]
            ck = Process(
                "checkpoint",
                data={"steps": DataDep(PPoly.step(xs, ys))},
                resources={"storage_bw": ResourceDep.stream(total / m.ckpt_bw, total)},
                total_progress=total).identity_output()
            wf.add(ck, resources={"storage_bw": PPoly.constant(1.0)})
            wf.connect("train_step", "checkpoint", "steps")
    return wf


@dataclass
class StepPrediction:
    makespan_s: float
    step_time_s: float
    bottleneck_shares: list
    gains: list
    workflow: Workflow

    def dominant(self) -> str:
        for b in self.bottleneck_shares:
            if b.process == "train_step":
                return b.name
        return "unknown"


def predict(m: StepModelInputs) -> StepPrediction:
    wf = build_step_workflow(m)
    res = wf.analyze()
    fin = res.finish("train_step")
    gains = potential_gains(wf, res, factor=2.0)
    return StepPrediction(
        makespan_s=res.makespan,
        step_time_s=fin / m.n_steps,
        bottleneck_shares=list(bottleneck_report(res)),
        gains=gains,
        workflow=wf,
    )


def from_dryrun_record(rec: dict, **overrides) -> StepModelInputs:
    """Step-model inputs straight from a dry-run JSON record."""
    per_dev = rec["per_device"]
    kw = dict(
        flops_per_step=per_dev["flops"],
        hbm_bytes_per_step=per_dev["bytes"],
        coll_bytes_per_step=per_dev["collective_bytes"],
    )
    kw.update(overrides)
    return StepModelInputs(**kw)
