"""The paper's Sect. 5 evaluation workflow (Fig. 5).

Five processes: two rate-capped downloads of the same 1.1 GB video from a
shared 100 Mbit/s webserver link, task 1 (ffmpeg reverse — burst consumer),
task 2 (ffmpeg rotate — stream consumer), and task 3 (concat, gated on 1&2).

Constants come straight from Sect. 5.1:
  * input video         1,137,486,559 B
  * net link rate       97.51 Mbit/s  (measured: 1.1 GB in 89 s)
  * task 1 (reverse)    read+decode 26 s, encode+write 82 s, output 80 MB
  * task 2 (rotate)     5 s end-to-end, streaming, output ≈ input size
  * task 3 (concat)     3 s, streaming, starts after 1 & 2 finish

Two BottleMod task-1 calibrations are provided:

* ``recipe='paper'`` — exactly Sect. 5.2: burst data requirement; the whole
  isolated execution time (108 s) spread linearly over the progress.
* ``recipe='refined'`` — beyond-paper: progress spans input+output bytes with
  a two-segment CPU requirement (26 s over the read phase, 82 s over the
  encode phase) and the burst step placed between the phases.  This captures
  the decode/download overlap the simple recipe ignores and demonstrates the
  paper's own point that more accurate requirement functions yield better
  predictions.
"""

from __future__ import annotations


import numpy as np

from repro_torch.core import DataDep, PPoly, Process, ResourceDep, Workflow

# --- Sect. 5.1 constants ----------------------------------------------------
VIDEO_BYTES = 1_137_486_559.0
LINK_BPS = 97.51e6 / 8.0            # net bytes/s of the 100 Mbit/s link
T1_READ_S = 26.0
T1_ENCODE_S = 82.0
T1_TOTAL_CPU_S = T1_READ_S + T1_ENCODE_S   # 108 s isolated execution
T1_OUT_BYTES = 80e6
T2_TOTAL_S = 5.0
T2_OUT_BYTES = VIDEO_BYTES          # metadata-only rotation: content copied
T3_TOTAL_S = 3.0
T3_OUT_BYTES = T1_OUT_BYTES + T2_OUT_BYTES


# ==========================================================================
# BottleMod model (Sect. 5.2)
# ==========================================================================

def build_workflow(frac_task1: float, *, recipe: str = "paper",
                   video_bytes: float = VIDEO_BYTES) -> Workflow:
    """The five-process BottleMod model with ``frac_task1`` of the link rate
    initially assigned to task 1's download (the Fig. 7 sweep parameter)."""
    if not 0.0 < frac_task1 < 1.0:
        raise ValueError("frac_task1 must be in (0, 1)")
    wf = Workflow()

    # -- download processes: one data input (the remote file, fully available),
    #    one resource (the allocated link rate), R_R slope 1 (Sect. 5.2).
    dl1 = Process("dl1",
                  data={"remote": DataDep.stream(video_bytes, video_bytes)},
                  resources={"link": ResourceDep.stream(video_bytes, video_bytes)},
                  total_progress=video_bytes).identity_output()
    wf.add(dl1, resources={"link": PPoly.constant(frac_task1 * LINK_BPS)})
    wf.set_data_input("dl1", "remote", PPoly.constant(video_bytes))

    # dl1 is link-limited throughout, so it finishes at:
    t1_dl_finish = video_bytes / (frac_task1 * LINK_BPS)
    # Sect. 5.2: task 2's download gets the remainder, and the full rate once
    # wget for task 1 terminates (the nft rule is replaced).
    dl2 = Process("dl2",
                  data={"remote": DataDep.stream(video_bytes, video_bytes)},
                  resources={"link": ResourceDep.stream(video_bytes, video_bytes)},
                  total_progress=video_bytes).identity_output()
    wf.add(dl2, resources={"link": PPoly.step([0.0, t1_dl_finish],
                                              [(1.0 - frac_task1) * LINK_BPS, LINK_BPS])})
    wf.set_data_input("dl2", "remote", PPoly.constant(video_bytes))

    # -- task 1 (reverse) ----------------------------------------------------
    if recipe == "paper":
        # burst data requirement; 108 s CPU spread evenly over progress;
        # progress metric = output bytes; O(p) = p  (all exactly Sect. 5.2)
        t1 = Process("task1",
                     data={"video": DataDep.burst(video_bytes, T1_OUT_BYTES)},
                     resources={"cpu": ResourceDep.stream(T1_TOTAL_CPU_S, T1_OUT_BYTES)},
                     total_progress=T1_OUT_BYTES).identity_output()
    elif recipe == "refined":
        # progress = input-bytes-read then output-bytes-written
        p_total = video_bytes + T1_OUT_BYTES
        # data: stream over the read phase; all remaining progress unlocked
        # once the input is complete
        rd = PPoly(np.array([0.0, video_bytes]),
                   [np.array([0.0, 1.0]), np.array([p_total])])
        # cpu: 26 s over the read phase, 82 s over the encode phase
        rr = PPoly(np.array([0.0, video_bytes]),
                   [np.array([0.0, T1_READ_S / video_bytes]),
                    np.array([T1_READ_S, T1_ENCODE_S / T1_OUT_BYTES])])
        out = PPoly(np.array([0.0, video_bytes]),
                    [np.array([0.0]), np.array([0.0, 1.0])])
        t1 = Process("task1", data={"video": DataDep(rd)},
                     resources={"cpu": ResourceDep(rr)}, total_progress=p_total)
        t1.outputs["out"] = out
    else:
        raise ValueError(f"unknown recipe {recipe!r}")
    wf.add(t1, resources={"cpu": PPoly.constant(1.0)})
    wf.connect("dl1", "task1", "video")

    # -- task 2 (rotate): streaming, 5 s CPU over full progress ------------------
    t2 = Process("task2",
                 data={"video": DataDep.stream(video_bytes, T2_OUT_BYTES)},
                 resources={"cpu": ResourceDep.stream(T2_TOTAL_S, T2_OUT_BYTES)},
                 total_progress=T2_OUT_BYTES).identity_output()
    wf.add(t2, resources={"cpu": PPoly.constant(1.0)})
    wf.connect("dl2", "task2", "video")

    # -- task 3 (concat): gated on tasks 1+2; inputs complete at its start ----
    # data requirements: progress p needs p·(share_k) bytes of input k — a
    # proportional interleave, so each R_Dk maps its full input to the TOTAL
    # progress (the min over both then forms the actual ceiling).
    t3 = Process("task3",
                 data={"t1": DataDep.stream(T1_OUT_BYTES, T3_OUT_BYTES),
                       "t2": DataDep.stream(T2_OUT_BYTES, T3_OUT_BYTES)},
                 resources={"cpu": ResourceDep.stream(T3_TOTAL_S, T3_OUT_BYTES)},
                 total_progress=T3_OUT_BYTES).identity_output()
    wf.add(t3, resources={"cpu": PPoly.constant(1.0)}, start_after=["task1", "task2"])
    wf.connect("task1", "task3", "t1")
    wf.connect("task2", "task3", "t2")
    return wf


def predict_makespan(frac_task1: float, *, recipe: str = "paper",
                     video_bytes: float = VIDEO_BYTES) -> float:
    return build_workflow(frac_task1, recipe=recipe, video_bytes=video_bytes).analyze().makespan


def compile_paper_plan(frac_task1: float = 0.5, *, recipe: str = "paper",
                       video_bytes: float = VIDEO_BYTES, device=None):
    """The Sect. 5 workflow as a compile-once analysis plan on ``device``
    (default: the CUDA card).

    The returned :class:`repro_torch.analysis.plan.CompiledWorkflow` serves
    ``solve()``, ``sweep()``, ``whatif()``, ``bottleneck_fn()`` and
    ``gain()`` without re-deriving topo order, curves, or packing per call.
    """
    return build_workflow(frac_task1, recipe=recipe,
                          video_bytes=video_bytes).compile(device=device)


def sweep_scenarios(fracs, *, video_bytes: float = VIDEO_BYTES):
    """The Fig. 7 prioritization sweep as analysis scenarios.

    Each fraction becomes per-scenario link-allocation overrides on a shared
    base workflow (``build_workflow(0.5)``); process definitions stay
    identical across the batch, which is what lets the sweep engine run all
    of them in one batched pass.
    """
    from repro_torch.analysis import scenarios

    out = []
    for f in np.asarray(fracs, dtype=np.float64):
        if not 0.0 < f < 1.0:
            raise ValueError("frac_task1 must be in (0, 1)")
        t1_dl_finish = video_bytes / (f * LINK_BPS)
        out.append(scenarios.override(
            label=f"frac={f:.4f}",
            resources={
                ("dl1", "link"): PPoly.constant(f * LINK_BPS),
                ("dl2", "link"): PPoly.step([0.0, t1_dl_finish],
                                            [(1.0 - f) * LINK_BPS, LINK_BPS]),
            }))
    return out
