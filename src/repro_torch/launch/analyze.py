"""Analysis-service launcher — BottleMod's front door as a server.

``python -m repro_torch.launch.analyze --clients 32 --queries 4``

Starts an :class:`~repro_torch.analysis.serve.AnalysisService` on the paper
workflow, on the CUDA card unless ``--device cpu`` is given, and drives it
three ways:

1. **Concurrent what-if load**: N client threads each fire Q queries
   (resource prioritizations + ramped links); the service coalesces
   whatever is queued into one fused sweep per drain.  Prints p50/p99
   request latency, requests/s, and the coalescing counters.
2. **Online re-analysis**: a simulated live run where the download link
   degrades mid-flight; measured step timings flow through a
   :class:`~repro_torch.runtime.monitor.ProgressMonitor` and the measured
   rate is ingested as a ``ScenarioPack.override`` delta — the predicted
   makespan tracks the degradation without re-preparing anything.
3. **Distribution query** (``--mc``): the degrading-link scenario re-run as
   a Monte Carlo question through ``OnlineReanalysis.mc`` — "given the link
   we are *measuring*, what is the p95 makespan and what dominates it?" —
   with the sampled draws batched through the same coalescing service.

``main`` returns the printed numbers as a dict.
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from concurrent.futures import CancelledError

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=32,
                    help="concurrent client threads")
    ap.add_argument("--queries", type=int, default=4,
                    help="queries per client")
    ap.add_argument("--linger-ms", type=float, default=0.0,
                    help="coalescing window the worker waits per drain")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "torch", "numpy"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--online-steps", type=int, default=6,
                    help="monitoring updates in the online re-analysis demo")
    ap.add_argument("--mc", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the Monte Carlo distribution-query phase")
    ap.add_argument("--mc-draws", type=int, default=2048,
                    help="Monte Carlo draws in the --mc phase")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="artifact-store directory: compiled plans persist "
                         "as durable artifacts and warm-start the plan "
                         "cache on the next launch (see "
                         "repro_torch.analysis.artifacts)")
    return ap


def _load_phase(svc, plan, clients: int, queries: int) -> dict:
    from repro_torch.analysis import ramp_resource, scale_resource

    rng = np.random.default_rng(0)
    latencies: list[float] = []
    lat_lock = threading.Lock()
    barrier = threading.Barrier(clients)

    def client(ci: int) -> None:
        barrier.wait()
        for qi in range(queries):
            if (ci + qi) % 3:
                scs = scale_resource("task1", "cpu",
                                     [float(rng.uniform(0.5, 4.0))])
            else:  # monitoring-shaped ramp: pw-linear link rate
                scs = [ramp_resource("dl2", "link", [0.0, 200.0],
                                     [4e6 * rng.uniform(0.3, 1.0), 0.5e6])]
            t0 = time.perf_counter()
            try:
                svc.query(scs, plan=plan, timeout=600)
            except (CancelledError, RuntimeError):
                return  # service shut down under us (Ctrl-C): stop quietly
            with lat_lock:
                latencies.append(time.perf_counter() - t0)

    svc.query(scale_resource("task1", "cpu", [1.0]), plan=plan)  # warm-up
    t0 = time.perf_counter()
    # daemon threads: a Ctrl-C shutdown must not hang the interpreter on
    # clients still blocked in result() — close(drain=False) cancels their
    # futures and daemonization covers any straggler at teardown
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    lat = np.sort(latencies)
    snap = svc.snapshot()
    out = {"clients": clients, "queries": queries, "served": len(lat),
           "wall_s": wall, "requests_per_s": len(lat) / wall,
           "latency_p50_s": float(np.quantile(lat, 0.5)),
           "latency_p99_s": float(np.quantile(lat, 0.99)),
           "sweeps": snap["sweeps"],
           "coalesced_batches": snap["coalesced_batches"],
           "max_coalesced": snap["max_coalesced"]}
    print(f"[analyze] load: {clients} clients x {queries} queries in "
          f"{wall:.2f}s -> {out['requests_per_s']:.0f} req/s")
    print(f"[analyze]   latency p50={out['latency_p50_s'] * 1e3:.1f}ms "
          f"p99={out['latency_p99_s'] * 1e3:.1f}ms  "
          f"sweeps={snap['sweeps']} coalesced_batches="
          f"{snap['coalesced_batches']} max_coalesced={snap['max_coalesced']}")
    return out


def _online_phase(svc, plan, steps: int):
    from repro_torch.configs.paper_workflow import sweep_scenarios
    from repro_torch.runtime.monitor import ProgressMonitor

    live = svc.track(sweep_scenarios([0.5]), plan=plan)
    base = live.refresh()
    print(f"[analyze] online: base predicted makespan "
          f"{float(base.makespans[0]):.1f}s")
    mon = ProgressMonitor(predicted_step_s=0.002)
    makespans = [float(base.makespans[0])]
    for k in range(steps):
        # simulated live run: each "step" is one monitoring tick; the link
        # degrades over time, so measured steps take longer than predicted
        time.sleep(0.002 * (1 + k))
        mon.record_step(k)  # first record auto-starts the clock
        measured_rate = (mon.predicted_step_s
                         / max(mon.durations[-1], mon.predicted_step_s)
                         if mon.durations else 1.0)
        rep = live.ingest({"dl1.link": np.float64(measured_rate)})
        makespans.append(float(rep.makespans[0]))
        print(f"[analyze]   tick {k}: measured rate {measured_rate:.2f}x -> "
              f"makespan {float(rep.makespans[0]):.1f}s "
              f"(progress fn: {mon.measured_progress().n_pieces} pieces)")
    print(f"[analyze] online: {live.updates} re-analyses, all delta "
          "re-packs of one prepared pack")
    return live, {"updates": live.updates, "makespans": makespans}


def _mc_phase(live, draws: int) -> dict:
    from repro_torch.analysis import dist, scenarios

    # The degrading-link state is inherited from the tracked scenario (the
    # last ingested measurement); the distribution query asks what the
    # remaining uncertainty does to the makespan on top of it.
    spec = scenarios.override(
        label="live-mc",
        resources={("task1", "cpu"): dist.lognormal(sigma=0.2),
                   ("task2", "cpu"): dist.uniform(0.7, 1.3),
                   ("dl2", "link"): dist.lognormal(sigma=0.15)},
    )
    t0 = time.perf_counter()
    mc = live.mc(spec, n=draws, seed=0)
    wall = time.perf_counter() - t0
    top = mc.attribution()[0]
    sens = mc.sensitivity()[0]
    print(f"[analyze] mc: {draws} draws on the measured-link state in "
          f"{wall:.2f}s ({wall / draws * 1e6:.0f}us/draw, "
          f"{mc.fallback_count} fallbacks)")
    print(f"[analyze]   makespan p50={mc.p50:.1f}s p95={mc.p95:.1f}s "
          f"p99={mc.p99:.1f}s  P(makespan <= {mc.p50 * 1.2:.0f}s)="
          f"{mc.prob(makespan_le=mc.p50 * 1.2):.2f}")
    print(f"[analyze]   dominant bottleneck: {top.label} "
          f"(p={top.p_dominant:.2f}); most sensitive factor: "
          f"{sens.axis} (s1={sens.s1:.2f}, rho={sens.rho:+.2f})")
    return {"draws": draws, "wall_s": wall, "quantiles": mc.quantiles(),
            "fallbacks": mc.fallback_count, "dominant": top.label}


def main(argv: list[str] | None = None) -> dict:
    from repro_torch.analysis import AnalysisService
    from repro_torch.configs.paper_workflow import build_workflow

    args = build_parser().parse_args(argv)
    svc = AnalysisService(backend=args.backend, linger_s=args.linger_ms / 1e3,
                          store=args.store, device=args.device)
    out: dict = {"device": str(svc.device)}
    try:
        plan = svc.compile(build_workflow(0.5))
        out["load"] = _load_phase(svc, plan, args.clients, args.queries)
        live, out["online"] = _online_phase(svc, plan, args.online_steps)
        if args.mc:
            out["mc"] = _mc_phase(live, args.mc_draws)
        snap = svc.snapshot()
        print(f"[analyze] totals: requests={snap['requests']} "
              f"scenarios={snap['scenarios']} sweeps={snap['sweeps']} "
              f"plan_cache={snap['plan_hits']}h/{snap['plan_misses']}m")
        print(f"[analyze] durability: warm_plans={snap['warm_plans']} "
              f"warm_hits={snap['warm_hits']} "
              f"cold_traces={snap['cold_traces']} "
              f"artifacts_written={snap['artifacts_written']} "
              f"artifact_errors={snap['artifact_errors']}")
        out["snapshot"] = snap
    except KeyboardInterrupt:
        # graceful shutdown: cancel everything queued (clients see their
        # futures cancelled and stop), print what was served, exit 130 —
        # never hang on threads still waiting for results
        snap = svc.snapshot()
        print(f"\n[analyze] interrupted — cancelled the pending queue "
              f"(served so far: requests={snap['requests']} "
              f"sweeps={snap['sweeps']} restarts={snap['restarts']})",
              file=sys.stderr)
        svc.close(drain=False)
        sys.exit(130)
    finally:
        svc.close()  # idempotent: no-op after the interrupt path
    return out


if __name__ == "__main__":
    main()
