"""The port's analysis service (``repro_torch.analysis.serve``) against
``repro``'s, on the CPU: the twin of ``tests/test_analysis_service.py``.

Contracts under test:

* >= 16 concurrent what-if requests queued on a paused service coalesce
  into ONE fused sweep; every client's rows equal the port's own sequential
  ``plan.sweep`` bit for bit, and ``repro``'s service at the
  ``tests/test_sweep.py::_assert_match`` bars (makespans and finish times
  rtol 1e-5, shares rtol 1e-4), on the same numpy-seeded scenarios,
* a coalesced client's Report answers its curve queries as ``plan.sweep``'s
  Report does for the same rows, bit for bit,
* the plan cache returns the SAME plan for identical workflows, and plans
  of structurally identical workflows share one engine; fingerprints and
  level signatures equal the reference's,
* ``OnlineReanalysis.ingest`` matches a fresh ``plan.prepare`` of the edited
  scenario list, including monitoring-shaped deltas,
* a poisoned query fails only its own future; a 24-thread load smoke
  resolves every future correctly; ``submit_optimize`` is a local
  ``plan.optimize``, bit for bit.

Every service runs on ``device="cpu"`` and closes in a ``with`` block or a
``finally``; every ``result()`` is bounded.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import pytest

from repro.analysis import AnalysisService as RefService
from repro.analysis.serve import workflow_fingerprint as ref_fingerprint
from repro.configs import paper_workflow as ref_paper
from repro_torch.analysis import (AnalysisService, OnlineReanalysis,
                                  scenarios)
from repro_torch.analysis.serve import workflow_fingerprint
from repro_torch.configs.paper_workflow import build_workflow, sweep_scenarios
from repro_torch.core import DataDep, PPoly, Process, ResourceDep, Workflow

from test_sweep import _assert_match

T = 120  # per-future timeout, as in the reference's suites
CPU = "cpu"


def _fracs(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.05, 0.95, n)


@pytest.fixture(scope="module")
def plan():
    return build_workflow(0.5).compile(device=CPU)


@pytest.fixture(scope="module")
def ref_plan():
    return ref_paper.build_workflow(0.5).compile()


def _small_workflow(link_rate: float = 10.0) -> Workflow:
    n = 1000.0
    wf = Workflow()
    wf.add(Process("dl", data={"file": DataDep.stream(n, n)},
                   resources={"link": ResourceDep.stream(n, n)},
                   total_progress=n).identity_output(),
           resources={"link": PPoly.constant(link_rate)})
    wf.set_data_input("dl", "file", PPoly.constant(n))
    return wf


def _same_rows(rep, seq):
    assert rep.labels == seq.labels and rep.factors == seq.factors
    np.testing.assert_array_equal(rep.makespans, seq.makespans)
    for n in rep.order:
        np.testing.assert_array_equal(rep.finish[n], seq.finish[n])
    np.testing.assert_array_equal(rep.share_seconds, seq.share_seconds)


def _serve_paused(svc, plan, requests):
    futs = [svc.submit(scs, plan=plan) for scs in requests]
    svc.start()
    return [f.result(timeout=T) for f in futs]


# ------------------------------------------------------------- coalescing --
def test_coalesces_16_requests_into_one_fused_sweep(plan, ref_plan):
    fracs = _fracs(18, seed=1)
    with AnalysisService(autostart=False, device=CPU) as svc:
        reps = _serve_paused(svc, plan, [[sc] for sc in sweep_scenarios(fracs)])
        snap = svc.snapshot()
    assert snap["sweeps"] == 1, snap
    assert snap["coalesced_batches"] == 1
    assert snap["max_coalesced"] == 18 >= 16
    assert snap["max_batch_B"] == 18
    with RefService(autostart=False) as ref_svc:
        refs = _serve_paused(ref_svc, ref_plan,
                             [[sc] for sc in ref_paper.sweep_scenarios(fracs)])
    for sc, rep, ref in zip(sweep_scenarios(fracs), reps, refs):
        assert rep.B == 1 and rep.backends == ["torch"]
        _same_rows(rep, plan.sweep(plan.prepare([sc])))
        _assert_match(rep, ref)


def test_multi_scenario_requests_slice_correctly(plan, ref_plan):
    """Each client gets exactly its rows — and its rows of the engine
    results, so its curve queries equal ``plan.sweep``'s rows bit for bit."""
    fr = _fracs(6, seed=2)
    groups = [fr[:2], fr[2:3], fr[3:]]
    with AnalysisService(autostart=False, device=CPU) as svc:
        reps = _serve_paused(svc, plan, [sweep_scenarios(g) for g in groups])
        assert svc.snapshot()["sweeps"] == 1
    with RefService(autostart=False) as ref_svc:
        refs = _serve_paused(ref_svc, ref_plan,
                             [ref_paper.sweep_scenarios(g) for g in groups])
    assert [r.B for r in reps] == [2, 1, 3]
    full = plan.sweep(plan.prepare(sweep_scenarios(fr)))
    ts = np.linspace(0.0, 400.0, 33)
    lo = 0
    for rep, ref in zip(reps, refs):
        rows = list(range(lo, lo + rep.B))
        _same_rows(rep, full.subset(rows))
        _assert_match(rep, ref)
        for pn in ("dl1", "task3"):
            np.testing.assert_array_equal(rep.sample_progress(pn, ts),
                                          full.sample_progress(pn, ts)[rows])
            np.testing.assert_array_equal(rep.kernel_finish_times(pn),
                                          full.kernel_finish_times(pn)[rows])
        vals, arg = rep.data_ceiling("task3", ts)
        fvals, farg = full.data_ceiling("task3", ts)
        np.testing.assert_array_equal(vals, fvals[rows])
        np.testing.assert_array_equal(arg, farg[rows])
        lo += rep.B


def test_poisoned_request_fails_alone(plan):
    good = sweep_scenarios([0.4])
    bad = [scenarios.ScenarioSpec(label="ghost",
                                  resources={("ghost", "cpu"): 2.0})]
    with AnalysisService(autostart=False, device=CPU) as svc:
        f_good = svc.submit(good, plan=plan)
        f_bad = svc.submit(bad, plan=plan)
        svc.start()
        rep = f_good.result(timeout=T)
        with pytest.raises(ValueError):
            f_bad.result(timeout=T)
        snap = svc.snapshot()
    _same_rows(rep, plan.sweep(plan.prepare(good)))
    assert snap["solo_retries"] == 2


# -------------------------------------------------------------- plan cache --
def test_plan_cache_hit_on_identical_workflows():
    with AnalysisService(autostart=False, device=CPU) as svc:
        p1 = svc.compile(build_workflow(0.5))
        p2 = svc.compile(build_workflow(0.5))
        snap = svc.snapshot()
    assert p1 is p2 and p1.device.type == "cpu"
    assert snap["plan_hits"] == 1 and snap["plan_misses"] == 1
    assert workflow_fingerprint(build_workflow(0.5)) == \
        workflow_fingerprint(build_workflow(0.5))
    assert workflow_fingerprint(build_workflow(0.5)) != \
        workflow_fingerprint(build_workflow(0.7))
    # the same workflow has the same fingerprint in both packages
    assert workflow_fingerprint(build_workflow(0.7)) == \
        ref_fingerprint(ref_paper.build_workflow(0.7))


def test_structurally_identical_plans_share_one_engine(ref_plan):
    """Different base inputs, same level signature -> ONE engine, whose
    proven caps the second plan's sweeps reuse."""
    with AnalysisService(autostart=False, device=CPU) as svc:
        p1 = svc.compile(build_workflow(0.5))
        p3 = svc.compile(build_workflow(0.7))
        svc.start()
        assert p3 is not p1
        assert p1.level_signature == p3.level_signature
        assert p1.level_signature == ref_plan.level_signature
        assert p3._torch_engine is p1._torch_engine
        assert svc.snapshot()["trace_hits"] == 1
        svc.query(sweep_scenarios([0.3]), plan=p1, timeout=T)
        caps = p1._torch_engine.proven_caps_rows()
        assert caps, "a sweep should have proven an iteration cap"
        r = svc.query(sweep_scenarios([0.3]), plan=p3, timeout=T)
        assert p3._torch_engine.proven_caps_rows() == caps
    _same_rows(r, p3.sweep(p3.prepare(sweep_scenarios([0.3]))))


def test_level_signature_differs_for_different_structure():
    p_small = _small_workflow().compile(device=CPU)
    p_paper = build_workflow(0.5).compile(device=CPU)
    assert p_small.level_signature != p_paper.level_signature
    assert p_small.level_signature is p_small.level_signature  # cached


# -------------------------------------------------------- online re-analysis --
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_online_reanalysis_matches_fresh_prepare(plan, backend):
    fr = _fracs(3, seed=3)

    def edited():
        out = []
        for spec in sweep_scenarios(fr):
            sc = spec.resolve(plan.workflow)
            sc.resource_inputs[("dl1", "link")] = \
                plan.base_res[("dl1", "link")] * 0.7
            sc.resource_inputs[("task1", "cpu")] = \
                plan.base_res[("task1", "cpu")] * 1.5
            out.append(sc)
        return out

    live = OnlineReanalysis(plan, sweep_scenarios(fr), backend=backend)
    r = live.ingest({"dl1.link": 0.7, ("task1", "cpu"): 1.5})
    ref = plan.sweep(plan.prepare(edited()), backend=backend)
    np.testing.assert_array_equal(r.makespans, ref.makespans)
    np.testing.assert_array_equal(r.share_seconds, ref.share_seconds)
    assert live.updates == 1
    # second delta re-packs from the SAME pack, still against base inputs
    r2 = live.ingest({"dl1.link": 0.7})
    assert live.updates == 2
    np.testing.assert_array_equal(
        r2.makespans, plan.sweep(plan.prepare(edited()),
                                 backend=backend).makespans)


def test_online_reanalysis_ingests_monitoring_shapes(plan):
    from repro_torch.runtime.monitor import ProgressMonitor

    mon = ProgressMonitor()
    assert mon.record_step(0) is None  # auto-start (no start() call)
    mon.record_step(1)
    mon.record_step(2)
    measured = mon.measured_progress()
    assert measured.is_piecewise_linear

    live = OnlineReanalysis(plan, sweep_scenarios([0.5]), backend="numpy")
    # measured input-rate delta as a 0-d numpy scalar (np.isscalar is False!)
    r_nd = live.ingest({"dl1.link": np.array(0.7)})
    ref = OnlineReanalysis(plan, sweep_scenarios([0.5]), backend="numpy") \
        .ingest({"dl1.link": 0.7})
    np.testing.assert_array_equal(r_nd.makespans, ref.makespans)
    scaled = PPoly(measured.starts,
                   measured.coeffs * plan.base_data[("dl1", "remote")](1e9))
    r_fn = live.ingest({"dl1.remote": scaled})
    assert np.isfinite(r_fn.makespans).all()


def test_service_track_runs_on_worker(plan):
    with AnalysisService(device=CPU) as svc:
        live = svc.track(sweep_scenarios([0.5]), plan=plan)
        r0 = live.refresh()
        r1 = live.ingest({"dl1.link": np.float64(0.5)})
        snap = svc.snapshot()
    assert float(r1.makespans[0]) > float(r0.makespans[0])
    assert snap["sweeps"] >= 2
    assert r1.backends == ["torch"]


# ------------------------------------------------------------- load smoke --
def test_concurrent_load_smoke():
    """24 client threads hammer one service; all futures resolve with
    correct makespans, every thread is joined, the queue drains clean."""
    plan = _small_workflow().compile(device=CPU)
    rates = [2.0, 4.0, 5.0, 8.0, 10.0, 40.0]
    expect = {r: 1000.0 / r for r in rates}
    n_threads, per_thread = 24, 3
    results: dict[tuple[int, int], tuple[float, float]] = {}
    errors: list[BaseException] = []
    barrier = threading.Barrier(n_threads)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with AnalysisService(plan, device=CPU) as svc:
            def client(ci: int) -> None:
                try:
                    barrier.wait(timeout=T)
                    for qi in range(per_thread):
                        rate = rates[(ci + qi) % len(rates)]
                        sc = scenarios.override(
                            {"dl.link": PPoly.constant(rate)},
                            label=f"c{ci}q{qi}")
                        rep = svc.query([sc], timeout=T)
                        results[(ci, qi)] = (rate, float(rep.makespans[0]))
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=2 * T)
            snap = svc.snapshot()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(results) == n_threads * per_thread
    for (rate, ms) in results.values():
        assert ms == pytest.approx(expect[rate], rel=1e-9)
    assert snap["requests"] == n_threads * per_thread
    assert snap["sweeps"] <= snap["requests"]


def test_submit_validation(plan):
    svc = AnalysisService(autostart=False, max_batch=4, device=CPU)
    try:
        with pytest.raises(ValueError, match="at least one"):
            svc.submit([], plan=plan)
        with pytest.raises(ValueError, match="max_batch"):
            svc.submit(sweep_scenarios(np.linspace(0.1, 0.9, 5)), plan=plan)
        with pytest.raises(ValueError, match="no plan"):
            svc.submit(sweep_scenarios([0.5]))
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(sweep_scenarios([0.5]), plan=plan)


def test_service_with_default_workflow_and_context_manager():
    with AnalysisService(_small_workflow(), device=CPU) as svc:
        rep = svc.query([scenarios.override(
            {"dl.link": PPoly.constant(20.0)}, label="2x")], timeout=T)
        assert svc._default_plan.device.type == "cpu"
    assert float(rep.makespans[0]) == pytest.approx(50.0, rel=1e-9)
    assert rep.labels == ["2x"]


# ------------------------------------------------------------ optimize path --
def test_submit_optimize_identical_to_local(plan):
    """The twin of ``tests/test_optimize.py``'s service case: a search
    through the worker is the local ``plan.optimize``, bit for bit."""
    from repro_torch.analysis import cap_space

    space = cap_space(["task1.cpu"], lo=0.5, hi=2.0)
    local = plan.optimize(space=space, max_iters=2)
    with AnalysisService(plan, device=CPU) as svc:
        served = svc.query_optimize(space=space, max_iters=2, timeout=T)
    np.testing.assert_array_equal(served.theta, local.theta)
    assert served.value == local.value
    assert served.evals == local.evals and served.sweeps == local.sweeps
    np.testing.assert_array_equal(served.trajectory, local.trajectory)
