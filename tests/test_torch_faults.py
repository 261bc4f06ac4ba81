"""The port's chaos suite on the CPU: the twin of
``tests/test_fault_tolerance.py``.

Every ``FaultPlan`` mode must end in a typed error or a numpy-degraded
Report — never a stranded future:

* **kill-worker**: in-flight futures fail with ``ServiceCrashed`` carrying
  the injected cause, the supervisor restarts, a resubmit round-trips bit
  for bit to a fresh service,
* **fail-Nth-sweep**: absorbed by the seeded backoff retry,
* **NaN injection**: poisoned rows re-run on the numpy twin (``backends ==
  "degraded"``) with ONE aggregated warning; ``repro``'s service under the
  same plan degrades the same rows to the same answers (``_assert_match``),
* **delay past deadline**: ``DeadlineExceeded`` before packing,
* **malformed override**: fails alone with the client-input error type,
* **backpressure**: ``Overloaded`` sheds the newest request,
* **close/crash races**: aggregate ``submit_mc`` futures always resolve;
  ``submit_mc`` equals ``plan.mc`` bit for bit.

Every service runs on ``device="cpu"`` and closes in a ``finally`` or a
``with`` block; every ``result()`` is bounded by ``T``.
"""

from __future__ import annotations

import warnings
from concurrent.futures import CancelledError

import numpy as np
import pytest

from repro.analysis import AnalysisService as RefService
from repro.analysis import FaultPlan as RefFaultPlan
from repro.configs import paper_workflow as ref_paper
from repro_torch.analysis import (AnalysisService, DeadlineExceeded, FaultPlan,
                                  Overloaded, ServiceClosed, ServiceCrashed,
                                  dist)
from repro_torch.analysis.faults import FaultInjected
from repro_torch.configs.paper_workflow import build_workflow, sweep_scenarios

from test_sweep import _assert_match

T = 120  # per-future timeout: generous for CI, fatal for a stranded future
CPU = "cpu"
FRACS = np.random.default_rng(8).uniform(0.1, 0.9, 4)


@pytest.fixture(scope="module")
def plan():
    return build_workflow(0.5).compile(device=CPU)


@pytest.fixture(scope="module")
def ref(plan):
    """The port's clean numpy-twin answer for the standard scenario set."""
    return plan.sweep(plan.prepare(_scenarios()), backend="numpy")


def _scenarios():
    return sweep_scenarios(FRACS)


def _service(**kw):
    return AnalysisService(device=CPU, **kw)


# ------------------------------------------------------------ supervision --
def test_kill_worker_fails_typed_and_recovers(plan, ref):
    svc = _service(autostart=False, faults=FaultPlan(kill_worker_at=1))
    try:
        doomed = svc.submit(_scenarios(), plan=plan)
        svc.start()
        with pytest.raises(ServiceCrashed) as exc:
            doomed.result(timeout=T)
        assert isinstance(exc.value.cause, FaultInjected)
        # the supervisor restarted the worker: the NEXT submit round-trips
        rep = svc.submit(_scenarios(), plan=plan).result(timeout=T)
        snap = svc.snapshot()
    finally:
        svc.close()
    assert snap["restarts"] == 1, snap
    np.testing.assert_allclose(rep.makespans, ref.makespans, rtol=1e-9)
    with _service() as fresh:
        clean = fresh.submit(_scenarios(), plan=plan).result(timeout=T)
    np.testing.assert_array_equal(rep.makespans, clean.makespans)
    for n in rep.order:
        np.testing.assert_array_equal(rep.finish[n], clean.finish[n])


def test_worker_crash_fails_every_inflight_request(plan):
    svc = _service(autostart=False, faults=FaultPlan(kill_worker_at=1))
    try:
        futs = [svc.submit([sc], plan=plan) for sc in _scenarios()]
        svc.start()
        for f in futs:
            with pytest.raises(ServiceCrashed):
                f.result(timeout=T)
    finally:
        svc.close()
    assert svc.snapshot()["restarts"] == 1


# ----------------------------------------------------------------- retries --
def test_transient_sweep_failure_retried_to_success(plan, ref):
    with _service(faults=FaultPlan(fail_sweep=1),
                  retry_backoff_s=1e-4) as svc:
        rep = svc.submit(_scenarios(), plan=plan).result(timeout=T)
        snap = svc.snapshot()
    assert snap["retries"] >= 1, snap
    np.testing.assert_allclose(rep.makespans, ref.makespans, rtol=1e-9)
    assert rep.backends == ["torch"] * len(FRACS)


def test_malformed_override_fails_alone(plan, ref):
    svc = _service(autostart=False, retry_backoff_s=1e-4,
                   faults=FaultPlan(malformed_request=1))
    try:
        poisoned = svc.submit(_scenarios(), plan=plan)
        neighbor = svc.submit(_scenarios(), plan=plan)
        svc.start()
        # the injected malformed override is a CLIENT error: original type,
        # not a ServiceError — and only the poisoned future sees it
        with pytest.raises(ValueError):
            poisoned.result(timeout=T)
        rep = neighbor.result(timeout=T)
    finally:
        svc.close()
    np.testing.assert_allclose(rep.makespans, ref.makespans, rtol=1e-9)


# ------------------------------------------------------------- degradation --
def test_nan_rows_degrade_to_numpy_with_parity(plan, ref):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with _service(faults=FaultPlan(nan_rows=(1, 3),
                                       nan_sweep=None)) as svc:
            rep = svc.submit(_scenarios(), plan=plan).result(timeout=T)
            snap = svc.snapshot()
    assert rep.backends == ["torch", "degraded", "torch", "degraded"]
    assert rep.degraded_indices == [1, 3]
    np.testing.assert_allclose(rep.makespans, ref.makespans, rtol=1e-9)
    for n in rep.order:
        np.testing.assert_allclose(rep.finish[n], ref.finish[n], rtol=1e-9)
    # the degraded rows ARE the numpy twin's rows
    np.testing.assert_array_equal(rep.makespans[[1, 3]], ref.makespans[[1, 3]])
    assert snap["degraded"] == 2, snap
    assert snap["top_degrade_reasons"], snap
    degrade_warns = [w for w in caught
                     if "degraded to the numpy reference engine"
                     in str(w.message)]
    assert len(degrade_warns) == 1  # ONE aggregated warning, not per-row
    # repro's service under the same fault plan: same routing, same answers
    ref_plan = ref_paper.build_workflow(0.5).compile()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with RefService(faults=RefFaultPlan(nan_rows=(1, 3),
                                            nan_sweep=None)) as ref_svc:
            rep_r = ref_svc.submit(ref_paper.sweep_scenarios(FRACS),
                                   plan=ref_plan).result(timeout=T)
    assert [b.replace("jax", "torch") for b in rep_r.backends] == rep.backends
    _assert_match(rep, rep_r)


def test_degradation_composes_with_prepared_packs(plan, ref):
    """A prepared pack submitted as its own request degrades the same way
    (sharded: :func:`test_degradation_composes_with_sharded_packs`)."""
    pack = plan.prepare(_scenarios())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with _service(faults=FaultPlan(nan_rows=(0, 2),
                                       nan_sweep=None)) as svc:
            rep = svc.submit_pack(pack).result(timeout=T)
    assert rep.degraded_indices == [0, 2]
    np.testing.assert_allclose(rep.makespans, ref.makespans, rtol=1e-9)


@pytest.mark.parametrize("n", [3, 4])
def test_degradation_composes_with_sharded_packs(plan, ref, n):
    """The reference's case: a sharded pack degrades its poisoned rows to
    the numpy twin; the clean rows are the unsharded sweep's, bit for
    bit."""
    pack = plan.prepare(_scenarios())
    clean = plan.sweep(pack, backend="torch")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with _service(faults=FaultPlan(nan_rows=(0, 2),
                                       nan_sweep=None)) as svc:
            rep = svc.submit_pack(pack.shard(n)).result(timeout=T)
            snap = svc.snapshot()
    assert rep.degraded_indices == [0, 2] and snap["degraded"] == 2, snap
    assert rep.backends == ["degraded", "torch", "degraded", "torch"]
    np.testing.assert_allclose(rep.makespans, ref.makespans, rtol=1e-9)
    np.testing.assert_array_equal(rep.makespans[[0, 2]], ref.makespans[[0, 2]])
    np.testing.assert_array_equal(rep.makespans[[1, 3]], clean.makespans[[1, 3]])


def test_degraded_rows_survive_coalescing(plan, ref):
    """Poisoned rows inside a coalesced batch degrade without disturbing
    the per-client row slicing."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        svc = _service(autostart=False,
                       faults=FaultPlan(nan_rows=(0, 5), nan_sweep=None))
        try:
            futs = [svc.submit([sc], plan=plan) for sc in _scenarios()]
            svc.start()
            reps = [f.result(timeout=T) for f in futs]
            snap = svc.snapshot()
        finally:
            svc.close()
    assert snap["sweeps"] == 1, snap  # still ONE fused sweep
    for i, rep in enumerate(reps):
        assert rep.B == 1
        np.testing.assert_allclose(rep.makespans, ref.makespans[i:i + 1],
                                   rtol=1e-9)
    assert reps[0].backends == ["degraded"]  # row 0 was poisoned
    assert reps[1].backends == ["torch"]


def test_pack_subset_matches_full_numpy_rows(plan):
    pack = plan.prepare(_scenarios())
    full = plan.sweep(pack, backend="numpy")
    sub = plan.sweep(pack.subset([2, 0]), backend="numpy")
    np.testing.assert_array_equal(sub.makespans, full.makespans[[2, 0]])
    assert sub.labels == [full.labels[2], full.labels[0]]
    for n in full.order:
        np.testing.assert_array_equal(sub.finish[n], full.finish[n][[2, 0]])


# -------------------------------------------------- deadlines/backpressure --
def test_delay_past_deadline_fails_before_packing(plan, ref):
    svc = _service(autostart=False, faults=FaultPlan(delay_s=0.25))
    try:
        doomed = svc.submit(_scenarios(), plan=plan, deadline_s=0.02)
        patient = svc.submit(_scenarios(), plan=plan)
        svc.start()
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=T)
        rep = patient.result(timeout=T)
        snap = svc.snapshot()
    finally:
        svc.close()
    assert snap["deadline_expired"] == 1, snap
    np.testing.assert_allclose(rep.makespans, ref.makespans, rtol=1e-9)


def test_overload_sheds_newest_request(plan):
    svc = _service(autostart=False, max_pending=2)
    try:
        kept = [svc.submit(_scenarios(), plan=plan) for _ in range(2)]
        with pytest.raises(Overloaded):
            svc.submit(_scenarios(), plan=plan)
        assert svc.snapshot()["shed"] == 1
        svc.start()
        for f in kept:  # admitted requests still serve normally
            assert f.result(timeout=T).B == len(FRACS)
    finally:
        svc.close()


# ------------------------------------------------------- close/crash races --
def test_submit_mc_close_race_resolves_aggregate(plan):
    """close(drain=False) cancels queued MC chunks — the aggregate future
    must resolve typed, not strand."""
    svc = _service(autostart=False, max_batch=64)
    try:
        spec = {"task1.cpu": dist.lognormal(sigma=0.2)}
        agg = svc.submit_mc(spec, n=256, plan=plan)  # 4 queued chunks
    finally:
        svc.close(drain=False)
    with pytest.raises(ServiceCrashed, match="cancelled"):
        agg.result(timeout=T)


def test_submit_mc_worker_crash_fails_aggregate(plan):
    svc = _service(autostart=False, max_batch=64,
                   faults=FaultPlan(kill_worker_at=1))
    try:
        agg = svc.submit_mc({"task1.cpu": dist.uniform(0.8, 1.2)}, n=256,
                            plan=plan)
        svc.start()
        with pytest.raises(ServiceCrashed):
            agg.result(timeout=T)
    finally:
        svc.close()


def test_submit_mc_matches_plan_mc(plan):
    """Chunked through the coalescing worker, the distribution query is
    ``plan.mc`` with the same arguments, bit for bit."""
    from repro_torch.configs.paper_workflow import mc_spec

    with _service(max_batch=64) as svc:
        mc = svc.submit_mc(mc_spec(), n=256, seed=3, plan=plan).result(
            timeout=T)
        snap = svc.snapshot()
    want = plan.mc(mc_spec(), n=256, seed=3)
    assert snap["sweeps"] >= 4
    np.testing.assert_array_equal(mc.makespans, want.makespans)
    assert mc.quantiles() == want.quantiles()
    assert [(a.label, a.p_dominant) for a in mc.attribution()] == \
        [(a.label, a.p_dominant) for a in want.attribution()]


def test_close_never_strands_unstarted_queue(plan):
    svc = _service(autostart=False)
    try:
        fut = svc.submit(_scenarios(), plan=plan)
    finally:
        svc.close()
    with pytest.raises(CancelledError):
        fut.result(timeout=T)
    with pytest.raises(ServiceClosed):
        svc.submit(_scenarios(), plan=plan)
    with pytest.raises(ServiceClosed):
        svc.start()


def test_snapshot_reports_fault_census(plan):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with _service(max_pending=None,
                      faults=FaultPlan(nan_rows=(0,), nan_sweep=1)) as svc:
            svc.submit(_scenarios(), plan=plan).result(timeout=T)
            snap = svc.snapshot()
    assert snap["degraded"] == 1
    (reason, count), = snap["top_degrade_reasons"]
    assert count == 1 and "NaN" in reason
    for key in ("restarts", "retries", "shed", "deadline_expired",
                "latency_p50_s", "latency_p99_s", "warm_hits", "cold_traces"):
        assert key in snap
