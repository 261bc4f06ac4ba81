"""The torch port's fused sweep engine against the reference fused engine.

One pack of scenarios goes through ``repro`` (``backend="jax"``) and, carried
across by ``repro_torch.core.convert``, through ``repro_torch`` on the CPU
(``backend="torch"``).  Tolerances are those of
``tests/test_sweep.py::_assert_match``: makespans and finish times rtol 1e-5,
shares rtol 1e-4.
"""

import numpy as np
import pytest

from repro import sweep
from repro.configs.paper_workflow import build_workflow, sweep_scenarios
from repro.core import DataDep, PPoly, Process, ResourceDep, Workflow
from repro.sweep.batch import ScenarioBatch
from repro_torch.analysis import compile_workflow
from repro_torch.core.convert import scenarios_from_arrays, workflow_from_arrays
from repro_torch.sweep import torch_engine

from test_level_fused import _diamond
from test_quadratic_class import _ramp_scenarios
from test_sweep import _assert_match, _random_scenarios, _random_workflow, _single


def _torch_plan(wf):
    return compile_workflow(workflow_from_arrays(wf), device="cpu")


def _torch_scenarios(wf, scenarios):
    return scenarios_from_arrays(ScenarioBatch(wf, list(scenarios)).scenarios)


def _torch_vs_jax(wf, scenarios):
    plan_j = wf.compile()
    rj = plan_j.sweep(plan_j.prepare(scenarios), backend="jax")
    plan_t = _torch_plan(wf)
    pack_t = plan_t.prepare(_torch_scenarios(wf, scenarios))
    rt = plan_t.sweep(pack_t, backend="torch")
    assert set(rt.backends) == {"torch"} and rt.engine_fallback is None
    _assert_match(rt, rj)
    return plan_t, pack_t, rt, rj


@pytest.fixture(scope="module")
def paper600():
    wf = build_workflow(0.5)
    return (wf,) + _torch_vs_jax(wf, sweep_scenarios(np.linspace(0.02, 0.98, 600)))


# ------------------------------------------------------- golden workflow ----
def test_paper_workflow_b600_agrees(paper600):
    _wf, _plan, _pack, rt, rj = paper600
    assert rt.B == 600
    i, label, ms = rt.top_k(1)[0]
    assert label == "frac=0.9800" and ms == pytest.approx(206.2272, abs=1e-4)
    assert rt.top_k(5) == [(a, b, pytest.approx(c, rel=1e-9))
                           for a, b, c in rj.top_k(5)]


def test_progress_curves_agree(paper600):
    _wf, _plan, _pack, rt, rj = paper600
    for pn in rt.order:
        a, b = rt.proc_results[pn].progress, rj.proc_results[pn].progress
        ts = np.linspace(0.0, 400.0, 97)
        va = np.stack([a.eval_right(np.full(rt.B, t)) for t in ts], 1)
        vb = np.stack([b.eval_right(np.full(rj.B, t)) for t in ts], 1)
        np.testing.assert_allclose(va, vb, rtol=1e-5, atol=1e-3)


def test_resweep_is_deterministic(paper600):
    _wf, plan, pack, rt, _rj = paper600
    again = plan.sweep(pack, backend="torch")
    np.testing.assert_array_equal(rt.makespans, again.makespans)
    np.testing.assert_array_equal(rt.share_seconds, again.share_seconds)


def test_matches_the_ports_numpy_engine(paper600):
    _wf, plan, pack, rt, _rj = paper600
    _assert_match(rt, plan.sweep(pack, backend="numpy"))


# ----------------------------------------------------------- edge cases ----
def test_starvation_window():
    *_, rt, _ = _torch_vs_jax(_single(PPoly.step([0, 10, 20], [10.0, 0.0, 10.0])),
                              [sweep.Scenario()])
    assert rt.finish["dl"][0] == pytest.approx(110.0)


def test_permanent_starvation_never_finishes():
    *_, rt, _ = _torch_vs_jax(_single(PPoly.step([0, 10], [10.0, 0.0])),
                              [sweep.Scenario()])
    assert not np.isfinite(rt.finish["dl"][0])


def test_burst_resource_stall_absorption():
    n = 1000.0
    pr = Process("burst", data={"d": DataDep.stream(n, n)},
                 resources={"cpu": ResourceDep.stream(20.0, n),
                            "mem": ResourceDep.burst_at(500.0, 30.0, n)},
                 total_progress=n).identity_output()
    wf = Workflow()
    wf.add(pr, resources={"cpu": PPoly.constant(1.0),
                          "mem": PPoly.constant(2.0)})
    wf.set_data_input("burst", "d", PPoly.linear(0.0, 50.0))
    scs = [sweep.Scenario(label=f"m{m}",
                          resource_inputs={("burst", "mem"): PPoly.constant(m)})
           for m in (0.5, 1.0, 2.0, 1000.0)]
    _torch_vs_jax(wf, scs)


def test_wide_level_with_bursts_and_stalls():
    wf = _diamond(burst=True)
    scs = [sweep.Scenario(label=f"m{m}",
                          resource_inputs={("m1", "mem"): PPoly.constant(m),
                                           ("src", "link"): PPoly.step(
                                               [0, 15], [40.0, 10.0 * m])})
           for m in (0.5, 1.0, 4.0)]
    _torch_vs_jax(wf, scs)


def test_gated_chain_across_levels():
    plan, _pack, rt, _rj = _torch_vs_jax(_diamond(), [sweep.Scenario()])
    assert [sorted(lv) for lv in plan.levels] == [
        ["src", "tick"], ["m0", "m1", "m2", "m3"], ["join"]]
    assert rt.proc_results["join"].t_start[0] >= rt.finish["m2"][0] - 1e-6


def test_mixed_linear_and_ramp_classes_in_one_level():
    wf = _diamond()
    scs = [sweep.Scenario(
        label=f"r{f}",
        resource_inputs={("m0", "cpu"): PPoly.pwlinear([0.0, 40.0],
                                                       [0.2 * f, 3.0]),
                         ("m3", "cpu"): PPoly.constant(0.7),
                         ("tick", "cpu"): PPoly.pwlinear([0.0, 30.0],
                                                         [2.0, f])})
        for f in (0.5, 1.0, 2.0)]
    _plan, pack, _rt, _rj = _torch_vs_jax(wf, scs)
    assert pack.ramps


@pytest.mark.parametrize("seed", [1, 4, 7])
def test_randomized_dags_match(seed):
    rng = np.random.default_rng(seed)
    wf = _random_workflow(rng)
    _torch_vs_jax(wf, _random_scenarios(rng, wf, 6))


@pytest.mark.parametrize("seed", [2, 7])
def test_randomized_ramp_sweeps_match(seed):
    rng = np.random.default_rng(seed)
    wf = _random_workflow(rng)
    _plan, pack, _rt, _rj = _torch_vs_jax(wf, _ramp_scenarios(rng, wf, 6))
    assert pack.ramps


# ---------------------------------------------------- iteration budget ------
def test_iteration_ladder_and_proven_cap(monkeypatch):
    """A tiny initial budget doubles until it fits (same results), and the
    first solve down-ratchets the proven cap to the event depth."""
    wf = build_workflow(0.5)
    scs = sweep_scenarios(np.linspace(0.1, 0.9, 5))
    plan = _torch_plan(wf)
    pack = plan.prepare(_torch_scenarios(wf, scs))
    plan._torch_engine = torch_engine.TorchSweepEngine(plan, iter_cap=1)
    small = plan.sweep(pack, backend="torch")
    _assert_match(small, plan.sweep(pack, backend="numpy"))
    caps = plan._torch_engine.proven_caps_rows()
    assert caps == [(5, 1, False, 2)]
    monkeypatch.setattr(torch_engine, "MAX_ITER_CAP", 1)
    plan._torch_engine = torch_engine.TorchSweepEngine(plan, iter_cap=1)
    with pytest.raises(torch_engine.IterationLadderExhausted):
        plan.sweep(pack, backend="torch")
    auto = plan.sweep(pack)            # auto: the decline is recorded
    assert set(auto.backends) == {"batched"}
    assert "lockstep iterations" in auto.engine_fallback
