"""The port's shared-link allocator (§3.4/§5.2), its chunk-level DES (the
"measured system" of Fig. 7 and §6) and the deprecated ``sweep.analyze``
shim against the JAX package's, on the same inputs."""

import warnings

import numpy as np
import pytest

from repro.configs import paper_workflow as ref_pw
from repro.core import DataDep as RDataDep
from repro.core import PPoly as RPPoly
from repro.core import Process as RProcess
from repro.core import ResourceDep as RResourceDep
from repro.core import Workflow as RWorkflow
from repro.core import shared as ref_shared
from repro_torch import sweep as port_sweep
from repro_torch.analysis.report import Report
from repro_torch.configs import paper_workflow as pw
from repro_torch.core import (sequential_allocation, total_usage,
                              usage_rate)
from repro_torch.core.convert import ppoly_from_arrays, workflow_from_arrays

RTOL = 1e-12


def _download(name, size):
    return RProcess(name, data={"remote": RDataDep.stream(size, size)},
                    resources={"link": RResourceDep.stream(size, size)},
                    total_progress=size).identity_output()


def _ref_case(sizes, rates):
    wf = RWorkflow()
    for n, size in sizes.items():
        wf.add(_download(n, size))
        wf.set_data_input(n, "remote", RPPoly.constant(size))
    users = [(n, "link", RPPoly.constant(r)) for n, r in rates.items()]
    return wf, users


V, C = ref_pw.VIDEO_BYTES, ref_pw.LINK_BPS
CASES = {
    **{f"paper_{f}": ({"dl1": V, "dl2": V}, {"dl1": f * C, "dl2": C}, C)
       for f in (0.5, 0.7, 0.75, 0.93)},
    "cascade": ({"a": 1000.0, "b": 1000.0, "c": 1000.0},
                {"a": 50.0, "b": 100.0, "c": 100.0}, 100.0),
}


def _assert_ppoly_equal(got, want):
    np.testing.assert_allclose(got.starts, want.starts, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got.coeffs, want.coeffs, rtol=RTOL,
                               atol=RTOL * np.abs(want.coeffs).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequential_allocation_matches_reference(case):
    sizes, rates, cap = CASES[case]
    ref_wf, ref_users = _ref_case(sizes, rates)
    wf = workflow_from_arrays(ref_wf)
    users = [(n, r, ppoly_from_arrays(f)) for n, r, f in ref_users]
    ref = ref_shared.sequential_allocation(ref_wf, ref_users, cap)
    got = sequential_allocation(wf, users, cap)
    assert list(got) == list(ref)
    ts = np.linspace(0.0, 1.5 * max(r.finish_time for r in ref.values()), 513)
    for name in ref:
        np.testing.assert_allclose(got[name].finish_time,
                                   ref[name].finish_time, rtol=RTOL)
        _assert_ppoly_equal(wf.resource_alloc[name]["link"],
                            ref_wf.resource_alloc[name]["link"])
        _assert_ppoly_equal(got[name].progress, ref[name].progress)
        u, ru = usage_rate(got[name], "link"), ref_shared.usage_rate(
            ref[name], "link")
        _assert_ppoly_equal(u, ru)
        np.testing.assert_allclose(u(ts), ru(ts), rtol=RTOL, atol=0)
    tot = total_usage(got, "link", ts)
    np.testing.assert_allclose(tot, ref_shared.total_usage(ref, "link", ts),
                               rtol=RTOL, atol=0)
    assert np.max(tot) <= cap * (1 + 1e-9)


@pytest.mark.parametrize("frac", [0.5, 0.75, 0.93])
def test_dl2_finishes_when_the_link_moved_both_files(frac):
    sizes, rates, cap = CASES["paper_0.5"][0], {"dl1": frac * C, "dl2": C}, C
    ref_wf, ref_users = _ref_case(sizes, rates)
    wf = workflow_from_arrays(ref_wf)
    users = [(n, r, ppoly_from_arrays(f)) for n, r, f in ref_users]
    got = sequential_allocation(wf, users, cap)
    assert got["dl2"].finish_time == pytest.approx(2 * V / C, rel=1e-6)
    t1 = V / (frac * C)
    assert got["dl1"].finish_time == pytest.approx(t1, rel=1e-9)


@pytest.mark.parametrize("frac", [0.5, 0.75, 0.95])
def test_des_equals_reference_exactly(frac):
    assert pw.measure_makespan(frac) == ref_pw.measure_makespan(frac)


def test_des_small_video_equals_reference_exactly():
    vb = pw.VIDEO_BYTES / 8
    got = pw.measure_makespan(0.6, video_bytes=vb)
    assert got == ref_pw.measure_makespan(0.6, video_bytes=vb)
    assert got[1] < pw.measure_makespan(0.6)[1]


def test_des_gates_of_the_card_run():
    assert pw.measure_makespan(0.5) == (271.64631770623305, 89227)
    assert pw.measure_makespan(0.95) == (189.64551013362393, 89227)
    des50, _ = pw.measure_makespan(0.5)
    paper = pw.predict_makespan(0.5)
    assert paper >= des50 and paper == pytest.approx(des50, rel=0.15)


def test_sweep_analyze_shim_warns_and_equals_plan_sweep():
    wf = pw.build_workflow(0.5)
    scen = pw.sweep_scenarios(np.linspace(0.1, 0.9, 7))
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = port_sweep.analyze(wf, scen, backend="numpy", device="cpu")
    want = wf.compile(device="cpu").sweep(scen, backend="numpy")
    np.testing.assert_array_equal(got.makespans, want.makespans)
    np.testing.assert_array_equal(got.share_seconds, want.share_seconds)
    for name in want.order:
        np.testing.assert_array_equal(got.finish[name], want.finish[name])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        wf.compile(device="cpu").sweep(scen, backend="numpy")  # no warning
    assert port_sweep.SweepResult is Report
    assert {"SweepResult", "Report", "BottleneckRow", "analyze"} <= set(
        port_sweep.__all__)
