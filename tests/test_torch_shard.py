"""Sharded scenario packs in the port (``ScenarioPack.shard``) against the
unsharded sweep and the reference.

The reference pmaps the padded scenario axis over JAX devices; the port
splits it into sub-batches, shard i on ``cuda:i`` on a card and one after
another on the host for a CPU plan.  Bars: a sharded sweep is the unsharded
one bit for bit (rows, finish times, share seconds, progress arrays and the
``Report``'s curve queries) at n in {3, 4, 7}, with B not a multiple of n;
against the reference at ``_assert_match``'s bars.  Every plan here is on
``device="cpu"``.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from repro import sweep as ref_sweep
from repro.analysis import dist as ref_dist
from repro.analysis import scenarios as ref_scenarios
from repro.core import DataDep as RDataDep
from repro.core import PPoly as RPPoly
from repro.core import Process as RProcess
from repro.core import ResourceDep as RResourceDep
from repro.core import Workflow as RWorkflow
from repro_torch import sweep
from repro_torch.analysis import AnalysisService, dist, load_plan, scenarios
from repro_torch.configs import paper_workflow as paper
from repro_torch.core import DataDep, PPoly, Process, ResourceDep, Workflow
from repro_torch.sweep.torch_engine import shard_devices
from test_sweep import _assert_match

CPU = "cpu"
N_LINK = 1000.0
RATES = (2.0, 4.0, 5.0, 8.0, 10.0, 40.0)       # B = 6, not a multiple of 4


def _tiny(pkg):
    """One link-limited download: makespan = 1000 / rate."""
    DD, PP, PR, RD, WF = pkg
    wf = WF()
    wf.add(PR("dl", data={"file": DD.stream(N_LINK, N_LINK)},
              resources={"link": RD.stream(N_LINK, N_LINK)},
              total_progress=N_LINK).identity_output(),
           resources={"link": PP.constant(10.0)})
    wf.set_data_input("dl", "file", PP.constant(N_LINK))
    return wf


PORT = (DataDep, PPoly, Process, ResourceDep, Workflow)
REF = (RDataDep, RPPoly, RProcess, RResourceDep, RWorkflow)


def _rate_scenarios(mod, pp):
    return [mod.Scenario(label=f"r{r}",
                         resource_inputs={("dl", "link"): pp.constant(r)})
            for r in RATES]


@pytest.fixture(scope="module")
def fig7():
    plan = paper.compile_paper_plan(0.5, device=CPU)
    pack = plan.prepare(paper.sweep_scenarios(np.linspace(0.02, 0.98, 100)))
    return plan, pack, plan.sweep(pack, backend="torch")


@pytest.fixture(scope="module")
def ramped():
    """Fig. 7 splits and seeded ramped link allocations: the quadratic
    class (``pack.ramps``), as chip_smoke.py's b10k_ramped set."""
    rng = np.random.default_rng(0)
    scs = list(paper.sweep_scenarios(np.linspace(0.02, 0.98, 20)))
    for i in range(21):
        t1, t2 = np.sort(rng.uniform(5.0, 200.0, 2))
        scs.append(scenarios.override(label=f"ramp{i}", resources={
            ("dl1", "link"): PPoly.pwlinear([0.0, t1, t2],
                                            rng.uniform(0.05, 0.95, 3) * paper.LINK_BPS),
            ("dl2", "link"): PPoly.pwlinear([0.0, t1, t2],
                                            rng.uniform(0.05, 1.0, 3) * paper.LINK_BPS)}))
    plan = paper.compile_paper_plan(0.5, device=CPU)
    pack = plan.prepare(scs)
    assert pack.ramps
    return plan, pack, plan.sweep(pack, backend="torch")


def _same_bits(a, b, ts):
    """Two Reports equal bit for bit: rows, finish, shares, progress
    arrays and every curve query at ``ts``."""
    np.testing.assert_array_equal(a.makespans, b.makespans)
    np.testing.assert_array_equal(a.share_seconds, b.share_seconds)
    for pn in a.order:
        np.testing.assert_array_equal(a.finish[pn], b.finish[pn])
        pa, pb = a.proc_results[pn].progress, b.proc_results[pn].progress
        for x, y in zip(pa.arrays(), pb.arrays(), strict=True):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.sample_progress(pn, ts),
                                      b.sample_progress(pn, ts))
        for x, y in zip(a.data_ceiling(pn, ts), b.data_ceiling(pn, ts), strict=True):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a.kernel_finish_times(pn),
                                      b.kernel_finish_times(pn))


def test_shard_validation():
    """The twin of the reference's ``test_shard_validation``: n < 1 is
    refused; a CUDA plan takes at most the visible cards, a CPU plan any
    count."""
    plan = paper.compile_paper_plan(0.5, device=CPU)
    pack = plan.prepare(paper.sweep_scenarios([0.3, 0.6]))
    with pytest.raises(ValueError, match=">= 1"):
        pack.shard(0)
    with pytest.raises(ValueError, match=">= 1"):
        plan.sweep(pack, shards=-1)
    too_many = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="device"):
        shard_devices("cuda", too_many)
    assert shard_devices(CPU, 5) == [torch.device(CPU)] * 5
    assert pack.shard().shards == 1                  # the host is one device
    s = pack.shard(7)
    assert s.shards == 7 and pack.shards == 1
    assert s._cache is pack._cache                   # the memo is shared
    assert s.state_digest() != pack.state_digest()
    assert s.subset([1]).shards == 7
    assert s.override({"task1.cpu": 2.0}).shards == 7


def test_sharded_sweep_identical_to_single_device():
    """The reference's B = 6, ``shard(4)`` case: padding rows are dropped,
    the rows equal the unsharded sweep's bit for bit and the reference's
    ``plan.sweep``."""
    plan = _tiny(PORT).compile(device=CPU)
    pack = plan.prepare(_rate_scenarios(sweep, PPoly))
    r1 = plan.sweep(pack, backend="torch")
    r4 = plan.sweep(pack.shard(4), backend="torch")
    _same_bits(r1, r4, np.linspace(0.0, 600.0, 33))
    np.testing.assert_allclose(r4.makespans, [500., 250., 200., 125., 100., 25.])
    eng = plan._torch_engine
    assert [row[:3] for row in eng.proven_caps_rows()] == [(6, 1, False), (8, 4, False)]
    ref_plan = _tiny(REF).compile()
    ref_pack = ref_plan.prepare(_rate_scenarios(ref_sweep, RPPoly))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        want = ref_plan.sweep(ref_pack, backend="jax")
    _assert_match(r4, want)
    np.testing.assert_allclose(r4.makespans, want.makespans, rtol=1e-9)


@pytest.mark.parametrize("n", [3, 4, 7])
def test_fig7_sharded_bit_for_bit(fig7, n):
    plan, pack, want = fig7
    got = plan.sweep(pack.shard(n), backend="torch")
    assert got.backends == want.backends
    _same_bits(got, want, np.linspace(0.0, 320.0, 64))


@pytest.mark.parametrize("n", [3, 4, 7])
def test_ramped_sharded_bit_for_bit(ramped, n):
    plan, pack, want = ramped
    _same_bits(plan.sweep(pack, shards=n, backend="torch"), want,
               np.linspace(0.0, 400.0, 64))


def test_sweep_shards_prepares_a_list(fig7):
    """``plan.sweep(list, shards=n)`` prepares, shards and takes the torch
    engine, as ``plan.sweep(plan.prepare(list).shard(n))`` does."""
    plan, _pack, _want = fig7
    scs = paper.sweep_scenarios([0.3, 0.5, 0.9, 0.95])
    got = plan.sweep(scs, shards=3)
    assert got.backends == ["torch"] * 4
    _same_bits(got, plan.sweep(plan.prepare(scs)), np.linspace(0.0, 320.0, 16))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_mc_bit_identical_across_shards(n):
    """The twin of the reference's ``test_shard_bit_identity_subprocess``:
    the same seed gives the same MCReport at every shard count (B = 14),
    and the reference's at its bars."""
    plan = _tiny(PORT).compile(device=CPU)
    spec = scenarios.override({"dl.link": dist.lognormal(sigma=0.3)})
    m0 = plan.mc(spec, n=14, seed=42)
    mn = plan.mc(spec, n=14, seed=42, shards=n)
    np.testing.assert_array_equal(m0.makespans, mn.makespans)
    np.testing.assert_array_equal(m0.report.share_seconds, mn.report.share_seconds)
    for k in m0.samples:
        np.testing.assert_array_equal(m0.samples[k], mn.samples[k])
    assert m0.quantiles() == mn.quantiles()
    ref_plan = _tiny(REF).compile()
    want = ref_plan.mc(ref_scenarios.override({"dl.link": ref_dist.lognormal(sigma=0.3)}),
                       n=14, seed=42)
    np.testing.assert_allclose(mn.makespans, want.makespans, rtol=1e-9)


def test_service_sweeps_a_sharded_pack(fig7):
    """``submit_pack`` of a sharded pack: the rows of the unsharded sweep,
    bit for bit."""
    plan, pack, want = fig7
    with AnalysisService(device=CPU) as svc:
        got = svc.submit_pack(pack.shard(3)).result(timeout=120)
    np.testing.assert_array_equal(got.makespans, want.makespans)
    np.testing.assert_array_equal(got.share_seconds, want.share_seconds)


def test_bmplan_round_trip_sweeps_sharded(tmp_path):
    """A plan that swept sharded exports its ``(Bp, shards, ramps)`` cap
    row; the loaded plan starts that sweep warm, bit for bit."""
    plan = paper.compile_paper_plan(0.5, device=CPU)
    scs = paper.sweep_scenarios(np.linspace(0.1, 0.9, 10))
    pack = plan.prepare(scs).shard(4)
    plan.sweep(pack, backend="torch")              # proves the cap
    want = plan.sweep(pack, backend="torch")       # a warm sweep at it
    rows = plan._torch_engine.proven_caps_rows()
    assert any(r[:3] == (12, 4, False) for r in rows), rows
    loaded = load_plan(plan.export(tmp_path / "shard.bmplan"), device=CPU)
    got = loaded.sweep(loaded.prepare(scs).shard(4), backend="torch")
    eng = loaded._torch_engine
    assert eng.warm_hits == 1 and eng.cold_solves == 0
    assert eng.proven_caps_rows() == rows
    _same_bits(got, want, np.linspace(0.0, 320.0, 16))
