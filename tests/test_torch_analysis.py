"""The whole slice of the torch port: compile -> prepare -> sweep -> Report.

The paper workflow and its Fig. 7 scenarios go through ``repro`` and, carried
across by ``repro_torch.core.convert``, through ``repro_torch`` on the CPU.
Rankings, shares, timelines, the bottleneck function and the curve queries
are compared (curve queries against ``repro`` with ``use_pallas=False``, at
rtol/atol 1e-5, argmin exact); the pinned golden numbers of
``tests/test_golden_paper_workflow.py`` must hold at 1e-9.
"""

import numpy as np
import pytest

from repro.configs import paper_workflow as ref_paper
from repro_torch.configs import paper_workflow as paper
from repro_torch.analysis import compile_workflow, ramp_resource
from repro_torch.core.convert import workflow_from_arrays

from test_golden_paper_workflow import GOLDEN_FINISH, GOLDEN_MAKESPAN, GOLDEN_SHARES
from test_sweep import _assert_match

REL = 1e-9
FRACS = np.linspace(0.05, 0.95, 19)


@pytest.fixture(scope="module")
def both():
    plan_r = ref_paper.compile_paper_plan(0.5)
    rep_r = plan_r.sweep(plan_r.prepare(ref_paper.sweep_scenarios(FRACS)),
                         backend="jax")
    plan_t = paper.compile_paper_plan(0.5, device="cpu")
    rep_t = plan_t.sweep(plan_t.prepare(paper.sweep_scenarios(FRACS)),
                         backend="torch")
    return plan_r, rep_r, plan_t, rep_t


def test_report_matches_reference(both):
    _pr, rep_r, _pt, rep_t = both
    assert rep_t.backends == ["torch"] * len(FRACS) and rep_t.backend == "torch"
    assert rep_t.labels == rep_r.labels and rep_t.factors == rep_r.factors
    _assert_match(rep_t, rep_r)
    assert [(i, lab) for i, lab, _ in rep_t.top_k(5)] == \
        [(i, lab) for i, lab, _ in rep_r.top_k(5)]
    np.testing.assert_allclose([m for *_, m in rep_t.top_k(5)],
                               [m for *_, m in rep_r.top_k(5)], rtol=1e-9)


@pytest.mark.parametrize("i", [None, 0, 9])
def test_shares_and_timeline_match(both, i):
    _pr, rep_r, _pt, rep_t = both
    key = lambda r: (r.process, r.kind, r.name)  # noqa: E731
    st, sr = rep_t.shares(i), rep_r.shares(i)
    assert [key(r) for r in st] == [key(r) for r in sr]
    np.testing.assert_allclose([r.seconds for r in st], [r.seconds for r in sr],
                               rtol=1e-5)
    np.testing.assert_allclose([r.fraction for r in st],
                               [r.fraction for r in sr], rtol=1e-4)
    tt, tr = rep_t.timeline(i), rep_r.timeline(i)
    assert [row[2:] for row in tt] == [row[2:] for row in tr]
    np.testing.assert_allclose([row[:2] for row in tt], [row[:2] for row in tr],
                               rtol=1e-9)


def test_bottleneck_fn_and_gains_match(both):
    plan_r, _rr, plan_t, _rt = both
    ft, fr = plan_t.bottleneck_fn(), plan_r.bottleneck_fn()
    assert [iv[2:] for iv in ft.table()] == [iv[2:] for iv in fr.table()]
    np.testing.assert_allclose([iv[:2] for iv in ft.table()],
                               [iv[:2] for iv in fr.table()], rtol=1e-9)
    assert ft.dominant().name == fr.dominant().name
    gt, gr = plan_t.gains(), plan_r.gains()
    assert [g[:2] for g in gt] == [g[:2] for g in gr]
    np.testing.assert_allclose([g[2:] for g in gt], [g[2:] for g in gr],
                               rtol=1e-9)
    assert plan_t.gain(("task1", "cpu")) == pytest.approx(
        plan_r.gain(("task1", "cpu")), rel=1e-9)
    assert plan_t.whatif(**{"dl1.link": 1.5}).makespan == pytest.approx(
        plan_r.whatif(**{"dl1.link": 1.5}).makespan, rel=1e-9)


def test_curve_queries_match_reference(both):
    _pr, rep_r, _pt, rep_t = both
    ts = np.linspace(-5.0, 420.0, 333)
    for pn in rep_t.order:
        np.testing.assert_allclose(
            rep_t.sample_progress(pn, ts),
            rep_r.sample_progress(pn, ts, use_pallas=False),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            rep_t.kernel_finish_times(pn),
            rep_r.kernel_finish_times(pn, use_pallas=False), rtol=1e-5)
    for pn in ("task1", "task3"):
        vt, at = rep_t.data_ceiling(pn, ts)
        vr, ar = rep_r.data_ceiling(pn, ts, use_pallas=False)
        np.testing.assert_allclose(vt, vr, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(at, ar)


def test_kernel_finish_times_match_engine(both):
    _pr, _rr, _pt, rep_t = both
    for pn in rep_t.order:
        np.testing.assert_allclose(rep_t.kernel_finish_times(pn),
                                   rep_t.finish[pn], rtol=1e-4)


QUERIES = ("sample_progress", "data_ceiling", "kernel_finish_times")


def _query(rep, call, pn, ts, **kw):
    if call == "kernel_finish_times":
        return rep.kernel_finish_times(pn, **kw)
    return getattr(rep, call)(pn, ts, **kw)


def _arrays(out):
    return out if isinstance(out, tuple) else (out,)


def _same_bits(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
               for x, y in zip(_arrays(a), _arrays(b)))


def _by_hand(rep, call, pn, ts):
    """The call's op on float32 inputs packed by hand on the host: the
    tables from ``kernel_args()``, the ceilings padded to (B, F, P, K), the
    levels broadcast to (B, T)."""
    from repro_torch.kernels.ppoly_eval import (PAD_START, ppoly_eval,
                                                ppoly_first_crossing, ppoly_min_eval)

    r = rep.proc_results[pn]
    q = np.ascontiguousarray(np.broadcast_to(np.asarray(ts, np.float32),
                                             (rep.B, len(ts))))
    if call == "sample_progress":
        return ppoly_eval(*r.progress.kernel_args(), q).numpy()
    if call == "kernel_finish_times":
        y = np.full((rep.B, 1), r.p_end, np.float32)
        out = ppoly_first_crossing(*r.progress.kernel_args(), y).numpy()[:, 0]
        return np.where(out >= 1e29, np.inf, out.astype(np.float64))
    packs = [c.kernel_args() for c in r.ceilings]
    P = max(s.shape[1] for s, _ in packs)
    K = max(c.shape[-1] for _, c in packs)
    starts = np.full((rep.B, len(packs), P), PAD_START, np.float32)
    coeffs = np.zeros((rep.B, len(packs), P, K), np.float32)
    for f, (s, c) in enumerate(packs):
        starts[:, f, :s.shape[1]] = s
        coeffs[:, f, :s.shape[1], :c.shape[-1]] = c
    vals, arg = ppoly_min_eval(starts, coeffs, q)
    return vals.numpy(), arg.numpy()


@pytest.mark.parametrize("call", QUERIES)
def test_curve_queries_equal_the_ops_on_packed_inputs(both, call):
    """Each call gives the bits of its op on inputs packed by hand, with the
    reference's dtypes and shapes; a second call (its tables already on the
    device) gives the same bits in new arrays."""
    _pr, rep_r, _pt, rep_t = both
    ts = np.linspace(-5.0, 420.0, 333)
    for pn in rep_t.order:
        first = _query(rep_t, call, pn, ts)
        second = _query(rep_t, call, pn, ts)
        assert _same_bits(first, _by_hand(rep_t, call, pn, ts))
        assert _same_bits(second, first)
        for a, b in zip(_arrays(first), _arrays(second)):
            assert not np.shares_memory(a, b)
        ref = _query(rep_r, call, pn, ts, use_pallas=False)
        assert [(a.dtype, a.shape) for a in _arrays(first)] == \
            [(np.asarray(a).dtype, np.asarray(a).shape) for a in _arrays(ref)]


def test_subset_and_concat_reports_answer_as_the_reference(both):
    """Reports built from a Report carry none of its engine results and
    none of its tables on the device: their curve queries raise as the
    reference's do, after the parent's tables reached the device.  A concat
    of one Report is that Report, and a Report of other scenarios of the
    same plan answers from its own tables."""
    from repro.analysis.report import concat_reports as ref_concat
    from repro_torch.analysis.report import concat_reports

    _pr, rep_r, plan_t, rep_t = both
    ts = np.linspace(0.0, 400.0, 50)
    for call in QUERIES:
        _query(rep_t, call, "task3", ts)
    assert {("progress", "task3"), ("ceilings", "task3")} <= set(rep_t._tables_cache)
    pairs = [(rep_t.subset([3, 1]), rep_r.subset([3, 1])),
             (concat_reports([rep_t.subset([0]), rep_t.subset([1, 2])]),
              ref_concat([rep_r.subset([0]), rep_r.subset([1, 2])]))]
    for mine, ref in pairs:
        assert not mine._tables_cache
        for call in QUERIES:
            with pytest.raises(ValueError) as got:
                _query(mine, call, "task3", ts)
            with pytest.raises(ValueError) as want:
                _query(ref, call, "task3", ts, use_pallas=False)
            # the same message; the backend is named after each package's engine
            assert str(got.value) == str(want.value).replace("'jax'", "'torch'")
    assert concat_reports([rep_t]) is rep_t
    other = plan_t.sweep(plan_t.prepare(paper.sweep_scenarios(FRACS[::2])),
                         backend="torch")
    for call in QUERIES:
        got = _query(other, call, "task3", ts)
        assert _same_bits(got, _by_hand(other, call, "task3", ts))
        for a, b in zip(_arrays(got), _arrays(_query(rep_t, call, "task3", ts))):
            np.testing.assert_allclose(a, b[::2], rtol=1e-5, atol=1e-5)


def _ramped_specs(mod, ramp_resource):
    link = mod.LINK_BPS
    return mod.sweep_scenarios(FRACS[:6]) + [
        ramp_resource("dl2", "link", [0.0, 60.0, 150.0],
                      [0.4 * link, 0.9 * link, 0.2 * link]),
        ramp_resource("dl1", "link", [0.0, 100.0], [0.1 * link, 0.6 * link])]


def test_ramped_queries_match_reference():
    """Ramped link allocations: quadratic progress pieces (K = 3 queries)."""
    from repro.analysis import ramp_resource as ref_ramp_resource

    plan_r = ref_paper.compile_paper_plan(0.5)
    pack_r = plan_r.prepare(_ramped_specs(ref_paper, ref_ramp_resource))
    rep_r = plan_r.sweep(pack_r, backend="jax")
    plan_t = paper.compile_paper_plan(0.5, device="cpu")
    pack_t = plan_t.prepare(_ramped_specs(paper, ramp_resource))
    assert pack_t.ramps and pack_r.ramps
    rep_t = plan_t.sweep(pack_t, backend="torch")
    _assert_match(rep_t, rep_r)
    ts = np.linspace(0.0, 400.0, 101)
    for pn in rep_t.order:
        assert rep_t.proc_results[pn].progress.kernel_args()[1].shape[-1] in (2, 3)
        np.testing.assert_allclose(
            rep_t.kernel_finish_times(pn),
            rep_r.kernel_finish_times(pn, use_pallas=False), rtol=1e-5)
        np.testing.assert_allclose(
            rep_t.sample_progress(pn, ts),
            rep_r.sample_progress(pn, ts, use_pallas=False),
            rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ goldens ------
@pytest.mark.parametrize("frac", [0.50, 0.95])
def test_golden_scalar_solve(frac):
    rep = paper.compile_paper_plan(frac, device="cpu").solve()
    assert rep.makespan == pytest.approx(GOLDEN_MAKESPAN[frac], rel=REL)
    for name, expect in GOLDEN_FINISH[frac].items():
        assert rep.finish(name) == pytest.approx(expect, rel=REL), name
    shares = {(r.process, r.kind, r.name): r.fraction for r in rep.shares()}
    for key, expect in GOLDEN_SHARES[frac].items():
        assert shares[key] == pytest.approx(expect, rel=1e-6), key


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_golden_sweep_reproduces_both_points(backend):
    plan = paper.compile_paper_plan(0.5, device="cpu")
    rep = plan.sweep(plan.prepare(paper.sweep_scenarios([0.50, 0.95])),
                     backend=backend)
    for i, frac in enumerate((0.50, 0.95)):
        assert rep.makespan[i] == pytest.approx(GOLDEN_MAKESPAN[frac], rel=REL)
        for name, expect in GOLDEN_FINISH[frac].items():
            assert rep.finish[name][i] == pytest.approx(expect, rel=REL), name
        shares = {(r.process, r.kind, r.name): r.fraction
                  for r in rep.bottleneck_report(i)}
        for key, expect in GOLDEN_SHARES[frac].items():
            assert shares[key] == pytest.approx(expect, rel=1e-6), key


def test_predict_makespan_and_converted_workflow_agree():
    assert paper.predict_makespan(0.95) == pytest.approx(GOLDEN_MAKESPAN[0.95],
                                                         rel=REL)
    carried = compile_workflow(workflow_from_arrays(ref_paper.build_workflow(0.5)),
                               device="cpu")
    assert carried.solve().makespan == pytest.approx(GOLDEN_MAKESPAN[0.50],
                                                     rel=REL)


def test_auto_routes_packs_to_torch_and_lists_to_numpy():
    plan = paper.compile_paper_plan(0.5, device="cpu")
    scs = paper.sweep_scenarios([0.3, 0.7])
    assert set(plan.sweep(plan.prepare(scs)).backends) == {"torch"}
    assert set(plan.sweep(scs).backends) == {"batched"}
    with pytest.raises(ValueError, match="unknown backend"):
        plan.sweep(scs, backend="jax")


def test_pack_override_subset_and_digest():
    """Delta re-packs and row subsets sweep like freshly prepared packs."""
    plan = paper.compile_paper_plan(0.5, device="cpu")
    scs = paper.sweep_scenarios(FRACS[:5])
    pack = plan.prepare(scs)
    assert pack.state_digest() == plan.prepare(scs).state_digest()
    over = pack.override({"task1.cpu": 2.0})
    assert over.state_digest() != pack.state_digest()
    swept = plan.sweep(over, backend="torch")
    fresh = plan.sweep([sc for sc in over.scenarios], backend="numpy")
    _assert_match(swept, fresh)
    sub = plan.sweep(pack.subset([4, 1]), backend="torch")
    full = plan.sweep(pack, backend="torch")
    _assert_match(sub, full.subset([4, 1]))
