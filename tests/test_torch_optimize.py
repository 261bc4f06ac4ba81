"""The port's differentiable sweep and ``plan.optimize`` against ``repro``.

The same cases as ``tests/test_optimize.py`` run through the reference
(``jax.grad`` through its fixed-trip scan) and through ``repro_torch`` on
the CPU (``torch.autograd`` through the fixed-trip level loop).  Bars:

* gradients against central differences at the reference's own bar (rtol
  1e-4, atol 1e-6 max(1, |v|)) and against ``jax.grad`` at rtol 1e-5;
* the fixed-trip forward against the port's ``plan.sweep`` at rtol 1e-9
  and against the reference's at rtol 1e-5 (``_assert_match``'s bar);
* the Fig. 7 optimum: theta and value at rtol 1e-6, evals, sweeps and
  iterations exactly the reference's;
* the risk-aware objective: bit-reproducible, and the reference's at rtol
  1e-6.
"""

import numpy as np
import pytest
import torch

from repro import analysis as analysis_j
from repro.analysis import cap_space as cap_space_j
from repro.analysis import mc_quantile as mc_quantile_j
from repro.analysis.optimize import _DiffObjective as DiffObjective_j
from repro.analysis.pack import ThetaMap as ThetaMap_j
from repro.analysis.scenarios import override as override_j
from repro.analysis.scenarios import ramp_resource as ramp_resource_j
from repro.configs import paper_workflow as paper_j
from repro.sweep.jax_engine import _first_pos_root as first_pos_root_j
from repro_torch import analysis
from repro_torch.analysis import cap_space, mc_quantile, optimize
from repro_torch.analysis.optimize import _DiffObjective
from repro_torch.analysis.pack import ThetaMap
from repro_torch.analysis.scenarios import override, ramp_resource
from repro_torch.configs import paper_workflow as paper
from repro_torch.core.convert import workflow_from_arrays
from repro_torch.sweep import torch_engine

from test_optimize import _wide_workflow


@pytest.fixture(scope="module")
def plans():
    """(reference plan, port plan on the CPU) of the paper workflow."""
    return paper_j.compile_paper_plan(0.5), paper.compile_paper_plan(
        0.5, device="cpu")


@pytest.fixture(scope="module")
def plan(plans):
    return plans[1]


@pytest.fixture(scope="module")
def wide_plans():
    wf = _wide_workflow()
    return (analysis_j.compile(wf),
            analysis.compile(workflow_from_arrays(wf), device="cpu"))


def _objectives(plan_j, plan_t, targets, ramped=False):
    """The reference's and the port's point objective over ``cap_space``."""
    out = []
    for pl, cs, tm, diff, ov, rr in (
            (plan_j, cap_space_j, ThetaMap_j, DiffObjective_j, override_j,
             ramp_resource_j),
            (plan_t, cap_space, ThetaMap, _DiffObjective, override,
             ramp_resource)):
        space = cs(targets, lo=0.25, hi=4.0)
        scs = ([rr("dl1", "link", [0.0, 120.0], [1.6e6, 0.6e6], label="ramp")]
               if ramped else [ov(label="base")])
        out.append(diff(pl, tm(pl, space.axes), pl.prepare(scs), 1, None))
    return out


#: the reference's gradient cases (tests/test_optimize.py): the paper
#: workflow, its ramped (quadratic) variant, the wide fan-in DAG, and both
#: sides of the event-order change on task1.cpu
GRAD_CASES = {
    "paper": (False, ["task1.cpu", "dl1.link"], [1.31, 0.73], False),
    "ramp": (False, ["task1.cpu", "task2.cpu"], [1.37, 0.81], True),
    "wide": (True, ["dl0.link", "dl2.link", "join.cpu"], [0.93, 1.41, 1.18],
             False),
    "order_lo": (False, ["task1.cpu"], [0.41], False),
    "order_hi": (False, ["task1.cpu"], [3.63], False),
}


@pytest.fixture(scope="module")
def grads(plans, wide_plans):
    """Per case: the port's value, gradient and central differences, and
    the reference's value and ``jax.grad``."""
    out = {}
    for name, (wide, targets, theta, ramped) in GRAD_CASES.items():
        f_j, f_t = _objectives(*(wide_plans if wide else plans), targets,
                               ramped)
        th = np.asarray(theta, np.float64)[None, :]
        v, g = f_t.value_grad(th)
        K, h = th.shape[1], 1e-5
        eye = np.eye(K) * h
        vv = f_t.values(np.concatenate([th + eye, th - eye], axis=0))
        v_j, g_j = f_j.value_grad(th)
        out[name] = (float(v[0]), g[0], (vv[:K] - vv[K:]) / (2.0 * h),
                     float(v_j[0]), g_j[0])
    return out


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_grad_matches_fd_and_jax_grad(grads, case):
    v, g, fd, v_j, g_j = grads[case]
    assert np.isfinite(v) and np.all(np.isfinite(g))
    np.testing.assert_allclose(g, fd, rtol=1e-4, atol=1e-6 * max(1.0, abs(v)))
    np.testing.assert_allclose(v, v_j, rtol=1e-9)
    np.testing.assert_allclose(g, g_j, rtol=1e-5)


def test_grad_differs_across_event_order_change(grads):
    """cpu-bound side: more cpu buys real makespan; link-bound side: it
    can't (the reference's check on the same two thetas)."""
    assert abs(grads["order_lo"][1][0]) > 10.0 * abs(grads["order_hi"][1][0])


def test_grad_cases_pass_under_detect_anomaly(plans, wide_plans):
    """No backward step of the fixed-trip loop yields a NaN, even in a lane
    whose gradient is masked away later."""
    with torch.autograd.detect_anomaly(check_nan=True):
        for wide, targets, theta, ramped in GRAD_CASES.values():
            _, f_t = _objectives(*(wide_plans if wide else plans), targets,
                                 ramped)
            _, g = f_t.value_grad(np.asarray(theta)[None, :])
            assert np.all(np.isfinite(g))


def test_catch_up_tie_splits_the_gradient():
    """The quadratic catch-up clamps the gap p - pd to <= 0; at p == pd the
    reference's ``jnp.minimum`` passes half the gradient to the gap.  The
    port's ``_catch_up`` does the same (``clamp_max`` would pass all of
    it), on the engine's own root finder."""
    import jax
    import jax.numpy as jnp

    def ref(x):
        return first_pos_root_j(jnp.float64(1.0), jnp.float64(-1.0),
                                jnp.minimum(x - 1.0, 0.0))

    want_v, want_g = jax.value_and_grad(ref)(jnp.float64(1.0))
    x = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    one = torch.ones((), dtype=torch.float64)
    u = torch_engine._catch_up(one, -one, x - 1.0)
    (g,) = torch.autograd.grad(u, x)
    assert float(u.detach()) == float(want_v) == 1.0
    # du/dc = -1 / (2 a u + b) = -1; half of it reaches the gap
    assert float(g) == float(want_g) == -0.5


def test_first_pos_root_matches_reference():
    """The port's root finder, with the tie repair and the masked divide,
    finds the reference's roots on seeded coefficients with zero, tied and
    near-zero entries: the same lanes without a root, the rest within an
    ulp (XLA rounds a few products differently; the reference engine's
    module runs in float64: importing it enables x64)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    pick = np.array([0.0, 1.0, -1.0, 1e-160, 2.5, -3.0])
    a, b, c = (np.where(rng.random(4096) < 0.3, rng.choice(pick, 4096),
                        rng.normal(size=4096)) for _ in range(3))
    want = np.asarray(first_pos_root_j(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(c)))
    got = torch_engine._first_pos_root(
        *(torch.as_tensor(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0.0)


# ---------------------------------------------------- forward parity ----
FORWARD_CASES = {
    "caps": (["task1.cpu", "dl2.link"],
             [[0.62, 1.0], [1.0, 1.0], [1.73, 0.55]], False),
    "ramp": (["task1.cpu", "task2.cpu"], [[0.7, 1.3], [1.37, 0.81]], True),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_diff_values_match_plan_sweep(plans, case):
    """The fixed-trip forward is the number ``plan.sweep`` gives for the
    materialized scenario: the port's (torch and numpy engines) at rtol
    1e-9, the reference's at rtol 1e-5."""
    targets, thetas, ramped = FORWARD_CASES[case]
    plan_j, plan_t = plans
    thetas = np.asarray(thetas)
    f_j, f_t = _objectives(plan_j, plan_t, targets, ramped)
    got = f_t.values(thetas)
    for pl, f, rtol in ((plan_t, f_t, 1e-9), (plan_j, f_j, 1e-5)):
        pack = pl.prepare([_with_caps(pl, f, th, i)
                           for i, th in enumerate(thetas)])
        for backend in (("torch", "numpy") if pl is plan_t else ("numpy",)):
            ms = pl.sweep(pack, backend=backend).makespan
            np.testing.assert_allclose(got, ms, rtol=rtol, err_msg=backend)


def _with_caps(plan_, f, theta, i):
    """The objective's scenario with every cap axis applied on top (a cap
    axis multiplies whatever the pack row carries)."""
    base = f.pack.scenarios[0]
    res = dict(base.resource_inputs)
    for ax in f.tm.axes:
        key = (ax.proc, ax.res)
        res[key] = res.get(key, plan_.base_res[key]) * float(ax.scale(theta))
    return type(base)(label=f"t{i}", resource_inputs=res,
                      data_inputs=dict(base.data_inputs))


def test_fig7_space_values_match_grid_sweep(plan):
    """The PwAxis space (moving breakpoint) equals the Fig. 7 grid sweep's
    makespans at the same fractions."""
    space = paper.fig7_space()
    f = _DiffObjective(plan, ThetaMap(plan, space.axes),
                       plan.prepare([override(label="base")]), 1, None)
    fracs = np.array([0.3, 0.5, 0.77, 0.98])
    got = f.values(fracs[:, None])
    ms = plan.sweep(plan.prepare(paper.sweep_scenarios(fracs)),
                    backend="torch").makespan
    np.testing.assert_allclose(got, ms, rtol=1e-9)


# ---------------------------------------------------------- fig 7 search ----
@pytest.fixture(scope="module")
def fig7(plans):
    plan_j, plan_t = plans
    return (plan_j.optimize(space=paper_j.fig7_space(), max_evals=50),
            plan_t.optimize(space=paper.fig7_space(), max_evals=50))


def test_fig7_optimum_equals_reference(fig7):
    ref, opt = fig7
    np.testing.assert_allclose(opt.theta, ref.theta, rtol=1e-6)
    np.testing.assert_allclose(opt.value, ref.value, rtol=1e-6)
    assert (opt.evals, opt.sweeps, opt.iters, opt.converged) == (
        ref.evals, ref.sweeps, ref.iters, ref.converged)
    np.testing.assert_allclose(opt.trajectory, ref.trajectory, rtol=1e-6)


def test_fig7_optimum_recovers_the_grid(plan, fig7):
    """<= 50 evaluations where the paper's grid spends 600 (the reference
    test's checks, on the port)."""
    _ref, opt = fig7
    fracs = np.linspace(0.02, 0.98, 600)
    grid_ms = plan.sweep(plan.prepare(paper.sweep_scenarios(fracs)),
                         backend="torch").makespan
    gi = int(np.argmin(grid_ms))
    assert opt.evals <= 50
    assert abs(float(opt.theta[0]) - fracs[gi]) <= fracs[1] - fracs[0] + 1e-12
    assert opt.value <= grid_ms[gi] * (1.0 + 1e-6)
    assert opt.report.makespan[0] == pytest.approx(opt.value, rel=1e-9)
    assert opt.gain > 0.0 and opt.baseline > opt.value
    assert "frac_task1" in opt.summary()


def test_optimize_multistart_and_trajectory(plan):
    space = cap_space(["task1.cpu"], lo=0.25, hi=4.0)
    opt = plan.optimize(space=space, starts=2, max_iters=3)
    assert opt.thetas.shape[1] == 1 and len(opt.trajectory) == opt.iters
    assert np.all(np.diff(opt.trajectory) <= 1e-12)


# ------------------------------------------------------------- risk-aware ----
def test_mc_quantile_reproducible_and_equal_to_reference(plans):
    plan_j, plan_t = plans
    space = cap_space(["task1.cpu"], lo=0.5, hi=2.0)
    obj = mc_quantile(paper.mc_spec(), q=0.9, n=24, seed=5)
    a = plan_t.optimize(obj, space, max_iters=2)
    b = plan_t.optimize(obj, space, max_iters=2)
    np.testing.assert_array_equal(a.theta, b.theta)
    assert a.value == b.value and a.evals == b.evals
    np.testing.assert_array_equal(a.trajectory, b.trajectory)
    assert "p90" in a.objective and "seed=5" in a.objective
    ref = plan_j.optimize(mc_quantile_j(paper_j.mc_spec(), q=0.9, n=24, seed=5),
                          cap_space_j(["task1.cpu"], lo=0.5, hi=2.0),
                          max_iters=2)
    np.testing.assert_allclose(a.theta, ref.theta, rtol=1e-6)
    np.testing.assert_allclose(a.value, ref.value, rtol=1e-6)
    assert (a.evals, a.sweeps, a.iters) == (ref.evals, ref.sweeps, ref.iters)


# ------------------------------------------------------- guardrails & API ----
def test_pw_axis_rejected_on_mc_perturbed_key(plan):
    with pytest.raises(ValueError, match="perturb"):
        plan.optimize(mc_quantile(paper.mc_spec(), n=4), paper.fig7_space(),
                      max_iters=1)


def test_optimize_requires_space(plan):
    with pytest.raises(ValueError, match="Space"):
        plan.optimize()


def test_optimize_unknown_objective(plan):
    with pytest.raises(ValueError, match="objective"):
        plan.optimize("latency", cap_space(["task1.cpu"]))


def test_cap_space_unknown_resource(plan):
    with pytest.raises(KeyError):
        ThetaMap(plan, cap_space(["task1.gpu"]).axes)


def test_optimize_deadline(plan):
    with pytest.raises(TimeoutError):
        plan.optimize(space=cap_space(["task1.cpu"]), deadline_s=-1.0)


def test_constraints_projection_is_enforced(plan):
    space = cap_space(["task1.cpu"], lo=0.25, hi=4.0)
    opt = plan.optimize(space=space, constraints=lambda x: np.minimum(x, 1.1),
                        max_iters=4)
    assert float(opt.theta[0]) <= 1.1 + 1e-12


def test_optimize_report_summary_fields(plan):
    opt = plan.optimize(space=cap_space(["task1.cpu"]), max_iters=2)
    s = opt.summary()
    assert "task1.cpu" in s and "evals" in s and "baseline" in s


def test_default_device_is_the_card(monkeypatch):
    """A plan compiled without ``device=`` lives on the card: without one,
    ``plan.optimize`` and ``plan.mc`` never start."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper.compile_paper_plan(0.5).optimize(space=paper.fig7_space())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paper.compile_paper_plan(0.5).mc(paper.mc_spec(), n=4)


def test_front_door_exports():
    for name in ("Space", "cap_space", "mc_quantile", "optimize", "CapAxis",
                 "PwAxis", "ThetaMap", "OptimizeReport", "MCReport", "run_mc",
                 "sample_spec"):
        assert name in analysis.__all__, name
        assert hasattr(analysis, name), name
    assert optimize.OptimizeReport is analysis.OptimizeReport


def test_fill_gather_gradient_equals_gather():
    """The progress fill's gather sums its gradient over a one-hot mask (no
    atomics on a card): the same values as ``torch.gather``'s backward, on
    indices that read one source slot into several slots."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.normal(size=(3, 5, 9)), requires_grad=True)
    idx = torch.as_tensor(np.sort(rng.integers(0, 9, size=(3, 5, 8)), -1))
    w = torch.as_tensor(rng.normal(size=(3, 5, 8)))
    got = torch_engine._FillGather.apply(a, idx)
    want = torch.gather(a, -1, idx)
    assert torch.equal(got, want)
    (g1,) = torch.autograd.grad((got * w).sum(), a)
    (g2,) = torch.autograd.grad((want * w).sum(), a)
    torch.testing.assert_close(g1, g2, rtol=1e-15, atol=1e-15)
