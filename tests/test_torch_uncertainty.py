"""The port's Monte Carlo path (``plan.mc``) and its sampler against ``repro``.

* ``repro_torch.analysis.prng`` draws ``jax.random``'s threefry2x32 stream
  bit for bit (``PRNGKey``, ``fold_in``, ``bits`` with ``uint32``);
* ``sample_spec`` draws the reference's scenarios bit for bit;
* ``plan.mc`` matches at the reference's own bars
  (``tests/test_uncertainty.py``): makespans rtol 1e-9 against the port's
  numpy twin on the same draws and 1e-5 against ``repro``, SLO
  probabilities within 1.5/n, attribution probabilities within 2.5/n.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.analysis import dist as dist_j
from repro.analysis import scenarios as scenarios_j
from repro.analysis.uncertainty import sample_spec as sample_spec_j
from repro.configs import paper_workflow as paper_j
from repro_torch.analysis import dist, prng, scenarios
from repro_torch.analysis.uncertainty import mc_report_from_sweep, sample_spec
from repro_torch.configs import paper_workflow as paper
from repro_torch.core import DataDep, PPoly, Process, ResourceDep, Workflow


@pytest.fixture(scope="module")
def plans():
    return paper_j.compile_paper_plan(0.5), paper.compile_paper_plan(
        0.5, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """One link-limited download: makespan = 1000 / (10 * factor)."""
    n = 1000.0
    wf = Workflow()
    wf.add(Process("dl", data={"file": DataDep.stream(n, n)},
                   resources={"link": ResourceDep.stream(n, n)},
                   total_progress=n).identity_output(),
           resources={"link": PPoly.constant(10.0)})
    wf.set_data_input("dl", "file", PPoly.constant(n))
    return wf.compile(device="cpu")


# ------------------------------------------------------------------ prng ----
SEEDS = (0, 1, 7, 2**31 + 5)
SHAPES = ((1, 1), (2, 3), (7, 5), (10_000, 2))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_equals_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", (0, 1, 2**32 - 1))
@pytest.mark.parametrize("seed", SEEDS)
def test_prng_fold_in_and_bits_equal_jax(seed, data):
    key = prng.fold_in(prng.PRNGKey(seed), data)
    key_j = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    np.testing.assert_array_equal(key, np.asarray(key_j))
    for shape in SHAPES:
        got = prng.bits(key, shape)
        assert got.dtype == np.uint32 and got.shape == shape
        np.testing.assert_array_equal(
            got, np.asarray(jax.random.bits(key_j, shape, dtype=jnp.uint32)))


def test_prng_literal_pin():
    """Fails loudly if JAX's default key stream changes under the port."""
    want = [[3617712097, 783310428, 975722988],
            [518513098, 823833061, 3101031194]]
    np.testing.assert_array_equal(prng.PRNGKey(0), [0, 0])
    np.testing.assert_array_equal(
        prng.bits(prng.fold_in(prng.PRNGKey(0), 0), (2, 3)), want)
    np.testing.assert_array_equal(np.asarray(jax.random.bits(
        jax.random.fold_in(jax.random.PRNGKey(0), 0), (2, 3),
        dtype=jnp.uint32)), want)


# ----------------------------------------------------------- sample_spec ----
def _spec_cases(mod, dmod, pmod):
    """The same four specs built from either package."""
    return {
        "mc_spec_seed0": (pmod.mc_spec(), 64, 0),
        "mc_spec_seed11": (pmod.mc_spec(), 64, 11),
        "grid": (mod.grid({"dl1.link": [dmod.uniform(0.5, 1.0),
                                        dmod.uniform(1.5, 2.0)],
                           "task2.cpu": [0.8, 1.2]}), 30, 3),
        "dist_ramp": (mod.ramp_resource(
            "dl2", "link", [0.0, 40.0, 120.0],
            [dmod.lognormal(median=9e6, sigma=0.2), 6e6,
             dmod.triangular(1e6, 4e6, 1.2e7)]), 33, 9),
    }


@pytest.mark.parametrize("case", ["mc_spec_seed0", "mc_spec_seed11", "grid",
                                  "dist_ramp"])
def test_sample_spec_bit_identical_to_reference(plans, case):
    plan_j, plan_t = plans
    spec_j, n, seed = _spec_cases(scenarios_j, dist_j, paper_j)[case]
    spec_t, _, _ = _spec_cases(scenarios, dist, paper)[case]
    a = sample_spec_j(plan_j, spec_j, n, seed=seed)
    b = sample_spec(plan_t, spec_t, n, seed=seed)
    assert sorted(a.values) == sorted(b.values)
    for label, vals in a.values.items():
        np.testing.assert_array_equal(b.values[label], vals, err_msg=label)
    assert [ax.label for ax in a.axes] == [ax.label for ax in b.axes]
    np.testing.assert_array_equal(a.group_of, b.group_of)
    assert a.labels == b.labels and a.group_labels == b.group_labels


# ---------------------------------------------------------------- plan.mc ----
@pytest.fixture(scope="module")
def mc256(plans):
    n, seed = 256, 11
    plan_j, plan_t = plans
    samples = sample_spec(plan_t, paper.mc_spec(), n, seed=seed)
    mc_t = plan_t.mc(paper.mc_spec(), n=n, seed=seed)
    mc_np = mc_report_from_sweep(
        plan_t.sweep(plan_t.prepare(samples.scenarios), backend="numpy"),
        samples)
    mc_j = plan_j.mc(paper_j.mc_spec(), n=n, seed=seed)
    return n, mc_t, mc_np, mc_j


def test_mc_matches_numpy_twin(mc256):
    n, mc, mc_np, _ = mc256
    assert set(mc.report.backends) == {"torch"}
    np.testing.assert_allclose(mc.makespans, mc_np.makespans, rtol=1e-9)
    for q in (0.5, 0.95, 0.99):
        assert mc.quantile(q) == pytest.approx(mc_np.quantile(q), rel=1e-9)
    T = float(np.median(mc_np.makespans))
    assert mc.prob(makespan_le=T) == pytest.approx(
        mc_np.prob(makespan_le=T), abs=1.5 / n)
    want = {a.label: a.p_dominant for a in mc_np.attribution()}
    for a in mc.attribution():
        assert a.p_dominant == pytest.approx(want[a.label], abs=2.5 / n)


def test_mc_matches_reference(mc256):
    n, mc, _, mc_j = mc256
    np.testing.assert_allclose(mc.makespans, mc_j.makespans, rtol=1e-5)
    for label in mc_j.samples:
        np.testing.assert_array_equal(mc.samples[label], mc_j.samples[label])
    T = float(np.median(mc_j.makespans))
    assert mc.prob(makespan_le=T) == pytest.approx(
        mc_j.prob(makespan_le=T), abs=1.5 / n)
    want = {a.label: a.p_dominant for a in mc_j.attribution()}
    for a in mc.attribution():
        assert a.p_dominant == pytest.approx(want[a.label], abs=2.5 / n)
    got_s = {s.axis: s.s1 for s in mc.sensitivity()}
    for s in mc_j.sensitivity():
        assert got_s[s.axis] == pytest.approx(s.s1, abs=1e-6)


def test_mc_b10k_quantiles_equal_reference(plans):
    """p50 / p95 / p99 of the reference's ``plan.mc(mc_spec(), n=10_000,
    seed=0)`` (run with ``repro`` on a CPU), and its dominant factors."""
    mc = plans[1].mc(paper.mc_spec(), n=10_000, seed=0)
    q = mc.quantiles()
    np.testing.assert_allclose(
        [q["p50"], q["p95"], q["p99"]],
        [299.07836469867306, 365.39776369551555, 393.52668841248527],
        rtol=1e-5)
    dom = {a.label: a.p_dominant for a in mc.attribution()}
    for label, p in (("dl1.link", 0.5451), ("dl2.link", 0.4516),
                     ("task1.cpu", 0.0033)):
        assert dom[label] == pytest.approx(p, abs=2.5 / mc.n)


def test_same_seed_bit_identical(tiny):
    spec = scenarios.override({"dl.link": dist.lognormal(sigma=0.3)})
    a = tiny.mc(spec, n=200, seed=42)
    b = tiny.mc(spec, n=200, seed=42)
    np.testing.assert_array_equal(a.makespans, b.makespans)
    np.testing.assert_array_equal(a.report.share_seconds,
                                  b.report.share_seconds)
    c = tiny.mc(spec, n=200, seed=43)
    assert not np.array_equal(a.makespans, c.makespans)


def test_sensitivity_finds_the_driving_axis(tiny):
    spec = scenarios.override({"dl.link": dist.uniform(0.5, 2.0)},
                              data={"dl.file": dist.uniform(0.99, 1.01)})
    mc = tiny.mc(spec, n=512, seed=5)
    sens = mc.sensitivity()
    assert sens[0].axis == "dl.link" and sens[0].rho < -0.95
    assert sens[0].s1 > 0.8
    assert next(s for s in sens if s.axis == "dl.file").s1 < 0.1
    np.testing.assert_allclose(mc.makespans, 100.0 / mc.samples["dl.link"],
                               rtol=1e-9)


def test_slo_queries(tiny):
    mc = tiny.mc({"dl.link": dist.uniform(0.5, 2.0)}, n=400, seed=2)
    q95 = mc.quantile(0.95)
    assert mc.prob(makespan_le=q95) >= 0.95
    assert mc.prob(makespan_gt=q95) == pytest.approx(
        1.0 - mc.prob(makespan_le=q95))
    assert mc.quantiles() == {"p50": mc.p50, "p95": mc.p95, "p99": mc.p99}
    with pytest.raises(ValueError, match="exactly one"):
        mc.prob()


def test_dist_ramp_axes_stay_on_the_engine(tiny):
    spec = scenarios.ramp_resource("dl", "link", [0.0, 50.0],
                                   [10.0, dist.uniform(2.0, 20.0)])
    mc = tiny.mc(spec, n=32, seed=9)
    assert [a.label for a in mc.axes] == ["dl.link[t=50]"]
    assert mc.fallback_count == 0
    assert set(mc.report.backends) == {"torch"}
    assert "32 torch" in mc.summary()


# ------------------------------------------------------- validation ----
def test_sample_spec_errors(tiny, plans):
    with pytest.raises(ValueError, match="unknown process"):
        sample_spec(tiny, scenarios.override({"nope.link": dist.uniform(1, 2)}), 4)
    with pytest.raises(ValueError, match="no input"):
        sample_spec(tiny, scenarios.override({"dl.nope": dist.uniform(1, 2)}), 4)
    with pytest.raises(ValueError, match="n >= 1"):
        sample_spec(tiny, scenarios.override({"dl.link": dist.uniform(1, 2)}), 0)
    with pytest.raises(ValueError, match="empty"):
        sample_spec(tiny, [], 4)
    spec = scenarios.override(data={("task1", "video"): dist.uniform(1, 2)})
    with pytest.raises(ValueError, match="produced by"):
        sample_spec(plans[1], spec, 4)
    with pytest.deprecated_call():
        a = sample_spec(tiny, {"dl.link": dist.uniform(1, 2)}, 4, 7)
    b = sample_spec(tiny, {"dl.link": dist.uniform(1, 2)}, 4, seed=7)
    np.testing.assert_array_equal(a.values["dl.link"], b.values["dl.link"])


def test_mc_rejects_shards(tiny):
    """A shard count below 1 is refused; on the CPU any count >= 1 runs
    (the host takes the sub-batches in turn) and changes no bit."""
    with pytest.raises(ValueError, match=">= 1"):
        tiny.mc({"dl.link": dist.uniform(0.5, 2.0)}, n=8, shards=0)
    one = tiny.mc({"dl.link": dist.uniform(0.5, 2.0)}, n=8, shards=1)
    four = tiny.mc({"dl.link": dist.uniform(0.5, 2.0)}, n=8, shards=4)
    np.testing.assert_array_equal(one.makespans, four.makespans)


def test_mc_warns_once_with_rate(tiny):
    cubic = PPoly(np.array([0.0]), [np.array([0.0, 0.0, 0.0, 1e-9])])
    specs = [scenarios.override({"dl.link": dist.uniform(0.5, 2.0)},
                                label="good"),
             scenarios.override({"dl.link": dist.uniform(0.5, 2.0)},
                                data={("dl", "file"): cubic}, label="bad")]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mc = tiny.mc(specs, n=10, seed=0)
    fell = [w for w in caught if "fell off" in str(w.message)]
    assert len(fell) == 1
    assert "5/10" in str(fell[0].message) and "50.00%" in str(fell[0].message)
    assert not any("outside the batched function class" in str(w.message)
                   for w in caught)
    assert mc.fallback_count == 5 and mc.fallback_rate == pytest.approx(0.5)
    (reason, count), = mc.fallback_reasons().items()
    assert count == 5 and "degree 3" in reason and "dl.file" in reason


def test_clean_mc_summary_has_no_fallback_words(tiny):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mc = tiny.mc({"dl.link": dist.uniform(0.5, 2.0)}, n=16, seed=0)
    s = mc.summary()
    assert "0 draws off the batched quadratic class" in s
    assert "fallback" not in s and "loop" not in s
