"""``PPoly.minimum``'s attribution in the torch port, held against a pointwise
brute force.

The port names, on every segment, a function that attains the minimum
there, also after ties: ``_min2`` cuts the running minimum at its own
attribution switches.  The reference package's ``PPoly.minimum`` can lose
such a switch when a later function ties the minimum over the whole span,
so at ties the port deliberately differs from it, and these tests hold the
port against the functions' own values rather than against the reference.
"""

import numpy as np
import pytest

from repro_torch.core import PPoly

VAL_TOL = 1e-9


def _labels_at(seg, ts):
    """The function each segment names, at each of ``ts``."""
    lab = np.full(ts.shape, seg[0][1])
    for s, who in seg:
        lab[ts >= s] = who
    return lab


def _assert_attains_min(fns, ts):
    m, seg = PPoly.minimum(fns)
    vals = np.stack([f(ts) for f in fns])
    low = vals.min(0)
    named = vals[_labels_at(seg, ts), np.arange(ts.size)]
    np.testing.assert_allclose(named, low, atol=VAL_TOL)
    np.testing.assert_allclose(m(ts), low, atol=VAL_TOL)
    return seg


def _midpoints(seg, end):
    starts = [float(s) for s, _ in seg] + [end]
    return np.array([(a + b) * 0.5 for a, b in zip(starts[:-1], starts[1:])])


def test_minimum_tie_counterexample_against_brute_force():
    f0 = PPoly.pwlinear([0, 1, 1.5, 2, 3, 4], [0, 0, 0, 0, 0, 1])
    f1 = PPoly.pwlinear([0, 1, 2], [0, 0, 0])
    f2 = PPoly.pwlinear([0, 1, 7], [0, 0, 0])
    seg = _assert_attains_min([f0, f1, f2], np.linspace(0.0, 12.0, 4801))
    # f0 rises from t = 4 on, where f1 and f2 stay at 0: f0 must not be
    # named past it
    assert all(who != 0 for s, who in seg if s >= 4.0)
    assert float(f0(np.array([3.5]))[0]) == 0.5


@pytest.mark.parametrize("seed", range(8))
def test_minimum_names_a_minimiser_under_forced_ties(seed):
    """Random piecewise-linear families on a coarse grid of knots and values,
    so that functions tie over whole spans: at every segment's midpoint, and
    on a fine grid, the named function attains the minimum."""
    rng = np.random.default_rng(seed)
    knots = np.arange(0.0, 8.5, 0.5)
    for _ in range(40):
        fns = []
        for _f in range(int(rng.integers(2, 5))):
            n = int(rng.integers(2, 7))
            xs = np.concatenate([[0.0], np.sort(rng.choice(knots[1:], n - 1,
                                                           replace=False))])
            ys = rng.integers(0, 3, n).astype(float)
            fns.append(PPoly.pwlinear(xs, ys))
        if rng.random() < 0.5:                  # an exact copy ties everywhere
            fns.insert(int(rng.integers(0, len(fns) + 1)),
                       fns[int(rng.integers(0, len(fns)))])
        seg = _assert_attains_min(fns, np.linspace(0.0, 10.0, 2001))
        mids = _midpoints(seg, 12.0)
        vals = np.stack([f(mids) for f in fns])
        named = vals[[who for _s, who in seg], np.arange(mids.size)]
        np.testing.assert_allclose(named, vals.min(0), atol=VAL_TOL)
