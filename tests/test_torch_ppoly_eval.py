"""The torch port's curve-query ops against the reference package's.

The same numpy-seeded inputs go through ``repro.kernels.ppoly_eval`` (its
plain jnp versions, ``use_pallas=False``, and at the analysis path's shapes
also its Pallas kernels in interpret mode) and
``repro_torch.kernels.ppoly_eval`` (CPU tensors take the plain torch
versions).  Tolerance: rtol/atol 1e-5 on values, as in
``tests/test_kernel_ppoly_eval.py``; argmin exactly equal.

The CUDA kernels themselves are held against the plain torch versions by
the ``requires_cuda`` tests at the end and in
``tests/test_torch_ppoly_eval_cuda.py`` (which imports no JAX, so that it
runs on a machine with a card); both skip without a card.
"""

import numpy as np
import pytest
import torch

from repro.core import PPoly as RefPPoly
from repro.kernels import ppoly_eval as ref_ops
from repro_torch.core import PPoly
from repro_torch.kernels import ppoly_eval as ops
from repro_torch.kernels.ppoly_eval import kernel

RTOL = ATOL = 1e-5


def _random_ppolys(rng, n, max_pieces=6, max_deg=3):
    fns = []
    for _ in range(n):
        np_pieces = rng.integers(1, max_pieces + 1)
        starts = np.concatenate([[0.0], np.sort(rng.uniform(0.5, 50.0, np_pieces - 1))])
        deg = int(rng.integers(0, max_deg + 1))
        coeffs = [rng.uniform(-3, 3, rng.integers(1, deg + 2)) for _ in range(np_pieces)]
        fns.append(PPoly(starts, coeffs))
    return fns


def _random_monotone(rng, n_pieces, quad=True, jumps=True):
    """Monotone nondecreasing piecewise function of degree <= 2, possibly
    with upward jumps between pieces."""
    xs = np.concatenate([[0.0], np.sort(rng.uniform(1.0, 50.0, n_pieces - 1))])
    coeffs, val = [], float(rng.uniform(0, 5))
    for i in range(n_pieces):
        ln = (xs[i + 1] - xs[i]) if i + 1 < n_pieces else 10.0
        c1 = float(rng.uniform(0, 5)) if rng.random() < 0.8 else 0.0
        c2 = float(rng.uniform(0, 0.5)) if quad and rng.random() < 0.6 else 0.0
        coeffs.append([val, c1, c2])
        val = val + c1 * ln + c2 * ln * ln
        if jumps and rng.random() < 0.3:
            val += float(rng.uniform(1, 20))
    # a flat tail: levels above its value are never reached
    return PPoly(np.append(xs, 55.0), coeffs + [[val]])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ ppoly_eval ----
@pytest.mark.parametrize("n_fns,n_q", [(1, 7), (4, 64), (13, 200), (32, 128)])
def test_eval_matches_reference(n_fns, n_q):
    rng = np.random.default_rng(n_fns * 100 + n_q)
    starts, coeffs = ops.pack_ppolys_np(_random_ppolys(rng, n_fns))
    q = rng.uniform(-1.0, 60.0, (n_fns, n_q)).astype(np.float32)
    got = ops.ppoly_eval(torch.from_numpy(starts), torch.from_numpy(coeffs),
                         torch.from_numpy(q))
    want = ref_ops.ppoly_eval(starts, coeffs, q, use_pallas=False)
    assert got.dtype == torch.float32 and got.shape == (n_fns, n_q)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_eval_matches_exact_ppoly():
    rng = np.random.default_rng(5)
    fns = _random_ppolys(rng, 9)
    starts, coeffs = ops.pack_ppolys_np(fns)
    q = rng.uniform(-1.0, 60.0, (9, 50)).astype(np.float32)
    out = _np(ops.ppoly_eval(starts, coeffs, q))
    exact = np.stack([f(q[i].astype(np.float64)) for i, f in enumerate(fns)])
    assert np.all(np.abs(out - exact) / np.maximum(1.0, np.abs(exact)) < 5e-4)


def test_eval_padding_rows_and_duplicate_starts():
    """All-padding rows and repeated starts (jumps) resolve as in the
    reference: the count of ``start <= t`` picks the LAST duplicate."""
    rng = np.random.default_rng(3)
    starts = np.full((4, 5), 1e30, np.float32)
    coeffs = rng.uniform(-2, 2, (4, 5, 3)).astype(np.float32)
    starts[0, :3] = [0.0, 5.0, 5.0]           # duplicate start
    starts[1, :1] = [2.0]                     # single piece, queries before it
    starts[3, :5] = [0.0, 1.0, 1.0, 1.0, 9.0]
    q = np.array([[-1.0, 0.0, 5.0, 7.5],
                  [0.0, 1.0, 2.0, 3.0],
                  [0.0, 1.0, 2.0, 3.0],      # row 2: padding only
                  [0.5, 1.0, 8.9, 9.0]], np.float32)
    got = _np(ops.ppoly_eval(starts, coeffs, q))
    want = np.asarray(ref_ops.ppoly_eval(starts, coeffs, q, use_pallas=False))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -------------------------------------------------------- ppoly_min_eval ----
@pytest.mark.parametrize("seed,B,F,T", [(0, 3, 3, 32), (1, 5, 4, 130),
                                        (2, 9, 6, 77)])
def test_min_eval_matches_reference(seed, B, F, T):
    rng = np.random.default_rng(seed)
    rows = [_random_ppolys(rng, F, max_pieces=5, max_deg=2) for _ in range(B)]
    for i in range(0, B, 2):                 # ragged rows: absent slots
        k = int(rng.integers(1, F + 1))
        rows[i] = rows[i][:k] + [None] * (F - k)
    rows[-1] = [None] * F                    # a row with every slot absent
    starts, coeffs = ops.pack_ppoly_grid(rows)
    q = rng.uniform(-2.0, 60.0, (B, T)).astype(np.float32)
    v_t, a_t = ops.ppoly_min_eval(starts, coeffs, q)
    v_r, a_r = ref_ops.ppoly_min_eval(starts, coeffs, q, use_pallas=False)
    assert a_t.dtype == torch.int32
    np.testing.assert_allclose(_np(v_t), np.asarray(v_r), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_np(a_t), np.asarray(a_r))


def test_min_eval_ties_keep_lowest_slot():
    f = PPoly.pwlinear([0.0, 10.0], [0.0, 10.0])
    starts, coeffs = ops.pack_ppoly_grid([[None, f, f, f]])
    q = np.linspace(0.0, 12.0, 7, dtype=np.float32)[None]
    vals, arg = ops.ppoly_min_eval(starts, coeffs, q)
    v_r, a_r = ref_ops.ppoly_min_eval(starts, coeffs, q, use_pallas=False)
    assert np.all(_np(arg) == 1)
    np.testing.assert_array_equal(_np(arg), np.asarray(a_r))
    np.testing.assert_allclose(_np(vals), np.asarray(v_r), rtol=RTOL, atol=ATOL)


# -------------------------------------------------- ppoly_first_crossing ----
def test_first_crossing_linear_and_never_reached():
    fns = [PPoly.pwlinear([0.0, 10.0, 20.0], [0.0, 5.0, 30.0]),
           PPoly.step([0.0, 7.0], [0.0, 9.0]),
           PPoly.pwlinear([0.0, 4.0], [1.0, 1.0])]  # flat: most levels unreachable
    starts, coeffs = ops.pack_ppolys_np(fns)
    y = np.array([[0.0, 4.0, 17.0, 30.0],
                  [0.0, 5.0, 9.0, 10.0],
                  [0.5, 1.0, 2.0, 50.0]], np.float32)
    got = _np(ops.ppoly_first_crossing(starts, coeffs, y))
    want = np.asarray(ref_ops.ppoly_first_crossing(starts, coeffs, y,
                                                   use_pallas=False))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[2, 3] >= 1e30 and got[1, 3] >= 1e30


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_crossing_quadratic_matches_reference(seed):
    rng = np.random.default_rng(seed)
    fns = [_random_monotone(rng, int(rng.integers(1, 7))) for _ in range(11)]
    starts, coeffs = ops.pack_ppolys_np(fns, max_coef=3)
    hi = np.array([f(np.array([60.0]))[0] for f in fns])
    y = (rng.uniform(-0.2, 1.3, (11, 40)) * hi[:, None]).astype(np.float32)
    got = _np(ops.ppoly_first_crossing(starts, coeffs, y))
    want = np.asarray(ref_ops.ppoly_first_crossing(starts, coeffs, y,
                                                   use_pallas=False))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got >= 1e30).any()               # some levels are never reached


def test_first_crossing_rejects_high_degree():
    f = PPoly(np.array([0.0]), [np.array([0.0, 1.0, 1.0, 1.0])])  # cubic
    starts, coeffs = ops.pack_ppolys_np([f])
    with pytest.raises(ValueError, match="degree <= 2"):
        ops.ppoly_first_crossing(starts, coeffs, np.zeros((1, 1), np.float32))


def test_packers_match_reference():
    rng = np.random.default_rng(9)
    fns = _random_ppolys(rng, 5)
    ref_fns = [RefPPoly(f.starts, f.coeffs) for f in fns]
    for a, b in zip(ops.pack_ppolys_np(fns), ref_ops.pack_ppolys_np(ref_fns)):
        np.testing.assert_array_equal(a, b)
    grid = [[fns[0], None], [fns[1], fns[2]]]
    ref_grid = [[ref_fns[0], None], [ref_fns[1], ref_fns[2]]]
    for a, b in zip(ops.pack_ppoly_grid(grid), ref_ops.pack_ppoly_grid(ref_grid)):
        np.testing.assert_array_equal(a, np.asarray(b))
    planes = [rng.uniform(size=(3, 4)) for _ in range(3)]
    for a, b in zip(ops.pack_bpl_np(*planes), ref_ops.pack_bpl_np(*planes)):
        np.testing.assert_array_equal(a, b)


def test_cpu_tensors_never_launch_a_kernel():
    kernel.reset_launches()
    starts, coeffs = ops.pack_ppolys_np(_random_ppolys(np.random.default_rng(1), 3))
    ops.ppoly_eval(starts, coeffs, np.zeros((3, 4), np.float32))
    assert kernel.launches == {
        "ppoly_eval": 0, "ppoly_eval_vec": 0, "ppoly_eval_tile": 0,
        "ppoly_min_eval": 0, "ppoly_min_eval_vec": 0, "ppoly_min_eval_tile": 0,
        "ppoly_first_crossing": 0, "ppoly_first_crossing_row": 0,
        "ppoly_first_crossing_tile": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    z = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.ppoly_eval_cuda(z, torch.zeros((2, 3, 2)), z)


@pytest.mark.parametrize("launch,args", [
    ("launch_eval", ((2, 3), (2, 3, 2), (2, 5))),
    ("launch_min_eval", ((2, 2, 3), (2, 2, 3, 2), (2, 5))),
])
@pytest.mark.parametrize("rt", kernel.ROUTES)
def test_route_launchers_refuse_cpu_tensors(monkeypatch, launch, args, rt):
    """Each route's launcher refuses CPU tensors before it builds or loads
    the library, and counts nothing."""
    monkeypatch.setattr(kernel, "_lib", None)
    before = dict(kernel.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        getattr(kernel, launch)(rt, *(torch.zeros(a) for a in args))
    assert kernel._lib is None and kernel.launches == before


# ------------------------------------------------------ routes by shape ----
@pytest.mark.parametrize("P,K,F,want", [
    (9, 3, 1, "vec"),      # sample_progress on the analysis path
    (9, 3, 2, "vec"),      # data_ceiling of task3
    (1, 2, 1, "vec"),      # data_ceiling of dl1 / dl2
    (10, 3, 1, "vec"),
    (16, 3, 4, "vec"),     # the largest shape the vec kernels take
    (1, 1, 1, "vec"),
    (17, 1, 1, "tile"),
    (64, 3, 1, "tile"),
    (9, 4, 1, "tile"),
    (9, 3, 5, "tile"),
    (40, 2, 6, "tile"),
])
def test_route_is_a_function_of_the_shape(P, K, F, want):
    assert kernel.route(P, K, F) == want
    if F == 1:
        assert kernel.route(P, K) == want
    assert want in kernel.ROUTES


@pytest.mark.parametrize("P,K,T,want", [
    (9, 3, 1, "row"),      # kernel_finish_times on the analysis path
    (9, 2, 1, "row"),
    (1, 1, 1, "row"),
    (16, 3, 1, "row"),     # the most pieces the row route takes
    (16, 3, kernel.ROW_MAX_T, "row"),
    (9, 3, kernel.ROW_MAX_T + 1, "tile"),
    (1, 1, kernel.ROW_MAX_T, "row"),
    (1, 1, kernel.ROW_MAX_T + 1, "tile"),
    (9, 3, 1024, "tile"),
    (1, 2, 4097, "tile"),
    (17, 3, 1, "tile"),
    (17, 1, 1024, "tile"),
    (64, 2, 1, "tile"),
])
def test_crossing_route_is_a_function_of_the_shape(P, K, T, want):
    assert kernel.ROW_MAX_T == 16
    assert kernel.crossing_route(P, K, T) == want
    assert want in kernel.CROSSING_ROUTES


# --------------------------------- the analysis path's shapes, scaled in B ----
def _main_path_case(rng, B, T=1024, P=9, K=3, F=2):
    """As the Report's queries give them: P = 9 pieces of K = 3 coefficients
    (quadratic progress under ramped allocations), F = 2 ceiling slots;
    padding pieces, duplicate starts (jumps), an absent slot in every third
    row, queries on one ``linspace`` past the last start."""
    starts = np.sort(rng.uniform(0.0, 200.0, (B, F, P)), -1)
    starts[..., 0] = 0.0
    starts[::2, :, 3] = starts[::2, :, 2]           # duplicate starts
    n_real = rng.integers(2, P + 1, (B, F))
    starts[np.arange(P)[None, None] >= n_real[..., None]] = 1e30
    starts[::3, 1] = 1e30                             # absent slot
    coeffs = np.zeros((B, F, P, K))
    coeffs[..., 0] = np.cumsum(rng.uniform(0.0, 50.0, (B, F, P)), -1)
    coeffs[..., 1] = rng.uniform(0.0, 3.0, (B, F, P))
    coeffs[..., 2] = np.where(rng.random((B, F, P)) < 0.5,
                              rng.uniform(0.0, 0.05, (B, F, P)), 0.0)
    q = np.broadcast_to(np.linspace(0.0, 300.0, T), (B, T))
    return (starts.astype(np.float32), coeffs.astype(np.float32),
            np.ascontiguousarray(q, np.float32))


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas_interpret"])
def test_eval_matches_reference_at_main_path_shape(pallas):
    starts, coeffs, q = _main_path_case(np.random.default_rng(16), B=16)
    s, c = starts[:, 0], coeffs[:, 0]
    got = ops.ppoly_eval(torch.from_numpy(s), torch.from_numpy(c),
                         torch.from_numpy(q))
    want = ref_ops.ppoly_eval(s, c, q, use_pallas=pallas,
                              interpret=True if pallas else None)
    assert got.shape == (16, 1024) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas_interpret"])
def test_min_eval_matches_reference_at_main_path_shape(pallas):
    starts, coeffs, q = _main_path_case(np.random.default_rng(17), B=16)
    v_t, a_t = ops.ppoly_min_eval(torch.from_numpy(starts),
                                  torch.from_numpy(coeffs), torch.from_numpy(q))
    v_r, a_r = ref_ops.ppoly_min_eval(starts, coeffs, q, use_pallas=pallas,
                                      interpret=True if pallas else None)
    assert v_t.shape == a_t.shape == (16, 1024) and a_t.dtype == torch.int32
    np.testing.assert_allclose(_np(v_t), np.asarray(v_r), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(_np(a_t), np.asarray(a_r))
    assert (_np(a_t)[::3] == 0).all() and (_np(a_t) == 1).any()


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas_interpret"])
def test_first_crossing_matches_reference_at_main_path_shape(pallas):
    """B = 10,000, T = 1, P = 9, K = 3: the call of kernel_finish_times,
    with levels from below the first value to above the last real piece's
    start value."""
    B = 10_000
    rng = np.random.default_rng(18)
    starts, coeffs, _q = _main_path_case(rng, B=B, T=1)
    s, c = starts[:, 0], coeffs[:, 0]
    top = c[..., 0].max(-1)
    y = (rng.uniform(-0.1, 1.3, (B, 1)) * top[:, None]).astype(np.float32)
    got = ops.ppoly_first_crossing(torch.from_numpy(s), torch.from_numpy(c),
                                   torch.from_numpy(y))
    want = ref_ops.ppoly_first_crossing(s, c, y, use_pallas=pallas,
                                        interpret=True if pallas else None)
    assert got.shape == (B, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert (_np(got) == s[:, :1]).any()      # levels at or below f(start)


def _crossing_edge_case(rng, B, P=8, T=6):
    """Seeded monotone rows of degree <= 2 with the edges a crossing meets:
    duplicate starts (upward jumps), padding pieces, flat pieces, concave
    pieces (c2 < 0) whose vertex lies below some levels, so that the
    discriminant there is negative, and a flat last piece in every other
    row; levels below f at the first start, at piece values (jumps), inside
    the range and above it (never reached).  A concave piece's vertex lies
    half its length past its end, so it still rises there at a third of its
    first slope: no level meets a piece at a tangent, where a float32
    crossing time is ill-conditioned and the two packages' roundings of the
    discriminant (the reference's compiler may fuse its multiply and add)
    can fall on either side of 0."""
    starts = np.full((B, P), 1e30)
    coeffs = np.zeros((B, P, 3))
    y = np.zeros((B, T))
    for b in range(B):
        n = int(rng.integers(1, P + 1))
        xs = np.sort(rng.uniform(-5.0, 40.0, n))
        if n > 2 and rng.random() < 0.5:
            xs[2] = xs[1]                     # duplicate start: a jump
        val = float(rng.uniform(-5.0, 5.0))
        for i in range(n):
            ln = xs[i + 1] - xs[i] if i + 1 < n else None
            kind = rng.choice(["flat", "linear", "convex", "concave"])
            if ln is None:                    # the last piece rises forever, or is flat
                kind = "flat" if b % 2 else rng.choice(["linear", "convex"])
            if kind == "concave" and ln > 0:
                a = float(rng.uniform(0.01, 0.5))
                c1, c2 = 3.0 * a * ln, -a     # vertex at 1.5 ln
            else:
                c1 = 0.0 if kind in ("flat", "concave") else float(rng.uniform(0.1, 4.0))
                c2 = float(rng.uniform(0.01, 0.3)) if kind == "convex" else 0.0
            starts[b, i] = xs[i]
            coeffs[b, i] = val, c1, c2
            if ln is not None:
                val += c1 * ln + c2 * ln * ln
                if rng.random() < 0.3:
                    val += float(rng.uniform(0.5, 10.0))   # upward jump
        c0 = coeffs[b, :n, 0]
        y[b] = [c0[0] - rng.uniform(0.1, 5.0), c0[rng.integers(n)],
                rng.uniform(c0[0], val + 1.0), rng.uniform(c0[0], val + 1.0),
                val + rng.uniform(1.0, 50.0), val]
    return (starts.astype(np.float32), coeffs.astype(np.float32),
            y.astype(np.float32))


@pytest.mark.parametrize("pallas", [False, True], ids=["jnp", "pallas_interpret"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_crossing_edge_cases_match_reference(seed, pallas):
    starts, coeffs, y = _crossing_edge_case(np.random.default_rng(seed), B=40)
    c0, c1, c2 = (coeffs[:, None, :, k] for k in range(3))
    disc = c1 * c1 - 4.0 * c2 * (c0 - y[:, :, None])          # (B, T, P)
    assert ((disc < 0) & (c2 != 0) & (starts < 5e29)[:, None, :]).any()
    got = _np(ops.ppoly_first_crossing(starts, coeffs, y))
    want = np.asarray(ref_ops.ppoly_first_crossing(
        starts, coeffs, y, use_pallas=pallas, interpret=True if pallas else None))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert (got >= 1e30).any() and (got < 1e30).any()
    np.testing.assert_array_equal(got[:, 0], starts[:, 0])   # below f(start)


# ------------------------------------------------- CUDA kernels on a card ----
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ragged_case(rng, B, F, P, K, T):
    starts = np.sort(rng.uniform(0.0, 50.0, (B, F, P)), -1).astype(np.float32)
    starts[..., 0] = 0.0
    n_real = rng.integers(1, P + 1, (B, F))
    for b in range(B):
        for f in range(F):
            starts[b, f, n_real[b, f]:] = 1e30
    starts[rng.random((B, F)) < 0.2, :] = 1e30          # absent slots
    coeffs = rng.uniform(0.0, 3.0, (B, F, P, K)).astype(np.float32)
    q = rng.uniform(-2.0, 60.0, (B, T)).astype(np.float32)
    return starts, coeffs, q


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed,B,T,P,K", [(0, 13, 200, 7, 1), (1, 37, 129, 64, 3),
                                          (2, 5, 1000, 3, 2)])
def test_cuda_kernels_match_plain(cuda, seed, B, T, P, K):
    rng = np.random.default_rng(seed)
    F = int(rng.integers(1, 7))
    s3, c4, q = _ragged_case(rng, B, F, P, K, T)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    got = kernel.ppoly_eval_cuda(dev(s3[:, 0]), dev(c4[:, 0]), dev(q))
    want = ops.ppoly_eval_ref(dev(s3[:, 0]), dev(c4[:, 0]), dev(q))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    v, a = kernel.ppoly_min_eval_cuda(dev(s3), dev(c4), dev(q))
    v_r, a_r = ops.ppoly_min_eval_ref(dev(s3), dev(c4), dev(q))
    torch.testing.assert_close(v, v_r, rtol=RTOL, atol=ATOL)
    assert torch.equal(a, a_r)
    c3 = c4[:, 0, :, :min(K, 3)]
    cross = kernel.ppoly_first_crossing_cuda(dev(s3[:, 0]), dev(c3), dev(q))
    cross_r = ops.ppoly_first_crossing_ref(dev(s3[:, 0]), dev(c3), dev(q))
    torch.testing.assert_close(cross, cross_r, rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()
