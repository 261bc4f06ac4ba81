"""The curve-query CUDA kernels on a card: each route against the plain
version, and the "vec" route (and the first crossing's "row" route) bit for
bit against the "tile" route.

Imports no JAX and nothing of ``repro``, so that it runs on a machine with a
card and without JAX::

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_ppoly_eval_cuda.py

Every test needs the card and skips without one.  Tolerance: rtol/atol 1e-5
on values (the bar of ``tests/test_kernel_ppoly_eval.py``); argmin exactly
equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.ppoly_eval import kernel, ops, ref

RTOL = ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(seed, B, T, P, K, F, dev):
    """Seeded ragged inputs on the card: duplicate starts, padding pieces,
    absent slots (never all of a row's), queries beyond both ends."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0.0, 50.0, (B, F, P)), -1)
    starts[..., 0] = 0.0
    if P > 2:
        starts[::3, :, 2] = starts[::3, :, 1]
    n_real = rng.integers(1, P + 1, (B, F))
    starts[np.arange(P)[None, None] >= n_real[..., None]] = 1e30
    absent = rng.random((B, F)) < 0.25
    absent[:, 0] = False
    starts[absent] = 1e30
    coeffs = rng.uniform(-3.0, 3.0, (B, F, P, K))
    q = rng.uniform(-2.0, 60.0, (B, T))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)  # noqa: E731
    return t(starts), t(coeffs), t(q)


def _misaligned(x):
    """A contiguous copy of ``x`` 4 bytes past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    shift = (1 - flat.data_ptr() % 16 // 4) % 4
    out = flat[shift:shift + x.numel()].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16 == 4
    return out


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("P,K,F", [(9, 3, 2), (1, 2, 1), (16, 1, 4), (5, 3, 3)])
@pytest.mark.parametrize("B,T", [(5, 1), (7, 3), (33, 77), (9, 1025), (3, 4097),
                                 (130, 1024)])
def test_vec_route_matches_plain_and_tile(cuda, B, T, P, K, F):
    """Ragged B and T, and the same queries 4 bytes off a 16-byte boundary:
    the op takes the vec route and counts it; it agrees with the plain
    version and gives the tile route's bits."""
    starts, coeffs, q = _case(B * 7 + T, B, T, P, K, F, cuda)
    for qq in (q, _misaligned(q)):
        before = dict(kernel.launches)
        got = ops.ppoly_eval(starts[:, 0].contiguous(), coeffs[:, 0].contiguous(), qq)
        vals, arg = ops.ppoly_min_eval(starts, coeffs, qq)
        torch.cuda.synchronize()
        assert kernel.launches == {**before,
                                   "ppoly_eval": before["ppoly_eval"] + 1,
                                   "ppoly_eval_vec": before["ppoly_eval_vec"] + 1,
                                   "ppoly_min_eval": before["ppoly_min_eval"] + 1,
                                   "ppoly_min_eval_vec": before["ppoly_min_eval_vec"] + 1}
        want = ref.ppoly_eval_ref(starts[:, 0].contiguous(), coeffs[:, 0].contiguous(), qq)
        v_r, a_r = ref.ppoly_min_eval_ref(starts, coeffs, qq)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(vals, v_r, rtol=RTOL, atol=ATOL)
        assert torch.equal(arg, a_r)
        tile = kernel.launch_eval("tile", starts[:, 0].contiguous(),
                                  coeffs[:, 0].contiguous(), qq)
        t_vals, t_arg = kernel.launch_min_eval("tile", starts, coeffs, qq)
        torch.cuda.synchronize()
        assert _same_bits(got, tile)
        assert _same_bits(vals, t_vals) and torch.equal(arg, t_arg)


@pytest.mark.requires_cuda
def test_main_path_shape_takes_the_vec_route(cuda):
    """B = 10,000, T = 1024, P = 9, K = 3, F = 2, as the Report gives them."""
    starts, coeffs, q = _case(16, 10_000, 1024, 9, 3, 2, cuda)
    kernel.reset_launches()
    got = ops.ppoly_eval(starts[:, 0].contiguous(), coeffs[:, 0].contiguous(), q)
    vals, arg = ops.ppoly_min_eval(starts, coeffs, q)
    torch.cuda.synchronize()
    assert kernel.launches["ppoly_eval_vec"] == kernel.launches["ppoly_eval"] == 1
    assert kernel.launches["ppoly_min_eval_vec"] == kernel.launches["ppoly_min_eval"] == 1
    assert _same_bits(got, kernel.launch_eval("tile", starts[:, 0].contiguous(),
                                              coeffs[:, 0].contiguous(), q))
    t_vals, t_arg = kernel.launch_min_eval("tile", starts, coeffs, q)
    assert _same_bits(vals, t_vals) and torch.equal(arg, t_arg)
    torch.testing.assert_close(vals, ref.ppoly_min_eval_ref(starts, coeffs, q)[0],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("P,K,F", [(17, 1, 1), (64, 3, 2), (9, 3, 6)])
def test_shapes_outside_the_vec_kernels_take_the_tile_route(cuda, P, K, F):
    starts, coeffs, q = _case(P + F, 21, 300, P, K, F, cuda)
    s1, c1 = starts[:, 0].contiguous(), coeffs[:, 0].contiguous()
    before = dict(kernel.launches)
    vals, arg = ops.ppoly_min_eval(starts, coeffs, q)
    got = ops.ppoly_eval(s1, c1, q)
    torch.cuda.synchronize()
    assert kernel.launches["ppoly_min_eval_tile"] == before["ppoly_min_eval_tile"] + 1
    rt = kernel.route(P, K)
    assert kernel.launches[f"ppoly_eval_{rt}"] == before[f"ppoly_eval_{rt}"] + 1
    torch.testing.assert_close(got, ref.ppoly_eval_ref(s1, c1, q), rtol=RTOL, atol=ATOL)
    v_r, a_r = ref.ppoly_min_eval_ref(starts, coeffs, q)
    torch.testing.assert_close(vals, v_r, rtol=RTOL, atol=ATOL)
    assert torch.equal(arg, a_r)
    with pytest.raises(ValueError, match="vec route takes"):
        kernel.launch_min_eval("vec", starts, coeffs, q)


# ------------------------------------------------------ the first crossing ----
def _crossing_case(seed, B, T, P, K, dev):
    """Seeded monotone rows of degree < K: duplicate starts, padding pieces,
    non-negative slopes and curvature, each piece starting at or above the
    previous one's end (upward jumps), and levels from below the first value
    to above the last real piece's start value (never reached in the odd
    rows, whose last real piece is flat)."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0.0, 50.0, (B, P)), -1)
    starts[:, 0] = rng.uniform(-2.0, 0.0, B)
    if P > 2:
        starts[::3, 2] = starts[::3, 1]
    n_real = rng.integers(1, P + 1, B)
    real = np.arange(P)[None] < n_real[:, None]
    starts[~real] = 1e30
    coeffs = np.zeros((B, P, K))
    if K > 1:
        coeffs[..., 1] = np.where(rng.random((B, P)) < 0.8,
                                  rng.uniform(0.0, 3.0, (B, P)), 0.0)
    if K > 2:
        coeffs[..., 2] = np.where(rng.random((B, P)) < 0.5,
                                  rng.uniform(0.0, 0.3, (B, P)), 0.0)
    coeffs[1::2, :, 1:] *= (np.arange(P) != n_real[1::2, None] - 1)[..., None]
    jumps = np.where(rng.random((B, P)) < 0.3, rng.uniform(0.0, 20.0, (B, P)), 0.0)
    coeffs[:, 0, 0] = rng.uniform(-5.0, 5.0, B)
    for p in range(P - 1):
        ln = np.where(real[:, p + 1], starts[:, p + 1] - starts[:, p], 0.0)
        c = coeffs[:, p]
        end = c[:, 0] + (c[:, 1] * ln if K > 1 else 0.0) + (c[:, 2] * ln * ln if K > 2 else 0.0)
        coeffs[:, p + 1, 0] = end + jumps[:, p]
    last = coeffs[np.arange(B), n_real - 1, 0]
    y = rng.uniform(-0.1, 1.5, (B, T)) * (np.abs(last)[:, None] + 1.0)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)  # noqa: E731
    return t(starts), t(coeffs), t(y)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("P,K", [(9, 3), (1, 2), (16, 1), (5, 3), (12, 2)])
@pytest.mark.parametrize("B,T", [(1, 1), (5, 1), (10_000, 1), (37, 3), (129, 16),
                                 (33, 17), (20, 32), (20, 129), (9, 1025), (3, 4097),
                                 (130, 1024)])
def test_crossing_routes_match_plain_and_tile(cuda, B, T, P, K):
    """Ragged B and T, and the same levels 4 bytes off a 16-byte boundary:
    the op takes the route ``kernel.crossing_route`` names and counts it;
    both routes agree with the plain version, and the row route (which
    takes any T) gives the tile route's bits."""
    starts, coeffs, y = _crossing_case(B * 7 + T + P, B, T, P, K, cuda)
    want_rt = kernel.crossing_route(P, K, T)
    for yy in (y, _misaligned(y)) if T > 1 else (y,):
        before = dict(kernel.launches)
        got = ops.ppoly_first_crossing(starts, coeffs, yy)
        torch.cuda.synchronize()
        assert kernel.launches == {
            **before, "ppoly_first_crossing": before["ppoly_first_crossing"] + 1,
            f"ppoly_first_crossing_{want_rt}":
                before[f"ppoly_first_crossing_{want_rt}"] + 1}
        want = ref.ppoly_first_crossing_ref(starts, coeffs, yy)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        tile = kernel.launch_crossing("tile", starts, coeffs, yy)
        row = kernel.launch_crossing("row", starts, coeffs, yy)
        torch.cuda.synchronize()
        assert _same_bits(row, tile)
        assert _same_bits(got, tile)
        assert bool((got >= 1e30).any()) or B * T < 40


@pytest.mark.requires_cuda
def test_crossing_main_path_shape_takes_the_row_route(cuda):
    """B = 10,000, T = 1, P = 9, K = 3, as kernel_finish_times gives them."""
    starts, coeffs, y = _crossing_case(17, 10_000, 1, 9, 3, cuda)
    kernel.reset_launches()
    got = ops.ppoly_first_crossing(starts, coeffs, y)
    torch.cuda.synchronize()
    assert kernel.launches["ppoly_first_crossing_row"] == 1
    assert kernel.launches["ppoly_first_crossing"] == 1
    assert _same_bits(got, kernel.launch_crossing("tile", starts, coeffs, y))
    torch.testing.assert_close(got, ref.ppoly_first_crossing_ref(starts, coeffs, y),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("T", [1, 1024])
def test_crossing_beyond_16_pieces_takes_the_tile_route(cuda, T):
    starts, coeffs, y = _crossing_case(T, 21, T, 17, 3, cuda)
    before = dict(kernel.launches)
    got = ops.ppoly_first_crossing(starts, coeffs, y)
    torch.cuda.synchronize()
    assert (kernel.launches["ppoly_first_crossing_tile"]
            == before["ppoly_first_crossing_tile"] + 1)
    torch.testing.assert_close(got, ref.ppoly_first_crossing_ref(starts, coeffs, y),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="the row route takes"):
        kernel.launch_crossing("row", starts, coeffs, y)
