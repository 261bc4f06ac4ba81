"""The torch port's wkv6 (RWKV-6 recurrence) against the reference package's.

The same numpy-seeded r, k, v, w, u and s0 go through the reference's
``repro.models.rwkv.wkv_recurrent_ref`` / ``wkv_chunked`` (float32) and its
Pallas kernel in interpret mode, and through the port's plain versions and
its ``wkv6`` op (a CPU tensor takes the plain chunked version).

Bars, on y and on the final state: max abs error <= 2e-3 (the bar of
``tests/test_kernel_wkv6.py``) and relative L2 error <= 1e-4.  Summation
order alone moves small elements by up to about 7e-4 when |y| reaches 90,
so an elementwise rtol would measure the order, not the algorithm; the
relative L2 bar holds the whole output 10x above the differences seen
(5e-6 to 1e-5).

The CUDA kernels are held against the plain version by the ``requires_cuda``
test in ``tests/test_torch_isolation.py``, which imports no JAX and so also
runs on a machine with a card; it skips without one.  Here the CUDA chunked
route's arithmetic (phase 1 per chunk, the state scan, 16-token sub-chunks,
3xTF32 products) is held on the CPU through its plain version
``wkv_two_phase_ref``, at the same bars.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6 import wkv6 as jax_wkv6
from repro.models.rwkv import wkv_chunked as jax_wkv_chunked
from repro.models.rwkv import wkv_recurrent_ref as jax_wkv_recurrent
from repro_torch.kernels.wkv6 import kernel, precision, wkv6, wkv_chunked_ref, wkv_recurrent_ref
from repro_torch.kernels.wkv6.ref import wkv_two_phase_ref
from repro_torch.models import rwkv

MAX_ABS = 2e-3
REL_L2 = 1e-4


def _inputs(seed, B, L, H, N, decay_scale=2.0):
    """As the reference's tests make them: w = exp(-exp(scale * normal))."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, L, H, N)).astype(np.float32) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, L, H, N)) * decay_scale)).astype(np.float32)
    u = (0.1 * rng.standard_normal((H, N))).astype(np.float32)
    s0 = (0.2 * rng.standard_normal((B, H, N, N))).astype(np.float32)
    return r, k, v, w, u, s0


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() if got.size else 0.0
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= MAX_ABS, f"{what}: max abs {err}"
    assert rel <= REL_L2, f"{what}: relative L2 {rel}"


def _torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# the cases of tests/test_models.py and tests/test_moe_variants.py
CHUNKED_CASES = [(31, 32), (64, 32), (70, 16), (128, 64), (70, 64)]


@pytest.mark.parametrize("L,chunk", CHUNKED_CASES)
def test_chunked_ref_matches_reference(L, chunk):
    a = _inputs(L, 2, L, 3, 8)
    yw, sw = jax_wkv_chunked(*_jax(a), chunk=chunk)
    y, s = wkv_chunked_ref(*_torch(a), chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    _close(y, yw, "y")
    _close(s, sw, "s_final")


@pytest.mark.parametrize("L", [1, 31, 70])
def test_recurrent_ref_matches_reference(L):
    a = _inputs(L + 1, 2, L, 3, 8)
    yw, sw = jax_wkv_recurrent(*_jax(a))
    y, s = wkv_recurrent_ref(*_torch(a))
    _close(y, yw, "y")
    _close(s, sw, "s_final")


@pytest.mark.parametrize("L,chunk,scale", [(31, 32, 2.0), (70, 16, 2.0),
                                           (128, 64, 2.0), (64, 32, 3.5)])
def test_chunked_ref_matches_recurrent(L, chunk, scale):
    """The port's two plain versions agree with each other."""
    a = _torch(_inputs(L + 2, 2, L, 3, 8, scale))
    y, s = wkv_chunked_ref(*a, chunk=chunk)
    yr, sr = wkv_recurrent_ref(*a)
    _close(y, yr, "y")
    _close(s, sr, "s_final")


# the cases of tests/test_kernel_wkv6.py: B, L, H, N, chunk, decay scale
PALLAS_CASES = [
    (1, 32, 1, 8, 32, 2.0),     # single chunk
    (2, 96, 2, 16, 32, 2.0),    # multi-chunk, state carried
    (1, 80, 3, 8, 16, 2.0),     # chunk-size sweep
    (2, 64, 2, 64, 32, 2.0),    # model-sized head dim
    (1, 50, 2, 8, 32, 2.0),     # ragged length (padded by the reference's op)
    (1, 64, 1, 8, 32, 3.5),     # near-zero decays
]


@pytest.mark.parametrize("B,L,H,N,chunk,scale", PALLAS_CASES)
def test_pallas_interpret_matches_port(B, L, H, N, chunk, scale):
    """The TPU kernel itself (interpret mode) against the port's op."""
    a = _inputs(L + N, B, L, H, N, scale)
    yw, sw = jax_wkv6(*_jax(a), chunk=chunk, use_pallas=True, interpret=True)
    y, s = wkv6(*_torch(a), chunk=chunk)
    assert bool(torch.isfinite(y).all())
    _close(y, yw, "y")
    _close(s, sw, "s_final")


# L, chunk, decay scale, N: every CHUNKED_CASES entry, then near-zero decays,
# ragged L at each chunk size, and the model's head size
TWO_PHASE_CASES = ([(L, chunk, 2.0, 8) for L, chunk in CHUNKED_CASES]
                   + [(64, 32, 3.5, 8), (70, 16, 3.5, 24), (200, 64, 3.5, 24),
                      (45, 16, 2.0, 16), (333, 32, 2.0, 64), (1, 32, 2.0, 8)])


@pytest.mark.parametrize("L,chunk,scale,N", TWO_PHASE_CASES)
def test_two_phase_ref_matches_reference(L, chunk, scale, N):
    """The chunked route's decomposition, 3xTF32 emulated, against the port's
    chunked version and the reference's ``wkv_chunked`` on the same inputs."""
    a = _inputs(L + 3 * N, 2, L, 3, N, scale)
    y, s = wkv_two_phase_ref(*_torch(a), chunk=chunk)
    assert y.dtype == s.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    yr, sr = wkv_chunked_ref(*_torch(a), chunk=chunk)
    _close(y, yr, "y vs wkv_chunked_ref")
    _close(s, sr, "s_final vs wkv_chunked_ref")
    yw, sw = jax_wkv_chunked(*_jax(a), chunk=chunk)
    _close(y, yw, "y vs repro wkv_chunked")
    _close(s, sw, "s_final vs repro wkv_chunked")


def test_two_phase_ref_rejects_bad_arguments():
    a = _torch(_inputs(1, 1, 8, 1, 8))
    with pytest.raises(ValueError, match="multiple of 16"):
        wkv_two_phase_ref(*a, chunk=8)
    with pytest.raises(ValueError, match="passes"):
        wkv_two_phase_ref(*a, chunk=16, passes=2)


def test_precision_script_prints_both_emulations(capsys):
    """``python -m repro_torch.kernels.wkv6.precision``: plain TF32 and
    3xTF32 at both decay scales (the numbers are recorded, not asserted)."""
    precision.main()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4
    assert sum("3xTF32" in line for line in lines) == 2


@pytest.mark.parametrize("L,chunk,want", [(1, 32, "serial"), (31, 32, "serial"),
                                          (32, 32, "serial"), (33, 32, "chunked"),
                                          (16, 16, "serial"), (17, 16, "chunked"),
                                          (64, 64, "serial"), (4096, 32, "chunked")])
def test_route_by_shape(L, chunk, want):
    """A call with more than one chunk (a prefill) takes the chunked route;
    one chunk or less (a decode step) the serial route."""
    assert kernel.route(L, chunk) == want
    assert want in kernel.ROUTES


# ------------------------------------------------------------------ the op ----

def test_cpu_op_is_the_plain_version():
    a = _torch(_inputs(5, 2, 45, 2, 16))
    y, s = wkv6(*a, chunk=16)
    yr, sr = wkv_chunked_ref(*a, chunk=16)
    assert torch.equal(y, yr) and torch.equal(s, sr)


@pytest.mark.parametrize("L", [1, 7, 33])
def test_ragged_length_is_the_padded_result(L):
    """A ragged L gives what explicit padding (r = k = v = 0, w = 1) gives."""
    r, k, v, w, u, s0 = _torch(_inputs(L + 9, 2, L, 2, 8))
    pad = (-L) % 32

    def padded(x, value=0.0):
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=value)

    y, s = wkv6(r, k, v, w, u, s0)
    yp, sp = wkv6(padded(r), padded(k), padded(v), padded(w, 1.0), u, s0)
    assert y.shape == (2, L, 2, 8)
    torch.testing.assert_close(y, yp[:, :L], rtol=0, atol=0)
    torch.testing.assert_close(s, sp, rtol=0, atol=0)


def test_decode_steps_carry_the_state():
    """L = 1 calls chained through their states equal one call over L."""
    a = _torch(_inputs(11, 2, 12, 2, 8))
    r, k, v, w, u, s0 = a
    y_all, s_all = wkv6(*a)
    s = s0
    for t in range(12):
        y, s = wkv6(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1], w[:, t:t + 1], u, s)
        _close(y[:, 0], y_all[:, t], f"step {t}")
    _close(s, s_all, "s_final")


def test_op_casts_to_float32():
    a = _torch(_inputs(3, 1, 20, 2, 8))
    y, s = wkv6(*(x.to(torch.bfloat16) for x in a[:4]), a[4].double(), a[5])
    yr, sr = wkv_chunked_ref(*(x.to(torch.bfloat16).float() for x in a[:4]), a[4], a[5])
    assert y.dtype == s.dtype == torch.float32
    torch.testing.assert_close(y, yr, rtol=0, atol=0)
    torch.testing.assert_close(s, sr, rtol=0, atol=0)


def test_op_rejects_bad_arguments():
    r, k, v, w, u, s0 = _torch(_inputs(4, 1, 8, 2, 8))
    with pytest.raises(ValueError, match="chunk"):
        wkv6(r, k, v, w, u, s0, chunk=8)
    with pytest.raises(ValueError, match="expected"):
        wkv6(r, k[:, :4], v, w, u, s0)
    with pytest.raises(ValueError, match="expected"):
        wkv6(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="expected"):
        wkv6(r, k, v, w, u, s0[:, :, :4])
    with pytest.raises(ValueError, match=r"\(B, L, H, N\)"):
        wkv6(r[0], k[0], v[0], w[0], u, s0)
    with pytest.raises(ValueError, match="empty"):
        wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)
    big = _torch(_inputs(4, 1, 4, 1, 80))
    with pytest.raises(ValueError, match="head size"):
        wkv6(*big)
    with pytest.raises(ValueError, match="different devices"):
        wkv6(r, k, v, w, u.to("meta"), s0)
    # meta tensors take the plain version, which only propagates shapes (the
    # dry-run's route)
    y, s = wkv6(*(x.to("meta") for x in (r, k, v, w, u, s0)))
    assert (y.device.type, y.shape, s.shape) == ("meta", r.shape, s0.shape)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.wkv6_cuda(r, k, v, w, u, s0)


def test_model_reexports_the_plain_versions():
    """``models/rwkv.py`` keeps the reference's names."""
    assert rwkv.wkv_chunked is wkv_chunked_ref
    assert rwkv.wkv_recurrent_ref is wkv_recurrent_ref
    assert rwkv.CHUNK == 32
