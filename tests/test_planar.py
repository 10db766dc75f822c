"""Planar-real API: equivalence with the complex path, gradients,
matmul-DFT accuracy. The planar pipeline is the one the spread kernel
serves, tested here on CPU against the complex implementation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tensorflow_nufft_tpu as tfft
from tensorflow_nufft_tpu.fft.planar_fft import dft_planar
from tensorflow_nufft_tpu.planar import from_planar, to_planar
from tests.conftest import random_complex, random_points


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.max(np.abs(b)) or 1.0
    return np.max(np.abs(a - b)) / scale


class TestPlanarDft:
    @pytest.mark.parametrize("shape", [(8,), (6, 8), (4, 6, 8)])
    @pytest.mark.parametrize("direction", ["forward", "backward"])
    def test_matches_fft(self, rng, shape, direction):
        z = random_complex(rng, (2,) + shape, np.complex64)
        x = to_planar(z)
        rank = len(shape)
        out = from_planar(dft_planar(x, rank, direction))
        axes = tuple(range(-rank, 0))
        if direction == "forward":
            want = np.fft.fftn(z, axes=axes)
        else:
            want = np.fft.ifftn(z, axes=axes) * np.prod(shape)
        assert _relerr(out, want) < 1e-5

    def test_f64(self, rng):
        z = random_complex(rng, (1, 16, 16), np.complex128)
        out = from_planar(dft_planar(to_planar(z), 2, "forward"))
        want = np.fft.fftn(z, axes=(-2, -1))
        assert _relerr(out, want) < 1e-13


@pytest.mark.parametrize("grid_shape", [(8,), (6, 8), (4, 8, 6)])
@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
@pytest.mark.parametrize("fft_direction", ["forward", "backward"])
def test_planar_matches_complex(rng, grid_shape, transform_type,
                                fft_direction):
    rank = len(grid_shape)
    m = 13
    points = random_points(rng, (m, rank), np.float32)
    if transform_type == "type_1":
        z = random_complex(rng, (m,), np.complex64)
        gs = grid_shape
    else:
        z = random_complex(rng, grid_shape, np.complex64)
        gs = None
    got = from_planar(tfft.planar.nufft(
        to_planar(z), points, grid_shape=gs,
        transform_type=transform_type, fft_direction=fft_direction))
    want = tfft.nufft(z, points, grid_shape=gs,
                      transform_type=transform_type,
                      fft_direction=fft_direction)
    assert _relerr(got, want) < 1e-5


def test_planar_broadcasting(rng):
    grid_shape = (6, 8)
    m = 9
    z = random_complex(rng, (3, 1) + grid_shape, np.complex64)
    points = random_points(rng, (2, m, 2), np.float32)
    got = from_planar(tfft.planar.nufft(to_planar(z), points))
    want = tfft.nufft(z, points)
    assert got.shape == want.shape == (3, 2, m)
    assert _relerr(got, want) < 1e-5


@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
@pytest.mark.parametrize("fft_direction", ["forward", "backward"])
def test_planar_vjp_matches_planar_oracle(rng, transform_type,
                                          fft_direction):
    """Planar custom VJP == JAX autodiff of the planar dense oracle."""
    grid_shape = (6, 8)
    m = 9
    points = random_points(rng, (m, 2), np.float32)
    if transform_type == "type_1":
        src = to_planar(random_complex(rng, (m,), np.complex64))
        ct = to_planar(random_complex(rng, grid_shape, np.complex64))
        gs = grid_shape
    else:
        src = to_planar(random_complex(rng, grid_shape, np.complex64))
        ct = to_planar(random_complex(rng, (m,), np.complex64))
        gs = None

    fast = lambda s, p: tfft.planar.nufft(
        s, p, grid_shape=gs, transform_type=transform_type,
        fft_direction=fft_direction)
    oracle = lambda s, p: tfft.planar.nudft(
        s, p, grid_shape=gs, transform_type=transform_type,
        fft_direction=fft_direction)
    _, vjp_fast = jax.vjp(fast, src, points)
    _, vjp_oracle = jax.vjp(oracle, src, points)
    for got, want in zip(vjp_fast(jnp.asarray(ct)),
                         vjp_oracle(jnp.asarray(ct))):
        assert got.shape == want.shape
        assert _relerr(got, want) < 1e-3


def test_planar_loss_grad_matches_complex(rng):
    """Same real scalar loss through either API gives the same gradient
    (translated through to_planar)."""
    grid_shape = (8, 8)
    m = 11
    z = random_complex(rng, grid_shape, np.complex64)
    points = random_points(rng, (m, 2), np.float32)
    target = random_complex(rng, (m,), np.complex64)
    target_p = to_planar(target)

    def loss_planar(p_src, pts):
        pred = tfft.planar.nufft(p_src, pts)
        return jnp.sum((pred - target_p) ** 2)

    def loss_complex(c_src, pts):
        pred = tfft.nufft(c_src, pts)
        return jnp.sum(jnp.abs(pred - jnp.asarray(target)) ** 2)

    g_planar = jax.grad(loss_planar)(to_planar(z), points)
    g_complex = jax.grad(loss_complex)(jnp.asarray(z), points)
    # complex grad of real loss: JAX returns conj-style pairing; real/imag
    # parts map to the planar channels as (re, -im) or (re, +im) depending
    # on convention — compare against numerical ground truth instead.
    eps = 1e-3
    zp = to_planar(z)
    num = np.zeros(3)
    got = np.zeros(3)
    idx = [(0, 0, 0), (1, 2, 1), (3, 4, 0)]
    for t, (i, j, c) in enumerate(idx):
        delta = np.zeros_like(np.asarray(zp))
        delta[i, j, c] = eps
        lp = float(loss_planar(jnp.asarray(np.asarray(zp) + delta), points))
        lm = float(loss_planar(jnp.asarray(np.asarray(zp) - delta), points))
        num[t] = (lp - lm) / (2 * eps)
        got[t] = float(np.asarray(g_planar)[i, j, c])
    np.testing.assert_allclose(got, num, rtol=2e-2, atol=1e-2)
    # grad wrt points agrees between APIs (points are real in both).
    gp_p = jax.grad(loss_planar, argnums=1)(to_planar(z), points)
    gp_c = jax.grad(loss_complex, argnums=1)(jnp.asarray(z), points)
    assert _relerr(gp_p, gp_c) < 1e-3


def test_planar_interp_spread(rng):
    grid_shape = (16, 16)
    m = 12
    points = random_points(rng, (m, 2), np.float32)
    z = random_complex(rng, grid_shape, np.complex64)
    got = from_planar(tfft.planar.interp(to_planar(z), points))
    want = tfft.interp(z, points)
    assert _relerr(got, want) < 1e-5
    c = random_complex(rng, (m,), np.complex64)
    got = from_planar(tfft.planar.spread(to_planar(c), points, grid_shape))
    want = tfft.spread(c, points, grid_shape)
    assert _relerr(got, want) < 1e-5


def test_planar_jit(rng):
    z = random_complex(rng, (6, 8), np.complex64)
    points = random_points(rng, (9, 2), np.float32)
    fn = jax.jit(lambda s, p: tfft.planar.nufft(s, p))
    np.testing.assert_allclose(
        np.asarray(fn(to_planar(z), points)),
        np.asarray(tfft.planar.nufft(to_planar(z), points)),
        rtol=1e-5, atol=1e-5)


def test_planar_validation(rng):
    points = random_points(rng, (5, 2), np.float32)
    with pytest.raises(ValueError, match="trailing"):
        tfft.planar.nufft(np.zeros((8, 8, 3), np.float32), points)
    with pytest.raises(TypeError, match="float32 or float64"):
        tfft.planar.nufft(np.zeros((8, 8, 2), np.complex64), points)
    with pytest.raises(TypeError, match="points"):
        tfft.planar.nufft(np.zeros((8, 8, 2), np.float32),
                          points.astype(np.float64))


class TestToeplitzNormal:
    """planar.ToeplitzNormal: the FFT-domain embedded normal operator
    matches the composed forward/weights/adjoint NUFFT pair at the
    tolerance level, for ranks 1-3 and both A directions."""

    @pytest.mark.parametrize("grid", [(32,), (16, 24), (12, 16, 8)])
    def test_matches_composed(self, rng, grid):
        from tensorflow_nufft_tpu.planar import ToeplitzNormal
        rank = len(grid)
        m = 300
        pts = jnp.asarray(
            rng.uniform(-np.pi, np.pi, (m, rank)).astype(np.float32))
        w = jnp.asarray(rng.uniform(0.5, 2.0, (m,)).astype(np.float32))
        op = ToeplitzNormal(pts, grid, weights=w)
        src = jnp.asarray(rng.standard_normal(
            (2,) + grid + (2,)).astype(np.float32))
        fwd = tfft.planar.nufft(src, pts, transform_type="type_2")
        ref = np.asarray(tfft.planar.nufft(
            fwd * w[None, :, None], pts, grid_shape=grid,
            transform_type="type_1", fft_direction="backward"))
        got = np.asarray(op(src))
        np.testing.assert_allclose(
            got, ref, atol=5e-4 * np.abs(ref).max())

    def test_backward_direction(self, rng):
        from tensorflow_nufft_tpu.planar import ToeplitzNormal
        grid = (16, 12)
        m = 200
        pts = jnp.asarray(
            rng.uniform(-np.pi, np.pi, (m, 2)).astype(np.float32))
        op = ToeplitzNormal(pts, grid, fft_direction="backward")
        src = jnp.asarray(rng.standard_normal(
            (1,) + grid + (2,)).astype(np.float32))
        fwd = tfft.planar.nufft(src, pts, transform_type="type_2",
                                fft_direction="backward")
        ref = np.asarray(tfft.planar.nufft(
            fwd, pts, grid_shape=grid, transform_type="type_1",
            fft_direction="forward"))
        got = np.asarray(op(src))
        np.testing.assert_allclose(
            got, ref, atol=5e-4 * np.abs(ref).max())

    def test_vjp_is_self(self, rng):
        from tensorflow_nufft_tpu.planar import ToeplitzNormal
        grid = (16, 12)
        pts = jnp.asarray(
            rng.uniform(-np.pi, np.pi, (150, 2)).astype(np.float32))
        op = ToeplitzNormal(pts, grid)
        src = jnp.asarray(rng.standard_normal(
            (1,) + grid + (2,)).astype(np.float32))
        ct = jnp.asarray(rng.standard_normal(src.shape).astype(
            np.float32))
        _, vjp = jax.vjp(op, src)
        np.testing.assert_array_equal(np.asarray(vjp(ct)[0]),
                                      np.asarray(op(ct)))

    def test_errors(self, rng):
        from tensorflow_nufft_tpu.planar import ToeplitzNormal
        pts = jnp.asarray(
            rng.uniform(-np.pi, np.pi, (50, 2)).astype(np.float32))
        with pytest.raises(ValueError, match="single"):
            ToeplitzNormal(pts[None], (16, 16))
        with pytest.raises(ValueError, match="rank-2"):
            ToeplitzNormal(pts, (16,))
        with pytest.raises(ValueError, match="weights"):
            ToeplitzNormal(pts, (16, 16), weights=jnp.ones((7,)))
        op = ToeplitzNormal(pts, (16, 16))
        with pytest.raises(ValueError, match="planar"):
            op(jnp.zeros((16, 16, 2)))


def test_planar_check_points_range(rng):
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.planar import to_planar
    opts = tfft.Options(
        points_range=tfft.PointsRange.STRICT,
        debugging=tfft.DebuggingOptions(check_points_range=True))
    src = to_planar(random_complex(rng, (10,), np.complex64))
    bad = np.full((10, 1), 2 * np.pi, np.float32)
    # Eager: Python error.
    with pytest.raises(ValueError, match="supported range"):
        tfft.planar.nufft(src, bad, grid_shape=(16,),
                          transform_type="type_1", options=opts)
    # Under jit: NaN poisoning.
    out = jax.jit(lambda p: tfft.planar.nufft(
        src, p, grid_shape=(16,), transform_type="type_1",
        options=opts))(jnp.asarray(bad))
    assert not np.isfinite(np.asarray(out)).any()
    # In-range points unaffected.
    good = random_points(rng, (10, 1), np.float32)
    out2 = tfft.planar.nufft(src, good, grid_shape=(16,),
                             transform_type="type_1", options=opts)
    assert np.isfinite(np.asarray(out2)).all()


def test_planned_shape_validation(rng):
    import tensorflow_nufft_tpu as tfft
    pts = random_points(rng, (64, 2), np.float32)
    op = tfft.planar.PlannedNufft(pts, (16, 16), transform_type="type_1")
    with pytest.raises(ValueError, match="64"):
        op(np.zeros((1, 32, 2), np.float32))     # wrong point count
    op2 = tfft.planar.PlannedNufft(pts, (16, 16),
                                   transform_type="type_2")
    with pytest.raises(ValueError, match="16"):
        op2(np.zeros((1, 8, 16, 2), np.float32))  # wrong grid


def test_unplanned_normal_with_weights(rng):
    # An unplanned normal() must honor density weights via the
    # point-order fallback instead of raising.
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.planar import to_planar
    pts = random_points(rng, (80, 2), np.float32)
    op = tfft.planar.PlannedNufft(pts, (16, 16), transform_type="type_2")
    w = rng.uniform(0.5, 2.0, (80,)).astype(np.float32)
    sw = op.slot_weights(jnp.asarray(w))
    src = to_planar(random_complex(rng, (1, 16, 16), np.complex64))
    got = np.asarray(op.normal(src, sw))
    ref = np.asarray(op.adjoint()(
        op(src) * jnp.asarray(w)[None, :, None]))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_toeplitz_normal_float64(rng):
    # f64 pipelines keep f64 accuracy through ToeplitzNormal (the
    # spectrum used to be silently truncated to f32).
    import tensorflow_nufft_tpu as tfft
    from tensorflow_nufft_tpu.planar import to_planar
    from tensorflow_nufft_tpu.models import mri
    pts = random_points(rng, (100, 2), np.float64)
    grid = (16, 16)
    top = tfft.planar.ToeplitzNormal(pts, grid, tol=1e-12)
    assert top.spectrum.dtype == np.float64
    src = to_planar(random_complex(rng, (1, 16, 16), np.complex128))
    got = np.asarray(top(src))
    t2 = tfft.planar.nufft(src, pts.astype(np.float64),
                           transform_type="type_2", tol=1e-12)
    ref = np.asarray(tfft.planar.nufft(
        t2, pts, grid_shape=grid, transform_type="type_1",
        fft_direction="backward", tol=1e-12))
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-10
