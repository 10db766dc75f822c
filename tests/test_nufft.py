"""Accuracy sweep of ``nufft`` against the dense ``nudft`` oracle.

Models the reference's core test (nufft_ops_test.py:87-221): grid shapes x
batch/broadcast combos x transform types x directions x dtypes, with max
abs/rel error <= 1e-3 (the reference's CPU bound, nufft_ops_test.py:812).
"""

import jax
import numpy as np
import pytest

import tensorflow_nufft_tpu as tfft
from tests.conftest import random_complex, random_points

GRID_SHAPES = [(8,), (6, 8), (4, 8, 6)]
# (source_batch, points_batch) combos, including broadcasting.
BATCH_COMBOS = [
    ((), ()),
    ((2,), ()),        # inner-vectorized: shared points
    ((), (2,)),        # points batch only
    ((2,), (2,)),      # matched outer
    ((3, 2), (2,)),    # mixed ranks
    ((3, 1), (3, 2)),  # source broadcast against points
]
TOL = 1e-3


def _max_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.max(np.abs(b)) or 1.0
    return np.max(np.abs(a - b)) / scale


@pytest.mark.parametrize("grid_shape", GRID_SHAPES)
@pytest.mark.parametrize("src_batch,pts_batch", BATCH_COMBOS)
@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
def test_nufft_accuracy(rng, grid_shape, src_batch, pts_batch,
                        transform_type):
    rank = len(grid_shape)
    m = 14
    dtype = np.complex64
    points = random_points(rng, pts_batch + (m, rank), np.float32)
    if transform_type == "type_1":
        source = random_complex(rng, src_batch + (m,), dtype)
        kwargs = dict(grid_shape=grid_shape)
    else:
        source = random_complex(rng, src_batch + grid_shape, dtype)
        kwargs = {}
    result = tfft.nufft(source, points, transform_type=transform_type,
                        tol=1e-6, **kwargs)
    expected = tfft.nudft(source, points, transform_type=transform_type,
                          grid_shape=grid_shape if transform_type == "type_1"
                          else None)
    assert result.shape == expected.shape
    assert _max_err(result, expected) < TOL


@pytest.mark.parametrize("fft_direction", ["forward", "backward"])
@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
def test_directions(rng, transform_type, fft_direction):
    grid_shape = (6, 8)
    m = 10
    points = random_points(rng, (m, 2), np.float32)
    source = random_complex(
        rng, (m,) if transform_type == "type_1" else grid_shape,
        np.complex64)
    kwargs = dict(grid_shape=grid_shape) if transform_type == "type_1" \
        else {}
    result = tfft.nufft(source, points, transform_type=transform_type,
                        fft_direction=fft_direction, **kwargs)
    expected = tfft.nudft(source, points, transform_type=transform_type,
                          fft_direction=fft_direction,
                          grid_shape=grid_shape if transform_type == "type_1"
                          else None)
    assert _max_err(result, expected) < TOL


@pytest.mark.parametrize("grid_shape", [(8,), (6, 8)])
@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
def test_complex128(rng, grid_shape, transform_type):
    """complex128 path with a tighter tolerance."""
    rank = len(grid_shape)
    m = 12
    points = random_points(rng, (m, rank), np.float64)
    source = random_complex(
        rng, (m,) if transform_type == "type_1" else grid_shape,
        np.complex128)
    kwargs = dict(grid_shape=grid_shape) if transform_type == "type_1" \
        else {}
    result = tfft.nufft(source, points, transform_type=transform_type,
                        tol=1e-12, **kwargs)
    expected = tfft.nudft(source, points, transform_type=transform_type,
                          grid_shape=grid_shape if transform_type == "type_1"
                          else None)
    assert _max_err(result, expected) < 1e-10


def test_odd_grid_dims(rng):
    """Odd mode counts use integer modes k = i - N//2 (the reference's C++
    convention, cc/kernels/nufft_plan.cc:729-733)."""
    grid_shape = (7, 9)
    m = 8
    points = random_points(rng, (m, 2), np.float32)
    source = random_complex(rng, grid_shape, np.complex64)
    result = tfft.nufft(source, points)
    expected = tfft.nudft(source, points)
    assert _max_err(result, expected) < TOL


def test_jit_composable(rng):
    grid_shape = (6, 8)
    points = random_points(rng, (10, 2), np.float32)
    source = random_complex(rng, grid_shape, np.complex64)
    fn = jax.jit(lambda s, p: tfft.nufft(s, p))
    np.testing.assert_allclose(
        np.asarray(fn(source, points)),
        np.asarray(tfft.nufft(source, points)), rtol=1e-5, atol=1e-5)


def test_vmap_composable(rng):
    grid_shape = (6, 8)
    points = random_points(rng, (3, 10, 2), np.float32)
    source = random_complex(rng, (3,) + grid_shape, np.complex64)
    batched = jax.vmap(lambda s, p: tfft.nufft(s, p))(source, points)
    direct = tfft.nufft(source, points)
    np.testing.assert_allclose(np.asarray(batched), np.asarray(direct),
                               rtol=1e-4, atol=1e-4)


def test_max_batch_size_option(rng):
    grid_shape = (6, 8)
    points = random_points(rng, (10, 2), np.float32)
    source = random_complex(rng, (5,) + grid_shape, np.complex64)
    opts = tfft.Options(max_batch_size=2)
    with_chunks = tfft.nufft(source, points, options=opts)
    without = tfft.nufft(source, points)
    np.testing.assert_allclose(np.asarray(with_chunks), np.asarray(without),
                               rtol=1e-5, atol=1e-5)


def test_deterministic(rng):
    """Repeated large-ish 3D interp gives bit-identical results
    (models nufft_ops_test.py:420-435)."""
    grid_shape = (16, 16, 16)
    points = random_points(rng, (3000, 3), np.float32)
    source = random_complex(rng, grid_shape, np.complex64)
    fn = jax.jit(lambda s, p: tfft.nufft(s, p))
    first = np.asarray(fn(source, points))
    for _ in range(4):
        np.testing.assert_array_equal(first, np.asarray(fn(source, points)))


class TestErrors:
    def test_missing_grid_shape(self, rng):
        src = random_complex(rng, (5,), np.complex64)
        pts = random_points(rng, (5, 2), np.float32)
        with pytest.raises(ValueError, match="grid_shape must be provided"):
            tfft.nufft(src, pts, transform_type="type_1")

    def test_bad_grid_shape_rank(self, rng):
        src = random_complex(rng, (5,), np.complex64)
        pts = random_points(rng, (5, 2), np.float32)
        with pytest.raises(ValueError, match="rank-2"):
            tfft.nufft(src, pts, grid_shape=(8,), transform_type="type_1")

    def test_mismatched_num_points(self, rng):
        src = random_complex(rng, (6,), np.complex64)
        pts = random_points(rng, (5, 2), np.float32)
        with pytest.raises(ValueError, match="incompatible number"):
            tfft.nufft(src, pts, grid_shape=(8, 8),
                       transform_type="type_1")

    def test_bad_transform_type(self, rng):
        src = random_complex(rng, (4, 4), np.complex64)
        pts = random_points(rng, (5, 2), np.float32)
        with pytest.raises(ValueError, match="transform_type"):
            tfft.nufft(src, pts, transform_type="type_4")

    def test_type3_unimplemented(self, rng):
        # Parity: the reference enumerates type-3 but raises
        # Unimplemented (cc/kernels/nufft_plan.cc:175-177).
        src = random_complex(rng, (4, 4), np.complex64)
        pts = random_points(rng, (5, 2), np.float32)
        with pytest.raises(NotImplementedError, match="type-3"):
            tfft.nufft(src, pts, transform_type="type_3")

    def test_bad_dtype(self, rng):
        pts = random_points(rng, (5, 2), np.float32)
        with pytest.raises(TypeError, match="complex"):
            tfft.nufft(np.ones((4, 4), np.float32), pts)

    def test_mismatched_points_dtype(self, rng):
        src = random_complex(rng, (4, 4), np.complex64)
        pts = random_points(rng, (5, 2), np.float64)
        with pytest.raises(TypeError, match="points"):
            tfft.nufft(src, pts)

    def test_incompatible_batch(self, rng):
        src = random_complex(rng, (3, 4, 4), np.complex64)
        pts = random_points(rng, (2, 5, 2), np.float32)
        with pytest.raises(ValueError, match="[Bb]roadcast"):
            tfft.nufft(src, pts)


class TestScaleStress:
    """Reference-scale stress (models nufft_ops_test.py:420-435, which
    repeats a 3M-point 3D interp 5x): exercises the static chunk-bound
    binning machinery and the full pipeline at millions of points."""

    def test_binning_invariants_1m_uniform_and_adversarial(self):
        from tensorflow_nufft_tpu.kernels import binning
        m = 1_000_000
        fine = (256, 256, 256)
        geom = binning.choose_geometry(fine, 7, m)
        rng = np.random.default_rng(0)
        cases = {
            "uniform": rng.uniform(0, 255.999, (m, 3)).astype(np.float32),
            # adversarial: every point in ONE tile (worst-case skew for
            # the static M//chunk + num_tiles bound)
            "one_tile": rng.uniform(0, 1.0, (m, 3)).astype(np.float32),
        }
        for name, pts in cases.items():
            binned = binning.bin_points(jax.numpy.asarray(pts), geom)
            padpos = np.asarray(binned.padpos)
            bounds = np.asarray(binned.tile_bounds)
            # every point gets a unique slot within the static bound
            assert padpos.shape == (m,)
            assert np.unique(padpos).size == m, name
            assert padpos.min() >= 0
            assert padpos.max() < geom.num_chunks * geom.chunk, name
            # each point's chunk lies inside its tile's chunk range
            tid = np.zeros(m, np.int64)
            for d in range(3):
                td = np.clip((pts[:, d] // geom.tile[d]).astype(int),
                             0, geom.tiles[d] - 1)
                tid = tid * geom.tiles[d] + td
            chunk_of = padpos // geom.chunk
            assert (chunk_of >= bounds[tid]).all(), name
            assert (chunk_of < bounds[tid + 1]).all(), name

    def test_3d_3m_point_interp_repeat(self, rng):
        """3M-point 3D type-2, repeated: bit-determinism + accuracy on
        a subset vs the dense oracle (the reference's stress scale)."""
        m = 3_000_000
        grid_shape = (32, 32, 32)
        points = random_points(rng, (m, 3), np.float32)
        source = random_complex(rng, grid_shape, np.complex64)
        fn = jax.jit(lambda s, p: tfft.nufft(s, p, tol=1e-3))
        first = np.asarray(fn(source, points))
        assert np.isfinite(first).all()
        for _ in range(4):
            np.testing.assert_array_equal(
                first, np.asarray(fn(source, points)))
        sub = 1500
        oracle = np.asarray(tfft.nudft(source, points[:sub]))
        err = np.max(np.abs(first[:sub] - oracle)) / np.max(np.abs(oracle))
        # tol is a rough target: width formula overshoots by a small
        # factor (see docs/accuracy.md); gate an order above like the
        # reference's CI bound relative to its tolerances
        assert err < 1e-2, err

    def test_1m_point_3d_type1_accuracy(self, rng):
        """1M-point 3D type-1 vs oracle on a mode slab."""
        m = 1_000_000
        grid_shape = (16, 16, 16)
        points = random_points(rng, (m, 3), np.float32)
        strengths = random_complex(rng, (m,), np.complex64)
        out = np.asarray(tfft.nufft(strengths, points,
                                    grid_shape=grid_shape,
                                    transform_type="type_1", tol=1e-3))
        assert np.isfinite(out).all()
        # oracle on the full (small) mode grid, f64
        k = np.arange(16) - 8
        p64 = points.astype(np.float64)
        c = np.asarray(strengths, np.complex128)
        ph = [np.exp(-1j * np.outer(p64[:, d], k)) for d in range(3)]
        oracle = np.einsum("m,mi,mj,ml->ijl", c, *ph, optimize=True)
        err = np.max(np.abs(out - oracle)) / np.max(np.abs(oracle))
        assert err < 1e-2, err
