"""Spread-kernel path (backend='pallas'; the Pallas interpreter on CPU):
transform correctness vs the XLA path, ranks 1-3, adversarial point
distributions, planned transforms and the normal operator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tensorflow_nufft_tpu as tfft
from tensorflow_nufft_tpu.planar import to_planar
from tests.conftest import random_complex, random_points


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) or 1.0)


def _adversarial_points(rng, m, rank):
    """Uniform + clustered + edge + duplicate points."""
    parts = [
        rng.uniform(-np.pi, np.pi, (m // 2, rank)),
        rng.normal(0, 0.05, (m // 4, rank)),                # hot tile
        np.full((m // 8, rank), np.pi * 0.9999),            # edge/wrap
    ]
    rest = m - sum(p.shape[0] for p in parts)
    dup = rng.uniform(-np.pi, np.pi, (1, rank))
    parts.append(np.tile(dup, (rest, 1)))                   # duplicates
    pts = np.concatenate(parts).astype(np.float32)
    return np.clip(pts, -np.pi, np.pi)


@pytest.mark.parametrize("grid_shape,m", [
    ((64,), 600), ((32, 48), 800), ((16, 16, 16), 700)])
@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
def test_pallas_matches_xla(rng, grid_shape, m, transform_type):
    rank = len(grid_shape)
    pts = _adversarial_points(rng, m, rank)
    if transform_type == "type_1":
        src = to_planar(random_complex(rng, (m,), np.complex64))
        gs = grid_shape
    else:
        src = to_planar(random_complex(rng, grid_shape, np.complex64))
        gs = None
    kw = dict(grid_shape=gs, transform_type=transform_type, tol=1e-5)
    a = tfft.planar.nufft(src, pts, options=tfft.Options(backend="xla"),
                          **kw)
    b = tfft.planar.nufft(src, pts,
                          options=tfft.Options(backend="pallas"), **kw)
    assert _relerr(b, a) < 1e-4


@pytest.mark.parametrize("batch", [3, 16])   # 16 -> 32 channels, grouped
@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
def test_pallas_batched(rng, batch, transform_type):
    grid_shape = (32, 32)
    m = 300
    pts = _adversarial_points(rng, m, 2)
    if transform_type == "type_1":
        src = to_planar(random_complex(rng, (batch, m), np.complex64))
        kw = dict(grid_shape=grid_shape, transform_type="type_1")
    else:
        src = to_planar(random_complex(rng, (batch,) + grid_shape,
                                       np.complex64))
        kw = dict(transform_type="type_2")
    a = tfft.planar.nufft(src, pts, options=tfft.Options(backend="xla"),
                          **kw)
    b = tfft.planar.nufft(src, pts,
                          options=tfft.Options(backend="pallas"), **kw)
    assert _relerr(b, a) < 1e-4


def test_forced_pallas_rejects_f64():
    """backend='pallas' must error on f64/complex128 configs rather than
    silently casting to float32 (advisor finding)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-np.pi, np.pi, (64, 2))
    vals = rng.standard_normal((64, 2))
    with pytest.raises(ValueError, match="pallas"):
        tfft.planar.nufft(vals, pts, grid_shape=(16, 16),
                          transform_type="type_1",
                          options=tfft.Options(backend="pallas"))


class TestPlannedNufft:
    """PlannedNufft (planned path forced via backend='pallas') matches
    the unplanned pipeline, including gradients."""

    def _setup(self, transform_type, rng):
        grid = (16, 16)
        m = 200
        pts = random_points(rng, (m, 2), np.float32)
        if transform_type == "type_1":
            src = rng.standard_normal((2, m, 2)).astype(np.float32)
        else:
            src = rng.standard_normal((2,) + grid + (2,)).astype(
                np.float32)
        return grid, pts, src

    @pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
    def test_matches_unplanned(self, rng, transform_type):
        grid, pts, src = self._setup(transform_type, rng)
        opts = tfft.Options(backend="pallas")
        op = tfft.planar.PlannedNufft(
            pts, grid, transform_type=transform_type, options=opts)
        assert op._planned
        got = np.asarray(op(src))
        ref = np.asarray(tfft.planar.nufft(
            src, pts, grid_shape=grid, transform_type=transform_type))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())

    def test_gradient_matches(self, rng):
        grid, pts, src = self._setup("type_2", rng)
        opts = tfft.Options(backend="pallas")
        op = tfft.planar.PlannedNufft(pts, grid, transform_type="type_2",
                                      options=opts)

        def loss_planned(x):
            return jnp.sum(op(x) ** 2)

        def loss_ref(x):
            y = tfft.planar.nufft(x, pts, grid_shape=grid,
                                  transform_type="type_2")
            return jnp.sum(y ** 2)

        g1 = np.asarray(jax.grad(loss_planned)(jnp.asarray(src)))
        g2 = np.asarray(jax.grad(loss_ref)(jnp.asarray(src)))
        np.testing.assert_allclose(g1, g2, rtol=1e-3,
                                   atol=1e-3 * np.abs(g2).max())

    def test_fallback_off_pallas(self, rng):
        grid, pts, src = self._setup("type_2", rng)
        op = tfft.planar.PlannedNufft(pts, grid, transform_type="type_2")
        # default backend on CPU: unplanned fallback, still correct
        got = np.asarray(op(src))
        ref = np.asarray(tfft.planar.nufft(src, pts, grid_shape=grid))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


class TestFusedNormal:
    """PlannedNufft.normal: the slot-order A^H W A matches the composed
    adjoint-after-forward (same kernels; the slot permutation is exact)."""

    def _op(self, rng, grid, transform_type="type_2"):
        m = 400
        pts = random_points(rng, (m, len(grid)), np.float32)
        opts = tfft.Options(backend="pallas")
        return tfft.planar.PlannedNufft(
            pts, grid, transform_type=transform_type, options=opts), m

    @pytest.mark.parametrize("grid", [(32,), (16, 24), (12, 16, 8)])
    def test_matches_composed(self, rng, grid):
        op, _ = self._op(rng, grid)
        assert op._planned
        src = rng.standard_normal((2,) + grid + (2,)).astype(np.float32)
        ref = np.asarray(op.adjoint()(op(src)))
        got = np.asarray(op.normal(src))
        np.testing.assert_allclose(got, ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())

    def test_weighted(self, rng):
        op, m = self._op(rng, (16, 24))
        w = rng.uniform(0.5, 2.0, (m,)).astype(np.float32)
        sw = op.slot_weights(jnp.asarray(w))
        src = rng.standard_normal((2, 16, 24, 2)).astype(np.float32)
        ref = np.asarray(op.adjoint()(
            op(src) * jnp.asarray(w)[None, :, None]))
        got = np.asarray(op.normal(src, sw))
        np.testing.assert_allclose(got, ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())

    def test_type1_instance(self, rng):
        """normal on a type-1 planned instance: A W A^H on grid input."""
        op, m = self._op(rng, (16, 24), transform_type="type_1")
        src = rng.standard_normal((1, 16, 24, 2)).astype(np.float32)
        t2 = op.adjoint()
        ref = np.asarray(op(t2(src)))
        got = np.asarray(op.normal(src))
        np.testing.assert_allclose(got, ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())

    def test_vjp_is_self(self, rng):
        """The normal operator is self-adjoint: its VJP applies itself."""
        op, m = self._op(rng, (16, 24))
        w = rng.uniform(0.5, 2.0, (m,)).astype(np.float32)
        sw = op.slot_weights(jnp.asarray(w))
        src = jnp.asarray(
            rng.standard_normal((1, 16, 24, 2)).astype(np.float32))
        ct = jnp.asarray(
            rng.standard_normal(src.shape).astype(np.float32))
        _, vjp = jax.vjp(lambda s: op.normal(s, sw), src)
        got = np.asarray(vjp(ct)[0])
        ref = np.asarray(op.normal(ct, sw))
        np.testing.assert_allclose(got, ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())

    def test_jit_composes(self, rng):
        op, _ = self._op(rng, (16, 24))
        src = jnp.asarray(
            rng.standard_normal((1, 16, 24, 2)).astype(np.float32))
        got = np.asarray(jax.jit(op.normal)(src))
        ref = np.asarray(op.normal(src))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


class TestDispatchGuards:
    def test_forced_pallas_tiny_grid(self, rng):
        # A fine grid smaller than one tile: the single tile's block
        # wraps around the grid several times in the overlap-add.
        pts = random_points(rng, (20, 1), np.float32)
        src = to_planar(random_complex(rng, (20,), np.complex64))
        kw = dict(grid_shape=(3,), transform_type="type_1", tol=1e-1)
        got = tfft.planar.nufft(src, pts,
                                options=tfft.Options(backend="pallas"),
                                **kw)
        ref = tfft.planar.nufft(src, pts,
                                options=tfft.Options(backend="xla"), **kw)
        assert _relerr(got, ref) < 1e-5

    def test_forced_pallas_complex_raises(self, rng):
        # The spread kernel serves the planar pipeline only; forcing
        # it for complex arrays must error, not silently run XLA.
        pts = random_points(rng, (20, 1), np.float32)
        src = random_complex(rng, (20,), np.complex64)
        with pytest.raises(ValueError, match="planar"):
            tfft.nufft(src, pts, grid_shape=(32,),
                       transform_type="type_1",
                       options=tfft.Options(backend="pallas"))

    def test_planned_single_chunk(self, rng):
        # Most tiles own at most one chunk, many none: the kernel's
        # per-tile chunk loop runs zero or one times.
        pts = random_points(rng, (100, 2), np.float32)
        op = tfft.planar.PlannedNufft(
            pts, (32, 32), transform_type="type_1",
            options=tfft.Options(backend="pallas"))
        assert op._planned
        bounds = np.asarray(op.binned.tile_bounds)
        assert np.diff(bounds).max() <= 1    # the tiny-plan regime
        src = to_planar(random_complex(rng, (1, 100), np.complex64))
        got = np.asarray(op(src))
        ref = np.asarray(tfft.planar.nufft(
            src, pts, grid_shape=(32, 32), transform_type="type_1",
            options=tfft.Options(backend="xla")))
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
