"""The tile-exclusive spread kernel (kernels/triton_spread.py) in the
Pallas interpreter: against the XLA scatter spread and the dense NUDFT
oracle, ranks 1-3, tolerances 1e-2..1e-6, and point sets that stress
the binning (one hot tile, tile borders and the periodic wrap, empty
tiles). The compiled kernel runs only on a GPU: see ``test_gpu.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tensorflow_nufft_tpu as tfft
from tensorflow_nufft_tpu.kernels import binning, dispatch, triton_spread
from tensorflow_nufft_tpu.kernels import xla_ops
from tensorflow_nufft_tpu.plan.plan import PlanSpec, make_plan

_GRID = {1: (32,), 2: (16, 16), 3: (8, 8, 8)}
_M = {1: 300, 2: 400, 3: 300}
_PALLAS = tfft.Options(backend="pallas")
_XLA = tfft.Options(backend="xla")


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) or 1.0)


def _plan(rank, tol, transform_type="type_1"):
    return make_plan(PlanSpec(
        transform_type=transform_type, fft_direction="forward",
        rank=rank, grid_shape=_GRID[rank], dtype_name="complex64",
        tol=tol, points_range=0, spread_only=False))


def _points(rng, kind, m, rank, fine):
    if kind == "uniform":
        x = rng.uniform(-np.pi, np.pi, (m, rank))
    elif kind == "one_tile":
        x = rng.normal(0.3, 0.02, (m, rank))
    elif kind == "borders":
        # On tile borders (in fine-grid units), at the wrap (+-pi), and
        # a hair to either side of both.
        geom = binning.choose_geometry(fine, 7, m)
        edges = []
        for d in range(rank):
            k = np.arange(geom.tiles[d] + 1) * geom.tile[d]
            edges.append(k * 2 * np.pi / fine[d] - np.pi)
        x = np.stack([rng.choice(e, m) for e in edges], axis=-1)
        x = x + rng.choice([-1e-6, 0.0, 1e-6], (m, rank))
        x = np.clip(x, -np.pi, np.pi)
    else:                                   # "empty_tiles"
        x = rng.uniform(-np.pi, -np.pi / 2, (m, rank))
    return x.astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "one_tile", "borders",
                                  "empty_tiles"])
@pytest.mark.parametrize("tol", [1e-2, 1e-4, 1e-6])
@pytest.mark.parametrize("rank", [1, 2, 3])
def test_spread_matches_xla_and_oracle(rng, rank, tol, kind):
    plan = _plan(rank, tol)
    m = _M[rank]
    pts = _points(rng, kind, m, rank, plan.fine_shape)
    vals = rng.standard_normal((2, m)).astype(np.float32)

    # The kernel alone vs the XLA scatter spread.
    pr = xla_ops.fold_and_rescale_split(jnp.asarray(pts), plan.fine_shape,
                                        0)
    tiles, geom = triton_spread.spread(jnp.asarray(vals), pr, plan)
    got = binning.overlap_add(tiles, geom)
    idx, ker = xla_ops.spread_geometry(pr, plan)
    ref = xla_ops.spread_xla(jnp.asarray(vals), idx, ker, plan)
    assert _relerr(got, ref) < 1e-5

    # The whole type-1 transform vs the dense oracle.
    src = np.stack([vals[0], vals[1]], axis=-1)
    out = tfft.planar.nufft(src, pts, grid_shape=_GRID[rank],
                            transform_type="type_1", tol=tol,
                            options=_PALLAS)
    oracle = tfft.planar.nudft(src, pts, grid_shape=_GRID[rank],
                               transform_type="type_1")
    assert _relerr(out, oracle) < max(10 * tol, 1e-5)


@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("rank", [2, 3])
def test_batched_matches_xla(rng, batch, rank):
    m = _M[rank]
    pts = _points(rng, "uniform", m, rank, None)
    src = rng.standard_normal((batch, m, 2)).astype(np.float32)
    kw = dict(grid_shape=_GRID[rank], transform_type="type_1", tol=1e-6)
    a = tfft.planar.nufft(src, pts, options=_XLA, **kw)
    b = tfft.planar.nufft(src, pts, options=_PALLAS, **kw)
    assert _relerr(b, a) < 1e-5


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_channel_groups_cover_batch(rng, rank):
    """Programs own power-of-two channel groups that tile the batch."""
    for batch2 in (2, 6, 10, 16, 32):
        g = triton_spread.channel_group(rank, batch2)
        assert batch2 % g == 0 and g & (g - 1) == 0
        assert g <= triton_spread.MAX_GROUP[rank]


def test_custom_vjp_gradient(rng):
    """Gradients through the type-1 custom VJP (source and points) with
    the spread kernel match the XLA path."""
    m, grid = 200, (16, 16)
    pts = jnp.asarray(_points(rng, "uniform", m, 2, None))
    src = jnp.asarray(rng.standard_normal((2, m, 2)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((2,) + grid + (2,)).astype(
        np.float32))

    def loss(opts):
        def f(s, p):
            y = tfft.planar.nufft(s, p, grid_shape=grid,
                                  transform_type="type_1", options=opts)
            return jnp.sum(w * y)
        return f

    gs_p, gp_p = jax.grad(loss(_PALLAS), argnums=(0, 1))(src, pts)
    gs_x, gp_x = jax.grad(loss(_XLA), argnums=(0, 1))(src, pts)
    assert _relerr(gs_p, gs_x) < 1e-5
    assert _relerr(gp_p, gp_x) < 1e-4


def test_deterministic(rng):
    """No atomics: two runs agree bit for bit."""
    m = _M[2]
    pts = _points(rng, "one_tile", m, 2, None)
    src = rng.standard_normal((1, m, 2)).astype(np.float32)
    kw = dict(grid_shape=_GRID[2], transform_type="type_1",
              options=_PALLAS)
    a = np.asarray(tfft.planar.nufft(src, pts, **kw))
    b = np.asarray(tfft.planar.nufft(src, pts, **kw))
    np.testing.assert_array_equal(a, b)


def test_dispatch_choices():
    """On the CPU platform the kernel runs interpreted and only when
    forced; 'auto' serves XLA; complex data never reaches the kernel."""
    assert triton_spread.interpret_mode()
    for backend, active in (("auto", False), ("xla", False),
                            ("pallas", True), ("native", False)):
        plan = make_plan(PlanSpec(
            transform_type="type_1", fft_direction="forward", rank=2,
            grid_shape=(16, 16), dtype_name="complex64", tol=1e-6,
            points_range=0, spread_only=False, backend=backend))
        assert dispatch.spread_kernel_active(plan, np.float32) == active
    assert not dispatch.spread_kernel_active(_plan(2, 1e-6),
                                             np.complex64)
