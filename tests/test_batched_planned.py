"""Batched planned transforms (BatchedPlannedNufft): per-batch
trajectories served at planned speed (reference analog: the outer points-batch loop, cc/kernels/nufft_kernels.cc:491).

Pins: batched-planned == per-plan loop (the verdict's "done" bar),
accuracy vs the dense oracle, gradients through the adjoint-batch VJP,
the inner-batch axis, the unplanned fallback, and shape validation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tensorflow_nufft_tpu as tfft
from tensorflow_nufft_tpu.options.options import Options
from tensorflow_nufft_tpu.planar import (
    BatchedPlannedNufft, PlannedNufft, from_planar, to_planar)
from tests.conftest import random_complex, random_points


def _relerr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.max(np.abs(b)) or 1.0
    return np.max(np.abs(a - b)) / scale


def _mk(rng, s, m, grid, transform_type):
    rank = len(grid)
    pts = jnp.asarray(random_points(rng, (s, m, rank), np.float32))
    if transform_type == "type_1":
        z = random_complex(rng, (s, m), np.complex64)
    else:
        z = random_complex(rng, (s,) + grid, np.complex64)
    return pts, jnp.asarray(to_planar(z))


@pytest.mark.parametrize("grid", [(32, 32), (16, 12, 10)])
@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
def test_batched_matches_per_plan_loop(rng, grid, transform_type):
    s, m = 3, 500
    pts, src = _mk(rng, s, m, grid, transform_type)
    opts = Options(backend="pallas")
    op = BatchedPlannedNufft(pts, grid, transform_type=transform_type,
                             options=opts)
    assert op._planned, "pallas backend should plan on CPU interpret"
    got = np.asarray(op(src))
    for i in range(s):
        one = PlannedNufft(pts[i], grid, transform_type=transform_type,
                           options=opts)
        want = np.asarray(one(src[i][None]))[0]
        assert _relerr(got[i], want) < 1e-6, f"batch {i}"


@pytest.mark.parametrize("transform_type", ["type_1", "type_2"])
def test_batched_vs_oracle(rng, transform_type):
    grid, s, m = (24, 20), 2, 400
    pts, src = _mk(rng, s, m, grid, transform_type)
    op = BatchedPlannedNufft(pts, grid, transform_type=transform_type,
                             options=Options(backend="pallas"))
    got = np.asarray(op(src))
    gs = grid if transform_type == "type_1" else None
    for i in range(s):
        want = np.asarray(tfft.planar.nudft(
            src[i], pts[i], grid_shape=gs,
            transform_type=transform_type))
        assert _relerr(got[i], want) < 1e-3, f"batch {i}"


def test_batched_inner_batch_axis(rng):
    grid, s, b, m = (16, 16), 2, 3, 300
    pts = jnp.asarray(random_points(rng, (s, m, 2), np.float32))
    z = random_complex(rng, (s, b) + grid, np.complex64)
    src = jnp.asarray(to_planar(z))
    op = BatchedPlannedNufft(pts, grid, transform_type="type_2",
                             options=Options(backend="pallas"))
    got = np.asarray(op(src))              # [S, B, M, 2]
    assert got.shape == (s, b, m, 2)
    for i in range(s):
        for j in range(b):
            want = np.asarray(op._shards[i](src[i, j][None]))[0]
            assert _relerr(got[i, j], want) < 1e-6


def test_batched_gradients_match_loop(rng):
    grid, s, m = (16, 16), 2, 250
    pts, src = _mk(rng, s, m, grid, "type_2")
    opts = Options(backend="pallas")
    op = BatchedPlannedNufft(pts, grid, transform_type="type_2",
                             options=opts)

    def loss(x):
        return jnp.sum(op(x) ** 2)

    g = jax.grad(loss)(src)
    for i in range(s):
        one = PlannedNufft(pts[i], grid, transform_type="type_2",
                           options=opts)

        def loss_i(x):
            return jnp.sum(one(x[None]) ** 2)

        gi = jax.grad(loss_i)(src[i])
        assert _relerr(g[i], gi) < 1e-5, f"batch {i}"


def test_batched_under_jit(rng):
    grid, s, m = (16, 16), 2, 200
    pts, src = _mk(rng, s, m, grid, "type_2")
    op = BatchedPlannedNufft(pts, grid, transform_type="type_2",
                             options=Options(backend="pallas"))
    eager = np.asarray(op(src))
    jitted = np.asarray(jax.jit(op)(src))
    assert _relerr(jitted, eager) < 1e-6


def test_unplanned_fallback_matches(rng):
    # backend='xla' disables the Pallas planned path -> the batched op
    # must fall back to the vmapped unplanned pipeline.
    grid, s, m = (16, 16), 2, 200
    pts, src = _mk(rng, s, m, grid, "type_1")
    op = BatchedPlannedNufft(pts, grid, transform_type="type_1",
                             options=Options(backend="xla"))
    assert not op._planned
    got = np.asarray(op(src))
    for i in range(s):
        want = np.asarray(tfft.planar.nufft(
            src[i], pts[i], grid_shape=grid, transform_type="type_1",
            options=Options(backend="xla")))
        assert _relerr(got[i], want) < 1e-6


def test_from_batch_alias(rng):
    grid, s, m = (16, 16), 2, 100
    pts, _ = _mk(rng, s, m, grid, "type_2")
    op = PlannedNufft.from_batch(pts, grid,
                                 options=Options(backend="pallas"))
    assert isinstance(op, BatchedPlannedNufft)


def test_batched_shape_validation(rng):
    grid, s, m = (16, 16), 2, 100
    pts, src = _mk(rng, s, m, grid, "type_2")
    op = BatchedPlannedNufft(pts, grid, transform_type="type_2",
                             options=Options(backend="pallas"))
    with pytest.raises(ValueError, match="batched planned"):
        op(src[0])                          # missing S axis
    with pytest.raises(ValueError, match="batched planned"):
        op(src[:1])                         # wrong S
    with pytest.raises(ValueError):
        BatchedPlannedNufft(pts[0], grid)   # unstacked points
