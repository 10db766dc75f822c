"""Tolerance conformance sweep: achieved accuracy
tracks the requested tolerance across eps and precisions."""

import numpy as np
import pytest

import tensorflow_nufft_tpu as tfft
from tests.conftest import random_complex, random_points


def _err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


@pytest.mark.parametrize("tol", [1e-2, 1e-4, 1e-6])
def test_c64_accuracy_tracks_tol(rng, tol):
    grid_shape = (16, 16)
    m = 40
    points = random_points(rng, (m, 2), np.float32)
    src = random_complex(rng, grid_shape, np.complex64)
    got = tfft.nufft(src, points, tol=tol)
    want = tfft.nudft(src, points)
    # The ES-kernel guarantee is ~1 digit of slack; f32 floors at ~1e-6.
    assert _err(got, want) < max(10 * tol, 5e-6)


@pytest.mark.parametrize("tol", [1e-4, 1e-8, 1e-12])
def test_c128_accuracy_tracks_tol(rng, tol):
    grid_shape = (12, 16)
    m = 30
    points = random_points(rng, (m, 2), np.float64)
    src = random_complex(rng, grid_shape, np.complex128)
    got = tfft.nufft(src, points, tol=tol)
    want = tfft.nudft(src, points)
    assert _err(got, want) < 10 * tol


def test_tighter_tol_not_worse(rng):
    """Monotonicity: decreasing tol never increases the error by more
    than noise (catches kernel-width selection regressions)."""
    grid_shape = (16,)
    m = 25
    points = random_points(rng, (m, 1), np.float64)
    src = random_complex(rng, (16,), np.complex128)
    want = tfft.nudft(src, points)
    errs = [_err(tfft.nufft(src, points, tol=t), want)
            for t in (1e-2, 1e-5, 1e-8, 1e-11)]
    for a, b in zip(errs, errs[1:]):
        assert b < a * 1.5 + 1e-13


@pytest.mark.parametrize("rank_shape", [(32,), (16, 20), (14, 16, 18)])
def test_api_conformance_all_ranks(rng, rank_shape):
    """1D/2D/3D API conformance at default tol, both types."""
    rank = len(rank_shape)
    m = 20
    points = random_points(rng, (m, rank), np.float32)
    grid = random_complex(rng, rank_shape, np.complex64)
    c = random_complex(rng, (m,), np.complex64)
    t2 = tfft.nufft(grid, points)
    t1 = tfft.nufft(c, points, grid_shape=rank_shape,
                    transform_type="type_1")
    assert t2.shape == (m,)
    assert t1.shape == rank_shape
    assert _err(t2, tfft.nudft(grid, points)) < 1e-3
    assert _err(t1, tfft.nudft(c, points, grid_shape=rank_shape,
                               transform_type="type_1")) < 1e-3
