"""Eager (NumPy) NUFFT on the native CPU engine.

Serves the full precision envelope on the host: complex128 down to 1e-14
tolerances (reference range: python/ops/nufft_ops.py:77-80), with the
C++/OpenMP engine for the spread/interp hot loops and NumPy's pocketfft
for the FFT stage. Plan math is shared with the JAX path, so the two
paths are numerically consistent by construction.

These functions take and return NumPy arrays and run eagerly (host).
For jit-embedded use, wrap with ``jax.pure_callback``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from tensorflow_nufft_tpu.native import engine
from tensorflow_nufft_tpu.options.options import Options
from tensorflow_nufft_tpu.plan.plan import NufftPlan, PlanSpec, make_plan

_TWO_PI = 2.0 * np.pi


def _fold_np(points: np.ndarray, fine_shape, points_range: int
             ) -> np.ndarray:
    n = np.asarray(fine_shape, dtype=points.dtype)
    x = points
    if points_range == 0:
        s = x + np.pi
    elif points_range == 1:
        s = np.where(x > np.pi, x - np.pi,
                     np.where(x < -np.pi, x + 3 * np.pi, x + np.pi))
    else:
        s = np.mod(x + np.pi, _TWO_PI)
        s = np.where(s < 0, s + _TWO_PI, s)
    return s * (n / _TWO_PI)


def _deconv_nd(x: np.ndarray, plan: NufftPlan) -> np.ndarray:
    """[B, *fine] spectrum -> [B, *grid] CMCL modes with weights."""
    for d in range(plan.rank):
        n = plan.grid_shape[d]
        nf = plan.fine_shape[d]
        axis = 1 + d
        neg = np.take(x, range(nf - n // 2, nf), axis=axis)
        pos = np.take(x, range(0, n - n // 2), axis=axis)
        x = np.concatenate([neg, pos], axis=axis)
        w = plan.deconv_weights(d)
        shape = [1] * x.ndim
        shape[axis] = n
        x = x * w.reshape(shape)
    return x


def _amplify_nd(x: np.ndarray, plan: NufftPlan) -> np.ndarray:
    """[B, *grid] CMCL modes -> [B, *fine] weighted zero-padded."""
    for d in range(plan.rank):
        n = plan.grid_shape[d]
        axis = 1 + d
        w = plan.deconv_weights(d)
        shape = [1] * x.ndim
        shape[axis] = n
        x = x * w.reshape(shape)
    for d in range(plan.rank):
        n = plan.grid_shape[d]
        nf = plan.fine_shape[d]
        axis = 1 + d
        pos = np.take(x, range(n // 2, n), axis=axis)
        neg = np.take(x, range(0, n // 2), axis=axis)
        pad_shape = list(x.shape)
        pad_shape[axis] = nf - n
        x = np.concatenate(
            [pos, np.zeros(pad_shape, x.dtype), neg], axis=axis)
    return x


def _fft(x: np.ndarray, rank: int, direction: str) -> np.ndarray:
    axes = tuple(range(-rank, 0))
    if direction == "forward":
        return np.fft.fftn(x, axes=axes)
    size = np.prod([x.shape[a] for a in axes])
    return np.fft.ifftn(x, axes=axes) * size


def _make_spec(transform_type, fft_direction, rank, grid_shape, dtype,
               tol, options, spread_only=False) -> PlanSpec:
    return PlanSpec(
        transform_type=transform_type,
        fft_direction=fft_direction,
        rank=rank,
        grid_shape=tuple(int(d) for d in grid_shape),
        dtype_name=str(np.dtype(dtype)),
        tol=float(tol),
        points_range=int(options.points_range),
        spread_only=spread_only,
        upsampling_factor=options.upsampling_factor,
        backend="xla",
    )


def nufft(source: np.ndarray,
          points: np.ndarray,
          grid_shape: Optional[Tuple[int, ...]] = None,
          transform_type: str = "type_2",
          fft_direction: str = "forward",
          tol: float = 1e-6,
          options: Optional[Options] = None) -> np.ndarray:
    """Eager native-engine NUFFT; same semantics as the JAX ``nufft``
    for a single transform or a leading batch dim sharing one point set.

    source: [M] / [B, M] (type-1) or [*grid] / [B, *grid] (type-2).
    points: [M, rank].
    """
    options = options or Options()
    source = np.asarray(source)
    points = np.asarray(points)
    rank = points.shape[-1]
    if transform_type == "type_1":
        if grid_shape is None:
            raise ValueError(
                "grid_shape must be provided for type-1 transforms")
        grid_shape = tuple(int(d) for d in grid_shape)
        elem_rank = 1
    else:
        grid_shape = tuple(int(d) for d in source.shape[-rank:])
        elem_rank = rank
    batched = source.ndim > elem_rank
    if not batched:
        source = source[None]
    spec = _make_spec(transform_type, fft_direction, rank, grid_shape,
                      source.dtype, tol, options)
    plan = make_plan(spec)
    pts = _fold_np(points.astype(np.float64), plan.fine_shape,
                   int(options.points_range))
    if transform_type == "type_1":
        fine = engine.spread(source, pts, plan.fine_shape, plan.width,
                             plan.beta)
        out = _deconv_nd(_fft(fine, rank, fft_direction), plan)
    else:
        fine = _fft(_amplify_nd(source, plan), rank, fft_direction)
        out = engine.interp(np.ascontiguousarray(fine), pts, plan.width,
                            plan.beta)
    out = out.astype(source.dtype)
    return out if batched else out[0]


def interp(source: np.ndarray, points: np.ndarray, tol: float = 1e-6,
           options: Optional[Options] = None) -> np.ndarray:
    """Eager native standalone interpolation (scaled); see ``interp``."""
    options = options or Options()
    source = np.asarray(source)
    points = np.asarray(points)
    rank = points.shape[-1]
    grid_shape = tuple(int(d) for d in source.shape[-rank:])
    batched = source.ndim > rank
    if not batched:
        source = source[None]
    spec = _make_spec("type_2", "forward", rank, grid_shape,
                      source.dtype, tol, options, spread_only=True)
    plan = make_plan(spec)
    pts = _fold_np(points.astype(np.float64), plan.fine_shape,
                   int(options.points_range))
    out = engine.interp(np.ascontiguousarray(source), pts, plan.width,
                        plan.beta) * plan.kernel_scale
    out = out.astype(source.dtype)
    return out if batched else out[0]


def spread(source: np.ndarray, points: np.ndarray, grid_shape,
           tol: float = 1e-6,
           options: Optional[Options] = None) -> np.ndarray:
    """Eager native standalone spreading (scaled); see ``spread``."""
    options = options or Options()
    source = np.asarray(source)
    points = np.asarray(points)
    rank = points.shape[-1]
    grid_shape = tuple(int(d) for d in grid_shape)
    batched = source.ndim > 1
    if not batched:
        source = source[None]
    spec = _make_spec("type_1", "forward", rank, grid_shape,
                      source.dtype, tol, options, spread_only=True)
    plan = make_plan(spec)
    pts = _fold_np(points.astype(np.float64), plan.fine_shape,
                   int(options.points_range))
    out = engine.spread(source, pts, plan.fine_shape, plan.width,
                        plan.beta) * plan.kernel_scale
    out = out.astype(source.dtype)
    return out if batched else out[0]
