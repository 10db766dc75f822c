"""Core inner-batched NUFFT transform with custom VJP.

``nufft_core`` computes one transform (or an inner-vectorized batch of
transforms sharing one point set), the unit the reference calls a "plan
execution" (cc/kernels/nufft_plan.cc:316-351). The public API in
``nufft_ops`` layers broadcasting/batching on top.

The gradients reproduce the reference's mathematical structure
(python/ops/nufft_ops.py:126-232) — adjoint-pair transform for the source
cotangent and a mode-index-weighted type-2 transform for the points
cotangent — but in JAX's vjp convention (plain transpose, no conjugation),
so they agree exactly with ``jax.vjp`` of the dense ``nudft`` oracle:

  type-2 forward:  y_m = sum_k F_k e^{i s k.x_m}    (s = -1 fwd, +1 bwd)
    d/dF   (vjp):  type-1, same direction, of the cotangent.
    d/dx   (vjp):  Re( ct_m * i s * type2(F * k_ax)_m ).
  type-1 is symmetric.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tensorflow_nufft_tpu.fft.fft_ops import amplify, deconvolve, fft_fine
from tensorflow_nufft_tpu.kernels import dispatch
from tensorflow_nufft_tpu.kernels.xla_ops import fold_and_rescale_split
from tensorflow_nufft_tpu.plan.plan import (
    NufftPlan, PlanSpec, check_fine_grid_size, make_plan)
from tensorflow_nufft_tpu.utils import profiling as prof


def _execute(source: jax.Array, points: jax.Array,
             plan: NufftPlan) -> jax.Array:
    """Runs the 3-step NUFFT (or spread/interp-only) pipeline.

    Args:
        source: [B, M] (type-1) or [B, *grid_shape] (type-2), complex.
        points: [M, rank] in radians.

    Returns:
        [B, *grid_shape] (type-1) or [B, M] (type-2), complex.
    """
    spec = plan.spec
    check_fine_grid_size(plan, source.shape[0])
    with prof.scope("nufft.fold_rescale"):
        points_resc = fold_and_rescale_split(points, plan.fine_shape,
                                             spec.points_range)
    if spec.transform_type == "type_1":
        with prof.scope("nufft.spread"):
            fine = dispatch.spread(source, points_resc, plan)
        if spec.spread_only:
            return fine * jnp.asarray(plan.kernel_scale, source.dtype)
        with prof.scope("nufft.fft"):
            fine_hat = fft_fine(fine, plan.rank, spec.fft_direction)
        with prof.scope("nufft.deconvolve"):
            return deconvolve(fine_hat, plan)
    # type_2
    if spec.spread_only:
        with prof.scope("nufft.interp"):
            values = dispatch.interp(source, points_resc, plan)
        return values * jnp.asarray(plan.kernel_scale, source.dtype)
    with prof.scope("nufft.amplify"):
        fine = amplify(source, plan)
    with prof.scope("nufft.fft"):
        grid = fft_fine(fine, plan.rank, spec.fft_direction)
    with prof.scope("nufft.interp"):
        return dispatch.interp(grid, points_resc, plan)


def _mode_grid(grid_shape: Tuple[int, ...], axis: int,
               dtype) -> np.ndarray:
    """Mode indices k along ``axis`` broadcast over the grid, CMCL order.

    Integer modes k = i - N//2 (the reference oracle uses
    linspace(-N/2, N/2-1) — identical for even N; for odd N we use the
    integer modes that the reference's C++ kernels use,
    cc/kernels/nufft_plan.cc:729-733).
    """
    n = grid_shape[axis]
    k = (np.arange(n) - n // 2).astype(np.dtype(dtype))
    shape = [1] * len(grid_shape)
    shape[axis] = n
    return np.broadcast_to(k.reshape(shape), grid_shape)


def _replace(spec: PlanSpec, **kw) -> PlanSpec:
    import dataclasses
    return dataclasses.replace(spec, **kw)


def nufft_core_raw(source: jax.Array, points: jax.Array,
                   spec: PlanSpec) -> jax.Array:
    """Like ``nufft_core`` but without the custom VJP: JAX differentiates
    through the spread/interp kernels themselves (XLA path only — the
    Pallas kernels are not transposable; the standalone ops use
    ``spread_only_core`` instead)."""
    plan = make_plan(spec)
    return _execute(source, points, plan)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def spread_only_core(source: jax.Array, points: jax.Array,
                     spec: PlanSpec) -> jax.Array:
    """Standalone spread/interp (spec.spread_only) with an analytic
    custom VJP.

    The reference defines no gradients for Spread/Interp at all (only
    NUFFT has one: python/ops/nufft_ops.py:126); this exceeds parity.
    grad_source is the adjoint op (the kernels are real, so the plain
    transpose is just the swapped type); grad_points uses the analytic
    ES-kernel derivative phi'(z) = -beta c z phi(z)/sqrt(1 - c z^2)
    via a derivative-kernel interpolation — which lets the forward run
    the (non-differentiable-through) spread kernel or native engine.
    """
    return _execute(source, points, make_plan(spec))


def _spread_only_grad_points(grid_side: jax.Array, pts_side: jax.Array,
                             points: jax.Array, plan: NufftPlan):
    """Shared grad-points for the spread-only VJPs (complex form).

    grad_x[m, d] = Re( sum_b pts_side[b, m]
                       * scale * Dinterp_d(grid_side)[b, m] )
                   * (-nf_d / 2pi)
    where Dinterp_d interpolates with phi' on axis d. The -nf_d/2pi
    factor is dz/dx of the fold/rescale (z = index - s(x), s = x
    nf/2pi + nf/2). JAX's complex-vjp pairing is bilinear
    (unconjugated), hence the plain product under Re (cf.
    _nufft_core_bwd)."""
    spec = plan.spec
    points_resc = fold_and_rescale_split(points, plan.fine_shape,
                                         spec.points_range)
    grads = []
    for d in range(plan.rank):
        aux = dispatch.interp_deriv(grid_side, points_resc, plan, d)
        g = jnp.real(jnp.sum(pts_side * aux, axis=0))
        factor = -plan.kernel_scale * plan.fine_shape[d] / (2.0 * np.pi)
        grads.append(g * factor)
    return jnp.stack(grads, axis=-1).astype(points.dtype)


def _spread_only_fwd(source, points, spec):
    return spread_only_core(source, points, spec), (source, points)


def _spread_only_bwd(spec, residuals, cotangent):
    source, points = residuals
    plan = make_plan(spec)
    swapped = _replace(spec,
                       transform_type=("type_2"
                                       if spec.transform_type == "type_1"
                                       else "type_1"))
    grad_source = spread_only_core(cotangent, points, swapped)
    if spec.transform_type == "type_2":
        grid_side, pts_side = source, cotangent
    else:
        grid_side, pts_side = cotangent, source
    grad_points = _spread_only_grad_points(grid_side, pts_side, points,
                                           plan)
    return grad_source, grad_points


spread_only_core.defvjp(_spread_only_fwd, _spread_only_bwd)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def nufft_core(source: jax.Array, points: jax.Array,
               spec: PlanSpec) -> jax.Array:
    """Inner-batched NUFFT: one point set, B vectorized transforms."""
    plan = make_plan(spec)
    return _execute(source, points, plan)


def _nufft_core_fwd(source, points, spec):
    return nufft_core(source, points, spec), (source, points)


def _nufft_core_bwd(spec, residuals, cotangent):
    source, points = residuals
    plan = make_plan(spec)
    grid_shape = plan.grid_shape
    rank = plan.rank
    dtype = cotangent.dtype

    # --- Gradient w.r.t. source: swapped type, same direction (plain
    # transpose; JAX convention).
    swapped = _replace(spec,
                       transform_type=("type_2"
                                       if spec.transform_type == "type_1"
                                       else "type_1"))
    grad_source = nufft_core(cotangent, points, swapped)

    # --- Gradient w.r.t. points: mode-weighted type-2 transform.
    # W: grid-side quantity; V: points-side quantity.
    if spec.transform_type == "type_2":
        w_grid = source          # [B, *grid]
        v_pts = cotangent        # [B, M]
    else:
        w_grid = cotangent       # [B, *grid]
        v_pts = source           # [B, M]

    batch = w_grid.shape[0]
    kgrids = np.stack(
        [_mode_grid(grid_shape, ax, np.float64) for ax in range(rank)])
    kgrids = jnp.asarray(kgrids, dtype=dtype)            # [rank, *grid]
    weighted = w_grid[:, None] * kgrids[None]            # [B, rank, *grid]
    t2_spec = _replace(spec, transform_type="type_2", spread_only=False)
    aux = nufft_core(
        weighted.reshape((batch * rank,) + grid_shape), points, t2_spec)
    aux = aux.reshape(batch, rank, -1)                   # [B, rank, M]

    plan_sign = -1.0 if spec.fft_direction == "forward" else 1.0
    i_sigma = jnp.asarray(1j * plan_sign, dtype=dtype)
    # grad_points[m, ax] = Re( i*s * sum_b aux[b, ax, m] * V[b, m] )
    grad_points = jnp.real(
        i_sigma * jnp.einsum("bam,bm->ma", aux, v_pts,
                             precision=jax.lax.Precision.HIGHEST))
    grad_points = grad_points.astype(points.dtype)
    return grad_source, grad_points


nufft_core.defvjp(_nufft_core_fwd, _nufft_core_bwd)
