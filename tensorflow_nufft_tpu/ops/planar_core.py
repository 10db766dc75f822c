"""Planar-real core NUFFT: complex values as a trailing (re, im) channel.

Mathematically identical to ``ops.core`` but every tensor is real with a
trailing (re, im) channel. The spread/interp/deconvolve stages are
real-linear and channel-independent, so the channel folds into the batch
axis; only the DFT and the VJP rotations see the channel explicitly.

VJP convention note: for planar (real) tensors JAX's vjp is the plain
real transpose. The real transpose of a complex-linear map's planar
representation is the planar representation of its conjugate transpose,
so grad_source uses the *adjoint* transform — swapped type AND direction
(coinciding with the reference's TF-convention gradient,
python/ops/nufft_ops.py:160-175) — unlike the complex path, where JAX's
convention calls for the unconjugated transpose.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tensorflow_nufft_tpu.fft.planar_fft import (
    amplify_pad_dft,
    dft_truncate_deconvolve,
)
from tensorflow_nufft_tpu.kernels import dispatch
from tensorflow_nufft_tpu.kernels.xla_ops import fold_and_rescale_split
from tensorflow_nufft_tpu.ops.core import _mode_grid, _replace
from tensorflow_nufft_tpu.plan.plan import (
    PlanSpec, check_fine_grid_size, make_plan)
from tensorflow_nufft_tpu.utils import profiling as prof


def _fold(x: jax.Array) -> jax.Array:
    """[B, *elem, 2] -> [2B, *elem] (channel becomes fastest batch dim)."""
    moved = jnp.moveaxis(x, -1, 1)
    return moved.reshape((x.shape[0] * 2,) + x.shape[1:-1])


def _unfold(x: jax.Array, batch: int) -> jax.Array:
    """[2B, *elem] -> [B, *elem, 2]."""
    split = x.reshape((batch, 2) + x.shape[1:])
    return jnp.moveaxis(split, 1, -1)


def _execute_planar(source: jax.Array, points: jax.Array,
                    plan) -> jax.Array:
    """Planar pipeline. source: [B, M, 2] (type-1) or [B, *grid, 2]
    (type-2); points: [M, rank]. Returns planar output."""
    spec = plan.spec
    batch = source.shape[0]
    check_fine_grid_size(plan, 2 * batch)    # planar: re/im channel pair
    with prof.scope("nufft.fold_rescale"):
        points_resc = fold_and_rescale_split(points, plan.fine_shape,
                                             spec.points_range)
    if spec.transform_type == "type_1":
        with prof.scope("nufft.spread"):
            fine = dispatch.spread(_fold(source), points_resc, plan)
        if spec.spread_only:
            scale = jnp.asarray(plan.kernel_scale, fine.dtype)
            return _unfold(fine * scale, batch)
        # DFT + mode truncation + deconvolution in one fused contraction.
        with prof.scope("nufft.mode_dft_deconvolve"):
            return dft_truncate_deconvolve(_unfold(fine, batch), plan)
    # type_2
    if spec.spread_only:
        with prof.scope("nufft.interp"):
            values = dispatch.interp(_fold(source), points_resc, plan)
        scale = jnp.asarray(plan.kernel_scale, values.dtype)
        return _unfold(values * scale, batch)
    # Amplification + zero-padding + DFT in one fused contraction.
    with prof.scope("nufft.amplify_dft"):
        grid = amplify_pad_dft(source, plan)
    with prof.scope("nufft.interp"):
        values = dispatch.interp(_fold(grid), points_resc, plan)
    return _unfold(values, batch)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def nufft_core_planar(source: jax.Array, points: jax.Array,
                      spec: PlanSpec) -> jax.Array:
    """Inner-batched planar NUFFT (one point set, B transforms)."""
    return _execute_planar(source, points, make_plan(spec))


def nufft_core_planar_raw(source, points, spec):
    """No custom VJP: JAX differentiates through the kernels (XLA path
    only; the standalone ops use ``spread_only_core_planar``)."""
    return _execute_planar(source, points, make_plan(spec))


@functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def spread_only_core_planar(source: jax.Array, points: jax.Array,
                            spec: PlanSpec) -> jax.Array:
    """Planar standalone spread/interp with an analytic custom VJP
    (see ops.core.spread_only_core). Everything is real here, so
    grad_source is the plain transpose (swapped type; there are no
    phases to conjugate in a spread-only op) and grad_points is the
    derivative-kernel interpolation contracted channel-wise."""
    return _execute_planar(source, points, make_plan(spec))


def _spread_only_planar_fwd(source, points, spec):
    return (spread_only_core_planar(source, points, spec),
            (source, points))


def _spread_only_planar_bwd(spec, residuals, cotangent):
    source, points = residuals
    plan = make_plan(spec)
    swapped = _replace(spec,
                       transform_type=("type_2"
                                       if spec.transform_type == "type_1"
                                       else "type_1"))
    grad_source = spread_only_core_planar(cotangent, points, swapped)
    if spec.transform_type == "type_2":
        grid_side, pts_side = source, cotangent   # [B,*grid,2], [B,M,2]
    else:
        grid_side, pts_side = cotangent, source
    batch = grid_side.shape[0]
    points_resc = fold_and_rescale_split(points, plan.fine_shape,
                                         spec.points_range)
    grid_cm = _fold(grid_side)                       # [2B, *grid]
    grads = []
    for d in range(plan.rank):
        aux = dispatch.interp_deriv(grid_cm, points_resc, plan, d)
        aux = _unfold(aux, batch)                    # [B, M, 2]
        g = jnp.sum(pts_side * aux, axis=(0, 2))     # real contraction
        factor = -plan.kernel_scale * plan.fine_shape[d] / (2.0 * np.pi)
        grads.append(g * factor)
    grad_points = jnp.stack(grads, axis=-1).astype(points.dtype)
    return grad_source, grad_points


spread_only_core_planar.defvjp(_spread_only_planar_fwd,
                               _spread_only_planar_bwd)


def _fwd(source, points, spec):
    return nufft_core_planar(source, points, spec), (source, points)


def _bwd(spec, residuals, cotangent):
    source, points = residuals
    plan = make_plan(spec)
    rank = plan.rank
    grid_shape = plan.grid_shape
    sign = -1.0 if spec.fft_direction == "forward" else 1.0

    # Real transpose == adjoint: swap type AND direction.
    adjoint = _replace(
        spec,
        transform_type=("type_2" if spec.transform_type == "type_1"
                        else "type_1"),
        fft_direction=("backward" if spec.fft_direction == "forward"
                       else "forward"))
    grad_source = nufft_core_planar(cotangent, points, adjoint)

    # Points gradient via mode-weighted type-2 transforms.
    #   type-2: grad[m,ax] = Re( conj(ct_m) i s t2_s(F k_ax)_m )
    #                      = s (ct_i aux_r - ct_r aux_i)
    #   type-1: grad[m,ax] = Re( i s c_m conj(t2_{-s}(ct k_ax)_m) )
    #                      = s (c_r aux_i - c_i aux_r)
    if spec.transform_type == "type_2":
        w_grid = source          # [B, *grid, 2]
        v_pts = cotangent        # [B, M, 2]
        aux_direction = spec.fft_direction
    else:
        w_grid = cotangent
        v_pts = source
        aux_direction = ("backward" if spec.fft_direction == "forward"
                         else "forward")

    batch = w_grid.shape[0]
    kgrids = np.stack(
        [_mode_grid(grid_shape, ax, np.float64) for ax in range(rank)])
    kgrids = jnp.asarray(kgrids, dtype=w_grid.dtype)     # [rank, *grid]
    weighted = w_grid[:, None] * kgrids[None, ..., None]  # [B,rank,*grid,2]
    t2_spec = _replace(spec, transform_type="type_2",
                       fft_direction=aux_direction, spread_only=False)
    aux = nufft_core_planar(
        weighted.reshape((batch * rank,) + grid_shape + (2,)), points,
        t2_spec)
    aux = aux.reshape(batch, rank, -1, 2)                # [B, rank, M, 2]

    vr = v_pts[..., 0]
    vi = v_pts[..., 1]
    aux_r = aux[..., 0]
    aux_i = aux[..., 1]
    if spec.transform_type == "type_2":
        per = vi[:, None] * aux_r - vr[:, None] * aux_i  # [B, rank, M]
    else:
        per = vr[:, None] * aux_i - vi[:, None] * aux_r
    grad_points = (sign * jnp.einsum("bam->ma", per)).astype(points.dtype)
    return grad_source, grad_points


nufft_core_planar.defvjp(_fwd, _bwd)
