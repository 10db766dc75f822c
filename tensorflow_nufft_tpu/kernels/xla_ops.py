"""Portable XLA implementations of the NUFFT spread/interp stages.

These are the portable device path: pure jnp/lax, correct on every backend,
differentiable, and the numerical oracle for the spread kernel. The hot
loops are written as a ``lax.scan`` over kernel-offset combinations so peak
memory is O(M * width) instead of O(M * width^rank).

Reference behavior being reproduced (re-designed, not translated):
  - fold/rescale of points into [0, fine_dim) with STRICT/EXTENDED/INFINITE
    variants: cc/kernels/nufft_plan.h:676-734.
  - ES kernel evaluation: cc/kernels/nufft_util.cc:64-69.
  - spreading/interpolation with periodic index wrap:
    cc/kernels/nufft_plan.cc:883-1806.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tensorflow_nufft_tpu.plan.plan import NufftPlan

# PointsRange enum values (match proto: STRICT=0, EXTENDED=1, INFINITE=2).
STRICT = 0
EXTENDED = 1
INFINITE = 2

_PI = np.pi
_TWO_PI = 2.0 * np.pi


def fold_and_rescale(points: jax.Array, fine_shape: Sequence[int],
                     points_range: int) -> jax.Array:
    """Maps point coordinates from radians to fine-grid units in [0, nf).

    ``points`` has shape [..., rank]; coordinate d is scaled by
    ``fine_shape[d]``. The three variants mirror the reference functors
    (nufft_plan.h:683-734): STRICT assumes [-pi, pi] and only shifts,
    EXTENDED folds once from [-3pi, 3pi], INFINITE folds any value.
    """
    n = jnp.asarray(np.array(fine_shape, dtype=np.float64),
                    dtype=points.dtype)
    pi = jnp.asarray(_PI, dtype=points.dtype)
    two_pi = jnp.asarray(_TWO_PI, dtype=points.dtype)
    x = points
    if points_range == STRICT:
        s = x + pi
    elif points_range == EXTENDED:
        s = jnp.where(x > pi, x - pi, jnp.where(x < -pi, x + 3 * pi, x + pi))
    elif points_range == INFINITE:
        s = jnp.mod(x + pi, two_pi)
        s = jnp.where(s < 0, s + two_pi, s)
    else:
        raise ValueError(f"Invalid points_range: {points_range}")
    return s * (n / two_pi)


def fold_and_rescale_split(points: jax.Array, fine_shape: Sequence[int],
                           points_range: int
                           ) -> Tuple[jax.Array, jax.Array]:
    """Two-float (hi, lo) fold/rescale for float32 points.

    A rescaled coordinate s in [0, nf) stored in one float32 carries an
    absolute error of ~nf * 2^-25 grid units, which turns into a phase
    error of ~k_max * 2pi * 2^-25 at the largest modes — 1e-5-scale for
    256^2 grids, dominating the NUFFT error budget at tol 1e-6. This
    returns s as an exact-compensated pair (s_hi + s_lo ~ 1e-12 grid
    units of error) using Dekker/Veltkamp arithmetic. The corrections
    are wrapped in ``optimization_barrier`` so that no compiler
    reassociates them away (the compensation would silently become 0).

    Note pi * (nf / 2pi) == nf/2 exactly, so the +pi shift is the exact
    integer nf/2 and only the product x * c needs compensation.
    """
    if points.dtype == jnp.float64:
        s = fold_and_rescale(points, fine_shape, points_range)
        return s, jnp.zeros_like(s)

    bar = jax.lax.optimization_barrier
    n64 = np.array(fine_shape, dtype=np.float64)
    c64 = n64 / (2.0 * np.pi)
    c_hi = c64.astype(np.float32)
    c_lo = (c64 - c_hi.astype(np.float64)).astype(np.float32)
    # Exact Veltkamp split of the per-dim c_hi constants (host, f32).
    w = c_hi * np.float32(4097.0)
    b1 = (w - (w - c_hi)).astype(np.float32)
    b2 = (c_hi - b1).astype(np.float32)

    x = points
    n_f = jnp.asarray(n64, jnp.float32)
    xw = x * jnp.float32(4097.0)
    a_hi = bar(xw - bar(xw - x))
    a_lo = bar(x - a_hi)
    b1 = jnp.asarray(b1)
    b2 = jnp.asarray(b2)
    p = bar(x * jnp.asarray(c_hi))
    err = bar(bar(bar(a_hi * b1 - p) + a_hi * b2) + a_lo * b1) \
        + a_lo * b2 + x * jnp.asarray(c_lo)

    pi = jnp.float32(np.pi)
    half_n = jnp.asarray(n64 / 2.0, jnp.float32)
    if points_range == STRICT:
        offset = jnp.broadcast_to(half_n, x.shape)
    elif points_range == EXTENDED:
        offset = half_n - n_f * (x > pi) + n_f * (x < -pi)
    elif points_range == INFINITE:
        offset = jnp.broadcast_to(half_n, x.shape)
    else:
        raise ValueError(f"Invalid points_range: {points_range}")

    s_hi = bar(p + offset)
    err = err + bar(p - bar(s_hi - offset))
    if points_range == INFINITE:
        # Compensated wrap: q*n_f can round (n_f is 5-smooth, not a power
        # of two) and so can the subtraction; both residuals feed err so
        # far-out-of-range points keep two-float coordinate precision.
        q = jnp.floor(s_hi / n_f)
        t0 = s_hi - q * n_f
        q = q + (t0 >= n_f) - (t0 < 0)     # land in [0, n_f) directly
        qw = q * jnp.float32(4097.0)
        q_hi = bar(qw - bar(qw - q))
        q_lo = bar(q - q_hi)
        prod = bar(q * n_f)
        prod_err = bar(bar(q_hi * n_f - prod) + q_lo * n_f)
        # Knuth TwoSum (branch-free; no magnitude precondition).
        b_ = -prod
        t = bar(s_hi + b_)
        bb = bar(t - s_hi)
        sub_err = bar(bar(s_hi - bar(t - bb)) + bar(b_ - bb))
        s_hi = t
        err = err + sub_err - prod_err
        s_hi = jnp.where(s_hi < 0, s_hi + n_f, s_hi)
        s_hi = jnp.where(s_hi >= n_f, s_hi - n_f, s_hi)
    return s_hi, err


def es_kernel(z: jax.Array, beta: float, c: float,
              half_width: float) -> jax.Array:
    """"Exponential of semicircle" kernel phi(z) = exp(beta sqrt(1 - c z^2)).

    Zero outside |z| < half_width. Uses the double-where trick so the
    gradient is well-defined at the support boundary.
    """
    inside = jnp.abs(z) < half_width
    arg = 1.0 - c * jnp.square(z)
    arg_safe = jnp.where(inside, jnp.maximum(arg, 0.0), 1.0)
    val = jnp.exp(beta * jnp.sqrt(arg_safe))
    return jnp.where(inside, val, 0.0)


def es_kernel_horner(z: jax.Array, horner, half_width: float) -> jax.Array:
    """Horner evaluation of the plan's fitted kernel polynomial.

    More accurate than ``es_kernel`` in float32 (~3e-7 vs ~1e-6
    relative-to-peak; the exp argument rounding is amplified by beta)
    and transcendental-free. ``horner`` are ascending power-basis
    coefficients in t = 2 (z/half_width)^2 - 1 (see
    plan.fit_horner_coeffs).
    """
    dt = z.dtype
    u = jnp.square(z) * dt.type(2.0 / (half_width * half_width))
    t = u - dt.type(1.0)
    inside = t < dt.type(1.0)
    # Clamp masked lanes so far-out sentinels don't overflow to inf
    # (inf * 0 = nan would poison gradients).
    t = jnp.where(inside, t, dt.type(1.0))
    acc = jnp.full_like(t, dt.type(horner[-1]))
    for a in horner[-2::-1]:
        acc = acc * t + dt.type(a)
    return jnp.where(inside, acc, dt.type(0.0))


def es_kernel_deriv(z: jax.Array, beta: float, c: float,
                    half_width: float) -> jax.Array:
    """Analytic ES-kernel derivative
    phi'(z) = -beta c z phi(z) / sqrt(1 - c z^2), zero outside the
    support. Used by the spread-only custom VJPs (the reference defines
    no gradient for Spread/Interp at all; this exceeds parity). Direct
    evaluation only — the Horner fit approximates phi, not phi'."""
    inside = jnp.abs(z) < half_width
    arg = 1.0 - c * jnp.square(z)
    # Floor keeps the edge-of-support derivative finite (the true
    # derivative diverges as arg -> 0; measure-zero, and the clamp
    # matches autodiff of es_kernel's sqrt at the same points).
    arg_safe = jnp.where(inside, jnp.maximum(arg, 1e-12), 1.0)
    r = jnp.sqrt(arg_safe)
    val = -beta * c * z * jnp.exp(beta * r) / r
    return jnp.where(inside, val, 0.0)


def es_kernel_for(z: jax.Array, plan) -> jax.Array:
    """Kernel evaluation dispatch: fitted Horner polynomial when the
    plan has one and the computation is float32, direct exp/sqrt
    otherwise (f64 direct eval is already ~1e-15 accurate)."""
    if plan.horner is not None and z.dtype == jnp.float32:
        return es_kernel_horner(z, plan.horner, plan.half_width)
    return es_kernel(z, plan.beta, plan.c, plan.half_width)


def _match_vma(init: jax.Array, like: jax.Array) -> jax.Array:
    """Marks a fresh (zeros) scan carry as varying over the same
    shard_map manual axes as ``like``, so carry-in and carry-out types
    agree under shard_map's vma check (no-op outside shard_map)."""
    vma = jax.typeof(like).vma
    if not vma:
        return init
    if hasattr(jax.lax, "pcast"):       # pvary deprecated in newer jax
        return jax.lax.pcast(init, tuple(vma), to="varying")
    return jax.lax.pvary(init, tuple(vma))


def spread_geometry(points_resc, plan: NufftPlan, deriv_axis=None
                    ) -> Tuple[Tuple[jax.Array, ...], Tuple[jax.Array, ...]]:
    """Per-dimension spreading indices and kernel values.

    Args:
        points_resc: coordinates in fine-grid units, in [0, nf): either a
            [M, rank] array or a two-float (hi, lo) pair of such arrays
            (see ``fold_and_rescale_split``).
        plan: the static plan.
        deriv_axis: if set, that axis's kernel values are the analytic
            derivative phi'(z) instead of phi(z) (spread-only VJPs).

    Returns:
        (indices, kernels): per dim, ``indices[d]`` is an int32 [M, width]
        array of periodically wrapped fine-grid indices and ``kernels[d]``
        is the matching [M, width] array of kernel values. The leftmost
        covered grid index is ceil(s - width/2), as in the reference
        spreader (nufft_plan.cc:1463-1636).
    """
    if isinstance(points_resc, tuple):
        points_hi, points_lo = points_resc
    else:
        points_hi, points_lo = points_resc, None
    width = plan.width
    offsets = jnp.arange(width, dtype=points_hi.dtype)
    indices = []
    kernels = []
    for d in range(plan.rank):
        s = points_hi[:, d]
        i0 = jnp.ceil(s - plan.half_width)
        # (i0 + j) - s is exact (nearby f32 magnitudes); the low word
        # restores full coordinate precision.
        z = i0[:, None] + offsets[None, :] - s[:, None]      # [M, width]
        if points_lo is not None:
            z = z - points_lo[:, d][:, None]
        if deriv_axis == d:
            ker = es_kernel_deriv(z, plan.beta, plan.c, plan.half_width)
        else:
            ker = es_kernel_for(z, plan)
        idx = (i0.astype(jnp.int32)[:, None]
               + offsets.astype(jnp.int32)[None, :])
        idx = jnp.mod(idx, plan.fine_shape[d])
        indices.append(idx)
        kernels.append(ker)
    return tuple(indices), tuple(kernels)


def _flat_strides(fine_shape: Sequence[int]) -> Tuple[int, ...]:
    strides = [1] * len(fine_shape)
    for d in range(len(fine_shape) - 2, -1, -1):
        strides[d] = strides[d + 1] * fine_shape[d + 1]
    return tuple(strides)


def spread_xla(strengths: jax.Array, indices, kernels,
               plan: NufftPlan) -> jax.Array:
    """Spreads NU strengths onto the fine grid (type-1 step 1).

    Args:
        strengths: [B, M] complex strengths (inner-vectorized batch).
        indices/kernels: output of ``spread_geometry``.
        plan: static plan.

    Returns:
        [B, *fine_shape] complex fine grid.

    XLA lowers the scatter-add to atomics on a GPU, so results vary in
    the last bits from run to run; the spread kernel
    (``kernels/triton_spread.py``) replaces this with tile-exclusive
    accumulation.
    """
    rank = plan.rank
    width = plan.width
    batch = strengths.shape[0]
    fine_flat_size = plan.fine_size
    strides = _flat_strides(plan.fine_shape)
    out = _match_vma(
        jnp.zeros((batch, fine_flat_size), dtype=strengths.dtype),
        strengths)

    if rank == 1:
        vals = strengths[:, :, None] * kernels[0][None].astype(strengths.dtype)
        out = out.at[:, indices[0]].add(vals)
        return out.reshape((batch,) + plan.fine_shape)

    # Scan over the leading rank-1 offset combinations; vectorize the last
    # dim. Memory: O(B * M * width) per step.
    num_combos = width ** (rank - 1)

    def body(carry, combo):
        if rank == 2:
            j0 = combo
            lead_idx = jnp.take(indices[0], j0, axis=1) * strides[0]
            lead_ker = jnp.take(kernels[0], j0, axis=1)
        else:
            j0 = combo // width
            j1 = combo % width
            lead_idx = (jnp.take(indices[0], j0, axis=1) * strides[0]
                        + jnp.take(indices[1], j1, axis=1) * strides[1])
            lead_ker = (jnp.take(kernels[0], j0, axis=1)
                        * jnp.take(kernels[1], j1, axis=1))
        flat = lead_idx[:, None] + indices[-1]               # [M, width]
        wts = (lead_ker[:, None] * kernels[-1]).astype(strengths.dtype)
        vals = strengths[:, :, None] * wts[None]             # [B, M, width]
        carry = carry.at[:, flat].add(vals)
        return carry, None

    out, _ = jax.lax.scan(body, out, jnp.arange(num_combos))
    return out.reshape((batch,) + plan.fine_shape)


def interp_xla(fine: jax.Array, indices, kernels,
               plan: NufftPlan) -> jax.Array:
    """Interpolates fine-grid values at NU points (type-2 step 3).

    Args:
        fine: [B, *fine_shape] complex fine grid.
        indices/kernels: output of ``spread_geometry``.

    Returns:
        [B, M] complex values at the points.
    """
    rank = plan.rank
    width = plan.width
    batch = fine.shape[0]
    num_points = indices[0].shape[0]
    strides = _flat_strides(plan.fine_shape)
    fine_flat = fine.reshape(batch, -1)

    if rank == 1:
        vals = fine_flat[:, indices[0]]                      # [B, M, width]
        return jnp.sum(vals * kernels[0][None].astype(fine.dtype), axis=-1)

    num_combos = width ** (rank - 1)
    acc0 = _match_vma(
        jnp.zeros((batch, num_points), dtype=fine.dtype), fine)

    def body(carry, combo):
        if rank == 2:
            j0 = combo
            lead_idx = jnp.take(indices[0], j0, axis=1) * strides[0]
            lead_ker = jnp.take(kernels[0], j0, axis=1)
        else:
            j0 = combo // width
            j1 = combo % width
            lead_idx = (jnp.take(indices[0], j0, axis=1) * strides[0]
                        + jnp.take(indices[1], j1, axis=1) * strides[1])
            lead_ker = (jnp.take(kernels[0], j0, axis=1)
                        * jnp.take(kernels[1], j1, axis=1))
        flat = lead_idx[:, None] + indices[-1]               # [M, width]
        wts = (lead_ker[:, None] * kernels[-1]).astype(fine.dtype)
        vals = fine_flat[:, flat]                            # [B, M, width]
        carry = carry + jnp.sum(vals * wts[None], axis=-1)
        return carry, None

    acc, _ = jax.lax.scan(body, acc0, jnp.arange(num_combos))
    return acc
