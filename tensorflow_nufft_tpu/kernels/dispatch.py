"""Backend dispatch for the spread/interp hot loops.

Mirrors the reference's spread-method auto-selection
(cc/kernels/nufft_plan.cu.cc:1871-1879). 'pallas' is the tile-exclusive
spread kernel (``kernels/triton_spread.py``: compiled through Triton on
a GPU, interpreted on the CPU), 'xla' the portable scatter/gather path,
'native' the C++ host engine. Interpolation is XLA's gather on every
device (the reference's GPU interp is the same per-point gather,
NUPTS_DRIVEN). 'auto' picks the spread kernel on a GPU where it was
measured faster end to end, and XLA otherwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tensorflow_nufft_tpu.kernels import xla_ops
from tensorflow_nufft_tpu.plan.plan import NufftPlan

# Ranks whose type-1 is faster on a GPU with the spread kernel than
# with the XLA scatter (measured end to end on an H100; see PERF.md).
AUTO_GPU_RANKS = (2, 3)


def spread_kernel_active(plan: NufftPlan, dtype) -> bool:
    """Whether the tile-exclusive spread kernel serves this plan for
    data of ``dtype`` (planar float32 only).

    ``backend='pallas'`` forces the kernel and raises where it cannot
    serve the transform; 'auto' uses it on a GPU for the ranks in
    ``AUTO_GPU_RANKS``."""
    from tensorflow_nufft_tpu.kernels import triton_spread
    backend = plan.spec.backend
    if backend in ("xla", "native"):
        return False
    is_complex_data = jnp.issubdtype(np.dtype(dtype), jnp.complexfloating)
    if backend == "pallas":
        if is_complex_data:
            raise ValueError(
                "backend='pallas' serves the planar (real, trailing "
                "re/im channel) pipeline only; complex-dtype arrays "
                "dispatch to XLA. Use the planar API or backend='xla'.")
        if not triton_spread.supports(plan):
            raise ValueError(
                f"backend='pallas' requires complex64/planar-float32 "
                f"data and rank in (1, 2, 3); got "
                f"dtype_name={plan.spec.dtype_name!r}, rank={plan.rank}. "
                f"Use backend='xla' (or 'auto') instead.")
        return True
    return (not is_complex_data
            and triton_spread.platform() == "gpu"
            and triton_spread.supports(plan)
            and plan.rank in AUTO_GPU_RANKS)


def _native_requested(plan: NufftPlan) -> bool:
    if plan.spec.backend != "native":
        return False
    from tensorflow_nufft_tpu.native import engine
    return engine.available()


def _points_pair(points_resc):
    if isinstance(points_resc, tuple):
        return points_resc
    return points_resc, jnp.zeros_like(points_resc)


def _host_points(hi, lo):
    """Reconstructs float64 coordinates from the two-float pair on the
    host (the engine takes double points for full precision)."""
    return np.asarray(hi).astype(np.float64) + np.asarray(lo)


def _native_spread_callback(strengths, points_resc, plan: NufftPlan):
    """Host-callback spread on the C++ engine (complex or planar)."""
    from tensorflow_nufft_tpu.native import engine

    complex_in = jnp.issubdtype(strengths.dtype, jnp.complexfloating)
    out_shape = (strengths.shape[0],) + plan.fine_shape
    hi, lo = _points_pair(points_resc)

    if complex_in:
        def host(s, p_hi, p_lo):
            s = np.asarray(s)
            return engine.spread(
                s, _host_points(p_hi, p_lo), plan.fine_shape,
                plan.width, plan.beta).astype(s.dtype)
        result = jax.ShapeDtypeStruct(out_shape, strengths.dtype)
        return jax.pure_callback(host, result, strengths, hi, lo,
                                 vmap_method="sequential")

    # Planar real: fold the (re, im) channel pair through the complex
    # engine by viewing consecutive batch rows as complex pairs.
    def host_planar(s, p_hi, p_lo):
        s = np.asarray(s)                      # [B2, M] real, (b, c)
        c_dt = np.complex64 if s.dtype == np.float32 else np.complex128
        z = s[0::2] + 1j * s[1::2]
        out = engine.spread(z.astype(c_dt), _host_points(p_hi, p_lo),
                            plan.fine_shape, plan.width, plan.beta)
        stacked = np.empty((s.shape[0],) + plan.fine_shape, s.dtype)
        stacked[0::2] = out.real
        stacked[1::2] = out.imag
        return stacked

    result = jax.ShapeDtypeStruct(out_shape, strengths.dtype)
    return jax.pure_callback(host_planar, result, strengths, hi, lo,
                             vmap_method="sequential")


def _native_interp_callback(fine, points_resc, plan: NufftPlan):
    from tensorflow_nufft_tpu.native import engine

    complex_in = jnp.issubdtype(fine.dtype, jnp.complexfloating)
    hi, lo = _points_pair(points_resc)
    m = hi.shape[0]
    out_shape = (fine.shape[0], m)

    if complex_in:
        def host(f, p_hi, p_lo):
            f = np.ascontiguousarray(np.asarray(f))
            return engine.interp(f, _host_points(p_hi, p_lo),
                                 plan.width, plan.beta).astype(f.dtype)
        result = jax.ShapeDtypeStruct(out_shape, fine.dtype)
        return jax.pure_callback(host, result, fine, hi, lo,
                                 vmap_method="sequential")

    def host_planar(f, p_hi, p_lo):
        f = np.asarray(f)                      # [B2, *fine] real
        c_dt = np.complex64 if f.dtype == np.float32 else np.complex128
        z = (f[0::2] + 1j * f[1::2]).astype(c_dt)
        out = engine.interp(np.ascontiguousarray(z),
                            _host_points(p_hi, p_lo), plan.width,
                            plan.beta)
        stacked = np.empty((f.shape[0], out.shape[1]), f.dtype)
        stacked[0::2] = out.real
        stacked[1::2] = out.imag
        return stacked

    result = jax.ShapeDtypeStruct(out_shape, fine.dtype)
    return jax.pure_callback(host_planar, result, fine, hi, lo,
                             vmap_method="sequential")


def spread(strengths: jax.Array, points_resc: jax.Array,
           plan: NufftPlan) -> jax.Array:
    """[B, M] strengths + [M, rank] rescaled points -> [B, *fine_shape]."""
    if _native_requested(plan):
        return _native_spread_callback(strengths, points_resc, plan)
    if spread_kernel_active(plan, strengths.dtype):
        from tensorflow_nufft_tpu.kernels import binning, triton_spread
        tiles, geom = triton_spread.spread(strengths, points_resc, plan)
        return binning.overlap_add(tiles, geom).astype(strengths.dtype)
    indices, kernels = xla_ops.spread_geometry(points_resc, plan)
    return xla_ops.spread_xla(strengths, indices, kernels, plan)


def interp(fine: jax.Array, points_resc: jax.Array,
           plan: NufftPlan) -> jax.Array:
    """[B, *fine_shape] grid + [M, rank] rescaled points -> [B, M]."""
    if _native_requested(plan):
        return _native_interp_callback(fine, points_resc, plan)
    indices, kernels = xla_ops.spread_geometry(points_resc, plan)
    return xla_ops.interp_xla(fine, indices, kernels, plan)


def interp_deriv(fine: jax.Array, points_resc, plan: NufftPlan,
                 axis: int) -> jax.Array:
    """``interp`` with the analytic ES-kernel derivative phi' on one
    axis — the building block of the spread-only custom VJPs
    (ops.core.spread_only_core): the points-gradient of both standalone
    ops is a derivative-kernel interpolation of the grid-side quantity.
    XLA on every backend (the native engine has no derivative path)."""
    indices, kernels = xla_ops.spread_geometry(points_resc, plan,
                                               deriv_axis=axis)
    return xla_ops.interp_xla(fine, indices, kernels, plan)
