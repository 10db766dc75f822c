"""Planar-real NUFFT API: complex values as a trailing (re, im) channel.

A complex array ``z`` is carried as a real array
``p = stack([z.real, z.imag], -1)``. The planar pipeline is the one the
tile-exclusive spread kernel serves (``kernels/triton_spread.py``), and
the home of the planned transforms.

Function signatures mirror the top-level complex API (and the reference,
python/ops/nufft_ops.py:34-123) with every complex argument/result gaining
a trailing channel axis of size 2:

    kspace = tfft.planar.nufft(image_p, points)   # image_p: [*grid, 2]

Helpers ``to_planar``/``from_planar`` convert on the host.

Gradient convention: these are real-valued functions, so ``jax.vjp`` is
the plain real transpose, which equals the planar representation of the
complex *adjoint* (conjugate transpose). Gradients of any real scalar
loss agree with the complex API's; raw cotangent pulls differ by the
conjugation convention, as they must.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from tensorflow_nufft_tpu.ops.nufft_ops import (
    _apply_batched,
    _canonical_grid_shape,
    _validate_enum,
    _VALID_FFT_DIRECTIONS,
    _VALID_TRANSFORM_TYPES,
)
from tensorflow_nufft_tpu.ops.planar_core import (
    nufft_core_planar,
    spread_only_core_planar,
)
from tensorflow_nufft_tpu.options.options import Options
from tensorflow_nufft_tpu.plan.plan import (
    PlanSpec, auto_max_batch_size, log_plan_summary,
    warn_if_tol_clamped)

_FLOAT_DTYPES = (np.dtype(np.float32), np.dtype(np.float64))


def to_planar(z) -> jnp.ndarray:
    """complex array -> planar real array with trailing (re, im) axis."""
    z = np.asarray(z)
    return jnp.asarray(np.stack([z.real, z.imag], axis=-1))


def from_planar(p) -> np.ndarray:
    """planar real array -> complex numpy array (host-side)."""
    p = np.asarray(p)
    return p[..., 0] + 1j * p[..., 1]


def _check_planar_inputs(source, points, name="source"):
    if source.dtype not in _FLOAT_DTYPES:
        raise TypeError(
            f"planar {name} must be float32 or float64, got "
            f"{source.dtype}.")
    if source.ndim < 1 or source.shape[-1] != 2:
        raise ValueError(
            f"planar {name} must have a trailing (re, im) axis of size 2, "
            f"got shape {source.shape}.")
    if points.dtype != source.dtype:
        raise TypeError(
            f"points must have dtype {source.dtype} (same as planar "
            f"{name}), got {points.dtype}.")
    if points.ndim < 2:
        raise ValueError(
            f"points must have shape [..., M, rank], got {points.shape}.")


def _dtype_name(dtype) -> str:
    return "complex64" if np.dtype(dtype) == np.float32 else "complex128"


def nufft(source,
          points,
          grid_shape=None,
          transform_type: str = "type_2",
          fft_direction: str = "forward",
          tol: float = 1e-6,
          options: Optional[Options] = None):
    """Planar NUFFT. See the top-level ``nufft`` for semantics.

    Args:
        source: planar complex: [..., M, 2] (type-1) or
            [...] + grid_shape + [2] (type-2), float32/float64.
        points: [..., M, rank] same float dtype, radians in [-pi, pi].

    Returns:
        [...] + grid_shape + [2] (type-1) or [..., M, 2] (type-2).
    """
    options = options or Options()
    transform_type = _validate_enum(
        transform_type, _VALID_TRANSFORM_TYPES, "transform_type")
    fft_direction = _validate_enum(
        fft_direction, _VALID_FFT_DIRECTIONS, "fft_direction")
    source = jnp.asarray(source)
    points = jnp.asarray(points)
    _check_planar_inputs(source, points)
    rank = int(points.shape[-1])
    if rank not in (1, 2, 3):
        raise ValueError(f"rank must be 1, 2 or 3, got {rank}.")
    num_points = int(points.shape[-2])

    if transform_type == "type_1":
        if grid_shape is None:
            raise ValueError(
                "grid_shape must be provided for type-1 transforms")
        grid_shape = _canonical_grid_shape(grid_shape)
        if len(grid_shape) != rank:
            raise ValueError(
                f"grid_shape must represent a rank-{rank} shape. "
                f"Received: {grid_shape}")
        if int(source.shape[-2]) != num_points:
            raise ValueError(
                f"source and points have incompatible number of points: "
                f"{source.shape[-2]} vs {num_points}.")
        elem_rank = 2                       # (M, 2)
        out_elem_shape = grid_shape + (2,)
    else:
        if source.ndim < rank + 1:
            raise ValueError(
                f"planar source must have at least rank {rank + 1}, got "
                f"shape {source.shape}.")
        grid_shape = tuple(int(d) for d in source.shape[-rank - 1:-1])
        elem_rank = rank + 1                # (*grid, 2)
        out_elem_shape = (num_points, 2)

    spec = PlanSpec(
        transform_type=transform_type,
        fft_direction=fft_direction,
        rank=rank,
        grid_shape=grid_shape,
        dtype_name=_dtype_name(source.dtype),
        tol=float(tol),
        points_range=int(options.points_range),
        spread_only=False,
        upsampling_factor=options.upsampling_factor,
        backend=options.backend,
        kernel_evaluation_method=options.kernel_evaluation_method,
    )
    warn_if_tol_clamped(tol, spec.dtype_name, options.show_warnings)
    log_plan_summary(spec, options.verbosity)
    max_bs = options.max_batch_size
    if max_bs is None:
        max_bs = auto_max_batch_size(spec, channels_per_batch=2)
    out = _apply_batched(nufft_core_planar, source, points, spec,
                         elem_rank, out_elem_shape, max_bs)
    if options.debugging.check_points_range:
        out = _poison_if_out_of_range_planar(out, points, options)
    return out


def _poison_if_out_of_range_planar(out, points, options: Options):
    """Planar twin of the complex API's device-side points-range check
    (ops/nufft_ops._poison_if_out_of_range; reference:
    nufft_plan.h:866-898): eager Python error on concrete inputs, NaN
    poisoning under jit."""
    from tensorflow_nufft_tpu.options.options import PointsRange
    if options.points_range == PointsRange.INFINITE:
        return out
    bound = np.pi if options.points_range == PointsRange.STRICT \
        else 3 * np.pi
    ok = jnp.all((points > -bound) & (points < bound))
    try:
        concrete_ok = bool(ok)
    except jax.errors.TracerBoolConversionError:
        return jnp.where(ok, out, jnp.asarray(np.nan, out.dtype))
    if not concrete_ok:
        raise ValueError(
            f"points are not within the supported range "
            f"[-{bound / np.pi:g}*pi, {bound / np.pi:g}*pi]. "
            "Use a wider options.points_range or disable "
            "options.debugging.check_points_range.")
    return out


def interp(source, points, tol: float = 1e-6,
           options: Optional[Options] = None):
    """Planar standalone interpolation; see top-level ``interp``."""
    return _spread_or_interp("type_2", source, points, None, tol, options)


def spread(source, points, grid_shape, tol: float = 1e-6,
           options: Optional[Options] = None):
    """Planar standalone spreading; see top-level ``spread``."""
    return _spread_or_interp("type_1", source, points, grid_shape, tol,
                             options)


def _spread_or_interp(transform_type, source, points, grid_shape, tol,
                      options):
    options = options or Options()
    source = jnp.asarray(source)
    points = jnp.asarray(points)
    _check_planar_inputs(source, points)
    rank = int(points.shape[-1])
    if rank not in (1, 2, 3):
        raise ValueError(f"rank must be 1, 2 or 3, got {rank}.")
    num_points = int(points.shape[-2])

    if transform_type == "type_1":
        grid_shape = _canonical_grid_shape(grid_shape)
        if len(grid_shape) != rank:
            raise ValueError(
                f"grid_shape must represent a rank-{rank} shape. "
                f"Received: {grid_shape}")
        if int(source.shape[-2]) != num_points:
            raise ValueError(
                f"source and points have incompatible number of points: "
                f"{source.shape[-2]} vs {num_points}.")
        elem_rank = 2
        out_elem_shape = grid_shape + (2,)
    else:
        grid_shape = tuple(int(d) for d in source.shape[-rank - 1:-1])
        elem_rank = rank + 1
        out_elem_shape = (num_points, 2)

    spec = PlanSpec(
        transform_type=transform_type,
        fft_direction="forward",
        rank=rank,
        grid_shape=grid_shape,
        dtype_name=_dtype_name(source.dtype),
        tol=float(tol),
        points_range=int(options.points_range),
        spread_only=True,
        upsampling_factor=None,
        backend=options.backend,
        kernel_evaluation_method=options.kernel_evaluation_method,
    )
    warn_if_tol_clamped(tol, spec.dtype_name, options.show_warnings)
    log_plan_summary(spec, options.verbosity)
    max_bs = options.max_batch_size
    if max_bs is None:
        max_bs = auto_max_batch_size(spec, channels_per_batch=2)
    return _apply_batched(spread_only_core_planar, source, points,
                          spec, elem_rank, out_elem_shape, max_bs)


def nudft(source,
          points,
          grid_shape=None,
          transform_type: str = "type_2",
          fft_direction: str = "forward"):
    """Planar dense NUDFT oracle (testing; real arithmetic throughout)."""
    transform_type = _validate_enum(
        transform_type, _VALID_TRANSFORM_TYPES, "transform_type")
    fft_direction = _validate_enum(
        fft_direction, _VALID_FFT_DIRECTIONS, "fft_direction")
    source = jnp.asarray(source)
    points = jnp.asarray(points)
    _check_planar_inputs(source, points)
    rank = int(points.shape[-1])
    num_points = int(points.shape[-2])
    if transform_type == "type_1":
        if grid_shape is None:
            raise ValueError(
                "grid_shape must be provided for type-1 transforms")
        grid_shape = _canonical_grid_shape(grid_shape)
        elem_rank = 2
        out_elem_shape = grid_shape + (2,)
    else:
        grid_shape = tuple(int(d) for d in source.shape[-rank - 1:-1])
        elem_rank = rank + 1
        out_elem_shape = (num_points, 2)

    sign = -1.0 if fft_direction == "forward" else 1.0
    k_vecs = [np.arange(n) - n // 2 for n in grid_shape]
    k_grid = np.stack(np.meshgrid(*k_vecs, indexing="ij"),
                      axis=0).reshape(rank, -1)
    k_grid = jnp.asarray(k_grid, dtype=points.dtype)

    # Oracle accuracy trumps speed: a float32 matmul at default precision
    # may run in TF32 (or bf16), and a ~0.1% relative error on phases of
    # magnitude ~N*pi/2 destroys the oracle entirely. Force full-f32
    # (HIGHEST) arithmetic throughout.
    hi = jax.lax.Precision.HIGHEST

    def core(src, pts, _spec=None):
        theta = jnp.matmul(pts, k_grid, precision=hi)   # [M, N]
        cos = jnp.cos(theta)
        sin = sign * jnp.sin(theta)
        if transform_type == "type_1":
            sr = src[..., 0]                     # [B, M]
            si = src[..., 1]
            # y_k = sum_m (sr + i si)(cos + i sin)
            yr = jnp.einsum("bm,mn->bn", sr, cos, precision=hi) - \
                jnp.einsum("bm,mn->bn", si, sin, precision=hi)
            yi = jnp.einsum("bm,mn->bn", sr, sin, precision=hi) + \
                jnp.einsum("bm,mn->bn", si, cos, precision=hi)
            out = jnp.stack([yr, yi], axis=-1)
            return out.reshape((src.shape[0],) + grid_shape + (2,))
        flat = src.reshape(src.shape[0], -1, 2)  # [B, N, 2]
        sr = flat[..., 0]
        si = flat[..., 1]
        yr = jnp.einsum("bn,mn->bm", sr, cos, precision=hi) - \
            jnp.einsum("bn,mn->bm", si, sin, precision=hi)
        yi = jnp.einsum("bn,mn->bm", sr, sin, precision=hi) + \
            jnp.einsum("bn,mn->bm", si, cos, precision=hi)
        return jnp.stack([yr, yi], axis=-1)

    return _apply_batched(core, source, points, None, elem_rank,
                          out_elem_shape, None)


# ---------------------------------------------------------------------------
# Planned transforms (FINUFFT "guru"-style; the reference's internal
# Plan::initialize / set_points / execute split, cc/kernels/
# nufft_plan.h:223-256, exposed as an API: the fold, the tile binning
# and the slot-order kernel coordinates depend only on the points and
# are computed ONCE here, so each type-1 apply runs only the values
# permutation, the spread kernel and the mode contraction.)
# ---------------------------------------------------------------------------


import functools as _functools


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _planned_call(source, planned):
    return planned._apply(source)


@_functools.partial(jax.custom_vjp, nondiff_argnums=(2,))
def _planned_normal_call(source, slot_w, planned):
    return planned._apply_normal(source, slot_w)


def _planned_normal_fwd(source, slot_w, planned):
    return _planned_normal_call(source, slot_w, planned), slot_w


def _planned_normal_bwd(planned, slot_w, cotangent):
    # A^H W A with real W is self-adjoint, and the planar-real
    # transpose of a self-adjoint complex-linear operator is itself.
    # Weights are treated as non-differentiable plan data.
    return (_planned_normal_call(cotangent, slot_w, planned),
            None if slot_w is None else jnp.zeros_like(slot_w))


_planned_normal_call.defvjp(_planned_normal_fwd, _planned_normal_bwd)


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _planned_slots_call(source, planned):
    return planned._apply_slots(source)


def _planned_slots_fwd(source, planned):
    return _planned_slots_call(source, planned), None


def _planned_slots_bwd(planned, _, cotangent):
    # The slot-space operator is the point-space operator conjugated by
    # the slot embedding (both directions mask to real slots), so its
    # planar-real transpose is the adjoint plan's slot-space apply.
    return (_planned_slots_call(cotangent, planned.adjoint()),)


_planned_slots_call.defvjp(_planned_slots_fwd, _planned_slots_bwd)


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _to_slots_call(values, planned):
    return planned._to_slots(values)


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _from_slots_call(slot_values, planned):
    return planned._from_slots(slot_values)


def _to_slots_fwd(values, planned):
    return _to_slots_call(values, planned), None


def _to_slots_bwd(planned, _, cotangent):
    # to_slots is the slot embedding E (zeros in padded/unused slots);
    # its real transpose is exactly the padpos gather back (E^T).
    return (_from_slots_call(cotangent, planned),)


def _from_slots_fwd(slot_values, planned):
    return _from_slots_call(slot_values, planned), None


def _from_slots_bwd(planned, _, cotangent):
    return (_to_slots_call(cotangent, planned),)


_to_slots_call.defvjp(_to_slots_fwd, _to_slots_bwd)
_from_slots_call.defvjp(_from_slots_fwd, _from_slots_bwd)


def _planned_fwd(source, planned):
    return _planned_call(source, planned), None


def _planned_bwd(planned, _, cotangent):
    # Real transpose == adjoint: swap type AND direction; the adjoint
    # shares every points-side artifact (same points, same plan width).
    return (_planned_call(cotangent, planned.adjoint()),)


_planned_call.defvjp(_planned_fwd, _planned_bwd)

# Eager applies run compiled, as one program (the same one a caller's
# jit inlines); the plan object is a static argument.
_planned_call_jit = jax.jit(_planned_call, static_argnums=1)
_planned_normal_jit = jax.jit(_planned_normal_call, static_argnums=2)
_planned_slots_jit = jax.jit(_planned_slots_call, static_argnums=1)


def _planned_prep(pts, *, geom, fine_shape, points_range):
    """Points-side planned preprocessing — pure and jit/vmap-able;
    shared by PlannedNufft and the batched shard builder (batch_build).
    Returns (points_resc, binned, slot coords)."""
    from tensorflow_nufft_tpu.kernels import binning
    from tensorflow_nufft_tpu.kernels.xla_ops import (
        fold_and_rescale_split)
    pr = fold_and_rescale_split(pts, fine_shape, points_range)
    binned = binning.bin_points(pr, geom)
    return pr, binned, binning.slot_coords(binned)


def planned_spread_modes(values_slots, coords, tile_bounds, plan, geom,
                         batch: int):
    """Slot-order channel-major values [2B, S] -> planar modes
    [B, *grid, 2]: the spread kernel and the overlap-add, then the
    fused DFT + truncation + deconvolution contraction. Shared by the
    planned and sharded-planned transforms."""
    from tensorflow_nufft_tpu.fft.planar_fft import dft_truncate_deconvolve
    from tensorflow_nufft_tpu.kernels import binning, triton_spread
    from tensorflow_nufft_tpu.ops.planar_core import _unfold
    from tensorflow_nufft_tpu.utils import profiling as prof
    with prof.scope("nufft.spread"):
        tiles = triton_spread.spread_tiles(values_slots, coords,
                                           tile_bounds, plan, geom)
        fine = binning.overlap_add(tiles, geom)
    with prof.scope("nufft.mode_dft_deconvolve"):
        return dft_truncate_deconvolve(_unfold(fine, batch), plan)


def planned_interp(source, points_resc, plan):
    """Planar modes [B, *grid, 2] -> channel-major point values
    [2B, M]: amplify + pad + DFT contraction, then the gather interp."""
    from tensorflow_nufft_tpu.fft.planar_fft import amplify_pad_dft
    from tensorflow_nufft_tpu.kernels import dispatch
    from tensorflow_nufft_tpu.ops.planar_core import _fold
    from tensorflow_nufft_tpu.utils import profiling as prof
    with prof.scope("nufft.amplify_dft"):
        grid = amplify_pad_dft(source, plan)
    with prof.scope("nufft.interp"):
        return dispatch.interp(_fold(grid), points_resc, plan)


def _channel_major(x):
    """[B, N, 2] -> [2B, N] (row order (b, ch))."""
    b, n = x.shape[0], x.shape[1]
    return jnp.moveaxis(x, -1, 1).reshape(2 * b, n)


def _planar_rows(x, batch: int):
    """[2B, N] -> [B, N, 2] (inverse of ``_channel_major``)."""
    return jnp.moveaxis(x.reshape(batch, 2, x.shape[-1]), 1, -1)


class PlannedNufft:
    """Planned planar NUFFT: fixed points, repeated applies.

    Precomputes everything that depends only on the points — the fold,
    the tile binning and the slot-order kernel coordinates — so each
    ``__call__`` runs only the value-dependent work. This is the planner
    analog of the reference's internal ``Plan::initialize``/
    ``set_points`` (nufft_plan.h:223-256) and of FINUFFT's guru
    interface.

    Differentiable w.r.t. ``source`` (the adjoint shares the plan);
    points are fixed by construction.

    The plan is binned where the tile-exclusive spread kernel serves the
    configuration (``dispatch.spread_kernel_active``); elsewhere it
    falls back to the unplanned pipeline and the slot surface is the
    identity.
    """

    def __init__(self, points, grid_shape, transform_type="type_2",
                 fft_direction="forward", tol: float = 1e-6,
                 options: Optional[Options] = None):
        from tensorflow_nufft_tpu.kernels import binning, dispatch
        from tensorflow_nufft_tpu.plan.plan import make_plan

        transform_type = _validate_enum(
            transform_type, _VALID_TRANSFORM_TYPES, "transform_type")
        fft_direction = _validate_enum(
            fft_direction, _VALID_FFT_DIRECTIONS, "fft_direction")
        options = options or Options()
        points = jnp.asarray(points)
        if points.ndim != 2:
            raise ValueError(
                f"planned transforms take a single [M, rank] point set, "
                f"got shape {points.shape}")
        grid_shape = _canonical_grid_shape(grid_shape)
        rank = int(points.shape[-1])
        if len(grid_shape) != rank:
            raise ValueError(
                f"grid_shape must have rank {rank}, got {grid_shape}")
        self.points = points
        self.grid_shape = grid_shape
        self.transform_type = transform_type
        self.fft_direction = fft_direction
        self.tol = float(tol)
        self.options = options
        spec = PlanSpec(
            transform_type=transform_type, fft_direction=fft_direction,
            rank=rank, grid_shape=grid_shape,
            dtype_name=_dtype_name(points.dtype), tol=float(tol),
            points_range=int(options.points_range), spread_only=False,
            upsampling_factor=options.upsampling_factor,
            backend=options.backend,
            kernel_evaluation_method=options.kernel_evaluation_method)
        self.spec = spec
        self.plan = make_plan(spec)
        self._adjoint = None
        self._planned = dispatch.spread_kernel_active(self.plan,
                                                      points.dtype)
        if not self._planned:
            return
        self.geom = binning.choose_geometry(
            self.plan.fine_shape, self.plan.width, int(points.shape[0]))
        self._set_artifacts(jax.jit(self._prep_fn())(points))

    def _prep_fn(self):
        return _functools.partial(
            _planned_prep, geom=self.geom,
            fine_shape=self.plan.fine_shape,
            points_range=self.spec.points_range)

    def _set_artifacts(self, arts):
        """Installs one shard's (points_resc, binned, coords) prep
        outputs. Traced construction is allowed (the one-shot type-3
        path builds its inner type-2 under the caller's jit); the cached
        tracer artifacts are then valid only within that trace — the
        plan's lifetime in that mode."""
        pr, binned, coords = arts
        self.points_resc = pr
        self.binned = binned
        self.coords = coords
        m = int(self.points.shape[0])
        self._slot_mask = (binned.invpos < m).astype(jnp.float32)

    @classmethod
    def batch_build(cls, points_stack, grid_shape,
                    transform_type="type_2", fft_direction="forward",
                    tol: float = 1e-6,
                    options: Optional[Options] = None):
        """Builds one PlannedNufft per leading slice of ``points_stack``
        ([S, M, rank]) with the points-side preprocessing of ALL shards
        traced and executed as ONE vmapped jit — plan-build wall time
        is then ~flat in S instead of S sequential prep dispatches.
        Equal shard sizes mean identical static geometry, so one trace
        serves every shard.
        """
        points_stack = jnp.asarray(points_stack)
        s = points_stack.shape[0]
        p0 = cls(points_stack[0], grid_shape,
                 transform_type=transform_type,
                 fft_direction=fft_direction, tol=tol, options=options)
        if s == 1 or not p0._planned:
            return [p0] + [cls(points_stack[i], grid_shape,
                               transform_type=transform_type,
                               fft_direction=fft_direction, tol=tol,
                               options=options) for i in range(1, s)]
        arts_stack = jax.jit(jax.vmap(p0._prep_fn()))(points_stack)
        shards = []
        for i in range(s):
            sh = object.__new__(cls)
            sh.__dict__.update(p0.__dict__)
            sh.points = points_stack[i]
            sh._adjoint = None
            sh._set_artifacts(jax.tree.map(lambda x, i=i: x[i], arts_stack))
            shards.append(sh)
        return shards

    @classmethod
    def from_batch(cls, points_batch, grid_shape, **kwargs):
        """Batched planned transforms over stacked per-batch
        trajectories ([S, M, rank] -> one planned transform per slice,
        applied in one call); see ``BatchedPlannedNufft``."""
        return BatchedPlannedNufft(points_batch, grid_shape, **kwargs)

    def adjoint(self) -> "PlannedNufft":
        """The adjoint planned transform (swapped type and direction),
        sharing all points-side artifacts."""
        if getattr(self, "_adjoint", None) is None:
            adj = object.__new__(PlannedNufft)
            adj.__dict__.update(self.__dict__)
            adj.transform_type = ("type_2"
                                  if self.transform_type == "type_1"
                                  else "type_1")
            adj.fft_direction = ("backward"
                                 if self.fft_direction == "forward"
                                 else "forward")
            import dataclasses
            from tensorflow_nufft_tpu.plan.plan import make_plan
            adj.spec = dataclasses.replace(
                self.spec, transform_type=adj.transform_type,
                fft_direction=adj.fft_direction)
            adj.plan = make_plan(adj.spec)
            adj._adjoint = self
            self._adjoint = adj
        return self._adjoint

    def _spread_modes(self, values_slots, batch, plan=None):
        return planned_spread_modes(
            values_slots, self.coords, self.binned.tile_bounds,
            plan or self.plan, self.geom, batch)

    def _apply(self, source):
        from tensorflow_nufft_tpu.kernels import binning
        batch = source.shape[0]
        if self.transform_type == "type_1":
            vals = binning.to_slots(
                _channel_major(source).astype(jnp.float32), self.binned)
            return self._spread_modes(vals, batch).astype(source.dtype)
        values = planned_interp(source, self.points_resc, self.plan)
        return _planar_rows(values, batch).astype(source.dtype)

    def slot_weights(self, weights) -> jax.Array:
        """Per-point real weights [M] -> chunk-slot order for
        ``normal`` (zero in padded slots). Compute once per weight
        vector and reuse across iterations."""
        from tensorflow_nufft_tpu.kernels import binning
        weights = jnp.asarray(weights)
        if not self._planned:
            return weights
        return binning.to_slots(weights.astype(jnp.float32)[None],
                                self.binned)[0]

    def normal(self, source, slot_w=None):
        """Normal operator ``A^H W A``: the type-2 forward followed by
        the type-1 adjoint, with the intermediate point values moved to
        slot order once and weighted there.

        Args:
            source: [B, *grid, 2] planar images.
            slot_w: optional slot-order real weights from
                ``slot_weights`` (density compensation). Treated as
                non-differentiable.

        Returns:
            [B, *grid, 2] planar ``A^H W A source``.

        Mirrors the role of composed forward+adjoint in the
        reference's toeplitz-free CG recon (docs/examples
        mri_app.ipynb).
        """
        source = jnp.asarray(source)
        if not self._planned:
            # Unplanned fallback: slot_weights returned the weights in
            # point order (there is no slot layout); apply them to the
            # intermediate point values directly.
            t2 = (self if self.transform_type == "type_2"
                  else self.adjoint())
            vals = t2(source)
            if slot_w is not None:
                vals = vals * jax.lax.stop_gradient(
                    jnp.asarray(slot_w))[None, :, None]
            return t2.adjoint()(vals)
        return _planned_normal_jit(source, slot_w, self)

    def _apply_normal(self, source, slot_w=None):
        from tensorflow_nufft_tpu.kernels import binning
        t2 = self if self.transform_type == "type_2" else self.adjoint()
        batch = source.shape[0]
        vals = planned_interp(source, t2.points_resc, t2.plan)
        flat = binning.to_slots(vals.astype(jnp.float32), t2.binned)
        if slot_w is not None:
            flat = flat * jax.lax.stop_gradient(slot_w)[None, :]
        out = t2._spread_modes(flat, batch, plan=t2.adjoint().plan)
        return out.astype(source.dtype)

    # -- chunk-slot-order apply surface -------------------------------
    # The spread kernel's native point layout is the chunk-padded SLOT
    # stream (binning.BinnedPoints); point-order type-1 applies pay one
    # permutation gather per call to convert. Iterative pipelines that
    # keep their per-point vectors in slot order skip it: convert fixed
    # data ONCE with ``to_slots`` (e.g. measured k-space), then loop on
    # ``apply_to_slots``/``apply_from_slots``. FINUFFT/the reference
    # have no analog (their sorted order is internal only).

    @property
    def num_slots(self) -> int:
        """Length S of the slot axis ([B, S, 2] slot-order vectors)."""
        if not self._planned:
            return int(self.points.shape[0])
        return int(self.geom.num_slots)

    @property
    def slot_mask(self) -> jax.Array:
        """[S] float32; 1 where the slot holds a real point, 0 in
        padded / unused slots. Use to restrict slot-space reductions
        (norms, inner products) to real points."""
        if not self._planned:
            # Not cached: under jit this would cache a tracer.
            return jnp.ones((self.num_slots,), jnp.float32)
        return self._slot_mask

    def to_slots(self, values) -> jax.Array:
        """Point-order planar values [B, M, 2] -> slot order [B, S, 2]
        (zeros in padded/unused slots). One gather; convert
        loop-invariant data once, outside the iteration."""
        values = jnp.asarray(values)
        m = int(self.points.shape[0])
        if not (values.ndim == 3 and values.shape[1] == m
                and values.shape[-1] == 2):
            raise ValueError(
                f"to_slots expects [B, {m}, 2] planar values, got "
                f"shape {values.shape}")
        if not self._planned:
            return values
        return _to_slots_call(values, self)

    def from_slots(self, slot_values) -> jax.Array:
        """Slot-order planar values [B, S, 2] -> point order
        [B, M, 2] (one gather; the inverse of ``to_slots``)."""
        slot_values = jnp.asarray(slot_values)
        s = self.num_slots
        if not (slot_values.ndim == 3 and slot_values.shape[1] == s
                and slot_values.shape[-1] == 2):
            raise ValueError(
                f"from_slots expects [B, {s}, 2] slot-order values, "
                f"got shape {slot_values.shape}")
        if not self._planned:
            return slot_values
        return _from_slots_call(slot_values, self)

    def _to_slots(self, values):
        from tensorflow_nufft_tpu.kernels import binning
        flat = binning.to_slots(_channel_major(values), self.binned)
        return _planar_rows(flat, values.shape[0])

    def _from_slots(self, slot_values):
        from tensorflow_nufft_tpu.kernels import binning
        flat = binning.from_slots(_channel_major(slot_values), self.binned)
        return _planar_rows(flat, slot_values.shape[0])

    def apply_to_slots(self, source) -> jax.Array:
        """Type-2 apply producing SLOT-ORDER values [B, S, 2].
        Equivalent to ``plan.to_slots(plan(source))``; padded and
        unused slots come out exactly zero. Differentiable w.r.t.
        ``source``."""
        if self.transform_type != "type_2":
            raise ValueError(
                "apply_to_slots is the type-2 (grid -> points) apply; "
                "this plan is type_1 (use adjoint(), or "
                "apply_from_slots)")
        source = jnp.asarray(source)
        expect = tuple(self.grid_shape)
        if not (source.ndim == len(expect) + 2
                and tuple(source.shape[1:-1]) == expect
                and source.shape[-1] == 2):
            raise ValueError(
                f"apply_to_slots expects [B, "
                f"{', '.join(str(g) for g in expect)}, 2], got shape "
                f"{source.shape}")
        if not self._planned:
            return self(source)        # slot order == point order
        return _planned_slots_jit(source, self)

    def apply_from_slots(self, slot_values) -> jax.Array:
        """Type-1 apply consuming SLOT-ORDER values [B, S, 2] -> grid
        [B, *grid, 2] — skips the per-call values permutation gather of
        ``__call__``. Padded/unused input slots are masked out (only
        real-point slots contribute). Differentiable w.r.t.
        ``slot_values``."""
        if self.transform_type != "type_1":
            raise ValueError(
                "apply_from_slots is the type-1 (points -> grid) "
                "apply; this plan is type_2 (use adjoint(), or "
                "apply_to_slots)")
        slot_values = jnp.asarray(slot_values)
        s = self.num_slots
        if not (slot_values.ndim == 3 and slot_values.shape[1] == s
                and slot_values.shape[-1] == 2):
            raise ValueError(
                f"apply_from_slots expects [B, {s}, 2] slot-order "
                f"values, got shape {slot_values.shape}")
        if not self._planned:
            return self(slot_values)   # slot order == point order
        return _planned_slots_jit(slot_values, self)

    def _apply_slots(self, source):
        from tensorflow_nufft_tpu.kernels import binning
        batch = source.shape[0]
        keep = self.slot_mask > 0
        if self.transform_type == "type_1":
            vals = jnp.where(keep[None, :],
                             _channel_major(source).astype(jnp.float32),
                             0.0)
            return self._spread_modes(vals, batch).astype(source.dtype)
        values = planned_interp(source, self.points_resc, self.plan)
        flat = binning.to_slots(values, self.binned)
        return _planar_rows(flat, batch).astype(source.dtype)

    def __call__(self, source):
        """Applies the transform to planar ``source``.

        Type-2: [B, *grid, 2] -> [B, M, 2]; type-1: [B, M, 2] ->
        [B, *grid, 2]. A leading batch dim is required (use B=1).
        """
        source = jnp.asarray(source)
        m = int(self.points.shape[0])
        if self.transform_type == "type_1":
            expect = ("[B, {}, 2]".format(m),)
            ok = (source.ndim == 3 and source.shape[1] == m
                  and source.shape[-1] == 2)
        else:
            expect = ("[B, {}, 2]".format(
                ", ".join(str(g) for g in self.grid_shape)),)
            ok = (source.ndim == len(self.grid_shape) + 2
                  and tuple(source.shape[1:-1]) == self.grid_shape
                  and source.shape[-1] == 2)
        if not ok:
            raise ValueError(
                f"planned {self.transform_type} expects a source of "
                f"shape {expect[0]} (leading batch, trailing (re, im)); "
                f"got shape {source.shape}")
        if not self._planned:
            return nufft(source, self.points, grid_shape=self.grid_shape,
                         transform_type=self.transform_type,
                         fft_direction=self.fft_direction, tol=self.tol,
                         options=self.options)
        return _planned_call_jit(source, self)


# ---------------------------------------------------------------------------
# Batched planned transforms: one trajectory per batch element.
# ---------------------------------------------------------------------------


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _batched_planned_call(source, batched):
    return batched._apply(source)


def _batched_planned_fwd(source, batched):
    return _batched_planned_call(source, batched), None


def _batched_planned_bwd(batched, _, cotangent):
    # Real transpose == adjoint per trajectory; the adjoint batch
    # shares every per-trajectory points-side artifact.
    return (_batched_planned_call(cotangent, batched.adjoint()),)


_batched_planned_call.defvjp(_batched_planned_fwd, _batched_planned_bwd)


class BatchedPlannedNufft:
    """Planned planar NUFFT over a STACK of trajectories: points
    [S, M, rank], one planned transform per leading slice, applied in
    one jit-compiled call.

    This serves the reference's outer points-batch loop (per-batch
    trajectories, cc/kernels/nufft_kernels.cc:491 loops ``set_points``
    + ``execute`` per batch element) at planned speed: the points-side
    preprocessing of all S trajectories runs as ONE vmapped prep at
    construction (``PlannedNufft.batch_build``), and each apply runs S
    planned transforms back-to-back — no per-call binning.

    Apply shapes (planar, one transform per trajectory):
      type_2: [S, *grid, 2] -> [S, M, 2]
      type_1: [S, M, 2]     -> [S, *grid, 2]
    An optional inner batch axis B (transforms sharing trajectory i)
    is accepted as [S, B, ...] -> [S, B, ...].

    Differentiable w.r.t. ``source`` (adjoint-batch custom VJP);
    points are fixed by construction. Falls back to the unplanned
    vmapped pipeline where the spread kernel does not serve the
    configuration.
    """

    def __init__(self, points_batch, grid_shape,
                 transform_type="type_2", fft_direction="forward",
                 tol: float = 1e-6, options: Optional[Options] = None):
        points_batch = jnp.asarray(points_batch)
        if points_batch.ndim != 3:
            raise ValueError(
                f"BatchedPlannedNufft takes stacked [S, M, rank] "
                f"points, got shape {points_batch.shape}")
        s = int(points_batch.shape[0])
        self.points_batch = points_batch
        self.num_batches = s
        self._shards = PlannedNufft.batch_build(
            points_batch, grid_shape, transform_type=transform_type,
            fft_direction=fft_direction, tol=tol, options=options)
        p0 = self._shards[0]
        self.grid_shape = p0.grid_shape
        self.transform_type = transform_type
        self.fft_direction = fft_direction
        self.tol = p0.tol
        self.options = p0.options
        self._planned = all(sh._planned for sh in self._shards)
        self._adjoint = None

    @property
    def num_points(self) -> int:
        return int(self.points_batch.shape[1])

    def adjoint(self) -> "BatchedPlannedNufft":
        """The adjoint batch (swapped type and direction), sharing all
        per-trajectory points-side artifacts."""
        if self._adjoint is None:
            adj = object.__new__(BatchedPlannedNufft)
            adj.__dict__.update(self.__dict__)
            adj.transform_type = ("type_2"
                                  if self.transform_type == "type_1"
                                  else "type_1")
            adj.fft_direction = ("backward"
                                 if self.fft_direction == "forward"
                                 else "forward")
            adj._shards = [sh.adjoint() for sh in self._shards]
            adj._adjoint = self
            self._adjoint = adj
        return self._adjoint

    def _apply(self, source):
        inner = source.ndim == self._elem_rank() + 2
        outs = []
        for i, sh in enumerate(self._shards):
            src = source[i] if inner else source[i][None]
            out = sh._apply(src)
            outs.append(out if inner else out[0])
        return jnp.stack(outs)

    def _elem_rank(self) -> int:
        return (2 if self.transform_type == "type_1"
                else len(self.grid_shape) + 1)

    def __call__(self, source):
        """Applies the per-trajectory transforms to planar ``source``
        ([S, *elem] or [S, B, *elem]; see class docstring)."""
        source = jnp.asarray(source)
        m = self.num_points
        er = self._elem_rank()
        if self.transform_type == "type_1":
            elem_ok = (source.shape[-2:] == (m, 2)
                       if source.ndim >= 2 else False)
            expect = f"[S, (B,) {m}, 2]"
        else:
            gs = tuple(self.grid_shape)
            elem_ok = (source.ndim >= er + 1
                       and tuple(source.shape[-er:-1]) == gs
                       and source.shape[-1] == 2)
            expect = f"[S, (B,) {', '.join(str(g) for g in gs)}, 2]"
        if (not elem_ok or source.ndim not in (er + 1, er + 2)
                or source.shape[0] != self.num_batches):
            raise ValueError(
                f"batched planned {self.transform_type} expects a "
                f"source of shape {expect} with S={self.num_batches}; "
                f"got shape {source.shape}")
        if not self._planned:
            # Unplanned fallback: vmap the functional op over the
            # (source, trajectory) pairs.
            inner = source.ndim == er + 2
            src = source if inner else source[:, None]
            kwargs = (dict(grid_shape=self.grid_shape)
                      if self.transform_type == "type_1" else {})
            out = jax.vmap(
                lambda s, p: nufft(
                    s, p, transform_type=self.transform_type,
                    fft_direction=self.fft_direction, tol=self.tol,
                    options=self.options, **kwargs)
            )(src, self.points_batch)
            return out if inner else out[:, 0]
        return _batched_planned_call(source, self)


# ---------------------------------------------------------------------------
# Toeplitz-embedded normal operator.
# ---------------------------------------------------------------------------


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _toeplitz_call(source, op):
    return op._apply(source)


def _toeplitz_fwd(source, op):
    return _toeplitz_call(source, op), None


def _toeplitz_bwd(op, _, cotangent):
    # A^H W A with real W is self-adjoint; planar-real transpose = self.
    return (_toeplitz_call(cotangent, op),)


_toeplitz_call.defvjp(_toeplitz_fwd, _toeplitz_bwd)


class ToeplitzNormal:
    """Toeplitz-embedded normal operator ``A^H W A``.

    ``A^H W A`` is shift-invariant on the mode grid: it is convolution
    with the kernel ``t[d] = sum_j w_j e^{+/- i omega_j . d}`` — ONE
    type-1 NUFFT of the weights onto the doubled grid, computed at
    construction. Each apply is then pad -> 2N-DFT -> multiply ->
    cropped inverse DFT: dense matmul work with NO spread/interp,
    no gathers and no scatters — the fastest way to run CG-style
    iterations when only the normal operator is needed (the classic
    Toeplitz trick of the MRI reconstruction literature; no reference
    counterpart — mrphys/tensorflow-nufft composes two NUFFTs,
    docs/examples/mri_app.ipynb).

    The embedding is exact linear algebra; accuracy is set by the one
    NUFFT evaluating ``t`` (``tol``), so applies agree with the
    composed pair at the tolerance level while costing a fraction:
    the apply does O((2N)^d log-free matmul DFT work against the
    composed pair's two spread/interp passes + two mode-DFTs.

    Args:
        points: [M, rank] radians in [-pi, pi].
        grid_shape: the image/mode grid N (output of the normal op).
        weights: optional [M] real per-point weights (density
            compensation). Default: ones.
        fft_direction: direction of the FORWARD model A ('forward' ->
            A uses e^{-i omega n}).
        tol: accuracy of the kernel-evaluating NUFFT.

    Apply: ``op(source)`` with planar [B, *grid, 2] -> [B, *grid, 2].
    Differentiable (self-adjoint custom VJP).
    """

    def __init__(self, points, grid_shape, weights=None,
                 fft_direction: str = "forward", tol: float = 1e-6,
                 options: Optional[Options] = None):
        from tensorflow_nufft_tpu.fft.planar_fft import dft_planar
        points = jnp.asarray(points)
        if points.ndim != 2:
            raise ValueError(
                f"ToeplitzNormal takes a single [M, rank] point set, "
                f"got shape {points.shape}")
        fft_direction = _validate_enum(
            fft_direction, _VALID_FFT_DIRECTIONS, "fft_direction")
        self.grid_shape = _canonical_grid_shape(grid_shape)
        self.rank = rank = int(points.shape[-1])
        if len(self.grid_shape) != rank:
            raise ValueError(
                f"grid_shape must represent a rank-{rank} shape. "
                f"Received: {self.grid_shape}")
        m = int(points.shape[0])
        if weights is None:
            w = jnp.ones((m,), points.dtype)
        else:
            w = jnp.asarray(weights).astype(points.dtype)
            if w.shape != (m,):
                raise ValueError(
                    f"weights must have shape [{m}], got {w.shape}")
        doubled = tuple(2 * n for n in self.grid_shape)
        # t[d] = sum_j w_j e^{+i omega d} for a 'forward' A: the
        # type-1 NUFFT with the OPPOSITE direction.
        t1_dir = ("backward" if fft_direction == "forward"
                  else "forward")
        w_planar = jnp.stack([w, jnp.zeros_like(w)], axis=-1)
        t = nufft(w_planar, points, grid_shape=doubled,
                  transform_type="type_1", fft_direction=t1_dir,
                  tol=tol, options=options)              # [*2N, 2]
        # CMCL modes n' in [-N, N) -> spatial offsets on the 2N torus:
        # roll by -N per axis; the never-referenced offset -N slot
        # (index N after the roll) is zeroed.
        t_np = np.asarray(jax.device_get(t), np.float64)
        for d in range(rank):
            n = self.grid_shape[d]
            t_np = np.roll(t_np, -n, axis=d)
            idx = [slice(None)] * t_np.ndim
            idx[d] = n
            t_np[tuple(idx)] = 0.0
        # Spectrum of the embedded kernel, with the inverse-DFT
        # normalization folded in.
        # Keep the spectrum (and applies) at the points' precision:
        # silently truncating f64 pipelines to f32 would stall CG far
        # above the requested tolerance.
        real_dt = points.dtype
        spec = dft_planar(jnp.asarray(t_np[None], real_dt),
                          rank, "forward")[0]
        self.spectrum = jnp.asarray(
            np.asarray(spec, np.float64)
            / float(np.prod(doubled))).astype(real_dt)

    def _apply(self, source):
        from tensorflow_nufft_tpu.fft.planar_fft import (
            dft_doubled_planar)
        z = dft_doubled_planar(source.astype(self.spectrum.dtype),
                               self.rank, forward=True)  # [B, *2N, 2]
        y = pmul(z, self.spectrum)
        out = dft_doubled_planar(y, self.rank, forward=False)
        return out.astype(source.dtype)

    def __call__(self, source):
        source = jnp.asarray(source)
        expect = self.rank + 2
        if source.ndim != expect or source.shape[-1] != 2:
            raise ValueError(
                f"ToeplitzNormal expects [B, *grid, 2] planar input "
                f"of rank {expect}, got shape {source.shape}")
        return _toeplitz_call(source, self)


# ---------------------------------------------------------------------------
# Type-3 (nonuniform -> nonuniform) planar transforms.
# ---------------------------------------------------------------------------


@_functools.partial(jax.custom_vjp, nondiff_argnums=(1,))
def _type3_call(source, op):
    return op._apply(source)


def _type3_fwd(source, op):
    return _type3_call(source, op), None


def _type3_bwd(op, _, cotangent):
    # Planar-real transpose == complex adjoint: the type-3 adjoint swaps
    # the point sets and flips the direction. The adjoint plan is cached.
    return (_type3_call(cotangent, op.adjoint()),)


_type3_call.defvjp(_type3_fwd, _type3_bwd)


def pmul(values, phase):
    """Planar complex multiply: values [..., 2] * phase [..., 2]
    (broadcasting elementwise; the shared planar helper —
    ``models.mri.pmul`` is an alias)."""
    vr, vi = values[..., 0], values[..., 1]
    pr, pi = phase[..., 0], phase[..., 1]
    return jnp.stack([vr * pr - vi * pi, vr * pi + vi * pr], axis=-1)


class Type3Plan:
    """Planned planar type-3 NUFFT: nonuniform points -> nonuniform
    frequencies, f_k = sum_j c_j exp(s i t_k . x_j).

    The planar twin of the complex ``tensorflow_nufft_tpu.Type3Plan``
    (see ops/type3.py for the algorithm derivation), built from the
    planned stages: a spread onto the type-3 fine grid (binning hoisted
    to plan time where the spread kernel serves it) and a planned
    planar type-2 at the rescaled target frequencies. The
    reference enumerates type-3 but does not implement it
    (cc/kernels/nufft_plan.cc:175-177).

    Apply: ``op(source)`` with planar [B, M, 2] -> [B, K, 2], float32.
    Differentiable w.r.t. the strengths (adjoint-plan custom VJP); the
    point sets are plan statics.
    """

    def __init__(self, points, target_points,
                 fft_direction: str = "forward", tol: float = 1e-6,
                 options: Optional[Options] = None):
        from tensorflow_nufft_tpu.kernels import binning, dispatch
        from tensorflow_nufft_tpu.kernels.xla_ops import (
            fold_and_rescale_split)
        from tensorflow_nufft_tpu.ops.type3 import (
            compute_type3_statics, validate_type3_point_sets)
        from tensorflow_nufft_tpu.plan.plan import make_plan

        fft_direction = _validate_enum(
            fft_direction, _VALID_FFT_DIRECTIONS, "fft_direction")
        options = options or Options()
        if options.upsampling_factor not in (None, 0.0, 2.0):
            raise ValueError(
                "type-3 transforms support only upsampling_factor=2.0 "
                f"(got {options.upsampling_factor}).")
        x, t = validate_type3_point_sets(points, target_points,
                                         allowed_dtypes=(np.float32,))
        st = compute_type3_statics(
            np.asarray(x, np.float64), np.asarray(t, np.float64),
            fft_direction, tol, real_dt=np.float32)
        self._x, self._t = x, t
        self.rank = st.rank
        self.num_points = st.num_points
        self.num_targets = st.num_targets
        self.fine_shape = st.fine_shape
        self.fft_direction = fft_direction
        self.tol = float(tol)
        self.options = options

        self._prephase = jnp.asarray(
            np.stack([st.prephase.real, st.prephase.imag],
                     axis=-1).astype(np.float32))          # [M, 2]
        self._postphase = jnp.asarray(
            np.stack([st.postphase.real, st.postphase.imag],
                     axis=-1).astype(np.float32))          # [K, 2]

        # Outer spread: raw ES-kernel spread onto the type-3 fine grid
        # (spread-only geometry; kernel_scale NOT applied — the exact
        # kernel-FT deconvolution lives in the postphase).
        self._spread_spec = PlanSpec(
            transform_type="type_1", fft_direction=fft_direction,
            rank=self.rank, grid_shape=self.fine_shape,
            dtype_name="complex64", tol=self.tol, points_range=0,
            spread_only=True, backend=options.backend,
            kernel_evaluation_method=options.kernel_evaluation_method)
        self._spread_plan = make_plan(self._spread_spec)
        xi32 = jnp.asarray(st.xi.astype(np.float32))
        self._points_resc = jax.tree.map(
            jnp.asarray,
            fold_and_rescale_split(xi32, self.fine_shape, 0))

        # Plan the spread binning when the spread kernel serves this
        # geometry (mirrors PlannedNufft).
        self._spread_planned = dispatch.spread_kernel_active(
            self._spread_plan, np.float32)
        if self._spread_planned:
            self.geom = binning.choose_geometry(
                self.fine_shape, self._spread_plan.width, self.num_points)
            self.binned = jax.jit(binning.bin_points, static_argnums=1)(
                self._points_resc, self.geom)
            self.coords = jax.jit(binning.slot_coords)(self.binned)

        # Inner planned type-2 on the fine grid at the rescaled targets.
        self._inner_t2 = PlannedNufft(
            jnp.asarray(st.theta.astype(np.float32)), self.fine_shape,
            transform_type="type_2", fft_direction=fft_direction,
            tol=self.tol, options=options)
        self._adjoint = None

    def adjoint(self) -> "Type3Plan":
        """The adjoint type-3 plan: swapped point sets, flipped
        direction (maps values [B, K, 2] back to strengths [B, M, 2])."""
        if self._adjoint is None:
            adj = Type3Plan(
                self._t, self._x,
                fft_direction=("backward"
                               if self.fft_direction == "forward"
                               else "forward"),
                tol=self.tol, options=self.options)
            adj._adjoint = self
            self._adjoint = adj
        return self._adjoint

    def _apply(self, source):
        from tensorflow_nufft_tpu.kernels import dispatch
        from tensorflow_nufft_tpu.utils import profiling as prof
        batch = source.shape[0]
        src = pmul(source.astype(jnp.float32), self._prephase)
        cm = jnp.moveaxis(src, -1, 1).reshape(2 * batch, self.num_points)
        with prof.scope("nufft3.spread"):
            if self._spread_planned:
                from tensorflow_nufft_tpu.kernels import binning
                from tensorflow_nufft_tpu.kernels.triton_spread import (
                    spread_tiles)
                tiles = spread_tiles(
                    binning.to_slots(cm, self.binned), self.coords,
                    self.binned.tile_bounds, self._spread_plan, self.geom)
                fine = binning.overlap_add(tiles, self.geom)
            else:
                fine = dispatch.spread(cm, self._points_resc,
                                       self._spread_plan)
        grid = jnp.moveaxis(
            fine.reshape((batch, 2) + self.fine_shape), 1, -1)
        with prof.scope("nufft3.inner_t2"):
            vals = self._inner_t2(grid)            # [B, K, 2]
        return pmul(vals, self._postphase)

    def __call__(self, source):
        """Applies the transform: planar [B, M, 2] -> [B, K, 2]."""
        from tensorflow_nufft_tpu.plan.plan import auto_max_batch_size
        from tensorflow_nufft_tpu.utils.batching import chunked_map
        source = jnp.asarray(source)
        if source.dtype != np.float32:
            raise TypeError(
                f"planar type-3 is float32-only, got {source.dtype}.")
        if (source.ndim != 3 or source.shape[-1] != 2
                or source.shape[1] != self.num_points):
            raise ValueError(
                f"planned planar type-3 expects a source of shape "
                f"[B, {self.num_points}, 2]; got {source.shape}")
        # Bound fine-grid memory like the complex twin (ops/type3.py):
        # the spread materializes [2B, *fine_shape] before the inner
        # type-2, so chunk the batch at max_batch_size.
        max_bs = self.options.max_batch_size
        if max_bs is None:
            max_bs = auto_max_batch_size(self._inner_t2.plan.spec)
        return chunked_map(lambda s: _type3_call(s, self), source,
                           max_bs)


def nufft_type3(source, points, target_points,
                fft_direction: str = "forward", tol: float = 1e-6,
                options: Optional[Options] = None):
    """Planar type-3 NUFFT (one-shot). See ``Type3Plan``; planar twin of
    the top-level ``nufft_type3``."""
    return Type3Plan(points, target_points, fft_direction, tol,
                     options)(source)


def nudft_type3(source, points, target_points,
                fft_direction: str = "forward"):
    """Dense planar type-3 oracle: O(M*K); testing only.

    source [..., M, 2], points [M, rank], target_points [K, rank]
    -> [..., K, 2].
    """
    fft_direction = _validate_enum(
        fft_direction, _VALID_FFT_DIRECTIONS, "fft_direction")
    source = jnp.asarray(source)
    points = jnp.asarray(points)
    target_points = jnp.asarray(target_points)
    sign = -1.0 if fft_direction == "forward" else 1.0
    hi = jax.lax.Precision.HIGHEST
    phase = jnp.matmul(target_points, points.T, precision=hi)  # [K, M]
    cos = jnp.cos(phase)
    sin = sign * jnp.sin(phase)
    sr, si = source[..., 0], source[..., 1]
    yr = (jnp.einsum("...m,km->...k", sr, cos, precision=hi)
          - jnp.einsum("...m,km->...k", si, sin, precision=hi))
    yi = (jnp.einsum("...m,km->...k", sr, sin, precision=hi)
          + jnp.einsum("...m,km->...k", si, cos, precision=hi))
    return jnp.stack([yr, yi], axis=-1)
