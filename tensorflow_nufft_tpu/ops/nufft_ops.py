"""Public NUFFT API: ``nufft``, ``interp``, ``spread``, ``nudft``.

Signature and semantics parity with the reference Python API
(python/ops/nufft_ops.py:34-123), re-implemented in JAX: everything is
pure JAX, jit/vmap/grad-compatible, with static shapes.

Batching follows the reference's kernel-dispatch semantics
(cc/kernels/nufft_kernels.cc:146-266): batch dims of ``source`` and
``points`` broadcast NumPy-style; batch dims in which the points are
broadcast (size 1) are "inner" dims vectorized into a single multi-transform
plan execution, the rest are "outer" dims mapped via ``vmap``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tensorflow_nufft_tpu.ops.core import (
    nufft_core,
    spread_only_core,
)
from tensorflow_nufft_tpu.options.options import Options
from tensorflow_nufft_tpu.plan.plan import (
    PlanSpec, auto_max_batch_size, log_plan_summary,
    warn_if_tol_clamped)
from tensorflow_nufft_tpu.utils.batching import chunked_map
from tensorflow_nufft_tpu.utils.dtypes import real_dtype

_VALID_TRANSFORM_TYPES = ("type_1", "type_2")
_VALID_FFT_DIRECTIONS = ("forward", "backward")
_COMPLEX_DTYPES = (np.dtype(np.complex64), np.dtype(np.complex128))


def _validate_enum(value, valid, name):
    if name == "transform_type" and value == "type_3":
        # The reference enumerates type-3 but does not implement it
        # (cc/kernels/nufft_plan.cc:175-177). This framework does — via a
        # separate entry point, since type-3 takes two point sets rather
        # than a grid shape.
        raise NotImplementedError(
            "type-3 transforms use a different signature; call "
            "tensorflow_nufft_tpu.nufft_type3(source, points, "
            "target_points, ...) instead")
    if value not in valid:
        raise ValueError(
            f"Invalid {name}: {value!r}. Must be one of {sorted(valid)}.")
    return value


def _canonical_grid_shape(grid_shape) -> Tuple[int, ...]:
    if isinstance(grid_shape, (int, np.integer)):
        return (int(grid_shape),)
    return tuple(int(d) for d in np.asarray(grid_shape).reshape(-1))


def _check_dtypes(source, points):
    if source.dtype not in _COMPLEX_DTYPES:
        raise TypeError(
            f"source must be complex64 or complex128, got {source.dtype}.")
    expected = np.dtype(real_dtype(source.dtype))
    if points.dtype != expected:
        raise TypeError(
            f"points must have dtype {expected} (the real dtype of "
            f"source's {source.dtype}), got {points.dtype}.")


def _broadcast_batch_shapes(a: Tuple[int, ...], b: Tuple[int, ...]
                            ) -> Tuple[int, ...]:
    try:
        return tuple(np.broadcast_shapes(a, b))
    except ValueError as err:
        raise ValueError(
            "Incompatible batch shapes for source and points. The batch "
            f"dimensions must be broadcastable. Received: {a}, {b}"
        ) from err


def _apply_batched(core_fn, source, points, spec,
                   elem_rank: int, out_elem_shape: Tuple[int, ...],
                   max_batch_size: Optional[int]):
    """Runs the inner-batched core over broadcast batch dims.

    Args:
        core_fn: callable (source[B, *elem], points[M, rank], spec) -> out.
        source: [*src_batch, *elem] complex.
        points: [*pts_batch, M, rank] real.
        elem_rank: number of trailing element dims of source.
        out_elem_shape: trailing element shape of the output.

    Returns:
        [*broadcast_batch, *out_elem_shape]
    """
    num_points = points.shape[-2]
    rank = points.shape[-1]
    elem_shape = source.shape[source.ndim - elem_rank:]

    src_batch = tuple(source.shape[:source.ndim - elem_rank])
    pts_batch = tuple(points.shape[:-2])
    nb = max(len(src_batch), len(pts_batch))
    src_batch_p = (1,) * (nb - len(src_batch)) + src_batch
    pts_batch_p = (1,) * (nb - len(pts_batch)) + pts_batch
    batch = _broadcast_batch_shapes(src_batch_p, pts_batch_p)

    # Partition batch dims: dims where points are broadcast are "inner"
    # (vectorized in one plan execution); others are "outer" (vmapped).
    inner_dims = [i for i in range(nb) if pts_batch_p[i] == 1]
    outer_dims = [i for i in range(nb) if pts_batch_p[i] != 1]
    inner_shape = tuple(batch[i] for i in inner_dims)
    outer_shape = tuple(batch[i] for i in outer_dims)
    inner_size = int(np.prod(inner_shape, dtype=np.int64)) if inner_shape \
        else 1
    outer_size = int(np.prod(outer_shape, dtype=np.int64)) if outer_shape \
        else 1

    # Bring source to [*outer, *inner, *elem] then flatten.
    source_b = jnp.broadcast_to(source.reshape(src_batch_p + elem_shape),
                                batch + elem_shape)
    perm = outer_dims + inner_dims + list(range(nb, nb + elem_rank))
    source_b = jnp.transpose(source_b, perm)
    source_flat = source_b.reshape((outer_size, inner_size) + elem_shape)

    # Bring points to [*outer, M, rank] then flatten outer.
    points_b = points.reshape(pts_batch_p + (num_points, rank))
    pts_perm = outer_dims + inner_dims + [nb, nb + 1]
    points_b = jnp.transpose(points_b, pts_perm)
    points_flat = points_b.reshape((outer_size, num_points, rank))

    def run_inner(src_i, pts_i):
        if max_batch_size is not None and inner_size > max_batch_size:
            # Chunk the inner batch to bound fine-grid memory
            # (reference: max_batch_size option, nufft_options.py:239-243).
            return chunked_map(lambda s: core_fn(s, pts_i, spec),
                               src_i, max_batch_size)
        return core_fn(src_i, pts_i, spec)

    if outer_size == 1:
        out = run_inner(source_flat[0], points_flat[0])[None]
    else:
        out = jax.vmap(run_inner)(source_flat, points_flat)
    # out: [outer_size, inner_size, *out_elem]
    out = out.reshape(outer_shape + inner_shape + out_elem_shape)
    # Invert the batch-dim permutation.
    inv = [0] * nb
    for pos, dim in enumerate(outer_dims + inner_dims):
        inv[dim] = pos
    out = jnp.transpose(
        out, inv + list(range(nb, nb + len(out_elem_shape))))
    return out.reshape(batch + out_elem_shape)


def nufft(source,
          points,
          grid_shape=None,
          transform_type: str = "type_2",
          fft_direction: str = "forward",
          tol: float = 1e-6,
          options: Optional[Options] = None):
    """Computes the non-uniform discrete Fourier transform via NUFFT.

    Evaluates the type-1 or type-2 non-uniform discrete Fourier transform
    via the NUFFT algorithm (spread/interp with an "exponential of
    semicircle" kernel, oversampled FFT, deconvolution). Supports 1D, 2D
    and 3D transforms; jit-, vmap- and grad-compatible.

    API parity with the reference ``tfft.nufft``
    (python/ops/nufft_ops.py:34-123).

    Args:
        source: A complex64/complex128 array. For type-2, the source grid
            of shape ``[...] + grid_shape``; for type-1, the source points
            of shape ``[..., M]``.
        points: Nonuniform point coordinates in radians/pixel, in
            ``[-pi, pi]``, shape ``[..., M, rank]`` with rank in {1, 2, 3}.
            Batch dims broadcast against ``source``'s.
        grid_shape: Required for type-1: the output grid shape (rank ints).
            Ignored for type-2.
        transform_type: "type_1" (nonuniform -> uniform) or "type_2"
            (uniform -> nonuniform).
        fft_direction: "forward" (negative exponent sign) or "backward"
            (positive).
        tol: Requested relative precision; drives kernel width and
            oversampling.
        options: Optional ``Options``.

    Returns:
        For type-2: ``[..., M]``; for type-1: ``[...] + grid_shape``, with
        batch dims broadcast. Modes are in centered (CMCL) order: array
        index i along a size-N mode axis is frequency k = i - N//2.
    """
    options = options or Options()
    transform_type = _validate_enum(
        transform_type, _VALID_TRANSFORM_TYPES, "transform_type")
    fft_direction = _validate_enum(
        fft_direction, _VALID_FFT_DIRECTIONS, "fft_direction")

    source = jnp.asarray(source)
    points = jnp.asarray(points)
    _check_dtypes(source, points)
    if points.ndim < 2:
        raise ValueError(
            f"points must have shape [..., M, rank], got {points.shape}.")
    rank = int(points.shape[-1])
    if rank not in (1, 2, 3):
        raise ValueError(f"rank (points.shape[-1]) must be 1, 2 or 3, "
                         f"got {rank}.")
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
        if source.ndim < 1 or int(source.shape[-1]) != num_points:
            raise ValueError(
                f"source and points have incompatible number of points: "
                f"source.shape[-1]={source.shape[-1] if source.ndim else None}"
                f" vs points.shape[-2]={num_points}.")
        elem_rank = 1
        out_elem_shape = grid_shape
    else:
        if source.ndim < rank:
            raise ValueError(
                f"source must have at least rank {rank} for a rank-{rank} "
                f"type-2 transform, got shape {source.shape}.")
        grid_shape = tuple(int(d) for d in source.shape[-rank:])
        elem_rank = rank
        out_elem_shape = (num_points,)

    spec = PlanSpec(
        transform_type=transform_type,
        fft_direction=fft_direction,
        rank=rank,
        grid_shape=grid_shape,
        dtype_name=str(source.dtype),
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
        max_bs = auto_max_batch_size(spec)
    out = _apply_batched(nufft_core, source, points, spec, elem_rank,
                         out_elem_shape, max_bs)
    if options.debugging.check_points_range:
        out = _poison_if_out_of_range(out, points, options)
    return out


def _poison_if_out_of_range(out, points, options: Options):
    """Device-side points-range check (reference: nufft_plan.h:866-898).

    Under jit we cannot raise on data-dependent conditions, so violations
    poison the output with NaN, which ``jax.debug`,`checkify`` or the
    user's own finiteness checks surface. For concrete (trace-free) inputs
    a Python error is raised eagerly.
    """
    from tensorflow_nufft_tpu.options.options import PointsRange
    if options.points_range == PointsRange.INFINITE:
        return out
    bound = np.pi if options.points_range == PointsRange.STRICT \
        else 3 * np.pi
    ok = jnp.all((points > -bound) & (points < bound))
    try:
        concrete_ok = bool(ok)
    except jax.errors.TracerBoolConversionError:
        # Under jit: poison the output so the violation is detectable.
        nan = jnp.asarray(np.nan * (1 + 1j), dtype=out.dtype)
        return jnp.where(ok, out, nan)
    if not concrete_ok:
        raise ValueError(
            f"points are not within the supported range "
            f"[-{bound / np.pi:g}*pi, {bound / np.pi:g}*pi]. "
            "Use a wider options.points_range or disable "
            "options.debugging.check_points_range.")
    return out


def interp(source, points, tol: float = 1e-6,
           options: Optional[Options] = None):
    """Interpolates grid values at nonuniform points (no FFT stage).

    The standalone interpolation step of the NUFFT: evaluates the
    ES-kernel-weighted sum of grid values around each point, normalized so
    a constant grid interpolates to (approximately) the same constant.
    Grid dims must be even, at least twice the kernel width, and 5-smooth
    (reference: cc/ops/nufft_ops.cc:136-201, nufft_plan.h:829-837).

    Args:
        source: ``[...] + grid_shape`` complex grid.
        points: ``[..., M, rank]`` real coordinates in radians.

    Returns:
        ``[..., M]`` complex values.
    """
    return _spread_or_interp("type_2", source, points, None, tol, options)


def spread(source, points, grid_shape, tol: float = 1e-6,
           options: Optional[Options] = None):
    """Spreads nonuniform point strengths onto a grid (no FFT stage).

    Adjoint of ``interp``; same grid-shape constraints.

    Args:
        source: ``[..., M]`` complex strengths.
        points: ``[..., M, rank]`` real coordinates in radians.
        grid_shape: rank-long output grid shape.

    Returns:
        ``[...] + grid_shape`` complex grid.
    """
    return _spread_or_interp("type_1", source, points, grid_shape, tol,
                             options)


def _spread_or_interp(transform_type, source, points, grid_shape, tol,
                      options):
    options = options or Options()
    source = jnp.asarray(source)
    points = jnp.asarray(points)
    _check_dtypes(source, points)
    if points.ndim < 2:
        raise ValueError(
            f"points must have shape [..., M, rank], got {points.shape}.")
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
        if int(source.shape[-1]) != num_points:
            raise ValueError(
                f"source and points have incompatible number of points: "
                f"{source.shape[-1]} vs {num_points}.")
        elem_rank = 1
        out_elem_shape = grid_shape
    else:
        grid_shape = tuple(int(d) for d in source.shape[-rank:])
        elem_rank = rank
        out_elem_shape = (num_points,)

    spec = PlanSpec(
        transform_type=transform_type,
        fft_direction="forward",     # irrelevant: no FFT stage
        rank=rank,
        grid_shape=grid_shape,
        dtype_name=str(source.dtype),
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
        max_bs = auto_max_batch_size(spec)
    return _apply_batched(spread_only_core, source, points, spec,
                          elem_rank, out_elem_shape, max_bs)


def nudft(source,
          points,
          grid_shape=None,
          transform_type: str = "type_2",
          fft_direction: str = "forward"):
    """Computes the non-uniform discrete Fourier transform directly.

    Warning: builds the dense DFT matrix — O(M * prod(grid_shape)) work
    and memory. Exists primarily as the test oracle, like the reference's
    ``tfft.nudft`` (python/ops/nufft_ops.py:235-321).

    For the parameters, see ``nufft``.
    """
    transform_type = _validate_enum(
        transform_type, _VALID_TRANSFORM_TYPES, "transform_type")
    fft_direction = _validate_enum(
        fft_direction, _VALID_FFT_DIRECTIONS, "fft_direction")
    source = jnp.asarray(source)
    points = jnp.asarray(points)
    _check_dtypes(source, points)
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
        elem_rank = 1
        out_elem_shape = grid_shape
    else:
        grid_shape = tuple(int(d) for d in source.shape[-rank:])
        elem_rank = rank
        out_elem_shape = (num_points,)

    hi = jax.lax.Precision.HIGHEST   # oracle accuracy trumps speed

    def core(src, pts, _spec=None):
        # src: [B, *elem]; pts: [M, rank]
        mat = _nudft_matrix(pts, grid_shape, fft_direction, source.dtype)
        if transform_type == "type_1":
            return jnp.einsum("mn,bm->bn", mat, src,
                              precision=hi).reshape(
                (src.shape[0],) + grid_shape)
        return jnp.einsum("mn,bn->bm", mat,
                          src.reshape(src.shape[0], -1), precision=hi)

    return _apply_batched(core, source, points, None, elem_rank,
                          out_elem_shape, None)


def _nudft_matrix(points, grid_shape: Tuple[int, ...], fft_direction: str,
                  dtype):
    """Dense [M, prod(grid_shape)] NUDFT matrix exp(sign i x . k).

    Modes are integers k = i - N//2 in CMCL order (see ``nufft`` notes;
    reference: python/ops/nufft_ops.py:293-321).
    """
    rank = len(grid_shape)
    k_vecs = [np.arange(n) - n // 2 for n in grid_shape]
    k_grid = np.stack(np.meshgrid(*k_vecs, indexing="ij"), axis=0)
    k_grid = k_grid.reshape(rank, -1)
    k_grid = jnp.asarray(k_grid, dtype=points.dtype)
    phase = jnp.matmul(points, k_grid,
                       precision=jax.lax.Precision.HIGHEST)
    sign = -1.0 if fft_direction == "forward" else 1.0
    return jnp.exp(jnp.asarray(sign * 1j, dtype) *
                   phase.astype(dtype))
