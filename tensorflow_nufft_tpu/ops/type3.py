"""Type-3 NUFFT: nonuniform points -> nonuniform frequencies.

Computes f_k = sum_j c_j exp(s i t_k . x_j) for arbitrary real point sets
x_j ("points") and t_k ("target_points"), s = -1 (forward) / +1 (backward).

The reference enumerates type-3 but never implements it
(cc/kernels/nufft_plan.h:119-123, nufft_plan.cc:175-177); this module
exceeds the reference's capability envelope. The algorithm is the standard
two-step t3 factorization (Lee & Greengard 2005; Barnett-Magland-af
Klinteberg 2019, section 4), re-derived for this codebase's conventions
(CMCL mode order, +pi fold shift, exp(s i k.x) sign convention):

  1. Center both point sets (x_c, t_c midpoints; half-widths X, S) and pick
     a fine grid nf >= 2*sigma*S*X/pi + w + 1 per dim (5-smooth even), with
     rescale factor gamma = nf / (2 sigma S) and step h = 2 pi / nf. The
     "+w+1" margin guarantees no kernel mass ever wraps around the grid,
     which is what makes the continuous-frequency evaluation below exact.
  2. Spread the prephased strengths c_j * exp(s i t_c (x_j - x_c)) at
     xi_j = (x_j - x_c)/gamma in (-pi, pi) onto the nf grid with the ES
     kernel (a plain type-1 spread; no FFT).
  3. Evaluate the spread grid's semidiscrete Fourier transform at the
     continuous frequencies via an inner type-2 NUFFT of the grid (read as
     CMCL modes) at theta_k = gamma (t_k - t_c) h in [-pi/sigma, pi/sigma].
     The two +-pi fold phases cancel exactly.
  4. Divide by the kernel's continuous Fourier transform
     psi_hat(gamma (t_k - t_c) h) per dim (Gauss-Legendre quadrature, the
     same rule as the uniform-mode fseries, nufft_util.cc:71-117) and apply
     the decentering postphase exp(s i t_k . x_c).

Everything except the strengths is concrete at plan time, so the spread
coordinates, inner type-2 points, prephase, postphase and deconvolution
weights are all static float64 constants; only the strength pipeline is
traced. Gradients w.r.t. the strengths flow through the spread and inner
type-2 (both differentiable); the point sets are plan statics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tensorflow_nufft_tpu.kernels import dispatch
from tensorflow_nufft_tpu.kernels.xla_ops import fold_and_rescale_split
from tensorflow_nufft_tpu.ops.core import nufft_core
from tensorflow_nufft_tpu.options.options import Options
from tensorflow_nufft_tpu.plan.plan import (
    EPSILON, MAX_ARRAY_SIZE, PlanSpec, auto_max_batch_size, es_kernel_np,
    kernel_beta, make_plan, select_kernel_width)
from tensorflow_nufft_tpu.utils.batching import chunked_map
from tensorflow_nufft_tpu.utils.dtypes import real_dtype
from tensorflow_nufft_tpu.utils import profiling as prof
from tensorflow_nufft_tpu.utils.smooth import next_smooth_integer

_VALID_FFT_DIRECTIONS = ("forward", "backward")


def kernel_ft(omega: np.ndarray, width: int, beta: float) -> np.ndarray:
    """Continuous Fourier transform of the ES kernel at frequencies omega.

    psi_hat(omega) = 2 * int_0^{w/2} psi(u) cos(omega u) du, evaluated by
    the same Gauss-Legendre rule as the uniform-mode Fourier series
    (plan.kernel_fseries_1d; reference: nufft_util.cc:71-117) but at
    arbitrary real frequencies instead of integer modes. Float64.
    """
    half_width = width / 2.0
    c = 4.0 / (width * width)
    q = int(2 + 3.0 * half_width)
    nodes, weights = np.polynomial.legendre.leggauss(2 * q)
    z = nodes[q:] * half_width
    f = half_width * weights[q:] * es_kernel_np(z, beta, c, half_width)
    return 2.0 * (np.cos(np.outer(np.asarray(omega, np.float64), z)) @ f)


@dataclasses.dataclass(frozen=True)
class Type3Statics:
    """Point-dependent statics of a type-3 transform, float64.

    Shared between the complex (``Type3Plan``) and planar
    (``planar.Type3Plan``) pipelines: the geometry and phases are
    identical; only the strength pipeline differs.
    """
    rank: int
    num_points: int
    num_targets: int
    fine_shape: Tuple[int, ...]
    width: int
    beta: float
    xi: np.ndarray          # [M, rank] spread coordinates in (-pi, pi)
    theta: np.ndarray       # [K, rank] inner type-2 points
    prephase: np.ndarray    # [M] complex128
    postphase: np.ndarray   # [K] complex128 (incl. kernel-FT deconv)


def compute_type3_statics(x64: np.ndarray, t64: np.ndarray,
                          fft_direction: str, tol: float,
                          real_dt=np.float64) -> Type3Statics:
    """Computes fine-grid geometry, rescaled coordinates and phases.

    See the module docstring for the derivation; formulas follow the
    standard t3 grid/rescale selection (sigma fixed at 2.0). ``real_dt``
    is the transform's real dtype: the tolerance is clamped to its
    precision floor with the SAME rule as ``make_plan`` so the statics'
    kernel width always matches the spread/inner-t2 plans' (a mismatch
    would silently deconvolve with the wrong kernel)."""
    rank = int(x64.shape[1])
    sigma = 2.0
    tol = max(float(tol), EPSILON[np.dtype(real_dt)])
    width = select_kernel_width(tol, sigma)
    beta = kernel_beta(width, sigma)

    x_c = (x64.max(0) + x64.min(0)) / 2.0
    t_c = (t64.max(0) + t64.min(0)) / 2.0
    half_x = np.abs(x64 - x_c).max(0)
    half_t = np.abs(t64 - t_c).max(0)
    # Degenerate (zero-extent) dimensions: substitute safe widths so
    # nf stays small and gamma finite; values are still exact because
    # the centered coordinate is identically zero along such dims.
    tiny = 1e-30
    x_safe = np.where(
        half_x <= tiny,
        np.where(half_t <= tiny, 1.0, 1.0 / np.maximum(half_t, tiny)),
        half_x)
    t_safe = np.where(half_x <= tiny,
                      np.where(half_t <= tiny, 1.0, half_t),
                      np.maximum(half_t, 1.0 / x_safe))

    fine_shape = []
    gamma = np.empty(rank, np.float64)
    for d in range(rank):
        n = int(2.0 * sigma * t_safe[d] * x_safe[d] / math.pi + width + 1)
        n = max(n, 2 * width)
        n = next_smooth_integer(n)
        fine_shape.append(n)
        gamma[d] = n / (2.0 * sigma * t_safe[d])
    fine_shape = tuple(fine_shape)
    # The inner type-2 oversamples this grid by sigma per dim; guard the
    # larger allocation here so the tailored message fires.
    inner_fine = int(np.prod([next_smooth_integer(int(n * sigma))
                              for n in fine_shape]))
    if inner_fine > MAX_ARRAY_SIZE:
        raise ValueError(
            f"type-3 fine grid is too big: {fine_shape} "
            f"(inner type-2 fine grid {inner_fine} elements > "
            f"{MAX_ARRAY_SIZE}). The grid scales with the product of the "
            "point and frequency extents per dimension.")
    h = 2.0 * math.pi / np.asarray(fine_shape, np.float64)
    sign = -1.0 if fft_direction == "forward" else 1.0

    xi = (x64 - x_c) / gamma                       # [M, rank]
    theta = (t64 - t_c) * gamma * h                # [K, rank]
    prephase = np.exp(sign * 1j * ((x64 - x_c) @ t_c))
    postphase = np.exp(sign * 1j * (t64 @ x_c))
    for d in range(rank):
        postphase = postphase / kernel_ft(theta[:, d], width, beta)
    return Type3Statics(
        rank=rank, num_points=int(x64.shape[0]),
        num_targets=int(t64.shape[0]), fine_shape=fine_shape,
        width=width, beta=beta, xi=xi, theta=theta,
        prephase=prephase, postphase=postphase)


def validate_type3_point_sets(points, target_points,
                              allowed_dtypes=(np.float32, np.float64)):
    """Shared validation: returns (x, t) as concrete numpy arrays."""
    x = _concrete(points, "points")
    t = _concrete(target_points, "target_points")
    if x.ndim != 2 or t.ndim != 2:
        raise ValueError(
            "type-3 points and target_points must have shape "
            f"[M, rank] / [K, rank]; got {x.shape} and {t.shape}. "
            "(Batch dims are supported on the strengths only.)")
    if x.shape[1] != t.shape[1]:
        raise ValueError(
            f"points and target_points disagree on rank: "
            f"{x.shape[1]} vs {t.shape[1]}.")
    if x.shape[1] not in (1, 2, 3):
        raise ValueError(f"rank must be 1, 2 or 3, got {x.shape[1]}.")
    if x.shape[0] == 0 or t.shape[0] == 0:
        raise ValueError(
            "type-3 point sets must be non-empty, got "
            f"{x.shape[0]} points and {t.shape[0]} target_points.")
    if x.dtype != t.dtype:
        raise TypeError(
            f"points and target_points must share a dtype, got "
            f"{x.dtype} vs {t.dtype}.")
    if x.dtype not in [np.dtype(d) for d in allowed_dtypes]:
        raise TypeError(
            f"points must be one of {[np.dtype(d).name for d in allowed_dtypes]}, "
            f"got {x.dtype}.")
    return x, t


def _concrete(arr, name: str) -> np.ndarray:
    try:
        return np.asarray(arr)
    except Exception as err:  # TracerArrayConversionError and friends
        raise ValueError(
            f"{name} must be concrete (non-traced) for a type-3 transform: "
            "the fine-grid geometry depends on the point values, so the "
            "point sets are plan-time statics. Build the Type3Plan (or "
            "call nufft_type3) outside jit; the resulting strength->values "
            "map is itself jittable.") from err


class Type3Plan:
    """Planned type-3 NUFFT for fixed point sets.

    Precomputes all point-dependent statics (fine-grid geometry, spread
    coordinates, inner type-2 points, phases, deconvolution weights) from
    concrete ``points`` / ``target_points``; ``__call__`` maps strengths
    ``[..., M] -> [..., K]`` and is jit/vmap/grad-compatible in the
    strengths.
    """

    def __init__(self, points, target_points,
                 fft_direction: str = "forward", tol: float = 1e-6,
                 options: Optional[Options] = None):
        if fft_direction not in _VALID_FFT_DIRECTIONS:
            raise ValueError(
                f"Invalid fft_direction: {fft_direction!r}. Must be one of "
                f"{sorted(_VALID_FFT_DIRECTIONS)}.")
        options = options or Options()
        if options.upsampling_factor not in (None, 0.0, 2.0):
            raise ValueError(
                "type-3 transforms support only upsampling_factor=2.0 "
                f"(got {options.upsampling_factor}).")
        x, t = validate_type3_point_sets(points, target_points)
        dtype_name = ("complex64" if x.dtype == np.float32
                      else "complex128")
        st = compute_type3_statics(
            np.asarray(x, np.float64), np.asarray(t, np.float64),
            fft_direction, tol, real_dt=x.dtype)

        rank = st.rank
        self.rank = rank
        self.num_points = st.num_points
        self.num_targets = st.num_targets
        self.fft_direction = fft_direction
        self.dtype = np.dtype(dtype_name)
        self._options = options
        self.fine_shape = st.fine_shape
        width = st.width

        real_dt = np.dtype(real_dtype(self.dtype))
        self._xi = jnp.asarray(st.xi.astype(real_dt))
        self._theta = jnp.asarray(st.theta.astype(real_dt))
        self._prephase = jnp.asarray(st.prephase.astype(self.dtype))
        self._postphase = jnp.asarray(st.postphase.astype(self.dtype))

        # Outer spread: the nf grid IS the spread grid (spread-only
        # geometry: fine == grid; nf is even, >= 2w, 5-smooth by
        # construction). kernel_scale is NOT applied — deconvolution by
        # the exact kernel FT happens in the postphase instead.
        self._spread_spec = PlanSpec(
            transform_type="type_1", fft_direction=fft_direction,
            rank=rank, grid_shape=self.fine_shape, dtype_name=dtype_name,
            tol=float(tol), points_range=0, spread_only=True,
            backend=options.backend,
            kernel_evaluation_method=options.kernel_evaluation_method)
        self._spread_plan = make_plan(self._spread_spec)
        if (self._spread_plan.width != width
                or self._spread_plan.fine_shape != self.fine_shape):
            raise AssertionError("type-3 spread plan geometry mismatch")
        self._points_resc = fold_and_rescale_split(
            self._xi, self.fine_shape, 0)
        # Inner type-2 on the nf grid at the rescaled target frequencies.
        self._t2_spec = PlanSpec(
            transform_type="type_2", fft_direction=fft_direction,
            rank=rank, grid_shape=self.fine_shape, dtype_name=dtype_name,
            tol=float(tol), points_range=0,
            backend=options.backend,
            kernel_evaluation_method=options.kernel_evaluation_method)
        self.tol = float(tol)

    def __call__(self, source) -> jax.Array:
        """Applies the transform: strengths [..., M] -> values [..., K]."""
        source = jnp.asarray(source)
        if source.dtype != self.dtype:
            hint = ""
            if (self.dtype == np.complex128
                    and source.dtype == np.dtype(np.complex64)
                    and not jax.config.jax_enable_x64):
                hint = (" (jax x64 is disabled, so complex128 inputs "
                        "downcast to complex64 — enable jax_enable_x64 "
                        "or build the plan with float32 points)")
            raise TypeError(
                f"source must be {self.dtype} (from the points dtype), "
                f"got {source.dtype}{hint}.")
        if source.ndim < 1 or source.shape[-1] != self.num_points:
            raise ValueError(
                f"source must have shape [..., {self.num_points}], got "
                f"{source.shape}.")
        batch_shape = source.shape[:-1]
        src = source.reshape((-1, self.num_points))
        # Bound fine-grid memory like the main API (_apply_batched's
        # max_batch_size chunking): the inner type-2's oversampled grid
        # dominates.
        max_bs = self._options.max_batch_size
        if max_bs is None:
            max_bs = auto_max_batch_size(self._t2_spec)
        out = chunked_map(self._apply_inner, src, max_bs)
        return out.reshape(batch_shape + (self.num_targets,))

    def _apply_inner(self, src: jax.Array) -> jax.Array:
        """One inner batch: [B, M] -> [B, K]."""
        src = src * self._prephase
        with prof.scope("nufft3.spread"):
            grid = dispatch.spread(src, self._points_resc,
                                   self._spread_plan)
        with prof.scope("nufft3.inner_t2"):
            vals = nufft_core(grid, self._theta, self._t2_spec)
        return vals * self._postphase


def nufft_type3(source, points, target_points,
                fft_direction: str = "forward", tol: float = 1e-6,
                options: Optional[Options] = None):
    """Computes the type-3 NUFFT (nonuniform -> nonuniform).

    Evaluates f_k = sum_j source_j exp(s i target_points_k . points_j)
    with s = -1 for ``fft_direction='forward'``, +1 for ``'backward'``,
    to relative precision ~``tol``. Unlike type-1/2 there is no uniform
    grid; both point sets are arbitrary real coordinates (any range —
    the transform rescales internally).

    The reference enumerates but does not implement type-3
    (cc/kernels/nufft_plan.cc:175-177); this framework does.

    Args:
        source: ``[..., M]`` complex strengths (batch dims allowed).
        points: ``[M, rank]`` real coordinates, rank in {1, 2, 3}. Must be
            concrete (not traced): the plan geometry depends on the values.
        target_points: ``[K, rank]`` real target frequencies. Concrete.
        fft_direction: "forward" (negative exponent) or "backward".
        tol: requested relative precision.
        options: optional ``Options`` (backend / kernel eval method).

    Returns:
        ``[..., K]`` complex values at the target frequencies.
    """
    plan = Type3Plan(points, target_points, fft_direction, tol, options)
    return plan(source)


def nudft_type3(source, points, target_points,
                fft_direction: str = "forward"):
    """Dense type-3 NUDFT oracle: O(M*K) work and memory; testing only."""
    if fft_direction not in _VALID_FFT_DIRECTIONS:
        raise ValueError(
            f"Invalid fft_direction: {fft_direction!r}. Must be one of "
            f"{sorted(_VALID_FFT_DIRECTIONS)}.")
    source = jnp.asarray(source)
    points = jnp.asarray(points)
    target_points = jnp.asarray(target_points)
    sign = -1.0 if fft_direction == "forward" else 1.0
    phase = jnp.matmul(target_points, points.T,
                       precision=jax.lax.Precision.HIGHEST)   # [K, M]
    mat = jnp.exp(jnp.asarray(sign * 1j, source.dtype)
                  * phase.astype(source.dtype))
    return jnp.einsum("km,...m->...k", mat, source,
                      precision=jax.lax.Precision.HIGHEST)
