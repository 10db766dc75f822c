"""NUFFT plan: static, trace-time computation of all transform parameters.

The reference implementation builds a C++ ``Plan`` object per op call
(reference: cc/kernels/nufft_plan.h:223-256, nufft_plan.cc:166-265). In this
framework the plan is a frozen Python dataclass computed once at
trace time and cached: every quantity here (upsampling factor, kernel width,
beta, fine grid dims, kernel Fourier series) is a static constant under
``jax.jit``, so XLA sees fully concrete shapes and weights.

Numerical parity targets (formulas re-derived, constants matched):
  - tolerance -> (upsampling sigma, kernel width): nufft_plan.h:739-780.
  - "exponential of semicircle" kernel parameters beta, c:
    nufft_plan.cc:925-940 (Barnett-Magland-af Klinteberg 2019).
  - fine grid sizing: nufft_plan.h:803-863 (sigma*N, >=2w, 5-smooth even).
  - kernel Fourier series by Gauss-Legendre quadrature with phase winding:
    nufft_util.cc:71-117.
  - spread/interp-only normalization: nufft_util.cc:43-62.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np

# Parity constants (reference: cc/kernels/nufft_plan.h:62-68, :84-89).
MAX_ARRAY_SIZE = 2_000_000_000
MAX_QUAD_NODES = 100
MAX_KERNEL_WIDTH = 16

# Smallest meaningful tolerance per precision; requested tolerances are
# clamped from below (reference: nufft_plan.h:87-89, nufft_plan.cc:189).
EPSILON = {
    np.dtype(np.float32): 6e-08,
    np.dtype(np.float64): 1.1e-16,
}


def select_upsampling_factor(
    tol: float,
    rank: int,
    grid_size: int,
    user_value: Optional[float] = None,
) -> float:
    """Chooses the fine-grid oversampling factor sigma.

    Default is 2.0; large low-precision problems use 1.25 to save memory
    and FFT time (reference: nufft_plan.h:739-760).
    """
    if user_value is not None and user_value != 0.0:
        if user_value <= 1.0:
            raise ValueError(
                f"upsampling_factor must be > 1.0, but got: {user_value}")
        return float(user_value)
    sigma = 2.0
    if tol >= 1e-9:
        if ((rank == 1 and grid_size > 10_000_000)
                or (rank == 2 and grid_size > 300_000)
                or (rank == 3 and grid_size > 3_000_000)):
            sigma = 1.25
    return sigma


def select_kernel_width(tol: float, sigma: float) -> int:
    """Kernel width (number of grid points the kernel spans) from tolerance.

    sigma == 2.0 uses the empirical one-digit-per-point rule; other sigmas
    use the ES-kernel aliasing estimate (reference: nufft_plan.h:762-777).
    """
    if sigma == 2.0:
        width = math.ceil(-math.log10(tol / 10.0))
    else:
        width = math.ceil(
            -math.log(tol) / (math.pi * math.sqrt(1.0 - 1.0 / sigma)))
    return int(min(max(width, 2), MAX_KERNEL_WIDTH))


def kernel_beta(width: int, sigma: float) -> float:
    """ES kernel shape parameter beta for a given width and sigma.

    beta = beta_over_width * width, with small-width tweaks for sigma=2 and
    the gamma=0.97 cutoff formula otherwise (reference: nufft_plan.cc:925-940).
    """
    beta_over_width = {2: 2.20, 3: 2.26, 4: 2.38}.get(width, 2.30)
    if sigma != 2.0:
        gamma = 0.97
        beta_over_width = gamma * math.pi * (1.0 - 1.0 / (2.0 * sigma))
    return beta_over_width * width


def es_kernel_np(z: np.ndarray, beta: float, c: float,
                 half_width: float) -> np.ndarray:
    """Reference "exponential of semicircle" kernel, evaluated in float64.

    phi(z) = exp(beta * sqrt(1 - c z^2)) on |z| < width/2, else 0
    (reference: nufft_util.cc:64-69). Used at trace time only; the device
    path has its own jnp/Pallas evaluators.
    """
    z = np.asarray(z, dtype=np.float64)
    inside = np.abs(z) < half_width
    arg = np.maximum(1.0 - c * z * z, 0.0)
    return np.where(inside, np.exp(beta * np.sqrt(arg)), 0.0)


def fit_horner_coeffs(width: int, beta: float,
                      tol: float) -> Tuple[float, ...]:
    """Fits the ES kernel as ONE polynomial in t = 2 (2z/w)^2 - 1.

    A re-design of the reference's piecewise-Horner kernel tables
    (kernel_horner_sigma2.inc, dispatched at nufft_plan.cc:1291-1307):
    piecewise-per-offset polynomials need per-entry piece selection
    (cheap per CUDA thread, expensive on a vector unit), but since the
    kernel is even, a single Chebyshev fit in the squared argument
    converges fast wherever it matters — the endpoint sqrt-singularity
    region contributes only O(e^-beta) relative to the peak. Degree
    10-16 reaches ~3e-8 relative-to-peak, and a float32 Horner
    evaluation stays at a few ULPs of the peak (~3e-7), versus ~1e-6
    for direct exp/sqrt in float32 (argument rounding is amplified by
    beta). Coefficients are derived independently via least-squares on
    Chebyshev nodes — nothing is copied from the reference's generated
    tables.

    Returns power-basis coefficients (a_0, ..., a_d) in t, ascending.
    """
    hw = width / 2.0
    c = 4.0 / (width * width)
    target = max(tol / 50.0, 2.5e-8)
    zz = np.linspace(0.0, hw, 4001)[:-1]
    tz = 2.0 * (zz / hw) ** 2 - 1.0
    phi = np.exp(beta * np.sqrt(np.maximum(1.0 - c * zz * zz, 0.0)))
    peak = float(phi.max())
    best = None
    for deg in range(6, 25):
        n = 4 * deg + 8
        tn = np.cos(np.pi * (np.arange(n) + 0.5) / n)
        u = (tn + 1.0) / 2.0
        z = hw * np.sqrt(u)
        f = np.exp(beta * np.sqrt(np.maximum(1.0 - c * z * z, 0.0)))
        cf = np.polynomial.chebyshev.chebfit(tn, f, deg)
        pw = np.polynomial.chebyshev.cheb2poly(cf)
        err = float(np.max(np.abs(np.polyval(pw[::-1], tz) - phi))) / peak
        if best is None or err < best[0]:
            best = (err, pw)
        if err <= target:
            break
    return tuple(float(a) for a in best[1])


def kernel_fseries_1d(fine_dim: int, width: int, beta: float) -> np.ndarray:
    """Fourier series coefficients of the ES kernel along one dimension.

    Computes ``fine_dim//2 + 1`` coefficients via Gauss-Legendre quadrature
    over half the kernel support with phase winding; the (-1)^j factor
    accounts for the +pi shift used when folding points into [0, fine_dim)
    (reference: nufft_util.cc:71-117). Trace-time, float64, vectorized.
    """
    half_width = width / 2.0
    c = 4.0 / (width * width)
    q = int(2 + 3.0 * half_width)  # quadrature nodes on (0, half_width)
    if 2 * q > 2 * MAX_QUAD_NODES:
        raise ValueError(f"too many quadrature nodes: {q}")
    # Symmetric 2q-point rule on (-1, 1); keep the positive half.
    nodes, weights = np.polynomial.legendre.leggauss(2 * q)
    z = nodes[q:] * half_width
    f = half_width * weights[q:] * es_kernel_np(z, beta, c, half_width)
    j = np.arange(fine_dim // 2 + 1, dtype=np.float64)
    # fseries[j] = (-1)^j * 2 * sum_n f_n cos(2 pi j z_n / fine_dim)
    phases = np.cos((2.0 * np.pi / fine_dim) * np.outer(j, z))
    signs = np.where(np.arange(fine_dim // 2 + 1) % 2 == 0, 1.0, -1.0)
    return signs * (2.0 * (phases @ f))


def calculate_scale_factor(rank: int, width: int, beta: float) -> float:
    """Normalization for standalone spread/interp so they are unit-scaled.

    Matches the reference's n=100 midpoint-style Riemann sum of the kernel
    integral exactly, including its quirks, because the factor is observable
    in op outputs (reference: nufft_util.cc:43-62).
    """
    n = 100
    h = 2.0 / n
    x = -1.0 + h * np.arange(1, n, dtype=np.float64)
    total = float(np.sum(np.exp(beta * np.sqrt(np.maximum(1.0 - x * x, 0.0)))))
    total += 1.0
    total *= h
    total *= math.sqrt(1.0 / (4.0 / (width * width)))  # * width / 2
    return 1.0 / total ** rank


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Hashable static key describing a transform; the argument to
    ``make_plan`` and the ``nondiff`` static argument of the core op."""
    transform_type: str            # 'type_1' | 'type_2'
    fft_direction: str             # 'forward' | 'backward'
    rank: int
    grid_shape: Tuple[int, ...]    # mode dims (type-1 output / type-2 input)
    dtype_name: str                # 'complex64' | 'complex128'
    tol: float
    points_range: int              # 0 strict / 1 extended / 2 infinite
    spread_only: bool = False
    upsampling_factor: Optional[float] = None
    backend: str = "auto"          # 'auto' | 'xla' | 'pallas'
    kernel_evaluation_method: str = "auto"  # 'auto' | 'direct' | 'horner'


@dataclasses.dataclass(frozen=True)
class NufftPlan:
    """All static parameters of one NUFFT configuration."""
    spec: PlanSpec
    sigma: float
    width: int
    beta: float
    c: float                        # ES kernel c = 4 / width^2
    half_width: float
    fine_shape: Tuple[int, ...]
    fseries: Tuple[np.ndarray, ...]   # per-dim, float64, len nf//2+1
    kernel_scale: float               # spread/interp-only normalization
    tol: float                        # clamped tolerance
    # Horner polynomial for float32 kernel evaluation (None for f64
    # plans, where direct exp/sqrt is already exact enough): power-basis
    # coefficients in t = 2 (2z/width)^2 - 1, ascending.
    horner: Optional[Tuple[float, ...]] = None

    @property
    def rank(self) -> int:
        return self.spec.rank

    @property
    def grid_shape(self) -> Tuple[int, ...]:
        return self.spec.grid_shape

    @property
    def dir_sign(self) -> int:
        """Sign of i in exp(sign * i k.x): forward=-1, backward=+1."""
        return -1 if self.spec.fft_direction == "forward" else 1

    @property
    def fine_size(self) -> int:
        return int(np.prod(self.fine_shape))

    def deconv_weights(self, dim: int) -> np.ndarray:
        """1 / fseries factors in CMCL mode order for grid axis `dim`.

        Array index i in [0, N) corresponds to mode k = i - N//2; the
        weight is 1 / fseries[|k|] (reference: nufft_plan.cc:729-780).
        """
        n = self.grid_shape[dim]
        k = np.arange(n) - n // 2
        return 1.0 / self.fseries[dim][np.abs(k)]


def auto_max_batch_size(spec: "PlanSpec",
                        channels_per_batch: int = 1) -> int:
    """Automatic inner-batch cap: the largest batch whose fine grids fit
    the allocation guard. The reference sizes inner batches per thread
    count (CPU, nufft_plan.cc:211-219) or caps at 8 (GPU,
    nufft_plan.cu.cc:1923-1928) to bound fine-grid memory; here the
    cap is memory-driven: vectorize as wide as the guard allows."""
    plan = make_plan(spec)
    return max(1, int(MAX_ARRAY_SIZE
                      // max(plan.fine_size * channels_per_batch, 1)))


def warn_if_tol_clamped(tol: float, dtype_name: str,
                        show_warnings: bool) -> None:
    """Warns when a requested tolerance below machine precision is
    clamped (the reference's show_warnings behavior,
    nufft_options.h:102-103; clamping at nufft_plan.cc:189)."""
    if not show_warnings:
        return
    real_dt = np.dtype(np.float32) if dtype_name == "complex64"         else np.dtype(np.float64)
    eps = EPSILON[real_dt]
    if float(tol) < eps:
        import warnings
        warnings.warn(
            f"Requested tolerance {tol:g} is below the {real_dt.name} "
            f"precision floor; clamped to {eps:g}.", RuntimeWarning,
            stacklevel=3)


def log_plan_summary(spec: "PlanSpec", verbosity: int) -> None:
    """One-line plan summary to stderr at verbosity >= 1 (the role of the
    reference's verbosity printfs, nufft_options.h:98-100,
    nufft_plan.cc:1060). Runs at trace time; the plan is lru-cached so
    this costs nothing extra."""
    if verbosity < 1:
        return
    import sys
    plan = make_plan(spec)
    print(
        f"[tfft] plan: {spec.transform_type} {spec.fft_direction} "
        f"rank={spec.rank} grid={spec.grid_shape} tol={plan.tol:g} "
        f"sigma={plan.sigma} width={plan.width} beta={plan.beta:.4f} "
        f"fine={plan.fine_shape} backend={spec.backend}",
        file=sys.stderr, flush=True)


def check_fine_grid_size(plan: "NufftPlan", batch: int) -> None:
    """Guards the total fine-grid allocation including the inner batch
    (the reference checks fine_size * batch_size, nufft_plan.h:843-848;
    checking fine_size alone would let large inner batches through)."""
    total = int(batch) * int(np.prod(plan.fine_shape))
    if total > MAX_ARRAY_SIZE:
        raise ValueError(
            f"Fine grid is too big: batch {batch} x fine grid "
            f"{plan.fine_shape} = {total} elements > {MAX_ARRAY_SIZE}")


@functools.lru_cache(maxsize=512)
def make_plan(spec: PlanSpec) -> NufftPlan:
    """Builds (and caches) the static plan for a transform spec."""
    rank = spec.rank
    if rank not in (1, 2, 3):
        raise ValueError(f"rank must be 1, 2 or 3, got {rank}")
    if len(spec.grid_shape) != rank:
        raise ValueError(
            f"grid_shape must have rank {rank}, got {spec.grid_shape}")
    if spec.transform_type not in ("type_1", "type_2"):
        raise ValueError(
            f"transform_type must be 'type_1' or 'type_2', got "
            f"{spec.transform_type!r}")
    if spec.fft_direction not in ("forward", "backward"):
        raise ValueError(
            f"fft_direction must be 'forward' or 'backward', got "
            f"{spec.fft_direction!r}")

    real_dt = np.dtype(np.float32) if spec.dtype_name == "complex64" \
        else np.dtype(np.float64)
    tol = max(float(spec.tol), EPSILON[real_dt])

    grid_size = int(np.prod(spec.grid_shape))
    if spec.spread_only:
        # Standalone spread/interp: no oversampling; sigma fixed at 2.0 for
        # kernel-width selection (reference: nufft_kernels.cc:457-460).
        sigma = 2.0
    else:
        sigma = select_upsampling_factor(
            tol, rank, grid_size, spec.upsampling_factor)
    width = select_kernel_width(tol, sigma)
    beta = kernel_beta(width, sigma)
    c = 4.0 / (width * width)

    from tensorflow_nufft_tpu.utils.smooth import next_smooth_integer
    fine_shape = []
    for d in range(rank):
        n = spec.grid_shape[d]
        if spec.spread_only:
            fine = n
        else:
            fine = int(n * sigma)
        fine = max(fine, 2 * width)
        fine = next_smooth_integer(fine)
        if spec.spread_only and fine != n:
            raise ValueError(
                f"Invalid grid dimension size: {n}. Grid dimension must be "
                f"even, larger than the kernel ({2 * width}) and have no "
                f"prime factors larger than 5.")
        fine_shape.append(fine)
    fine_shape = tuple(fine_shape)

    if int(np.prod(fine_shape)) > MAX_ARRAY_SIZE:
        raise ValueError(
            f"Fine grid is too big: size {int(np.prod(fine_shape))} > "
            f"{MAX_ARRAY_SIZE}")

    fseries = tuple(
        kernel_fseries_1d(fine_shape[d], width, beta) for d in range(rank))
    kernel_scale = calculate_scale_factor(rank, width, beta) \
        if spec.spread_only else 1.0
    # Kernel evaluation method (reference: KernelEvaluationMethod,
    # nufft_options.h:62-70): 'auto' fits a Horner polynomial for f32
    # plans (more accurate than direct f32 exp/sqrt) and uses direct
    # evaluation for f64 (already exact enough); 'direct'/'horner'
    # force one. Everything downstream keys off ``plan.horner is None``.
    kev = spec.kernel_evaluation_method
    if kev == "horner" and real_dt != np.dtype(np.float32):
        raise ValueError(
            "kernel_evaluation_method='horner' requires a float32/"
            "complex64 transform; float64 plans evaluate the kernel "
            "directly (the fitted polynomial targets f32 accuracy).")
    use_horner = (kev == "horner"
                  or (kev == "auto" and real_dt == np.dtype(np.float32)))
    horner = fit_horner_coeffs(width, beta, tol) if use_horner else None

    return NufftPlan(
        spec=spec,
        sigma=sigma,
        width=width,
        beta=beta,
        c=c,
        half_width=width / 2.0,
        fine_shape=fine_shape,
        fseries=fseries,
        kernel_scale=kernel_scale,
        tol=tol,
        horner=horner,
    )
