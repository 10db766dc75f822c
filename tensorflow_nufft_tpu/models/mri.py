"""Non-Cartesian MRI reconstruction built on the NUFFT.

The reference ships this as its flagship application notebook
(docs/examples/mri_app.ipynb): a radial k-space trajectory, a type-2
forward model, density-compensated type-1 adjoint, and an iterative
CG-SENSE reconstruction through the op's gradients. This module provides
those pieces as a first-class (planar, jit-able) model family.

Complex images/k-space are planar: real arrays with a trailing (re, im)
channel (see ``tensorflow_nufft_tpu.planar``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tensorflow_nufft_tpu import planar
from tensorflow_nufft_tpu.options.options import Options

# ---------------------------------------------------------------------------
# Planar complex helpers.


# Planar complex multiply: shared implementation lives in planar.pmul.
pmul = planar.pmul


def pconj(a: jax.Array) -> jax.Array:
    """Planar complex conjugate."""
    return jnp.stack([a[..., 0], -a[..., 1]], axis=-1)


def pabs2(a: jax.Array) -> jax.Array:
    """|a|^2 (real array, channel axis reduced)."""
    return jnp.sum(a * a, axis=-1)


# ---------------------------------------------------------------------------
# Trajectories and density compensation.


def radial_trajectory(num_spokes: int, num_samples: int,
                      golden_angle: bool = False,
                      dtype=np.float32) -> np.ndarray:
    """Radial k-space trajectory in radians/pixel.

    Returns [num_spokes * num_samples, 2] coordinates in [-pi, pi),
    matching the sampling used by the reference's MRI example.
    """
    if golden_angle:
        angles = np.arange(num_spokes) * np.pi * (3 - np.sqrt(5.0))
    else:
        angles = np.linspace(0, np.pi, num_spokes, endpoint=False)
    radii = (np.arange(num_samples) - num_samples / 2) \
        / (num_samples / 2) * np.pi
    kx = radii[None, :] * np.cos(angles[:, None])
    ky = radii[None, :] * np.sin(angles[:, None])
    return np.stack([kx.ravel(), ky.ravel()], axis=-1).astype(dtype)


def radial_density(num_spokes: int, num_samples: int,
                   dtype=np.float32) -> np.ndarray:
    """Ramp (|k|) density-compensation weights for a radial trajectory,
    normalized so a unit disk integrates to ~1. Shape
    [num_spokes * num_samples]."""
    radii = np.abs(np.arange(num_samples) - num_samples / 2) \
        / (num_samples / 2)
    radii = np.maximum(radii, 1.0 / num_samples)  # DC gets smallest cell
    w = np.tile(radii, num_spokes)
    w = w / (w.sum() * np.pi / num_spokes)
    return w.astype(dtype)


def pipe_menon_density(points, grid_shape: Tuple[int, ...],
                       num_iters: int = 30, tol: float = 1e-3,
                       options: Optional[Options] = None) -> jax.Array:
    """Iterative density-compensation weights for arbitrary trajectories
    (Pipe & Menon 1999).

    Fixed-point iteration ``w <- w / |C C^H w|`` where ``C C^H`` is the
    gridding-kernel k-space convolution (standalone ``spread`` followed
    by ``interp`` on a 2x-oversampled grid — no FFT stage), which drives
    the convolved sampling density flat. Works for any trajectory, unlike
    the analytic ``radial_density`` ramp; the reference ships only the
    analytic radial weights in its MRI example (docs/examples/
    mri_app.ipynb via tfmri.sampling.radial_density).

    The result is normalized to ``sum(w) == 1``, which makes the
    density-compensated adjoint ``A^H W`` approximately unit-gain for
    this framework's unnormalized transforms (the k = 0 response of
    ``A^H W A`` is exactly ``sum(w)``).

    Args:
        points: [M, rank] trajectory in radians, rank in {1, 2, 3}.
        grid_shape: target image grid (sets the convolution resolution).
        num_iters: fixed-point iterations (static; ~20-40 suffices).
        tol: kernel tolerance for the spread/interp pair (loose is fine:
            the iteration only needs a smooth local kernel).
        options: optional ``Options`` for the spread/interp ops.

    Returns:
        [M] float weights, ``sum(w) == 1``.
    """
    from tensorflow_nufft_tpu.kernels import xla_ops
    from tensorflow_nufft_tpu.plan.plan import PlanSpec, make_plan
    from tensorflow_nufft_tpu.utils.smooth import next_smooth_integer
    points = jnp.asarray(points)
    if points.ndim != 2:
        raise ValueError(
            f"points must have shape [M, rank], got {points.shape}")
    rank = int(points.shape[-1])
    if len(grid_shape) != rank:
        raise ValueError(
            f"grid_shape must have rank {rank}, got {grid_shape}")
    m = int(points.shape[0])
    fine = tuple(next_smooth_integer(2 * int(n)) for n in grid_shape)
    options = options or Options()

    # The spread/interp geometry (fold, per-point indices, ES kernel
    # values) depends only on the points: compute it ONCE outside the
    # fixed-point loop. The weights are real throughout, so the kernel
    # convolution runs on a single real channel (global normalization
    # constants cancel in the final sum-to-one step).
    spec = PlanSpec(
        transform_type="type_1", fft_direction="forward", rank=rank,
        grid_shape=fine, dtype_name=planar._dtype_name(points.dtype),
        tol=float(tol), points_range=int(options.points_range),
        spread_only=True,
        kernel_evaluation_method=options.kernel_evaluation_method)
    plan = make_plan(spec)
    resc = xla_ops.fold_and_rescale_split(points, fine,
                                          int(options.points_range))
    indices, kernels = xla_ops.spread_geometry(resc, plan)

    def body(_, w):
        g = xla_ops.spread_xla(w[None], indices, kernels, plan)
        v = xla_ops.interp_xla(g, indices, kernels, plan)[0]
        return w / jnp.maximum(jnp.abs(v), 1e-12)

    w = jax.lax.fori_loop(0, num_iters, body,
                          jnp.ones((m,), points.dtype))
    return w / jnp.sum(w)


def birdcage_maps(num_coils: int, grid_shape: Tuple[int, int],
                  dtype=np.float32) -> np.ndarray:
    """Simulated birdcage coil sensitivity maps (planar),
    [num_coils, *grid_shape, 2]. Standard synthetic maps for testing and
    benchmarks (no counterpart needed in the reference, which left coil
    handling to the user)."""
    ny, nx = grid_shape
    y, x = np.mgrid[0:ny, 0:nx]
    maps = np.empty((num_coils, ny, nx), np.complex64)
    for c in range(num_coils):
        ang = 2 * np.pi * c / num_coils
        cy = ny * (0.5 + 0.45 * np.sin(ang))
        cx = nx * (0.5 + 0.45 * np.cos(ang))
        r2 = ((y - cy) / ny) ** 2 + ((x - cx) / nx) ** 2
        maps[c] = np.exp(-4.0 * r2) * np.exp(1j * ang)
    # Normalize sum-of-squares to 1 where meaningful.
    sos = np.sqrt(np.sum(np.abs(maps) ** 2, axis=0))
    maps /= np.maximum(sos, 1e-3)
    out = np.stack([maps.real, maps.imag], axis=-1)
    return out.astype(dtype)


# ---------------------------------------------------------------------------
# SENSE forward model.


class SenseNufft:
    """Multicoil non-Cartesian MRI forward operator A = F_nu S.

    forward: image [*grid, 2] -> kspace [C, M, 2]
    adjoint: kspace [C, M, 2] -> image [*grid, 2]

    ``F_nu`` is the type-2 NUFFT at ``points``; ``S`` multiplies by coil
    sensitivities. The adjoint applies optional density compensation,
    the type-1 backward NUFFT, and a conjugate-map coil combination —
    the structure demonstrated in the reference's MRI notebook.

    With ``planned=True`` (default) and a single [M, rank] trajectory,
    the forward/adjoint pair runs on a shared ``planar.PlannedNufft``:
    the fold and the tile binning are computed once at construction (the
    trajectory is fixed across CG iterations). Falls back to the
    unplanned pipeline where the planned path does not serve (CPU, f64).
    """

    def __init__(self, points, maps, grid_shape: Tuple[int, ...],
                 density: Optional[jax.Array] = None,
                 tol: float = 1e-6,
                 options: Optional[Options] = None,
                 planned: bool = True,
                 toeplitz: bool = False):
        self.points = jnp.asarray(points)
        self.maps = jnp.asarray(maps)        # [C, *grid, 2]
        self.grid_shape = tuple(grid_shape)
        self.density = None if density is None else jnp.asarray(density)
        self.tol = tol
        self.options = options or Options()
        self._t2 = None
        self._slot_density = None
        self._toeplitz = None
        if planned and self.points.ndim == 2:
            self._t2 = planar.PlannedNufft(
                self.points, self.grid_shape, transform_type="type_2",
                fft_direction="forward", tol=tol, options=self.options)
            if self._t2._planned and self.density is not None:
                # Slot-order density for the fused normal operator.
                self._slot_density = self._t2.slot_weights(self.density)
        if toeplitz and self.points.ndim == 2:
            # Toeplitz-embedded normal: A^H W A as FFT-domain
            # convolution — no spread/interp per CG iteration at all.
            self._toeplitz = planar.ToeplitzNormal(
                self.points, self.grid_shape, weights=self.density,
                fft_direction="forward", tol=tol, options=self.options)

    def forward(self, image: jax.Array) -> jax.Array:
        """[*grid, 2] -> [C, M, 2]."""
        coil_images = pmul(self.maps, image[None])
        if self._t2 is not None:
            return self._t2(coil_images)
        return planar.nufft(coil_images, self.points,
                            transform_type="type_2",
                            fft_direction="forward", tol=self.tol,
                            options=self.options)

    def adjoint(self, kspace: jax.Array) -> jax.Array:
        """[C, M, 2] -> [*grid, 2] (density-compensated A^H)."""
        if self.density is not None:
            kspace = kspace * self.density[None, :, None]
        if self._t2 is not None:
            # The planned adjoint (type-1 backward) shares every
            # points-side artifact with the forward transform.
            coil_images = self._t2.adjoint()(kspace)
        else:
            coil_images = planar.nufft(kspace, self.points,
                                       grid_shape=self.grid_shape,
                                       transform_type="type_1",
                                       fft_direction="backward",
                                       tol=self.tol, options=self.options)
        return jnp.sum(pmul(pconj(self.maps), coil_images), axis=0)

    def normal(self, image: jax.Array) -> jax.Array:
        """A^H W A applied to an image (the CG system operator).

        With ``toeplitz=True`` the normal operator is the embedded
        FFT-domain convolution (``planar.ToeplitzNormal``): no
        spread/interp runs at all per iteration. Otherwise, on a planned
        transform this runs ``PlannedNufft.normal``: the per-coil point
        values are weighted in chunk-slot order and go straight to the
        spread kernel."""
        if self._toeplitz is not None:
            coil_images = pmul(self.maps, image[None])
            coil_normal = self._toeplitz(coil_images)
            return jnp.sum(pmul(pconj(self.maps), coil_normal), axis=0)
        if self._t2 is not None and self._t2._planned:
            coil_images = pmul(self.maps, image[None])
            coil_normal = self._t2.normal(coil_images,
                                          self._slot_density)
            return jnp.sum(pmul(pconj(self.maps), coil_normal), axis=0)
        return self.adjoint(self.forward(image))


def _pdot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Real inner product <a, b> over planar arrays."""
    return jnp.sum(a * b)


def cg_sense(kspace: jax.Array, op: SenseNufft, num_iters: int = 10,
             lamda: float = 0.0) -> jax.Array:
    """CG-SENSE reconstruction: solves the (density-weighted) normal
    equations (A^H W A + lamda I) x = A^H W y, with W = diag(op.density)
    (identity when no density is set). Note lamda trades off against
    the data term under W's normalization (radial_density sums to
    spokes/pi; pipe_menon_density to 1).

    Matches the iterative reconstruction demonstrated in the reference's
    MRI notebook, expressed as a jit-friendly lax.fori_loop.

    Args:
        kspace: [C, M, 2] measured data.
        op: the SENSE operator.
        num_iters: CG iterations (static).
        lamda: Tikhonov regularization.

    Returns:
        [*grid, 2] reconstructed image.
    """
    rhs = op.adjoint(kspace)

    def system(x):
        out = op.normal(x)
        if lamda:
            out = out + lamda * x
        return out

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    p0 = r0
    rs0 = _pdot(r0, r0)

    def body(_, state):
        x, r, p, rs = state
        ap = system(p)
        alpha = rs / jnp.maximum(_pdot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _pdot(r, r)
        beta = rs_new / jnp.maximum(rs, 1e-30)
        p = r + beta * p
        return (x, r, p, rs_new)

    x, _, _, _ = jax.lax.fori_loop(0, num_iters, body,
                                   (x0, r0, p0, rs0))
    return x


def shepp_logan(grid_shape: Tuple[int, int],
                dtype=np.float32) -> np.ndarray:
    """Simple Shepp-Logan-like phantom (planar, zero imaginary part)."""
    ny, nx = grid_shape
    y, x = np.mgrid[0:ny, 0:nx]
    y = (y - ny / 2) / (ny / 2)
    x = (x - nx / 2) / (nx / 2)
    img = np.zeros((ny, nx), np.float64)
    for (cy, cx, ry, rx, val) in [
            (0.0, 0.0, 0.85, 0.65, 1.0),
            (0.0, 0.0, 0.78, 0.58, -0.6),
            (-0.2, 0.2, 0.3, 0.15, 0.4),
            (-0.2, -0.2, 0.25, 0.12, 0.35),
            (0.35, 0.0, 0.15, 0.2, 0.3)]:
        img += val * (((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 < 1)
    out = np.stack([img, np.zeros_like(img)], axis=-1)
    return out.astype(dtype)
