"""FFT, deconvolution and amplification stages of the NUFFT.

The reference plans FFTW/cuFFT transforms at plan-creation time
(cc/kernels/nufft_plan.cc:364-430, nufft_plan.cu.cc:2227-2285); XLA's
FFT (cuFFT on a GPU) needs no planning here. Mode reordering between CMCL (centered) order
and the FFT's wrap order is pure slicing/concatenation, which XLA fuses —
no gather/scatter needed (contrast cc/kernels/nufft_plan.cc:705-881).

Conventions:
  - 'forward' means a negative exponent sign, 'backward' positive
    (reference: python/ops/nufft_ops.py:74-78).
  - Mode (CMCL) order: array index i along a size-N axis is mode
    k = i - N//2.
  - The fine-grid FFT slot for mode k is k mod nf.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tensorflow_nufft_tpu.plan.plan import NufftPlan
from tensorflow_nufft_tpu.utils.dtypes import real_dtype


def fft_fine(fine: jax.Array, rank: int, fft_direction: str) -> jax.Array:
    """FFT over the trailing ``rank`` axes with the requested sign.

    forward: X[k] = sum_l x[l] exp(-2 pi i k l / n)
    backward: X[k] = sum_l x[l] exp(+2 pi i k l / n)
    """
    axes = tuple(range(-rank, 0))
    if fft_direction == "forward":
        return jnp.fft.fftn(fine, axes=axes)
    size = np.prod([fine.shape[a] for a in axes])
    return jnp.fft.ifftn(fine, axes=axes) * jnp.asarray(size, fine.dtype)


def _weight(plan: NufftPlan, dim: int, dtype) -> np.ndarray:
    """Separable deconvolution weights 1/fseries in CMCL order, float."""
    return plan.deconv_weights(dim).astype(np.dtype(real_dtype(dtype)))


def deconvolve(fine_hat: jax.Array, plan: NufftPlan) -> jax.Array:
    """Truncates FFT output to the requested modes and divides by the
    kernel Fourier series (type-1 step 3).

    Args:
        fine_hat: [B, *fine_shape] FFT of the fine grid.

    Returns:
        [B, *grid_shape] mode coefficients in CMCL order.
    """
    x = fine_hat
    for d in range(plan.rank):
        axis = 1 + d
        n = plan.grid_shape[d]
        nf = plan.fine_shape[d]
        neg = jax.lax.slice_in_dim(x, nf - n // 2, nf, axis=axis)
        pos = jax.lax.slice_in_dim(x, 0, n - n // 2, axis=axis)
        x = jnp.concatenate([neg, pos], axis=axis)
    for d in range(plan.rank):
        w = _weight(plan, d, x.dtype)
        shape = [1] * x.ndim
        shape[1 + d] = plan.grid_shape[d]
        x = x * jnp.asarray(w).reshape(shape)
    return x


def amplify(modes: jax.Array, plan: NufftPlan) -> jax.Array:
    """Pre-weights mode coefficients and zero-pads into the fine grid
    (type-2 step 1, "amplification"/deconvolution transpose).

    Args:
        modes: [B, *grid_shape] coefficients in CMCL order.

    Returns:
        [B, *fine_shape] fine-grid spectrum, zero outside the mode band.
    """
    x = modes
    for d in range(plan.rank):
        w = _weight(plan, d, x.dtype)
        shape = [1] * x.ndim
        shape[1 + d] = plan.grid_shape[d]
        x = x * jnp.asarray(w).reshape(shape)
    for d in range(plan.rank):
        axis = 1 + d
        n = plan.grid_shape[d]
        nf = plan.fine_shape[d]
        neg = jax.lax.slice_in_dim(x, 0, n // 2, axis=axis)
        pos = jax.lax.slice_in_dim(x, n // 2, n, axis=axis)
        pad_shape = list(x.shape)
        pad_shape[axis] = nf - n
        zeros = jnp.zeros(pad_shape, dtype=x.dtype)
        x = jnp.concatenate([pos, zeros, neg], axis=axis)
    return x
