"""Planar (split re/im) DFT via dense matmuls.

Computes the DFT of planar tensors — real arrays with a trailing re/im
channel — as dense per-axis contractions against precomputed
cosine/sine twiddle matrices. The pruned forms fuse mode truncation or
zero-padding and the kernel deconvolution into the same contraction.

For the fine-grid sizes this framework targets (hundreds per axis), a
dense per-axis DFT is O(N) matmul work per element. Precision is forced
to HIGHEST (float32 products): a float32 matmul at default precision may
run in TF32 on a GPU (about three decimal digits, far above tolerance).

Replaces the FFTW/cuFFT stage of the reference
(cc/kernels/nufft_plan.cc:364-430; fftw_api.h).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=64)
def _twiddles(n: int) -> tuple:
    """(C, S) with C[l,k] = cos(2 pi l k / n), S likewise sin; float64."""
    lk = np.outer(np.arange(n), np.arange(n))
    ang = (2.0 * np.pi / n) * lk
    return np.cos(ang), np.sin(ang)


def _mode_twiddles(nf: int, n: int, sign: float, weights: np.ndarray,
                   truncating: bool) -> tuple:
    """Pruned, weighted DFT matrices fusing the deconvolve/amplify stage.

    Mode i (CMCL order, k = i - n//2) lives at fine-grid slot k mod nf.
    For the type-1 direction (truncating=True) returns (C, S) of shape
    [nf, n] with C[l, i] = w[i] cos(2 pi l slot_i / nf) and
    S[l, i] = sign * w[i] sin(...); for type-2 (truncating=False) the
    transposed [n, nf] layout. Contracting with these computes
    DFT + mode truncation/zero-padding + kernel deconvolution in one
    matmul (the reference does these as separate passes,
    cc/kernels/nufft_plan.cc:705-881).
    """
    k = np.arange(n) - n // 2
    slots = np.mod(k, nf)
    ang = (2.0 * np.pi / nf) * np.outer(np.arange(nf), slots)  # [nf, n]
    c = np.cos(ang) * weights[None, :]
    s = sign * np.sin(ang) * weights[None, :]
    if truncating:
        return c, s
    return c.T.copy(), s.T.copy()


def _contract_planar(xr, xi, c, s, axis, precision):
    """(xr + i xi) contracted along `axis` with (c + i s); returns planar
    pair with the transformed axis restored in place."""
    ar = jnp.tensordot(xr, c, axes=[[axis], [0]], precision=precision)
    br = jnp.tensordot(xr, s, axes=[[axis], [0]], precision=precision)
    ai = jnp.tensordot(xi, c, axes=[[axis], [0]], precision=precision)
    bi = jnp.tensordot(xi, s, axes=[[axis], [0]], precision=precision)
    yr = jnp.moveaxis(ar - bi, -1, axis)
    yi = jnp.moveaxis(ai + br, -1, axis)
    return yr, yi


def dft_truncate_deconvolve(x: jax.Array, plan,
                            precision=jax.lax.Precision.HIGHEST
                            ) -> jax.Array:
    """Type-1 post-stage: [B, *fine, 2] -> [B, *grid, 2] modes (CMCL),
    computing DFT + truncation + deconvolution as one pruned matmul per
    axis."""
    sign = -1.0 if plan.spec.fft_direction == "forward" else 1.0
    xr, xi = x[..., 0], x[..., 1]
    for d in range(plan.rank):
        c_np, s_np = _mode_twiddles(
            plan.fine_shape[d], plan.grid_shape[d], sign,
            plan.deconv_weights(d), truncating=True)
        c = jnp.asarray(c_np, x.dtype)
        s = jnp.asarray(s_np, x.dtype)
        xr, xi = _contract_planar(xr, xi, c, s, 1 + d, precision)
    return jnp.stack([xr, xi], axis=-1)


def amplify_pad_dft(x: jax.Array, plan,
                    precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """Type-2 pre-stage: [B, *grid, 2] modes (CMCL) -> [B, *fine, 2]
    fine-grid values, computing amplification + zero-padding + DFT as one
    pruned matmul per axis."""
    sign = -1.0 if plan.spec.fft_direction == "forward" else 1.0
    xr, xi = x[..., 0], x[..., 1]
    for d in range(plan.rank):
        c_np, s_np = _mode_twiddles(
            plan.fine_shape[d], plan.grid_shape[d], sign,
            plan.deconv_weights(d), truncating=False)
        c = jnp.asarray(c_np, x.dtype)
        s = jnp.asarray(s_np, x.dtype)
        xr, xi = _contract_planar(xr, xi, c, s, 1 + d, precision)
    return jnp.stack([xr, xi], axis=-1)


@functools.lru_cache(maxsize=64)
def _doubled_twiddles(n: int) -> tuple:
    """(C, S) of shape [n, 2n] with C[l, k] = cos(pi l k / n),
    S[l, k] = sin(pi l k / n) — the DFT twiddles between an N-support
    signal and its 2N torus (float64; cast at use)."""
    lk = np.outer(np.arange(n), np.arange(2 * n))
    ang = (np.pi / n) * lk
    return np.cos(ang), np.sin(ang)


def dft_doubled_planar(x: jax.Array, rank: int, forward: bool,
                       precision=jax.lax.Precision.HIGHEST
                       ) -> jax.Array:
    """Pruned planar DFT between N-support and the 2N torus.

    forward=True: [B, *N, 2] -> [B, *2N, 2], the 2N-point forward DFT
    (sign e^{-i}) of the zero-padded input — the pad never
    materializes (the twiddle matrices are [N, 2N]).
    forward=False: [B, *2N, 2] -> [B, *N, 2], the UNNORMALIZED inverse
    (sign e^{+i}) cropped to the leading N samples per axis — fold the
    1/(2N)^rank into the spectrum being applied.

    The two directions are the wings of the Toeplitz-embedded normal
    operator (see planar.ToeplitzNormal).
    """
    xr, xi = x[..., 0], x[..., 1]
    for d in range(rank):
        axis = 1 + d
        if forward:
            n = xr.shape[axis]
            c_np, s_np = _doubled_twiddles(n)
            c = jnp.asarray(c_np, x.dtype)          # [n, 2n]
            s = jnp.asarray(-s_np, x.dtype)
        else:
            n2 = xr.shape[axis]
            c_np, s_np = _doubled_twiddles(n2 // 2)
            c = jnp.asarray(c_np.T.copy(), x.dtype)  # [2n, n]
            s = jnp.asarray(s_np.T.copy(), x.dtype)
        xr, xi = _contract_planar(xr, xi, c, s, axis, precision)
    return jnp.stack([xr, xi], axis=-1)


def dft_planar(x: jax.Array, rank: int, fft_direction: str,
               precision=jax.lax.Precision.HIGHEST) -> jax.Array:
    """DFT over the ``rank`` spatial axes of a planar tensor.

    Args:
        x: [B, *spatial, 2] real array; last axis is (re, im).
        rank: number of trailing spatial axes (before the channel axis).
        fft_direction: 'forward' -> exp(-i...), 'backward' -> exp(+i...)
            with no normalization (matches ``fft_fine``'s ifft * N).

    Returns:
        [B, *spatial, 2] transformed planar tensor.
    """
    sign = -1.0 if fft_direction == "forward" else 1.0
    xr = x[..., 0]
    xi = x[..., 1]
    dtype = x.dtype
    for d in range(rank):
        axis = 1 + d
        n = xr.shape[axis]
        c_np, s_np = _twiddles(n)
        c = jnp.asarray(c_np, dtype=dtype)
        s = jnp.asarray(s_np, dtype=dtype)
        # y = (xr + i xi) (C + i sign S) along `axis`:
        #   yr = xr C - sign xi S ; yi = xi C + sign xr S
        ar = jnp.tensordot(xr, c, axes=[[axis], [0]], precision=precision)
        br = jnp.tensordot(xr, s, axes=[[axis], [0]], precision=precision)
        ai = jnp.tensordot(xi, c, axes=[[axis], [0]], precision=precision)
        bi = jnp.tensordot(xi, s, axes=[[axis], [0]], precision=precision)
        yr = ar - sign * bi
        yi = ai + sign * br
        # tensordot moved the transformed axis to the end; restore it.
        xr = jnp.moveaxis(yr, -1, axis)
        xi = jnp.moveaxis(yi, -1, axis)
    return jnp.stack([xr, xi], axis=-1)
