"""Compute kernels: the XLA scatter/gather path and the GPU spread kernel.

``xla_ops`` is the portable, always-correct path built from XLA
scatter/gather; ``triton_spread`` is the tile-exclusive type-1 spread
kernel (Pallas through Triton), selected by ``dispatch`` where it was
measured faster.
"""

from tensorflow_nufft_tpu.kernels.xla_ops import (
    fold_and_rescale,
    es_kernel,
    spread_geometry,
    spread_xla,
    interp_xla,
)

__all__ = [
    "fold_and_rescale",
    "es_kernel",
    "spread_geometry",
    "spread_xla",
    "interp_xla",
]
