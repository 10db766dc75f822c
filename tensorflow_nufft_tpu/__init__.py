"""Non-uniform fast Fourier transform for JAX, run on NVIDIA GPUs.

A from-scratch re-design of the capabilities of mrphys/tensorflow-nufft
(reference exports: tensorflow_nufft/__init__.py:17-20) in JAX:
jit-compiled XLA pipelines, a tile-exclusive spread kernel (Pallas through
Triton) for the type-1 hot loop, custom-VJP autodiff, NumPy-style
batching/broadcasting, and multi-device sharding via ``jax.sharding``.

Typical usage::

    import tensorflow_nufft_tpu as tfft
    target = tfft.nufft(source, points, transform_type='type_2')
"""

from tensorflow_nufft_tpu.__about__ import __version__
from tensorflow_nufft_tpu.ops.nufft_ops import nufft, interp, spread, nudft
from tensorflow_nufft_tpu.ops.type3 import (
    Type3Plan, nudft_type3, nufft_type3)
from tensorflow_nufft_tpu import planar
from tensorflow_nufft_tpu import parallel
from tensorflow_nufft_tpu.options.options import (
    Options,
    DebuggingOptions,
    FftwOptions,
    FftwPlanningRigor,
    PointsRange,
)

__all__ = [
    "planar",
    "nufft",
    "nufft_type3",
    "nudft_type3",
    "Type3Plan",
    "interp",
    "spread",
    "nudft",
    "Options",
    "DebuggingOptions",
    "FftwOptions",
    "FftwPlanningRigor",
    "PointsRange",
    "__version__",
]
