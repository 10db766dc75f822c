"""Package metadata for tensorflow_nufft_tpu.

A from-scratch JAX (XLA/Pallas) non-uniform fast Fourier
transform framework with the capabilities of mrphys/tensorflow-nufft
(reference: tensorflow_nufft/__about__.py).
"""

__title__ = "tensorflow-nufft-tpu"
__summary__ = (
    "Non-uniform fast Fourier transform for JAX on NVIDIA GPUs: a "
    "tile-exclusive spread kernel, autodiff, batching/broadcasting, and "
    "multi-device sharding."
)
__uri__ = "https://localhost/tensorflow-nufft-tpu"
__version__ = "0.1.0"
__author__ = "The tensorflow-nufft-tpu Authors"
__license__ = "Apache 2.0"
