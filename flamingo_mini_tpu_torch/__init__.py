"""flamingo_mini_tpu_torch: the Flamingo captioner on PyTorch and CUDA.

A port of the JAX package ``flamingo_mini_tpu`` (which stays the reference)
for NVIDIA Hopper cards. Plain tensor code is PyTorch; the TPU kernels of
the ported path are hand-written CUDA C++ under ``csrc/``, built at first
use. This package never imports jax.
"""
from .configuration_flamingo import FlamingoConfig
from .flamingo_processor import FlamingoProcessor
from .modeling_flamingo import FlamingoModel

__all__ = ["FlamingoConfig", "FlamingoModel", "FlamingoProcessor"]
