"""Utilities: the parameter-tree tooling (``params``), the JAX parameter
bridge, checkpoint formats, and profiling (``profiling``)."""
from .params import (
    tree_size,
    trainable_mask,
    partition_params,
    merge_params,
)

__all__ = ["tree_size", "trainable_mask", "partition_params", "merge_params"]
