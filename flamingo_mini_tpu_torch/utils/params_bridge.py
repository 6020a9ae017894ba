"""Bring a JAX parameter tree into the port.

``from_jax_numpy`` takes the JAX package's parameter pytree after
``jax.tree_util.tree_map(np.asarray, params)`` (nested dicts and lists of
numpy arrays) and returns the same tree of torch tensors. Layouts are kept
as they are: the port's functions read the JAX layouts. bfloat16 arrays
(numpy's ``bfloat16`` extension dtype) are carried over bit for bit. The
tensors land on the card unless the caller asks for another device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_jax_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts / lists / tuples of numpy arrays -> the same of tensors."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_numpy(v, device) for v in tree)
    return _tensor(np.asarray(tree), device)
