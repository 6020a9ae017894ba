"""Exact blockwise top-k for wide rows, port of ``flamingo_mini_tpu/ops/topk.py``.

The row is split into blocks; each block's top k survive (small sorts over
the block axis), then a final top k over the ``n_blocks * k`` survivors.
An element of the global top k is in its block's top k, so the result is
exact. Ties go to the lower index, as ``lax.top_k``'s do: every sort is
stable and the survivors stay block-major, each block's in its own order.

No decode path uses it: beams take ``top_k``, one stable sort over the
flattened (beams x V) row, as the JAX package keeps ``lax.top_k`` there.
It is for rows wide enough that the row-wide sort is the bound.
"""
from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: descending, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def exact_topk(x: torch.Tensor, k: int, block: int = 8192):
    """Top k over the last axis of a 2-D ``x`` (batch, n) -> (values,
    int64 indices), identical to one stable top k over the whole row. Rows
    of at most ``2 * block`` and ``k > block`` take the plain top k."""
    b, n = x.shape
    if n <= 2 * block or k > block:
        return top_k(x, k)
    n_blocks = -(-n // block)
    pad = n_blocks * block - n
    if pad:
        fill = (float("-inf") if x.dtype.is_floating_point
                else torch.iinfo(x.dtype).min)
        x = torch.cat([x, torch.full((b, pad), fill, dtype=x.dtype,
                                     device=x.device)], dim=1)
    v, i = top_k(x.reshape(b, n_blocks, block), k)    # (b, n_blocks, k)
    base = (torch.arange(n_blocks, device=x.device) * block)[None, :, None]
    gi = (i + base).reshape(b, n_blocks * k)
    fv, fi = top_k(v.reshape(b, n_blocks * k), k)
    return fv, gi.gather(1, fi)
