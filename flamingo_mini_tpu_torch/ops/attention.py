"""Shared attention core, port of ``flamingo_mini_tpu/ops/attention.py``.

One ``attend`` serves the perceiver, the media-masked xattn, the GPT-2
prefill, the ViT and the decode steps over the head-major cache;
``attend_beam_lazy`` serves lazy beams over the head-major cache. It is written with plain ops on purpose: PyTorch's
fused scaled-dot-product attention scales, masks and rounds at other
places, and the parity tests hold this chain to the JAX one step by step
(scale after the QK product, dtype-aware finfo.min fill, float32 softmax,
alphas cast to the compute dtype before the V product).
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import const, dropout


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, n, h*d) -> (b, h, n, d)"""
    b, n, hd = x.shape
    return x.reshape(b, n, n_heads, hd // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, h, n, d) -> (b, n, h*d)"""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def softmax_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum, the max
    a constant to autograd as it is to JAX's gradient."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    stabilize: bool = False,
    dropout_rate: float = 0.0,
    dropout_generator: Optional[torch.Generator] = None,
    dropout_heads=None,
) -> torch.Tensor:
    """Scaled-dot-product attention core -> (..., n_q, d).

    ``mask``: boolean, False positions filled with finfo(dtype).min.
    ``bias``: additive float mask (HF convention, finfo.min where disallowed).
    ``scale``: multiplier applied to the scores after the QK product.
    ``stabilize``: subtract the rowwise max (a constant to autograd) before
    the softmax.
    ``dropout_rate``, ``dropout_generator``: dropout on the attention
    probabilities (training; ``layers.dropout``); ``dropout_heads``: the
    heads are a model-parallel rank's, (rank, size) (``layers.rand``).
    """
    dtype = q.dtype
    sim = torch.matmul(q, k.transpose(-1, -2))
    if scale is not None:
        sim = sim * const(scale, sim.dtype)
    if mask is not None or bias is not None:
        neg = const(torch.finfo(dtype).min, sim.dtype)
        if mask is not None:
            sim = torch.where(mask, sim, neg)
        if bias is not None:
            sim = sim + bias.to(dtype)
        sim = sim.clamp(min=neg)
    if stabilize:
        sim = sim - sim.amax(dim=-1, keepdim=True).detach()
    alphas = softmax_f32(sim.float()).to(dtype)
    alphas = dropout(alphas, dropout_rate, dropout_generator, dropout_heads)
    return torch.matmul(alphas, v)


def attend_beam_lazy(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     anc: torch.Tensor, *, causal: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One decode token's attention over an unpermuted head-major beam
    cache (the lazy reorder) -> (b*kb, h, 1, d).

    Logical beam i of a family attends over all kb physical rows j of it;
    the entry (j, t) counts where ``anc[b, i, t] == j``, the row that owns
    position t for beam i. Scores and the joint softmax over (j, t) are
    float32; the probabilities are cast to q's dtype before the V product,
    whose float32 sums are added in the JAX function's order (offset o =
    (i - j) mod kb, o = 0 first).

    q: (b*kb, h, 1, d); k, v: (b*kb, h, T, d), possibly kv_limit-sliced;
    anc: (b, kb, >= T) int32; causal: bool broadcastable to (T,); bias:
    additive (b*kb, 1, 1, T); scale: applied to the scores after the
    product."""
    dtype = q.dtype
    bk, h, _, d = q.shape
    T = k.shape[2]
    b, kb = anc.shape[0], anc.shape[1]
    if b * kb != bk:
        raise ValueError(f"attend_beam_lazy: {b} families of {kb} beams do not "
                         f"tile {bk} rows")
    qr = q.reshape(b, kb, h, d).float()
    # sim[b, i, h, j, t]: logical beam i's query against physical row j
    sim = torch.einsum("bihd,bjhtd->bihjt", qr, k.reshape(b, kb, h, T, d).float())
    if scale is not None:
        sim = sim * torch.tensor(scale, dtype=torch.float32)
    ar = torch.arange(kb, device=q.device)
    valid = anc[:, :, :T][:, :, None, :] == ar[None, None, :, None]   # (b, i, j, t)
    mask = valid[:, :, None]                                           # (b, i, 1, j, t)
    if causal is not None:
        mask = mask & causal.reshape(causal.shape[-1:])
    neg = torch.finfo(torch.float32).min
    sim = torch.where(mask, sim, neg)
    if bias is not None:
        sim = sim + bias.float().reshape(b, kb, 1, 1, T)
    sim = sim.clamp(min=neg)
    p = torch.exp(sim - sim.amax(dim=(3, 4), keepdim=True))
    p = torch.where(mask, p, 0.0)
    al = p / p.sum(dim=(3, 4), keepdim=True).clamp(min=1e-30)
    # parts[b, i, j, h, d]: row j's share of logical beam i's output
    parts = torch.einsum("bihjt,bjhtd->bijhd", al.to(dtype).float(),
                         v.reshape(b, kb, h, T, d).float())
    out = torch.zeros((b, kb, h, d), dtype=torch.float32, device=q.device)
    for o in range(kb):
        out = out + parts[:, ar, (ar - o) % kb]
    return out.to(dtype).reshape(bk, h, d)[:, :, None, :]
