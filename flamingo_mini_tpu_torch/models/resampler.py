"""PerceiverResampler, port of ``flamingo_mini_tpu/models/resampler.py``.

Latents cross-attend to ``concat(features, latents)``, q scaled by
``dim_head**-0.5`` before the product, max-subtracted softmax; ``depth`` x
(attention + FeedForward) with residuals, then a final LayerNorm. Input is
``(b, T, v, d)``: images are videos with T=1. Under a ``pallas`` policy the
attention is ``fused_attention`` on unscaled q with ``scale=dim_head**-0.5``.
With a model group (``policy.tp``) a rank computes its heads: to_q, to_k,
to_v and the FeedForward's fc1 column-parallel, to_out and fc2
row-parallel.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.attention import attend, merge_heads, split_heads
from ..ops.fused_attention import fused_attention
from ..ops.layers import (Policy, column_linear, const, feed_forward,
                          init_feed_forward, init_layer_norm, init_linear,
                          layer_norm, normal, row_linear)

Params = Dict[str, Any]


def init_resampler(gen: torch.Generator, *, dim: int, depth: int,
                   dim_head: int = 64, heads: int = 8, num_latents: int = 64,
                   num_time_embeds: int = 4, ff_mult: int = 4) -> Params:
    dev = gen.device
    inner = dim_head * heads
    p: Params = {
        "latents": normal(gen, (num_latents, dim)),
        "time_pos_emb": normal(gen, (num_time_embeds, 1, dim)),
        "layers": [],
        "norm": init_layer_norm(dim, dev),
    }
    for _ in range(depth):
        p["layers"].append({
            "attn": {
                "norm_media": init_layer_norm(dim, dev),
                "norm_latents": init_layer_norm(dim, dev),
                "to_q": init_linear(gen, dim, inner, bias=False),
                "to_k": init_linear(gen, dim, inner, bias=False),
                "to_v": init_linear(gen, dim, inner, bias=False),
                "to_out": init_linear(gen, inner, dim, bias=False),
            },
            "ffw": init_feed_forward(gen, dim, ff_mult),
        })
    return p


def apply_perceiver_attention(p: Params, features: torch.Tensor,
                              latents: torch.Tensor, *, heads: int,
                              dim_head: int, policy: Policy) -> torch.Tensor:
    """features (b, f, dim), latents (b, q, dim) -> (b, q, dim)."""
    tp, heads = policy.tp, policy.local_heads(heads)
    x = layer_norm(features, p["norm_media"])
    lat = layer_norm(latents, p["norm_latents"])
    q = split_heads(column_linear(lat, p["to_q"], tp), heads)
    kv_in = torch.cat([x, lat], dim=1)
    k = split_heads(column_linear(kv_in, p["to_k"], tp), heads)
    v = split_heads(column_linear(kv_in, p["to_v"], tp), heads)
    if policy.pallas:
        out = fused_attention(q, k, v, scale=dim_head ** -0.5)
    else:
        out = attend(q * const(dim_head ** -0.5, q.dtype), k, v, stabilize=True)
    return row_linear(merge_heads(out), p["to_out"], tp)


def apply_resampler(p: Params, x_f: torch.Tensor, *, heads: int,
                    dim_head: int, act: str, policy: Policy) -> torch.Tensor:
    """Compress ``(b, T, v, d)`` to ``(b, num_latents, d)``."""
    b, T, v, d = x_f.shape
    x_f = x_f + p["time_pos_emb"][:T].to(x_f.dtype)
    x_f = x_f.reshape(b, T * v, d)
    x = p["latents"].to(x_f.dtype).expand(b, *p["latents"].shape)
    for layer in p["layers"]:
        x = x + apply_perceiver_attention(layer["attn"], x_f, x, heads=heads,
                                          dim_head=dim_head, policy=policy)
        x = x + feed_forward(x, layer["ffw"], act, policy.tp)
    return layer_norm(x, p["norm"])
