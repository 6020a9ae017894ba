"""Media-masked gated cross-attention, port of ``flamingo_mini_tpu/models/xattn.py``.

* ``text_time = media_locations.cumsum(-1)``; a text token attends the
  ``n_visual`` latents of image j iff ``text_time == j + 1`` (the ``==`` mask
  of the reference: only the most recent preceding image).
* masked scores are filled with ``finfo(dtype).min``, the softmax is
  max-subtracted, and tokens with ``text_time == 0`` get zero alphas.
* gating: ``y += tanh(alpha_attn) * attn(y); y += tanh(alpha_ffw) * ffw(y)``,
  both alphas 0 at init (identity).
* under a ``pallas`` policy, more than one token (prefill, the uncached
  forward) goes through ``fused_media_xattn``, which fills with float32
  min on float32 scores as the TPU kernel does; q is pre-scaled in the
  compute dtype as on the plain path, and the kernel's scale is 1.

The visual K/V are computed once per sequence (``compute_visual_kv``) and
passed to every call, as the (k, v) pair or, under the int8 KV cache, its
int8 form ``{"k8", "ks", "v8", "vs"}`` (``ops.quant.quantize_kv_pair``),
dequantized into the text's dtype at each call.

With a model group (``policy.tp``; ``tp`` for ``compute_visual_kv``) a
rank computes its heads: to_q, to_kv (its ``[k_r | v_r]`` slice, see
``parallel/sharding.py``) and fc1 column-parallel, to_out and fc2
row-parallel; ``heads`` is always the model's count.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..ops.attention import merge_heads, softmax_f32, split_heads
from ..ops.layers import (Policy, column_linear, const, feed_forward,
                          init_feed_forward, init_layer_norm, init_linear,
                          layer_norm, row_linear)
from ..parallel import comm
from ..ops.media_xattn import fused_media_xattn
from ..ops.quant import dequantize_kv

Params = Dict[str, Any]
KV = Tuple[torch.Tensor, torch.Tensor]  # each (b, h, n_media*n_visual, d)


def init_gated_xattn_block(gen: torch.Generator, *, dim: int, dim_visual: int,
                           dim_head: int, heads: int, ff_mult: int) -> Params:
    inner = dim_head * heads
    return {
        "attn": {
            "norm": init_layer_norm(dim, gen.device),
            "to_q": init_linear(gen, dim, inner, bias=False),
            "to_kv": init_linear(gen, dim_visual, inner * 2, bias=False),
            "to_out": init_linear(gen, inner, dim, bias=False),
        },
        "alpha_attn": torch.zeros(1, device=gen.device),
        "ffw": init_feed_forward(gen, dim, ff_mult),
        "alpha_ffw": torch.zeros(1, device=gen.device),
    }


def compute_visual_kv(p: Params, visual_features: torch.Tensor, *,
                      heads: int, tp=None) -> KV:
    """(b, n_media, n_visual, d_visual) -> per-head K, V (the rank's heads
    over the model group ``tp``)."""
    b, n_media, n_visual, d = visual_features.shape
    kv = column_linear(visual_features.reshape(b, n_media * n_visual, d),
                       p["to_kv"], tp)
    k, v = kv.chunk(2, dim=-1)
    heads //= comm.size(tp) if tp is not None else 1
    return split_heads(k, heads), split_heads(v, heads)


def apply_masked_xattn(p: Params, y: torch.Tensor, kv: KV,
                       text_time: torch.Tensor, *, n_visual: int, heads: int,
                       dim_head: int, policy: Policy) -> torch.Tensor:
    """y (b, n_token, dim), text_time (b, n_token) -> (b, n_token, dim);
    ``kv`` the (k, v) pair or its int8 dict."""
    if isinstance(kv, dict):
        k = dequantize_kv(kv["k8"], kv["ks"], y.dtype)
        v = dequantize_kv(kv["v8"], kv["vs"], y.dtype)
    else:
        k, v = kv
    n_media = k.shape[2] // n_visual
    tp = policy.tp
    y_n = layer_norm(y, p["norm"])
    q = column_linear(y_n, p["to_q"], tp)
    q = q * const(dim_head ** -0.5, q.dtype)
    q = split_heads(q, policy.local_heads(heads))
    if policy.pallas and y.shape[1] > 1:
        out = fused_media_xattn(q, k, v, text_time, scale=1.0, n_visual=n_visual)
        return row_linear(merge_heads(out), p["to_out"], tp)

    media_time = torch.arange(1, n_media + 1, dtype=text_time.dtype,
                              device=text_time.device).repeat_interleave(n_visual)
    mask = text_time[:, None, :, None] == media_time[None, None, None, :]

    sim = torch.matmul(q, k.transpose(-1, -2))
    sim = torch.where(mask, sim, const(torch.finfo(q.dtype).min, q.dtype))
    sim = sim - sim.amax(dim=-1, keepdim=True).detach()
    alphas = softmax_f32(sim.float()).to(q.dtype)
    no_media = (text_time == 0)[:, None, :, None]
    alphas = alphas.masked_fill(no_media, 0)
    out = torch.matmul(alphas, v)
    return row_linear(merge_heads(out), p["to_out"], tp)


def apply_gated_xattn_block(p: Params, y: torch.Tensor, kv: KV,
                            text_time: torch.Tensor, *, n_visual: int,
                            heads: int, dim_head: int, act: str,
                            policy: Policy) -> torch.Tensor:
    """tanh-gated residual xattn + tanh-gated residual FFW."""
    attn_out = apply_masked_xattn(p["attn"], y, kv, text_time,
                                  n_visual=n_visual, heads=heads,
                                  dim_head=dim_head, policy=policy)
    y = y + torch.tanh(p["alpha_attn"]).to(y.dtype) * attn_out
    y = y + torch.tanh(p["alpha_ffw"]).to(y.dtype) * feed_forward(
        y, p["ffw"], act, policy.tp)
    return y
