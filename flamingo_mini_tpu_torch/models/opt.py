"""OPT decoder trunk with the T-major flat KV cache.

Port of ``flamingo_mini_tpu/models/opt.py`` for the greedy and lazy-beam
decode paths and the uncached forward. Gated cross-attention enters
through ``layer_hook`` before every layer.

Numerics follow HF ``OPTModel``'s eager attention, as the JAX package
does: scores ``QK^T * d_head**-0.5`` (the scale after the dot), one
additive causal + padding bias with float32 min where disallowed, float32
softmax. Learned positions with an offset of 2 (``POS_OFFSET``). The
activation is ReLU. Two layouts: pre-norm (``do_layer_norm_before``;
opt-125m, 1.3b, 2.7b, 6.7b) with a final LayerNorm, and post-norm with the
``project_in`` / ``project_out`` projections between the embedding width
and the hidden width (opt-350m).

Positions: the generate path passes them explicitly (``clip(cumsum(mask)
- 1, 0)``); without them they are ``opt_position_ids`` of the attention
mask, HF's ``cumsum(mask) * mask - 1``, so that a pad reads row 1 of the
offset table.

The caches, the cached attention and the tied head are GPT-2's
(``gpt2.make_cache``, ``gpt2.cached_attention``, ``gpt2.head_major_write``,
``gpt2.tied_head``): per layer ``{"kf", "vf"}``
views ``(T, b, D)`` of two stacked ``(n_layer, T, b, D)`` buffers, written
in place, which the whole-step megakernel reads as they are; or the
head-major ``(b, h, max_len, d_head)`` cache, bf16 or int8, whose steps
attend in plain ops under one additive causal + padding bias.

Training-mode dropout (``dropout_generator``) at HF's sites, rate
``arch.dropout``: the embeddings and both residual branches (OPT's
attention probabilities have none); as in the JAX package it forces the
plain attention path.

Tensor parallelism and ring attention as in ``gpt2``: with ``policy.tp``
q/k/v_proj and fc1 are column-parallel, out_proj and fc2 row-parallel, the
embedding and the tied head vocab-parallel (``project_in`` / ``project_out``
replicated); ``ring`` runs the uncached forward's self-attention over a
sequence split in chunks over that group.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..configuration_flamingo import OPTArch
from ..ops.attention import attend, attend_beam_lazy, merge_heads, split_heads
from ..ops.fused_attention import fused_attention
from ..ops.layers import (Policy, column_linear, dropout, get_activation,
                          init_layer_norm, init_linear, layer_norm, linear,
                          normal, row_linear)
from ..parallel.ring_attention import ring_attention
from .gpt2 import (F32_MIN, cached_attention, head_major_slots, head_major_write,
                   is_flat, make_cache, tied_head, token_embedding)

Params = Dict[str, Any]
LayerHook = Callable[[int, torch.Tensor], torch.Tensor]
Cache = List[Dict[str, torch.Tensor]]

POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding offset
EMBED, FINAL_LN = "embed_tokens", "final_ln"   # as gpt2.EMBED, gpt2.FINAL_LN


def init_opt(gen: torch.Generator, arch: OPTArch, extra_tokens: int = 1) -> Params:
    """Random-init trunk; ``extra_tokens`` adds embedding rows for ``<EOC>``."""
    d, w = arch.hidden_size, arch.word_embed_proj_dim
    dev = gen.device
    p: Params = {
        "embed_tokens": normal(gen, (arch.vocab_size + extra_tokens, w), 0.02),
        "embed_positions": normal(gen, (arch.max_position_embeddings + POS_OFFSET, d),
                                  0.02),
        "layers": [{
            "attn_ln": init_layer_norm(d, dev),
            "q_proj": init_linear(gen, d, d),
            "k_proj": init_linear(gen, d, d),
            "v_proj": init_linear(gen, d, d),
            "out_proj": init_linear(gen, d, d),
            "final_ln": init_layer_norm(d, dev),
            "fc1": init_linear(gen, d, arch.ffn_dim),
            "fc2": init_linear(gen, arch.ffn_dim, d),
        } for _ in range(arch.num_hidden_layers)],
    }
    if arch.do_layer_norm_before:
        p["final_ln"] = init_layer_norm(d, dev)
    if w != d:
        p["project_in"] = init_linear(gen, w, d, bias=False)
        p["project_out"] = init_linear(gen, d, w, bias=False)
    return p


def init_cache(arch: OPTArch, batch: int, max_len: int, dtype, device, *,
               int8: bool = False, flat: bool = True, shards: int = 1
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Cache]:
    """``gpt2.make_cache`` at the trunk's depth, heads and width."""
    return make_cache(arch.num_hidden_layers, arch.num_attention_heads,
                      arch.hidden_size, batch, max_len, dtype, device, int8=int8,
                      flat=flat, shards=shards)


def embed(p: Params, ids: torch.Tensor, pos: torch.Tensor, dtype,
          tp=None) -> torch.Tensor:
    """Token embedding (int8 ``embed_tokens_q`` where quantized), through
    ``project_in`` where the model has it, plus ``embed_positions[pos + 2]``."""
    x = token_embedding(p, EMBED, ids, dtype, tp)
    if "project_in" in p:
        x = linear(x, p["project_in"])
    return x + p["embed_positions"].to(dtype)[pos + POS_OFFSET]


def opt_position_ids(attention_mask: torch.Tensor) -> torch.Tensor:
    """HF OPT positions ``cumsum(mask) * mask - 1``: a pad gets -1, which
    reads row 1 of the offset table."""
    m = attention_mask.to(torch.int32)
    return torch.cumsum(m, dim=1) * m - 1


def _self_attention(bp: Params, h: torch.Tensor, *, n_head: int,
                    bias: Optional[torch.Tensor],
                    row_bias: Optional[torch.Tensor],
                    layer_cache: Optional[Dict[str, torch.Tensor]],
                    cache_index: Optional[int], kv_limit: Optional[int],
                    npad: Optional[torch.Tensor], policy: Policy,
                    beam_anc: Optional[torch.Tensor], training: bool,
                    ring=None, ring_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer's attention, ``n_head`` the rank's heads."""
    tp = policy.tp
    q, k, v = (column_linear(h, bp[name], tp) for name in ("q_proj", "k_proj", "v_proj"))
    scale = (q.shape[-1] // n_head) ** -0.5
    if layer_cache is not None and "kf" in layer_cache:
        out = cached_attention(q, k, v, layer_cache, cache_index, n_head=n_head,
                               scale=scale, kv_limit=kv_limit, npad=npad,
                               beam_anc=beam_anc)
        if out is not None:
            return row_linear(out, bp["out_proj"], tp)
    qh, kh, vh = (split_heads(t, n_head) for t in (q, k, v))
    if layer_cache is not None and "kf" not in layer_cache:
        # head-major: ``bias`` holds the causal and padding masks
        kh, vh = head_major_write(layer_cache, kh, vh, cache_index, kv_limit)
        if beam_anc is not None:
            out = attend_beam_lazy(qh, kh, vh, beam_anc, bias=bias, scale=scale)
        else:
            out = attend(qh, kh, vh, scale=scale, bias=bias)
    elif layer_cache is None and ring is not None:
        out = ring_attention(qh, kh, vh, group=ring, scale=scale,
                             attention_mask=ring_mask)
    elif layer_cache is None and policy.pallas and not training:
        out = fused_attention(qh, kh, vh, scale=scale, causal=True, row_bias=row_bias)
    else:
        # prefill (cache_index == 0) or uncached: attend over the fresh K/V
        out = attend(qh, kh, vh, scale=scale, bias=bias)
    return row_linear(merge_heads(out), bp["out_proj"], tp)


def apply_opt(
    p: Params,
    input_ids: torch.Tensor,                       # (b, n)
    *,
    arch: OPTArch,
    policy: Policy,
    attention_mask: Optional[torch.Tensor] = None,  # (b, n_kv) 1 = real token
    position_ids: Optional[torch.Tensor] = None,   # (b, n), before the offset
    layer_hook: Optional[LayerHook] = None,
    cache: Optional[Cache] = None,
    cache_index: Optional[int] = None,             # write offset
    kv_limit: Optional[int] = None,                # attend only cache[:kv_limit]
    beam_anc: Optional[torch.Tensor] = None,       # (b // kb, kb, max_len) int32
    dropout_generator: Optional[torch.Generator] = None,  # training mode when set
    ring=None,                                     # the sequence split over a group
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Run the trunk -> (hidden (b, n, word_embed_proj_dim), cache): after
    the final LayerNorm (pre-norm) and ``project_out`` (where the model has
    it).

    With a flat cache, K/V are written at ``cache_index``. A prompt (n > 1)
    must start at slot 0 and attends over itself; a single token (n == 1)
    attends over the cache slots ``npad <= t <= cache_index`` through
    ``decode_attention``, or with ``beam_anc`` through
    ``decode_attention_beam``; over a head-major cache through ``attend``
    or ``attend_beam_lazy`` (``gpt2.apply_gpt2``). With ``ring`` (uncached)
    the tokens, ``position_ids`` and ``attention_mask`` are this rank's
    chunk of a sequence split over that group."""
    b, n = input_ids.shape
    dev = input_ids.device
    flat = cache is not None and is_flat(cache)
    if flat and n > 1 and cache_index != 0:
        raise NotImplementedError("a multi-token step must start at slot 0")
    if attention_mask is None:
        n_full = n if cache is None else (cache[0]["kf"].shape[0] if flat
                                          else head_major_slots(cache, None))
        attention_mask = torch.ones((b, n_full), dtype=torch.int32, device=dev)
    if position_ids is None:
        position_ids = opt_position_ids(attention_mask)
        if cache is not None:
            position_ids = position_ids[:, cache_index:cache_index + n]

    tp = policy.tp
    x = dropout(embed(p, input_ids, position_ids, policy.dtype, tp), arch.dropout,
                dropout_generator)

    npad = bias = row_bias = None
    if flat and n == 1:
        npad = attention_mask.to(torch.int32).argmax(dim=-1).to(torch.int32)
    else:
        # one additive causal + padding bias, HF-style; over a head-major
        # cache every slot (up to kv_limit) against the absolute positions
        if cache is None or flat:
            n_kv = n
            causal = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
        else:
            n_kv = head_major_slots(cache, kv_limit)
            q_pos = cache_index + torch.arange(n, device=dev)
            causal = torch.arange(n_kv, device=dev)[None, :] <= q_pos[:, None]
        pad_ok = attention_mask[:, :n_kv].bool()
        bias = torch.where(causal[None, None] & pad_ok[:, None, None, :], 0.0,
                           F32_MIN).to(policy.dtype)
        # the kernels' (b, n) row bias: float32 as they read it, the dtype's
        # values (bf16: -inf), built once for every layer
        row_bias = torch.where(pad_ok, 0.0, F32_MIN).to(policy.dtype).float()

    n_head = policy.local_heads(arch.num_attention_heads)
    eps = arch.layer_norm_epsilon
    pre = arch.do_layer_norm_before
    act = get_activation(arch.activation)
    for i, bp in enumerate(p["layers"]):
        if layer_hook is not None:
            x = layer_hook(i, x)
        h = layer_norm(x, bp["attn_ln"], eps) if pre else x
        x = x + dropout(_self_attention(
            bp, h, n_head=n_head, bias=bias, row_bias=row_bias,
            layer_cache=None if cache is None else cache[i],
            cache_index=cache_index, kv_limit=kv_limit, npad=npad,
            policy=policy, beam_anc=beam_anc,
            training=dropout_generator is not None, ring=ring,
            ring_mask=attention_mask), arch.dropout, dropout_generator)
        if not pre:
            x = layer_norm(x, bp["attn_ln"], eps)
        h = layer_norm(x, bp["final_ln"], eps) if pre else x
        x = x + dropout(row_linear(act(column_linear(h, bp["fc1"], tp)), bp["fc2"], tp),
                        arch.dropout, dropout_generator)
        if not pre:
            x = layer_norm(x, bp["final_ln"], eps)
    if "final_ln" in p:
        x = layer_norm(x, p["final_ln"], eps)
    if "project_out" in p:
        x = linear(x, p["project_out"])
    return x, cache


def lm_head(p: Params, hidden: torch.Tensor,
            n_valid: Optional[int] = None, tp=None) -> torch.Tensor:
    """``gpt2.tied_head`` over ``embed_tokens``."""
    return tied_head(p.get(EMBED), p.get(EMBED + "_q"), hidden, n_valid, tp)
