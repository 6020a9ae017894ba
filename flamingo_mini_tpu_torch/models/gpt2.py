"""GPT-2 decoder trunk with the T-major flat KV cache.

Port of ``flamingo_mini_tpu/models/gpt2.py`` for the greedy and lazy-beam
decode paths and the uncached forward.
Gated cross-attention enters through ``layer_hook`` before every block.
Attention follows HF GPT-2 eager numerics: QK product, divide by
sqrt(d_head), causal fill with finfo.min, additive padding bias, softmax.
Under a ``pallas`` policy the uncached forward's attention is
``fused_attention`` (causal in the kernel, the padding bias as its per-row
``row_bias``); a prefill that writes the cache stays on ``attend``, as in
the JAX package. Training-mode dropout (``dropout_generator``) at HF's
sites and rates: the embeddings (``embd_pdrop``), the attention
probabilities (``attn_pdrop``) and both residual branches
(``resid_pdrop``); as in the JAX package it forces the plain attention
path, so a forward with dropout launches no ``fused_attention``.

Two cache layouts, as in the JAX package. The flat one: per layer
``{"kf", "vf"}`` of shape ``(T, b, D)`` with T the max length rounded up to
a multiple of 64, so that a decode step's write is one contiguous ``(b, D)``
slab and the decode-attention kernel streams the live prefix contiguously;
the layers' caches are views of two stacked ``(n_layer, T, b, D)`` buffers,
which the whole-step megakernel reads as they are. The head-major one
(``flat=False``): per layer ``{"k", "v"}`` of shape ``(b, h, max_len,
d_head)``, or with ``int8`` ``{"k8", "v8"}`` int8 and their per-position
bf16 scales ``{"ks", "vs"}`` ``(b, h, max_len, 1)``; a step attends the
whole buffer (or its first ``kv_limit`` slots) in plain ops under a causal
mask and the padding bias, lazy beams through ``attend_beam_lazy``. Unlike
the JAX package, the port writes either cache in place: no copy per step,
and no stacking copy after prefill.

With a model group (``policy.tp``) a rank computes its heads: ``c_attn``
(its head-aligned ``[q_r | k_r | v_r]``) and ``mlp_fc`` column-parallel,
``c_proj`` and ``mlp_proj`` row-parallel; its cache holds its heads
(``init_cache(shards=...)``); the embedding looks up the rank's vocab rows
and sums over the group, and the tied head computes the rank's vocab
columns and gathers them. With ``ring`` (a process group) the uncached
forward's tokens are the rank's chunk of a sequence split over it, and the
self-attention is ``parallel.ring_attention``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..configuration_flamingo import GPT2Arch
from ..ops.attention import attend, attend_beam_lazy, merge_heads, split_heads
from ..ops.decode_attention import decode_attention, decode_attention_beam
from ..ops.fused_attention import fused_attention
from ..ops.layers import (Policy, column_linear, dot, dropout, get_activation,
                          init_layer_norm, init_linear, layer_norm, normal,
                          row_linear)
from ..ops.quant import dequantize_kv, embed_lookup, quantize_kv_write
from ..parallel import comm
from ..parallel.ring_attention import ring_attention

Params = Dict[str, Any]
LayerHook = Callable[[int, torch.Tensor], torch.Tensor]
Cache = List[Dict[str, torch.Tensor]]

F32_MIN = float(torch.finfo(torch.float32).min)
EMBED, FINAL_LN = "wte", "ln_f"   # the tied embedding's and the final LayerNorm's keys


def init_gpt2(gen: torch.Generator, arch: GPT2Arch,
              extra_tokens: int = 1) -> Params:
    """Random-init trunk; ``extra_tokens`` adds wte rows for ``<EOC>``."""
    d = arch.n_embd
    dev = gen.device
    p: Params = {
        "wte": normal(gen, (arch.vocab_size + extra_tokens, d), 0.02),
        "wpe": normal(gen, (arch.n_positions, d), 0.01),
        "blocks": [],
        "ln_f": init_layer_norm(d, dev),
    }
    for _ in range(arch.n_layer):
        p["blocks"].append({
            "ln_1": init_layer_norm(d, dev),
            "c_attn": init_linear(gen, d, 3 * d),
            "c_proj": init_linear(gen, d, d),
            "ln_2": init_layer_norm(d, dev),
            "mlp_fc": init_linear(gen, d, 4 * d),
            "mlp_proj": init_linear(gen, 4 * d, d),
        })
    return p


def cache_len(max_len: int) -> int:
    """The flat cache's slot count T: max_len rounded up to a multiple of 64."""
    return -(-max_len // 64) * 64


def flat_cache(n_layer: int, width: int, batch: int, max_len: int, dtype,
               device) -> Tuple[torch.Tensor, torch.Tensor, Cache]:
    """Zeroed flat T-major caches, T = ``cache_len(max_len)``: the stacked K
    and V buffers ``(n_layer, T, batch, width)`` and the per-layer
    ``{"kf", "vf"}`` views of them (no copy)."""
    shape = (n_layer, cache_len(max_len), batch, width)
    kc = torch.zeros(shape, dtype=dtype, device=device)
    vc = torch.zeros(shape, dtype=dtype, device=device)
    return kc, vc, [{"kf": kc[i], "vf": vc[i]} for i in range(n_layer)]


def make_cache(n_layer: int, n_head: int, width: int, batch: int, max_len: int,
               dtype, device, *, int8: bool = False, flat: bool = True,
               shards: int = 1
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Cache]:
    """A trunk's zeroed caches -> (K stack, V stack, per-layer caches): the
    ``flat_cache``, or with ``flat=False`` the head-major one, per layer
    ``{"k", "v"}`` of shape ``(batch, n_head, max_len, width / n_head)`` in
    ``dtype``, with ``int8`` the int8 ``{"k8", "v8"}`` and their bf16
    scales ``{"ks", "vs"}`` ``(batch, n_head, max_len, 1)`` (stacks None).
    ``shards``: a tensor-parallel rank's cache, its ``n_head / shards``
    heads."""
    n_head, width = n_head // shards, width // shards
    if flat:
        if int8:
            raise ValueError("the flat cache holds bf16 or float32 K/V, not int8")
        return flat_cache(n_layer, width, batch, max_len, dtype, device)
    shape = (batch, n_head, max_len, width // n_head)
    zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
    if int8:
        layer = lambda: {"k8": zeros(shape, torch.int8), "v8": zeros(shape, torch.int8),
                         "ks": zeros(shape[:-1] + (1,), torch.bfloat16),
                         "vs": zeros(shape[:-1] + (1,), torch.bfloat16)}
    else:
        layer = lambda: {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}
    return None, None, [layer() for _ in range(n_layer)]


def init_cache(arch: GPT2Arch, batch: int, max_len: int, dtype, device, *,
               int8: bool = False, flat: bool = True, shards: int = 1
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Cache]:
    """``make_cache`` at the trunk's depth, heads and width."""
    return make_cache(arch.n_layer, arch.n_head, arch.n_embd, batch, max_len, dtype,
                      device, int8=int8, flat=flat, shards=shards)


def is_flat(cache: Cache) -> bool:
    """True for the flat T-major cache, False for the head-major one."""
    return "kf" in cache[0]


def head_major_slots(cache: Cache, kv_limit: Optional[int]) -> int:
    """The slots a head-major cache's step attends: all, or ``kv_limit``."""
    buf = cache[0]["k8" if "k8" in cache[0] else "k"]
    return buf.shape[2] if kv_limit is None else kv_limit


def head_major_write(layer_cache: Dict[str, torch.Tensor], k: torch.Tensor,
                     v: torch.Tensor, cache_index: int, kv_limit: Optional[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k, v (b, h, n, d) into a head-major layer cache at
    ``cache_index`` (the int8 codes and scales where the cache is int8) ->
    the cache's K and V over its first ``kv_limit`` slots (all without),
    dequantized into k's dtype."""
    at = slice(cache_index, cache_index + k.shape[2])
    lim = slice(None) if kv_limit is None else slice(0, kv_limit)
    if "k8" not in layer_cache:
        layer_cache["k"][:, :, at] = k
        layer_cache["v"][:, :, at] = v
        return layer_cache["k"][:, :, lim], layer_cache["v"][:, :, lim]
    out = []
    for name, x in (("k", k), ("v", v)):
        x8, s = quantize_kv_write(x)
        layer_cache[name + "8"][:, :, at] = x8
        layer_cache[name + "s"][:, :, at] = s
        out.append(dequantize_kv(layer_cache[name + "8"][:, :, lim],
                                 layer_cache[name + "s"][:, :, lim], k.dtype))
    return out[0], out[1]


def token_embedding(p: Params, key: str, ids: torch.Tensor, dtype,
                    tp=None) -> torch.Tensor:
    """The rows of embedding ``key`` (its int8 ``key + "_q"`` where
    quantized) for ``ids``. Over the model group ``tp`` the table is the
    rank's block of rows: ids outside it give 0, and the group's sum (exact:
    one rank holds each row) is the lookup."""
    if key + "_q" in p:
        rows = p[key + "_q"]["w8"].shape[0]
        lookup = lambda i: embed_lookup(p[key + "_q"], i, dtype)
    else:
        rows = p[key].shape[0]
        lookup = lambda i: p[key].to(dtype)[i]
    if tp is None:
        return lookup(ids)
    local = ids - comm.rank(tp) * rows
    inside = ((local >= 0) & (local < rows))[..., None]
    emb = lookup(local.clamp(0, rows - 1)).masked_fill(~inside, 0)
    return comm.reduce_from_model_parallel(emb.float(), tp).to(dtype)


def embed(p: Params, ids: torch.Tensor, pos: torch.Tensor, dtype,
          tp=None) -> torch.Tensor:
    """Token embedding (int8 ``wte_q`` where quantized) plus ``wpe[pos]``."""
    return token_embedding(p, EMBED, ids, dtype, tp) + p["wpe"].to(dtype)[pos]


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     layer_cache: Dict[str, torch.Tensor], cache_index: int, *,
                     n_head: int, scale: float, kv_limit: Optional[int],
                     npad: Optional[torch.Tensor],
                     beam_anc: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Write k, v (b, n, D) into the layer's cache at ``cache_index``. A
    single token (n == 1) then attends over the cache through
    ``decode_attention`` (``decode_attention_beam`` with ``beam_anc``) ->
    (b, 1, D) before the output projection; a prompt -> None (the caller
    attends over the fresh K/V)."""
    n = q.shape[1]
    layer_cache["kf"][cache_index:cache_index + n] = k.transpose(0, 1)
    layer_cache["vf"][cache_index:cache_index + n] = v.transpose(0, 1)
    if n != 1:
        return None
    if beam_anc is None:
        out2d = decode_attention(
            q[:, 0].contiguous(), layer_cache["kf"], layer_cache["vf"],
            npad, cache_index, n_head=n_head, scale=scale, kv_limit=kv_limit)
    else:
        out2d = decode_attention_beam(
            q[:, 0].contiguous(), layer_cache["kf"], layer_cache["vf"],
            beam_anc, npad, cache_index, n_head=n_head, scale=scale,
            kb=beam_anc.shape[1], kv_limit=kv_limit)
    return out2d[:, None, :]


def _self_attention(bp: Params, x: torch.Tensor, *, n_head: int,
                    causal_mask: Optional[torch.Tensor],
                    pad_bias: Optional[torch.Tensor],
                    row_bias: Optional[torch.Tensor],
                    layer_cache: Optional[Dict[str, torch.Tensor]],
                    cache_index: Optional[int], eps: float,
                    kv_limit: Optional[int],
                    npad: Optional[torch.Tensor], policy: Policy,
                    beam_anc: Optional[torch.Tensor] = None,
                    attn_pdrop: float = 0.0,
                    dropout_generator: Optional[torch.Generator] = None,
                    ring=None, ring_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The block's attention half, ``n_head`` the rank's heads."""
    tp = policy.tp
    h = layer_norm(x, bp["ln_1"], eps)
    qkv = column_linear(h, bp["c_attn"], tp)
    d_model = qkv.shape[-1] // 3
    q, k, v = qkv.split(d_model, dim=-1)
    scale = 1.0 / ((d_model // n_head) ** 0.5)
    if layer_cache is not None and "kf" in layer_cache:
        out = cached_attention(q, k, v, layer_cache, cache_index, n_head=n_head,
                               scale=scale, kv_limit=kv_limit, npad=npad,
                               beam_anc=beam_anc)
        if out is not None:
            return row_linear(out, bp["c_proj"], tp)
    qh, kh, vh = (split_heads(t, n_head) for t in (q, k, v))
    if layer_cache is not None and "kf" not in layer_cache:
        # head-major: attend the cache's slots under the causal mask and
        # the padding bias (the prompt's too); lazy beams through ancestry
        kh, vh = head_major_write(layer_cache, kh, vh, cache_index, kv_limit)
        if beam_anc is not None:
            out = attend_beam_lazy(qh, kh, vh, beam_anc, causal=causal_mask,
                                   bias=pad_bias, scale=scale)
        else:
            out = attend(qh, kh, vh, scale=scale, mask=causal_mask, bias=pad_bias)
    elif layer_cache is None and ring is not None:
        out = ring_attention(qh, kh, vh, group=ring, scale=scale,
                             attention_mask=ring_mask)
    elif layer_cache is None and policy.pallas and dropout_generator is None:
        out = fused_attention(qh, kh, vh, scale=scale, causal=True, row_bias=row_bias)
    else:
        # prefill (cache_index == 0) or uncached: attend over the fresh K/V
        out = attend(qh, kh, vh, scale=scale, mask=causal_mask, bias=pad_bias,
                     dropout_rate=attn_pdrop, dropout_generator=dropout_generator,
                     dropout_heads=policy.tp_heads)
    return row_linear(merge_heads(out), bp["c_proj"], tp)


def apply_gpt2(
    p: Params,
    input_ids: torch.Tensor,                       # (b, n)
    *,
    arch: GPT2Arch,
    policy: Policy,
    position_ids: Optional[torch.Tensor] = None,   # (b, n)
    attention_mask: Optional[torch.Tensor] = None,  # (b, n_kv) 1 = real token
    layer_hook: Optional[LayerHook] = None,
    cache: Optional[Cache] = None,
    cache_index: Optional[int] = None,             # write offset
    kv_limit: Optional[int] = None,                # attend only cache[:kv_limit]
    beam_anc: Optional[torch.Tensor] = None,       # (b // kb, kb, max_len) int32
    dropout_generator: Optional[torch.Generator] = None,  # training mode when set
    ring=None,                                     # the sequence split over a group
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Run the trunk -> (final-LN hidden (b, n, d), cache).

    With a flat cache, K/V are written at ``cache_index``. A prompt (n > 1)
    must start at slot 0 and attends over itself; a single token (n == 1)
    attends over the cache slots ``npad <= t <= cache_index`` through
    ``decode_attention``, npad being each row's first real slot
    (left-padded prompts); with ``beam_anc`` (lazy beam search: rows in
    families of kb whose cache rows never move) through
    ``decode_attention_beam``, which reads each slot from the row the
    ancestry table names. With a head-major cache, the tokens attend the
    buffer's slots (the first ``kv_limit``) under the causal mask of their
    absolute positions and the padding bias, as the JAX package does;
    ``beam_anc`` through ``attend_beam_lazy``. With ``ring`` (uncached) the
    tokens, ``position_ids`` and ``attention_mask`` are this rank's chunk
    of a sequence split over that group, attended by ring attention.
    """
    b, n = input_ids.shape
    if position_ids is None:
        position_ids = torch.arange(n, device=input_ids.device)[None, :] \
            + (cache_index or 0)
    tp = policy.tp
    x = dropout(embed(p, input_ids, position_ids, policy.dtype, tp), arch.embd_pdrop,
                dropout_generator)

    npad = causal = pad_bias = row_bias = None
    flat = cache is not None and is_flat(cache)
    if flat and n == 1:
        npad = (attention_mask.to(torch.int32).argmax(dim=-1).to(torch.int32)
                if attention_mask is not None
                else torch.zeros(b, dtype=torch.int32, device=x.device))
    else:
        if flat and cache_index != 0:
            raise NotImplementedError("a multi-token step must start at slot 0")
        if cache is None or flat:
            n_kv = n
            causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        else:
            # head-major: every slot of the buffer (up to kv_limit) against
            # the queries' absolute positions
            n_kv = head_major_slots(cache, kv_limit)
            q_pos = cache_index + torch.arange(n, device=x.device)
            causal = torch.arange(n_kv, device=x.device)[None, :] <= q_pos[:, None]
        causal = causal[None, None]
        if attention_mask is not None:
            am = attention_mask[:, :n_kv]
            pad_bias = torch.where(am[:, None, None, :].bool(), 0.0,
                                   F32_MIN).to(policy.dtype)
            # the kernels' (b, n) row bias: float32 as they read it, the
            # dtype's values (bf16: -inf), built once for every layer
            row_bias = pad_bias[:, 0, 0, :].float()

    act = get_activation(arch.activation)
    eps = arch.layer_norm_epsilon
    for i, bp in enumerate(p["blocks"]):
        if layer_hook is not None:
            x = layer_hook(i, x)
        x = x + dropout(_self_attention(
            bp, x, n_head=policy.local_heads(arch.n_head), causal_mask=causal,
            pad_bias=pad_bias,
            row_bias=row_bias,
            layer_cache=None if cache is None else cache[i],
            cache_index=cache_index, eps=eps, kv_limit=kv_limit, npad=npad,
            policy=policy, beam_anc=beam_anc, attn_pdrop=arch.attn_pdrop,
            dropout_generator=dropout_generator, ring=ring,
            ring_mask=attention_mask), arch.resid_pdrop, dropout_generator)
        h = layer_norm(x, bp["ln_2"], eps)
        h = row_linear(act(column_linear(h, bp["mlp_fc"], tp)), bp["mlp_proj"], tp)
        x = x + dropout(h, arch.resid_pdrop, dropout_generator)
    return layer_norm(x, p["ln_f"], eps), cache


def tied_head(emb: torch.Tensor, emb_q: Optional[Params], hidden: torch.Tensor,
              n_valid: Optional[int] = None, tp=None) -> torch.Tensor:
    """Tied lm_head: logits = hidden @ emb^T (the int8 ``emb_q`` where
    given), in hidden's dtype; columns >= n_valid (padded vocab rows) are
    masked to finfo.min. Over the model group ``tp`` the table is the rank's
    block of (padded) vocab rows: the rank's logits are gathered over the
    group and the padded columns past ``n_valid`` dropped, so the logits
    have the one-device width (JAX keeps them, masked: the same softmax and
    argmax; the width keeps a sampling draw the one device's)."""
    if tp is not None:
        hidden = comm.copy_to_model_parallel(hidden, tp)
    if emb_q is not None:
        logits = torch.matmul(hidden.float(), emb_q["w8"].float().t())
        logits = (logits * emb_q["scale"]).to(hidden.dtype)
    else:
        logits = dot(hidden, emb.t())
    if tp is not None:
        logits = comm.gather_from_model_parallel(logits, tp, dim=-1)
        return logits if n_valid is None else logits[..., :n_valid]
    return _mask_pad_vocab(logits, n_valid)


def lm_head(p: Params, hidden: torch.Tensor,
            n_valid: Optional[int] = None, tp=None) -> torch.Tensor:
    """``tied_head`` over ``wte``."""
    return tied_head(p.get(EMBED), p.get(EMBED + "_q"), hidden, n_valid, tp)


def _mask_pad_vocab(logits: torch.Tensor, n_valid: Optional[int]) -> torch.Tensor:
    if n_valid is None or logits.shape[-1] <= n_valid:
        return logits
    cols = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(cols >= n_valid, torch.finfo(logits.dtype).min)
