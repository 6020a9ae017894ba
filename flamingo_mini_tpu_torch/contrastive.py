"""Contrastive search (the degeneration penalty), port of
``flamingo_mini_tpu/contrastive.py``.

Each step takes the ``top_k`` most probable tokens under the processed
step distribution, penalises each by its largest cosine similarity to the
trunk's output at every earlier position (the prompt's pads included), and
emits

    score = (1 - alpha) * p(candidate) - alpha * max_t cos(h_candidate, h_t)

(Su et al., 2022, as the JAX package follows HF's loop: the candidates'
probabilities from the processed logits, the next candidates from the
winner's logits of the same forward, no extra model call).

The head-major cache, the xattn K/V, the mask, ``pos_next`` and the media
count are tiled to ``b * top_k`` rows once and never gathered: each
step's candidates write position ``cur`` into their own rows, and a (b,
max_length) table of the row that owns each position, broadcast over the
candidates with each one's own row at ``cur``, is the lazy ancestry the
attention reads (``ops.attention.attend_beam_lazy``). The history of
hidden states is a (b, max_length, D) buffer in the policy's dtype. Per
layer in plain torch, as JAX runs it in plain XLA; the megakernel refuses
this search.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .beam_search import _tile_beams, _tile_leaves
from .configuration_flamingo import FlamingoConfig
from .generation import DecodeConfig, _prefill, _softmax, _stop, process_logits
from .models import flamingo
from .ops.layers import Policy
from .ops.topk import top_k as _top_k

Params = Dict[str, Any]


def _unit(x: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, 1e-12) over the last axis, in float32."""
    x = x.float()
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True)).clamp(min=1e-12)


def contrastive_generate(params: Params, config: FlamingoConfig,
                         dc: DecodeConfig, policy: Policy, input_ids,
                         media_locations, attention_mask, visual_features=None,
                         pixel_values=None) -> torch.Tensor:
    """Contrastive search -> token ids (b, max_length) int64: prompt,
    generated tokens (EOS kept), pads after it."""
    if pixel_values is not None:
        visual_features = flamingo.encode_resample_visuals(
            params, config, policy.cast(pixel_values), policy=policy)
    b, L = input_ids.shape
    k, alpha, max_len = dc.top_k, dc.penalty_alpha, dc.max_length
    M = _stop(dc, L)
    dev = input_ids.device
    next_logits, xattn_kv, st = _prefill(
        params, config, dc, policy, input_ids, media_locations, attention_mask,
        visual_features, flat=False, with_hidden=True)
    D = st["prompt_hidden"].shape[-1]
    hist = torch.zeros((b, max_len, D), dtype=policy.dtype, device=dev)
    hist[:, :L] = st["prompt_hidden"].to(policy.dtype)

    # candidate rows: tiled once, never gathered
    cache = [_tile_leaves(layer, k) for layer in st["cache"]]
    xattn_kv = {key: _tile_leaves(kv, k) for key, kv in xattn_kv.items()}
    maskk = _tile_beams(st["mask"], k)                  # (b*k, max_len)
    pos_next = _tile_beams(st["pos_next"], k)
    hook = flamingo.make_layer_hook(params, config, xattn_kv,
                                    _tile_beams(st["media_count"], k),
                                    policy=policy)
    tokens, mask1 = st["tokens"], st["mask"]
    anc = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
    own_row = torch.arange(k, dtype=torch.int32, device=dev)
    seen = torch.arange(max_len, device=dev)

    # the first candidates: processors -> softmax -> top k
    lp = process_logits(next_logits, dc, tokens, mask1, L, L)
    cand_p, cand_tok = _top_k(_softmax(lp), k)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    cur = L
    while cur < M and not bool(finished.all()):
        # every candidate's forward at position cur
        maskk[:, cur] = 1
        anc_full = anc[:, None, :].expand(b, k, max_len).clone()
        anc_full[:, :, cur] = own_row
        logits, _, hidden = flamingo.apply_lm(
            params, config, cand_tok.reshape(b * k, 1), policy=policy,
            layer_hook=hook, attention_mask=maskk,
            position_ids=pos_next + (cur - L), cache=cache, cache_index=cur,
            beam_anc=anc_full)
        h_cand = hidden[:, -1].reshape(b, k, D)

        # the penalty: the largest cosine against every position < cur
        cos = torch.matmul(_unit(h_cand), _unit(hist).transpose(1, 2))
        pen = torch.where(seen < cur, cos, -1.0).amax(dim=-1)   # (b, k)
        score = (1.0 - alpha) * cand_p - alpha * pen
        c = score.argmax(dim=-1)                                  # first max

        tok = cand_tok.gather(1, c[:, None])[:, 0]
        tok = tok.masked_fill(finished, dc.pad_token_id)
        tokens[:, cur] = tok
        mask1[:, cur] = 1
        hist[:, cur] = h_cand[torch.arange(b, device=dev), c].to(policy.dtype)
        anc[:, cur] = c.to(torch.int32)
        finished = finished | (tok == dc.eos_token_id)

        # the next candidates from the winner's logits
        sel = logits[:, -1].reshape(b, k, -1)[torch.arange(b, device=dev), c]
        lp = process_logits(sel, dc, tokens, mask1, cur + 1, L)
        cand_p, cand_tok = _top_k(_softmax(lp), k)
        cur += 1
    return tokens
