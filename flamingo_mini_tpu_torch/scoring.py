"""Zero-shot sequence scoring (the reference's ``score_sequences``), port of
``flamingo_mini_tpu/scoring.py``.

Two passes:

1. the common prefix (its length found on the host) runs once, batch 1,
   into a head-major cache;
2. the next-token logits after it keep the top-k candidate sequences
   (ties to the lower index, as ``lax.top_k``: ``ops.topk.top_k``);
3. the cache and the xattn K/V are repeated for the k choices, and the
   choices' suffixes re-enter the cache at ``n_reuse - 1`` (the reference
   trims the last cached position, which recomputes that slot);
4. each choice's score is ``-sum`` of its per-token loss past the common
   prefix; the sequences not kept score ``finfo(float32).min``.

The JAX package's ``reuse_block`` (prefix lengths bucketed so that jit
compiles once a bucket) has no counterpart: the passes run eagerly at the
prefix's own length.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .beam_search import _tile_leaves
from .configuration_flamingo import FlamingoConfig
from .models import flamingo
from .ops.layers import Policy
from .ops.topk import top_k

Params = Dict[str, Any]


def get_common_prefix_length(input_ids) -> int:
    """Length of the longest common prefix across rows (the reference's
    utils.py:53-57)."""
    x = np.asarray(input_ids)
    if x.shape[0] == 1:
        return x.shape[1]
    eq = (x[0] == x[1:]).all(axis=0)
    idx = np.argmin(eq)
    if eq[idx]:
        return x.shape[1]
    return int(idx)


def _score_impl(params: Params, config: FlamingoConfig, policy: Policy,
                input_ids: torch.Tensor, media_locations: torch.Tensor,
                attention_mask: torch.Tensor, visual_features: torch.Tensor,
                n_reuse: int, k: int) -> torch.Tensor:
    n_choices, L = input_ids.shape
    dev = input_ids.device

    # pass 1: the shared prefix (batch 1) over [0, n_reuse)
    text_time = torch.cumsum(media_locations.to(torch.int32), dim=-1)
    xattn_kv = flamingo.compute_xattn_kv(params, config, visual_features,
                                         policy=policy)
    hook = flamingo.make_layer_hook(params, config, xattn_kv, text_time[:1, :n_reuse],
                                    policy=policy)
    _, _, cache = flamingo.trunk(config).init_cache(config.lm_arch, 1, L, policy.dtype,
                                                    dev, flat=False)
    # the mask spans the whole (preallocated) cache
    mask_full = torch.zeros((1, L), dtype=torch.int32, device=dev)
    mask_full[:, :n_reuse] = attention_mask[:1, :n_reuse]
    logits, cache, _ = flamingo.apply_lm(
        params, config, input_ids[:1, :n_reuse], policy=policy, layer_hook=hook,
        attention_mask=mask_full, cache=cache, cache_index=0)

    # top-k on the next token after the prefix
    next_tokens = input_ids[:, n_reuse]
    cand_logits = logits[0, n_reuse - 1][next_tokens]
    _, topk_idx = top_k(cand_logits, k)

    # pass 2: the k choices from n_reuse - 1 over the repeated caches; column
    # j of its logits predicts the token at n_reuse + j
    cache_k = [_tile_leaves(layer, k) for layer in cache]
    xattn_kv_k = {key: _tile_leaves(kv, k) for key, kv in xattn_kv.items()}
    choice_ids = input_ids[topk_idx][:, n_reuse - 1:]
    choice_media = media_locations[topk_idx]
    choice_mask = attention_mask[topk_idx]
    choice_time = torch.cumsum(choice_media.to(torch.int32), dim=-1)[:, n_reuse - 1:]
    hook2 = flamingo.make_layer_hook(params, config, xattn_kv_k, choice_time,
                                     policy=policy)
    logits2, _, _ = flamingo.apply_lm(
        params, config, choice_ids, policy=policy, layer_hook=hook2,
        attention_mask=choice_mask, cache=cache_k, cache_index=n_reuse - 1)
    losses = flamingo.cross_entropy_loss(logits2, choice_ids,
                                         reduction="none").reshape(k, -1).sum(dim=1)

    scores = torch.full((n_choices,), torch.finfo(torch.float32).min,
                        dtype=torch.float32, device=dev)
    scores[topk_idx] = -losses
    return scores


@torch.inference_mode()
def score_sequences(
    params: Params,
    config: FlamingoConfig,
    input_ids: torch.Tensor,
    media_locations: torch.Tensor,
    attention_mask: torch.Tensor,
    *,
    policy: Policy,
    pixel_values: Optional[torch.Tensor] = None,
    visual_features: Optional[torch.Tensor] = None,
    k: int = 100000,
) -> torch.Tensor:
    """Log-prob scores (b,) float32 for candidate sequences sharing a
    common prefix. The visual input is shared by the whole batch:
    ``pixel_values`` (N c h w) or ``visual_features`` (N q d) / (1 N q d).
    Tensors on one device, which the scores land on."""
    n_choices, L = input_ids.shape
    n_reuse = get_common_prefix_length(input_ids.cpu().numpy())
    k = min(k, n_choices)
    if n_reuse == 0:
        # without a common prefix the filter would condition on row 0's
        # first token, which could wrongly drop other rows: keep them all
        # (pass 2 recomputes every row from index 0)
        k = n_choices
    # the reference fails when every sequence is equal; clamp so the choice
    # pass always has at least one token
    n_reuse = max(min(n_reuse, L - 1), 1)

    if visual_features is None:
        if pixel_values is None:
            raise ValueError("need pixel_values or visual_features")
        visual_features = flamingo.encode_resample_visuals(
            params, config, pixel_values[None], policy=policy)   # (1, N, q, d)
    elif visual_features.ndim == 3:
        visual_features = visual_features[None]
    return _score_impl(params, config, policy, input_ids, media_locations,
                       attention_mask, visual_features, n_reuse, k)
