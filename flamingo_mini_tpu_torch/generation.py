"""Batched generation over the flat KV cache: greedy here, beams in
``beam_search.py``.

Port of the greedy path of ``flamingo_mini_tpu/generation.py`` (``_prefill``
and ``_generate_impl``); ``generate_impl`` hands ``num_beams > 1`` to
``beam_search.beam_generate``:

* prefill runs the (left-padded) prompt through the model once, filling the
  flat cache; the xattn K/V are computed once and stay constant;
* the first token is the argmax of the full ``lm_head`` at the last slot;
* each decode step runs embed -> trunk -> final LayerNorm -> head. The
  trunk (GPT-2 or OPT) runs either per layer (the default: gated xattn
  where the layer has it, then the decoder block with
  ``decode_attention``) or, with ``megakernel``, as one
  ``decode_step_megakernel`` launch over the stacked cache (int8 weights
  packed once per call; GPT-2 and pre-norm OPT), weight-only or, with
  ``w8a8``, with int8 activations too. On the plain-greedy bf16
  int8 path the head is ``lm_head_argmax``, which returns the token without
  writing the logits; otherwise the full ``lm_head`` + argmax;
* with ``prefix_block > 0`` the steps run in segments that attend only the
  live cache prefix ``[0, seg_end)``; every segment, and the whole loop,
  stops once every row has emitted EOS.

Generated tokens see ``text_time`` = the prompt's media count. Prompts must
be unpadded or left-padded. The loop is a Python loop; it checks the
all-EOS exit once per step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from .configuration_flamingo import FlamingoConfig
from .models import flamingo, gpt2
from .ops import lm_head, megadecode
from .ops.layers import Policy, layer_norm
from .ops.lm_head import lm_head_argmax, pad_head_weights

Params = Dict[str, Any]
HEAD_BLOCK_V = 2048


@dataclass(frozen=True)
class DecodeConfig:
    """The greedy and beam subset of the JAX package's DecodeConfig, with
    its defaults. None of the logits-processor options is ported yet, so
    the chain (``process_logits`` there) is the identity here."""

    max_length: int = 150
    max_new_tokens: Optional[int] = None
    eos_token_id: int = 50256
    pad_token_id: int = 50256
    prefix_block: int = 0
    flat_kv_cache: bool = True
    fused_head: bool = True
    # whole-step megakernel: int8 weights, bf16 policy, GPT-2 or pre-norm
    # OPT trunk
    megakernel: bool = False
    # w8a8 tier (needs the megakernel): every trunk and xattn linear of the
    # step quantizes its activations per row (symmetric absmax int8) and
    # sums int8 x int8 products; attention stays bf16. Another numerics
    # tier than weight-only, not an approximation of it.
    w8a8: bool = False
    # beam search (HF semantics, beam_search.py)
    num_beams: int = 1
    length_penalty: float = 1.0
    early_stopping: bool = True
    num_return_sequences: int = 1     # top n hypotheses per row, interleaved
    num_beam_groups: int = 1          # diverse beams: per layer only
    diversity_penalty: float = 0.0
    # "lazy": cache rows never move, an ancestry table is permuted instead
    beam_reorder: str = "lazy"
    return_scores: bool = False       # beams: HF sequences_scores

    def __post_init__(self):
        if self.max_new_tokens is not None and self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if self.max_length < 2:
            raise ValueError(f"max_length must be >= 2, got {self.max_length}")
        if not self.flat_kv_cache:
            raise NotImplementedError("only the flat KV cache is ported")
        if self.beam_reorder not in ("gather", "lazy"):
            raise ValueError(f"beam_reorder must be 'gather' or 'lazy', "
                             f"got {self.beam_reorder!r}")
        if self.beam_reorder == "gather":
            raise NotImplementedError("beam_reorder='gather' is not ported; "
                                      "the lazy reorder is")
        if self.num_beam_groups > 1 and self.num_beams % self.num_beam_groups:
            raise ValueError(f"num_beams ({self.num_beams}) must be divisible "
                             f"by num_beam_groups ({self.num_beam_groups})")
        if self.w8a8 and not self.megakernel:
            raise ValueError("w8a8 (int8 activation quantization) is a "
                             "megakernel tier: set megakernel=True")
        if self.w8a8 and self.num_beam_groups > 1:
            raise ValueError("w8a8 runs on the megakernel, and diverse beams "
                             "(num_beam_groups > 1) run per layer")
        if self.diversity_penalty != 0.0 and self.num_beam_groups <= 1:
            raise ValueError("diversity_penalty requires num_beam_groups > 1")
        if self.num_beams == 1:
            if self.return_scores:
                raise NotImplementedError(
                    "return_scores is ported for beam search only")
            if self.num_return_sequences > 1:
                raise ValueError("num_return_sequences > 1 requires "
                                 "num_beams >= num_return_sequences")


def _prefill(params: Params, config: FlamingoConfig, dc: DecodeConfig,
             policy: Policy, input_ids, media_locations, attention_mask,
             visual_features):
    """Run the prompt, filling the cache -> (next_logits, xattn_kv, state)."""
    b, L = input_ids.shape
    dev = input_ids.device
    mask_buf = torch.zeros((b, dc.max_length), dtype=torch.int32, device=dev)
    mask_buf[:, :L] = attention_mask
    tokens = torch.full((b, dc.max_length), dc.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, :L] = input_ids

    text_time = torch.cumsum(media_locations.to(torch.int32), dim=-1)
    xattn_kv = flamingo.compute_xattn_kv(params, config, visual_features,
                                         policy=policy)
    hook = flamingo.make_layer_hook(params, config, xattn_kv, text_time,
                                    policy=policy)
    kc, vc, cache = flamingo.trunk(config).init_cache(
        config.lm_arch, b, dc.max_length, policy.dtype, dev)
    # position ids from the attention mask (pads do not advance positions)
    pos = torch.clamp(torch.cumsum(attention_mask.to(torch.int32), dim=-1) - 1,
                      min=0)
    logits, cache, _ = flamingo.apply_lm(
        params, config, input_ids, policy=policy, layer_hook=hook,
        attention_mask=mask_buf, position_ids=pos, cache=cache, cache_index=0)
    state = {
        "tokens": tokens,
        "mask": mask_buf,
        "cache": cache,
        "kc": kc,
        "vc": vc,
        "media_count": text_time[:, -1:],
        "pos_next": attention_mask.to(torch.int32).sum(-1, keepdim=True),
    }
    return logits[:, -1], xattn_kv, state


def check_mega_fits(config: FlamingoConfig, dc: DecodeConfig, rows: int,
                    visual_features: Optional[torch.Tensor],
                    pixel_values: Optional[torch.Tensor], device) -> None:
    """With ``dc.megakernel`` on a CUDA device, refuse a step the card
    cannot hold (``megadecode.check_fits``: ``rows`` rows, the flat cache's
    slots, the media's latents) before vision and prefill run."""
    if not dc.megakernel:
        return
    if pixel_values is not None:
        n_media = pixel_values.shape[0 if pixel_values.ndim == 4 else 1]
    else:
        n_media = visual_features.shape[1]
    megadecode.check_fits(config, rows, gpt2.cache_len(dc.max_length),
                          n_media * config.resampler_num_latents,
                          act_quant=dc.w8a8, device=device)


def _mega_prepare(params: Params, config: FlamingoConfig, policy: Policy,
                  dc: DecodeConfig, xattn_kv, mask: torch.Tensor,
                  media_count: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The megakernel's per-generate inputs: packed weights and xattn K/V,
    each row's first real slot and its media count, the w8a8 switch."""
    if policy.dtype != torch.bfloat16:
        raise ValueError("the megakernel runs the bf16 compute policy")
    xk, xv = megadecode.pack_xattn_kv_flat(xattn_kv, flamingo.n_lm_layers(config))
    return dict(packed=megadecode.pack_decode_weights(params, config), xk=xk,
                xv=xv, npad=mask.argmax(dim=-1).to(torch.int32),
                text_time=media_count[:, 0].to(torch.int32).contiguous(),
                act_quant=dc.w8a8)


def _mega_hidden(params: Params, config: FlamingoConfig, policy: Policy,
                 mega: Dict[str, torch.Tensor], kc, vc, tok: torch.Tensor,
                 pos: torch.Tensor, cur: int, kv_limit: Optional[int],
                 beam_anc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One megakernel decode step: embed ``tok`` (b,) at positions ``pos``
    (b,), run every layer (K/V written at slot ``cur`` of kc/vc) ->
    final-LN hidden (b, D)."""
    lm, trunk = params["lm"], flamingo.trunk(config)
    x = trunk.embed(lm, tok, pos, policy.dtype)
    hidden = megadecode.decode_step_megakernel(
        mega["packed"], mega["xk"], mega["xv"], kc, vc, x, mega["npad"],
        mega["text_time"], cur, config=config, kv_limit=kv_limit,
        beam_anc=beam_anc, act_quant=mega["act_quant"])
    return layer_norm(hidden, lm[trunk.FINAL_LN], config.lm_arch.layer_norm_epsilon)


def generate_impl(params: Params, config: FlamingoConfig, dc: DecodeConfig,
                  policy: Policy, input_ids: torch.Tensor,
                  media_locations: torch.Tensor, attention_mask: torch.Tensor,
                  visual_features: Optional[torch.Tensor] = None,
                  pixel_values: Optional[torch.Tensor] = None):
    """Greedy decode -> tokens (b, max_length) int64: prompt, generated
    tokens, pad after EOS. ``dc.num_beams > 1``: ``beam_search.beam_generate``
    (its returns), on the batch as given."""
    if dc.megakernel and not megadecode.supports_arch(config.lm_arch):
        raise ValueError("the megakernel takes GPT-2 and pre-norm OPT trunks "
                         f"without project_in/out, width a multiple of "
                         f"{megadecode.K_CHUNK}; got {config.lm!r}")
    if dc.num_beams > 1:
        from .beam_search import beam_generate   # beam_search imports _prefill
        return beam_generate(params, config, dc, policy, input_ids,
                             media_locations, attention_mask,
                             visual_features=visual_features,
                             pixel_values=pixel_values)
    b, L = input_ids.shape
    check_mega_fits(config, dc, b, visual_features, pixel_values, input_ids.device)
    # fused int8 head + argmax: plain greedy under the bf16 policy with an
    # int8 tied embedding (the kernel takes a bf16 hidden row of any width;
    # what the card cannot hold is refused here, before vision and prefill)
    head = None
    wq = params["lm"].get(flamingo.trunk(config).EMBED + "_q")
    if dc.fused_head and policy.dtype == torch.bfloat16 and wq is not None:
        lm_head.check_fits(int(wq["w8"].shape[1]), b, input_ids.device)
        head_nvalid = min(int(wq["w8"].shape[0]), config.lm_arch.vocab_size + 1)
        head = pad_head_weights(wq, HEAD_BLOCK_V)
    if pixel_values is not None:
        visual_features = flamingo.encode_resample_visuals(
            params, config, policy.cast(pixel_values), policy=policy)
    next_logits, xattn_kv, st = _prefill(
        params, config, dc, policy, input_ids, media_locations,
        attention_mask, visual_features)
    decode_hook = flamingo.make_layer_hook(params, config, xattn_kv,
                                           st["media_count"], policy=policy)
    if dc.megakernel:
        mega = _mega_prepare(params, config, policy, dc, xattn_kv, st["mask"],
                             st["media_count"])

    tok = torch.argmax(next_logits.float(), dim=-1)
    finished = tok == dc.eos_token_id
    # the first generated token is written as-is; finished rows emit pad
    # from the next step on
    st["tokens"][:, L] = tok
    st["mask"][:, L] = 1

    M = dc.max_length if dc.max_new_tokens is None else \
        min(dc.max_length, L + dc.max_new_tokens)
    if dc.prefix_block > 0:
        seg_ends = sorted(set(list(range(L + dc.prefix_block, M - 1,
                                         dc.prefix_block)) + [M - 1]))
    else:
        seg_ends = [M - 1]

    cur = L
    for seg_end in seg_ends:
        kv_limit = min(seg_end, dc.max_length) if dc.prefix_block > 0 else None
        while cur < seg_end and not bool(finished.all()):
            if dc.megakernel:
                hid = _mega_hidden(params, config, policy, mega, st["kc"],
                                   st["vc"], tok, st["pos_next"][:, 0], cur,
                                   kv_limit)[:, None]
                logits = None if head is not None else flamingo.lm_head(
                    params, config, hid)
            else:
                logits, _, hid = flamingo.apply_lm(
                    params, config, tok[:, None], policy=policy,
                    layer_hook=decode_hook, attention_mask=st["mask"],
                    position_ids=st["pos_next"], cache=st["cache"],
                    cache_index=cur, kv_limit=kv_limit,
                    skip_head=head is not None)
            st["pos_next"] = st["pos_next"] + 1
            if head is not None:
                nxt = lm_head_argmax(head["w8"], head["scale"],
                                     hid[:, -1].contiguous(),
                                     n_valid=head_nvalid).long()
            else:
                nxt = torch.argmax(logits[:, -1].float(), dim=-1)
            st["tokens"][:, cur + 1] = nxt.masked_fill(finished, dc.pad_token_id)
            st["mask"][:, cur + 1] = 1
            finished = finished | (nxt == dc.eos_token_id)
            tok = nxt
            cur += 1
    return st["tokens"]
