"""Flamingo model assembly, port of ``flamingo_mini_tpu/models/flamingo.py``.

The decoder trunk (GPT-2 or OPT, ``lm_family``) applies a gated xattn
block before every ``xattn_every``-th layer through ``layer_hook``; the
visual K/V per xattn layer and ``text_time`` are explicit arguments.
``forward`` is the uncached full-sequence pass with the shifted
cross-entropy (training, scoring, eval loss); ``dropout_generator`` turns
on the trunk's training-mode dropout. The vision tower runs under
``torch.no_grad()``: it never trains, whatever the freeze flags (JAX's
``stop_gradient``).

A policy with a model group (``policy.tp``) runs every module on the
rank's slice of the parameters (``parallel/sharding.py``). ``forward(...,
ring=group)`` splits the sequence over a process group (context
parallelism, JAX's ``context_mesh``): positions and ``text_time`` from the
whole sequence, each rank's chunk through the trunk with ring attention,
the logits gathered.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configuration_flamingo import FlamingoConfig
from ..ops.layers import Policy
from ..parallel import comm
from . import clip_vit, gpt2, opt
from .resampler import apply_resampler, init_resampler
from .xattn import (KV, apply_gated_xattn_block, compute_visual_kv,
                    init_gated_xattn_block)

Params = Dict[str, Any]


def lm_family(config: FlamingoConfig) -> str:
    """"gpt2" or "opt": the trunk's ``family``, which the ``lm`` hub name
    chose when the config resolved its architecture."""
    return config.lm_arch.family


def trunk(config: FlamingoConfig):
    """The trunk's module, ``gpt2`` or ``opt``: ``init_cache``, ``embed``,
    ``lm_head`` and the ``EMBED`` / ``FINAL_LN`` keys under the same names."""
    return {"gpt2": gpt2, "opt": opt}[lm_family(config)]


def n_lm_layers(config: FlamingoConfig) -> int:
    arch = config.lm_arch
    return arch.n_layer if lm_family(config) == "gpt2" else arch.num_hidden_layers


def xattn_layer_indices(config: FlamingoConfig) -> List[int]:
    """LM layers that get a gated xattn block: every xattn_every-th from 0."""
    return [i for i in range(n_lm_layers(config)) if i % config.xattn_every == 0]


def init_flamingo(gen: torch.Generator, config: FlamingoConfig) -> Params:
    """Random-init parameter tree {vision, resampler, lm, xattn} on the
    generator's device (float32, alphas 0)."""
    arch = config.lm_arch
    gpt = lm_family(config) == "gpt2"
    hidden = arch.n_embd if gpt else arch.hidden_size
    if config.dim != hidden:
        raise ValueError(f"config.dim={config.dim} but {config.lm} hidden "
                         f"size={hidden}")
    return {
        "vision": clip_vit.init_clip_vit(gen, config.vision_arch),
        "resampler": init_resampler(
            gen, dim=config.dim_visual, depth=config.resampler_depth,
            dim_head=config.resampler_dim_head, heads=config.resampler_heads,
            num_latents=config.resampler_num_latents,
            num_time_embeds=config.resampler_num_time_embeds,
            ff_mult=config.resampler_ff_mult),
        "lm": gpt2.init_gpt2(gen, arch) if gpt else opt.init_opt(gen, arch),
        "xattn": {
            str(i): init_gated_xattn_block(
                gen, dim=config.dim, dim_visual=config.dim_visual,
                dim_head=config.xattn_dim_head, heads=config.xattn_heads,
                ff_mult=config.xattn_ff_mult)
            for i in xattn_layer_indices(config)},
    }


def encode_resample_visuals(params: Params, config: FlamingoConfig,
                            pixel_values: torch.Tensor, *,
                            policy: Policy) -> torch.Tensor:
    """Vision encoder + resampler: pixels -> (b, N, q, d_visual).

    Accepts ``(N c h w)`` (b=1), ``(b N c h w)`` (T=1) or ``(b N T c h w)``.
    The vision tower runs under ``torch.no_grad()``: no gradient reaches it
    or the pixels.
    """
    if pixel_values.ndim == 4:
        b, N, T = 1, pixel_values.shape[0], 1
    elif pixel_values.ndim == 5:
        (b, N), T = pixel_values.shape[:2], 1
    elif pixel_values.ndim == 6:
        b, N, T = pixel_values.shape[:3]
    else:
        raise ValueError("pixel_values must have ndim 4, 5 or 6")
    flat = pixel_values.reshape((b * N * T,) + tuple(pixel_values.shape[-3:]))
    with torch.no_grad():
        feats = clip_vit.apply_clip_vit(params["vision"], flat,
                                        arch=config.vision_arch, policy=policy)
    v, d = feats.shape[-2:]
    resampled = apply_resampler(
        params["resampler"], feats.reshape(b * N, T, v, d),
        heads=config.resampler_heads, dim_head=config.resampler_dim_head,
        act=config.resampler_act, policy=policy)
    return resampled.reshape(b, N, resampled.shape[-2], config.dim_visual)


def compute_xattn_kv(params: Params, config: FlamingoConfig,
                     visual_features: torch.Tensor, *,
                     policy: Policy) -> Dict[str, KV]:
    """Per-xattn-layer visual K/V from the features in the policy's dtype,
    constant over the decode steps."""
    visual_features = policy.cast(visual_features)
    return {idx: compute_visual_kv(block["attn"], visual_features,
                                   heads=config.xattn_heads, tp=policy.tp)
            for idx, block in params["xattn"].items()}


def make_layer_hook(params: Params, config: FlamingoConfig,
                    xattn_kv: Dict[str, KV], text_time: torch.Tensor, *,
                    policy: Policy):
    """The decoder layer_hook applying gated xattn at the hijacked layers."""

    def hook(i: int, x: torch.Tensor) -> torch.Tensor:
        key = str(i)
        if key not in params["xattn"]:
            return x
        return apply_gated_xattn_block(
            params["xattn"][key], x, xattn_kv[key], text_time,
            n_visual=config.resampler_num_latents, heads=config.xattn_heads,
            dim_head=config.xattn_dim_head, act=config.xattn_act, policy=policy)

    return hook


def apply_lm(params: Params, config: FlamingoConfig, input_ids: torch.Tensor,
             *, policy: Policy, layer_hook, attention_mask: Optional[torch.Tensor],
             position_ids: Optional[torch.Tensor] = None, cache=None,
             cache_index: Optional[int] = None, kv_limit: Optional[int] = None,
             skip_head: bool = False, beam_anc: Optional[torch.Tensor] = None,
             dropout_generator: Optional[torch.Generator] = None, ring=None
             ) -> Tuple[Optional[torch.Tensor], Any, torch.Tensor]:
    """Trunk + tied head -> (logits or None with ``skip_head``, cache,
    the trunk's output: the hidden rows the head reads). ``beam_anc``: the
    lazy-beam ancestry table of a decode step (``gpt2.apply_gpt2``);
    ``dropout_generator``: the trunk's training-mode dropout; ``ring``: the
    tokens are a chunk of a sequence split over that group."""
    apply = gpt2.apply_gpt2 if lm_family(config) == "gpt2" else opt.apply_opt
    hidden, cache = apply(
        params["lm"], input_ids, arch=config.lm_arch, policy=policy,
        position_ids=position_ids, attention_mask=attention_mask,
        layer_hook=layer_hook, cache=cache, cache_index=cache_index,
        kv_limit=kv_limit, beam_anc=beam_anc, dropout_generator=dropout_generator,
        ring=ring)
    logits = None if skip_head else lm_head(params, config, hidden, policy.tp)
    return logits, cache, hidden


def lm_head(params: Params, config: FlamingoConfig, hidden: torch.Tensor,
            tp=None) -> torch.Tensor:
    """The family's tied head, the ``<EOC>`` row included and padded vocab
    rows masked (dropped over a model group ``tp``)."""
    return trunk(config).lm_head(params["lm"], hidden,
                                 n_valid=config.lm_arch.vocab_size + 1, tp=tp)


@dataclass
class FlamingoOutput:
    logits: torch.Tensor
    loss: Optional[torch.Tensor] = None
    xattn_kv: Optional[Dict[str, KV]] = None


def forward(params: Params, config: FlamingoConfig, input_ids: torch.Tensor,
            *, policy: Policy, media_locations: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            pixel_values: Optional[torch.Tensor] = None,
            visual_features: Optional[torch.Tensor] = None,
            labels: Optional[torch.Tensor] = None,
            loss_reduction: str = "mean",
            dropout_generator: Optional[torch.Generator] = None,
            ring=None) -> FlamingoOutput:
    """The uncached full-sequence forward: visual encode + resample (unless
    features are given; without either, zero features and no media),
    per-layer conditioning, trunk, tied head, and the shifted cross-entropy
    when ``labels`` are given. input_ids, media_locations, attention_mask,
    labels: (b, n). ``dropout_generator`` (a ``torch.Generator`` on the
    inputs' device) turns on the trunk's dropout; None is evaluation.

    ``ring``: a process group of n ranks, each with the same inputs, over
    which the sequence (n dividing it) is split in contiguous chunks:
    positions and ``text_time`` are taken on the whole sequence, then each
    rank runs its chunk through the trunk with ring attention, and the
    logits are gathered, so every rank returns the whole output. The
    gradient a rank's loss gives a parameter is that rank's share: their
    sum over the group is the gradient of the loss."""
    b, n = input_ids.shape
    dev = input_ids.device
    if visual_features is None:
        if pixel_values is not None:
            visual_features = encode_resample_visuals(params, config, pixel_values,
                                                      policy=policy)
        else:
            visual_features = torch.zeros(
                (b, 1, config.resampler_num_latents, config.dim_visual),
                dtype=policy.dtype, device=dev)
    if media_locations is None:
        media_locations = torch.zeros((b, n), dtype=torch.int32, device=dev)
    text_time = torch.cumsum(media_locations.to(torch.int32), dim=-1)
    xattn_kv = compute_xattn_kv(params, config, visual_features, policy=policy)
    ids, mask, positions = input_ids, attention_mask, None
    if ring is not None:
        n_rank = comm.size(ring)
        if n % n_rank:
            raise ValueError(f"sequence {n} not divisible by the {n_rank} "
                             "ranks of the context group")
        chunk = slice(comm.rank(ring) * (n // n_rank), (comm.rank(ring) + 1) * (n // n_rank))
        if lm_family(config) == "gpt2":
            positions = torch.arange(n, device=dev)[None].expand(b, n)
        else:
            full = (attention_mask if attention_mask is not None
                    else torch.ones((b, n), dtype=torch.int32, device=dev))
            positions = opt.opt_position_ids(full)
        ids, positions, text_time = (x[:, chunk] for x in (input_ids, positions,
                                                            text_time))
        mask = None if attention_mask is None else attention_mask[:, chunk]
    hook = make_layer_hook(params, config, xattn_kv, text_time, policy=policy)
    logits, _, _ = apply_lm(params, config, ids, policy=policy,
                            layer_hook=hook, attention_mask=mask,
                            position_ids=positions,
                            dropout_generator=dropout_generator, ring=ring)
    if ring is not None:
        logits = comm.gather_from_model_parallel(logits, ring, dim=1)
    loss = None
    if labels is not None:
        loss = cross_entropy_loss(logits, labels, reduction=loss_reduction)
    return FlamingoOutput(logits=logits, loss=loss, xattn_kv=xattn_kv)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       reduction: str = "mean",
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shifted next-token cross-entropy in float32 over every position, pads
    included (the reference's loss). ``reduction``: "mean" or "none" (per
    token, flattened to (b * (n - 1),)); ``weights`` (b, n) masks tokens,
    and "mean" then divides by their sum (at least 1)."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    token_loss = -torch.gather(logp, -1, labels[:, 1:, None].long())[..., 0]
    if weights is not None:
        w = weights[:, 1:].to(token_loss.dtype)
        token_loss = token_loss * w
        if reduction == "mean":
            return token_loss.sum() / torch.clamp(w.sum(), min=1)
    if reduction == "mean":
        return token_loss.mean()
    if reduction == "none":
        return token_loss.reshape(-1)
    raise ValueError(f"unknown reduction {reduction!r}")
