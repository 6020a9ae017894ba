"""FlamingoModel: the public entry point, cut to generation and the forward.

Port of ``flamingo_mini_tpu/modeling_flamingo.py::FlamingoModel`` for greedy,
sampled, beam and beam-sample decoding with HF's logits processors over a
GPT-2 or OPT trunk, per layer or through the whole-step megakernel
(weight-only or w8a8), constrained beams and contrastive search per layer,
and the uncached forward with its loss. The policy
follows ``compute_dtype`` and ``use_pallas`` (bf16 with ``use_pallas``: the
attention kernels). Holds (config, params, policy, device); params are a
nested dict of tensors in the JAX package's layout, made by
``models.flamingo.init_flamingo`` from a seed or bridged from JAX by
``utils.params_bridge.from_jax_numpy``. The model runs on the card unless
the caller asks for another device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .configuration_flamingo import FlamingoConfig
from .generation import DecodeConfig, generate_impl
from .models import flamingo as F
from .ops.layers import Policy, policy_for
from .ops.quant import (cast_params_bf16, quantize_gpt2_lm, quantize_opt_lm,
                        quantize_xattn_blocks)

Params = Dict[str, Any]


class FlamingoModel:
    """Stateful wrapper over the functional core."""

    def __init__(self, config: FlamingoConfig, params: Optional[Params] = None,
                 *, device="cuda", seed: int = 0):
        """``params`` on another device are moved to ``device``."""
        self.config = config
        self.device = torch.device(device)
        self.policy: Policy = policy_for(config.compute_dtype, config.use_pallas)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = F.init_flamingo(gen, config)
        self.params = _to_device(params, self.device)

    def to_bf16(self) -> "FlamingoModel":
        """Store float weights as bf16 (int8 scales stay float32). In place."""
        self.params = cast_params_bf16(self.params)
        return self

    def quantize_int8(self) -> "FlamingoModel":
        """Weight-only int8 trunk (GPT-2 or OPT) and xattn blocks. In place."""
        quantize = (quantize_gpt2_lm if F.lm_family(self.config) == "gpt2"
                    else quantize_opt_lm)
        self.params["lm"] = quantize(self.params["lm"])
        self.params["xattn"] = quantize_xattn_blocks(self.params["xattn"])
        return self

    def __call__(self, input_ids, **kw) -> F.FlamingoOutput:
        return self.forward(input_ids, **kw)

    def forward(self, input_ids, *, media_locations=None, attention_mask=None,
                pixel_values=None, visual_features=None, labels=None,
                loss_reduction: str = "mean",
                context_mesh=None) -> F.FlamingoOutput:
        """The uncached forward -> ``FlamingoOutput(logits, loss, xattn_kv)``;
        ``loss`` is the shifted cross-entropy when ``labels`` are given.
        Context parallelism (``context_mesh``) is not ported yet and
        raises ``NotImplementedError``."""
        if context_mesh is not None:
            raise NotImplementedError("context_mesh (ring attention) is not ported")
        dev = self.device

        def put(x, dtype=None):
            return None if x is None else torch.as_tensor(x, device=dev, dtype=dtype)
        return F.forward(
            self.params, self.config, put(input_ids, torch.long),
            policy=self.policy, media_locations=put(media_locations, torch.int32),
            attention_mask=put(attention_mask, torch.int32),
            pixel_values=put(pixel_values), visual_features=put(visual_features),
            labels=put(labels, torch.long), loss_reduction=loss_reduction)

    def encode_resample_visuals(self, pixel_values) -> torch.Tensor:
        """Pixels -> resampled visual features (b, N, q, d_visual)."""
        return F.encode_resample_visuals(
            self.params, self.config, torch.as_tensor(pixel_values, device=self.device),
            policy=self.policy)

    @torch.inference_mode()
    def generate(self, input_ids, *, media_locations=None, attention_mask=None,
                 pixel_values=None, visual_features=None,
                 max_length: int = 150, max_new_tokens: Optional[int] = None,
                 num_beams: int = 1, do_sample: bool = False, top_k: int = 0,
                 top_p: float = 1.0, temperature: float = 1.0,
                 min_p: float = 0.0, typical_p: float = 1.0,
                 epsilon_cutoff: float = 0.0, eta_cutoff: float = 0.0,
                 penalty_alpha: float = 0.0, repetition_penalty: float = 1.0,
                 length_penalty: float = 1.0, early_stopping: bool = True,
                 min_length: int = 0, min_new_tokens: int = 0,
                 no_repeat_ngram_size: int = 0, bad_words_ids=None,
                 force_words_ids=None, num_return_sequences: int = 1,
                 num_beam_groups: int = 1, diversity_penalty: float = 0.0,
                 forced_bos_token_id: Optional[int] = None,
                 forced_eos_token_id: Optional[int] = None,
                 suppress_tokens=None, begin_suppress_tokens=None,
                 sequence_bias=None, exponential_decay_length_penalty=None,
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 int8_kv_cache: bool = False, prefix_block: int = 0,
                 beam_reorder: str = "lazy", flat_kv_cache: bool = True,
                 megakernel: bool = False, w8a8: bool = False,
                 fused_head: bool = True, return_scores: bool = False,
                 output_scores: bool = False, **unsupported):
        """Token ids (b, max_length): prompt, generated tokens, pads after
        EOS. Greedy; sampling with ``do_sample`` (HF's warpers: temperature,
        ``top_k``, ``top_p``, ``min_p``, ``typical_p``, ``epsilon_cutoff``,
        ``eta_cutoff``; the noise from ``generator``, a ``torch.Generator``
        on the model's device, seeded 0 when None, as JAX's ``rng``
        defaults to ``PRNGKey(0)``); or beam search with ``num_beams > 1``
        (HF semantics, ``beam_search.py``), diverse with ``num_beam_groups >
        1``, beam-sample with ``do_sample`` (the warpers after the chain,
        the candidates drawn without replacement, the noise from
        ``generator``, seeded 0 when None); constrained beams with
        ``force_words_ids`` (HF's nested lists: a list of ids is a phrase,
        a list of lists a disjunctive set; ``constrained_beam.py``); or
        contrastive search with ``penalty_alpha > 0`` over ``top_k > 1``
        candidates (``contrastive.py``; ``return_scores`` raises
        ``ValueError``). Every path runs HF's logits processors: ``sequence_bias``,
        ``repetition_penalty``, ``no_repeat_ngram_size``, ``bad_words_ids``
        (a lone-EOS word dropped), ``min_length``, ``min_new_tokens``,
        ``forced_bos_token_id``, ``forced_eos_token_id``,
        ``exponential_decay_length_penalty``, ``suppress_tokens``,
        ``begin_suppress_tokens``.

        ``num_return_sequences=n``: sampling returns n samples per prompt,
        beams the top n hypotheses, either as (b * n, max_length); greedy
        raises ``ValueError``. ``return_scores``: also the scores (b,)
        (greedy and sampling: the sum of the chosen tokens' log-probs under
        the processed, and when sampling warped, step distribution, post-EOS
        pads excluded; beams: HF's ``sequences_scores``). ``output_scores``
        (greedy and sampling): also those log-probs per step, (b,
        max_length) float32 at absolute positions, 0 at prompt slots and
        post-EOS pads; ``(tokens, scores, step_scores)`` with both.

        ``megakernel`` runs each decode step's trunk as one
        ``decode_step_megakernel`` launch (int8 weights, bf16 policy, GPT-2
        or pre-norm OPT trunk; opt-350m's post-norm trunk with its in/out
        projections raises ``ValueError``), any batch; ``w8a8`` (with
        ``megakernel`` only, else ``ValueError``) runs its w8a8 tier, every
        linear on int8 activations; diverse beams run per layer and refuse
        ``w8a8``. ``fused_head`` lets plain greedy (no processor, no scores)
        take ``lm_head_argmax`` (over the flat bf16 cache only, as in JAX).
        Before vision and prefill, a megakernel call the card cannot hold
        raises ``ValueError``. The KV-cache variants run per layer in plain
        torch, as JAX runs them in plain XLA: ``flat_kv_cache=False`` (the
        head-major cache), ``int8_kv_cache`` (the head-major cache in int8
        and the xattn K/V in int8; the megakernel refuses it with
        ``ValueError``) and ``beam_reorder="gather"`` (beams reorder the
        head-major cache's live prefix; with ``megakernel`` it raises
        ``ValueError``). ``pixel_values`` of one prompt may be 4-D, ``(N c
        h w)``. Constrained and contrastive search run per layer over the
        head-major cache, as in JAX: with ``megakernel`` they raise
        ``ValueError``. Not ported yet, raising ``NotImplementedError``:
        ``mesh``, ``tensor_parallel`` or any other JAX option."""
        if unsupported:
            raise NotImplementedError(
                f"generate options not ported yet: {sorted(unsupported)}")
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        b, L = ids.shape
        mask = (torch.ones((b, L), dtype=torch.int32, device=dev)
                if attention_mask is None
                else torch.as_tensor(attention_mask, device=dev).to(torch.int32))
        media = (torch.zeros((b, L), dtype=torch.int32, device=dev)
                 if media_locations is None
                 else torch.as_tensor(media_locations, device=dev).to(torch.int32))
        if pixel_values is not None:
            pixel_values = torch.as_tensor(pixel_values, device=dev)
        elif visual_features is not None:
            visual_features = torch.as_tensor(visual_features, device=dev)
        else:
            visual_features = torch.zeros(
                (b, 1, self.config.resampler_num_latents, self.config.dim_visual),
                dtype=self.policy.dtype, device=dev)
        arch = self.config.lm_arch
        eos = arch.eos_token_id if eos_token_id is None else eos_token_id
        if bad_words_ids is not None:
            # HF drops a bad word equal to [eos]: EOS stays reachable
            bad_words_ids = tuple(tuple(int(t) for t in w) for w in bad_words_ids
                                  if not (len(w) == 1 and int(w[0]) == eos))
        ints = lambda xs: None if xs is None else tuple(int(t) for t in xs)
        if sequence_bias is not None:
            # HF takes a dict {ids: bias} or a list [[ids, bias], ...]
            sequence_bias = tuple(
                (tuple(int(t) for t in w), float(v))
                for w, v in (sequence_bias.items() if isinstance(sequence_bias, dict)
                             else sequence_bias))
        if exponential_decay_length_penalty is not None:
            start, factor = exponential_decay_length_penalty
            exponential_decay_length_penalty = (int(start), float(factor))
        if force_words_ids is not None:
            # HF's nested lists: a phrase becomes one alternative, a
            # disjunctive set keeps its alternatives
            force_words_ids = tuple(
                tuple(tuple(int(t) for t in alt) for alt in w)
                if w and isinstance(w[0], (list, tuple))
                else (tuple(int(t) for t in w),)
                for w in force_words_ids)
        dc = DecodeConfig(
            max_length=max_length, max_new_tokens=max_new_tokens,
            eos_token_id=eos, pad_token_id=eos if pad_token_id is None else pad_token_id,
            do_sample=do_sample, top_k=top_k, top_p=top_p, temperature=temperature,
            min_p=min_p, typical_p=typical_p, epsilon_cutoff=epsilon_cutoff,
            eta_cutoff=eta_cutoff, penalty_alpha=penalty_alpha,
            sequence_bias=sequence_bias,
            exponential_decay_length_penalty=exponential_decay_length_penalty,
            repetition_penalty=repetition_penalty, min_length=min_length,
            min_new_tokens=min_new_tokens, no_repeat_ngram_size=no_repeat_ngram_size,
            bad_words_ids=bad_words_ids,
            force_words_ids=force_words_ids,
            forced_bos_token_id=forced_bos_token_id,
            forced_eos_token_id=forced_eos_token_id,
            suppress_tokens=ints(suppress_tokens),
            begin_suppress_tokens=ints(begin_suppress_tokens),
            int8_kv_cache=int8_kv_cache, prefix_block=prefix_block,
            flat_kv_cache=flat_kv_cache, fused_head=fused_head,
            megakernel=megakernel, w8a8=w8a8, num_beams=num_beams,
            length_penalty=length_penalty, early_stopping=early_stopping,
            num_return_sequences=num_return_sequences,
            num_beam_groups=num_beam_groups, diversity_penalty=diversity_penalty,
            beam_reorder=beam_reorder, return_scores=return_scores,
            output_scores=output_scores)
        return generate_impl(self.params, self.config, dc, self.policy, ids,
                             media, mask, visual_features=visual_features,
                             pixel_values=pixel_values, generator=generator)


def _to_device(tree, device: torch.device):
    """The same nested dicts / lists of tensors, each on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)
