"""FlamingoModel: the public entry point, cut to generation and the forward.

Port of ``flamingo_mini_tpu/modeling_flamingo.py::FlamingoModel`` for greedy
and beam decoding over a GPT-2 or OPT trunk, per layer or through the
whole-step megakernel (weight-only or w8a8), and the uncached forward with
its loss. The policy
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
                 eos_token_id: Optional[int] = None,
                 pad_token_id: Optional[int] = None, prefix_block: int = 0,
                 fused_head: bool = True, megakernel: bool = False,
                 w8a8: bool = False, num_beams: int = 1, length_penalty: float = 1.0,
                 early_stopping: bool = True, num_return_sequences: int = 1,
                 num_beam_groups: int = 1, diversity_penalty: float = 0.0,
                 beam_reorder: str = "lazy", return_scores: bool = False,
                 **unsupported):
        """Token ids (b, max_length): prompt, generated tokens, pads after
        EOS. Greedy, or beam search with ``num_beams > 1`` (HF semantics,
        ``beam_search.py``): then ``(b * n, max_length)`` with
        ``num_return_sequences=n``, and ``(tokens, sequences_scores)`` with
        ``return_scores``. ``megakernel`` runs each decode step's trunk as
        one ``decode_step_megakernel`` launch (int8 weights, bf16 policy,
        GPT-2 or pre-norm OPT trunk; opt-350m's post-norm trunk with its
        in/out projections raises ``ValueError``); ``w8a8`` (with
        ``megakernel`` only, else ``ValueError``) runs its w8a8 tier, every
        linear on int8 activations, greedy and beams, any batch; diverse
        beams (``num_beam_groups > 1``) run per layer and refuse ``w8a8``.
        Before vision and prefill, a megakernel call the card cannot hold
        (a trunk too wide for its shared memory at this batch) raises
        ``ValueError``. Other JAX ``generate`` options (sampling, logits
        processors, the gather beam reorder, greedy scores, int8 KV,
        meshes, ...) are not ported yet and raise ``NotImplementedError``."""
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
        dc = DecodeConfig(max_length=max_length, max_new_tokens=max_new_tokens,
                          eos_token_id=eos,
                          pad_token_id=eos if pad_token_id is None else pad_token_id,
                          prefix_block=prefix_block, fused_head=fused_head,
                          megakernel=megakernel, w8a8=w8a8, num_beams=num_beams,
                          length_penalty=length_penalty,
                          early_stopping=early_stopping,
                          num_return_sequences=num_return_sequences,
                          num_beam_groups=num_beam_groups,
                          diversity_penalty=diversity_penalty,
                          beam_reorder=beam_reorder, return_scores=return_scores)
        return generate_impl(self.params, self.config, dc, self.policy, ids,
                             media, mask, visual_features=visual_features,
                             pixel_values=pixel_values)


def _to_device(tree, device: torch.device):
    """The same nested dicts / lists of tensors, each on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)
