"""CLIP ViT vision tower, port of ``flamingo_mini_tpu/models/clip_vit.py``.

The patch convolution is patch extraction by reshape followed by one GEMM
(stride == kernel size), with the patch rows ordered (ph, pw, c) as in the
JAX package. Returns HF ``last_hidden_state`` (no post_layernorm). Under a
``pallas`` policy the self-attention is ``fused_attention`` on unscaled q,
the scale applied to the float32 scores inside the kernel; otherwise
``attend`` on q pre-scaled in the compute dtype. With a model group
(``policy.tp``) a rank computes its heads: q/k/v and fc1 column-parallel,
out_proj and fc2 row-parallel.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configuration_flamingo import CLIPViTArch
from ..ops.attention import attend, merge_heads, split_heads
from ..ops.fused_attention import fused_attention
from ..ops.layers import (Policy, column_linear, const, get_activation,
                          init_layer_norm, init_linear, layer_norm, linear,
                          normal, row_linear)

Params = Dict[str, Any]


def init_clip_vit(gen: torch.Generator, arch: CLIPViTArch) -> Params:
    d = arch.hidden_size
    dev = gen.device
    patch_dim = arch.patch_size * arch.patch_size * 3
    p: Params = {
        "class_embedding": normal(gen, (d,), 0.02),
        "patch_embedding": {"w": normal(gen, (patch_dim, d), 0.02)},
        "position_embedding": normal(gen, (arch.seq_len, d), 0.02),
        "pre_layernorm": init_layer_norm(d, dev),
        "layers": [],
        "post_layernorm": init_layer_norm(d, dev),
    }
    for _ in range(arch.num_hidden_layers):
        p["layers"].append({
            "ln_1": init_layer_norm(d, dev),
            "q_proj": init_linear(gen, d, d),
            "k_proj": init_linear(gen, d, d),
            "v_proj": init_linear(gen, d, d),
            "out_proj": init_linear(gen, d, d),
            "ln_2": init_layer_norm(d, dev),
            "fc1": init_linear(gen, d, arch.intermediate_size),
            "fc2": init_linear(gen, arch.intermediate_size, d),
        })
    return p


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """(b, c, H, W) -> (b, n_patches, patch*patch*c), rows ordered (ph, pw, c)."""
    b, c, H, W = pixel_values.shape
    gh, gw = H // patch, W // patch
    x = pixel_values.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 3, 5, 1)
    return x.reshape(b, gh * gw, patch * patch * c)


def apply_clip_vit(p: Params, pixel_values: torch.Tensor, *,
                   arch: CLIPViTArch, policy: Policy) -> torch.Tensor:
    """(b, 3, H, W) -> last_hidden_state (b, 1 + n_patches, d)."""
    b = pixel_values.shape[0]
    d = arch.hidden_size
    eps = arch.layer_norm_epsilon
    scale = (d // arch.num_attention_heads) ** -0.5
    n_head, tp = policy.local_heads(arch.num_attention_heads), policy.tp

    patches = patchify(policy.cast(pixel_values), arch.patch_size)
    x = linear(patches, p["patch_embedding"])
    cls = p["class_embedding"].to(x.dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1)
    x = x + p["position_embedding"].to(x.dtype)[None]
    x = layer_norm(x, p["pre_layernorm"], eps)

    act = get_activation(arch.activation)
    for bp in p["layers"]:
        residual = x
        h = layer_norm(x, bp["ln_1"], eps)
        q, k, v = (split_heads(column_linear(h, bp[name], tp), n_head)
                   for name in ("q_proj", "k_proj", "v_proj"))
        if policy.pallas:
            out = fused_attention(q, k, v, scale=scale)
        else:
            out = attend(q * const(scale, h.dtype), k, v)
        x = residual + row_linear(merge_heads(out), bp["out_proj"], tp)

        residual = x
        h = layer_norm(x, bp["ln_2"], eps)
        h = act(column_linear(h, bp["fc1"], tp))
        x = residual + row_linear(h, bp["fc2"], tp)
    return x
