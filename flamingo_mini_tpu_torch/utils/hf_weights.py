"""HF-PyTorch checkpoint -> the port's parameter tree, port of
``flamingo_mini_tpu/utils/hf_weights.py``.

A reference-layout ``FlamingoModel`` state dict (or an HF GPT-2 / OPT /
CLIP one) maps onto the parameter tree the port reads, which keeps the JAX
package's layouts:

* input is a flat ``{name: numpy array}`` dict (``state_dict_to_numpy``
  turns a torch state dict into one; bf16 tensors become float32);
* ``torch.nn.Linear`` stores ``(out, in)`` -> transposed to ``(in, out)``;
* GPT-2's ``Conv1D`` already stores ``(in, out)`` -> copied as is;
* every leaf is a float32 CPU tensor (``FlamingoModel`` moves the tree to
  its device).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Params = Dict[str, Any]


def state_dict_to_numpy(state_dict) -> Dict[str, np.ndarray]:
    """Convert a torch state_dict (or mapping of tensors) to numpy arrays;
    bf16 tensors, which numpy cannot hold, become float32 (every converter
    reads float32)."""
    out = {}
    for k, v in state_dict.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        out[k] = np.asarray(v)
    return out


def _j(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _ln(sd: Dict[str, np.ndarray], prefix: str) -> Params:
    return {"scale": _j(sd[f"{prefix}.weight"]), "bias": _j(sd[f"{prefix}.bias"])}


def _lin(sd: Dict[str, np.ndarray], prefix: str, transpose: bool = True) -> Params:
    w = sd[f"{prefix}.weight"]
    p: Params = {"w": _j(w.T if transpose else w)}
    if f"{prefix}.bias" in sd:
        p["b"] = _j(sd[f"{prefix}.bias"])
    return p


def _ffw(sd: Dict[str, np.ndarray], prefix: str) -> Params:
    """Reference FeedForward = nn.Sequential(LayerNorm, Linear, act, Linear)
    -> keys ``{prefix}.0.*``, ``{prefix}.1.weight``, ``{prefix}.3.weight``
    (the reference's utils.py:45-50)."""
    return {
        "norm": _ln(sd, f"{prefix}.0"),
        "fc1": _lin(sd, f"{prefix}.1"),
        "fc2": _lin(sd, f"{prefix}.3"),
    }


# ---------------------------------------------------------------------------
# PerceiverResampler (the reference's perceiver_resampler.py)
# ---------------------------------------------------------------------------


def convert_resampler(sd: Dict[str, np.ndarray], prefix: str = "") -> Params:
    """Names: ``latents``, ``time_pos_emb``, ``layers.{i}.0.*`` (attention),
    ``layers.{i}.1.*`` (ffw), ``norm.*``."""
    p = prefix
    depth = 0
    while f"{p}layers.{depth}.0.to_q.weight" in sd:
        depth += 1
    layers = []
    for i in range(depth):
        a = f"{p}layers.{i}.0"
        layers.append({
            "attn": {
                "norm_media": _ln(sd, f"{a}.norm_media"),
                "norm_latents": _ln(sd, f"{a}.norm_latents"),
                "to_q": _lin(sd, f"{a}.to_q"),
                "to_k": _lin(sd, f"{a}.to_k"),
                "to_v": _lin(sd, f"{a}.to_v"),
                "to_out": _lin(sd, f"{a}.to_out"),
            },
            "ffw": _ffw(sd, f"{p}layers.{i}.1"),
        })
    return {
        "latents": _j(sd[f"{p}latents"]),
        "time_pos_emb": _j(sd[f"{p}time_pos_emb"]),
        "layers": layers,
        "norm": _ln(sd, f"{p}norm"),
    }


# ---------------------------------------------------------------------------
# GatedCrossAttentionBlock (the reference's gated_cross_attention.py)
# ---------------------------------------------------------------------------


def convert_gated_xattn_block(sd: Dict[str, np.ndarray], prefix: str = "") -> Params:
    """Names: ``attn.norm.*``, ``attn.to_q/to_kv/to_out.weight``,
    ``alpha_attn``, ``ffw.{0,1,3}.*``, ``alpha_ffw``."""
    p = prefix
    return {
        "attn": {
            "norm": _ln(sd, f"{p}attn.norm"),
            "to_q": _lin(sd, f"{p}attn.to_q"),
            "to_kv": _lin(sd, f"{p}attn.to_kv"),
            "to_out": _lin(sd, f"{p}attn.to_out"),
        },
        "alpha_attn": _j(sd[f"{p}alpha_attn"]),
        "ffw": _ffw(sd, f"{p}ffw"),
        "alpha_ffw": _j(sd[f"{p}alpha_ffw"]),
    }


# ---------------------------------------------------------------------------
# GPT-2 trunk (HF GPT2Model names under ``transformer.``)
# ---------------------------------------------------------------------------


def convert_gpt2(sd: Dict[str, np.ndarray], prefix: str = "transformer.") -> Params:
    """HF GPT2Model: ``wte``, ``wpe``, ``h.{i}.{ln_1,attn.c_attn,attn.c_proj,
    ln_2,mlp.c_fc,mlp.c_proj}``, ``ln_f``. Conv1D weights are (in, out)
    already -> no transpose."""
    p = prefix
    n_layer = 0
    while f"{p}h.{n_layer}.ln_1.weight" in sd:
        n_layer += 1
    blocks = []
    for i in range(n_layer):
        b = f"{p}h.{i}"
        blocks.append({
            "ln_1": _ln(sd, f"{b}.ln_1"),
            "c_attn": _lin(sd, f"{b}.attn.c_attn", transpose=False),
            "c_proj": _lin(sd, f"{b}.attn.c_proj", transpose=False),
            "ln_2": _ln(sd, f"{b}.ln_2"),
            "mlp_fc": _lin(sd, f"{b}.mlp.c_fc", transpose=False),
            "mlp_proj": _lin(sd, f"{b}.mlp.c_proj", transpose=False),
        })
    return {
        "wte": _j(sd[f"{p}wte.weight"]),
        "wpe": _j(sd[f"{p}wpe.weight"]),
        "blocks": blocks,
        "ln_f": _ln(sd, f"{p}ln_f"),
    }


# ---------------------------------------------------------------------------
# OPT trunk (HF OPTModel names under ``model.``)
# ---------------------------------------------------------------------------


def convert_opt(sd: Dict[str, np.ndarray], prefix: str = "model.") -> Params:
    """HF OPTModel: ``decoder.embed_tokens``, ``decoder.embed_positions``
    (offset-2 learned positions), per-layer self_attn {k,v,q,out}_proj (+bias),
    self_attn_layer_norm, fc1, fc2, final_layer_norm; optional
    project_in/project_out (opt-350m); decoder.final_layer_norm."""
    p = f"{prefix}decoder."
    n_layer = 0
    while f"{p}layers.{n_layer}.self_attn.q_proj.weight" in sd:
        n_layer += 1
    layers = []
    for i in range(n_layer):
        b = f"{p}layers.{i}"
        layers.append({
            "attn_ln": _ln(sd, f"{b}.self_attn_layer_norm"),
            "q_proj": _lin(sd, f"{b}.self_attn.q_proj"),
            "k_proj": _lin(sd, f"{b}.self_attn.k_proj"),
            "v_proj": _lin(sd, f"{b}.self_attn.v_proj"),
            "out_proj": _lin(sd, f"{b}.self_attn.out_proj"),
            "final_ln": _ln(sd, f"{b}.final_layer_norm"),
            "fc1": _lin(sd, f"{b}.fc1"),
            "fc2": _lin(sd, f"{b}.fc2"),
        })
    out: Params = {
        "embed_tokens": _j(sd[f"{p}embed_tokens.weight"]),
        "embed_positions": _j(sd[f"{p}embed_positions.weight"]),
        "layers": layers,
    }
    if f"{p}final_layer_norm.weight" in sd:
        out["final_ln"] = _ln(sd, f"{p}final_layer_norm")
    if f"{p}project_in.weight" in sd:
        out["project_in"] = _lin(sd, f"{p}project_in")
    if f"{p}project_out.weight" in sd:
        out["project_out"] = _lin(sd, f"{p}project_out")
    return out


# ---------------------------------------------------------------------------
# CLIP ViT vision tower (HF CLIPVisionModel names under ``vision_model.``)
# ---------------------------------------------------------------------------


def convert_clip_vit(sd: Dict[str, np.ndarray], prefix: str = "vision_model.") -> Params:
    """HF CLIPVisionTransformer: embeddings {class_embedding,
    patch_embedding (conv, no bias), position_embedding}, pre_layrnorm,
    encoder.layers.{i}.{layer_norm1, self_attn.{q,k,v,out}_proj, layer_norm2,
    mlp.fc1, mlp.fc2}, post_layernorm.

    The patch conv weight ``(d, c, p, p)`` is reshaped to a patchify matmul
    matrix ``(p*p*c, d)``: patches are extracted with a reshape and
    embedded by one GEMM.
    """
    p = prefix
    n_layer = 0
    while f"{p}encoder.layers.{n_layer}.layer_norm1.weight" in sd:
        n_layer += 1
    layers = []
    for i in range(n_layer):
        b = f"{p}encoder.layers.{i}"
        layers.append({
            "ln_1": _ln(sd, f"{b}.layer_norm1"),
            "q_proj": _lin(sd, f"{b}.self_attn.q_proj"),
            "k_proj": _lin(sd, f"{b}.self_attn.k_proj"),
            "v_proj": _lin(sd, f"{b}.self_attn.v_proj"),
            "out_proj": _lin(sd, f"{b}.self_attn.out_proj"),
            "ln_2": _ln(sd, f"{b}.layer_norm2"),
            "fc1": _lin(sd, f"{b}.mlp.fc1"),
            "fc2": _lin(sd, f"{b}.mlp.fc2"),
        })
    conv_w = sd[f"{p}embeddings.patch_embedding.weight"]  # (d, c, ph, pw)
    d, c, ph, pw = conv_w.shape
    # patches are unfolded channel-last as (ph, pw, c) rows -> matmul matrix
    patch_w = np.transpose(conv_w, (2, 3, 1, 0)).reshape(ph * pw * c, d)
    return {
        "class_embedding": _j(sd[f"{p}embeddings.class_embedding"]),
        "patch_embedding": {"w": _j(patch_w)},
        "position_embedding": _j(sd[f"{p}embeddings.position_embedding.weight"]),
        "pre_layernorm": _ln(sd, f"{p}pre_layrnorm"),  # sic: HF's typo'd name
        "layers": layers,
        "post_layernorm": _ln(sd, f"{p}post_layernorm"),
    }


# ---------------------------------------------------------------------------
# Full Flamingo checkpoint (reference FlamingoModel state_dict)
# ---------------------------------------------------------------------------


def convert_flamingo(sd: Dict[str, np.ndarray], xattn_every: int, n_lm_layers: int) -> Params:
    """Convert a reference ``FlamingoModel`` state_dict.

    Reference layout (the reference's modeling_flamingo.py):
      flamingo.vision_encoder.vision_model.*      (may be absent: checkpoints
        exclude the vision tower, re-fetched at load; modeling_flamingo.py:376)
      flamingo.resampler.*
      flamingo.lm.*  — the trunk, where hijacked layers ``h.{i}`` become
        ``h.{i}.lm_block`` + ``h.{i}.xattn_block`` (GPT-2), or
        ``decoder.layers.{i}.{lm_block,xattn_block}`` (OPT)
      flamingo.lm_head.weight (tied to wte -> ignored)
    """
    is_opt = any(k.startswith("flamingo.lm.decoder.") for k in sd)
    layer_prefix = "flamingo.lm.decoder.layers" if is_opt else "flamingo.lm.h"

    # un-hijack: rewrite "{layer_prefix}.{i}.lm_block.X" -> "{layer_prefix}.{i}.X"
    # and collect xattn blocks
    lm_sd: Dict[str, np.ndarray] = {}
    xattn: Dict[str, Params] = {}
    for k, v in sd.items():
        if not k.startswith("flamingo.lm."):
            continue
        key = k[len("flamingo.lm."):]
        lm_sd[key] = v
    plain_sd: Dict[str, np.ndarray] = {}
    rel_layers = layer_prefix[len("flamingo.lm."):]  # "h" or "decoder.layers"
    for k, v in lm_sd.items():
        if k.startswith(rel_layers + "."):
            rest = k[len(rel_layers) + 1:]
            idx, _, tail = rest.partition(".")
            if tail.startswith("lm_block."):
                plain_sd[f"{rel_layers}.{idx}.{tail[len('lm_block.'):]}"] = v
            elif tail.startswith("xattn_block."):
                continue  # handled below
            else:
                plain_sd[k] = v
        else:
            plain_sd[k] = v

    for i in range(0, n_lm_layers, xattn_every):
        pref = f"flamingo.lm.{rel_layers}.{i}.xattn_block."
        sub = {k[len(pref):]: v for k, v in sd.items() if k.startswith(pref)}
        if sub:
            xattn[str(i)] = convert_gated_xattn_block(sub)

    if is_opt:
        lm = convert_opt(plain_sd, prefix="")
    else:
        lm = convert_gpt2(plain_sd, prefix="")

    out: Params = {
        "resampler": convert_resampler(
            {k[len("flamingo.resampler."):]: v for k, v in sd.items()
             if k.startswith("flamingo.resampler.")}),
        "lm": lm,
        "xattn": xattn,
    }
    if any(k.startswith("flamingo.vision_encoder.") for k in sd):
        out["vision"] = convert_clip_vit(
            {k[len("flamingo.vision_encoder."):]: v for k, v in sd.items()
             if k.startswith("flamingo.vision_encoder.")})
    return out
