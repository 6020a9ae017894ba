"""The port's parameter tree -> a reference-layout HF checkpoint, port of
``flamingo_mini_tpu/utils/hf_export.py`` (the inverse of ``hf_weights``).

The reference's checkpoints follow the ``flamingo.*`` naming of its module
tree and exclude the vision tower; ``export_flamingo`` emits that layout,
so a checkpoint saved here loads into the reference and into
``hf_weights.convert_flamingo``. Linear ``w`` is ``(in, out)`` -> torch
``.weight`` ``(out, in)`` (transposed), except GPT-2's Conv1D, which stores
``(in, out)``. ``save_hf_checkpoint`` writes ``model.safetensors`` with the
port's own writer (``safetensors_io``), so no package is needed.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from .safetensors_io import save_file

Params = Dict[str, Any]


def _n(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _ln(out: Dict[str, np.ndarray], prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _n(p["scale"])
    out[f"{prefix}.bias"] = _n(p["bias"])


def _lin(out: Dict[str, np.ndarray], prefix: str, p: Params,
         transpose: bool = True) -> None:
    w = _n(p["w"])
    out[f"{prefix}.weight"] = w.T if transpose else w
    if "b" in p:
        out[f"{prefix}.bias"] = _n(p["b"])


def _ffw(out: Dict[str, np.ndarray], prefix: str, p: Params) -> None:
    """Inverse of hf_weights._ffw (the reference's utils.py:45-50 Sequential)."""
    _ln(out, f"{prefix}.0", p["norm"])
    _lin(out, f"{prefix}.1", p["fc1"])
    _lin(out, f"{prefix}.3", p["fc2"])


def export_resampler(p: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}latents"] = _n(p["latents"])
    out[f"{prefix}time_pos_emb"] = _n(p["time_pos_emb"])
    for i, layer in enumerate(p["layers"]):
        a = f"{prefix}layers.{i}.0"
        _ln(out, f"{a}.norm_media", layer["attn"]["norm_media"])
        _ln(out, f"{a}.norm_latents", layer["attn"]["norm_latents"])
        for name in ("to_q", "to_k", "to_v", "to_out"):
            _lin(out, f"{a}.{name}", layer["attn"][name])
        _ffw(out, f"{prefix}layers.{i}.1", layer["ffw"])
    _ln(out, f"{prefix}norm", p["norm"])
    return out


def export_gated_xattn_block(p: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _ln(out, f"{prefix}attn.norm", p["attn"]["norm"])
    for name in ("to_q", "to_kv", "to_out"):
        _lin(out, f"{prefix}attn.{name}", p["attn"][name])
    out[f"{prefix}alpha_attn"] = _n(p["alpha_attn"])
    _ffw(out, f"{prefix}ffw", p["ffw"])
    out[f"{prefix}alpha_ffw"] = _n(p["alpha_ffw"])
    return out


def export_gpt2(p: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of hf_weights.convert_gpt2; Conv1D weights untransposed."""
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}wte.weight"] = _n(p["wte"])
    out[f"{prefix}wpe.weight"] = _n(p["wpe"])
    for i, blk in enumerate(p["blocks"]):
        b = f"{prefix}h.{i}"
        _ln(out, f"{b}.ln_1", blk["ln_1"])
        _lin(out, f"{b}.attn.c_attn", blk["c_attn"], transpose=False)
        _lin(out, f"{b}.attn.c_proj", blk["c_proj"], transpose=False)
        _ln(out, f"{b}.ln_2", blk["ln_2"])
        _lin(out, f"{b}.mlp.c_fc", blk["mlp_fc"], transpose=False)
        _lin(out, f"{b}.mlp.c_proj", blk["mlp_proj"], transpose=False)
    _ln(out, f"{prefix}ln_f", p["ln_f"])
    return out


def export_opt(p: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Inverse of hf_weights.convert_opt."""
    d = f"{prefix}decoder."
    out: Dict[str, np.ndarray] = {}
    out[f"{d}embed_tokens.weight"] = _n(p["embed_tokens"])
    out[f"{d}embed_positions.weight"] = _n(p["embed_positions"])
    for i, blk in enumerate(p["layers"]):
        b = f"{d}layers.{i}"
        _ln(out, f"{b}.self_attn_layer_norm", blk["attn_ln"])
        for ours, theirs in (("q_proj", "q_proj"), ("k_proj", "k_proj"),
                             ("v_proj", "v_proj"), ("out_proj", "out_proj")):
            _lin(out, f"{b}.self_attn.{theirs}", blk[ours])
        _ln(out, f"{b}.final_layer_norm", blk["final_ln"])
        _lin(out, f"{b}.fc1", blk["fc1"])
        _lin(out, f"{b}.fc2", blk["fc2"])
    if "final_ln" in p:
        _ln(out, f"{d}final_layer_norm", p["final_ln"])
    if "project_in" in p:
        _lin(out, f"{d}project_in", p["project_in"])
    if "project_out" in p:
        _lin(out, f"{d}project_out", p["project_out"])
    return out


def export_clip_vit(p: Params, prefix: str = "vision_model.") -> Dict[str, np.ndarray]:
    """Inverse of hf_weights.convert_clip_vit (patchify matrix -> conv)."""
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}embeddings.class_embedding"] = _n(p["class_embedding"])
    pos = _n(p["position_embedding"])
    out[f"{prefix}embeddings.position_embedding.weight"] = pos
    d = pos.shape[-1]
    patch_w = _n(p["patch_embedding"]["w"])          # (ph*pw*c, d)
    c = 3
    ph = int(round((patch_w.shape[0] // c) ** 0.5))
    conv = patch_w.reshape(ph, ph, c, d).transpose(3, 2, 0, 1)
    out[f"{prefix}embeddings.patch_embedding.weight"] = conv
    _ln(out, f"{prefix}pre_layrnorm", p["pre_layernorm"])  # sic: HF's name
    for i, blk in enumerate(p["layers"]):
        b = f"{prefix}encoder.layers.{i}"
        _ln(out, f"{b}.layer_norm1", blk["ln_1"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(out, f"{b}.self_attn.{name}", blk[name])
        _ln(out, f"{b}.layer_norm2", blk["ln_2"])
        _lin(out, f"{b}.mlp.fc1", blk["fc1"])
        _lin(out, f"{b}.mlp.fc2", blk["fc2"])
    _ln(out, f"{prefix}post_layernorm", p["post_layernorm"])
    return out


def export_flamingo(params: Params, xattn_every: int,
                    include_vision: bool = False) -> Dict[str, np.ndarray]:
    """Emit a reference-layout ``FlamingoModel`` state dict.

    Hijacked layers ``i % xattn_every == 0`` become
    ``flamingo.lm.<layers>.{i}.{lm_block,xattn_block}.*``
    (reference gated_cross_attention.py:187-252 ModifiedLMBlock); the tied
    ``flamingo.lm_head.weight`` mirrors the token embedding. The vision
    tower is excluded by default — the reference's checkpoint convention
    (modeling_flamingo.py:376)."""
    lm = params["lm"]

    def has_quantized(node) -> bool:
        if isinstance(node, dict):
            return "w8" in node or any(has_quantized(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return any(has_quantized(v) for v in node)
        return False

    if has_quantized(params):
        raise ValueError(
            "export requires unquantized params: the model was quantized "
            "(quantize_int8); reload the bf16/f32 checkpoint to export in "
            "HF format")
    is_opt = "embed_tokens" in lm
    raw = export_opt(lm) if is_opt else export_gpt2(lm)
    layer_key = "decoder.layers." if is_opt else "h."
    n_layers = len(lm["layers" if is_opt else "blocks"])
    hijacked = {i for i in range(n_layers) if i % xattn_every == 0}

    out: Dict[str, np.ndarray] = {}
    for k, v in raw.items():
        if k.startswith(layer_key):
            rest = k[len(layer_key):]
            idx, _, tail = rest.partition(".")
            if int(idx) in hijacked:
                k = f"{layer_key}{idx}.lm_block.{tail}"
        out[f"flamingo.lm.{k}"] = v
    for idx, blk in params["xattn"].items():
        out.update(export_gated_xattn_block(
            blk, prefix=f"flamingo.lm.{layer_key}{int(idx)}.xattn_block."))
    out.update(export_resampler(params["resampler"],
                                prefix="flamingo.resampler."))
    embed = lm["embed_tokens"] if is_opt else lm["wte"]
    out["flamingo.lm_head.weight"] = _n(embed)  # weight-tied head
    if include_vision and "vision" in params:
        out.update(export_clip_vit(params["vision"],
                                   prefix="flamingo.vision_encoder.vision_model."))
    return out


def save_hf_checkpoint(state: Dict[str, np.ndarray], path: str) -> str:
    """Write ``state`` as ``model.safetensors`` in the directory ``path``;
    returns the file's path."""
    fn = os.path.join(path, "model.safetensors")
    save_file(state, fn)
    return fn
