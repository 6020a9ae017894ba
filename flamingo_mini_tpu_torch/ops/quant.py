"""Weight-only int8 quantization for the decode path, and the int8 KV
cache's codes (``quantize_kv_write``, ``dequantize_kv``, ``quantize_kv_pair``).

Port of ``flamingo_mini_tpu/ops/quant.py``. Symmetric per-output-channel
scales::

    w8[:, j] = round(w[:, j] / s[j]),   s[j] = absmax(w[:, j]) / 127
    y = (x @ w8) * s            (float32 accumulation)

A quantized linear leaf is ``{"w8": int8 (d_in, d_out), "scale": float32
(d_out,)}`` (+ optional "b"); the tied embedding quantizes per row:
``{"w8": int8 (vocab, d), "scale": (vocab,)}``, serving both the gather and
the lm_head. ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

Params = Dict[str, Any]


def cast_params_bf16(params):
    """Cast float32 leaves to bfloat16 for inference; int8 scales stay
    float32 (any leaf under a key named "scale")."""

    def cast(node, is_scale=False):
        if isinstance(node, dict):
            return {k: cast(v, k == "scale") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(cast(v) for v in node)
        if isinstance(node, torch.Tensor) and node.dtype == torch.float32 \
                and not is_scale:
            return node.to(torch.bfloat16)
        return node

    return cast(params)


def quantize_weight(w: torch.Tensor, axis: int = 0) -> Params:
    """Symmetric int8 with per-channel scales (channels = the non-``axis``
    dim)."""
    s = w.float().abs().amax(dim=axis, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-8)
    w8 = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"w8": w8, "scale": s.squeeze(axis)}


def quantize_linear(p: Params) -> Params:
    out = quantize_weight(p["w"], axis=0)
    if "b" in p:
        out["b"] = p["b"]
    return out


def embed_lookup(q: Params, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Row gather from a per-row-quantized embedding."""
    return (q["w8"][ids].float() * q["scale"][ids][..., None]).to(dtype)


def quantize_gpt2_lm(lm: Params) -> Params:
    """Quantize the GPT-2 trunk's decode-path weights (blocks + tied
    embedding). LayerNorms, biases and wpe stay as they are."""
    out = dict(lm)
    out["wte_q"] = quantize_weight(lm["wte"], axis=1)
    out.pop("wte")
    out["blocks"] = [
        {
            "ln_1": b["ln_1"],
            "c_attn": quantize_linear(b["c_attn"]),
            "c_proj": quantize_linear(b["c_proj"]),
            "ln_2": b["ln_2"],
            "mlp_fc": quantize_linear(b["mlp_fc"]),
            "mlp_proj": quantize_linear(b["mlp_proj"]),
        }
        for b in lm["blocks"]
    ]
    return out


def quantize_ffw(f: Params) -> Params:
    return {"norm": f["norm"], "fc1": quantize_linear(f["fc1"]),
            "fc2": quantize_linear(f["fc2"])}


def quantize_xattn_blocks(xattn: Params) -> Params:
    """Quantize the gated-xattn blocks' linears (they run every decode step)."""
    out = {}
    for idx, blk in xattn.items():
        a = blk["attn"]
        out[idx] = {
            "attn": {"norm": a["norm"], "to_q": quantize_linear(a["to_q"]),
                     "to_kv": quantize_linear(a["to_kv"]),
                     "to_out": quantize_linear(a["to_out"])},
            "alpha_attn": blk["alpha_attn"],
            "ffw": quantize_ffw(blk["ffw"]),
            "alpha_ffw": blk["alpha_ffw"],
        }
    return out


def quantize_opt_lm(lm: Params) -> Params:
    """Quantize the OPT trunk's decode-path weights (layers + tied
    embedding). LayerNorms, biases, the position table and opt-350m's
    ``project_in`` / ``project_out`` stay as they are."""
    out = dict(lm)
    out["embed_tokens_q"] = quantize_weight(lm["embed_tokens"], axis=1)
    out.pop("embed_tokens")
    out["layers"] = [
        {
            "attn_ln": b["attn_ln"],
            "q_proj": quantize_linear(b["q_proj"]),
            "k_proj": quantize_linear(b["k_proj"]),
            "v_proj": quantize_linear(b["v_proj"]),
            "out_proj": quantize_linear(b["out_proj"]),
            "final_ln": b["final_ln"],
            "fc1": quantize_linear(b["fc1"]),
            "fc2": quantize_linear(b["fc2"]),
        }
        for b in lm["layers"]
    ]
    return out


# ---------------------------------------------------------------------------
# int8 KV: per-position symmetric scales over the head dim (absmax / 127).
# The codes divide by the float32 scale; the stored scale, which the
# dequantize multiplies by, is that scale rounded to bf16.
# ---------------------------------------------------------------------------


def quantize_kv_write(x: torch.Tensor):
    """(..., n, d) -> (int8 values, per-position scales (..., n, 1) bf16)."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    x8 = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return x8, s.to(torch.bfloat16)


def dequantize_kv(x8: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """int8 values times their scales, in ``dtype``."""
    return x8.to(dtype) * s.to(dtype)


def quantize_kv_pair(kv) -> Params:
    """(k, v) -> {"k8", "ks", "v8", "vs"} (the per-sequence xattn K/V)."""
    k, v = kv
    k8, ks = quantize_kv_write(k)
    v8, vs = quantize_kv_write(v)
    return {"k8": k8, "ks": ks, "v8": v8, "vs": vs}
