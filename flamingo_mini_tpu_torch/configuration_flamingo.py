"""Flamingo configuration: the port's own copy of the JAX package's.

The same ``FlamingoConfig`` fields and defaults, ``to_dict``/``from_dict``
(a HF-style ``config.json``), hashing by value, the ``GPT2Arch``,
``OPTArch`` and ``CLIPViTArch`` backbone descriptions, and the offline
tables that resolve the ``lm`` / ``clip_model_type`` hub names to them.

``FlamingoConfig.from_pretrained`` reads a local directory, a
``config.json`` path, or a hub id resolved against the local HF cache
(``utils/hub.py``; nothing is fetched).
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class GPT2Arch:
    """GPT-2 family architecture (HF ``GPT2Config`` subset)."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    activation: str = "gelu_new"
    bos_token_id: int = 50256
    eos_token_id: int = 50256
    family: str = "gpt2"
    # training-mode dropout rates (HF GPT2Config defaults)
    embd_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    attn_pdrop: float = 0.1


@dataclass
class OPTArch:
    """OPT family architecture (HF ``OPTConfig`` subset)."""

    vocab_size: int = 50272
    max_position_embeddings: int = 2048
    hidden_size: int = 768
    ffn_dim: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    word_embed_proj_dim: int = 768
    do_layer_norm_before: bool = True
    activation: str = "relu"
    layer_norm_epsilon: float = 1e-5
    bos_token_id: int = 2
    eos_token_id: int = 2
    family: str = "opt"
    # training-mode dropout (HF OPTConfig default)
    dropout: float = 0.1


@dataclass
class CLIPViTArch:
    """CLIP vision tower architecture (HF ``CLIPVisionConfig`` subset)."""

    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    layer_norm_epsilon: float = 1e-5
    activation: str = "quick_gelu"
    # CLIPImageProcessor normalisation constants
    image_mean: tuple = (0.48145466, 0.4578275, 0.40821073)
    image_std: tuple = (0.26862954, 0.26130258, 0.27577711)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + CLS token


# Known hub names -> architectures (offline tables).
_GPT2_ARCHS: Dict[str, Dict[str, Any]] = {
    "gpt2": dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-medium": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-large": dict(n_embd=1280, n_layer=36, n_head=20),
    "gpt2-xl": dict(n_embd=1600, n_layer=48, n_head=25),
}

_OPT_ARCHS: Dict[str, Dict[str, Any]] = {
    "facebook/opt-125m": dict(hidden_size=768, ffn_dim=3072, num_hidden_layers=12, num_attention_heads=12, word_embed_proj_dim=768),
    "facebook/opt-350m": dict(hidden_size=1024, ffn_dim=4096, num_hidden_layers=24, num_attention_heads=16, word_embed_proj_dim=512, do_layer_norm_before=False),
    "facebook/opt-1.3b": dict(hidden_size=2048, ffn_dim=8192, num_hidden_layers=24, num_attention_heads=32, word_embed_proj_dim=2048),
    "facebook/opt-2.7b": dict(hidden_size=2560, ffn_dim=10240, num_hidden_layers=32, num_attention_heads=32, word_embed_proj_dim=2560),
    "facebook/opt-6.7b": dict(hidden_size=4096, ffn_dim=16384, num_hidden_layers=32, num_attention_heads=32, word_embed_proj_dim=4096),
}

_CLIP_ARCHS: Dict[str, Dict[str, Any]] = {
    "openai/clip-vit-base-patch32": dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12, patch_size=32),
    "openai/clip-vit-base-patch16": dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12, patch_size=16),
    "openai/clip-vit-large-patch14": dict(hidden_size=1024, intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16, patch_size=14),
}


def resolve_lm_arch(lm: str, override: Optional[Dict[str, Any]] = None):
    """Resolve the decoder architecture from a hub name + optional overrides."""
    if lm.startswith("gpt"):
        base = dict(_GPT2_ARCHS.get(lm, _GPT2_ARCHS["gpt2"]))
        base.update(override or {})
        return GPT2Arch(**base)
    if lm.startswith("facebook/opt"):
        base = dict(_OPT_ARCHS.get(lm, _OPT_ARCHS["facebook/opt-125m"]))
        base.update(override or {})
        return OPTArch(**base)
    raise ValueError(f"unsupported language model {lm!r}")


def resolve_vision_arch(clip_model_type: str,
                        override: Optional[Dict[str, Any]] = None) -> CLIPViTArch:
    base = dict(_CLIP_ARCHS.get(clip_model_type,
                                _CLIP_ARCHS["openai/clip-vit-base-patch32"]))
    base.update(override or {})
    return CLIPViTArch(**base)


@dataclass
class FlamingoConfig:
    """Flamingo model configuration: the reference's 18 public fields with
    their defaults, plus explicit backbone overrides and the compute dtype."""

    lm: str = "gpt2"
    clip_model_type: str = "openai/clip-vit-base-patch32"
    dim: int = 1024
    dim_visual: int = 768
    xattn_every: int = 1
    xattn_dim_head: int = 64
    xattn_heads: int = 8
    xattn_ff_mult: int = 4
    xattn_act: str = "gelu"
    resampler_depth: int = 6
    resampler_dim_head: int = 64
    resampler_heads: int = 8
    resampler_num_latents: int = 64
    resampler_num_time_embeds: int = 4
    resampler_ff_mult: int = 4
    resampler_act: str = "gelu"
    freeze_language_model: bool = True
    freeze_vision_model: bool = True

    # Explicit backbone architectures; resolved from the hub-name tables
    # when left as None.
    lm_arch_overrides: Optional[Dict[str, Any]] = None
    vision_arch_overrides: Optional[Dict[str, Any]] = None
    # Compute dtype policy: 'bfloat16' (production) or 'float32' (parity).
    compute_dtype: str = "float32"
    # The JAX package's Pallas attention switch; kept so that one config
    # file serves both packages.
    use_pallas: bool = False
    # Extra HF config.json fields tolerated but ignored.
    extra: Dict[str, Any] = field(default_factory=dict, repr=False)

    def __hash__(self):
        return hash((json.dumps(self.to_dict(), sort_keys=True), self.compute_dtype))

    @property
    def lm_arch(self):
        return resolve_lm_arch(self.lm, self.lm_arch_overrides)

    @property
    def vision_arch(self) -> CLIPViTArch:
        return resolve_vision_arch(self.clip_model_type, self.vision_arch_overrides)

    _PUBLIC_FIELDS = (
        "lm", "clip_model_type", "dim", "dim_visual", "xattn_every",
        "xattn_dim_head", "xattn_heads", "xattn_ff_mult", "xattn_act",
        "resampler_depth", "resampler_dim_head", "resampler_heads",
        "resampler_num_latents", "resampler_num_time_embeds",
        "resampler_ff_mult", "resampler_act", "freeze_language_model",
        "freeze_vision_model",
    )

    def to_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in self._PUBLIC_FIELDS}
        if self.lm_arch_overrides:
            d["lm_arch_overrides"] = self.lm_arch_overrides
        if self.vision_arch_overrides:
            d["vision_arch_overrides"] = self.vision_arch_overrides
        d["model_type"] = "flamingo"
        return d

    def save_pretrained(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FlamingoConfig":
        known = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        kwargs = {k: v for k, v in d.items() if k in known}
        extra = {k: v for k, v in d.items() if k not in known}
        return cls(extra=extra, **kwargs)

    @classmethod
    def from_pretrained(cls, path: str) -> "FlamingoConfig":
        """``path``: a local directory holding ``config.json``, the
        ``config.json`` path itself, or a hub id resolved from the local HF
        cache."""
        from .utils.hub import resolve_checkpoint_dir
        path = resolve_checkpoint_dir(path)
        cfg_file = path if path.endswith(".json") else os.path.join(path, "config.json")
        with open(cfg_file) as f:
            return cls.from_dict(json.load(f))


__all__ = ["FlamingoConfig", "GPT2Arch", "OPTArch", "CLIPViTArch",
           "resolve_lm_arch", "resolve_vision_arch"]
