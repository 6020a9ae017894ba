"""Flamingo's media-masked cross-attention as one kernel.

Port of ``flamingo_mini_tpu/ops/pallas_xattn.py::fused_media_xattn``. The
CUDA kernel is ``csrc/media_xattn.cu`` (the kMedia mode of
``csrc/attention_tile.cuh``, whose note says what bounds it on the card and
how the design answers that).

Semantics, as the TPU kernel's: scores ``scale * q.k`` in float32; key j is
valid for query i iff ``text_time[i] == j // n_visual + 1``, the rest set to
float32 min; max-subtracted float32 softmax; rows with ``text_time == 0``
zeroed; probabilities times V in float32, rounded once. A row whose
``text_time`` is past the media count is fully masked: its output is the
mean of V, not zero.

``fused_media_xattn`` launches the kernel for CUDA tensors and runs its plain
version for CPU tensors; nothing else picks the path. It counts its
launches. On the card the inputs are read in place through their strides
(head dim 64) and inputs that require grad raise, as ``fused_attention``'s.
"""
from __future__ import annotations

import torch

from .attention import softmax_f32
from .fused_attention import NEG, check_cuda, launch


def fused_media_xattn_plain(q, k, v, text_time, *, scale: float,
                            n_visual: int) -> torch.Tensor:
    """Plain version (``pallas_xattn.py::_reference``)."""
    n_kv = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    media_time = torch.arange(n_kv, device=q.device) // n_visual + 1
    tt = text_time.to(torch.int32)[:, None, :, None]
    s = torch.where(tt == media_time, s, NEG)
    p = softmax_f32(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(tt == 0, 0.0, p)
    return torch.matmul(p, v.float()).to(q.dtype)


def fused_media_xattn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      text_time: torch.Tensor, *, scale: float,
                      n_visual: int) -> torch.Tensor:
    """Media-masked xattn -> (b, h, n_token, d).

    q (b, h, n_token, d); k/v (b, h, n_media * n_visual, d); text_time
    (b, n_token) int: the media count at or before each token."""
    b, h, n_q, _ = q.shape
    if text_time.shape != (b, n_q):
        raise ValueError(f"text_time must be ({b}, {n_q}), got {tuple(text_time.shape)}")
    if q.device.type == "cpu":
        return fused_media_xattn_plain(q, k, v, text_time, scale=scale,
                                       n_visual=n_visual)
    check_cuda("fused_media_xattn", q, k, v)
    if n_visual < 1:
        raise ValueError(f"n_visual must be positive, got {n_visual}")
    tt = text_time.to(device=q.device, dtype=torch.int32).contiguous()
    fused_media_xattn.launches += 1
    return launch("fmt_media_xattn", q, k, v, scale=scale, text_time=tt,
                  n_visual=n_visual)


fused_media_xattn.launches = 0
