"""Flamingo's media-masked cross-attention as one kernel.

Port of ``flamingo_mini_tpu/ops/pallas_xattn.py::fused_media_xattn``. The
CUDA entry point is ``csrc/media_xattn.cu``, routed by dtype: bf16 calls run
``csrc/media_xattn_sm90.cuh`` (a warp per 16-row slice of a (batch, head),
only the keys of the media a block's rows attend loaded, the whole needed
slab in flight at once, a one-pass softmax over resident scores; past 256
keys a block that needs more than its 16 tiles of shared memory streams
them) under the layout ``plan`` picks per shape; float32 calls run the
kMedia mode of
``csrc/attention_tile.cuh``. Each source note says what bounds the kernel
on the card and how the design answers that.

Semantics, as the TPU kernel's: scores ``scale * q.k`` in float32; key j is
valid for query i iff ``text_time[i] == j // n_visual + 1``, the rest set to
float32 min; max-subtracted float32 softmax; rows with ``text_time == 0``
zeroed; probabilities times V in float32, rounded once. A row whose
``text_time`` is past the media count is fully masked: its output is the
mean of V, not zero. The bf16 kernel does not read the keys of media a row
does not attend, so a NaN or inf in those keys' V leaves the row finite
where the TPU kernel's 0 x V makes it NaN (the source note's NaN contract).

``fused_media_xattn`` launches the kernel for CUDA tensors and runs its plain
version for CPU tensors; nothing else picks the path. It counts its
launches. On the card the inputs are read in place through their strides
(head dim 64). Where grad is enabled and q, k or v requires it, the call
runs through ``fused_attention.RecomputeBackward`` (the ``custom_vjp`` of
``pallas_xattn.py:74-119``): the kernel forward, and a backward that
differentiates ``fused_media_xattn_plain`` recomputed, ``text_time`` a
constant.
The bf16 kernel takes any number of keys; a call it refuses raises and
never runs the float32 tile.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .attention import softmax_f32
from .fused_attention import (HEAD_DIM, NEG, check_cuda, check_tile_grid, launch,
                              recompute_backward)

# the bf16 kernel (csrc/media_xattn_sm90.cuh): keys a tile (a P V k-step),
# the most tiles a block's shared memory holds, and a tile's K and V there
# (16 rows of 72 bf16 each)
TILE_KEYS = 16
MAX_SLOTS = 16
SLOT_BYTES = 2 * TILE_KEYS * 72 * 2


def fused_media_xattn_plain(q, k, v, text_time, *, scale: float,
                            n_visual: int) -> torch.Tensor:
    """Plain version (``pallas_xattn.py::_reference``)."""
    n_kv = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    media_time = torch.arange(n_kv, device=q.device) // n_visual + 1
    tt = text_time.to(torch.int32)[:, None, :, None]
    s = torch.where(tt == media_time, s, NEG)
    p = softmax_f32(s - s.amax(dim=-1, keepdim=True).detach())
    p = torch.where(tt == 0, 0.0, p)
    return torch.matmul(p, v.float()).to(q.dtype)


class Plan(NamedTuple):
    """The bf16 kernel's layout: a block holds ``slices`` 16-row slices of
    one (batch row, head), a warp each; ``slots`` the 16-key tiles of K and V
    its shared memory holds (``smem`` bytes), ``blocks`` the grid."""
    slices: int
    slots: int
    smem: int
    blocks: int


def make_plan(b: int, h: int, n_q: int, n_kv: int, *, slices: int) -> Plan:
    slots = min(-(-n_kv // TILE_KEYS), MAX_SLOTS)
    n_slices = -(-n_q // 16)
    return Plan(slices, slots, slots * SLOT_BYTES, b * h * -(-n_slices // slices))


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, n_q: int, n_kv: int) -> Plan:
    """The bf16 kernel's layout at one shape, cached: one slice a block
    under 32 rows (the prefill's 4 rows: 256 blocks), two sharing a slab
    from 32 rows (the forwards: 128 blocks). At every shape that
    ``profile_decode.py media_plans`` measured, this was within 0.0003 ms
    of the fastest layout (PERF.md §6 row 7)."""
    p = make_plan(b, h, n_q, n_kv, slices=2 if n_q >= 32 else 1)
    if p.blocks >= 2 ** 31:
        raise ValueError(f"fused_media_xattn: grid too large for {(b, h, n_q)}")
    return p


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
    check_cuda("fused_media_xattn", q, k, v, head_dims=(HEAD_DIM,))
    if n_visual < 1:
        raise ValueError(f"n_visual must be positive, got {n_visual}")
    if q.dtype == torch.bfloat16:
        layout = plan(b, h, n_q, k.shape[2]).slices
    else:
        check_tile_grid("fused_media_xattn", q)
        layout = 0
    tt = text_time.to(device=q.device, dtype=torch.int32).contiguous()

    def kernel(q, k, v, tt):
        fused_media_xattn.launches += 1
        return launch("fmt_media_xattn", q, k, v, scale=scale, text_time=tt,
                      n_visual=n_visual, plan=(layout,))

    def plain(q, k, v, tt):
        return fused_media_xattn_plain(q, k, v, tt, scale=scale, n_visual=n_visual)
    return recompute_backward(kernel, plain, q, k, v, tt)


fused_media_xattn.launches = 0
