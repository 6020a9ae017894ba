"""Fused int8 lm_head + greedy argmax.

Port of ``flamingo_mini_tpu/ops/pallas_lmhead.py`` (``lm_head_argmax`` and
``pad_head_weights``). The CUDA kernel is ``csrc/lm_head_argmax.cu``; its
source note says what bounds it on the card and how the design answers
that.

``lm_head_argmax`` launches the kernel for CUDA tensors and runs
``lm_head_argmax_plain`` for CPU tensors; nothing else picks the path.
Semantics (both paths), as ``models/gpt2.lm_head`` followed by argmax::

    logits = (x @ w8^T)_f32 * scale          (per-row dequant, float32)
    logits = bf16(logits)                    (the head's output dtype)
    tok    = argmax_f32(logits)              (first index on ties)

with padded rows ``>= n_valid`` at float32 min, so they never win. NaN
logits are undefined behaviour, as in the JAX kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import cuda_build

NEG = float(torch.finfo(torch.float32).min)
# a mirror of the CUDA kernel's shape (csrc/lm_head_argmax.cu), for the
# CPU tests of its deal: vocab rows per tile and k per weight chunk,
# consumer warpgroups, ring stages, the most hidden rows of a group and the
# shared memory the staged rows may take (the card tests hold smem_bytes
# and MAX_D against the kernel's own fmt_lm_head_smem)
TILE = 64
GROUPS = 4
RING = 16
MAX_N = 32
STAGE_BYTES = 96 * 1024
MAX_D = STAGE_BYTES // (2 * 8)   # the widest hidden row it stages 8 of


def group_rows(D: int) -> int:
    """Hidden rows of a group: ``MAX_N``, fewer (a multiple of 8) where
    ``MAX_N`` rows of D would outgrow ``STAGE_BYTES`` (the kernel's
    ``group_rows``)."""
    return min(STAGE_BYTES // (2 * D) // 8 * 8, MAX_N)


def smem_bytes(D: int, B: int) -> int:
    """The kernel's dynamic shared memory (its ``layout``): alignment, the
    ring, the first group's staged rows, the warps' best pairs, the
    barriers."""
    n = -(-min(B, group_rows(D)) // 8) * 8
    return 1024 + RING * TILE * TILE + n * (D // TILE) * 128 + GROUPS * 4 * MAX_N * 8 \
        + 2 * RING * 8


def schedule(block: int, blocks: int, n_tiles: int, D: int, B: int):
    """The kernel's deal for one block of the persistent grid, mirrored:
    (the producer's issue order, each consumer warpgroup's order), every
    entry ``(warpgroup, its chunk count so far, first row of the group,
    vocab tile, weight chunk)``; chunk j of warpgroup w lands in stage
    ``w * RING // GROUPS + j % (RING // GROUPS)`` of its own ring. The
    block takes tiles [block n / blocks, (block + 1) n / blocks); warpgroup
    w the share's tiles w, w + 4, ...; the producer, per row group and round
    of four tiles, each chunk of the round's tiles in turn."""
    t0, t1 = block * n_tiles // blocks, (block + 1) * n_tiles // blocks
    nk, rows = D // TILE, group_rows(D)
    producer, consumers = [], [[] for _ in range(GROUPS)]
    issued = [0] * GROUPS
    for r0 in range(0, B, rows):
        for t in range(t0, t1, GROUPS):
            for c in range(nk):
                for w in range(min(GROUPS, t1 - t)):
                    producer.append((w, issued[w], r0, t + w, c))
                    issued[w] += 1
        for w in range(GROUPS):
            for tile in range(t0 + w, t1, GROUPS):
                for c in range(nk):
                    consumers[w].append((w, len(consumers[w]), r0, tile, c))
    return producer, consumers


def pad_head_weights(wq: Dict[str, torch.Tensor], block_v: int = 2048):
    """Pad {"w8": (V, D) int8, "scale": (V,) f32} rows to a multiple of
    ``block_v``. Runs once per generate call, outside the decode loop."""
    V, D = wq["w8"].shape
    Vp = -(-V // block_v) * block_v
    w8 = torch.zeros((Vp, D), dtype=torch.int8, device=wq["w8"].device)
    w8[:V] = wq["w8"]
    scale = torch.zeros((1, Vp), dtype=torch.float32, device=wq["w8"].device)
    scale[0, :V] = wq["scale"].float()
    return {"w8": w8, "scale": scale}


def lm_head_argmax_plain(w8: torch.Tensor, scale: torch.Tensor,
                         x: torch.Tensor, *, n_valid: int) -> torch.Tensor:
    """Plain PyTorch version: the kernel's oracle -> (B,) int32."""
    logits = torch.matmul(x.to(torch.bfloat16).float(), w8.float().t())
    logits = (logits * scale.reshape(1, -1)).to(torch.bfloat16).float()
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(cols[None, :] < n_valid, logits,
                         torch.full_like(logits, NEG))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def lm_head_argmax(w8: torch.Tensor, scale: torch.Tensor, x: torch.Tensor,
                   *, n_valid: int) -> torch.Tensor:
    """Greedy next token over the tied int8 head -> (B,) int32.

    w8: (Vp, D) int8 padded rows; scale: (1, Vp) float32; x: (B, D) bf16
    post-ln_f hidden rows.
    """
    Vp, D = w8.shape
    B = x.shape[0]
    if x.device.type == "cpu":
        return lm_head_argmax_plain(w8, scale, x, n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"lm_head_argmax: unsupported device {x.device}")
    lib = cuda_build.kernels()
    rows = lib.fmt_lm_head_rows_per_block()
    if w8.dtype != torch.int8 or w8.device != x.device or not w8.is_contiguous():
        raise ValueError("lm_head_argmax: w8 must be contiguous int8 on "
                         "the same device")
    # whole vocab tiles; the kernel says which widths it takes (whole 64-k
    # weight chunks, at least 8 hidden rows staged)
    if Vp % rows or lib.fmt_lm_head_smem(D, 1) < 0:
        raise ValueError(f"lm_head_argmax: needs Vp % {rows} == 0 and a width the "
                         f"kernel takes (D % 64 == 0, D <= {MAX_D}), got Vp={Vp}, D={D}")
    if scale.dtype != torch.float32 or scale.numel() != Vp \
            or scale.device != x.device or not scale.is_contiguous():
        raise ValueError("lm_head_argmax: scale must be contiguous float32 "
                         "(1, Vp) on the same device")
    if x.dtype != torch.bfloat16 or x.shape != (B, D) or not x.is_contiguous():
        raise ValueError(f"lm_head_argmax: x must be contiguous bf16 ({B}, {D})")
    if not 0 < n_valid <= Vp:
        raise ValueError(f"lm_head_argmax: n_valid={n_valid} outside (0, {Vp}]")
    # one (max, index) pair per row from each block of the persistent grid
    # (at most one block per vocab tile)
    n_tiles = Vp // rows
    part_max = torch.empty((n_tiles, B), dtype=torch.float32, device=x.device)
    part_idx = torch.empty((n_tiles, B), dtype=torch.int32, device=x.device)
    out = torch.empty((B,), dtype=torch.int32, device=x.device)
    lm_head_argmax.launches += 1
    err = lib.fmt_lm_head_argmax(
        w8.data_ptr(), scale.data_ptr(), x.data_ptr(), part_max.data_ptr(),
        part_idx.data_ptr(), out.data_ptr(), Vp, D, B, n_valid,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "lm_head_argmax")
    return out


lm_head_argmax.launches = 0
