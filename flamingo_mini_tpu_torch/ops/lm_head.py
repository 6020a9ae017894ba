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
# consumer warpgroups, ring stages, the hidden rows of a group and the
# shared memory the staged rows may take (the card tests hold smem_bytes
# against the kernel's own fmt_lm_head_smem)
TILE = 64
GROUPS = 4
RING = 16
MAX_N = 32
STAGE_BYTES = 96 * 1024
ROW_ALIGN = 16      # bytes: a TMA row stride, which pad_head_weights pads to


def n_chunks(D: int) -> int:
    """The 64-k weight chunks of a row of width D (the last zero-filled
    past D)."""
    return -(-D // TILE)


def group_n(rows: int) -> int:
    """The wgmma N of a group of ``rows`` hidden rows."""
    return -(-rows // 8) * 8


def slice_chunks(D: int, n: int) -> int:
    """The chunks of a K-slice of a group ``n`` rows wide (the kernel's
    ``slice_chunks``): every chunk where the group's staged rows fit
    ``STAGE_BYTES`` whole, else as many as fit."""
    return min(STAGE_BYTES // (n * 128), n_chunks(D))


def slices(D: int, rows: int):
    """The K-slices [(first chunk, chunks)] in which a group of ``rows``
    rows is staged: one where its rows fit whole."""
    nk, sk = n_chunks(D), slice_chunks(D, group_n(rows))
    return [(c0, min(sk, nk - c0)) for c0 in range(0, nk, sk)]


def smem_bytes(D: int, B: int) -> int:
    """The kernel's dynamic shared memory (its ``layout``): alignment, the
    ring, the first group's staged rows (a slice of them where they do not
    fit whole), the warps' best pairs, the barriers."""
    n = group_n(min(B, MAX_N))
    return 1024 + RING * TILE * TILE + n * slice_chunks(D, n) * 128 \
        + GROUPS * 4 * MAX_N * 8 + 2 * RING * 8


def schedule(block: int, blocks: int, n_tiles: int, D: int, B: int):
    """The kernel's deal for one block of the persistent grid, mirrored:
    (the producer's issue order, each consumer warpgroup's order), every
    entry ``(warpgroup, its chunk count so far, first row of the group,
    vocab tile, weight chunk)``; chunk j of warpgroup w lands in stage
    ``w * RING // GROUPS + j % (RING // GROUPS)`` of its own ring. The
    block takes tiles [block n / blocks, (block + 1) n / blocks); warpgroup
    w the share's tiles w, w + 4, ...; the producer, per row group and round
    of four tiles, each chunk of the round's tiles in turn. A group staged
    in K-slices is consumed in the same order, slice by slice."""
    t0, t1 = block * n_tiles // blocks, (block + 1) * n_tiles // blocks
    nk = n_chunks(D)
    producer, consumers = [], [[] for _ in range(GROUPS)]
    issued = [0] * GROUPS
    for r0 in range(0, B, MAX_N):
        for t in range(t0, t1, GROUPS):
            for c in range(nk):
                for w in range(min(GROUPS, t1 - t)):
                    producer.append((w, issued[w], r0, t + w, c))
                    issued[w] += 1
        for w in range(GROUPS):
            for tile in range(t0 + w, t1, GROUPS):
                for c0, nc in slices(D, min(MAX_N, B - r0)):
                    for c in range(c0, c0 + nc):
                        consumers[w].append((w, len(consumers[w]), r0, tile, c))
    return producer, consumers


def pad_head_weights(wq: Dict[str, torch.Tensor], block_v: int = 2048):
    """Pad {"w8": (V, D) int8, "scale": (V,) f32} rows to a multiple of
    ``block_v``, and, where a row of D int8 is not a multiple of
    ``ROW_ALIGN`` bytes (the kernel's TMA row stride), its columns with
    zeros to one: w8 (Vp, D rounded up to 16), of which the first D
    columns are the weights. Runs once per generate call, outside the
    decode loop."""
    V, D = wq["w8"].shape
    Vp = -(-V // block_v) * block_v
    w8 = torch.zeros((Vp, -(-D // ROW_ALIGN) * ROW_ALIGN), dtype=torch.int8,
                     device=wq["w8"].device)
    w8[:V, :D] = wq["w8"]
    scale = torch.zeros((1, Vp), dtype=torch.float32, device=wq["w8"].device)
    scale[0, :V] = wq["scale"].float()
    return {"w8": w8, "scale": scale}


def check_fits(D: int, B: int, device) -> None:
    """Refuse, before any work, a head the card cannot hold: ``B`` hidden
    rows of width ``D`` need ``fmt_lm_head_smem`` bytes of shared memory
    per block, past the card's opt-in limit a ``ValueError``. The kernel
    takes every width; on the CPU the plain version runs and nothing is
    checked."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    need = int(cuda_build.kernels().fmt_lm_head_smem(D, B))
    limit = int(torch.cuda.get_device_properties(device).shared_memory_per_block_optin)
    if need < 0 or need > limit:
        raise ValueError(f"lm_head_argmax: {B} rows of width {D} need {need} bytes of "
                         f"shared memory per block, past the card's limit of {limit}")


def lm_head_argmax_plain(w8: torch.Tensor, scale: torch.Tensor,
                         x: torch.Tensor, *, n_valid: int) -> torch.Tensor:
    """Plain PyTorch version: the kernel's oracle -> (B,) int32. w8 may
    carry zero columns past x's width (``pad_head_weights``)."""
    D = x.shape[-1]
    logits = torch.matmul(x.to(torch.bfloat16).float(), w8[:, :D].float().t())
    logits = (logits * scale.reshape(1, -1)).to(torch.bfloat16).float()
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = torch.where(cols[None, :] < n_valid, logits,
                         torch.full_like(logits, NEG))
    return torch.argmax(logits, dim=-1).to(torch.int32)


def lm_head_argmax(w8: torch.Tensor, scale: torch.Tensor, x: torch.Tensor,
                   *, n_valid: int) -> torch.Tensor:
    """Greedy next token over the tied int8 head -> (B,) int32.

    w8: (Vp, Dw) int8 padded rows (``pad_head_weights``: Dw is D, or D
    rounded up to 16 with zero columns); scale: (1, Vp) float32; x: (B, D)
    bf16 post-ln_f hidden rows.
    """
    Vp, Dw = w8.shape
    B, D = x.shape
    if x.device.type == "cpu":
        return lm_head_argmax_plain(w8, scale, x, n_valid=n_valid)
    if x.device.type != "cuda":
        raise ValueError(f"lm_head_argmax: unsupported device {x.device}")
    lib = cuda_build.kernels()
    rows = lib.fmt_lm_head_rows_per_block()
    if w8.dtype != torch.int8 or w8.device != x.device or not w8.is_contiguous():
        raise ValueError("lm_head_argmax: w8 must be contiguous int8 on "
                         "the same device")
    # whole vocab tiles; a weight row stride the TMA takes (pad_head_weights)
    if Vp % rows or Dw < D or Dw % ROW_ALIGN:
        raise ValueError(f"lm_head_argmax: needs Vp % {rows} == 0 and w8's rows "
                         f"padded to a multiple of {ROW_ALIGN} bytes, at least D wide "
                         f"(pad_head_weights), got w8 ({Vp}, {Dw}), D={D}")
    if scale.dtype != torch.float32 or scale.numel() != Vp \
            or scale.device != x.device or not scale.is_contiguous():
        raise ValueError("lm_head_argmax: scale must be contiguous float32 "
                         "(1, Vp) on the same device")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or B < 1:
        raise ValueError(f"lm_head_argmax: x must be contiguous bf16 (B, D), got {tuple(x.shape)}")
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
        part_idx.data_ptr(), out.data_ptr(), Vp, D, Dw, B, n_valid,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "lm_head_argmax", part_max)
    return out


lm_head_argmax.launches = 0
