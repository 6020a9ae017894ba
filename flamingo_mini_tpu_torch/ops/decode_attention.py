"""Decode-step attention over the T-major flat KV cache, greedy and beam.

Port of ``flamingo_mini_tpu/ops/pallas_decode.py::decode_attention`` and
``::decode_attention_beam``. Both CUDA kernels are in
``csrc/decode_attention.cu``; its source note says what bounds them on the
card and how the design answers that: the live prefix split across blocks
(flash-decoding), each block's whole K/V slab issued at once by 16-byte
``cp.async``, and the splits' partials folded in split order by a second
small launch. ``plan`` picks, per shape, the heads a block holds, the
splits and the slots a split holds, and is cached per shape. The kernels
take head widths 16, 32, 64, 80 and 128 (``HEAD_DIMS``): GPT-2 and OPT up
to 1.3B are 64 wide, opt-2.7b 80, opt-6.7b 128, the narrow test-scale
models 16 or 32; a CUDA call at any other width raises.

``decode_attention`` and ``decode_attention_beam`` launch their kernel for
CUDA tensors and run their plain version for CPU tensors; nothing else picks
the path. Each counts its own launches, one per call. Semantics (both
paths): scores in float32, scaled after the dot, positions valid iff
``npad[row] <= t <= cur`` (invalid ones filled with float32 min), float32
softmax, probabilities cast to the cache dtype before the V product with
float32 accumulation, normalised at the end. Only the live prefix
``[0, min(kv_limit, T))`` is read. A fully masked row comes out finite. The
kernels round the probabilities against a split's own max, the plain
versions against the row's: bf16 outputs agree to 2 bf16 ulps of the
output's scale, float32 ones to 1e-5.

The beam variant is the lazy reorder of ``beam_search.py``: rows come in
families of ``kb`` cache rows that never move, and logical beam ``i`` of
family ``f`` attends cache row ``f * kb + j`` at position ``t`` iff
``anc[f, i, t] == j``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Union

import torch

from . import cuda_build

NEG = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (16, 32, 64, 80, 128)   # the head widths the kernels take
HEAD_DIM = 64               # flamingo-mini's (the plan's default)
# H100 SXM: streaming multiprocessors, shared memory an SM holds (228 KB)
# and a block may take (227 KB) less the kernel's static arrays (2 KB);
# the registers the kernel takes a thread at most (ptxas: 40-57)
SM_COUNT = 132
SM_SMEM = 233472
STATIC_SMEM = 2048
SMEM_LIMIT = 232448 - STATIC_SMEM
REGISTERS = 64
MAX_WARPS = 16
MAX_SPLITS = 32
MAX_BEAMS = 32      # the family rows a block holds (kMaxRows in the source)
# a split's second launch in slots a warp walks (about 1.8 us over about
# 18 ns on the H100; the sweep of ``profile_decode.py attn_plans``, PERF.md)
SPLIT_COST = 100


def decode_attention_plain(q, k_cache, v_cache, npad, cur: int, *,
                           n_head: int, scale: float,
                           kv_limit: Optional[int] = None,
                           acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: the kernel's oracle, shapes as the kernel's.
    ``acc_dtype`` float64: the dot products, the softmax denominator and
    the V sums are summed in float64 and rounded once to float32 (the
    megakernel's attention, whose sums so do not depend on their order)."""
    max_len, b, D = k_cache.shape
    dh = D // n_head
    T = max_len if kv_limit is None else min(kv_limit, max_len)
    k = k_cache[:T].reshape(T, b, n_head, dh).permute(1, 2, 0, 3).to(acc_dtype)
    v = v_cache[:T].reshape(T, b, n_head, dh).permute(1, 2, 0, 3)
    qh = q.reshape(b, n_head, 1, dh).to(acc_dtype)
    s = torch.matmul(qh, k.transpose(-1, -2)).float() * scale  # (b, h, 1, T)
    t_pos = torch.arange(T, device=q.device)
    valid = (t_pos[None, :] >= npad[:, None]) & (t_pos[None, :] <= cur)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.to(acc_dtype).sum(dim=-1, keepdim=True).float()
    o = torch.matmul(p.to(v.dtype).to(acc_dtype), v.to(acc_dtype)).float()
    o = o / torch.clamp(l, min=1e-30)
    return o.permute(0, 2, 1, 3).reshape(b, D).to(q.dtype)


def _check_cuda(q, k_cache, v_cache, npad, n_head: int) -> None:
    """The checks both CUDA kernels make of their common inputs."""
    max_len, b, D = k_cache.shape
    if D // n_head not in HEAD_DIMS:
        raise ValueError(f"CUDA decode_attention takes head dims {HEAD_DIMS}, "
                         f"got D={D}, n_head={n_head}")
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode_attention: unsupported dtype {q.dtype}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype or t.device != q.device or t.shape != k_cache.shape:
            raise ValueError(f"decode_attention: {name} must be {q.dtype} "
                             f"{tuple(k_cache.shape)} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if q.shape != (b, D) or not q.is_contiguous():
        raise ValueError(f"decode_attention: q must be contiguous ({b}, {D})")
    if npad.shape != (b,) or npad.dtype != torch.int32 \
            or npad.device != q.device or not npad.is_contiguous():
        raise ValueError("decode_attention: npad must be contiguous int32 (b,) "
                         "on the same device")


class Plan(NamedTuple):
    """One launch's layout: a block holds ``heads`` adjacent heads of a
    family's rows over ``positions`` slots of the live prefix, ``splits``
    blocks along it, ``warps`` warps a block; ``smem`` its dynamic shared
    memory in bytes, ``blocks`` the grid, ``pairs`` the (beam, head) pairs
    a block's warps take, ``head_dim`` the head width."""
    heads: int
    splits: int
    positions: int
    warps: int
    smem: int
    blocks: int
    pairs: int
    head_dim: int = HEAD_DIM

    @property
    def part_stride(self) -> int:
        """Floats of one split's partial in the scratch: ``head_dim``
        sums, max, sum, pad to 16 bytes."""
        return self.head_dim + 4


def plan_smem(kb: int, heads: int, positions: int, itemsize: int,
              beam: bool, head_dim: int = HEAD_DIM) -> int:
    """Dynamic shared memory of a block (``smem_bytes`` in the source): K
    and V slabs of ``kb * positions`` (row, slot)s of ``heads * head_dim``
    values, q of the ``kb`` rows, a float score per (row, head, slot);
    beam: the ancestry (int32) and a need flag (byte) per (row, slot)."""
    slab = heads * head_dim * itemsize
    n = kb * positions
    return 2 * n * slab + kb * slab + 4 * n * heads + (5 * n if beam else 0)


def make_plan(rows: int, n_head: int, t_lim: int, itemsize: int, *, kb: int,
              beam: bool, heads: int, splits: int, head_dim: int = HEAD_DIM) -> Plan:
    """The plan of ``heads`` heads a block and (at most) ``splits`` splits:
    equal splits of ``ceil(t_lim / splits)`` slots, the last one ragged."""
    positions = -(-t_lim // splits)
    splits = -(-t_lim // positions)
    chunks = heads * head_dim * itemsize // 16     # 16-byte chunks a (row, slot)
    step = chunks // math.gcd(32, chunks)          # warps whose threads hold whole
    warps = min(MAX_WARPS, kb * heads)             # chunk columns; a (beam, head)
    warps = -(-warps // step) * step               # pair a warp
    if warps > MAX_WARPS:
        warps -= step
    return Plan(heads, splits, positions, warps,
                plan_smem(kb, heads, positions, itemsize, beam, head_dim),
                (rows // kb) * (n_head // heads) * splits, kb * heads, head_dim)


def resident(p: Plan) -> int:
    """Blocks of the plan an SM holds at once: bounded by its 228 KB of
    shared memory (the block's dynamic and static arrays and 1 KB the card
    reserves a block), its 2,048 threads, its 65,536 registers (at most
    REGISTERS a thread) and 32 blocks."""
    return min(32, 64 // p.warps, 65536 // (REGISTERS * 32 * p.warps),
               SM_SMEM // (p.smem + STATIC_SMEM + 1024))


def waves(p: Plan, n_sm: int = SM_COUNT) -> int:
    """Waves of the grid: blocks over the blocks the card holds at once."""
    return -(-p.blocks // (n_sm * resident(p)))


def rank(p: Plan, n_sm: int = SM_COUNT):
    """The plan's sort key, least first. A grid the card holds in one wave
    with a block for every SM: the fewest splits (a split's combine is a
    second launch, about 1.8 us), then the most blocks. Any other grid
    after those, by the slots each warp walks (each of its pairs' in turn,
    once a wave), plus SPLIT_COST for a split (a slot walked costs about
    18 ns), then the most blocks."""
    if waves(p, n_sm) == 1 and p.blocks >= n_sm:
        return (0, p.splits, -p.blocks)
    rounds = -(-p.pairs // p.warps)        # (beam, head) pairs a warp takes in turn
    walk = waves(p, n_sm) * rounds * p.positions
    return (1, walk + SPLIT_COST * (p.splits > 1), -p.blocks)


@functools.lru_cache(maxsize=None)
def plan(rows: int, n_head: int, t_lim: int, itemsize: int, *, kb: int = 1,
         beam: bool = False, n_sm: int = SM_COUNT, head_dim: int = HEAD_DIM) -> Plan:
    """The kernel's layout at one shape, cached: ``rows`` query rows in
    families of ``kb`` (1 greedy), ``t_lim`` slots of live prefix, heads
    ``head_dim`` wide. Of the
    plans of 4, 2 or 1 heads a block and 1 to MAX_SPLITS splits whose
    shared memory fits, the first by ``rank``. At the decode paths' shapes
    that is an unsplit grid of one head a block: the whole slab in flight
    in one wave (PERF.md §6)."""
    plans = [p for heads in (4, 2, 1) if n_head % heads == 0
             for splits in range(1, min(MAX_SPLITS, t_lim) + 1)
             for p in [make_plan(rows, n_head, t_lim, itemsize, kb=kb, beam=beam,
                                 heads=heads, splits=splits, head_dim=head_dim)]
             if p.splits == splits and p.smem <= SMEM_LIMIT]
    if not plans:
        raise ValueError(f"decode_attention: no plan fits {rows} rows of "
                         f"{n_head} heads over {t_lim} slots")
    return min(plans, key=lambda p: rank(p, n_sm))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(q, k_cache, v_cache, npad, anc, cur: int, *, n_head: int,
            scale: float, kb: int, t_lim: int, p: Plan) -> torch.Tensor:
    """Launch the greedy kernel (``anc`` None) or the beam kernel on checked
    inputs under the plan ``p`` -> out. Raises before the launch where the
    plan or an input breaks a rule the kernel keeps."""
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte aligned")
    if p.head_dim * n_head != q.shape[1]:
        raise ValueError(f"decode_attention: {p} is for heads {p.head_dim} wide, the "
                         f"inputs' are {q.shape[1] // n_head}")
    if p.smem > SMEM_LIMIT:
        raise ValueError(f"decode_attention: {p} takes {p.smem} bytes of shared "
                         f"memory, over {SMEM_LIMIT}")
    rows, D = q.shape
    scratch = None
    if p.splits > 1:
        scratch = torch.empty(rows * n_head * p.splits * p.part_stride,
                              dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lib = cuda_build.kernels()
    tail = (int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
            None if scratch is None else scratch.data_ptr(), p.heads, p.splits,
            p.positions, p.warps)
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), npad.data_ptr())
    if anc is None:
        err = lib.fmt_decode_attention(*ptrs, out.data_ptr(), rows, D, n_head, t_lim,
                                       cur, float(scale), *tail)
    else:
        err = lib.fmt_decode_attention_beam(*ptrs, anc.data_ptr(), out.data_ptr(), rows,
                                            D, n_head, t_lim, cur, float(scale), kb,
                                            anc.shape[2], *tail)
    name = "decode_attention" if anc is None else "decode_attention_beam"
    cuda_build.check(err, name, out)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, npad: torch.Tensor,
                     cur: Union[int, torch.Tensor], *, n_head: int,
                     scale: float,
                     kv_limit: Optional[int] = None) -> torch.Tensor:
    """Single-token attention -> (b, D).

    q: (b, D) current query (unscaled); k_cache/v_cache: (T, b, D) T-major
    flat caches; npad: (b,) int32 first real slot per row; cur: last valid
    slot (the current write position).
    """
    max_len, b, D = k_cache.shape
    if D % n_head:
        raise ValueError(f"D={D} is not a multiple of n_head={n_head}")
    if max_len % 16:
        raise ValueError(f"flat cache length must be a multiple of 16, got {max_len}")
    cur = int(cur)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, npad, cur,
                                      n_head=n_head, scale=scale,
                                      kv_limit=kv_limit)
    _check_cuda(q, k_cache, v_cache, npad, n_head)
    t_lim = max_len if kv_limit is None else min(kv_limit, max_len)
    p = plan(b, n_head, t_lim, q.element_size(), n_sm=_sm_count(q.device),
             head_dim=D // n_head)
    out = _launch(q, k_cache, v_cache, npad, None, cur, n_head=n_head,
                  scale=scale, kb=1, t_lim=t_lim, p=p)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _pad_anc(anc: torch.Tensor, max_len: int) -> torch.Tensor:
    """Ancestry shorter than the cache, padded with zeros (positions past
    the table are past ``cur`` and masked anyway)."""
    if anc.shape[2] >= max_len:
        return anc
    return torch.nn.functional.pad(anc, (0, max_len - anc.shape[2]))


def decode_attention_beam_plain(q, k_cache, v_cache, anc, npad, cur: int, *,
                                n_head: int, scale: float, kb: int,
                                kv_limit: Optional[int] = None,
                                acc_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """Plain PyTorch version: the kernel's oracle, with the semantics of
    ``decode_attention_beam_reference``: each logical beam scores all kb
    rows of its family and masks those that are not its ancestor, so a row
    whose range ``[npad, cur]`` is empty is uniform over the family.
    ``acc_dtype``: as ``decode_attention_plain``'s."""
    max_len, B, D = k_cache.shape
    b, dh = B // kb, D // n_head
    anc = _pad_anc(anc, max_len)
    T = max_len if kv_limit is None else min(kv_limit, max_len)
    # (b, kb_j, h, T, dh): the family's physical rows
    k = k_cache[:T].reshape(T, b, kb, n_head, dh).permute(1, 2, 3, 0, 4).to(acc_dtype)
    v = v_cache[:T].reshape(T, b, kb, n_head, dh).permute(1, 2, 3, 0, 4)
    qh = q.reshape(b, kb, n_head, dh).to(acc_dtype)
    s = torch.einsum("bihd,bjhtd->bihjt", qh, k).float() * scale
    t_pos = torch.arange(T, device=q.device)
    own = anc[:, :, :T][:, :, None, :] == \
        torch.arange(kb, device=q.device)[None, None, :, None]     # (b, i, j, t)
    valid = own & (t_pos <= cur) & \
        (t_pos >= npad.reshape(b, kb)[:, :, None, None])
    s = torch.where(valid[:, :, None], s, torch.full_like(s, NEG))
    sf = s.reshape(b, kb, n_head, kb * T)
    p = torch.exp(sf - sf.amax(dim=-1, keepdim=True))
    l = p.to(acc_dtype).sum(dim=-1, keepdim=True).float()
    p = p.to(v.dtype).to(acc_dtype).reshape(b, kb, n_head, kb, T)
    o = torch.einsum("bihjt,bjhtd->bihd", p, v.to(acc_dtype)).float() / l
    return o.reshape(B, D).to(q.dtype)


def decode_attention_beam(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, anc: torch.Tensor,
                          npad: torch.Tensor, cur: Union[int, torch.Tensor], *,
                          n_head: int, scale: float, kb: int,
                          kv_limit: Optional[int] = None) -> torch.Tensor:
    """Lazy-beam single-token attention -> (b * kb, D).

    q: (b * kb, D) one query per logical beam (unscaled); k_cache/v_cache:
    (T, b * kb, D) T-major flat caches whose rows never move; anc:
    (b, kb, anc_len) int32 ancestry table (zero-padded when shorter than
    the cache); npad: (b * kb,) int32 first real slot per row; cur: last
    valid slot (the current write position).
    """
    max_len, B, D = k_cache.shape
    if D % n_head:
        raise ValueError(f"D={D} is not a multiple of n_head={n_head}")
    if max_len % 16:
        raise ValueError(f"flat cache length must be a multiple of 16, got {max_len}")
    if anc.dim() != 3 or anc.shape[1] != kb or anc.shape[0] * kb != B:
        raise ValueError(f"decode_attention_beam: anc must be ({B // max(kb, 1)}, "
                         f"{kb}, anc_len), got {tuple(anc.shape)}")
    if anc.dtype != torch.int32:
        raise ValueError(f"decode_attention_beam: anc must be int32, got {anc.dtype}")
    cur = int(cur)
    if q.device.type == "cpu":
        return decode_attention_beam_plain(q, k_cache, v_cache, anc, npad, cur,
                                           n_head=n_head, scale=scale, kb=kb,
                                           kv_limit=kv_limit)
    _check_cuda(q, k_cache, v_cache, npad, n_head)
    if kb > MAX_BEAMS:
        raise ValueError(f"CUDA decode_attention_beam takes at most {MAX_BEAMS} "
                         f"beams, got {kb}")
    if anc.device != q.device or not anc.is_contiguous():
        raise ValueError("decode_attention_beam: anc must be contiguous on "
                         "the same device")
    t_lim = max_len if kv_limit is None else min(kv_limit, max_len)
    p = plan(B, n_head, t_lim, q.element_size(), kb=kb, beam=True,
             n_sm=_sm_count(q.device), head_dim=D // n_head)
    out = _launch(q, k_cache, v_cache, npad, anc, cur, n_head=n_head,
                  scale=scale, kb=kb, t_lim=t_lim, p=p)
    decode_attention_beam.launches += 1
    return out


decode_attention_beam.launches = 0
