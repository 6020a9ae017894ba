"""Decode-step attention over the T-major flat KV cache, greedy and beam.

Port of ``flamingo_mini_tpu/ops/pallas_decode.py::decode_attention`` and
``::decode_attention_beam``. Both CUDA kernels are in
``csrc/decode_attention.cu``; its source note says what bounds them on the
card and how the design answers that.

``decode_attention`` and ``decode_attention_beam`` launch their kernel for
CUDA tensors and run their plain version for CPU tensors; nothing else picks
the path. Each counts its own launches. Semantics (both paths): scores in
float32, scaled after the dot, positions valid iff ``npad[row] <= t <= cur``
(invalid ones filled with float32 min), float32 softmax, probabilities cast
to the cache dtype before the V product with float32 accumulation,
normalised at the end. Only the live prefix ``[0, min(kv_limit, T))`` is
read. A fully masked row comes out finite.

The beam variant is the lazy reorder of ``beam_search.py``: rows come in
families of ``kb`` cache rows that never move, and logical beam ``i`` of
family ``f`` attends cache row ``f * kb + j`` at position ``t`` iff
``anc[f, i, t] == j``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import cuda_build

NEG = float(torch.finfo(torch.float32).min)
HEAD_DIM = 64


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
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if D != n_head * HEAD_DIM:
        raise ValueError(f"CUDA decode_attention takes head dim {HEAD_DIM}, "
                         f"got D={D}, n_head={n_head}")
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
    out = torch.empty_like(q)
    lib = cuda_build.kernels()
    decode_attention.launches += 1
    err = lib.fmt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), npad.data_ptr(),
        out.data_ptr(), b, D, n_head, t_lim, cur, float(scale),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "decode_attention")
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
    if anc.device != q.device or not anc.is_contiguous():
        raise ValueError("decode_attention_beam: anc must be contiguous on "
                         "the same device")
    t_lim = max_len if kv_limit is None else min(kv_limit, max_len)
    out = torch.empty_like(q)
    lib = cuda_build.kernels()
    decode_attention_beam.launches += 1
    err = lib.fmt_decode_attention_beam(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), npad.data_ptr(),
        anc.data_ptr(), out.data_ptr(), B, D, n_head, t_lim, cur, float(scale),
        kb, anc.shape[2], int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "decode_attention_beam")
    return out


decode_attention_beam.launches = 0
