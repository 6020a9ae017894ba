"""Ring attention: exact causal attention with the sequence split over a
process group, port of ``flamingo_mini_tpu/parallel/ring_attention.py``.

Each rank holds one contiguous chunk of the sequence: its queries and the
K, V and padding mask of the same positions. At ring step s it attends its
queries to the chunk of rank ``(r - s) mod n`` under the causal mask of the
absolute positions, folds the result into float32 online-softmax
accumulators, and passes the K, V and mask chunks on to the next rank
(``comm.ring_shift``). Chunks wholly after the rank's queries are masked
out entirely and skipped; the result is JAX's (which attends them and adds
nothing). A query row whose every visible key is padding gives 0, as in
JAX.

The backward (``torch.autograd.Function``) is a second ring: dq stays with
its queries; dk and dv travel with their K/V chunk and, after n steps, are
back at the rank that owns it. The softmax is recomputed per chunk from the
forward's row maxima and sums.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import comm

NEG = float(torch.finfo(torch.float32).min)


def _valid(q_pos0: int, kv_pos0: int, chunk: int, mask, device) -> torch.Tensor:
    """(b or 1, 1, chunk, chunk) bool: causal by absolute position, and the
    key's padding mask (b, chunk) where given."""
    pos = torch.arange(chunk, device=device)
    valid = ((kv_pos0 + pos)[None, :] <= (q_pos0 + pos)[:, None])[None, None]
    if mask is not None:
        valid = valid & mask[:, None, None, :]
    return valid


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, group, scale):
        n, r = comm.size(group), comm.rank(group)
        b, h, c, d = q.shape
        qf = q.float()
        m = torch.full((b, h, c), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, c), dtype=torch.float32, device=q.device)
        o = torch.zeros((b, h, c, d), dtype=torch.float32, device=q.device)
        kc, vc, mc = k, v, mask
        for s in range(n):
            owner = (r - s) % n
            if owner <= r:
                valid = _valid(r * c, owner * c, c, mc, q.device)
                sc = torch.matmul(qf, kc.float().transpose(-1, -2)) * scale
                sc = torch.where(valid, sc, NEG)
                m_new = sc.amax(dim=-1)
                p = torch.where(valid, torch.exp(sc - m_new[..., None]), 0.0)
                m_tot = torch.maximum(m, m_new)
                a, bb = torch.exp(m - m_tot), torch.exp(m_new - m_tot)
                l = l * a + p.sum(dim=-1) * bb
                o = o * a[..., None] + torch.matmul(p, vc.float()) * bb[..., None]
                m = m_tot
            if s < n - 1:
                kc, vc, mc = _shift(kc, vc, mc, group)
        out = o / l.clamp(min=1e-30)[..., None]
        ctx.save_for_backward(q, k, v, mask, m, l, out)
        ctx.group, ctx.scale = group, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, m, l, out = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, r = comm.size(group), comm.rank(group)
        c = q.shape[2]
        qf, do = q.float(), dout.float()
        delta = (do * out).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qf)
        kc, vc, mc = k, v, mask
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for s in range(n):
            owner = (r - s) % n
            if owner <= r:
                valid = _valid(r * c, owner * c, c, mc, q.device)
                kf, vf = kc.float(), vc.float()
                sc = torch.matmul(qf, kf.transpose(-1, -2)) * scale
                p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0) \
                    / l.clamp(min=1e-30)[..., None]
                dv = dv + torch.matmul(p.transpose(-1, -2), do)
                ds = p * (torch.matmul(do, vf.transpose(-1, -2)) - delta)
                dq = dq + torch.matmul(ds, kf) * scale
                dk = dk + torch.matmul(ds.transpose(-1, -2), qf) * scale
            if n > 1:
                # dk, dv ride with their chunk; after n steps they are home
                if s < n - 1:
                    kc, vc, mc = _shift(kc, vc, mc, group)
                dk, dv = comm.ring_shift([dk, dv], group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def _shift(k, v, mask, group):
    if mask is None:
        k, v = comm.ring_shift([k, v], group)
        return k, v, None
    return tuple(comm.ring_shift([k, v, mask], group))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group=None, scale: Optional[float] = None,
                   attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact causal attention over a sequence split in rank order over
    ``group``. q, k, v: this rank's chunk ``(b, h, chunk, d)``;
    ``attention_mask``: the chunk's padding ``(b, chunk)`` (1 = real; HF
    convention, left or right padding). -> this chunk's output ``(b, h,
    chunk, d)`` in q's dtype. ``scale`` defaults to ``d ** -0.5``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mask = None if attention_mask is None else attention_mask.to(torch.bool)
    return _RingAttention.apply(q, k, v, mask, group, float(scale))
