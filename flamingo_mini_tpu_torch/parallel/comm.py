"""The collectives of the port's parallel paths, as plain functions on a
process group (``None``: every rank).

* ``all_reduce``: the sum over the group, out of place;
* ``all_gather``: every rank's tensor, concatenated along a dimension;
* ``ring_shift``: tensors sent to the next rank of the group, the previous
  rank's received (the ring attention's step);
* two Megatron autograd functions: ``copy_to_model_parallel`` (identity
  forward, all-reduced gradient) at the input of a column-parallel layer,
  ``reduce_from_model_parallel`` (all-reduced forward, gradient as it is)
  at the output of a row-parallel one; and ``gather_from_model_parallel``
  (all-gathered forward, the rank's slice of the gradient). The first two
  are written out because ``torch.distributed.nn.functional.all_reduce``
  all-reduces the gradient in its backward too: in the "reduce" position
  that multiplies a gradient replicated over the group by its size.

gloo and CUDA tensors: PyTorch documents gloo's CUDA support for
``broadcast`` and ``all_reduce`` only (``GLOO_CUDA_OPS``). On a gloo group
every other op on CUDA tensors is staged through pinned host memory: the
tensors are copied out, the op runs on the copies, the result is copied
back. The group's backend and the tensor's device choose that path, never
a caught error; the arithmetic stays on the card. Data movement sends
bf16 and bool as their bytes (uint8; gloo moves neither type).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})
_BYTES = (torch.bfloat16, torch.bool)


def rank(group=None) -> int:
    """This process's rank in ``group`` (0 without a process group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def size(group=None) -> int:
    """The ranks in ``group`` (1 without a process group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def staged(op: str, group, t: torch.Tensor) -> bool:
    """Whether ``op`` on ``t`` goes through pinned host memory: a CUDA tensor
    on a gloo group, for an op outside ``GLOO_CUDA_OPS``."""
    return (t.is_cuda and op not in GLOO_CUDA_OPS
            and dist.get_backend(group) == "gloo")


def _wire(t: torch.Tensor, stage: bool) -> torch.Tensor:
    """``t`` as the bytes to move: contiguous, bf16 and bool as uint8 bytes
    (the last dimension doubled for bf16), in pinned host memory when
    staged."""
    t = t.contiguous()
    if t.dtype in _BYTES:
        t = t.view(torch.uint8)
    if stage:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host
    return t


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_wire`` onto ``like``'s device and dtype."""
    t = t.to(like.device)
    return t.view(like.dtype) if like.dtype in _BYTES else t


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over ``group``, a new tensor (``x`` untouched); bf16
    summed in float32 and rounded once. gloo takes it on CUDA tensors."""
    if size(group) == 1:
        return x.clone()
    y = x.to(torch.float32 if x.dtype == torch.bfloat16 else x.dtype, copy=True,
             memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along ``dim`` in rank
    order."""
    n = size(group)
    if n == 1:
        return x
    stage = staged("all_gather", group, x)
    src = _wire(x, stage)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat([_unwire(p, x) for p in parts], dim=dim)


def ring_shift(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """Send each tensor to the group's next rank ``(r + 1) % n`` and return
    the previous rank's, of the same shapes and dtypes: one step of a ring.
    Every send and receive is posted before any is waited on."""
    n, r = size(group), rank(group)
    if n == 1:
        return list(tensors)
    pg = group if group is not None else dist.group.WORLD
    dst = dist.get_global_rank(pg, (r + 1) % n)
    src = dist.get_global_rank(pg, (r - 1) % n)
    ops, recvs = [], []
    for tag, t in enumerate(tensors):
        stage = staged("ring_shift", group, t)
        send = _wire(t, stage)
        recv = torch.empty(send.shape, dtype=send.dtype, device=send.device,
                           pin_memory=stage)
        ops += [dist.P2POp(dist.isend, send, dst, group, tag),
                dist.P2POp(dist.irecv, recv, src, group, tag)]
        recvs.append(recv)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [_unwire(recv, t) for recv, t in zip(recvs, tensors)]


class _CopyToModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModelParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        start = rank(ctx.group) * ctx.width
        return grad.narrow(ctx.dim, start, ctx.width).contiguous(), None, None


def copy_to_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over ``group``."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModelParallel.apply(x, group)


def reduce_from_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``; the gradient passed as it is."""
    return _ReduceFromModelParallel.apply(x, group)


def gather_from_model_parallel(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; each rank's gradient is
    its own slice of the gathered one."""
    return _GatherFromModelParallel.apply(x, group, dim % x.ndim)
