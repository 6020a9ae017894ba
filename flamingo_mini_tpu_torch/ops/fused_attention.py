"""Fused softmax attention: the full-KV kernel and its streaming variant.

Port of ``flamingo_mini_tpu/ops/pallas_attn.py::fused_attention``. Both CUDA
kernels are ``csrc/fused_attention.cu``: bf16 inputs run the Hopper tile
``csrc/attention_sm90.cuh`` (TMA, wgmma, a producer and a consumer
warpgroup), float32 inputs ``csrc/attention_tile.cuh``; each note says what
bounds the kernel on the card and how the design answers that.

Semantics, as the TPU kernels': scores ``scale * q.k`` in float32, then
``+ bias`` and ``+ row_bias`` (float32), then causal positions set to
float32 min; softmax in float32; probabilities times V in float32; the
output rounded once to q's dtype. The streaming variant (``streaming=True``,
or ``n_kv > 2048`` without ``bias``) computes the same function by online
softmax, its running max starting at float32 min, over kv blocks of
``min(block_q, n_kv)`` keys with the tail padded: padded keys score float32
min and carry V = 0. So a fully masked row averages V over its masked keys
(and, streaming, the padded ones) instead of giving NaN.

``fused_attention`` and ``flash_attention`` launch their kernel for CUDA
tensors and run their plain version for CPU tensors; nothing else picks the
path. Each counts its own launches. On the card the head dim is 64, 80 or
128 (``HEAD_DIMS``: the ViT, the resampler and the trunks up to opt-1.3b
are 64 wide, opt-2.7b 80, opt-6.7b 128; any other raises), q/k/v are read
in place through their strides (the (b, n, h*d) projection layout that
``split_heads`` views), and the output is written (b, n, h, d) and returned
as its (b, h, n, d) view, so ``merge_heads`` copies nothing.

Training: on the card, when grad is enabled and q, k or v requires it, both
run through ``RecomputeBackward``, the port of the JAX functions'
``custom_vjp`` (``pallas_attn.py:241-267``): the forward launches the
kernel and keeps q, k, v, bias and row_bias; the backward recomputes
``fused_attention_plain`` (for the streaming mode too, as JAX's ``_bwd``
differentiates ``_reference_attention`` for both) and differentiates it
for the same upstream gradient. The masks are constants: their gradients
are None. The backward launches no kernel.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from typing import Optional

import torch

from . import cuda_build
from .attention import softmax_f32

NEG = float(torch.finfo(torch.float32).min)
HEAD_DIM = 64           # the ViT's and the resampler's (and the 64-wide trunks')
HEAD_DIMS = (64, 80, 128)   # the head widths the kernels take
_BLOCK_Q = 64         # query rows per CUDA block (attention_tile.cuh kBlockQ)


class _Args(ctypes.Structure):
    """``struct AttnArgs`` of csrc/attention_tile.cuh, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "out", "bias", "row_bias", "text_time")]
                + [("stride", (ctypes.c_longlong * 3) * 4)]
                + [(n, ctypes.c_int) for n in
                   ("b", "h", "n_q", "n_kv", "n_kv_pad", "causal", "n_visual")]
                + [("scale", ctypes.c_float)])


# _Args's bytes in one pack: 7 pointers, the 4 x 3 strides, 7 ints, scale
_PACKED = struct.Struct("7Q12q7if")


@functools.lru_cache(maxsize=None)
def _checked_lib() -> ctypes.CDLL:
    lib = cuda_build.kernels()
    if lib.fmt_attention_args_size() != ctypes.sizeof(_Args) \
            or _PACKED.size != ctypes.sizeof(_Args):
        raise RuntimeError("fused_attention: ctypes _Args does not match "
                           "struct AttnArgs")
    return lib


def check_cuda(name: str, q, k, v, head_dims=HEAD_DIMS) -> None:
    """The checks the attention kernels make of q (b, h, n_q, d) and k, v
    (b, h, n_kv, d) on the card; ``head_dims``: the widths the kernel takes."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: unsupported dtype {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or q.shape[-1] not in head_dims:
        raise ValueError(f"CUDA {name} takes (b, h, n, d) inputs with d in "
                         f"{tuple(head_dims)}, got {tuple(q.shape)}")
    b, h, n_q, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape \
            or k.shape[2] < 1 or n_q < 1:
        raise ValueError(f"{name}: k and v must be (b, h, n_kv, d) beside q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)}, {tuple(v.shape)}")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: q, k and v must share dtype and device")
        # 16-byte rows: the kernel copies K/V rows 16 bytes at a time
        sb, sh, sn, sd = t.stride()
        if sd != 1 or t.data_ptr() % 16 or sb % 8 or sh % 8 or sn % 8:
            raise ValueError(f"{name}: each input needs a contiguous head dim, "
                             "16-byte alignment and strides that are multiples "
                             f"of 8 elements; got strides {t.stride()}")


def check_tile_grid(name: str, q) -> None:
    """The grid limit of the tiles of ``fused_attention.cu``: the
    ``mma.sync`` tile launches (b * h, ceil(n_q / 64)) blocks, the Hopper
    tile walks as many items."""
    b, h, n_q, _ = q.shape
    if -(-n_q // _BLOCK_Q) > 65535 or b * h >= 2 ** 31:
        raise ValueError(f"{name}: grid too large for {tuple(q.shape)}")


def launch(fn: str, q, k, v, *, scale: float, causal: bool = False,
           bias=None, row_bias=None, text_time=None, n_visual: int = 0,
           n_kv_pad: Optional[int] = None, plan: tuple = ()) -> torch.Tensor:
    """Launch one of the attention kernels (``fn``: its C entry point;
    ``plan``: the ints it takes before the stream) on checked inputs ->
    (b, h, n_q, d), a view of a (b, n_q, h, d) tensor."""
    b, h, n_q, d = q.shape
    n_kv = k.shape[2]
    out = torch.empty((b, n_q, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    args = _PACKED.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if bias is None else bias.data_ptr(),
        0 if row_bias is None else row_bias.data_ptr(),
        0 if text_time is None else text_time.data_ptr(),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        b, h, n_q, n_kv, n_kv if n_kv_pad is None else n_kv_pad, int(causal),
        n_visual, scale)
    err = getattr(_checked_lib(), fn)(
        args, int(q.dtype == torch.bfloat16), *plan,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, fn, out)
    return out


def _row_bias_f32(row_bias, b: int, n_kv: int, device) -> Optional[torch.Tensor]:
    """(b, n_kv) padding bias as the kernels read it: float32, contiguous
    (exact for bf16 values; a bf16 -inf stays -inf). The models build it so
    once per forward, and then this copies nothing."""
    if row_bias is None:
        return None
    if row_bias.shape != (b, n_kv):
        raise ValueError(f"row_bias must be ({b}, {n_kv}), got {tuple(row_bias.shape)}")
    return row_bias.to(device=device, dtype=torch.float32).contiguous()


class RecomputeBackward(torch.autograd.Function):
    """``forward(q, k, v, *consts)`` (a kernel's launch) with the gradient of
    ``plain(q, k, v, *consts)``, its plain version, recomputed in the
    backward: the ``custom_vjp`` of the JAX kernels, whose ``_bwd``
    differentiates the XLA reference. ``consts`` (masks, ``text_time``;
    tensors or None) are saved beside q, k and v and get no gradient.

    ``RecomputeBackward.apply(forward, plain, q, k, v, *consts)``; the
    wrappers pass their launch as ``forward``, and only the tests pass
    anything else (the plain version, to run this on the CPU)."""

    @staticmethod
    def forward(ctx, forward, plain, q, k, v, *consts):
        ctx.plain = plain
        ctx.save_for_backward(q, k, v, *consts)
        return forward(q, k, v, *consts)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, *consts = ctx.saved_tensors
        need = ctx.needs_input_grad[2:5]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(n) for t, n in zip((q, k, v), need)]
            out = ctx.plain(*qkv, *consts)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(qkv, need) if n], grad_out))
        return (None, None, *(next(grads) if n else None for n in need),
                *(None for _ in consts))


def recompute_backward(forward, plain, q, k, v, *consts) -> torch.Tensor:
    """``forward(q, k, v, *consts)``, through ``RecomputeBackward`` where
    grad is enabled and q, k or v requires it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RecomputeBackward.apply(forward, plain, q, k, v, *consts)
    return forward(q, k, v, *consts)


def fused_attention_plain(q, k, v, *, scale: float = 1.0, bias=None,
                          row_bias=None, causal: bool = False) -> torch.Tensor:
    """Plain version of the full-KV kernel (``_reference_attention``):
    float32 scores and probabilities, float32 V product, one rounding."""
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    if row_bias is not None:
        s = s + row_bias.float().reshape(b, 1, 1, n_kv)
    if causal:
        keep = torch.ones(n_q, n_kv, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG)
    return torch.matmul(softmax_f32(s), v.float()).to(q.dtype)


def flash_attention_plain(q, k, v, *, scale: float = 1.0, row_bias=None,
                          causal: bool = False, block_q: int = 256) -> torch.Tensor:
    """Plain version of the streaming kernel (``_flash_kernel``): online
    softmax over kv blocks of ``min(block_q, n_kv)`` keys, the tail padded
    with zero keys whose row bias is float32 min; running max from float32
    min; ``acc / max(l, 1e-30)``."""
    b, h, n_q, d = q.shape
    n_kv = k.shape[2]
    block_kv = min(block_q, n_kv)
    n_kv_pad = -(-n_kv // block_kv) * block_kv
    pad = n_kv_pad - n_kv
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    rb = (torch.zeros(b, n_kv, device=q.device) if row_bias is None
          else row_bias.float())
    rb = torch.nn.functional.pad(rb, (0, pad), value=NEG)[:, None, None, :]
    qf = q.float()
    q_pos = torch.arange(n_q, device=q.device)[:, None]
    m = torch.full((b, h, n_q, 1), NEG, device=q.device)
    l = torch.zeros((b, h, n_q, 1), device=q.device)
    acc = torch.zeros((b, h, n_q, d), device=q.device)
    for j0 in range(0, n_kv_pad, block_kv):
        js = slice(j0, j0 + block_kv)
        s = torch.matmul(qf, kf[:, :, js].transpose(-1, -2)) * scale + rb[..., js]
        if causal:
            kv_pos = torch.arange(j0, j0 + block_kv, device=q.device)[None, :]
            s = torch.where(kv_pos <= q_pos, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[:, :, js])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float = 1.0, row_bias: Optional[torch.Tensor] = None,
                    causal: bool = False, block_q: int = 256) -> torch.Tensor:
    """The streaming kernel (``_flash_attention_fwd_impl``) -> (b, h, n_q, d);
    ``block_q`` sets the padded kv length as the TPU kernel's blocks do."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, row_bias=row_bias,
                                     causal=causal, block_q=block_q)
    check_cuda("flash_attention", q, k, v)
    check_tile_grid("flash_attention", q)
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    block_kv = min(block_q, n_kv)
    rb = _row_bias_f32(row_bias, b, n_kv, q.device)

    def kernel(q, k, v, rb):
        flash_attention.launches += 1
        return launch("fmt_flash_attention", q, k, v, scale=scale, causal=causal,
                      row_bias=rb, n_kv_pad=-(-n_kv // block_kv) * block_kv,
                      plan=(q.shape[3],))

    def plain(q, k, v, rb):
        return fused_attention_plain(q, k, v, scale=scale, row_bias=rb, causal=causal)
    return recompute_backward(kernel, plain, q, k, v, rb)


flash_attention.launches = 0


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float = 1.0, bias: Optional[torch.Tensor] = None,
                    row_bias: Optional[torch.Tensor] = None, causal: bool = False,
                    block_q: int = 256,
                    streaming: Optional[bool] = None) -> torch.Tensor:
    """softmax(scale * q k^T + bias + row_bias) v -> (b, h, n_q, d).

    q (b, h, n_q, d), k/v (b, h, n_kv, d); ``bias`` broadcastable to
    (b, h, n_q, n_kv); ``row_bias`` (b, n_kv) padding bias shared by every
    head and query row. Dispatches as the JAX function does: the streaming
    kernel (``flash_attention``) when ``streaming`` is set, or when it is
    None and ``n_kv > 2048``, and ``bias`` is None; else the full-KV kernel.
    """
    b, h, n_q, _ = q.shape
    n_kv = k.shape[2]
    if streaming is None:
        streaming = n_kv > 2048 and bias is None
    if streaming and bias is None:
        return flash_attention(q, k, v, scale=scale, row_bias=row_bias,
                               causal=causal, block_q=block_q)
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, scale=scale, bias=bias,
                                     row_bias=row_bias, causal=causal)
    check_cuda("fused_attention", q, k, v)
    check_tile_grid("fused_attention", q)
    rb = _row_bias_f32(row_bias, b, n_kv, q.device)

    def kernel(q, k, v, bias, rb):
        bf = None if bias is None else \
            bias.to(q.device).expand(b, h, n_q, n_kv).float().contiguous()
        fused_attention.launches += 1
        return launch("fmt_fused_attention", q, k, v, scale=scale, causal=causal,
                      bias=bf, row_bias=rb, plan=(q.shape[3],))

    def plain(q, k, v, bias, rb):
        return fused_attention_plain(q, k, v, scale=scale, bias=bias, row_bias=rb,
                                     causal=causal)
    return recompute_backward(kernel, plain, q, k, v, bias, rb)


fused_attention.launches = 0
