"""In-situ decode-attention probe on the card: the per-layer cost of
attention variants inside a decode loop whose layers each write the running
hidden row into their cache first (the real data flow).

    python -m flamingo_mini_tpu_torch.tools.probe_decode_kernel [--full]

Port of ``tools/probe_decode_kernel.py``. Its three TPU kernels, which
replace the decode kernel's math by a running sum to isolate the stream of
cache bytes from the math, are hand-written CUDA in
``csrc/decode_stream_probe.cu``, one entry point per cache layout:

- ``attn_stream_only``: b-major ``(b, T, D)`` caches (``block_b`` only
  checks that it divides b: the rows are independent);
- ``tmajor_stream`` (``make_tmajor_stream``'s kernel): T-major ``(T, b,
  D)``, the layout of the port's decode cache;
- ``packed_stream`` (``make_tmajor_packed_loop``'s kernel): one packed
  ``(T, b, 2D)`` cache, K = ``[..., :D]``, V = ``[..., D:]``.

Each computes ``out = bf16(sum over the n = ceil(kv_limit / block_t)
chunks' rows of (f32 K + f32 V) + f32 q)``, launches its kernel for CUDA
tensors and runs its ``_plain`` version for CPU tensors, and counts its
launches. The plain versions sum in the kernel's order (groups of
``group_rows(block_t)`` rows in row order, the group partials chunk by chunk
in order), so the two agree bit for bit. The kernel is one launch a call,
with no scratch: its layout (``plan``: the output's 16-byte column vectors
a block owns, the groups it holds at once) is worked out on the host once
per shape and cached. A ``b`` that ``block_b`` does not
divide, or chunks that reach past the cache (n block_t > T), raise
``ValueError`` (the TPU kernels drop rows or read past the array).

The loops keep the TPU probe's data flow: caches made inside the loop from
q0, each layer writing the carried row at ``cur = min(4 + i, kv_limit - 1)``
first, ``q = attn(...) + q * 1e-6``, the result ``sum(q.float())``. Each
factory returns ``run(q0, npad, reps)``; ``inputs(device, generator)``
makes q0 and npad. The TPU probe adds a seed term to q0 on every call so
that no call can be served a cached result; here q0 comes fresh from the
generator in each process and the term is left out. Shapes come from a
``Shape`` (default ``PROBE``, the module constants). In the stream loops each layer writes q into a row it
then sums, so q grows about 3x per layer and overflows to inf within a few
steps at 24 layers, as on the TPU: the timing does not depend on the
values, but no check rests on a long loop's result.

``main`` times the TPU probe's variants with ``insitu.per_step_ms`` (one
CUDA graph per trip count, 8 and 40 steps): per step = (t_40 - t_8) / 32,
per layer = per step / 24, GB/s = 2 b kv_limit D 2 bytes per layer. The
port's ``decode_attention`` tiles the cache on its own, so the TPU's
``tmajor_kernel_bt16``, ``_bt32`` and ``_default`` are one variant here,
``tmajor_kernel``; ``stream_tmajor_bt32`` is ``stream_tmajor_bt32``; under
``--full`` ``stream_tmajor_packed_bt16`` is ``stream_tmajor_packed_bt16``
and the TPU's ``xla_head_r3`` is ``head_layout_attend`` (head-major caches
and the port's ``attend``). The TPU probe's ``main`` never runs
``attn_stream_only``; ``chip_smoke.py`` drives it through
``make_flat_loop``. The last line is one JSON object ``{"per_layer_us":
{...}, "GBps": {...}, "shape": "..."}``. Without a CUDA device the CLI
exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import sys
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..ops import cuda_build
from ..ops.attention import attend
from ..ops.decode_attention import decode_attention
from . import insitu

B, T, D, H, NLAYER = 32, 192, 1024, 16, 24
KV_LIMIT = 128   # about the live prefix the greedy headline's segments average
SCALE = (D // H) ** -0.5
REPEATS = (8, 40)
NEG = float(torch.finfo(torch.float32).min)


@dataclasses.dataclass(frozen=True)
class Shape:
    b: int = B
    t: int = T
    d: int = D
    h: int = H
    n_layer: int = NLAYER
    kv_limit: int = KV_LIMIT

    @property
    def scale(self) -> float:
        return (self.d // self.h) ** -0.5

    def __str__(self) -> str:
        return (f"B{self.b} T{self.t} D{self.d} H{self.h} L{self.n_layer} "
                f"kv{self.kv_limit}")


PROBE = Shape()


def group_rows(block_t: int) -> int:
    """Rows one kernel thread sums in order: the largest of 8, 4, 2, 1 that
    divides block_t."""
    return next(r for r in (8, 4, 2, 1) if block_t % r == 0)


def chunk_rows(kv_limit: int, block_t: int, t: int) -> int:
    """Rows the chunks cover: ceil(kv_limit / block_t) * block_t, at most t."""
    if block_t < 1 or kv_limit < 1:
        raise ValueError(f"block_t ({block_t}) and kv_limit ({kv_limit}) must be >= 1")
    n_rows = -(-kv_limit // block_t) * block_t
    if n_rows > t:
        raise ValueError(f"{n_rows // block_t} chunks of {block_t} rows reach past "
                         f"the {t}-row cache")
    return n_rows


def _rows(q, caches, b_major: bool, block_t: int, kv_limit: int) -> int:
    """Check a stream call's inputs -> the rows its chunks cover. Caches are
    (b, T, D) b-major, else (T, b, D), or (T, b, 2D) for one packed cache."""
    if q.dim() != 2 or q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"stream probe: q must be contiguous bf16 (b, D), got "
                         f"{q.dtype} {tuple(q.shape)}")
    b, d = q.shape
    t = caches[0].shape[1 if b_major else 0] if caches[0].dim() == 3 else 0
    want = (b, t, d) if b_major else (t, b, d * (2 if len(caches) == 1 else 1))
    for c in caches:
        if c.shape != want or c.dtype != torch.bfloat16 or not c.is_contiguous() \
                or c.device != q.device:
            raise ValueError(f"stream probe: cache must be contiguous bf16 {want} on "
                             f"{q.device}, got {c.dtype} {tuple(c.shape)} on {c.device}")
    return chunk_rows(kv_limit, block_t, t)


def _sum_plain(q, k_rows, v_rows, block_t: int) -> torch.Tensor:
    """The kernel's sum in its order: k_rows, v_rows (n_rows, b, D) views."""
    n_rows, b, d = k_rows.shape
    r = group_rows(block_t)
    kg = k_rows.float().reshape(n_rows // r, r, b, d)
    vg = v_rows.float().reshape(n_rows // r, r, b, d)
    sk, sv = kg[:, 0], vg[:, 0]
    for i in range(1, r):
        sk = sk + kg[:, i]
        sv = sv + vg[:, i]
    part = sk + sv
    gpc = block_t // r
    acc = torch.zeros((b, d), dtype=torch.float32, device=q.device)
    for c in range(n_rows // block_t):
        cs = part[c * gpc]
        for j in range(1, gpc):
            cs = cs + part[c * gpc + j]
        acc = acc + cs
    return (acc + q.float()).to(torch.bfloat16)


MAX_THREADS = 512   # csrc/decode_stream_probe.cu's kMaxThreads
# the rule's block: 16 of the output's 16-byte column vectors, at most 256
# threads (two blocks an SM at 122 registers; 256 blocks, one wave, at the
# probe's shape), the fastest or within 3 % of it at every shape of
# ``profile_decode.py stream_plans`` (PERF.md §6, PR 14)
WIDTH, THREADS = 16, 256


class Plan(NamedTuple):
    """The stream kernel's layout: a block owns ``width`` 16-byte column
    vectors of the output and holds ``window`` groups of rows at once, a
    thread a (group, vector) (``threads`` of them), their float32 partials
    in ``smem`` bytes of shared memory; ``blocks`` the grid, ``windows``
    the walk over the groups."""
    width: int
    window: int
    threads: int
    smem: int
    blocks: int
    windows: int


def make_plan(b: int, d: int, n_rows: int, block_t: int, *, width: int = WIDTH,
              max_threads: int = THREADS) -> Plan:
    """A block of ``width`` vectors (fewer where the output has fewer)
    holding as many groups as ``max_threads`` threads take: whole chunks
    where a chunk's groups fit, else the threads' worth, a chunk's sum then
    carried from one window to the next."""
    n_vec = b * (d // 8)
    r = group_rows(block_t)
    n_groups, gpc = n_rows // r, block_t // r
    width = min(width, n_vec, max_threads)
    room = max_threads // width
    window = min(n_groups, room // gpc * gpc if gpc <= room else room)
    threads = width * window
    return Plan(width, window, threads, threads * 32, -(-n_vec // width),
                -(-n_groups // window))


@functools.lru_cache(maxsize=None)
def plan(b: int, d: int, n_rows: int, block_t: int) -> Plan:
    """The stream kernel's layout at one shape, cached: the rule's
    ``WIDTH`` vectors a block, at most ``THREADS`` threads."""
    return make_plan(b, d, n_rows, block_t)


def _launch(name: str, q: torch.Tensor, n_rows: int, block_t: int, ptrs, dims,
            p: Optional[Plan]):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    b, d = q.shape
    if d % 8:
        raise ValueError(f"{name}: D ({d}) must be a multiple of 8")
    out = torch.empty_like(q)
    if any(ptr % 16 for ptr in (q.data_ptr(), out.data_ptr(), *ptrs)):
        raise ValueError(f"{name}: q and the caches must start on 16 bytes")
    p = p or plan(b, d, n_rows, block_t)
    lib = cuda_build.kernels()
    err = getattr(lib, name)(q.data_ptr(), *ptrs, out.data_ptr(), *dims, n_rows, block_t,
                             group_rows(block_t), p.width, p.window,
                             torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, name, out)
    return out


def _bmajor_rows(q, kf, vf, block_b, block_t, kv_limit):
    n_rows = _rows(q, (kf, vf), True, block_t or 32, kv_limit)
    b = q.shape[0]
    if (block_b or b) < 1 or b % (block_b or b):
        raise ValueError(f"attn_stream_only: block_b ({block_b}) must divide b ({b})")
    return n_rows


def attn_stream_only_plain(q, kf, vf, npad=None, cur=None, block_b=None, block_t=None,
                           *, shape: Shape = PROBE) -> torch.Tensor:
    """``attn_stream_only``'s plain version; kf, vf (b, T, D)."""
    n_rows = _bmajor_rows(q, kf, vf, block_b, block_t, shape.kv_limit)
    return _sum_plain(q, kf[:, :n_rows].transpose(0, 1), vf[:, :n_rows].transpose(0, 1),
                      block_t or 32)


def attn_stream_only(q, kf, vf, npad=None, cur=None, block_b=None, block_t=None,
                     *, shape: Shape = PROBE, plan: Optional[Plan] = None
                     ) -> torch.Tensor:
    """The decode kernel's reads over b-major caches kf, vf (b, T, D), the
    math replaced by a running sum -> (b, D) bf16. ``block_t`` defaults to
    32; ``npad`` and ``cur`` are not read (the TPU kernel's signature).
    ``plan``: the kernel's layout, ``plan()``'s by default."""
    n_rows = _bmajor_rows(q, kf, vf, block_b, block_t, shape.kv_limit)
    if q.device.type == "cpu":
        return attn_stream_only_plain(q, kf, vf, npad, cur, block_b, block_t, shape=shape)
    attn_stream_only.launches += 1
    return _launch("fmt_stream_bmajor", q, n_rows, block_t or 32,
                   (kf.data_ptr(), vf.data_ptr()), (q.shape[0], kf.shape[1], q.shape[1]),
                   plan)


attn_stream_only.launches = 0


def tmajor_stream_plain(q, kf, vf, *, block_t: int, kv_limit: int = KV_LIMIT
                        ) -> torch.Tensor:
    """``tmajor_stream``'s plain version."""
    n_rows = _rows(q, (kf, vf), False, block_t, kv_limit)
    return _sum_plain(q, kf[:n_rows], vf[:n_rows], block_t)


def tmajor_stream(q, kf, vf, *, block_t: int, kv_limit: int = KV_LIMIT,
                  plan: Optional[Plan] = None) -> torch.Tensor:
    """The stream-only sum over T-major caches kf, vf (T, b, D) -> (b, D)."""
    n_rows = _rows(q, (kf, vf), False, block_t, kv_limit)
    if q.device.type == "cpu":
        return tmajor_stream_plain(q, kf, vf, block_t=block_t, kv_limit=kv_limit)
    tmajor_stream.launches += 1
    return _launch("fmt_stream_tmajor", q, n_rows, block_t,
                   (kf.data_ptr(), vf.data_ptr()), q.shape, plan)


tmajor_stream.launches = 0


def packed_stream_plain(q, ckv, *, block_t: int, kv_limit: int = KV_LIMIT
                        ) -> torch.Tensor:
    """``packed_stream``'s plain version."""
    n_rows = _rows(q, (ckv,), False, block_t, kv_limit)
    d = q.shape[1]
    return _sum_plain(q, ckv[:n_rows, :, :d], ckv[:n_rows, :, d:], block_t)


def packed_stream(q, ckv, *, block_t: int, kv_limit: int = KV_LIMIT,
                  plan: Optional[Plan] = None) -> torch.Tensor:
    """The stream-only sum over one packed T-major cache ckv (T, b, 2D),
    K = ckv[..., :D], V = ckv[..., D:] -> (b, D)."""
    n_rows = _rows(q, (ckv,), False, block_t, kv_limit)
    if q.device.type == "cpu":
        return packed_stream_plain(q, ckv, block_t=block_t, kv_limit=kv_limit)
    packed_stream.launches += 1
    return _launch("fmt_stream_packed", q, n_rows, block_t, (ckv.data_ptr(),), q.shape,
                   plan)


packed_stream.launches = 0


def inputs(device, generator: torch.Generator, shape: Shape = PROBE
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q0 (b, D) bf16 of N(0, 0.1^2), npad (b,) int32 in [0, 3)) on device."""
    q0 = (torch.randn((shape.b, shape.d), generator=generator, device=device) * 0.1
          ).to(torch.bfloat16)
    npad = torch.randint(0, 3, (shape.b,), generator=generator, device=device,
                         dtype=torch.int32)
    return q0, npad


def _cur(i: int, shape: Shape) -> int:
    return min(4 + i, shape.kv_limit - 1)


def make_tmajor_stream(block_t: int, shape: Shape = PROBE) -> Callable:
    """attn(q, kf, vf, npad, cur, *_) over T-major (T, b, D) caches."""
    def attn(q, kf, vf, npad, cur, *_):
        return tmajor_stream(q, kf, vf, block_t=block_t, kv_limit=shape.kv_limit)
    return attn


def make_tmajor_loop(block_t: Optional[int], real_kernel: bool = False,
                     shape: Shape = PROBE) -> Callable:
    """The decode loop over T-major caches: the port's ``decode_attention``
    (``real_kernel``; ``block_t`` is not read, the kernel tiles on its own)
    or the stream-only sum in chunks of ``block_t``."""
    if real_kernel:
        def attn(q, kf, vf, npad, cur, *_):
            return decode_attention(q, kf, vf, npad, cur, n_head=shape.h,
                                    scale=shape.scale, kv_limit=shape.kv_limit)
    else:
        attn = make_tmajor_stream(block_t, shape)

    def run(q0, npad, reps):
        L, b, d = shape.n_layer, shape.b, shape.d
        ck = torch.zeros((L, shape.t, b, d), dtype=torch.bfloat16, device=q0.device) \
            + q0.to(torch.bfloat16)[None, None] * 1e-3
        cv = ck + 1e-6
        q = q0
        for i in range(reps):
            cur = _cur(i, shape)
            for l in range(L):
                ck[l, cur] = q
                cv[l, cur] = q
                q = attn(q, ck[l], cv[l], npad, cur) + q * 1e-6
        return torch.sum(q.float())
    return run


def make_tmajor_packed_loop(block_t: int, shape: Shape = PROBE) -> Callable:
    """The decode loop over one packed T-major (T, b, 2D) K||V cache: one
    cache write per layer per step (the row [q, q / 2] of the step's q)."""
    def run(q0, npad, reps):
        L, b, d = shape.n_layer, shape.b, shape.d
        ckv = torch.zeros((L, shape.t, b, 2 * d), dtype=torch.bfloat16,
                          device=q0.device) \
            + q0.to(torch.bfloat16)[None, None, :, :1] * 1e-3
        q = q0
        for i in range(reps):
            cur = _cur(i, shape)
            row = torch.cat([q, q * 0.5], -1)
            for l in range(L):
                ckv[l, cur] = row
                q = packed_stream(q, ckv[l], block_t=block_t,
                                  kv_limit=shape.kv_limit) + q * 1e-6
        return torch.sum(q.float())
    return run


def attn_eager_flat(q, kf, vf, npad, cur, *_, shape: Shape = PROBE) -> torch.Tensor:
    """Plain attention on b-major (b, T, D) caches (the TPU probe's
    ``attn_xla_flat``): float32 scores, masked to npad <= t <= cur, softmax,
    probabilities cast to q's dtype, float32 V product."""
    b, d = q.shape
    kv, h = shape.kv_limit, shape.h
    k = kf[:, :kv].reshape(b, kv, h, d // h)
    v = vf[:, :kv].reshape(b, kv, h, d // h)
    qh = q.reshape(b, h, 1, d // h)
    s = torch.einsum("bhqd,bthd->bhqt", qh.float(), k.float()) * shape.scale
    t_pos = torch.arange(kv, device=q.device)
    valid = (t_pos[None, :] >= npad[:, None]) & (t_pos[None, :] <= cur)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bhqt,bthd->bhqd", p.float(), v.float())
    return o.reshape(b, d).to(q.dtype)


def make_flat_loop(attn: Callable, block_b: Optional[int] = None,
                   block_t: Optional[int] = None, shape: Shape = PROBE) -> Callable:
    """The decode loop over b-major (b, T, D) caches with
    ``attn(q, kf, vf, npad, cur, block_b, block_t, shape=shape)``."""
    def run(q0, npad, reps):
        L, b, d = shape.n_layer, shape.b, shape.d
        ck = torch.zeros((L, b, shape.t, d), dtype=torch.bfloat16, device=q0.device) \
            + q0.to(torch.bfloat16)[None, :, None, :] * 1e-3
        cv = ck + 1e-6
        q = q0
        for i in range(reps):
            cur = _cur(i, shape)
            for l in range(L):
                ck[l, :, cur] = q
                cv[l, :, cur] = q
                q = attn(q, ck[l], cv[l], npad, cur, block_b, block_t, shape=shape) \
                    + q * 1e-6
        return torch.sum(q.float())
    return run


def make_head_loop(shape: Shape = PROBE) -> Callable:
    """The decode loop over head-major (b, h, T, dh) caches with the port's
    ``attend`` and an additive mask (the TPU probe's ``xla_head_r3``)."""
    def run(q0, npad, reps):
        L, b, d, h = shape.n_layer, shape.b, shape.d, shape.h
        dh, kv = d // h, shape.kv_limit
        ck = torch.zeros((L, b, h, shape.t, dh), dtype=torch.bfloat16,
                         device=q0.device) \
            + q0.to(torch.bfloat16).reshape(b, h, 1, dh)[None] * 1e-3
        cv = ck + 1e-6
        t_pos = torch.arange(kv, device=q0.device)
        q = q0
        for i in range(reps):
            cur = _cur(i, shape)
            qh = q.reshape(b, h, 1, dh)
            row = qh[:, :, 0]    # the step's row: every layer writes the same
            valid = (t_pos[None, :] >= npad[:, None]) & (t_pos[None, :] <= cur)
            bias = torch.where(valid, 0.0, NEG).to(q.dtype)[:, None, None, :]
            for l in range(L):
                ck[l, :, :, cur] = row
                cv[l, :, :, cur] = row
                o = attend(qh, ck[l, :, :, :kv], cv[l, :, :, :kv], scale=shape.scale,
                           bias=bias)
                q = o.reshape(b, d) + q * 1e-6
                qh = q.reshape(b, h, 1, dh)
        return torch.sum(q.float())
    return run


def variants(full: bool, shape: Shape = PROBE) -> Tuple[Tuple[str, Callable], ...]:
    """The CLI's (name, loop) pairs."""
    out = (("tmajor_kernel", make_tmajor_loop(None, real_kernel=True, shape=shape)),
           ("stream_tmajor_bt32", make_tmajor_loop(32, shape=shape)))
    if full:
        out += (("stream_tmajor_packed_bt16", make_tmajor_packed_loop(16, shape)),
                ("head_layout_attend", make_head_loop(shape)))
    return out


def measure(name: str, run: Callable, args, shape: Shape = PROBE,
            repeats=REPEATS) -> Dict[str, float]:
    """{"ms_per_step", "per_layer_us", "GBps"} of one loop on the card."""
    per_step = insitu.per_step_ms(run, args, repeats)
    per_layer_us = per_step / shape.n_layer * 1e3
    gbps = 2 * shape.b * shape.kv_limit * shape.d * 2 / (per_layer_us * 1e-6) / 1e9
    print(f"{name:28s} {per_step:7.3f} ms/step  {per_layer_us:6.2f} us/layer  "
          f"{gbps:5.0f} GB/s", flush=True)
    return {"ms_per_step": per_step, "per_layer_us": per_layer_us, "GBps": gbps}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_decode_kernel: no CUDA device; the probe runs on the card only",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(time.time_ns() % (1 << 31))
    args = inputs(dev, gen)
    print(insitu.card_line())
    results = {name: measure(name, run, args)
               for name, run in variants("--full" in argv)}
    print(json.dumps({"per_layer_us": {k: r["per_layer_us"] for k, r in results.items()},
                      "GBps": {k: r["GBps"] for k, r in results.items()},
                      "shape": str(PROBE)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
