"""In-situ probe on the card: the per-step cost of the int8 tied lm_head and
greedy argmax inside a loop that feeds each token back into the hidden row.

    python -m flamingo_mini_tpu_torch.tools.probe_lm_head

Port of ``tools/probe_lm_head.py``. The loop is its ``make_loop``: each step
computes the next token from x (B, D) and adds ``(token & 1) * 1e-6`` to x,
so each step depends on the last. Two variants, each timed with
``insitu.per_step_ms`` (one CUDA graph per trip count, 64 and 576 steps;
per step = (t_576 - t_64) / 512):

- ``eager_int8``: the plain int8 head, ``x @ w8^T`` in float32 on the
  unpadded (V, D) weights, times the row scales, cast to bf16, argmax (the
  TPU probe's ``xla_int8``);
- ``cuda_rows{n}``: the port's ``lm_head_argmax`` over ``pad_head_weights``
  (rows padded to the generate path's 2,048), named after the kernel's
  ``fmt_lm_head_rows_per_block`` (the TPU probe's ``pallas_bv1024``,
  ``_bv2048`` and ``_bv4096``: the port's kernel has no ``block_v``).

GB/s counts the int8 weight bytes per step. Every step reads the same
51.5 MB (52.4 MB padded) of weights, about the size of the card's 50 MB L2,
so part of them may come from L2: a rate above 3.35 TB/s is L2-served, not
a kernel beating device memory. The last line is one JSON object
``{"us_per_step": {...}, "GBps": {...}, "shape": "..."}``. Without a CUDA
device the CLI exits 1 and prints no result.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict

import torch

from ..ops import cuda_build
from ..ops.lm_head import lm_head_argmax, pad_head_weights
from . import insitu

B, D, V = 32, 1024, 50258   # flamingo-mini's head (GPT-2's vocabulary + <EOC>)
REPEATS = (64, 576)
PAD_ROWS = 2048             # generation.HEAD_BLOCK_V


def eager_head(w8: torch.Tensor, scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain int8 head + argmax -> (B,) int32; w8 (V, D) int8, scale
    (V,) or (1, V) float32, x (B, D) bf16."""
    logits = torch.matmul(x.float(), w8.float().t())
    logits = (logits * scale.reshape(1, -1)[:, :w8.shape[0]]).to(x.dtype)
    return torch.argmax(logits.float(), dim=-1).to(torch.int32)


def kernel_head(n_valid: int) -> Callable:
    """head(w8p, scale_p, x) on the port's fused kernel over padded rows."""
    def head(w8p, sp, x):
        return lm_head_argmax(w8p, sp, x, n_valid=n_valid)
    return head


def make_loop(head: Callable, padded: bool, n_valid: int = V) -> Callable:
    """run(w8, scale, x0, reps) -> sum(x.float()) after ``reps`` steps; an
    unpadded head reads w8[:n_valid]."""
    def run(w8, scale, x0, reps):
        x = x0
        for _ in range(reps):
            tok = head(w8, scale, x) if padded else head(w8[:n_valid], scale, x)
            x = x + (tok[:, None] & 1).to(x.dtype) * 1e-6
        return torch.sum(x.float())
    return run


def inputs(device, generator: torch.Generator, b: int = B, d: int = D, v: int = V):
    """(w8 (v, d) int8, scale (v,) float32, x0 (b, d) bf16) on device."""
    x0 = (torch.randn((b, d), generator=generator, device=device) * 0.1
          ).to(torch.bfloat16)
    w8 = torch.randint(-127, 128, (v, d), generator=generator, device=device
                       ).to(torch.int8)
    scale = torch.randn((v,), generator=generator, device=device).abs() * 0.01 + 1e-4
    return w8, scale, x0


def variants(w8, scale, x0, rows_per_block: int, n_valid: int = V):
    """The CLI's (name, loop, args, weight bytes per step) rows."""
    padded = pad_head_weights({"w8": w8, "scale": scale}, PAD_ROWS)
    return (("eager_int8", make_loop(eager_head, padded=False, n_valid=n_valid),
             (w8, scale, x0), w8.shape[0] * w8.shape[1]),
            (f"cuda_rows{rows_per_block}",
             make_loop(kernel_head(n_valid), padded=True, n_valid=n_valid),
             (padded["w8"], padded["scale"], x0), padded["w8"].numel()))


def measure(name: str, run: Callable, args, bytes_per_step: int,
            repeats=REPEATS) -> Dict[str, float]:
    """{"us_per_step", "GBps"} of one loop on the card."""
    us = insitu.per_step_ms(run, args, repeats) * 1e3
    gbps = bytes_per_step / (us * 1e-6) / 1e9
    print(f"{name:24s} {us:7.1f} us/step  {gbps:5.0f} GB/s", flush=True)
    return {"us_per_step": us, "GBps": gbps}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_lm_head: no CUDA device; the probe runs on the card only",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(time.time_ns() % (1 << 31))
    w8, scale, x0 = inputs(dev, gen)
    print(insitu.card_line())
    rows = cuda_build.kernels().fmt_lm_head_rows_per_block()
    results = {name: measure(name, run, args, n_bytes)
               for name, run, args, n_bytes in variants(w8, scale, x0, rows)}
    print(json.dumps({"us_per_step": {k: r["us_per_step"] for k, r in results.items()},
                      "GBps": {k: r["GBps"] for k, r in results.items()},
                      "shape": f"B{B} D{D} V{V}"}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
