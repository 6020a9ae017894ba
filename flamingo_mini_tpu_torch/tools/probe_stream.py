"""Device-memory streaming probe on the card: how fast one kernel reads a
large buffer, beside one PyTorch reduction over the same buffer.

    python -m flamingo_mini_tpu_torch.tools.probe_stream [MB]

Port of ``tools/probe_stream.py`` (``pallas_stream`` and its protocol).
``stream_sum`` sums an (N, 1024) bf16 buffer, reading every byte once; its
CUDA kernel is ``csrc/stream_probe.cu`` and ``stream_sum_plain`` is its
plain version. The CLI fills a buffer of MB megabytes (default 512) with
fresh values in every process, chains R calls through the carry (each call
reads the last one's result), times the chain with CUDA events for R = 4
and 36 (median of 5 each), and reports the marginal time per call and its
GB/s, for the kernel and for ``torch.sum(x, dim=0, dtype=torch.float32)``.
Its last line is one JSON object ``{"stream_GBps": {...}, "buffer_MB": n}``.
The rate every bound in PERF.md assumes is 3.35 TB/s: 512 MB in 0.160 ms.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from typing import Callable, Dict

import torch

from ..ops import cuda_build
from . import insitu

COLS = 1024          # the probe's row width, as on the TPU
SUM_COLS = 128       # the columns that enter the sum (the TPU's one lane tile)
REPEATS = (4, 36)    # chain lengths whose difference gives the time per call
HBM_BYTES_PER_S = 3.35e12


def _check(x: torch.Tensor, chunk_rows: int) -> None:
    if x.dim() != 2 or x.shape[1] != COLS or x.dtype != torch.bfloat16 \
            or not x.is_contiguous():
        raise ValueError(f"stream_sum: x must be contiguous bf16 (N, {COLS}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if chunk_rows < 1 or x.shape[0] % chunk_rows:
        raise ValueError(f"stream_sum: chunk_rows ({chunk_rows}) must divide the "
                         f"{x.shape[0]} rows")


def stream_sum_plain(x: torch.Tensor, acc: torch.Tensor,
                     chunk_rows: int) -> torch.Tensor:
    """``pallas_stream``'s result in float32: sum over the first 128 columns
    j of (sum_i x[i, j] + (N / chunk_rows) * acc * 1e-30)."""
    _check(x, chunk_rows)
    steps = x.shape[0] // chunk_rows
    col = x[:, :SUM_COLS].float().sum(dim=0)
    return (col + steps * (acc.float() * 1e-30)).sum()


def stream_sum(x: torch.Tensor, acc: torch.Tensor, chunk_rows: int) -> torch.Tensor:
    """The probe's sum -> float32 scalar (0-dim) on x's device; acc: float32
    scalar tensor there (the carry). A CUDA tensor runs the kernel, which
    reads every byte of x once; a CPU tensor runs ``stream_sum_plain``."""
    _check(x, chunk_rows)
    if x.device.type == "cpu":
        return stream_sum_plain(x, acc, chunk_rows)
    if x.device.type != "cuda":
        raise ValueError(f"stream_sum: unsupported device {x.device}")
    if acc.dtype != torch.float32 or acc.numel() != 1 or acc.device != x.device:
        raise ValueError("stream_sum: acc must be one float32 on x's device")
    # 8 blocks of 256 threads per SM: the SM's full 2,048 threads in flight
    n_blocks = 8 * torch.cuda.get_device_properties(x.device).multi_processor_count
    # per block of 8 warps: its partial sum, then each warp's xor fold of
    # the words it read (stored so that no load can be dropped)
    scratch = torch.empty(n_blocks * (1 + 8), dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    lib = cuda_build.kernels()
    stream_sum.launches += 1
    err = lib.fmt_stream_sum(x.data_ptr(), acc.data_ptr(), scratch.data_ptr(),
                             out.data_ptr(), x.shape[0], n_blocks,
                             x.shape[0] // chunk_rows,
                             torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "stream_sum", out)
    return out


stream_sum.launches = 0


def library_sum(x: torch.Tensor, acc: torch.Tensor, _chunk_rows: int) -> torch.Tensor:
    """The yardstick (``xla_stream``'s counterpart): one PyTorch reduction
    over every byte, ``torch.sum(x, dim=0, dtype=torch.float32)``, with the
    carry added so that chained calls depend on each other."""
    return torch.sum(x, dim=0, dtype=torch.float32)[:SUM_COLS].sum() + acc * 1e-30


def marginal_ms(fn: Callable, x: torch.Tensor, chunk_rows: int,
                repeats=REPEATS, runs: int = 5) -> float:
    """Device ms per call: chains of ``repeats`` calls, each fed the last
    one's result, timed by CUDA events (median of ``runs`` per length);
    the difference over the difference in length."""
    def chain(n):
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for _ in range(n):
            acc = fn(x, acc, chunk_rows)
        return acc

    medians = []
    for n in repeats:
        chain(n)
        times = []
        for _ in range(runs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            chain(n)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        medians.append(statistics.median(times))
    return (medians[1] - medians[0]) / (repeats[1] - repeats[0])


def fresh_buffer(n_mb: int, device) -> torch.Tensor:
    """(n_mb MB / 2 KB, 1024) bf16 of N(0, 1) values from a seed that
    differs in every process."""
    n_rows = n_mb * 1024 * 1024 // (2 * COLS)
    gen = torch.Generator(device=device).manual_seed(time.time_ns() % (1 << 31))
    return torch.randn((n_rows, COLS), generator=gen, device=device).to(torch.bfloat16)


def measure(x: torch.Tensor, chunk_rows: int = 1024) -> Dict[str, Dict[str, float]]:
    """{label: {"ms": per call, "GBps": bytes / ms}} for the kernel
    ("cuda") and the library reduction ("torch_sum") over x."""
    n_bytes = x.numel() * x.element_size()
    out = {}
    for label, fn in (("cuda", stream_sum), ("torch_sum", library_sum)):
        ms = marginal_ms(fn, x, chunk_rows)
        out[label] = {"ms": ms, "GBps": n_bytes / (ms * 1e-3) / 1e9}
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_stream: no CUDA device; the probe runs on the card only",
              file=sys.stderr)
        return 1
    n_mb = int(argv[0]) if argv else 512
    dev = torch.device("cuda", 0)
    x = fresh_buffer(n_mb, dev)
    n_bytes = x.numel() * x.element_size()
    print(insitu.card_line())
    print(f"buffer {n_mb} MB: bound {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s")
    results = measure(x)
    for label, r in results.items():
        print(f"{label} per-call {r['ms']:.4f} ms  {r['GBps']:.0f} GB/s", flush=True)
    print(json.dumps({"stream_GBps": {k: r["GBps"] for k, r in results.items()},
                      "buffer_MB": n_mb}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
