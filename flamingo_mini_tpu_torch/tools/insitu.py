"""In-situ timing on the card: a decode loop captured as one CUDA graph per
trip count, the per-step time taken from two trip counts.

Port of the protocol that ``tools/probe_decode_kernel.py`` and
``tools/probe_lm_head.py`` share (their ``timed`` and ``measure``). There
one jitted loop with a traced trip count is one dispatch, so the host's
launch time drops out. Here the loop body's launches (a decode probe step
is 24 layers of cache-row writes, the probed call and an axpy) would each
cost the host more than the kernel takes on the card, so each trip count
is captured once into a ``torch.cuda.CUDAGraph`` and the graph is replayed:

- ``per_step_ms``: run the loop once eagerly (builds the kernels, warms the
  allocator; nothing inside the captured region may synchronise with the
  host), capture it for ``lo`` and for ``hi`` steps, time ``RUNS`` replays
  of each with CUDA events, and return (median_hi - median_lo) / (hi - lo);
- ``graph_equals_eager``: the captured loop replayed against the same loop
  run eagerly on the card, bit for bit, NaN-aware.

A loop is ``run(*args, reps)`` returning a tensor; its arguments lie on the
card. The wrappers' launch counts see the eager run and the captures (the
kernel is enqueued once per call while capturing); a replay relaunches the
captured kernels without Python. Nothing here times on the CPU: a loop
whose arguments are CPU tensors raises.
"""
from __future__ import annotations

import statistics
import subprocess
from typing import Callable, Sequence, Tuple

import torch

RUNS = 5


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", "0"],
                              capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(0)


def _device(args: Sequence) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.device.type != "cuda":
                raise RuntimeError(f"in-situ timing runs on the card only, got a "
                                   f"tensor on {a.device}")
            return a.device
    raise RuntimeError("in-situ timing needs a tensor argument on the card")


def capture(run: Callable, args: Sequence, reps: int
            ) -> Tuple[torch.cuda.CUDAGraph, torch.Tensor]:
    """``run(*args, reps)`` captured into a CUDA graph -> (graph, its output
    tensor, which each replay rewrites)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(*args, reps)
    return graph, out


def warm_up(run: Callable, args: Sequence, reps: int = 1) -> None:
    """One eager run on a side stream, as PyTorch asks before a capture."""
    side = torch.cuda.Stream(_device(args))
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(*args, reps)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


def replay_ms(graph: torch.cuda.CUDAGraph, runs: int = RUNS) -> float:
    """Median ms of ``runs`` replays after one untimed replay."""
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def per_step_ms(run: Callable, args: Sequence, repeats: Tuple[int, int],
                runs: int = RUNS) -> float:
    """Device ms per loop step: (median replay at hi - at lo) / (hi - lo)."""
    _device(args)
    warm_up(run, args)
    medians = []
    for reps in repeats:
        graph, out = capture(run, args, reps)
        medians.append(replay_ms(graph, runs))
        del graph, out
    torch.cuda.empty_cache()
    lo, hi = repeats
    return (medians[1] - medians[0]) / (hi - lo)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit equal, where a NaN equals any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.reshape(-1), b.reshape(-1)
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    nan = torch.isnan(a) if a.is_floating_point() else torch.zeros_like(a, dtype=torch.bool)
    nan_b = torch.isnan(b) if b.is_floating_point() else nan
    return bool(((a.view(ints) == b.view(ints)) | (nan & nan_b)).all())


def graph_equals_eager(run: Callable, args: Sequence, reps: int = 2
                       ) -> Tuple[bool, torch.Tensor, torch.Tensor]:
    """(same bits, eager output, replayed output) of ``run(*args, reps)``."""
    _device(args)
    eager = run(*args, reps).clone()
    torch.cuda.synchronize()
    graph, out = capture(run, args, reps)
    graph.replay()
    torch.cuda.synchronize()
    replayed = out.clone()
    del graph, out
    return same_bits(eager, replayed), eager, replayed
