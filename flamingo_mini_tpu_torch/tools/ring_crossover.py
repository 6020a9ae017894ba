"""Per-rank memory of ring attention against full attention, port of the
JAX package's ``tools/ring_crossover.py``.

Ring attention (``parallel/ring_attention.py``) splits the sequence over a
group of ranks and passes the K/V chunks round the ring. Each rank holds
only its own chunk of Q, K and V, and forms scores of (n/D)^2 per chunk
pair instead of n^2: that is what lets a context outgrow one card. This
measures it at b=1, h=16, d=64 in float32, sequence lengths 2,048, 4,096
and 8,192:

* the single-device baseline: full causal attention over the whole
  sequence in one process (rank 0, before the ring starts);
* the ring: ``--world`` gloo ranks (8, as JAX's 8-device mesh), rank r on
  card ``r % cards`` (several ranks share a card), each holding its chunk;
* per rank: the temporary bytes (the peak of ``torch.cuda.max_memory_
  allocated`` during the call, less the bytes allocated before it; the
  output included) and the argument bytes (its Q, K, V); the shrink factor
  of the temporary bytes; and JAX's analytic fields for the same shapes
  (the key ``icI_bytes_per_ring_step`` keeps JAX's name: one step's K/V
  chunk, here over host memory or NVLink rather than the TPU's ICI);
* the check: the ring's output, gathered on rank 0, against the full
  attention's (normwise 1e-4): a memory figure for a wrong answer is worth
  nothing.

The JSON is printed, and written to ``--out`` when given. It runs on the
card unless ``--device cpu`` (no memory figures there: the CPU has no
allocator statistics).

    python -m flamingo_mini_tpu_torch.tools.ring_crossover [--world 8] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import socket
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel import comm, distributed_init
from ..parallel.ring_attention import ring_attention

SEQ_LENS = (2048, 4096, 8192)
B, H, D = 1, 16, 64
TOLERANCE = 1e-4            # normwise, float32
TIMEOUT = 600.0             # seconds for the whole world


def inputs(n_seq: int, b: int = B, h: int = H, d: int = D):
    """Q, K, V (b, h, n_seq, d) float32 on the host, from RandomState(0)."""
    rs = np.random.RandomState(0)
    return tuple(torch.from_numpy(rs.randn(b, h, n_seq, d).astype(np.float32))
                 for _ in range(3))


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal softmax attention over the whole sequence, in one piece."""
    n, d = q.shape[2], q.shape[3]
    s = torch.matmul(q, k.transpose(-1, -2)) * (d ** -0.5)
    causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, torch.finfo(torch.float32).min)
    return torch.matmul(torch.softmax(s, dim=-1), v)


def analytic(n_seq: int, world: int, b: int = B, h: int = H, d: int = D) -> Dict[str, int]:
    """JAX's analytic model of the deployment claim, for ``world`` ranks."""
    return {
        "score_matrix_bytes_single": 4 * b * h * n_seq * n_seq,
        "score_chunk_bytes_ring": 4 * b * h * (n_seq // world) ** 2,
        "icI_bytes_per_ring_step": 2 * 4 * b * h * (n_seq // world) * d,
    }


def _peak_during(fn, device: torch.device):
    """(fn's result, the temporary bytes of the call) on a card; None bytes
    on the CPU. A small product first, so that cuBLAS's workspace (some 32
    MiB from the caching allocator at a process's first product) is not
    counted as the call's."""
    if device.type != "cuda":
        return fn(), None
    torch.ones(8, 8, device=device) @ torch.ones(8, 8, device=device)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    out = fn()
    torch.cuda.synchronize(device)
    return out, torch.cuda.max_memory_allocated(device) - before


def single_device(n_seq: int, device: torch.device):
    """-> (the full attention's output on the host, its memory figures)."""
    q, k, v = (t.to(device) for t in inputs(n_seq))
    out, temp = _peak_during(lambda: full_attention(q, k, v), device)
    stats = {"temp_bytes": temp, "args_bytes": 3 * q.numel() * q.element_size()}
    return out.cpu(), stats


def ring_rank(n_seq: int, device: torch.device, group=None):
    """This rank's share of the ring over ``group``: only its chunk of Q,
    K and V goes to ``device`` -> (every rank's output gathered in rank
    order on the host, this rank's memory figures)."""
    world, r = comm.size(group), comm.rank(group)
    if n_seq % world:
        raise ValueError(f"sequence {n_seq} not divisible by {world} ranks")
    c = n_seq // world
    q, k, v = (t[:, :, r * c:(r + 1) * c].contiguous().to(device) for t in inputs(n_seq))
    out, temp = _peak_during(lambda: ring_attention(q, k, v, group=group), device)
    stats = {"temp_bytes": temp, "args_bytes": 3 * q.numel() * q.element_size()}
    return comm.all_gather(out, group, dim=2).cpu(), stats


def measure_rank(seq_lens, device: torch.device, group=None) -> Optional[List[Dict]]:
    """Every sequence length on this rank of ``group``: rank 0 runs the
    single-device baseline first, then every rank its share of the ring.
    -> rank 0: the rows (every rank's figures, the check); others: None.
    Raises where the ring's output is off the full attention's."""
    world, r = comm.size(group), comm.rank(group)
    rows = []
    for n_seq in seq_lens:
        if r == 0:
            want, single = single_device(n_seq, device)
            if device.type == "cuda":
                torch.cuda.empty_cache()
        torch.distributed.barrier(group)
        got, mine = ring_rank(n_seq, device, group)
        every = [None] * world
        torch.distributed.all_gather_object(every, mine, group)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if r != 0:
            continue
        err = float((got - want).norm() / want.norm())
        if not err <= TOLERANCE:
            raise AssertionError(f"ring attention at {n_seq} tokens over {world} ranks: "
                                 f"normwise error {err} against full attention "
                                 f"(tolerance {TOLERANCE})")
        temps = [s["temp_bytes"] for s in every]
        row = {"seq_len": n_seq, "single_device": single,
               f"ring_{world}rank": {"temp_bytes_per_rank": temps,
                                     "args_bytes_per_rank": every[0]["args_bytes"]},
               "normwise_error_vs_full": err,
               "analytic": analytic(n_seq, world)}
        if single["temp_bytes"] is not None:
            row["temp_shrink_x"] = round(single["temp_bytes"] / max(max(temps), 1), 1)
        rows.append(row)
    return rows


def _rank_main(rank: int, world: int, port: int, seq_lens, device: str, out: str) -> None:
    """One rank of the CLI's ranks (a spawned process)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    distributed_init(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout=TIMEOUT)
    try:
        rows = measure_rank(seq_lens, dev)
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(rows, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(world: int, seq_lens, device: str = "cuda", timeout: float = TIMEOUT) -> List[Dict]:
    """Start ``world`` gloo ranks (spawned processes), run
    ``measure_rank`` on them -> rank 0's rows. A rank that fails or
    outlasts ``timeout`` seconds (one deadline for all) raises; every
    process is gone on return."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rows.json")
        port = _free_port()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, port, tuple(seq_lens), device, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            late = [p for p in procs if p.is_alive()]
            for p in late:
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if late or codes != [0] * world:
            raise RuntimeError(f"ring ranks: exit codes {codes}"
                               f"{' (past the time limit)' if late else ''}")
        with open(out) as f:
            return json.load(f)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flamingo_mini_tpu_torch.tools.ring_crossover",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=8, help="ranks in the ring")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--device", default="cuda", help="the ranks' device")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    rows = run(args.world, SEQ_LENS, args.device)
    result = {
        "results": rows,
        "device": (torch.cuda.get_device_name(0) if args.device != "cpu" else "cpu"),
        "note": f"b={B}, h={H}, d={D}, float32; temp bytes = the peak of "
                "torch.cuda.max_memory_allocated during the call less the bytes "
                "allocated before it (the output included); the ranks share "
                "their cards and talk over gloo",
    }
    text = json.dumps(result, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
