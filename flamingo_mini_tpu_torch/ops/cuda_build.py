"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``,
all at once, and the objects are linked into one shared library with a
plain C interface, at first use, and loaded with ``ctypes``. The library
lands in ``build/kernels/`` at the repository root (git-ignored), named by
a hash of the sources and flags, so an edit to a source rebuilds it and an
unchanged tree reuses it. There is no fallback: a
CUDA machine without ``nvcc`` raises.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: name -> argument types; each returns cudaGetLastError()
SIGNATURES = {
    # q, k, v, npad, out, b, D, n_head, t_lim, cur, scale, is_bf16, stream,
    # scratch, and the plan: heads, splits, positions, warps
    "fmt_decode_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                             _P, _P, _I, _I, _I, _I],
    # q, k, v, npad, anc, out, b, D, n_head, t_lim, cur, scale, kb, anc_len,
    # is_bf16, stream, scratch, heads, splits, positions, warps
    "fmt_decode_attention_beam": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _F, _I, _I, _I, _P, _P, _I, _I, _I, _I],
    # w8, scale, x, part_max, part_idx, out, Vp, D, ldw, B, n_valid, stream
    "fmt_lm_head_argmax": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fmt_lm_head_rows_per_block": [],
    # D, B -> the launch's dynamic shared memory, or -1 (width refused)
    "fmt_lm_head_smem": [_I, _I],
    # &MegaArgs (ops/megadecode._Args), stream
    "fmt_decode_megakernel": [_P, _P],
    # &MegaArgs, &blocks, &smem_bytes
    "fmt_decode_megakernel_grid": [_P, _P, _P],
    "fmt_decode_megakernel_args_size": [],
    # &MegaArgs -> dynamic shared memory bytes (launches nothing)
    "fmt_decode_megakernel_smem": [_P],
    # sync, slots, errors, phases, stream (the weight-only kernel's barrier)
    "fmt_grid_sync_test": [_P, _P, _P, _I, _P],
    # &MegaArgs (shapes, plan, amax words), linear, A, W, scale, bias, out,
    # stream
    "fmt_w8a8_linear": [_P, _I, _P, _P, _P, _P, _P, _P],
    # x, acc, partial, out, n_rows, n_blocks, steps, stream
    "fmt_stream_sum": [_P, _P, _P, _P, _L, _I, _I, _P],
    # the decode stream probes: q, k, v (or kv), out, b, [T,] D, n_rows,
    # block_t, group_rows, and the plan: slice, window; stream
    "fmt_stream_tmajor": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fmt_stream_bmajor": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "fmt_stream_packed": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # &AttnArgs (ops/fused_attention._Args), is_bf16, head width, stream
    "fmt_fused_attention": [_P, _I, _I, _P],
    "fmt_flash_attention": [_P, _I, _I, _P],
    # &AttnArgs, is_bf16, the bf16 kernel's plan (slices a block), stream
    "fmt_media_xattn": [_P, _I, _I, _P],
    "fmt_attention_args_size": [],
}


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfmt_kernels-{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Run the commands concurrently -> [(cmd, returncode, output, seconds
    it ran)]."""
    t0 = time.monotonic()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    results = [None] * len(procs)

    def wait(i):
        cmd, proc = procs[i]
        out, _ = proc.communicate()
        results[i] = (cmd, proc.returncode, out, time.monotonic() - t0)
    threads = [threading.Thread(target=wait, args=(i,)) for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results


def build() -> str:
    """Compile the kernels unless the library for these sources exists.
    Returns the library path; nvcc's output (registers, shared memory and
    spills per kernel) is kept beside it as ``.log``, each command with the
    seconds it took (``# nvcc <source or link>: <s> s``)."""
    lib = library_path()
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tmp = f"{lib}.{os.getpid()}"
    cus = [s for s in sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(cu)}.o" for cu in cus]
    results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, cu]
                        for cu, obj in zip(cus, objs)])
    if all(rc == 0 for _, rc, _, _ in results):
        results += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp + ".so",
                              *objs]])
    with open(lib[:-3] + ".log", "w") as f:
        for cmd, _, out, secs in results:
            what = "link" if "-shared" in cmd else os.path.basename(cmd[-1])
            f.write(f"{' '.join(cmd)}\n# nvcc {what}: {secs:.1f} s\n{out}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    failed = [(cmd, rc, out) for cmd, rc, out, _ in results if rc != 0]
    if failed:
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    os.replace(tmp + ".so", lib)
    return lib


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# set by ``utils.profiling.debug_nans``: ``check`` then also looks for NaN
# in the kernel's outputs; off, it does not touch them
nan_checks = False


def check(err: int, name: str, *outputs) -> None:
    """Raise ``RuntimeError`` where the launch of the kernel ``name``
    failed; with ``nan_checks`` on, ``FloatingPointError`` where one of its
    floating ``outputs`` holds a NaN (this waits for the card)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    if nan_checks:
        import torch
        for t in outputs:
            if t.is_floating_point() and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"debug_nans: {name} produced NaN")
