"""The C++ BPE merger (``bpe.cpp``) behind ctypes, port of
``flamingo_mini_tpu/native/__init__.py``.

The shared library is built with ``g++`` at first use into ``build/native/``
at the repository root (git-ignored), named by a hash of the source and
flags, so an edited source rebuilds and an unchanged one is reused. A
failed build or load raises with the compiler's output: the tokenizer does
not fall back to its Python merger on an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "bpe.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfmt_bpe-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``bpe.cpp`` unless the library for this source exists ->
    the library path. Raises ``RuntimeError`` with g++'s output."""
    lib = library_path()
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}"
    cmd = ["g++", *CXX_FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded merger library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        i64 = ctypes.c_int64
        p64 = ctypes.POINTER(ctypes.c_int64)
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_new.argtypes = [i64, p64, p64, p64]
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_encode.restype = i64
        lib.bpe_encode.argtypes = [ctypes.c_void_p, p64, i64, p64, i64]
        _lib = lib
        return _lib


class NativeBPE:
    """Integer-domain BPE merger backed by bpe.cpp.

    Construction: ``merges`` as (rank-ordered) triples of vocab ids
    (left, right, merged). ``encode_word`` takes/returns vocab ids.
    """

    def __init__(self, triples: Sequence[Tuple[int, int, int]]):
        self._lib = load_library()
        arr = np.asarray(triples, np.int64).reshape(-1, 3)
        lefts = np.ascontiguousarray(arr[:, 0])
        rights = np.ascontiguousarray(arr[:, 1])
        merged = np.ascontiguousarray(arr[:, 2])
        p64 = ctypes.POINTER(ctypes.c_int64)
        self._handle = self._lib.bpe_new(
            len(arr), lefts.ctypes.data_as(p64), rights.ctypes.data_as(p64),
            merged.ctypes.data_as(p64))

    def __del__(self):
        if getattr(self, "_handle", None) and getattr(self, "_lib", None):
            self._lib.bpe_free(self._handle)
            self._handle = None

    def encode_word(self, symbol_ids: Sequence[int]) -> List[int]:
        n = len(symbol_ids)
        if n <= 1:
            return list(symbol_ids)
        inp = np.asarray(symbol_ids, np.int64)
        out = np.empty(n, np.int64)
        p64 = ctypes.POINTER(ctypes.c_int64)
        m = self._lib.bpe_encode(self._handle, inp.ctypes.data_as(p64), n,
                                 out.ctypes.data_as(p64), n)
        if m < 0:
            raise RuntimeError("bpe_encode: output buffer too small")
        return out[:m].tolist()
