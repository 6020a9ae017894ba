"""Read and write the ``.safetensors`` format without the ``safetensors``
package.

A file is an 8-byte little-endian header length, a JSON header mapping each
name to its ``dtype``, ``shape`` and ``data_offsets`` (begin and end, in
bytes, into the data that follows), an optional ``__metadata__`` entry, and
then the tensors' raw little-endian bytes, C order. A checkpoint written
here loads with ``safetensors`` and the other way round.
"""
from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np
import torch

# safetensors dtype -> (torch dtype, numpy dtype of the same width)
_DTYPES = {
    "F64": (torch.float64, np.float64), "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16), "BF16": (torch.bfloat16, np.int16),
    "I64": (torch.int64, np.int64), "I32": (torch.int32, np.int32),
    "I16": (torch.int16, np.int16), "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8), "BOOL": (torch.bool, np.bool_),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}


def _to_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous()
    a = np.array(x, order="C")              # a copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":          # numpy's bfloat16 extension
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _raw(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    a = t.numpy()
    return a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()


def save_file(tensors: Dict[str, object], path: str) -> None:
    """Write ``{name: tensor or array}`` to ``path``."""
    header: Dict[str, object] = {}
    chunks, offset = [], 0
    for name in sorted(tensors):
        t = _to_tensor(tensors[name])
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        raw = _raw(t)
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)         # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in chunks:
            f.write(raw)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """``path`` -> ``{name: CPU tensor}`` in the file's dtypes."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{name}: unsupported safetensors dtype {info['dtype']}")
        tdt, ndt = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        a = np.frombuffer(data, dtype=np.dtype(ndt).newbyteorder("<"),
                          count=(end - begin) // np.dtype(ndt).itemsize,
                          offset=base + begin)
        t = torch.from_numpy(a.astype(ndt, copy=True)).reshape(info["shape"])
        out[name] = t.view(tdt) if tdt == torch.bfloat16 else t
    return out
