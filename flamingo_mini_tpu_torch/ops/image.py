"""Image preprocessing (CLIPImageProcessor's chain), port of
``flamingo_mini_tpu/ops/image.py``.

``preprocess_images`` runs on the tensors' device (the card unless the
caller asks for the CPU), in plain PyTorch ops, as the JAX package runs
it in plain XLA:

  1. resize the shortest edge to ``size`` (the long edge is
     ``round(long * size / short)`` with Python's round, at least
     ``size``) with ``jax.image.resize``'s antialiased bicubic: per axis a
     weight matrix (the Keys cubic, widened by the downscale factor,
     columns normalized, samples outside the input zeroed), built on the
     host in float32 by JAX's formula (``resize_weights``);
  2. center crop ``crop x crop`` at ``(n - crop) // 2``: only the kept
     rows and columns of the weight matrices are built;
  3. clip to [0, 255] and scale by 1/255;
  4. normalize with the CLIP mean and std.

The two products (rows, then columns) run in float64, so the card and
the CPU give the same pixels to float32 rounding whatever the TF32
setting; ``F.interpolate(antialias=True)`` would not (its float32 sample
positions round differently on the card and on the CPU: up to 0.015 of the
0-255 scale on noise at 1,000 px). Output: (n, 3, crop, crop) float32. Each
image is resized alone, and the batch is stacked on the device. The weight
pair of a source shape stays on the device for the next image of that
shape: the last 16 shapes' pairs are kept, in float32, (h + w) x crop x 4
bytes each (1.8 MB for a 1,000 x 1,000 source at crop 224).

``preprocess_images_pil`` is the PIL path, bit for bit HF's
``CLIPImageProcessor`` (PIL is imported inside it, as in the JAX package);
it returns numpy.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_shape(h: int, w: int, size: int) -> Tuple[int, int]:
    """The resized (height, width): the shortest edge at ``size``."""
    if h <= w:
        return size, max(int(round(w * size / h)), size)
    return max(int(round(h * size / w)), size), size


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel (a = -0.5) in float32, as JAX evaluates it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def resize_weights(in_size: int, out_size: int, start: int, count: int) -> np.ndarray:
    """Rows ``start .. start + count`` of the antialiased bicubic resize from
    ``in_size`` to ``out_size`` samples: a (count, in_size) float32 matrix,
    ``jax.image.resize``'s weight matrix (``compute_weight_mat``)
    transposed, by its float32 formula."""
    inv = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv, np.float32(1.0))
    sample = (np.arange(start, start + count, dtype=np.float32) + np.float32(0.5)) \
        * inv - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, 0.0).T, dtype=np.float32)


@lru_cache(maxsize=16)
def _device_weights(h: int, w: int, size: int, crop: int,
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (rows, columns) weight pair of an ``h x w`` source on ``device``."""
    nh, nw = resize_shape(h, w, size)
    return tuple(torch.from_numpy(resize_weights(n, m, (m - crop) // 2, crop)).to(device)
                 for n, m in ((h, nh), (w, nw)))


def _resize_crop_one(img: torch.Tensor, size: int, crop: int) -> torch.Tensor:
    """(H, W, 3) -> (3, crop, crop) float32 in [0, 1]."""
    wh, ww = _device_weights(img.shape[0], img.shape[1], size, crop, img.device)
    x = torch.matmul(torch.matmul(wh.double(), img.permute(2, 0, 1).double()),
                     ww.double().t())
    return torch.clamp(x.float(), 0.0, 255.0) / 255.0


def normalize(x: torch.Tensor, mean: Tuple[float, ...] = CLIP_MEAN,
              std: Tuple[float, ...] = CLIP_STD) -> torch.Tensor:
    """(..., 3, H, W) in [0, 1] -> CLIP-normalized."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)[:, None, None]
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device)[:, None, None]
    return (x - mean_t) / std_t


def _as_hwc(im) -> np.ndarray:
    """A PIL-like image (anything with ``convert``) or an array -> (H, W, 3)."""
    if hasattr(im, "convert"):
        im = np.asarray(im.convert("RGB"))
    im = np.asarray(im)
    if im.ndim == 2:
        im = np.stack([im] * 3, axis=-1)
    return im


def preprocess_images(
    images: Sequence,
    *,
    size: int = 224,
    crop: int = 224,
    mean: Tuple[float, ...] = CLIP_MEAN,
    std: Tuple[float, ...] = CLIP_STD,
    device="cuda",
) -> torch.Tensor:
    """PIL images / HWC (or grayscale HW) arrays or tensors -> (n, 3, crop,
    crop) float32 CLIP-normalized pixels on ``device``. An image goes to
    the device in its own dtype (uint8 stays 1 byte a value)."""
    out = []
    for im in images:
        t = im if isinstance(im, torch.Tensor) else torch.from_numpy(
            np.require(_as_hwc(im), requirements=["C", "W"]))
        if t.ndim == 2:
            t = t[..., None].expand(*t.shape, 3)
        out.append(_resize_crop_one(t.to(device), size, crop))
    return normalize(torch.stack(out), tuple(mean), tuple(std))


def preprocess_images_pil(
    images: Sequence,
    *,
    size: int = 224,
    crop: int = 224,
    mean: Tuple[float, ...] = CLIP_MEAN,
    std: Tuple[float, ...] = CLIP_STD,
) -> np.ndarray:
    """Host-side PIL-exact preprocessing, bit for bit HF's
    ``CLIPImageProcessor``: PIL bicubic resize of the shortest edge, center
    crop, 1/255 rescale, float32 normalize. Returns a numpy (n, 3, crop,
    crop) float32 batch. Needs Pillow."""
    from PIL import Image

    out = []
    for im in images:
        if not hasattr(im, "convert"):
            arr = np.asarray(im)
            if arr.ndim == 2:
                arr = np.stack([arr] * 3, axis=-1)
            im = Image.fromarray(arr.astype(np.uint8))
        im = im.convert("RGB")
        w, h = im.size
        # HF get_resize_output_image_size(default_to_square=False):
        # new_long = int(size * long / short)
        short, long = (w, h) if w <= h else (h, w)
        new_short, new_long = size, int(size * long / short)
        nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
        im = im.resize((nw, nh), resample=Image.BICUBIC)
        arr = np.asarray(im)                                  # (nh, nw, 3) u8
        top = (nh - crop) // 2
        left = (nw - crop) // 2
        arr = arr[top:top + crop, left:left + crop]
        # HF rescale: float multiply then astype(float32)
        x = (arr * (1.0 / 255.0)).astype(np.float32)
        # HF normalize: channels-last, mean/std cast to image dtype
        m = np.array(mean, dtype=x.dtype)
        s = np.array(std, dtype=x.dtype)
        x = (x - m) / s
        out.append(x.transpose(2, 0, 1))                      # channel-first
    return np.stack(out)
