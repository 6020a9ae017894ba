"""Training data pipeline, port of ``flamingo_mini_tpu/train/data.py``.

The reference's COCO pipeline semantics (its training/train.py:37-84):

* caption template ``f"{random ['' or ' ']}<image>{caption}<EOC></s>"``: the
  random leading space varies the '<' token id between the two leq_ids
  (train.py:56), exercising both media-location variants;
* the collator tokenizes the batch, stacks pixel values, and sets
  ``labels = input_ids`` (loss over the full sequence; pads are eos);
* images: any indexable dataset yielding (image, captions) works. A COCO
  adapter (torchvision, where it and the data are present) and a synthetic
  dataset (tests, smoke runs; no downloads) are provided.

Fixed ``length`` padding on the right, as in the JAX package. The collator
builds the batch on its processor's device (the host, for a processor made
with ``device="cpu"``); ``prefetch_to_device`` moves host batches to the
card one step ahead of the trainer.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..flamingo_processor import FlamingoProcessor


@dataclass
class CaptionSample:
    image: Any                 # HWC uint8 array or PIL image
    caption: str


class SyntheticCaptionDataset:
    """Deterministic synthetic (image, caption) pairs: no downloads."""

    def __init__(self, size: int = 256, image_hw: int = 64,
                 vocab: Optional[Sequence[str]] = None, seed: int = 0):
        self.size = size
        self.image_hw = image_hw
        self.vocab = list(vocab or ["a", "cat", "dog", "picture", "of", "red",
                                    "blue", "small", "big", "bird"])
        self.seed = seed

    def __len__(self):
        return self.size

    def __getitem__(self, i: int) -> CaptionSample:
        rs = np.random.RandomState(self.seed + i)
        img = rs.randint(0, 255, (self.image_hw, self.image_hw, 3), np.uint8)
        words = [self.vocab[rs.randint(len(self.vocab))]
                 for _ in range(rs.randint(3, 8))]
        return CaptionSample(image=img, caption=" ".join(words))


class CocoCaptionDataset:
    """COCO Captions via torchvision (local data only). One random caption
    per image is chosen at access time, as in the reference (train.py:56).
    Without torchvision it raises ``ImportError``."""

    def __init__(self, root: str, ann_file: str):
        from torchvision.datasets import CocoCaptions
        self.ds = CocoCaptions(root=root, annFile=ann_file)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i: int) -> CaptionSample:
        img, captions = self.ds[i]
        return CaptionSample(image=img, caption=random.choice(captions))


class CocoCaptionEvalDataset:
    """COCO val split for captioning eval: (image, all reference captions),
    the shape ``evaluate_image_captioning`` takes (the reference evaluates
    COCO val with every annotation as a reference; train.py:160-168)."""

    def __init__(self, root: str, ann_file: str):
        from torchvision.datasets import CocoCaptions
        self.ds = CocoCaptions(root=root, annFile=ann_file)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i: int):
        img, captions = self.ds[i]
        return img, list(captions)


class SyntheticEvalDataset:
    """(image, [caption]) view over SyntheticCaptionDataset for eval."""

    def __init__(self, ds: SyntheticCaptionDataset):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i: int):
        s = self.ds[i]
        return s.image, [s.caption]


class DataCollator:
    """Samples -> model batch dict of tensors on the processor's device:
    ``input_ids`` and ``labels`` int64, ``media_locations`` and
    ``attention_mask`` int32, ``pixel_values`` (b, 1, c, h, w) float32. The
    leading spaces and flips draw from ``random.Random(seed)`` in the JAX
    collator's order, so both packages collate the same batches."""

    def __init__(self, processor: FlamingoProcessor, length: int = 64,
                 random_leading_space: bool = True, hflip_prob: float = 0.5,
                 seed: int = 0):
        self.processor = processor
        self.length = length
        self.random_leading_space = random_leading_space
        # train-time augmentation: the reference composes RandomHorizontalFlip
        # (p=0.5) before the CLIP transform (its training/train.py:40-45)
        self.hflip_prob = hflip_prob
        self._rng = random.Random(seed)

    def _maybe_flip(self, image):
        if self.hflip_prob > 0 and self._rng.random() < self.hflip_prob:
            return np.asarray(image)[:, ::-1]
        return image

    def __call__(self, samples: Sequence[CaptionSample]) -> dict:
        texts = []
        for s in samples:
            lead = self._rng.choice(["", " "]) if self.random_leading_space else ""
            texts.append(lead + self.processor.prepare_caption(s.caption))
        pixels = self.processor.preprocess_images(
            [self._maybe_flip(s.image) for s in samples])
        ids, media, mask = self.processor.encode_text(
            texts, length=self.length, pad_side="right")
        return {"input_ids": ids, "media_locations": media, "attention_mask": mask,
                "pixel_values": pixels[:, None], "labels": ids}


def batches(dataset, collator: DataCollator, batch_size: int,
            shuffle: bool = True, seed: int = 0,
            drop_last: bool = True) -> Iterator[dict]:
    """One epoch of collated batches, shuffled by ``RandomState(seed)``."""
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    for start in range(0, len(idx), batch_size):
        chunk = idx[start:start + batch_size]
        if drop_last and len(chunk) < batch_size:
            return
        yield collator([dataset[int(i)] for i in chunk])


def prefetch_to_device(batch_iter: Iterator[dict], device,
                       cast_pixels: Optional[Callable] = None) -> Iterator[dict]:
    """Batches on ``device``, the copy of batch i+1 queued before batch i
    is handed to the trainer.

    Each host tensor is pinned and copied with ``non_blocking=True`` on the
    current stream: the host goes on to launch step i while the copy is in
    flight, and step i + 1's kernels queue behind it. Tensors already on
    ``device`` stay where they are; with ``device`` the CPU nothing moves.
    ``cast_pixels`` (the policy's cast) is applied to ``pixel_values`` after
    the copy."""
    device = torch.device(device)

    def put(b):
        b = dict(b)
        for k, t in b.items():
            t = torch.as_tensor(t)
            if t.device != device:
                t = (t.pin_memory() if device.type == "cuda" else t).to(
                    device, non_blocking=True)
            b[k] = t
        if cast_pixels is not None and "pixel_values" in b:
            b["pixel_values"] = cast_pixels(b["pixel_values"])
        return b

    it = iter(batch_iter)
    try:
        pending = put(next(it))
    except StopIteration:
        return
    for nxt in it:
        nxt_dev = put(nxt)
        yield pending
        pending = nxt_dev
    yield pending
