"""FlamingoProcessor: text and image preprocessing, port of
``flamingo_mini_tpu/flamingo_processor.py``.

The same public methods (``encode_text``, ``prepare_caption(s)``,
``remove_tags``, ``get_media_locations``, ``preprocess_images``,
``__call__``) and semantics: ``<EOC>`` an added token, pad = eos, the
families' BOS defaults (GPT-2: none; OPT: ``</s>``), left padding by
default, and media locations at either ``"<"`` id (with and without a
leading space), OR-ed. Tensors land on the processor's device (the card
unless the caller asks for the CPU): ``input_ids`` int64,
``media_locations`` and ``attention_mask`` int32, pixels float32, the
dtypes ``FlamingoModel.generate`` takes. Images go through
``ops.image.preprocess_images`` on that device; ``exact=True`` takes the
PIL path (Pillow needed).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .configuration_flamingo import FlamingoConfig
from .ops.image import preprocess_images as _preprocess_images
from .tokenizer import BPETokenizer


class FlamingoProcessor:
    def __init__(
        self,
        config: FlamingoConfig,
        tokenizer: Optional[BPETokenizer] = None,
        eoc_token: str = "<EOC>",
        vocab_path: Optional[str] = None,
        add_bos: Optional[bool] = None,
        device="cuda",
    ):
        """``add_bos=None`` keeps the family's default (GPT-2: no BOS;
        OPT: ``</s>``); True/False overrides it."""
        self.config = config
        self.device = torch.device(device)
        self.eoc_token = eoc_token
        if tokenizer is None:
            if config.lm.startswith("gpt"):
                tokenizer = (BPETokenizer.gpt2(vocab_path) if add_bos is None
                             else BPETokenizer.gpt2(vocab_path, add_bos=add_bos))
            elif config.lm.startswith("facebook/opt"):
                tokenizer = (BPETokenizer.opt(vocab_path) if add_bos is None
                             else BPETokenizer.opt(vocab_path, add_bos=add_bos))
            else:
                raise ValueError(f"unsupported lm {config.lm!r}")
        elif add_bos is not None:
            tokenizer.add_bos = add_bos
        self.tokenizer = tokenizer
        self.eoc_token_id = self.tokenizer.add_token(eoc_token)

        # the "<" ids with and without a leading space: media locations mark
        # the '<' of '<image>'
        self.leq_ids = [
            self.tokenizer.encode("<", add_special_tokens=False)[-1],
            self.tokenizer.encode(" <", add_special_tokens=False)[-1],
        ]

        arch = config.vision_arch
        self._image_size = arch.image_size
        self._image_mean = tuple(arch.image_mean)
        self._image_std = tuple(arch.image_std)

    # -- text ------------------------------------------------------------
    def encode_text(
        self,
        text: Union[str, List[str]],
        *,
        length: Optional[int] = None,
        max_length: Optional[int] = None,
        pad_side: str = "left",
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Tokenize -> (input_ids, media_locations, attention_mask).

        Rows are padded to a common length with pad = eos, on the left by
        default (decoder-only generation; the reference right-pads).
        ``length`` truncates or pads every row to it; ``max_length`` caps
        the longest row's width.
        """
        if isinstance(text, str):
            text = [text]
        encoded = [self.tokenizer.encode(t) for t in text]
        if length is not None:
            encoded = [e[:length] for e in encoded]
            width = length
        else:
            width = max(len(e) for e in encoded)
            if max_length is not None:
                encoded = [e[:max_length] for e in encoded]
                width = min(width, max_length)
        b = len(encoded)
        ids = np.full((b, width), self.tokenizer.pad_token_id, np.int64)
        mask = np.zeros((b, width), np.int32)
        for i, e in enumerate(encoded):
            if pad_side == "left":
                ids[i, width - len(e):] = e
                mask[i, width - len(e):] = 1
            else:
                ids[i, :len(e)] = e
                mask[i, :len(e)] = 1
        ids_t = torch.from_numpy(ids).to(self.device)
        return (ids_t, self.get_media_locations(ids_t),
                torch.from_numpy(mask).to(self.device))

    def get_media_locations(self, input_ids) -> torch.Tensor:
        """1 where the token is the '<' of an '<image>' tag (either id),
        int32 on the ids' device."""
        ids = torch.as_tensor(input_ids)
        out = torch.zeros_like(ids, dtype=torch.bool)
        for leq in self.leq_ids:
            out |= ids == leq
        # OR, not sum: where "<" and " <" share an id a sum would count each
        # tag twice and push text_time past the media count
        return out.to(torch.int32)

    def prepare_caption(self, caption: str) -> str:
        """'<image>' + caption + '<EOC>' + eos (BOS comes from the tokenizer)."""
        return "<image>" + caption + self.eoc_token + self.tokenizer.eos_token

    def prepare_captions(self, captions: List[str]) -> List[str]:
        return [self.prepare_caption(c) for c in captions]

    def _remove_tags(self, text: str) -> str:
        for s in ("<image>", self.tokenizer.eos_token, self.eoc_token,
                  self.tokenizer.pad_token):
            text = text.replace(s, "")
        return text.strip()

    def remove_tags(self, text: Union[str, List[str]]):
        if isinstance(text, str):
            return self._remove_tags(text)
        return [self._remove_tags(t) for t in text]

    # -- images ----------------------------------------------------------
    def preprocess_images(self, images, exact: bool = False) -> torch.Tensor:
        """PIL images / HWC arrays -> (n, 3, H, W) CLIP-normalized float32
        pixels on the processor's device.

        ``exact=True`` runs the host-side PIL pipeline, bit for bit the
        reference's ``CLIPImageProcessor`` (reference-checkpoint token
        parity from image files); it raises ``ImportError`` without Pillow."""
        if not isinstance(images, (list, tuple)):
            images = [images]
        if exact:
            from .ops.image import preprocess_images_pil
            try:
                pixels = preprocess_images_pil(
                    images, size=self._image_size, crop=self._image_size,
                    mean=self._image_mean, std=self._image_std)
            except ModuleNotFoundError as e:
                if e.name != "PIL":
                    raise
                raise ImportError("preprocess_images(exact=True) needs Pillow "
                                  "(PIL), which is not installed") from e
            return torch.from_numpy(pixels).to(self.device)
        return _preprocess_images(
            images, size=self._image_size, crop=self._image_size,
            mean=self._image_mean, std=self._image_std, device=self.device)

    def __call__(self, images=None, text=None):
        result = {}
        if images is not None:
            result["pixel_values"] = self.preprocess_images(images)
        if text is not None:
            ids, media, mask = self.encode_text(text)
            result["input_ids"] = ids
            result["media_locations"] = media
            result["attention_mask"] = mask
        return result
