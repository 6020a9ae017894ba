"""Image captioning demo (the reference's examples/image_captioning.py),
port of the JAX package's ``examples/image_captioning.py``.

With a converted checkpoint directory (``FLAMINGO_CKPT``, with its local
vocab files) this gives the reference's captions; without one it runs on
random weights to show the API. ``FLAMINGO_IMAGE`` names an image file;
without it a random image is captioned.

    python -m flamingo_mini_tpu_torch.examples.image_captioning [--device cpu]
"""
import os
from typing import List, Optional

import numpy as np

from .. import FlamingoConfig, FlamingoModel, FlamingoProcessor
from . import parse_args


def main(argv: Optional[List[str]] = None) -> str:
    args = parse_args(__doc__, argv)
    ckpt = os.environ.get("FLAMINGO_CKPT")
    if ckpt:
        model = FlamingoModel.from_pretrained(ckpt, device=args.device)
        processor = FlamingoProcessor(model.config, device=args.device)
    else:
        print("FLAMINGO_CKPT not set -> random weights + toy tokenizer demo")
        from ..tokenizer import build_toy_tokenizer
        config = FlamingoConfig(
            lm="gpt2", dim=768, dim_visual=768, compute_dtype="bfloat16")
        model = FlamingoModel(config, device=args.device)
        processor = FlamingoProcessor(
            config, tokenizer=build_toy_tokenizer(
                ["image", "a", "picture", "of", "cat"]), device=args.device)

    image_path = os.environ.get("FLAMINGO_IMAGE")
    if image_path:
        from PIL import Image
        image = Image.open(image_path)
    else:
        image = np.random.RandomState(0).randint(0, 255, (480, 640, 3), np.uint8)

    caption = model.generate_captions(processor, images=[image], max_length=30)
    print("caption:", caption[0])
    return caption[0]


if __name__ == "__main__":
    main()
