"""Throughput-oriented batch captioning (the deployment recipe), port of
the JAX package's ``examples/batch_serving.py``.

The serving loop's shape: load once, ``to_bf16()`` (and ``quantize_int8()``
with ``FLAMINGO_INT8=1``), then stream batches of 16 images through
``generate_captions``; the weights stay on the card between requests. The
first batch also builds the kernels where they are not built yet.

    python -m flamingo_mini_tpu_torch.examples.batch_serving [--device cpu]
"""
import os
import time
from typing import List, Optional

import numpy as np

from .. import FlamingoConfig, FlamingoModel, FlamingoProcessor
from ..tokenizer import build_toy_tokenizer
from . import parse_args


def main(argv: Optional[List[str]] = None) -> List[List[str]]:
    args = parse_args(__doc__, argv)
    ckpt = os.environ.get("FLAMINGO_CKPT")
    if ckpt:
        model = FlamingoModel.from_pretrained(ckpt, device=args.device)
        processor = FlamingoProcessor(model.config, device=args.device)
    else:
        config = FlamingoConfig(lm="gpt2", dim=768, dim_visual=768,
                                compute_dtype="bfloat16")
        model = FlamingoModel(config, device=args.device)
        processor = FlamingoProcessor(config, tokenizer=build_toy_tokenizer(
            ["image", "a", "picture", "of"]), device=args.device)

    # deployment transforms: bf16 weight storage (+ int8 for the LM trunk)
    model.to_bf16()
    if os.environ.get("FLAMINGO_INT8") == "1":
        model.quantize_int8()

    batch, max_length = 16, 36
    rs = np.random.RandomState(0)

    def batch_of_images(seed):
        return [rs.randint(0, 255, (224, 224, 3), np.uint8) for _ in range(batch)]

    every = []
    for i in range(3):
        t0 = time.perf_counter()
        caps = model.generate_captions(processor, images=batch_of_images(i),
                                       max_length=max_length)
        dt = time.perf_counter() - t0
        label = "compile+run" if i == 0 else "run"
        print(f"batch {i} ({label}): {dt:.2f}s  "
              f"({batch/dt:.1f} captions/s)  e.g. {caps[0][:40]!r}")
        every.append(caps)
    return every


if __name__ == "__main__":
    main()
