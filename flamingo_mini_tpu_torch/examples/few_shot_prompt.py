"""Few-shot interleaved prompting (the reference's
examples/few_shot_prompt.ipynb), port of the JAX package's
``examples/few_shot_prompt.py``.

One sequence with k (image, caption) shots and a query image,
``<image>cap1<EOC><image>cap2<EOC>...<image>``: the media masking routes
each text span to its own image; then the final caption is generated.

    python -m flamingo_mini_tpu_torch.examples.few_shot_prompt [--device cpu]
"""
from typing import List, Optional

import numpy as np

from .. import FlamingoConfig, FlamingoModel, FlamingoProcessor
from ..tokenizer import build_toy_tokenizer
from . import parse_args


def main(argv: Optional[List[str]] = None) -> str:
    args = parse_args(__doc__, argv)
    config = FlamingoConfig(lm="gpt2", dim=768, dim_visual=768,
                            compute_dtype="bfloat16")
    model = FlamingoModel(config, device=args.device)
    processor = FlamingoProcessor(config, tokenizer=build_toy_tokenizer(
        ["image", "a", "picture", "of", "cat", "dog", "bird"]), device=args.device)

    shots = [("a cat", None), ("a dog", None)]
    prompt = ""
    rs = np.random.RandomState(0)
    images = []
    for caption, _ in shots:
        prompt += f"<image>{caption}{processor.eoc_token}"
        images.append(rs.randint(0, 255, (224, 224, 3), np.uint8))
    prompt += "<image>"                      # the query image
    images.append(rs.randint(0, 255, (224, 224, 3), np.uint8))

    ids, media, mask = processor.encode_text(prompt)
    pixels = processor.preprocess_images(images)[None]   # (1, N, c, h, w)

    out = model.generate(ids, media_locations=media, attention_mask=mask,
                         pixel_values=pixels, max_length=ids.shape[1] + 20)
    text = processor.tokenizer.batch_decode(out.cpu(), skip_special_tokens=True)[0]
    text = processor.remove_tags(text)
    print("continuation:", text)
    return text


if __name__ == "__main__":
    main()
