"""Video captioning: 8-frame clips through the time-embedded resampler
(``resampler_num_time_embeds=8``: one learned time embedding added per
frame before the frames flatten into the feature axis), port of the JAX
package's ``examples/video_captioning.py``.

    python -m flamingo_mini_tpu_torch.examples.video_captioning [--device cpu]
"""
from typing import List, Optional

import numpy as np

from .. import FlamingoConfig, FlamingoModel, FlamingoProcessor
from ..tokenizer import build_toy_tokenizer
from . import parse_args


def main(argv: Optional[List[str]] = None) -> str:
    args = parse_args(__doc__, argv)
    config = FlamingoConfig(lm="gpt2", dim=768, dim_visual=768,
                            resampler_num_time_embeds=8,
                            compute_dtype="bfloat16")
    model = FlamingoModel(config, device=args.device)
    processor = FlamingoProcessor(config, tokenizer=build_toy_tokenizer(
        ["image", "a", "video", "of", "cat"]), device=args.device)

    # 8 frames -> (b=1, N=1, T=8, c, h, w)
    rs = np.random.RandomState(0)
    frames = [rs.randint(0, 255, (224, 224, 3), np.uint8) for _ in range(8)]
    pixels = processor.preprocess_images(frames)[None, None]  # (1, 1, 8, 3, H, W)

    ids, media, mask = processor.encode_text("<image>")
    out = model.generate(ids, media_locations=media, attention_mask=mask,
                         pixel_values=pixels, max_length=ids.shape[1] + 20)
    text = processor.tokenizer.batch_decode(out.cpu(), skip_special_tokens=True)[0]
    text = processor.remove_tags(text)
    print("video caption:", text)
    return text


if __name__ == "__main__":
    main()
