"""Round-trip a checkpoint out of this package into the reference's
layout, port of the JAX package's ``examples/export_to_torch.py``.

The reference is a HuggingFace ``PreTrainedModel``; models trained here
export to its ``flamingo.*`` state-dict layout (vision tower excluded, the
reference's checkpoint convention) through ``save_pretrained(save_format=
"hf")`` or ``push_to_hub``, so the reference's users load them unchanged.
This builds a tiny model, exports it in both layouts, loads the export back
through ``from_pretrained`` and checks that the greedy tokens are
identical; then stages ``push_to_hub`` in a fresh temporary ``HF_HOME``
and loads the staged checkpoint by its hub id. ``huggingface_hub`` is
hidden meanwhile, so the upload fails at its import and ``push_to_hub``
only stages, as it does wherever the hub is out of reach: nothing is
uploaded, and the user's cache is never touched (the environment and the
module table are restored afterwards).

    python -m flamingo_mini_tpu_torch.examples.export_to_torch [--device cpu]
"""
import os
import sys
import tempfile
from typing import List, Optional
from unittest import mock

import numpy as np
import torch

from .. import FlamingoConfig, FlamingoModel
from . import parse_args

_ABSENT = object()


def main(argv: Optional[List[str]] = None) -> List[int]:
    args = parse_args(__doc__, argv)
    config = FlamingoConfig(
        lm="gpt2", dim=64, dim_visual=64, xattn_every=2, xattn_dim_head=16,
        xattn_heads=4, resampler_depth=2, resampler_dim_head=16,
        resampler_heads=4, resampler_num_latents=8,
        lm_arch_overrides=dict(vocab_size=256, n_positions=128, n_embd=64,
                               n_layer=4, n_head=4),
        vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   image_size=64, patch_size=16))
    model = FlamingoModel(config, device=args.device, seed=0)

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "export")
        model.save_pretrained(out, save_format="both")
        print("exported:", sorted(os.listdir(out)))

        loaded = FlamingoModel.from_pretrained(out, device=args.device)
        ids = np.arange(4)[None].astype(np.int32)
        a = model.generate(ids, max_length=12, eos_token_id=999, pad_token_id=0)
        b = loaded.generate(ids, max_length=12, eos_token_id=999, pad_token_id=0)
        if not torch.equal(a, b):
            raise RuntimeError(f"reload changed greedy tokens: {a.tolist()} vs {b.tolist()}")
        print("self round-trip OK; greedy tokens identical:", a[0, 4:].tolist())

        # a fresh HF_HOME, huggingface_hub hidden; the caller's back after
        hub = sys.modules.get("huggingface_hub", _ABSENT)
        sys.modules["huggingface_hub"] = None
        try:
            with mock.patch.dict(os.environ, HF_HOME=os.path.join(tmp, "hf_home")):
                snap = model.push_to_hub("demo/flamingo-tpu-export", save_format="npz")
                again = FlamingoModel.from_pretrained("demo/flamingo-tpu-export",
                                                      device=args.device)
        finally:
            if hub is _ABSENT:
                del sys.modules["huggingface_hub"]
            else:
                sys.modules["huggingface_hub"] = hub
        print("push_to_hub staged at", snap)
        print("from_pretrained('demo/flamingo-tpu-export') OK:",
              type(again).__name__)
    return a[0, 4:].tolist()


if __name__ == "__main__":
    main()
