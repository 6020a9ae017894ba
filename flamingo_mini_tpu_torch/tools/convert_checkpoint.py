"""Convert a reference (HF PyTorch) flamingo-mini checkpoint to the port's
native format, port of the JAX package's ``tools/convert_checkpoint.py``.

    python -m flamingo_mini_tpu_torch.tools.convert_checkpoint SRC DST [--clip-checkpoint DIR]

SRC: an HF checkpoint directory (``config.json`` + ``model.safetensors`` or
``pytorch_model.bin``), e.g. a local clone of dhansmair/flamingo-mini, or a
hub id already in the local HF cache. Such checkpoints leave out the CLIP
vision tower (the reference's convention): ``--clip-checkpoint`` embeds a
local CLIP checkpoint; without it the tower is initialised from a seed
(fine for decode parity, wrong for real captions). DST receives
``config.json`` and ``flamingo_tpu.npz`` (``FlamingoModel.save_pretrained``),
and the tokenizer files (``vocab.json``, ``merges.txt``, ``tokenizer.json``)
where SRC has them, so that it is self-contained offline. The weights pass
through ``--device`` (the card unless ``--device cpu``).
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import List, Optional

from ..modeling_flamingo import FlamingoModel
from ..utils.hub import resolve_checkpoint_dir

VOCAB_FILES = ("vocab.json", "merges.txt", "tokenizer.json")


def main(argv: Optional[List[str]] = None) -> FlamingoModel:
    ap = argparse.ArgumentParser(prog="python -m flamingo_mini_tpu_torch.tools.convert_checkpoint",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--clip-checkpoint", default=None)
    ap.add_argument("--device", default="cuda", help="the weights' device")
    args = ap.parse_args(argv)

    model = FlamingoModel.from_pretrained(
        args.src, clip_checkpoint=args.clip_checkpoint, device=args.device)
    model.save_pretrained(args.dst)

    src = resolve_checkpoint_dir(args.src)
    for name in VOCAB_FILES:
        path = os.path.join(src, name)
        if os.path.isfile(path):
            shutil.copy(path, os.path.join(args.dst, name))

    vision = f"from {args.clip_checkpoint}" if args.clip_checkpoint else "random-init"
    print(f"converted {args.src} -> {args.dst} ({model.num_parameters():,} params, "
          f"vision={vision})")
    return model


if __name__ == "__main__":
    main()
