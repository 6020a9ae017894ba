"""The JAX package's ``examples/*.py`` on the port, one module each, under
the same names: ``image_captioning``, ``batch_serving``,
``few_shot_prompt``, ``video_captioning``, ``model_stats`` and
``export_to_torch``. Each runs as

    python -m flamingo_mini_tpu_torch.examples.<name> [--device cpu]

on the card unless ``--device`` says otherwise, and is a ``main(argv)`` that
can be called in-process. ``FLAMINGO_CKPT`` (a checkpoint directory or a
cached hub id) and ``FLAMINGO_IMAGE`` (an image file, read with Pillow) keep
their meaning.
"""
import argparse
from typing import List, Optional


def parse_args(doc: str, argv: Optional[List[str]] = None) -> argparse.Namespace:
    """An example's command line: ``--device`` (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the model's device")
    return ap.parse_args(argv)
