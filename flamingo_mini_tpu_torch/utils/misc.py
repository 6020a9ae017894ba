"""Misc utilities, a copy of ``flamingo_mini_tpu/utils/misc.py`` (the
reference's utils.py:10-19). PIL and ``requests`` are imported inside the
functions that need them."""
from __future__ import annotations

from typing import List, Sequence, Tuple


def load_url(url: str):
    """PIL image from an HTTP(S) URL (requires network; reference
    utils.py:10-11)."""
    import requests
    from PIL import Image

    return Image.open(requests.get(url, stream=True).raw)


def load_image(path: str):
    """PIL image from a local path (reference utils.py:14-15)."""
    from PIL import Image

    return Image.open(path)


def unzip(seq: Sequence[Tuple]) -> List[Tuple]:
    """[(a1,b1), (a2,b2), ...] -> [(a1,a2,...), (b1,b2,...)]
    (reference utils.py:18-19)."""
    return list(zip(*seq))
