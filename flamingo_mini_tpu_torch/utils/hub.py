"""Hub-id -> local-path resolution against a warm HuggingFace cache, a copy
of ``flamingo_mini_tpu/utils/hub.py`` (stdlib only).

The reference is a ``PreTrainedModel``: ``from_pretrained('dhansmair/
flamingo-mini')`` resolves through the HF hub machinery
(the reference's modeling_flamingo.py:359-376 and README.md:33).
This framework targets zero-egress environments, so network fetching is out
of scope by design — but a hub id must still resolve whenever the files
already exist locally, i.e. in the standard HF cache layout::

    $HF_HOME/hub/models--{org}--{name}/snapshots/{commit}/...

Snapshot choice follows huggingface_hub: the commit recorded in
``refs/main`` when present, otherwise the newest snapshot that contains the
required file.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Sequence

_HUB_ID_RE = re.compile(r"^[\w.\-]+(/[\w.\-]+)?$")


def hf_hub_dir() -> str:
    hf_home = os.environ.get(
        "HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    return os.path.join(hf_home, "hub")


def _snapshot_for(model_dir: str, required: Sequence[str]) -> Optional[str]:
    snaps = os.path.join(model_dir, "snapshots")
    if not os.path.isdir(snaps):
        return None

    def has_required(d: str) -> bool:
        return all(os.path.isfile(os.path.join(d, r)) for r in required)

    ref_main = os.path.join(model_dir, "refs", "main")
    if os.path.isfile(ref_main):
        with open(ref_main) as f:
            commit = f.read().strip()
        cand = os.path.join(snaps, commit)
        if os.path.isdir(cand) and has_required(cand):
            return cand
    # fall back: newest snapshot holding the required files
    entries = sorted(
        (os.path.join(snaps, s) for s in os.listdir(snaps)),
        key=os.path.getmtime, reverse=True)
    for cand in entries:
        if os.path.isdir(cand) and has_required(cand):
            return cand
    return None


def resolve_checkpoint_dir(
    path_or_id: str,
    required: Sequence[str] = ("config.json",),
) -> str:
    """Return a local directory for ``path_or_id``.

    Accepts a filesystem path (returned as-is) or a hub id like
    ``dhansmair/flamingo-mini`` resolved from the local HF cache. Raises
    FileNotFoundError when neither works (this framework never fetches).
    """
    if os.path.isdir(path_or_id) or os.path.isfile(path_or_id):
        return path_or_id
    if _HUB_ID_RE.match(path_or_id):
        cache_name = "models--" + path_or_id.replace("/", "--")
        model_dir = os.path.join(hf_hub_dir(), cache_name)
        if os.path.isdir(model_dir):
            snap = _snapshot_for(model_dir, required)
            if snap is not None:
                return snap
        raise FileNotFoundError(
            f"{path_or_id!r} is not a local directory and no usable snapshot "
            f"exists under {model_dir} (zero-egress: files must already be "
            f"cached — e.g. via `huggingface-cli download {path_or_id}` on a "
            f"networked machine)")
    raise FileNotFoundError(f"no such checkpoint directory: {path_or_id!r}")


def stage_into_cache(repo_id: str, save) -> str:
    """Write a checkpoint into the local HF cache layout for ``repo_id``.

    ``save`` is a callable that writes the checkpoint files into a directory.
    Creates ``models--org--name/snapshots/local-{n}`` and points
    ``refs/main`` at it, so ``resolve_checkpoint_dir(repo_id)`` (and hence
    ``from_pretrained(repo_id)``) finds it. Returns the snapshot dir."""
    if not _HUB_ID_RE.match(repo_id):
        raise ValueError(f"not a valid hub repo id: {repo_id!r}")
    model_dir = os.path.join(
        hf_hub_dir(), "models--" + repo_id.replace("/", "--"))
    snaps = os.path.join(model_dir, "snapshots")
    os.makedirs(snaps, exist_ok=True)
    n = 0
    while os.path.exists(os.path.join(snaps, f"local-{n}")):
        n += 1
    snap = os.path.join(snaps, f"local-{n}")
    os.makedirs(snap)
    save(snap)
    refs = os.path.join(model_dir, "refs")
    os.makedirs(refs, exist_ok=True)
    with open(os.path.join(refs, "main"), "w") as f:
        f.write(f"local-{n}")
    return snap
