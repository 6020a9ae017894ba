"""Parameter-tree tooling: sizes, the trainable mask, partition and merge,
port of ``flamingo_mini_tpu/utils/params.py``.

Trees are nested dicts and lists of tensors. The freeze rules are the
reference's ``freeze_lm`` / ``freeze_vm``:

* vision tower: always frozen;
* LM trunk: frozen except the token-embedding matrix (which holds the
  ``<EOC>`` row; the head is tied to it), when ``freeze_lm``;
* resampler and gated xattn blocks: trainable.

Leaves are visited in the JAX package's pytree order (dict keys sorted,
list items in order), and ``state_dict_trainable`` names them with
``jax.tree_util.keystr``'s form (``['lm']['blocks'][0]['ln_1']['scale']``),
so both packages give the same keys.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure (None is a leaf)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_map(fn, *items) for items in zip(*trees))
    return fn(*trees)


def leaves_with_path(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) in pytree order; None leaves are skipped, as
    JAX skips them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def tree_size(params) -> int:
    return sum(int(x.numel()) for _, x in leaves_with_path(params))


def trainable_mask(
    params: Dict[str, Any],
    *,
    freeze_lm: bool = True,
    lm_embed_key: str = "wte",
) -> Dict[str, Any]:
    """Boolean mask tree: True = trainable.

    ``lm_embed_key`` is the name of the token-embedding leaf inside
    ``params['lm']`` ('wte' for GPT-2, 'embed_tokens' for OPT).
    """

    def mask_subtree(tree, value: bool):
        return tree_map(lambda _: value, tree)

    mask: Dict[str, Any] = {}
    for top, sub in params.items():
        if top == "vision":
            mask[top] = mask_subtree(sub, False)
        elif top == "lm":
            if freeze_lm:
                mask[top] = {k: mask_subtree(v, k == lm_embed_key)
                             for k, v in sub.items()}
            else:
                mask[top] = mask_subtree(sub, True)
        else:
            mask[top] = mask_subtree(sub, True)
    return mask


def partition_params(params, mask) -> Tuple[Any, Any]:
    """Split params into (trainable, frozen) trees with None holes."""
    trainable = tree_map(lambda p, m: p if m else None, params, mask)
    frozen = tree_map(lambda p, m: None if m else p, params, mask)
    return trainable, frozen


def merge_params(trainable, frozen):
    return tree_map(lambda t, f: t if t is not None else f, trainable, frozen)


def trainable_leaves(params, mask) -> List[Tuple[str, torch.Tensor]]:
    """(keystr path, leaf) of the trainable leaves in pytree order: the
    order of the leaves of JAX's trainable partition and of its optax
    state."""
    keep = dict(leaves_with_path(mask))
    return [(path, leaf) for path, leaf in leaves_with_path(params) if keep[path]]


def state_dict_trainable(params, mask) -> Dict[str, torch.Tensor]:
    """Flat {keystr path: leaf} of the trainable leaves: the reference's
    checkpoint of only the trainable weights."""
    return dict(trainable_leaves(params, mask))


def set_requires_grad(params, mask) -> None:
    """``requires_grad`` on the trainable leaves and off on the frozen ones,
    in place: autograd then differentiates only the trainable partition."""
    keep = dict(leaves_with_path(mask))
    for path, leaf in leaves_with_path(params):
        leaf.requires_grad_(bool(keep[path]))
