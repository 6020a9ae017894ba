"""Megatron slices of the Flamingo parameter tree, port of
``flamingo_mini_tpu/parallel/sharding.py``.

JAX annotates each leaf with a ``PartitionSpec`` and lets GSPMD insert the
collectives. The port runs an explicit rank per device of the ``model``
axis, so the same rule (``_spec_for``) decides which slice of each leaf a
rank holds, and the model code (``ops/layers.py``'s ``column_linear`` and
``row_linear``, the vocab-parallel embedding and head) does the
collectives itself:

* column-parallel (``_COL``: attention q/k/v, MLP in): the output dimension
  split, the bias with it;
* row-parallel (``_ROW``: attention out, MLP out): the input dimension
  split, the bias replicated and added once after the reduction;
* the token embedding (``_VOCAB``, int8 ``_VOCAB_Q``): the vocab rows split,
  after ``pad_vocab_params`` padded them to a multiple of the model axis;
* everything else, and any dimension that does not divide, replicated.

A spec is a tuple like JAX's ``PartitionSpec``: ``()`` replicated,
``(None, "model")`` the second dimension split, ``("model", None)`` the
first.

Two points where an explicit rank differs from GSPMD's layout:

* fused projections. GPT-2's ``c_attn`` ``(d, 3d)`` packs q, k and v and
  the xattn ``to_kv`` ``(d_visual, 2 inner)`` packs k and v on the output
  dimension (``FUSED``). JAX splits that dimension in plain blocks, which
  GSPMD may do since it does not care which columns a device holds. A
  Megatron rank computes its own heads, so rank r holds ``[q_r | k_r |
  v_r]`` (``[k_r | v_r]``), head-aligned, and so do the bias and the int8
  ``scale``. Every other leaf's slice is JAX's shard for that position.
* int8 linears. JAX's rule reads the leaf's name unless it is ``w`` or
  ``b``, so an int8 linear's ``w8`` and ``scale`` fall through to
  replication and TP over int8 weights pools only biases and the
  embedding. Here ``w8`` takes its float ``w``'s spec and ``scale`` (per
  output channel) its ``b``'s: split in a column layer, replicated in a
  row layer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from . import comm

Params = Dict[str, Any]
Spec = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class AxisNames:
    data: str = "data"
    model: str = "model"


# Column-parallel = split output dim; row-parallel = split input dim.
_COL = {"c_attn", "mlp_fc", "q_proj", "k_proj", "v_proj", "fc1",
        "to_q", "to_k", "to_v", "to_kv"}
_ROW = {"c_proj", "mlp_proj", "out_proj", "fc2", "to_out"}
_VOCAB = {"wte", "embed_tokens"}
_VOCAB_Q = {"wte_q", "embed_tokens_q"}  # int8: {w8 (V, d), scale (V,)}
# fused column projections -> the parts packed on the output dimension
FUSED = {"c_attn": 3, "to_kv": 2}


def _spec_for(path: str, shape, model_axis: Optional[str], model_size: int) -> Spec:
    """JAX's rule for the leaf at dotted ``path`` of ``shape``."""
    ndim = len(shape)
    if model_axis is None or ndim == 0:
        return ()

    def ok(dim):  # a dim is shardable only if evenly divisible
        return shape[dim] % model_size == 0

    leaf = path.split(".")[-1]
    parent = path.split(".")[-2] if "." in path else ""
    name = parent if leaf in ("w", "b") else leaf
    if name in _COL:
        if leaf == "b":
            return (model_axis,) if ok(0) else ()
        return (None, model_axis) if ndim == 2 and ok(1) else ()
    if name in _ROW and leaf == "w":
        return (model_axis, None) if ndim == 2 and ok(0) else ()
    if name in _VOCAB and ndim == 2 and ok(0):
        return (model_axis, None)
    if parent in _VOCAB_Q and ok(0):
        return (model_axis, None) if ndim == 2 else (model_axis,)
    return ()


def leaf_spec(path: str, shape, model_axis: Optional[str], model_size: int) -> Spec:
    """The port's rule: ``_spec_for``, with an int8 linear's ``w8`` read as
    its ``w`` and its ``scale`` as its ``b``."""
    parts = path.split(".")
    if len(parts) >= 2 and parts[-2] in _COL | _ROW and parts[-1] in ("w8", "scale"):
        path = ".".join(parts[:-1] + [{"w8": "w", "scale": "b"}[parts[-1]]])
    return _spec_for(path, shape, model_axis, model_size)


def _walk(tree, fn, prefix=""):
    """``fn(dotted path, leaf)`` over the tree (JAX's path form: list items
    by index)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def fused_parts(path: str) -> int:
    """How many projections the leaf at ``path`` packs on its split
    dimension (``FUSED``), else 1."""
    parts = path.split(".")
    return FUSED.get(parts[-2], 1) if len(parts) >= 2 else 1


def _split_dim(spec: Spec) -> Optional[int]:
    for dim, axis in enumerate(spec):
        if axis is not None:
            return dim
    return None


def shard_leaf(x: torch.Tensor, spec: Spec, rank: int, world: int,
               parts: int = 1) -> torch.Tensor:
    """Rank ``rank``'s slice of ``x`` under ``spec``; a fused leaf
    (``parts`` > 1) gives each packed projection's ``rank``-th block."""
    dim = _split_dim(spec)
    if dim is None or world == 1:
        return x
    chunks = x.chunk(parts, dim=dim)
    return torch.cat([c.chunk(world, dim=dim)[rank] for c in chunks],
                     dim=dim).contiguous()


def unshard_leaf(slices, spec: Spec, parts: int = 1) -> torch.Tensor:
    """The inverse of ``shard_leaf`` over every rank's slice, in rank order."""
    dim = _split_dim(spec)
    if dim is None or len(slices) == 1:
        return slices[0]
    split = [s.chunk(parts, dim=dim) for s in slices]
    return torch.cat([torch.cat([s[j] for s in split], dim=dim)
                      for j in range(parts)], dim=dim)


def shard_params(params: Params, rank: int, world: int,
                 tensor_parallel: bool = True) -> Params:
    """Rank ``rank``'s slice of every leaf on a model axis of ``world``
    ranks: views where the slice is contiguous, copies elsewhere."""
    model_axis = AxisNames().model if tensor_parallel else None
    return _walk(params, lambda path, x: shard_leaf(
        x, leaf_spec(path, tuple(x.shape), model_axis, world), rank, world,
        fused_parts(path)))


def leaf_splits(params: Params, model_size: int,
                tensor_parallel: bool = True) -> Dict[str, Tuple[Spec, int]]:
    """{dotted path: (spec, packed projections)} of every leaf of the whole
    (padded) tree."""
    out: Dict[str, Tuple[Spec, int]] = {}
    model_axis = AxisNames().model if tensor_parallel else None
    _walk(params, lambda path, x: out.__setitem__(path, (leaf_spec(
        path, tuple(x.shape), model_axis, model_size), fused_parts(path))))
    return out


def gather_params(params: Params, splits: Dict[str, Tuple[Spec, int]],
                  group) -> Params:
    """The whole tree from every rank's slices on ``group`` (``splits``:
    ``leaf_splits`` of the whole tree)."""
    return _walk(params, lambda path, x: gather_leaf(x, *splits[path], group))


def gather_leaf(x: torch.Tensor, spec: Spec, parts: int, group) -> torch.Tensor:
    """The whole leaf from every rank's slice ``x`` on ``group`` (the
    inverse of ``shard_leaf``); a replicated leaf as it is."""
    dim = _split_dim(spec)
    n = comm.size(group)
    if dim is None or n == 1:
        return x
    whole = comm.all_gather(x.detach(), group, dim=dim)
    return unshard_leaf(whole.chunk(n, dim=dim), spec, parts)


def pad_vocab_params(params: Params, multiple: int) -> Params:
    """Pad the token-embedding rows up to a ``multiple`` so the largest
    tensor (vocab x d, tied lm_head) shards on the model axis instead of
    replicating: vocab + 1 (the ``<EOC>`` row) breaks divisibility. Padding
    rows are zeros (int8 scale rows are ones); their logits are masked to
    finfo.min in the head (``gpt2.tied_head``'s ``n_valid``), so argmax and
    softmax are unchanged. Takes the full Flamingo tree or the LM subtree;
    returns a new tree (shared leaves), unchanged where already divisible.
    A tree without a token embedding raises ``ValueError``."""

    def pad_rows(x, rows, fill=0.0):
        pad = torch.full((rows,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        return torch.cat([x, pad], dim=0)

    lm = dict(params["lm"]) if "lm" in params else dict(params)
    known = ("wte", "embed_tokens", "wte_q", "embed_tokens_q")
    if not any(k in lm for k in known):
        raise ValueError(
            "pad_vocab_params: no token-embedding key found (expected one of "
            f"{known}); pass the full Flamingo params or the LM subtree")
    for key in ("wte", "embed_tokens"):
        if key in lm:
            rows = (-lm[key].shape[0]) % multiple
            if rows:
                lm[key] = pad_rows(lm[key], rows)
        qkey = key + "_q"
        if qkey in lm:
            rows = (-lm[qkey]["w8"].shape[0]) % multiple
            if rows:
                lm[qkey] = {**lm[qkey], "w8": pad_rows(lm[qkey]["w8"], rows),
                            "scale": pad_rows(lm[qkey]["scale"], rows, 1.0)}
    if "lm" in params:
        return {**params, "lm": lm}
    return lm


def check_tensor_parallel(config, model_size: int) -> None:
    """Refuse a model whose heads or hidden widths the model axis does not
    divide: a Megatron rank computes whole heads of its own, where GSPMD
    would replicate such a leaf. Raises ``ValueError``."""
    arch, vit = config.lm_arch, config.vision_arch
    gpt = arch.family == "gpt2"
    widths = {
        "LM heads": arch.n_head if gpt else arch.num_attention_heads,
        "LM MLP width": 4 * arch.n_embd if gpt else arch.ffn_dim,
        "vision heads": vit.num_attention_heads,
        "vision MLP width": vit.intermediate_size,
        "xattn heads": config.xattn_heads,
        "xattn MLP width": config.dim * config.xattn_ff_mult,
        "resampler heads": config.resampler_heads,
        "resampler MLP width": config.dim_visual * config.resampler_ff_mult,
    }
    bad = {k: v for k, v in widths.items() if v % model_size}
    if bad:
        raise ValueError(f"tensor_parallel over a model axis of {model_size} "
                         f"needs these divisible by it: {bad}")


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s rows of every batch entry (the data axis' split of
    the leading dimension, contiguous as JAX's ``P('data')``)."""
    def rows(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        if x.shape[0] % world:
            raise ValueError(f"batch {x.shape[0]} not divisible by the mesh "
                             f"data axis ({world})")
        n = x.shape[0] // world
        return x[rank * n:(rank + 1) * n]
    return {k: rows(v) for k, v in batch.items()} if isinstance(batch, dict) \
        else rows(batch)
