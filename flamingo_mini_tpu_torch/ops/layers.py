"""Core layer primitives: norms, linears, activations, feed-forward.

Port of ``flamingo_mini_tpu/ops/layers.py``. Plain functions over parameter
dicts of tensors, with the JAX package's layouts: linear weights are
``(d_in, d_out)`` and int8 leaves are ``{"w8", "scale"}``.

Two compute policies, as in the JAX package:

* ``PARITY``: float32 activations, full float32 matmuls.
* ``FAST``: bfloat16 activations; every matmul accumulates in float32 and
  rounds its product once to bfloat16.
* ``FAST_PALLAS``: ``FAST`` with the attention kernels on: the ViT, the
  resampler, the gated xattn over more than one token and the uncached
  GPT-2 forward run ``fused_attention`` / ``fused_media_xattn`` instead of
  the plain ``attend`` chain (the JAX package's ``use_pallas``).

Scalar constants that JAX folds into a bfloat16 op as a weakly typed value
are rounded to the compute dtype first here too (``const``), so that both
packages multiply by the same number.

Tensor parallelism: a policy's ``tp`` is the model group of a Megatron rank
(``parallel/sharding.py`` slices its leaves). Every model function then
computes its rank's heads: ``column_linear`` on the input replicated over
the group, ``row_linear`` reducing the float32 partial products over it
before the rounding. With ``tp`` None they are ``linear``.

Random draws (dropout masks, sampling noise) go through ``rand``: under
``drawn_rows(rank, world)`` a rank of a data-parallel run draws the whole
batch's tensor and keeps its rows, so that it draws what one device draws.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel import comm

Params = Dict[str, Any]


@dataclass(frozen=True)
class Policy:
    """Compute policy threaded through all apply functions. ``pallas``:
    route the big attention ops through the attention kernels. ``tp``: the
    model group of a tensor-parallel rank, None on one device."""

    dtype: torch.dtype = torch.float32
    pallas: bool = False
    tp: Any = None

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    @property
    def tp_size(self) -> int:
        """The ranks of the model group (1 without one)."""
        return 1 if self.tp is None else comm.size(self.tp)

    def local_heads(self, heads: int) -> int:
        """The heads of ``heads`` this rank computes."""
        return heads // self.tp_size

    @property
    def tp_heads(self) -> Optional[Tuple[int, int]]:
        """(rank, size) in the model group for ``rand``'s ``heads``, or None."""
        return None if self.tp is None else (comm.rank(self.tp), self.tp_size)


PARITY = Policy(dtype=torch.float32)
FAST = Policy(dtype=torch.bfloat16)
FAST_PALLAS = Policy(dtype=torch.bfloat16, pallas=True)


def policy_for(compute_dtype: str, use_pallas: bool = False) -> Policy:
    """Map a FlamingoConfig.compute_dtype string to a Policy. float32 is
    PARITY even with ``use_pallas``, as in the JAX package."""
    if compute_dtype in ("float32", "fp32"):
        return PARITY
    if compute_dtype in ("bfloat16", "bf16"):
        return FAST_PALLAS if use_pallas else FAST
    raise ValueError(f"unknown compute dtype {compute_dtype!r}")


@functools.lru_cache(maxsize=None)
def const(value: float, dtype: torch.dtype) -> float:
    """``jnp.asarray(value, dtype)`` as a Python float: the constant rounded
    to the dtype (kept on the host, so using it launches no copy)."""
    return float(torch.tensor(value, dtype=dtype))


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype: float32 accumulation, one rounding of the product."""
    return torch.matmul(x, w.to(x.dtype))


def normal(gen: torch.Generator, shape, std: float = 1.0) -> torch.Tensor:
    """float32 N(0, std^2) on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device) * std


def init_layer_norm(dim: int, device) -> Params:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def init_linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool = True,
                std: float = 0.02) -> Params:
    p: Params = {"w": normal(gen, (d_in, d_out), std)}
    if bias:
        p["b"] = torch.zeros(d_out, device=gen.device)
    return p


def init_feed_forward(gen: torch.Generator, dim: int, mult: int = 4) -> Params:
    inner = int(dim * mult)
    return {"norm": init_layer_norm(dim, gen.device),
            "fc1": init_linear(gen, dim, inner, bias=False),
            "fc2": init_linear(gen, inner, dim, bias=False)}


def layer_norm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 statistics, cast back to the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def linear(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x @ w (+ b), weights ``(d_in, d_out)``.

    An int8 leaf ``{"w8", "scale"}`` computes ``(x @ w8)`` with a float32
    result, multiplies by the per-channel scale and rounds once to x's dtype.
    The product is taken in float32 on both operands: bfloat16 and int8
    values are exact in float32, so this is the float32-accumulated product
    the JAX package asks for. It materialises a float32 copy of the weight
    on every call; a fused int8 kernel is later work.
    """
    if "w8" in p:
        y = torch.matmul(x.float(), p["w8"].float())
        y = (y * p["scale"]).to(x.dtype)
    else:
        y = dot(x, p["w"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def column_linear(x: torch.Tensor, p: Params, tp=None) -> torch.Tensor:
    """A column-parallel ``linear``: the rank's output columns (its slice of
    ``w`` and ``b``) from the input replicated over the model group ``tp``,
    whose gradient is summed over the group."""
    return linear(x if tp is None else comm.copy_to_model_parallel(x, tp), p)


def row_linear(x: torch.Tensor, p: Params, tp=None) -> torch.Tensor:
    """A row-parallel ``linear``: the rank's input columns times its rows of
    ``w`` (``w8``), the float32 partial products summed over the model group
    ``tp``, then the int8 scale, one rounding to x's dtype and the
    replicated bias, added once."""
    if tp is None:
        return linear(x, p)
    y = torch.matmul(x.float(), p["w8" if "w8" in p else "w"].float())
    y = comm.reduce_from_model_parallel(y, tp)
    if "w8" in p:
        y = y * p["scale"]
    y = y.to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU == torch.nn.GELU default."""
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU == HF 'gelu_new' used by GPT-2."""
    return F.gelu(x, approximate="tanh")


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) == HF 'quick_gelu' used by CLIP."""
    return x * torch.sigmoid(const(1.702, x.dtype) * x)


def squared_relu(x: torch.Tensor) -> torch.Tensor:
    """relu(x)^2."""
    r = torch.relu(x)
    return r * r


_ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu_erf,
    "gelu_new": gelu_tanh,
    "quick_gelu": quick_gelu,
    "relu": torch.relu,
    "sqrelu": squared_relu,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name not in _ACTS:
        raise ValueError(f"activation must be one of {sorted(_ACTS)}, got {name!r}")
    return _ACTS[name]


_DRAWN_ROWS: contextvars.ContextVar = contextvars.ContextVar("drawn_rows",
                                                             default=None)


@contextlib.contextmanager
def drawn_rows(rank: int, world: int):
    """Within the block, ``rand`` draws for a batch split over ``world``
    data-parallel ranks: the tensor of all their rows, this ``rank``'s kept."""
    token = _DRAWN_ROWS.set((rank, world))
    try:
        yield
    finally:
        _DRAWN_ROWS.reset(token)


def rand(shape, generator: Optional[torch.Generator], device,
         heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """float32 uniforms on [0, 1) of ``shape`` from ``generator``, drawn as
    one device draws them: under ``drawn_rows(rank, world)`` the rank's rows
    (dimension 0) of the draw for every rank's rows; ``heads=(rank, world)``
    likewise keeps the rank's block of dimension 1 (a model-parallel
    rank's heads)."""
    shape, keep = list(shape), [slice(None)] * len(shape)
    for dim, split in ((0, _DRAWN_ROWS.get()), (1, heads)):
        if split is not None and split[1] > 1:
            r, n = split
            keep[dim] = slice(r * shape[dim], (r + 1) * shape[dim])
            shape[dim] *= n
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return u[tuple(keep)]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout: each value kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)`` (the factor rounded to x's dtype, as JAX's
    weakly typed constant is), the rest 0. The identity when ``generator``
    is None or ``rate <= 0`` (evaluation). The mask comes from
    ``generator``, a ``torch.Generator`` on x's device, through ``rand``
    (``heads``: x's dimension 1 is a model-parallel rank's heads); JAX's
    bits are not reproduced, only its sites and rates (the trunk's; the
    resampler and the xattn blocks have none)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    kept = rand(x.shape, generator, x.device, heads) < keep
    return torch.where(kept, x / const(keep, x.dtype), 0.0).to(x.dtype)


def feed_forward(x: torch.Tensor, p: Params, act: str, tp=None) -> torch.Tensor:
    """LayerNorm -> Linear(no bias) -> act -> Linear(no bias); over the model
    group ``tp``, fc1 column- and fc2 row-parallel."""
    h = layer_norm(x, p["norm"])
    h = column_linear(h, p["fc1"], tp)
    h = get_activation(act)(h)
    return row_linear(h, p["fc2"], tp)
