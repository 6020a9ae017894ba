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
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


@dataclass(frozen=True)
class Policy:
    """Compute policy threaded through all apply functions. ``pallas``:
    route the big attention ops through the attention kernels."""

    dtype: torch.dtype = torch.float32
    pallas: bool = False

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)


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


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each value kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)`` (the factor rounded to x's dtype, as JAX's
    weakly typed constant is), the rest 0. The identity when ``generator``
    is None or ``rate <= 0`` (evaluation). The mask comes from
    ``generator``, a ``torch.Generator`` on x's device; JAX's bits are not
    reproduced, only its sites and rates (the trunk's; the resampler and
    the xattn blocks have none)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(kept, x / const(keep, x.dtype), 0.0).to(x.dtype)


def feed_forward(x: torch.Tensor, p: Params, act: str) -> torch.Tensor:
    """LayerNorm -> Linear(no bias) -> act -> Linear(no bias)."""
    h = layer_norm(x, p["norm"])
    h = linear(h, p["fc1"])
    h = get_activation(act)(h)
    return linear(h, p["fc2"])
