"""Whole-decode-step megakernel: every gated-xattn and decoder layer in one
launch per token.

Port of ``flamingo_mini_tpu/ops/pallas_megadecode.py`` in all its modes:
greedy (``beam_anc=None``) and lazy beam (``beam_anc`` of shape ``(b, kb,
anc_len)``), over a GPT-2 trunk or a pre-norm OPT trunk (the OPT mode:
separate q/k/v projections packed as the three column blocks of one qkv
projection, ReLU, ``attn_ln`` / ``final_ln`` as the block's two
LayerNorms), each weight-only or, with ``act_quant``, w8a8 (int8
activations too: the JAX package's ``DecodeConfig.w8a8`` tier). The CUDA
kernel is ``csrc/decode_megakernel.cu``; its source note says what bounds
it on the card and how the design answers that.

``decode_step_megakernel`` launches the kernel for CUDA tensors and runs
``decode_step_megakernel_plain`` for CPU tensors; nothing else picks the
path. Both modes run ``csrc/decode_megakernel_sm90.cuh`` (TMA weight ring,
``wgmma``, split-K with a fixed-order combine), whose tile plan ``plan``
computes here from the shapes. Both compute, per layer, the gated xattn
block (where the layer has one) and the pre-norm decoder block with these
roundings (``pallas_megadecode.py``'s kernel body):

* every int8 linear: int8 -> bf16 exactly, bf16 products accumulated in
  float32, x the float32 per-channel scale, one rounding to bf16, the bias
  added in bf16; every residual add is a bf16 add;
* with ``act_quant`` (``pallas_megadecode.py``'s ``aquant``, ``mm_cols``,
  ``mm_rows``) every linear quantizes its bf16 input per row
  (``quantize_rows``: scale ``max(amax, 1e-30) * f32(1/127)``, round half
  to even) and sums int8 x int8 products exactly; the column form (``xq``,
  ``xf1``, ``qkv``, ``o``, ``fc``) scales by the row's one scale, then the
  weight's; the row form (``xo``, ``xf2``, ``pr``) quantizes each D-wide
  slice of its input with its own scale and adds the scaled float32
  partials in slice order (``_lin_w8a8``);
* LayerNorm with float32 statistics, eps fixed at 1e-5, summed in the
  CUDA kernel's order (``_layer_norm``: 8-element units, ``_warp_sum_units``);
  with ``act_quant`` the
  attention's dot products, softmax denominators and V sums are taken in
  float64 and rounded once, sums whose order does not matter: the w8a8
  mode of the kernel and of this version agree bit for bit (one
  activation rounded the other way could flip a quantized value);
* xattn: ``q * bf16(xdh**-0.5)`` in bf16; float32 scores rounded to bf16,
  valid iff ``latent // n_visual + 1 == text_time``; float32 softmax,
  probabilities cast to bf16 before the V product; rows with
  ``text_time == 0`` zeroed; ``x += bf16(g * f32(out))`` with the gate
  ``bf16(tanh(alpha))``; the gated FFW's activation is ``config.xattn_act``,
  ``"gelu"`` through the rational erf ``gelu_erf_rational``;
* the block's activation is the trunk's, on the bf16 value after the
  bias: ``gelu_new`` in float32 (GPT-2) or ReLU (OPT), one rounding;
* self-attention: ``dh**-0.5`` after the dot, valid iff
  ``npad <= t <= cur`` over ``[0, kv_limit)``, as ``decode_attention``, or
  in beam mode as ``decode_attention_beam`` (row ``r`` reads position ``t``
  of the family row ``beam_anc[r // kb, r % kb, t]``); the step's K/V rows
  are written at ``cur`` in place first.

Packing (``pack_decode_weights``, once per ``generate``): the TPU's D x D
chunks and its ``small`` row do not carry over. Each int8 projection is
transposed to ``(d_out, d_in)``, so that an output column's weights are
contiguous, and stacked: the trunk's over all layers, the xattn blocks'
over the layers that have one (the ragged ``hasx`` schedule: a layer
without xattn packs no xattn weights). Float32 scales, bf16 biases, float32
LayerNorm params and the gates go beside them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from . import cuda_build
from .decode_attention import decode_attention_beam_plain, decode_attention_plain
from .layers import const, gelu_tanh

Params = Dict[str, Any]
NEG = float(torch.finfo(torch.float32).min)
HEAD_DIM = 64       # the CUDA kernel's xattn head width, and its attention scratch's
HEAD_DIMS = (64, 80, 128)   # the self-attention head widths it takes (a kernel each)
K_CHUNK = 64        # the CUDA kernel's K step: every d_in is a multiple
INDEX_LIMIT = 2 ** 31 - 1   # the CUDA kernel's element offsets are 32-bit ints
# the kernel (decode_megakernel_sm90.cuh): its linears in the order of
# MegaArgs.split, 4 KB weight chunks (64 columns x 64 k) through a ring of
# RING_STAGES (its kRing), the wgmma N a warpgroup takes (at most ROW_GROUP
# rows), the rows of a pass past ROW_GROUP rows (a quarter for each
# warpgroup), and the shared memory a K-slice's staged activations may take
# (a chunk's row of them: 128 bytes of bf16, 64 of int8 in the w8a8 mode)
LINEARS = ("xq", "xo", "xf1", "xf2", "qkv", "o", "fc", "pr")
RING_STAGES = 8
ROW_GROUP = 64
WGMMA_N = (8, 16, 24, 32, 48, 64)
GROUPS = 4          # consumer warpgroups; 16 consumer warps
PASS_ROWS = GROUPS * ROW_GROUP
MAX_D = 4096        # the widest row its LayerNorm statistics hold in registers
STAGE_BUDGET = 160 * 1024
ITEM_COST = 16      # choose_split's model: an item's fixed cost, in chunks
SPLIT_COST = 10     # and a split tile's combine
SPLIT_COST_FEW_W8A8 = 15  # the w8a8 mode's under 32 rows: int32 sums per slice, scales
N_SMS = 132         # an H100 SXM's SMs: the plan's grid where no card is asked
# the kernel's section timer (its ``mark``): clock cycles per block in each
# section of the consumers' work
SECTIONS = ("barrier", "ln_stats", "stage_b", "products", "finish", "attention", "other")
# set to a (blocks, len(SECTIONS)) int64 tensor on the card to have every
# launch write its blocks' section cycles into it
section_timer: Optional[torch.Tensor] = None
# set to a (step_phases(packed), blocks, len(SECTIONS)) int64 tensor on the
# card to have every launch copy each block's section cycles (cumulative)
# at the end of every phase: a phase's busiest block, section by section
phase_timer: Optional[torch.Tensor] = None
# activation name -> the kernel's code; "gelu" is the rational-erf GELU
ACT_CODES = {"gelu_new": 0, "gelu": 1, "gelu_erf": 1, "relu": 2}


def trunk_dims(arch) -> Tuple[int, int, int, int]:
    """(D, Dff, n_layer, n_head) of a GPT-2 or OPT trunk."""
    if arch.family == "gpt2":
        return arch.n_embd, 4 * arch.n_embd, arch.n_layer, arch.n_head
    return (arch.hidden_size, arch.ffn_dim, arch.num_hidden_layers,
            arch.num_attention_heads)


def supports_arch(arch) -> bool:
    """Whether the megakernel takes this trunk: GPT-2, or pre-norm OPT
    without opt-350m's project_in/out (word_embed_proj_dim ==
    hidden_size), with D and Dff multiples of the kernel's 64-wide K step."""
    if arch.family == "opt" and not (
            arch.do_layer_norm_before and arch.word_embed_proj_dim == arch.hidden_size):
        return False
    D, Dff, _L, _H = trunk_dims(arch)
    return D % K_CHUNK == 0 and Dff % K_CHUNK == 0


def gelu_erf_rational(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU through the Abramowitz-Stegun 7.1.26 rational erf
    (|erf error| <= 1.5e-7), in float32, returned in x's dtype: the formula
    of ``pallas_megadecode.py``'s ``_gelu_erf_mosaic``."""
    x32 = x.float()
    z = x32 * (2.0 ** -0.5)
    s = torch.sign(z)
    a = torch.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    erf = s * (1.0 - poly * torch.exp(-a * a))
    return (0.5 * x32 * (1.0 + erf)).to(x.dtype)


def _activation(name: str):
    if name not in ACT_CODES:
        raise NotImplementedError(
            f"megakernel activation must be one of {sorted(ACT_CODES)}, got {name!r}")
    return {0: gelu_tanh, 1: gelu_erf_rational, 2: torch.relu}[ACT_CODES[name]]


def _wt(p: Params) -> torch.Tensor:
    """int8 (d_in, d_out) -> (d_out, d_in), contiguous."""
    if "w8" not in p:
        raise ValueError("the megakernel needs int8-quantized weights "
                         "(FlamingoModel.quantize_int8)")
    return p["w8"].t().contiguous()


def pack_decode_weights(params: Params, config) -> Params:
    """Stack the quantized trunk and xattn weights into the kernel's layout
    (module docstring). Runs once per generate call. OPT: the q, k and v
    projections become the qkv projection's three column blocks (their
    biases concatenated alike); ``attn_ln`` -> ln1, ``final_ln`` -> ln2,
    ``out_proj`` -> o, ``fc1`` -> fc, ``fc2`` -> pr."""
    arch = config.lm_arch
    D, Dff, L, _H = trunk_dims(arch)
    if not supports_arch(arch):
        raise ValueError(f"the megakernel takes GPT-2 and pre-norm OPT trunks "
                         f"without project_in/out, D and Dff multiples of "
                         f"{K_CHUNK}; got {arch}")
    if abs(arch.layer_norm_epsilon - 1e-5) > 1e-12:
        raise ValueError("the megakernel's LayerNorm has eps fixed at 1e-5")
    _activation(arch.activation)
    _activation(config.xattn_act)
    f32, bf16 = torch.float32, torch.bfloat16

    def stack(fn, items):
        return torch.stack([fn(it) for it in items]).contiguous()

    if arch.family == "gpt2":
        blocks = params["lm"]["blocks"]
        lin = {"qkv": ("c_attn",), "o": ("c_proj",), "fc": ("mlp_fc",),
               "pr": ("mlp_proj",)}
        lns = {"ln1": "ln_1", "ln2": "ln_2"}
    else:
        blocks = params["lm"]["layers"]
        lin = {"qkv": ("q_proj", "k_proj", "v_proj"), "o": ("out_proj",),
               "fc": ("fc1",), "pr": ("fc2",)}
        lns = {"ln1": "attn_ln", "ln2": "final_ln"}
    packed: Params = {}
    for name, keys in lin.items():
        packed["w_" + name] = stack(lambda b: torch.cat([_wt(b[k]) for k in keys]), blocks)
        packed["s_" + name] = stack(
            lambda b: torch.cat([b[k]["scale"].to(f32) for k in keys]), blocks)
        packed["b_" + name] = stack(
            lambda b: torch.cat([b[k]["b"].to(bf16) for k in keys]), blocks)
    for name, key in lns.items():
        packed[name + "_s"] = stack(lambda b: b[key]["scale"].to(f32), blocks)
        packed[name + "_b"] = stack(lambda b: b[key]["bias"].to(f32), blocks)

    # ragged schedule: only the layers with a gated xattn block pack one
    xlayers = tuple(l for l in range(L) if str(l) in params["xattn"])
    xblocks = [params["xattn"][str(l)] for l in xlayers]
    xlin = {"xq": lambda x: x["attn"]["to_q"], "xo": lambda x: x["attn"]["to_out"],
            "xf1": lambda x: x["ffw"]["fc1"], "xf2": lambda x: x["ffw"]["fc2"]}
    for name, get in xlin.items():
        packed["w_" + name] = stack(lambda x: _wt(get(x)), xblocks)
        packed["s_" + name] = stack(lambda x: get(x)["scale"].to(f32), xblocks)
    for name, get in (("xn", lambda x: x["attn"]["norm"]),
                      ("xfn", lambda x: x["ffw"]["norm"])):
        packed[name + "_s"] = stack(lambda x: get(x)["scale"].to(f32), xblocks)
        packed[name + "_b"] = stack(lambda x: get(x)["bias"].to(f32), xblocks)
    # the gates are rounded to bf16, so that the float32 product with the
    # branch output rounds as a bf16 x bf16 multiply does
    packed["gates"] = stack(
        lambda x: torch.cat([torch.tanh(x["alpha_attn"].float().reshape(1)),
                             torch.tanh(x["alpha_ffw"].float().reshape(1))]
                            ).to(bf16).to(f32), xblocks)
    dev = packed["w_qkv"].device
    packed["hasx"] = torch.tensor([int(l in xlayers) for l in range(L)],
                                  dtype=torch.int32, device=dev)
    packed["xlayers"] = xlayers
    return packed


def step_phases(packed: Params) -> int:
    """The kernel's phases in one step: ten in a layer with a gated xattn
    block (xq, xattn, xo, xf1, xf2, qkv, attention, o, fc, pr), five in a
    layer without."""
    return 5 * len(packed["hasx"]) + 5 * len(packed["xlayers"])


def pack_xattn_kv_flat(xattn_kv: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                       n_layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """{layer: (k, v)} with k (b, XH, NMNV, dh) -> flat T-major stacks
    (n_layer, NMNV, b, XI) bf16, zeros for layers without xattn."""
    k0 = next(iter(xattn_kv.values()))[0]
    b, XH, NMNV, dh = k0.shape
    shape = (n_layer, NMNV, b, XH * dh)
    ks = torch.zeros(shape, dtype=torch.bfloat16, device=k0.device)
    vs = torch.zeros(shape, dtype=torch.bfloat16, device=k0.device)
    for key, (k, v) in xattn_kv.items():
        ks[int(key)] = k.permute(2, 0, 1, 3).reshape(shape[1:])
        vs[int(key)] = v.permute(2, 0, 1, 3).reshape(shape[1:])
    return ks, vs


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _lin(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
         b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16((x . w^T)_f32 * s) (+ b in bf16), w (d_out, d_in) int8."""
    y = (torch.matmul(x.float(), w.float().t()) * s).to(torch.bfloat16)
    return y if b is None else y + b


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``aquant`` (``pallas_megadecode.py``): per-row symmetric absmax int8
    of x (rows, k) -> (q int8 (rows, k), s float32 (rows, 1)) with
    ``s = max(amax, 1e-30) * f32(1/127)`` and ``q = round_half_even(x *
    (1/s))``, every step a float32 op as JAX's (the reciprocal first, then
    the product)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax, min=const(1e-30, torch.float32)) * const(1.0 / 127.0,
                                                                   torch.float32)
    q = torch.round(x32 * (torch.ones_like(s) / s))
    return q.to(torch.int8), s


def _int_dot(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 (rows, k) . int8 (n, k)^T as the int32 sum cast once to float32.
    Exact in float64 (|sum| <= 127^2 k < 2^53), which every device
    multiplies; a float32 product would round once a sum passes 2^24."""
    return torch.matmul(q.double(), w.double().t()).float()


def _lin_w8a8(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
              b: Optional[torch.Tensor] = None, *,
              width: Optional[int] = None) -> torch.Tensor:
    """The w8a8 linear, w (d_out, d_in) int8. ``width`` None: the column
    form, ``bf16((f32(p) * s_row) * s)``; else the row form over
    ``width``-wide slices of x, ``bf16((sum_j f32(p_j) * s_j) * s)`` summed
    in slice order from 0. The bias is added in bf16."""
    if width is None:
        q, xs = quantize_rows(x)
        y = _int_dot(q, w) * xs
    else:
        y = torch.zeros((x.shape[0], w.shape[0]), dtype=torch.float32, device=x.device)
        for k0 in range(0, x.shape[1], width):
            q, hs = quantize_rows(x[:, k0:k0 + width])
            y = y + _int_dot(q, w[:, k0:k0 + width]) * hs
    y = (y * s).to(torch.bfloat16)
    return y if b is None else y + b


def lin_w8a8(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
             b: Optional[torch.Tensor] = None, *,
             width: Optional[int] = None) -> torch.Tensor:
    """The megakernel's w8a8 linear alone: x (rows, k) bf16, w (n, k) int8,
    s (n,) float32, b (n,) bf16 or None -> (rows, n) bf16, as
    ``_lin_w8a8``. A CUDA tensor runs the kernel's own machinery with a
    schedule of one linear phase (``fmt_w8a8_linear``: the quantizing
    stage, the int8 ``wgmma`` products, the int32 combine of split tiles
    and the epilogue, on this call's ``plan``), so that a test can hold the
    mode's linear bitwise against its plain version; a CPU tensor runs
    ``_lin_w8a8``. On the card the row form's slices are as wide as its
    output (the megakernel's D: to_out, fc2 and mlp_proj all write D
    columns)."""
    if x.device.type == "cpu":
        return _lin_w8a8(x, w, s, b, width=width)
    if x.device.type != "cuda":
        raise ValueError(f"lin_w8a8: unsupported device {x.device}")
    rows, k = x.shape
    n = w.shape[0]
    if k % K_CHUNK or n % K_CHUNK or width not in (None, n):
        raise ValueError(f"lin_w8a8: k ({k}) and n ({n}) must be multiples of "
                         f"{K_CHUNK}, and the row form's width ({width}) n")
    _require(x, "x", torch.bfloat16, (rows, k), x.device)
    _require(w, "w", torch.int8, (n, k), x.device)
    _require(s, "s", torch.float32, (n,), x.device)
    if b is not None:
        _require(b, "b", torch.bfloat16, (n,), x.device)
    # the column form as mlp_fc (n = Dff columns over K = D), the row form
    # as mlp_proj (n = D columns over K = Dff, D-wide slices)
    D, Dff, lin = (k, n, "fc") if width is None else (n, k, "pr")
    p = plan(rows, D, Dff, K_CHUNK, K_CHUNK, n_xattn=0, blocks=_sm_count(x.device),
             act_quant=True)
    out = torch.empty((rows, n), dtype=torch.bfloat16, device=x.device)
    amax = torch.empty(rows * -(-k // D), dtype=torch.int32, device=x.device)
    parts = torch.empty(p["parts_floats"], dtype=torch.float32, device=x.device)
    sync = torch.zeros(p["sync_words"], dtype=torch.int32, device=x.device)
    args = _Args(b=rows, D=D, Dff=Dff, XI=K_CHUNK, Dffx=K_CHUNK, act_quant=1,
                 amax=amax.data_ptr(), parts=parts.data_ptr(), sync=sync.data_ptr())
    _plan_args(args, p)
    err = _checked_lib().fmt_w8a8_linear(
        ctypes.addressof(args), LINEARS.index(lin), x.data_ptr(), w.data_ptr(),
        s.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "lin_w8a8", out)
    return out


def _warp_sum_units(t: torch.Tensor) -> torch.Tensor:
    """(rows, D) float32 -> (rows, 1): the kernel's order of a row sum
    (``ln_stats`` in decode_megakernel_sm90.cuh), one warp per
    row: lane l adds the 8-element units l, l + 32, ... of the row, unit by
    unit, element by element from 0, then the lanes meet in an xor
    butterfly (16, 8, 4, 2, 1). A lane past the row's last unit adds
    nothing (here: zeros)."""
    rows, D = t.shape
    n = -(-D // 256)
    lanes = torch.nn.functional.pad(t, (0, n * 256 - D)).reshape(rows, n, 32, 8)
    s = torch.zeros_like(lanes[:, 0, :, 0])
    for v in range(n):
        for j in range(8):
            s = s + lanes[:, v, :, j]
    idx = torch.arange(32, device=t.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[:, idx ^ o]
    return s[:, :1]


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """``layers.layer_norm`` with its statistics summed in the kernel's
    order (``_warp_sum_units``), every step one float32 op: the kernel's
    LayerNorm, bit for bit where rsqrt rounds alike. x: (rows, D)."""
    x32 = x.float()
    D = x.shape[-1]
    mean = _warp_sum_units(x32) / D
    d = x32 - mean
    var = _warp_sum_units(d * d) / D
    y = d * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _cross_attention(q, k, v, text_time, *, n_visual: int, heads: int,
                     acc_dtype: torch.dtype = torch.float32):
    """q (b, XI) bf16, pre-scaled; k, v (NMNV, b, XI) -> (b, XI) bf16; the
    sums in ``acc_dtype``, each rounded once to float32 (module
    docstring)."""
    NMNV, b, XI = k.shape
    dh = XI // heads
    qh = q.reshape(b, heads, 1, dh).to(acc_dtype)
    kh = k.reshape(NMNV, b, heads, dh).permute(1, 2, 3, 0).to(acc_dtype)
    s = torch.matmul(qh, kh).float().to(torch.bfloat16).float()  # (b, h, 1, NMNV)
    latent = torch.arange(NMNV, device=q.device)
    valid = (latent[None, :] // n_visual + 1) == text_time[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.to(acc_dtype).sum(dim=-1, keepdim=True).float()
    vh = v.reshape(NMNV, b, heads, dh).permute(1, 2, 0, 3).to(acc_dtype)
    o = torch.matmul(p.to(torch.bfloat16).to(acc_dtype), vh).float()
    o = o / torch.clamp(l, min=1e-30)
    o = torch.where((text_time > 0)[:, None], o.reshape(b, XI), 0.0)
    return o.to(torch.bfloat16)


def decode_step_megakernel_plain(packed: Params, xk, xv, kc, vc, x_emb, npad,
                                 text_time, cur: int, *, config,
                                 kv_limit: Optional[int] = None,
                                 beam_anc: Optional[torch.Tensor] = None,
                                 act_quant: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the kernel's oracle, arguments as the kernel's."""
    arch = config.lm_arch
    D, _Dff, L, H = trunk_dims(arch)
    t_lim = kc.shape[1] if kv_limit is None else min(kv_limit, kc.shape[1])
    act, xact = _activation(arch.activation), _activation(config.xattn_act)
    xq_scale = const(config.xattn_dim_head ** -0.5, torch.bfloat16)
    if act_quant:
        def lin(x, w, s, b=None, rows=False):
            return _lin_w8a8(x, w, s, b, width=D if rows else None)
    else:
        def lin(x, w, s, b=None, rows=False):
            return _lin(x, w, s, b)

    ln = _layer_norm
    acc = torch.float64 if act_quant else torch.float32
    P = packed
    x = x_emb
    for l in range(L):
        if l in P["xlayers"]:
            i = P["xlayers"].index(l)
            q = lin(ln(x, P["xn_s"][i], P["xn_b"][i]),
                    P["w_xq"][i], P["s_xq"][i]) * xq_scale
            att = _cross_attention(q, xk[l], xv[l], text_time,
                                   n_visual=config.resampler_num_latents,
                                   heads=config.xattn_heads, acc_dtype=acc)
            xo = lin(att, P["w_xo"][i], P["s_xo"][i], rows=True)
            x = x + (P["gates"][i, 0] * xo.float()).to(torch.bfloat16)
            h = ln(x, P["xfn_s"][i], P["xfn_b"][i])
            h = xact(lin(h, P["w_xf1"][i], P["s_xf1"][i]))
            xf = lin(h, P["w_xf2"][i], P["s_xf2"][i], rows=True)
            x = x + (P["gates"][i, 1] * xf.float()).to(torch.bfloat16)
        h = ln(x, P["ln1_s"][l], P["ln1_b"][l])
        q, k, v = lin(h, P["w_qkv"][l], P["s_qkv"][l], P["b_qkv"][l]).split(D, dim=-1)
        kc[l, cur] = k
        vc[l, cur] = v
        if beam_anc is None:
            att = decode_attention_plain(q, kc[l], vc[l], npad, cur, n_head=H,
                                         scale=(D // H) ** -0.5, kv_limit=t_lim,
                                         acc_dtype=acc)
        else:
            att = decode_attention_beam_plain(
                q, kc[l], vc[l], beam_anc, npad, cur, n_head=H,
                scale=(D // H) ** -0.5, kb=beam_anc.shape[1], kv_limit=t_lim,
                acc_dtype=acc)
        x = x + lin(att, P["w_o"][l], P["s_o"][l], P["b_o"][l])
        h = ln(x, P["ln2_s"][l], P["ln2_b"][l])
        h = act(lin(h, P["w_fc"][l], P["s_fc"][l], P["b_fc"][l]))
        x = x + lin(h, P["w_pr"][l], P["s_pr"][l], P["b_pr"][l], rows=True)
    return x


# ---------------------------------------------------------------------------
# the kernel's tile plan
# ---------------------------------------------------------------------------


def linear_shapes(D: int, Dff: int, XI: int, Dffx: int) -> Dict[str, Tuple[int, int]]:
    """{linear: (output columns, K)} in the kernel's order (``LINEARS``)."""
    return {"xq": (XI, D), "xo": (D, XI), "xf1": (Dffx, D), "xf2": (D, Dffx),
            "qkv": (3 * D, D), "o": (D, D), "fc": (Dff, D), "pr": (D, Dff)}


def wgmma_n(rows: int) -> int:
    """The wgmma N that covers ``rows`` rows (at most ``ROW_GROUP``)."""
    return next(n for n in WGMMA_N if n >= min(rows, ROW_GROUP))


def pass_shape(b: int, rows: int) -> Tuple[int, int]:
    """(wgmma N, rows of a staged B tile) of a pass over ``rows`` of a
    launch's ``b`` rows: up to ``ROW_GROUP`` rows every warpgroup takes all
    rows and a share of the chunks; past it (the wide mode) each warpgroup
    takes a quarter of the pass's rows over every chunk (the kernel's
    ``pass_n``, ``tile_rows``)."""
    if b <= ROW_GROUP:
        return wgmma_n(rows), wgmma_n(rows)
    return wgmma_n(-(-rows // GROUPS)), -(-rows // 8) * 8


def straddles(s: int, n_chunks: int, quant: int) -> bool:
    """Whether a K-slice of ``s`` over ``n_chunks`` chunks spans two
    quantization slices of ``quant`` chunks (the w8a8 mode's D-wide slices
    of a row-form input)."""
    return any(i * n_chunks // s // quant != ((i + 1) * n_chunks // s - 1) // quant
               for i in range(s))


def choose_split(n_tiles: int, n_chunks: int, blocks: int, cap: int, rows: int,
                 quant: Optional[int] = None) -> int:
    """K-slices per 64-column tile: the fewest that bring the busiest
    block's cost to its least, with no slice over ``cap`` chunks and, where
    ``quant`` is given (w8a8), none across a quantization slice of that many
    chunks: whole fractions of one (the combine adds a slice's partials in
    int32, then the slices' scaled sums in order). In units
    of one chunk's weights (calibrated on an H100 at flamingo-mini width,
    b = 1 and 32; at the beams' 96 and 160 rows, whose passes take every
    row, it gives one item per block in every phase): an item costs
    ``ITEM_COST`` (its staging and epilogue, a few dependent trips to
    memory), a chunk 1 + rows / 32 (its weights, and the pass's rows of
    activations staged), a split tile ``SPLIT_COST`` (the partial
    written, the arrival, the last block's reads, one after another) plus
    its partials' traffic (``rows`` x 64 floats a slice, written by each
    round of its blocks and read by the last). Under 32 rows the w8a8
    mode's split tile costs ``SPLIT_COST_FEW_W8A8``: its combine adds
    int32 partials per quantization slice and scales each, a fixed latency
    that few rows do not hide (measured on an H100: unsplit column-form
    linears at flamingo-mini b=1 took 2.79-2.80 ms a step against
    3.01-3.04 split; at b=32 the split plan was level or faster)."""
    split_cost = SPLIT_COST_FEW_W8A8 if quant is not None and rows < 32 else SPLIT_COST

    def cost(s):
        rounds = -(-(n_tiles * s) // blocks)
        return (rounds * (ITEM_COST + -(-n_chunks // s) * (1 + rows // 32))
                + (s > 1) * (split_cost + rows * (s + 2 * rounds) // 32))

    costs = {s: cost(s) for s in range(1, n_chunks + 1) if -(-n_chunks // s) <= cap
             and not (quant and straddles(s, n_chunks, quant))}
    if not costs:
        raise ValueError(f"decode_step_megakernel: no K-slice of {n_chunks} chunks "
                         f"fits {cap} chunks")
    return min(costs, key=lambda s: (costs[s], s))


def slice_chunks(slice_: int, s: int, n_chunks: int) -> Tuple[int, int]:
    """(first chunk, chunks) of K-slice ``slice_`` of ``s``: the kernel's
    ``slice_chunks``."""
    c0 = slice_ * n_chunks // s
    return c0, (slice_ + 1) * n_chunks // s - c0


def plan(rows: int, D: int, Dff: int, XI: int, Dffx: int, *, n_xattn: int,
         blocks: int = N_SMS, act_quant: bool = False) -> Dict[str, Any]:
    """The kernel's tile plan (``_plan``), computed once per shape in a
    process: every launch asks for it, and its search over the K-slices
    (with the w8a8 mode's quantization-slice rule) costs milliseconds of
    host time at OPT-1.3B width, more than a step of the kernel."""
    return dict(_plan(rows, D, Dff, XI, Dffx, n_xattn, blocks, act_quant))


@functools.lru_cache(maxsize=None)
def _plan(rows: int, D: int, Dff: int, XI: int, Dffx: int, n_xattn: int, blocks: int,
          act_quant: bool) -> Dict[str, Any]:
    """The kernel's tile plan for ``rows`` batch rows over a grid of
    ``blocks`` (one per SM): each linear's K-slices (``split``), the passes
    over the rows (``n_pass``) and the first's wgmma N (``n0``) and staged
    tile rows (``tile_rows``), the partials (float32, or int32 in the w8a8
    mode: 4-byte words) and the per-tile counters the call needs. A slice's
    staged activations (``tile_rows`` x 128 bytes per chunk, 64 in the w8a8
    mode) stay within ``STAGE_BUDGET`` (less, in the w8a8 mode, the 8 D
    bytes of the LayerNorm's scale and bias); past one pass a slice's chunks also
    stay within the ring, which holds them for every pass; in the w8a8 mode
    no slice spans two of a row-form input's D-wide quantization slices."""
    if D > MAX_D:
        raise ValueError(f"decode_step_megakernel: the kernel's LayerNorm holds a "
                         f"row of at most {MAX_D} in registers, got D={D}")
    first = min(rows, PASS_ROWS)
    n0, tr = pass_shape(rows, first)
    n_pass = -(-rows // PASS_ROWS)
    # w8a8: the phase's LayerNorm scale and bias (2 D floats) share the budget
    cap = (STAGE_BUDGET - (8 * D if act_quant else 0)) // (tr * (64 if act_quant else 128))
    if n_pass > 1:
        cap = min(cap, RING_STAGES)
    split, parts, counters = [], 1, 0
    for name in LINEARS:
        n_out, K = linear_shapes(D, Dff, XI, Dffx)[name]
        n_tiles, n_chunks = n_out // K_CHUNK, K // K_CHUNK
        s = choose_split(n_tiles, n_chunks, blocks, cap, first,
                         quant=D // K_CHUNK if act_quant else None)
        split.append(s)
        counters = max(counters, n_pass * n_tiles)
        if s > 1:
            parts = max(parts, n_pass * n_tiles * s * K_CHUNK * tr)
    return dict(split=split, wide=rows > ROW_GROUP, n0=n0, tile_rows=tr, n_pass=n_pass,
                n_xattn=n_xattn, parts_floats=parts, sync_words=2 + counters,
                act_quant=act_quant)


def max_chunks(p: Dict[str, Any], D: int, Dff: int, XI: int, Dffx: int) -> int:
    """The most chunks of one item over the linears the schedule runs."""
    shapes = linear_shapes(D, Dff, XI, Dffx)
    names = LINEARS if p["n_xattn"] else LINEARS[4:]
    return max(-(-(shapes[n][1] // K_CHUNK) // p["split"][LINEARS.index(n)]) for n in names)


def plan_smem_bytes(p: Dict[str, Any], D: int, Dff: int, XI: int, Dffx: int,
                    t_lim: int, n_media: int) -> int:
    """``fmt_decode_megakernel_smem`` for the plan's mode (the kernel's
    ``layout``): 1024 bytes of alignment, the ring, the union of the staged
    B tiles (in the wide mode with room for the last warpgroup's N rows past
    the last tile), the item's tile of sums (with the warpgroups' reduction
    before it) and the attention scratch (its sums float64 in the w8a8
    mode; laid out for items of four 64-wide heads at every width, which
    the 80- and 128-wide items fit), the pass's statistics
    (with each row's scale and its reciprocal in the w8a8 mode, and then
    the LayerNorm's scale and bias, 2 D floats), the barriers, a flag; and
    the section timer's static words."""
    n0, tr, wide, q = p["n0"], p["tile_rows"], p["wide"], p["act_quant"]
    warps = 4 * GROUPS
    acc = 8 if q else 4
    att = 4 * 4 * max(t_lim, n_media) + acc * warps * 4 * HEAD_DIM + (4 + acc) * warps * 4
    stage = (tr * max_chunks(p, D, Dff, XI, Dffx) + wide * n0) * (64 if q else 128)
    red = (tr + n0) * 256 if wide else (GROUPS - 1) * n0 * 256
    uni = max(stage, red, att)
    stats = (PASS_ROWS if wide else ROW_GROUP) * (16 if q else 8) + (8 * D if q else 0)
    return 1024 + RING_STAGES * 4096 + ((uni + 1023) & ~1023) + stats \
        + 2 * RING_STAGES * 8 + 16 + (len(SECTIONS) + 1) * 8


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_POINTERS = ("w_qkv", "s_qkv", "b_qkv", "w_o", "s_o", "b_o", "w_fc", "s_fc",
             "b_fc", "w_pr", "s_pr", "b_pr", "ln1_s", "ln1_b", "ln2_s", "ln2_b",
             "w_xq", "s_xq", "w_xo", "s_xo", "w_xf1", "s_xf1", "w_xf2", "s_xf2",
             "xn_s", "xn_b", "xfn_s", "xfn_b", "gates", "hasx")
_CALL_POINTERS = ("xk", "xv", "kc", "vc", "x_emb", "npad", "text_time", "x",
                  "scratch", "anc", "amax")
_INTS = ("b", "D", "Dff", "Dffx", "XI", "n_layer", "n_head", "x_heads",
         "n_visual", "NMNV", "T", "cur", "t_lim", "act", "xact", "kb",
         "anc_len", "act_quant")


class _Args(ctypes.Structure):
    """``struct MegaArgs`` of csrc/decode_megakernel.cu, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS + _CALL_POINTERS]
                + [(n, ctypes.c_int) for n in _INTS]
                + [("attn_scale", ctypes.c_float), ("xq_scale", ctypes.c_float),
                   ("parts", ctypes.c_void_p), ("sync", ctypes.c_void_p),
                   ("split", ctypes.c_int * len(LINEARS)), ("n_xattn", ctypes.c_int),
                   ("prof", ctypes.c_void_p), ("phases", ctypes.c_void_p)])


_SYNC: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _sync_words(device: torch.device, n: int) -> torch.Tensor:
    """The kernel's grid barrier count (a 64-bit count of
    arrivals that only grows, a multiple of the grid after every launch) and
    per-tile counters (left zeroed) for launches on ``device``'s current
    stream: zeroed once, so one buffer serves every launch of that stream,
    each after the one before. Launches on two streams never share one: each
    stream has its own."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _SYNC.get(key)
    if t is None or t.numel() < n:
        t = _SYNC[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return t


def _plan_args(args: _Args, p: Dict[str, Any]) -> None:
    args.split[:] = p["split"]
    args.n_xattn = p["n_xattn"]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _checked_lib() -> ctypes.CDLL:
    lib = cuda_build.kernels()
    if lib.fmt_decode_megakernel_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("decode_megakernel: ctypes _Args does not match "
                           "struct MegaArgs")
    return lib


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"decode_step_megakernel: {name} must be contiguous "
                         f"{dtype} {tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_anc(beam_anc: torch.Tensor, b: int) -> None:
    if beam_anc.dtype != torch.int32 or beam_anc.dim() != 3 \
            or beam_anc.shape[1] < 1 or beam_anc.shape[0] * beam_anc.shape[1] != b:
        raise ValueError(f"decode_step_megakernel: beam_anc must be int32 "
                         f"(families, kb, anc_len) with families * kb = {b}, "
                         f"got {beam_anc.dtype} {tuple(beam_anc.shape)}")


def max_rows(packed: Params, config) -> int:
    """The most batch rows the CUDA kernel's offsets take: its offsets into
    the (rows, width) activation buffers are 32-bit ints (module docstring
    of csrc/decode_megakernel.cu). Its shared memory is checked apart
    (``refuse_unless_fits``): it grows with the rows of a pass up to
    ``PASS_ROWS`` and with D."""
    D, Dff, _L, _H = trunk_dims(config.lm_arch)
    XI = config.xattn_heads * config.xattn_dim_head
    Dffx = packed["w_xf1"].shape[1]
    return INDEX_LIMIT // max(2 * max(D, XI), Dff, Dffx)


def refuse_unless_fits(rows: int, need: int, limit: int) -> None:
    """The decision on the kernel's shared memory: a block of a launch over
    ``rows`` rows needs ``need`` bytes (``fmt_decode_megakernel_smem``);
    the card lets a block opt in to ``limit``. Raises ``ValueError`` past
    it, naming both."""
    if need > limit:
        raise ValueError(f"decode_step_megakernel: {rows} rows need {need} bytes "
                         f"of shared memory per block, past the card's limit of "
                         f"{limit} bytes (a trunk this wide takes fewer rows)")


def _smem_need(args: _Args) -> int:
    """The kernel's own shared-memory formula for these arguments (the
    CUDA source's; ``plan_smem_bytes`` mirrors it for the CPU tests)."""
    return int(_checked_lib().fmt_decode_megakernel_smem(ctypes.addressof(args)))


def _smem_limit(device: torch.device) -> int:
    return int(torch.cuda.get_device_properties(device).shared_memory_per_block_optin)


def check_fits(config, rows: int, t_lim: int, n_media_latents: int, *,
               act_quant: bool, device) -> None:
    """Refuse, before any work, a megakernel launch that the card cannot
    hold: ``rows`` batch rows (b greedy, b * k beams), caches of ``t_lim``
    positions and ``n_media_latents`` xattn positions. On the CPU the plain
    version takes any size and nothing is checked."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    D, Dff, _L, _H = trunk_dims(config.lm_arch)
    XI = config.xattn_heads * config.xattn_dim_head
    Dffx = config.dim * config.xattn_ff_mult
    args = _Args(b=rows, D=D, Dff=Dff, XI=XI, Dffx=Dffx, t_lim=t_lim,
                 NMNV=n_media_latents, act_quant=int(act_quant))
    _plan_args(args, plan(rows, D, Dff, XI, Dffx, n_xattn=1, blocks=_sm_count(device),
                          act_quant=act_quant))
    refuse_unless_fits(rows, _smem_need(args), _smem_limit(device))


def kernel_args(packed: Params, xk, xv, kc, vc, x_emb, npad, text_time,
                cur: int, *, config, kv_limit: Optional[int] = None,
                beam_anc: Optional[torch.Tensor] = None, act_quant: bool = False
                ) -> Tuple[_Args, torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Check the CUDA kernel's inputs -> (arguments, output, the scratch
    buffers the arguments point into)."""
    arch = config.lm_arch
    D, Dff, L, H = trunk_dims(arch)
    dev = x_emb.device
    b = x_emb.shape[0]
    limit = max_rows(packed, config)
    if b > limit:
        raise ValueError(f"decode_step_megakernel: {b} rows exceed the "
                         f"kernel's limit of {limit} rows (32-bit offsets "
                         f"into the (rows, width) activation buffers)")
    T = kc.shape[1]
    NMNV, XI = xk.shape[1], xk.shape[3]
    XH = config.xattn_heads
    NX, Dffx = packed["w_xf1"].shape[:2]
    t_lim = T if kv_limit is None else min(kv_limit, T)
    if D % H or D // H not in HEAD_DIMS or XI % XH or XI // XH != HEAD_DIM:
        raise ValueError(f"decode_step_megakernel: the CUDA kernel takes self-attention "
                         f"heads {HEAD_DIMS} wide and xattn heads {HEAD_DIM} wide, got "
                         f"D={D}/{H} heads, XI={XI}/{XH} heads")
    if phase_timer is not None and D // H != HEAD_DIM:
        raise ValueError(f"decode_step_megakernel: the phase timer runs in the "
                         f"{HEAD_DIM}-wide kernels only, got heads {D // H} wide")
    if D % K_CHUNK or Dff % K_CHUNK or Dffx % K_CHUNK or XI % K_CHUNK:
        raise ValueError(f"decode_step_megakernel: D, Dff and XI must be "
                         f"multiples of {K_CHUNK}")
    if not 0 <= cur < t_lim:
        raise ValueError(f"decode_step_megakernel: cur={cur} outside "
                         f"[0, {t_lim})")
    bf16, i32, f32, i8 = torch.bfloat16, torch.int32, torch.float32, torch.int8
    _require(x_emb, "x_emb", bf16, (b, D), dev)
    for name, t in (("kc", kc), ("vc", vc)):
        _require(t, name, bf16, (L, T, b, D), dev)
    for name, t in (("xk", xk), ("xv", xv)):
        _require(t, name, bf16, (L, NMNV, b, XI), dev)
    for name, t in (("npad", npad), ("text_time", text_time)):
        _require(t, name, i32, (b,), dev)
    shapes = {"w_qkv": (i8, (L, 3 * D, D)), "w_o": (i8, (L, D, D)),
              "w_fc": (i8, (L, Dff, D)), "w_pr": (i8, (L, D, Dff)),
              "w_xq": (i8, (NX, XI, D)), "w_xo": (i8, (NX, D, XI)),
              "w_xf1": (i8, (NX, Dffx, D)), "w_xf2": (i8, (NX, D, Dffx)),
              "gates": (f32, (NX, 2)), "hasx": (i32, (L,))}
    for name in ("qkv", "o", "fc", "pr"):
        n = shapes["w_" + name][1][1]
        shapes["s_" + name] = (f32, (L, n))
        shapes["b_" + name] = (bf16, (L, n))
    for name in ("xq", "xo", "xf1", "xf2"):
        shapes["s_" + name] = (f32, (NX, shapes["w_" + name][1][1]))
    for name in ("ln1", "ln2"):
        shapes[name + "_s"] = shapes[name + "_b"] = (f32, (L, D))
    for name in ("xn", "xfn"):
        shapes[name + "_s"] = shapes[name + "_b"] = (f32, (NX, D))
    for name in _POINTERS:
        _require(packed[name], name, *shapes[name], dev)
    kb, anc_len = 1, 0
    if beam_anc is not None:
        _check_anc(beam_anc, b)
        kb, anc_len = beam_anc.shape[1], beam_anc.shape[2]
        _require(beam_anc, "beam_anc", i32, beam_anc.shape, dev)

    out = torch.empty((b, D), dtype=bf16, device=dev)
    scratch = torch.empty(b * (2 * max(D, XI) + max(Dff, Dffx)), dtype=bf16,
                          device=dev)
    # w8a8: one amax word per D-wide slice of a row of abuf and of hbuf
    # (the kernel zeroes them)
    amax = (torch.empty(b * (-(-max(D, XI) // D) + -(-max(Dff, Dffx) // D)), dtype=i32,
                        device=dev) if act_quant else None)
    p = plan(b, D, Dff, XI, Dffx, n_xattn=NX, blocks=_sm_count(dev), act_quant=act_quant)
    parts = torch.empty(p["parts_floats"], dtype=f32, device=dev)
    sync = _sync_words(dev, p["sync_words"])
    tensors = dict(xk=xk, xv=xv, kc=kc, vc=vc, x_emb=x_emb, npad=npad,
                   text_time=text_time, x=out, scratch=scratch, anc=beam_anc,
                   amax=amax, parts=parts, sync=sync)
    args = _Args(
        **{n: packed[n].data_ptr() for n in _POINTERS},
        **{n: None if t is None else t.data_ptr() for n, t in tensors.items()},
        b=b, D=D, Dff=Dff, Dffx=Dffx, XI=XI, n_layer=L, n_head=H, x_heads=XH,
        n_visual=config.resampler_num_latents, NMNV=NMNV, T=T, cur=cur,
        t_lim=t_lim, act=ACT_CODES[arch.activation],
        xact=ACT_CODES[config.xattn_act], kb=kb, anc_len=anc_len,
        act_quant=int(act_quant), attn_scale=(D // H) ** -0.5,
        xq_scale=const(config.xattn_dim_head ** -0.5, torch.bfloat16))
    _plan_args(args, p)
    if section_timer is not None:
        _require(section_timer, "section_timer", torch.int64,
                 (_sm_count(dev), len(SECTIONS)), dev)
        args.prof = section_timer.data_ptr()
    if phase_timer is not None:
        _require(phase_timer, "phase_timer", torch.int64,
                 (step_phases(packed), _sm_count(dev), len(SECTIONS)), dev)
        args.phases = phase_timer.data_ptr()
    refuse_unless_fits(b, _smem_need(args), _smem_limit(dev))
    return args, out, (scratch, amax, parts, sync)


def grid_sync_test(device, phases: int) -> int:
    """The kernel's grid barrier alone on the card
    (``fmt_grid_sync_test``): one block per SM writes a stamp before each of
    ``phases`` barriers and reads every block's back after it -> the number
    of stamps read wrong (0 when the barrier holds). The count of arrivals
    must end at ``phases`` x the grid."""
    device = torch.device(device)
    sync = torch.zeros(2, dtype=torch.int32, device=device)
    slots = torch.zeros(2 * _sm_count(device), dtype=torch.int32, device=device)
    errors = torch.zeros(1, dtype=torch.int32, device=device)
    err = _checked_lib().fmt_grid_sync_test(
        sync.data_ptr(), slots.data_ptr(), errors.data_ptr(), phases,
        torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check(err, "grid_sync_test")
    arrivals = int(sync.view(torch.int64)[0])
    if arrivals != phases * _sm_count(device):
        raise RuntimeError(f"grid_sync_test: {arrivals} arrivals counted after "
                           f"{phases} barriers of {_sm_count(device)} blocks")
    return int(errors[0])


def kernel_grid(args: _Args) -> Tuple[int, int]:
    """(blocks, dynamic shared memory bytes) of the cooperative grid that
    ``decode_step_megakernel`` launches for these arguments."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = _checked_lib().fmt_decode_megakernel_grid(
        ctypes.addressof(args), ctypes.addressof(blocks), ctypes.addressof(smem))
    cuda_build.check(err, "decode_step_megakernel grid")
    return blocks.value, smem.value


def decode_step_megakernel(packed: Params, xk: torch.Tensor, xv: torch.Tensor,
                           kc: torch.Tensor, vc: torch.Tensor,
                           x_emb: torch.Tensor, npad: torch.Tensor,
                           text_time: torch.Tensor, cur: int, *, config,
                           kv_limit: Optional[int] = None,
                           beam_anc: Optional[torch.Tensor] = None,
                           act_quant: bool = False) -> torch.Tensor:
    """One decode step through every layer -> hidden (b, D) bf16, before
    ``ln_f``. Writes each layer's K/V row at ``cur`` into the stacked caches
    in place.

    packed: ``pack_decode_weights``; xk/xv: (n_layer, NMNV, b, XI) bf16
    (``pack_xattn_kv_flat``); kc/vc: (n_layer, T, b, D) bf16; x_emb: (b, D)
    bf16 token + position embeddings; npad: (b,) int32 first real slot;
    text_time: (b,) int32 media count; only the cache prefix
    ``[0, min(kv_limit, T))`` is read. beam_anc: None (greedy) or the
    lazy-beam ancestry table (b // kb, kb, anc_len) int32; rows come in
    families of kb that never move (``decode_attention_beam``).
    act_quant: the w8a8 tier (int8 activations, module docstring).
    """
    cur = int(cur)
    if beam_anc is not None:
        _check_anc(beam_anc, x_emb.shape[0])
    if x_emb.device.type == "cpu":
        return decode_step_megakernel_plain(packed, xk, xv, kc, vc, x_emb, npad,
                                            text_time, cur, config=config,
                                            kv_limit=kv_limit, beam_anc=beam_anc,
                                            act_quant=act_quant)
    if x_emb.device.type != "cuda":
        raise ValueError(f"decode_step_megakernel: unsupported device {x_emb.device}")
    args, out, _scratch = kernel_args(packed, xk, xv, kc, vc, x_emb, npad,
                                      text_time, cur, config=config,
                                      kv_limit=kv_limit, beam_anc=beam_anc,
                                      act_quant=act_quant)
    lib = _checked_lib()
    decode_step_megakernel.launches += 1
    err = lib.fmt_decode_megakernel(
        ctypes.addressof(args), torch.cuda.current_stream(x_emb.device).cuda_stream)
    cuda_build.check(err, "decode_step_megakernel", out)
    return out


decode_step_megakernel.launches = 0
