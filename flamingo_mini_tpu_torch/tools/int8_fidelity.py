"""The fidelity cost of the deployment default, on the card: int8
weight-only against bf16 greedy decoding, and the w8a8 tier. Port of the
JAX package's ``tools/int8_fidelity.py``.

The deployment default serves int8 weight-only (the trunk and the gated
xattn blocks) with live-prefix segments. Segments are exact; int8 is not,
and this measures what it costs at caption level:

* ``--captions`` (1,024) captions at flamingo-mini width (GPT-2-medium +
  ViT-L/14), weights random from a seed; greedy ``--decode-tokens`` (64)
  tokens, EOS out of reach, the same prompts and pixels for every system:
  batch ``bi`` draws 4-token prompts and its pixels from
  ``RandomState(1000 + bi)``, one image at position 0;
* the systems: bf16 and int8 weight-only on the per-layer path, as the
  JAX package's ``DecodeConfig`` runs them (``megakernel=False``,
  ``prefix_block=32``); with ``--w8a8`` also the megakernel's w8a8 tier
  (int8 activations per row), against both;
* per pair: the identical captions and tokens (%) and the histogram of each
  diverging caption's first differing position.

``--smoke`` runs a tiny model (64 captions, batch 8, 16 tokens);
``--trained-smoke`` (tiny, 512 captions) and ``--trained-full`` (flamingo-
mini, 512 captions) measure the random weights, then train every parameter
with AdamW (lr 3e-3 and 1e-4, weight decay 1e-4, optax's defaults) for 400
steps (``--train-steps`` for the full model) on one seeded batch, and
measure again: training sharpens the logit margins, so int8 should flip
fewer argmaxes. The result is printed as JSON, and written to ``--out``
when given. It runs on the card unless ``--device cpu``.

    python -m flamingo_mini_tpu_torch.tools.int8_fidelity [--captions 1024] [--w8a8]
    python -m flamingo_mini_tpu_torch.tools.int8_fidelity --trained-full --w8a8 --out f.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configuration_flamingo import FlamingoConfig
from ..generation import DecodeConfig, generate_impl
from ..models import flamingo as F
from ..ops.layers import FAST
from ..ops.quant import (cast_params_bf16, quantize_gpt2_lm, quantize_opt_lm,
                         quantize_xattn_blocks)
from ..train.trainer import AdamW
from ..utils.params import leaves_with_path

PROMPT_LEN = 4
PREFIX_BLOCK = 32
EOS = 10 ** 9                      # out of reach: every caption runs its length
HIST_EDGES = (0, 1, 2, 4, 8, 16, 32, 64, 128)
WEIGHT_DECAY = 1e-4                # optax.adamw's default


def smoke_config() -> FlamingoConfig:
    """The tiny model of ``--smoke``."""
    return FlamingoConfig(
        lm="gpt2", clip_model_type="openai/clip-vit-base-patch32",
        dim=64, dim_visual=64, xattn_every=1, xattn_dim_head=16,
        xattn_heads=4, resampler_depth=2, resampler_dim_head=16,
        resampler_heads=4, resampler_num_latents=8,
        compute_dtype="bfloat16",
        lm_arch_overrides=dict(vocab_size=256, n_positions=512, n_embd=64,
                               n_layer=4, n_head=4),
        vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   image_size=64, patch_size=16))


def headline_config() -> FlamingoConfig:
    """Flamingo-mini: GPT-2-medium + ViT-L/14, xattn before every layer."""
    return FlamingoConfig(
        lm="gpt2-medium", clip_model_type="openai/clip-vit-large-patch14",
        dim=1024, dim_visual=1024, compute_dtype="bfloat16")


class PairStats:
    """Caption and token agreement of one (a, b) pair of systems, over
    captions of ``decode_tokens`` tokens."""

    def __init__(self, decode_tokens: int):
        self.decode_tokens = decode_tokens
        self.caps = self.toks = self.total = self.n = 0
        self.first_div: List[int] = []

    def add(self, a: np.ndarray, b: np.ndarray) -> None:
        same = a == b
        self.caps += int(same.all(axis=1).sum())
        self.toks += int(same.sum())
        self.total += same.size
        self.n += a.shape[0]
        for row in range(a.shape[0]):
            if not same[row].all():
                self.first_div.append(int(np.argmax(~same[row])))

    def report(self) -> Dict:
        edges = [e for e in HIST_EDGES if e < self.decode_tokens] + [self.decode_tokens]
        hist, _ = np.histogram(self.first_div, bins=edges)
        return {
            "captions": self.n,
            "identical_captions_pct": round(100.0 * self.caps / self.n, 2),
            "identical_tokens_pct": round(100.0 * self.toks / self.total, 3),
            "first_divergence_hist": {
                f"[{edges[i]},{edges[i + 1]})": int(hist[i]) for i in range(len(hist))},
        }


def quantize(params, config: FlamingoConfig):
    """The deployment default's weights: the trunk and the xattn blocks in
    int8 weight-only, the rest bf16."""
    quantize_lm = quantize_gpt2_lm if F.lm_family(config) == "gpt2" else quantize_opt_lm
    return cast_params_bf16({**params, "lm": quantize_lm(params["lm"]),
                             "xattn": quantize_xattn_blocks(params["xattn"])})


def batch_inputs(config: FlamingoConfig, bi: int, batch: int, device):
    """Batch ``bi``'s prompts, media locations, mask and bf16 pixels."""
    rs = np.random.RandomState(1000 + bi)
    hi = min(1000, config.lm_arch.vocab_size - 1)
    ids = torch.tensor(rs.randint(0, hi, (batch, PROMPT_LEN)), device=device)
    media = torch.zeros((batch, PROMPT_LEN), dtype=torch.int32, device=device)
    media[:, 0] = 1
    mask = torch.ones((batch, PROMPT_LEN), dtype=torch.int32, device=device)
    size = config.vision_arch.image_size
    px = torch.tensor(rs.randn(batch, 1, 3, size, size), dtype=torch.float32,
                      device=device).to(torch.bfloat16)
    return ids, media, mask, px


def decode(config: FlamingoConfig, params, inputs, decode_tokens: int,
           w8a8: bool = False) -> np.ndarray:
    """Greedy tokens after the prompt, (b, decode_tokens): per layer, or on
    the megakernel's w8a8 tier."""
    dc = DecodeConfig(max_length=PROMPT_LEN + decode_tokens, eos_token_id=EOS,
                      pad_token_id=0, prefix_block=PREFIX_BLOCK, megakernel=w8a8,
                      w8a8=w8a8)
    ids, media, mask, px = inputs
    out = generate_impl(params, config, dc, FAST, ids, media, mask, pixel_values=px)
    return out[:, PROMPT_LEN:].cpu().numpy()


def compare(config: FlamingoConfig, p_bf16, p_int8, *, captions: int, batch: int,
            decode_tokens: int, w8a8: bool = False, device="cuda") -> Dict[str, PairStats]:
    """The pairs' agreement over ``ceil(captions / batch)`` batches of
    ``batch_inputs``: ``int8_vs_bf16``; with ``w8a8`` also
    ``w8a8_vs_bf16`` and ``w8a8_vs_int8`` (the w8a8 tier runs the int8
    weights)."""
    pairs = {"int8_vs_bf16": PairStats(decode_tokens)}
    if w8a8:
        pairs["w8a8_vs_bf16"] = PairStats(decode_tokens)
        pairs["w8a8_vs_int8"] = PairStats(decode_tokens)
    for bi in range(-(-captions // batch)):
        inputs = batch_inputs(config, bi, batch, device)
        a = decode(config, p_bf16, inputs, decode_tokens)
        b = decode(config, p_int8, inputs, decode_tokens)
        pairs["int8_vs_bf16"].add(a, b)
        if w8a8:
            c = decode(config, p_int8, inputs, decode_tokens, w8a8=True)
            pairs["w8a8_vs_bf16"].add(c, a)
            pairs["w8a8_vs_int8"].add(c, b)
    return pairs


def measure(config: FlamingoConfig, params, *, captions: int, batch: int,
            decode_tokens: int, w8a8: bool = False, device="cuda") -> Dict:
    """The report of ``compare`` for float32 ``params``: bf16 and int8 made
    from them; with ``w8a8`` one report per pair."""
    pairs = compare(config, cast_params_bf16(params), quantize(params, config),
                    captions=captions, batch=batch, decode_tokens=decode_tokens,
                    w8a8=w8a8, device=device)
    if not w8a8:
        return pairs["int8_vs_bf16"].report()
    return {k: v.report() for k, v in pairs.items()}


def train(config: FlamingoConfig, params, *, steps: int, lr: float, seq: int,
          vocab_hi: int, device) -> Dict:
    """Train every leaf of ``params`` in place: AdamW at ``lr`` on one
    batch of 8 x ``seq`` tokens below ``vocab_hi`` and 8 images, drawn from
    ``RandomState(0)``, the tokens their own labels, under the bf16 policy.
    -> the first step's loss and the last's (each before its update), and
    the seconds the steps took."""
    rs = np.random.RandomState(0)
    size = config.vision_arch.image_size
    ids = torch.tensor(rs.randint(0, vocab_hi, (8, seq)), device=device)
    px = torch.tensor(rs.randn(8, 1, 3, size, size), dtype=torch.float32, device=device)
    media = torch.zeros((8, seq), dtype=torch.int32, device=device)
    media[:, 0] = 1
    leaves = [leaf.requires_grad_(True) for _, leaf in leaves_with_path(params)]
    opt = AdamW(leaves, lambda _count: lr, weight_decay=WEIGHT_DECAY)
    first = None
    t0 = time.perf_counter()
    for i in range(steps):
        loss = F.forward(params, config, ids, policy=FAST, media_locations=media,
                         pixel_values=px, labels=ids).loss
        # the vision tower runs under no_grad (no gradient, as in JAX): its
        # zeros still take the decay
        opt.update(torch.autograd.grad(loss, leaves, allow_unused=True,
                                       materialize_grads=True))
        if i == 0:
            first = loss.detach()
    last = float(loss.detach())              # waits for the last step
    seconds = time.perf_counter() - t0
    for leaf in leaves:
        leaf.requires_grad_(False)
    return {"steps": steps, "first_loss": round(float(first), 4),
            "last_loss": round(last, 4), "seconds": round(seconds, 1)}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m flamingo_mini_tpu_torch.tools.int8_fidelity",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--captions", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + 64 captions (CI-sized)")
    ap.add_argument("--trained-smoke", action="store_true",
                    help="the tiny model, random weights and after a short "
                         "training run (sharper logit margins), same prompts")
    ap.add_argument("--trained-full", action="store_true",
                    help="the same trained-vs-random measurement at "
                         "flamingo-mini width")
    ap.add_argument("--train-steps", type=int, default=400)
    ap.add_argument("--w8a8", action="store_true",
                    help="also the megakernel's w8a8 tier against bf16 and "
                         "against int8 weight-only (needs flamingo-mini width)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--device", default="cuda", help="the model's device")
    args = ap.parse_args(argv)
    if args.trained_smoke:
        args.smoke = True
    if args.w8a8 and args.smoke and not args.trained_full:
        ap.error("--w8a8 needs the headline scale (the megakernel takes the "
                 "1024-wide GPT-2 trunk)")
    if args.smoke:
        args.captions = min(args.captions, 512 if args.trained_smoke else 64)
        args.batch = min(args.batch, 8)
        args.decode_tokens = 16
    return args


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    # bf16 products summed in float32 throughout, as the JAX package's
    # (the reference system must not add cuBLAS's bf16 reductions of its own)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    config = smoke_config() if args.smoke and not args.trained_full else headline_config()
    params = F.init_flamingo(torch.Generator(device=device).manual_seed(0), config)
    kw = dict(batch=args.batch, decode_tokens=args.decode_tokens, device=device)
    result = {
        "model": config.lm,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "decode_tokens": args.decode_tokens,
        "weights": "random from seed 0",
        "note": "prefix_block is exact; this measures int8 weight-only (the "
                "trunk and the gated xattn) alone",
    }
    if args.trained_full or args.trained_smoke:
        if args.trained_full:
            captions, steps, lr, seq = min(args.captions, 512), args.train_steps, 1e-4, 32
            vocab_hi = config.lm_arch.vocab_size - 2
        else:
            captions, steps, lr, seq = args.captions, 400, 3e-3, 16
            vocab_hi = config.lm_arch.vocab_size - 1
        result["random_init"] = measure(config, params, captions=captions,
                                        w8a8=args.w8a8, **kw)
        result["training"] = train(config, params, steps=steps, lr=lr, seq=seq,
                                   vocab_hi=vocab_hi, device=device)
        result["after_training"] = measure(config, params, captions=captions,
                                           w8a8=args.w8a8, **kw)
        result["weights"] = "random from seed 0, then trained on one batch"
    elif args.w8a8:
        result["pairs"] = measure(config, params, captions=args.captions, w8a8=True, **kw)
        result["note"] = ("w8a8 = the megakernel tier with int8 activations per row "
                          "on every trunk and xattn linear; w8a8_vs_int8 isolates "
                          "the activation rounding on top of int8 weight-only")
    else:
        result.update(measure(config, params, captions=args.captions, **kw))
    text = json.dumps(result, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
