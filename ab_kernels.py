#!/usr/bin/env python3
"""Time the port's kernels in two checkouts on one card, in turns.

    python3 ab_kernels.py A_DIR B_DIR [GROUP ...]

GROUPs (all unless some are named): attention, media, head, decode, mega,
probes.
Runs each checkout in a process of its own (each builds its own kernels
from its own sources) in the order A, B, B, A and prints, for each run, the
median device time of ``decode_attention`` (b=32, D=1024, H=16, T=192,
cur 131, kv_limit 132, and OPT-1.3B's b=8, D=2048, H=32, T=128, cur 70,
kv_limit 71, bf16) and ``decode_attention_beam`` (96 rows in families of
3, T=128, cur 66, kv_limit 68), each beside its wrapper's host us per
call, of ``decode_step_megakernel`` at 24
layers: flamingo-mini width at b=32 and at b=1 (the fixed cost; kv_limit
132), its beam mode at 96 rows (3 beams) and 160 rows (5 beams; kv_limit
68) and its OPT mode at OPT-1.3B width, b=8 (kv_limit 71), each also in
the w8a8 mode (``act_quant``) where the checkout has it, of
``lm_head_argmax`` at flamingo-mini's head (B=32, D=1024, V=50,258) and
OPT-1.3B's (B=8, D=2048, V=50,273), and at B=32, D=1040 (a width of no
model: a K tail; null where the checkout's head refuses it), each beside
its wrapper's host us per call, and
of the bf16 attention kernels of ``use_pallas``: ``fused_attention`` at the
ViT (32, 16, 257, 257), resampler (32, 8, 64, 321) and causal GPT-2 and
OPT-1.3B forward shapes (two rows left-padded by 8) and ``flash_attention``
at (2, 16, 4000, 64), each beside its wrapper's host us per call, and of
``fused_media_xattn`` (bf16) at chip_smoke.py's ``MEDIA_SHAPES`` (the
prefill, the forward, two images with the first half of the rows after
image 1 and the second after image 2) and at 40 tokens over 13 and 20
images, each beside its time with L2 clean and its wrapper's host us per
call, and of the decode stream probes' three kernels alone (L2 flushed and
clean, host us per call) and in situ (us per layer of their loops beside
``tmajor_kernel`` and ``glue_only``). L2
flushed, on the inputs of each checkout's ``chip_smoke.py``; every time is
taken by this checkout's ``chip_smoke.time_ms`` (a spin on the card before
each call, so that the events time the card alone), whatever the timed
checkout's own timer. With the mega group, two more processes, B and A,
time the megakernel cases alone, so that each checkout's megakernel runs
in three fresh processes; the last lines print each process's OPT-1.3B times (a
level set per process shows there). Writes the runs to
``chiprun_out/ab_kernels.json``. Needs a card; exits 1 without one.
"""
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# this checkout's timers (chip_smoke.time_ms, host_us), for both trees
_spec = importlib.util.spec_from_file_location("chip_smoke_timers",
                                               os.path.join(REPO, "chip_smoke.py"))
_timers = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_timers)
time_ms, host_us = _timers.time_ms, _timers.host_us


def attention(cs, dev, flush, out: dict) -> None:
    """The bf16 attention kernels of use_pallas at chip_smoke's shapes."""
    from flamingo_mini_tpu_torch.ops.fused_attention import (flash_attention,
                                                             fused_attention)
    scale = cs.HEAD_DIM ** -0.5
    for name, (b, h, n_q, n_kv) in cs.ATT_SHAPES.items():
        q, k, v = cs.attention_inputs(dev, torch.bfloat16, b, h, n_q, n_kv, seed=1)
        kw = dict(scale=scale)
        if name.endswith("forward"):
            # float32, as the trunks build it once per forward for every layer
            kw.update(causal=True, row_bias=cs.left_pad_bias(
                dev, torch.bfloat16, b, n_q,
                [cs.GPT2_PAD, cs.GPT2_PAD] + [0] * (b - 2)).float())
        label = "fused_attention_" + name.replace(" ", "_")
        out[label + "_ms"] = time_ms(lambda: fused_attention(q, k, v, **kw), 50, flush)
        out[label + "_host_us"] = host_us(lambda: fused_attention(q, k, v, **kw))
    b, h, n = cs.FLASH_SHAPE
    q, k, v = cs.attention_inputs(dev, torch.bfloat16, b, h, n, n, seed=8)
    out["flash_attention_ms"] = time_ms(lambda: flash_attention(q, k, v, scale=scale), 20,
                                        flush)
    out["flash_attention_host_us"] = host_us(lambda: flash_attention(q, k, v, scale=scale))


def media(cs, dev, flush, out: dict) -> None:
    """``fused_media_xattn`` (bf16) at chip_smoke's MEDIA_SHAPES and at 40
    tokens over 13 and 20 images (832 and 1,280 keys), 8 heads of 64 over 64
    latents an image, scale 1 (as the models call it); text_time 1 on every
    row, with more images the last one on the second half of the rows (made
    here: the same in each checkout); null where the checkout refuses the
    shape."""
    from flamingo_mini_tpu_torch.ops.media_xattn import fused_media_xattn
    shapes = dict(cs.MEDIA_SHAPES, **{"13 images": (8, 40, 13), "20 images": (8, 40, 20)})
    for name, (b, n_q, n_media) in shapes.items():
        q, k, v = cs.attention_inputs(dev, torch.bfloat16, b, 8, n_q, 64 * n_media, 2)
        tt = torch.ones((b, n_q), dtype=torch.int32, device=dev)
        tt[:, n_q // 2:] = n_media

        def fn():
            return fused_media_xattn(q, k, v, tt, scale=1.0, n_visual=64)
        label = "fused_media_xattn_" + name.replace(" ", "_")
        try:
            fn()
        except ValueError:   # a kernel that does not take this many keys
            out[label + "_ms"] = out[label + "_clean_ms"] = out[label + "_host_us"] = None
            continue
        out[label + "_ms"] = time_ms(fn, 100, flush)
        out[label + "_clean_ms"] = time_ms(fn, 100, flush, clean=True)
        out[label + "_host_us"] = host_us(fn)


def head(dev, flush, out: dict) -> None:
    """``lm_head_argmax`` at the two heads of the greedy paths, on random
    int8 rows padded as generate pads them (the same inputs in each
    checkout: made here, not by the checkout's chip_smoke)."""
    from flamingo_mini_tpu_torch.ops.lm_head import lm_head_argmax, pad_head_weights
    for label, (B, D, V) in (("lm_head_argmax", (32, 1024, 50258)),
                             ("lm_head_argmax_opt", (8, 2048, 50273)),
                             ("lm_head_argmax_1040", (32, 1040, 50258))):
        gen = torch.Generator(device=dev).manual_seed(B + D)
        w8 = torch.randint(-127, 128, (V, D), generator=gen, device=dev).to(torch.int8)
        scale = torch.rand(V, generator=gen, device=dev) * 0.01 + 1e-4
        h = pad_head_weights({"w8": w8, "scale": scale}, 2048)
        x = (0.1 * torch.randn((B, D), generator=gen, device=dev)).to(torch.bfloat16)

        def fn():
            return lm_head_argmax(h["w8"], h["scale"], x, n_valid=V)
        try:
            fn()
        except ValueError:   # a head that does not take this width
            out[label + "_ms"] = out[label + "_host_us"] = None
            continue
        out[label + "_ms"] = time_ms(fn, 100, flush)
        out[label + "_host_us"] = host_us(fn)


def decode_attentions(cs, dev, flush, out: dict) -> None:
    """``decode_attention`` at flamingo-mini's greedy shape (b=32, D=1024,
    H=16, T=192, cur 131, kv_limit 132) and OPT-1.3B's (b=8, D=2048, H=32,
    T=128, cur 70, kv_limit 71), ``decode_attention_beam`` at 96 rows (32
    families of 3, D=1024, T=128, cur 66, kv_limit 68), bf16, each beside its
    wrapper's host us per call; the same inputs in each checkout (made here:
    numpy and torch generators, the beams' ancestry and padding by
    chip_smoke's helpers, which both checkouts have)."""
    from flamingo_mini_tpu_torch.ops.decode_attention import (decode_attention,
                                                              decode_attention_beam)
    for label, (b, D, T, cur, kv_limit) in (
            ("decode_attention", (32, 1024, 192, 131, 132)),
            ("decode_attention_opt", (8, 2048, 128, 70, 71)),
            ("decode_attention_beam96", (96, 1024, 128, 66, 68))):
        rs = np.random.RandomState(b + D)
        q, k, v = (torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32, device=dev)
                   .to(torch.bfloat16) for s in ((b, D), (T, b, D), (T, b, D)))
        kw = dict(n_head=D // 64, scale=0.125, kv_limit=kv_limit)
        if label.endswith("beam96"):
            anc = cs.random_ancestry(dev, b // 3, 3, seed=3)
            npad = cs.family_npad(dev, b // 3, 3)

            def fn():
                return decode_attention_beam(q, k, v, anc, npad, cur, kb=3, **kw)
        else:
            npad = torch.tensor(np.arange(b) % 4, dtype=torch.int32, device=dev)

            def fn():
                return decode_attention(q, k, v, npad, cur, **kw)
        out[label + "_ms"] = time_ms(fn, 100, flush)
        out[label + "_host_us"] = host_us(fn)


def probes(cs, dev, flush, out: dict) -> None:
    """The decode stream probes' three kernels at each layout's timed
    block_t (b-major 32, T-major 32, packed 16; b=32, D=1024, T=192,
    kv_limit 128), L2 flushed and clean, with their wrapper's host us per
    call, on chip_smoke's seeded inputs; then in situ (one CUDA graph per
    trip count, ``probe_decode_kernel.measure``) the three stream loops,
    ``tmajor_kernel`` and ``glue_only``, in us per layer."""
    from flamingo_mini_tpu_torch.tools import probe_decode_kernel as pdk
    for layout, block_t in (("bmajor", 32), ("tmajor", 32), ("packed", 16)):
        q, caches = cs.stream_probe_inputs(dev, layout, 60)

        def fn():
            return cs.stream_probe_call(layout, q, caches, block_t, None, pdk.KV_LIMIT)
        label = f"stream_{layout}_bt{block_t}"
        out[label + "_ms"] = time_ms(fn, 100, flush)
        out[label + "_clean_ms"] = time_ms(fn, 100, flush, clean=True)
        out[label + "_host_us"] = host_us(fn)
        del q, caches
    args = pdk.inputs(dev, torch.Generator(device=dev).manual_seed(70))
    for name, run in (("stream_bmajor_bt32", pdk.make_flat_loop(pdk.attn_stream_only,
                                                                block_t=32)),
                      ("stream_tmajor_bt32", pdk.make_tmajor_loop(32)),
                      ("stream_tmajor_packed_bt16", pdk.make_tmajor_packed_loop(16)),
                      ("tmajor_kernel", pdk.make_tmajor_loop(None, real_kernel=True)),
                      ("glue_only", pdk.make_flat_loop(lambda q, *_, **__: q))):
        out["insitu_" + name + "_us"] = pdk.measure(name, run, args)["per_layer_us"]


GROUPS = ("attention", "media", "head", "decode", "mega", "probes")


def one(tree: str, groups=GROUPS) -> dict:
    """The kernels' times in the checkout ``tree``, an absolute path (run in
    its own process, from that directory), of the named groups."""
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from flamingo_mini_tpu_torch.ops.megadecode import decode_step_megakernel
    dev = torch.device("cuda", 0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {"tree": tree, "groups": list(groups)}
    if "attention" in groups:
        attention(cs, dev, flush, out)
    if "media" in groups:
        media(cs, dev, flush, out)
    if "head" in groups:
        head(dev, flush, out)
    if "decode" in groups:
        decode_attentions(cs, dev, flush, out)
    if "probes" in groups:
        probes(cs, dev, flush, out)
    if "mega" not in groups:
        return out
    modes = [False]
    if "act_quant" in inspect.signature(decode_step_megakernel).parameters:
        modes.append(True)

    def mega(label, packed, cfg, inputs, cur, kv_limit, **kw):
        for act_quant in modes:
            extra = dict(kw, act_quant=True) if act_quant else kw
            out[label + ("_w8a8" if act_quant else "") + "_ms"] = time_ms(
                lambda: decode_step_megakernel(packed, *inputs, cur, config=cfg,
                                               kv_limit=kv_limit, **extra), 30, flush)

    cfg, packed = cs.random_trunk(dev, n_layer=24, xattn_every=1, seed=24)
    inputs = cs.mega_inputs(dev, cfg, 32, seed=99)
    inputs[5].zero_()
    mega("decode_step_megakernel", packed, cfg, inputs, 131, 132)
    inputs = cs.mega_inputs(dev, cfg, 1, seed=99)
    inputs[5].zero_()
    mega("decode_step_megakernel_b1", packed, cfg, inputs, 131, 132)
    inputs, anc = cs.beam_trunk_inputs(dev, cfg, 96, 3, seed=97)
    mega("decode_step_megakernel_beam96", packed, cfg, inputs, 66, 68, beam_anc=anc)
    inputs, anc = cs.beam_trunk_inputs(dev, cfg, 160, 5, seed=96)
    mega("decode_step_megakernel_beam160", packed, cfg, inputs, 66, 68, beam_anc=anc)
    del packed, inputs
    cfg, packed = cs.random_trunk(dev, n_layer=24, seed=224, family="opt", D=cs.OPT_D,
                                  H=cs.OPT_H, xattn_every=2)
    mega("decode_step_megakernel_opt", packed, cfg,
         cs.mega_inputs(dev, cfg, cs.OPT_B, seed=98, T=cs.OPT_T), 70, 71)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2], sys.argv[3].split(","))))
        return 0
    a, b = (os.path.abspath(t) for t in sys.argv[1:3])
    groups = sys.argv[3:] or list(GROUPS)
    if set(groups) - set(GROUPS):
        print(f"ab_kernels: groups are {GROUPS}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = []
    turns = [(tree, ",".join(groups)) for tree in (a, b, b, a)]
    if "mega" in groups:
        turns += [(b, "mega"), (a, "mega")]
    for tree, named in turns:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree,
                              named], capture_output=True, text=True, check=True, cwd=tree)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(f"{card}: {runs[-1]}", flush=True)
    for tree in (a, b) if "mega" in groups else ():
        per = [(r.get("decode_step_megakernel_opt_ms"), r.get("decode_step_megakernel_opt_w8a8_ms"))
               for r in runs if r["tree"] == tree]
        print(f"{card}: {tree}: OPT-1.3B b=8 (weight-only, w8a8) ms by process: {per}",
              flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "ab_kernels.json"), "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
