#!/usr/bin/env python3
"""Where the decode time goes on one CUDA card.

    python3 profile_decode.py [sweep] [paths] [opt] [fixed] [forward]
    python3 profile_decode.py levels | phases | attn_plans | media_plans | stream_plans

Four measurements of the PyTorch port at flamingo-mini width (GPT-2-medium
trunk with xattn before every layer, int8 weights, bf16; random weights from
chip_smoke.py's seeds), all of them unless some are named:

1. ``decode_step_megakernel`` alone, median of 30 calls with L2 flushed, over
   a sweep that isolates its parts: batch 1 vs 32 (the activation and
   attention work), kv_limit 36 vs 132 (the self-attention read), 12 vs 24
   layers (the per-layer cost), xattn every layer vs every other layer,
   and at the beam loop's last segment (kv_limit 68) 32 vs 96 rows and the
   beam mode at 96 rows (32 x 3 beams) and 160 rows (32 x 5); then the OPT
   mode at OPT-1.3B width (b=8, 24 layers, D=2048, xattn every other layer,
   the greedy loop's last segment: kv_limit 71); then the w8a8 mode
   (``act_quant``) at greedy b=32 and 1, beams at 96 and 160 rows and
   OPT-1.3B b=8; each beside its bound (``chip_smoke.mega_bound``) and its
   split by the kernel's section timer (``megadecode.SECTIONS``: each section's
   share of the blocks' clock cycles in one more call, times the call's
   median time: microseconds per layer, the grid barrier's wait included);
2. ``torch.profiler`` over one ``generate`` of each decode path, greedy and
   with 3 beams (batch 32, one image + 4-token prompt, 17 new tokens):
   device (kernel) time and its share of the wall window, the same share
   for the decode loop alone (the trace of a 1-token generate subtracted),
   kernel launches per decode step, and the device time by kernel;
   ``opt``: the same for chip_smoke.py's OPT-1.3B cell (batch 8, two rows
   left-padded, greedy per layer and on the megakernel);
3. ``fixed``: ``torch.profiler`` over each stage of a generate's fixed cost
   at batch 32 (ViT, resampler, xattn K/V, prefill with its first token),
   with the attention kernels off and on (``use_pallas``): device time,
   wall time, launches and the leading kernels of each stage;
4. ``forward``: the uncached forward with its loss under
   ``torch.inference_mode()`` (chip_smoke.py's batch of 8 x 64 tokens, rows
   0 and 1 left-padded by 8, bf16 weights, not quantized), flamingo-mini
   with use_pallas off and on and OPT-1.3B with it on: wall ms (median of
   5, host clock to a synchronize), then under ``torch.profiler`` device
   time and its share of the traced window, launches, the leading kernels,
   and the source lines at which the host waits on the card.

``fixed`` and ``forward`` also print the media xattn kernel's device time
by name (``media_kernel``: the Hopper kernel, or the mma.sync tile's kMedia
instantiation, which bf16 ran before it), so that one copy of this script
run in two checkouts compares them. ``media_plans``: ``fused_media_xattn``
(bf16) under every plan its kernel takes at chip_smoke.py's shapes, each
held to its plain version, beside the timer's floor; ``stream_plans`` the
same for the decode stream probes' kernel, bit for bit.

Prints one line per measurement and writes them all to
``chiprun_out/profile_decode.json``. Needs a card; exits 1 without one.
"""
import json
import os
import re
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "profile_decode.json")
PROFILE_NEW_TOKENS = 17
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchKernelExC")


def sections(fn, flush, ms: float, n_layer: int) -> dict:
    """One more call of ``fn`` with the kernel's section timer
    on -> {section: us per layer}: each section's share of all blocks'
    cycles times ``ms`` per layer."""
    from flamingo_mini_tpu_torch.ops import megadecode as md
    sms = torch.cuda.get_device_properties(flush.device).multi_processor_count
    timer = torch.zeros((sms, len(md.SECTIONS)), dtype=torch.int64, device=flush.device)
    flush.zero_()
    md.section_timer = timer
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        md.section_timer = None
    cycles = timer.double().sum(dim=0)
    share = (cycles / cycles.sum()).tolist()
    return {name: round(f * ms / n_layer * 1e3, 1) for name, f in zip(md.SECTIONS, share)}


def sweep(dev, card):
    import chip_smoke as cs
    from flamingo_mini_tpu_torch.ops.megadecode import decode_step_megakernel
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []
    # (trunk, rows, beams per family, layers, xattn_every, kv_limit); kb > 1
    # runs the beam mode over a random ancestry table; the four rows at
    # kv_limit 68 share the beam loop's last segment to split rows from
    # ancestry
    # the w8a8 mode (act_quant) at the main path's shapes follows the
    # weight-only rows
    opt = dict(family="opt", D=cs.OPT_D, H=cs.OPT_H)
    for trunk, b, kb, n_layer, every, kv_limit, act_quant in (
            ("gpt2", 32, 1, 24, 1, 132, False), ("gpt2", 1, 1, 24, 1, 132, False),
            ("gpt2", 32, 1, 24, 1, 36, False), ("gpt2", 32, 1, 12, 1, 132, False),
            ("gpt2", 32, 1, 24, 2, 132, False), ("gpt2", 1, 1, 24, 1, 36, False),
            ("gpt2", 32, 1, 24, 1, 68, False), ("gpt2", 96, 1, 24, 1, 68, False),
            ("gpt2", 96, 3, 24, 1, 68, False), ("gpt2", 160, 5, 24, 1, 68, False),
            ("opt-1.3b", cs.OPT_B, 1, 24, 2, 71, False),
            ("gpt2", 32, 1, 24, 1, 132, True), ("gpt2", 1, 1, 24, 1, 132, True),
            ("gpt2", 96, 3, 24, 1, 68, True), ("gpt2", 160, 5, 24, 1, 68, True),
            ("opt-1.3b", cs.OPT_B, 1, 24, 2, 71, True)):
        cfg, packed = cs.random_trunk(dev, n_layer=n_layer, xattn_every=every,
                                      seed=24, **(opt if trunk != "gpt2" else {}))
        anc = None
        if kb > 1:
            inputs, anc = cs.beam_trunk_inputs(dev, cfg, b, kb, seed=99)
        else:
            T = cs.OPT_T if trunk != "gpt2" else cs.MEGA_T
            inputs = cs.mega_inputs(dev, cfg, b, seed=99, T=T)
        xk, xv, kc, vc, x, npad, tt = inputs
        npad.zero_()
        tt.fill_(1)
        cur = kv_limit - 1

        def step():
            return decode_step_megakernel(packed, xk, xv, kc, vc, x, npad, tt, cur,
                                          config=cfg, kv_limit=kv_limit, beam_anc=anc,
                                          act_quant=act_quant)
        ms = cs.time_ms(step, 30, flush)
        split = sections(step, flush, ms, n_layer)
        # self K/V rows read: every row's own, or each distinct ancestor's
        n_pos = b * kv_limit
        slots, extra = n_pos, 0
        if anc is not None:
            slots, extra = cs.ancestor_reads(anc, npad, cur, kb)[0], 4 * n_pos
        bound_ms, bound_by, _, _ = cs.mega_bound(packed, cfg, inputs, slots, n_pos,
                                                 extra_bytes=extra, act_quant=act_quant)
        mode = "w8a8" if act_quant else "weight-only"
        row = dict(trunk=trunk, mode=mode, b=b, kb=kb, n_layer=n_layer, xattn_every=every,
                   kv_limit=kv_limit, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                   ms_per_layer=ms / n_layer, us_per_layer_by_section=split)
        print(f"[sweep] {card}: megakernel {mode} {trunk} b={b} kb={kb} layers={n_layer} "
              f"xattn_every={every} kv_limit={kv_limit}: {ms} ms per call "
              f"({ms / n_layer * 1e3:.1f} us per layer), bound {bound_ms:.4f} ms "
              f"({bound_by}); us per layer by section {split}")
        rows.append(row)
        del packed, inputs, xk, xv, kc, vc
        torch.cuda.empty_cache()
    return rows


PHASES = ("xq", "xattn", "xo", "xf1", "xf2", "qkv", "attention", "o", "fc", "pr")
LEVEL_PROCS = 4
# the buffers whose placement the levels sweep moves, each to this many
# fresh 2 MB segments
PLACED = ("amax", "parts", "sync", "scratch")
PLACEMENTS = 6


def direct_launch(packed, inputs, cfg, cur: int, kv_limit: int, act_quant: bool,
                  phases=None, beam_anc=None):
    """The megakernel on arguments built once (``megadecode.kernel_args``)
    -> a function that launches it: its time leaves out the wrapper's host
    steps, which ``time_ms``'s lead spin hides only up to about a
    millisecond. ``phases``: the phase timer the launches write."""
    import ctypes

    from flamingo_mini_tpu_torch.ops import megadecode as md
    md.phase_timer = phases
    try:
        args, x, keep = md.kernel_args(packed, *inputs, cur, config=cfg, kv_limit=kv_limit,
                                       beam_anc=beam_anc, act_quant=act_quant)
    finally:
        md.phase_timer = None
    lib = md._checked_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def launch():
        md.cuda_build.check(lib.fmt_decode_megakernel(ctypes.addressof(args), stream),
                            "decode_step_megakernel")
    launch.buffers = (args, x, keep)
    return launch


def phase_split(packed, inputs, cfg, cur: int, kv_limit: int, act_quant: bool,
                flush, beam_anc=None) -> dict:
    """One launch on the kernel's phase timer, timed by events (no host
    steps inside: ``direct_launch``) -> per phase kind, summed over the
    step's layers: the busiest block's work (the most cycles any block
    spent in the phase outside the barrier), split by section, and the mean
    barrier wait before the phase; all in us at the clock rate the launch's
    blocks measured (their total cycles over its event time)."""
    from flamingo_mini_tpu_torch.ops import megadecode as md
    dev = flush.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timer = torch.zeros((md.step_phases(packed), sms, len(md.SECTIONS)), dtype=torch.int64,
                        device=dev)
    launch = direct_launch(packed, inputs, cfg, cur, kv_limit, act_quant, phases=timer,
                           beam_anc=beam_anc)
    launch()
    flush.zero_()
    torch.cuda._sleep(1 << 20)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    launch()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    cum = timer.double().cpu()
    per = torch.diff(cum, dim=0, prepend=torch.zeros_like(cum[:1]))  # (phases, blocks, sections)
    mhz = float(cum[-1].sum(dim=1).median()) / ms / 1e3   # cycles per us
    bar = md.SECTIONS.index("barrier")
    work = per.sum(dim=2) - per[:, :, bar]
    busiest = work.argmax(dim=1)
    kinds = []
    for hx in packed["hasx"].tolist():
        kinds += list(PHASES if hx else PHASES[5:])
    out = {}
    for i, kind in enumerate(kinds):
        row = per[i, busiest[i]]
        d = out.setdefault(kind, {"busiest_us": 0.0, "mean_barrier_us": 0.0,
                                  **{k: 0.0 for k in md.SECTIONS if k != "barrier"}})
        d["busiest_us"] += float(work[i, busiest[i]]) / mhz
        d["mean_barrier_us"] += float(per[i, :, bar].mean()) / mhz
        for j, k in enumerate(md.SECTIONS):
            if k != "barrier":
                d[k] += float(row[j]) / mhz
    for d in out.values():
        for k in d:
            d[k] = round(d[k], 1)
    return dict(ms=ms, clock_mhz=round(mhz, 1),
                busiest_sum_us=round(sum(d["busiest_us"] for d in out.values()), 1),
                phases=out)


def levels_one(dev, card) -> dict:
    """One process's share of ``levels``: OPT-1.3B at b=8 (24 layers,
    xattn every other layer, kv_limit 71), both modes: the median time of
    the wrapper's calls and of launches on arguments built once
    (``direct_launch``), the wrapper's host us per call, the phase split of
    one more launch; then the w8a8 mode's launches with each buffer of
    ``PLACED`` moved in turn to the start of ``PLACEMENTS`` fresh 2 MB
    segments (its address printed beside each time)."""
    import chip_smoke as cs
    from flamingo_mini_tpu_torch.ops import megadecode as md
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    cfg, packed = cs.random_trunk(dev, n_layer=24, seed=224, family="opt", D=cs.OPT_D,
                                  H=cs.OPT_H, xattn_every=2)
    inputs = cs.mega_inputs(dev, cfg, cs.OPT_B, seed=98, T=cs.OPT_T)
    out = {}
    for act_quant in (False, True):
        def step():
            return md.decode_step_megakernel(packed, *inputs, 70, config=cfg, kv_limit=71,
                                             act_quant=act_quant)
        mode = "w8a8" if act_quant else "weight_only"
        out[mode + "_ms"] = cs.time_ms(step, 30, flush)
        out[mode + "_host_us"] = cs.host_us(step)
        out[mode + "_direct_ms"] = cs.time_ms(
            direct_launch(packed, inputs, cfg, 70, 71, act_quant), 30, flush)
        out[mode + "_split"] = phase_split(packed, inputs, cfg, 70, 71, act_quant, flush)
    launch = direct_launch(packed, inputs, cfg, 70, 71, True)
    args, _x, keep = launch.buffers
    sizes = {"amax": keep[1].numel() * 4, "parts": keep[2].numel() * 4,
             "sync": keep[3].numel() * 4, "scratch": keep[0].numel() * 2}
    default = {n: getattr(args, n) for n in PLACED}
    out["default_addresses"] = {n: hex(v) for n, v in default.items()}
    sweep_rows, segments = [], []
    for name in PLACED:
        for _ in range(PLACEMENTS):
            seg = torch.zeros(max(sizes[name], 2 << 20), dtype=torch.uint8, device=dev)
            segments.append(seg)   # a fresh segment for every placement
            setattr(args, name, seg.data_ptr())
            sweep_rows.append(dict(buffer=name, address=hex(seg.data_ptr()),
                                   ms=cs.time_ms(launch, 10, flush)))
            setattr(args, name, default[name])
    out["placements"] = sweep_rows
    return out


def phases(dev, card):
    """The kernel's phase split (``phase_split``) in both modes at
    ab_kernels.py's megakernel cases: flamingo-mini greedy b=32 and b=1
    (kv_limit 132), beams at 96 and 160 rows (kv_limit 68), OPT-1.3B b=8
    (kv_limit 71); per case and mode the launch's time and, summed over the
    phase kinds, the busiest blocks' work by section."""
    import chip_smoke as cs
    from flamingo_mini_tpu_torch.ops import megadecode as md
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    rows = []
    opt = dict(family="opt", D=cs.OPT_D, H=cs.OPT_H)
    for case, trunk, b, kb, every, kv_limit in (
            ("greedy b=32", "gpt2", 32, 1, 1, 132), ("b=1", "gpt2", 1, 1, 1, 132),
            ("beams 96 rows", "gpt2", 96, 3, 1, 68), ("beams 160 rows", "gpt2", 160, 5, 1, 68),
            ("OPT-1.3B b=8", "opt", cs.OPT_B, 1, 2, 71)):
        cfg, packed = cs.random_trunk(dev, n_layer=24, xattn_every=every, seed=24,
                                      **(opt if trunk == "opt" else {}))
        anc = None
        if kb > 1:
            inputs, anc = cs.beam_trunk_inputs(dev, cfg, b, kb, seed=99)
        else:
            inputs = cs.mega_inputs(dev, cfg, b, seed=99,
                                    T=cs.OPT_T if trunk == "opt" else cs.MEGA_T)
        for act_quant in (False, True):
            mode = "w8a8" if act_quant else "weight-only"
            ms = cs.time_ms(direct_launch(packed, inputs, cfg, kv_limit - 1, kv_limit,
                                          act_quant, beam_anc=anc), 20, flush)
            split = phase_split(packed, inputs, cfg, kv_limit - 1, kv_limit, act_quant, flush,
                                beam_anc=anc)
            row = dict(case=case, mode=mode, ms=ms, split=split)
            rows.append(row)
            by_section = {}
            for d in split["phases"].values():
                for k, v in d.items():
                    by_section[k] = round(by_section.get(k, 0.0) + v, 1)
            print(f"[phases] {card}: {case} {mode}: {ms:.4f} ms; busiest blocks "
                  f"{split['busiest_sum_us']} us at {split['clock_mhz']} MHz, by phase "
                  f"{ {k: d['busiest_us'] for k, d in split['phases'].items()} }, "
                  f"by section {by_section}", flush=True)
        del packed, inputs
        torch.cuda.empty_cache()
    return rows


def attn_plans(dev, card):
    """``decode_attention`` and ``decode_attention_beam`` (bf16, L2 flushed,
    ``chip_smoke.time_ms``) at chip_smoke.py's phase 2 shapes and three
    more, under every plan of 1, 2 or 4 heads a block and 1-16 splits that
    the kernel takes and the one ``plan()`` picks, each held to its plain
    version: flamingo-mini greedy
    (b=32, kv_limit 132, cur 131), OPT-1.3B (b=8, D=2048, kv_limit 71, cur
    70), beams at 96 rows (32 x 3) and 160 rows (32 x 5; kv_limit 68, cur
    66), then greedy b=1, beams at 3 rows and b=8 over 1,000 slots. Prints
    the timer's floor, each shape's times by plan, fastest first, the plan
    ``plan()`` picks, and those two with L2 clean."""
    import chip_smoke as cs
    from flamingo_mini_tpu_torch.ops import decode_attention as da
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    one = torch.zeros(1, device=dev)
    floor = cs.time_ms(lambda: one.add_(1), 30, flush)
    print(f"[attn_plans] {card}: the timer's floor (one 1-element add): {floor:.4f} ms")
    rows = [dict(case="timer floor", ms=floor)]
    for case, (b, D, T, kb, kv_limit, cur) in {
            "greedy b=32": (32, 1024, 192, 1, 132, 131),
            "OPT-1.3B b=8": (cs.OPT_B, cs.OPT_D, cs.OPT_T, 1, 71, 70),
            "beams 96 rows": (96, 1024, cs.BEAM_T, 3, 68, 66),
            "beams 160 rows": (160, 1024, cs.BEAM_T, 5, 68, 66),
            "greedy b=1": (1, 1024, 192, 1, 132, 131),
            "beams 3 rows": (3, 1024, cs.BEAM_T, 3, 68, 66),
            "greedy b=8, kv_limit 1000": (8, 1024, 1024, 1, 1000, 999)}.items():
        H = D // da.HEAD_DIM
        rs = np.random.RandomState(b)
        q, k, v = (torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32, device=dev)
                   .to(torch.bfloat16) for s in ((b, D), (T, b, D), (T, b, D)))
        kw = dict(n_head=H, scale=0.125, kv_limit=kv_limit)
        anc = None
        if kb > 1:
            anc = cs.random_ancestry(dev, b // kb, kb, seed=3)
            npad = cs.family_npad(dev, b // kb, kb)
            want = da.decode_attention_beam_plain(q, k, v, anc, npad, cur, kb=kb, **kw)
        else:
            npad = torch.tensor(np.arange(b) % 4, dtype=torch.int32, device=dev)
            want = da.decode_attention_plain(q, k, v, npad, cur, **kw)
        tol = cs.bf16_ulps(want.float(), 2)
        picked = da.plan(b, H, kv_limit, 2, kb=kb, beam=kb > 1)
        grid = {da.make_plan(b, H, kv_limit, 2, kb=kb, beam=kb > 1, heads=heads,
                             splits=splits)
                for heads in (1, 2, 4) for splits in (1, 2, 3, 4, 6, 8, 12, 16)}
        def run(p):
            return da._launch(q, k, v, npad, anc, cur, n_head=H, scale=0.125, kb=kb,
                              t_lim=kv_limit, p=p)
        times = []
        for p in sorted(p for p in grid | {picked} if p.smem <= da.SMEM_LIMIT):
            err = float((run(p).float() - want.float()).abs().max())
            assert err <= tol, (case, p, err, tol)
            times.append((cs.time_ms(lambda: run(p), 30, flush), p))
        times.sort(key=lambda x: x[0])
        for label, p in (("fastest", times[0][1]), ("picked", picked)):
            print(f"[attn_plans]   {label} {tuple(p)} with L2 clean: "
                  f"{cs.time_ms(lambda: run(p), 30, flush, clean=True):.4f} ms",
                  flush=True)
        row = dict(case=case, picked=picked._asdict(),
                   picked_ms=next(ms for ms, p in times if p == picked),
                   plans=[dict(ms=ms, **p._asdict()) for ms, p in times])
        rows.append(row)
        print(f"[attn_plans] {card}: {case}: plan() picks {tuple(picked)} "
              f"({row['picked_ms']} ms); fastest first:", flush=True)
        for ms, p in times[:12]:
            print(f"[attn_plans]   {ms:.4f} ms  heads {p.heads} splits {p.splits} "
                  f"positions {p.positions} warps {p.warps} smem {p.smem} "
                  f"blocks {p.blocks}", flush=True)
    return rows


def media_plans(dev, card):
    """``fused_media_xattn`` (bf16, L2 flushed, ``chip_smoke.time_ms``) at
    chip_smoke.py's MEDIA_SHAPES and four more (32 x 64 tokens over one
    image, 8 x 256 over two, 8 x 40 over 13 and over 20 images: past the
    kernel's 16 slots) under every plan of 1, 2, 4 and 8 slices a block that
    the rows fill, text_time 1 then the last image by half, each held to
    its plain version. Prints the timer's floor, each shape's times by
    plan, fastest first, the plan ``plan()`` picks, those two with L2
    clean, and SDPA under the media mask."""
    import chip_smoke as cs
    from flamingo_mini_tpu_torch.ops import media_xattn as mx
    from flamingo_mini_tpu_torch.ops.fused_attention import launch
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    one = torch.zeros(1, device=dev)
    floor = cs.time_ms(lambda: one.add_(1), 30, flush)
    print(f"[media_plans] {card}: the timer's floor (one 1-element add): {floor:.4f} ms")
    rows = [dict(case="timer floor", ms=floor)]
    shapes = dict(cs.MEDIA_SHAPES, **{"forward b=32": (32, 64, 1),
                                      "two images, 256 tokens": (8, 256, 2),
                                      "13 images, 40 tokens": (8, 40, 13),
                                      "20 images, 40 tokens": (8, 40, 20)})
    for case, (b, n_q, n_media) in shapes.items():
        n_kv = 64 * n_media
        q, k, v = cs.attention_inputs(dev, torch.bfloat16, b, 8, n_q, n_kv, 2)
        tt = torch.ones((b, n_q), dtype=torch.int32, device=dev)
        tt[:, n_q // 2:] = n_media
        want = mx.fused_media_xattn_plain(q, k, v, tt, scale=1.0, n_visual=64)
        tol = cs.bf16_ulps(want.float(), 2)
        picked = mx.plan(b, 8, n_q, n_kv)
        grid = [mx.make_plan(b, 8, n_q, n_kv, slices=slices) for slices in (1, 2, 4, 8)
                if slices <= -(-n_q // 16)]

        def run(p):
            return launch("fmt_media_xattn", q, k, v, scale=1.0, text_time=tt,
                          n_visual=64, plan=(p.slices,))
        times = []
        for p in grid:
            err = float((run(p).float() - want.float()).abs().max())
            assert err <= tol, (case, p, err, tol)
            times.append((cs.time_ms(lambda: run(p), 50, flush), p))
        times.sort(key=lambda x: x[0])
        for label, p in (("fastest", times[0][1]), ("picked", picked)):
            print(f"[media_plans]   {label} {tuple(p)} with L2 clean: "
                  f"{cs.time_ms(lambda: run(p), 50, flush, clean=True):.4f} ms",
                  flush=True)
        media_time = torch.arange(n_kv, device=dev) // 64 + 1
        mask = (tt[:, :, None] == media_time)[:, None]
        sdpa_ms = cs.time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0), 50, flush)
        row = dict(case=case, picked=picked._asdict(),
                   picked_ms=next(ms for ms, p in times if p == picked), sdpa_ms=sdpa_ms,
                   plans=[dict(ms=ms, **p._asdict()) for ms, p in times])
        rows.append(row)
        print(f"[media_plans] {card}: {case} {(b, 8, n_q, n_kv)}: plan() picks "
              f"{tuple(picked)} ({row['picked_ms']} ms), SDPA under the media mask "
              f"{sdpa_ms} ms; fastest first:", flush=True)
        for ms, p in times:
            print(f"[media_plans]   {ms:.4f} ms  slices {p.slices} slots {p.slots} "
                  f"smem {p.smem} blocks {p.blocks}", flush=True)
    return rows


def stream_plans(dev, card):
    """The decode stream probes' kernel (``csrc/decode_stream_probe.cu``)
    under plans of 8 to 128 vectors a block and at most 128 to 512 threads
    (``probe_decode_kernel.make_plan``), each held bit for bit to its plain
    version, at each layout's timed block_t (kv_limit 128 at b=32, D=1024,
    T=192), at OPT-1.3B's width (T-major, b=8, D=2048) and over a long cache
    (T-major, T=1,024, kv_limit 1,000): L2 flushed, ``chip_smoke.time_ms``,
    fastest first, beside the timer's floor and the plan ``plan()`` picks;
    then the rule's plan over 8 to 192 rows, L2 flushed and clean."""
    import chip_smoke as cs
    from flamingo_mini_tpu_torch.tools import probe_decode_kernel as pdk
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    one = torch.zeros(1, device=dev)
    floor = cs.time_ms(lambda: one.add_(1), 30, flush)
    print(f"[stream_plans] {card}: the timer's floor (one 1-element add): {floor:.4f} ms")
    rows = [dict(case="timer floor", ms=floor)]
    cases = (("bmajor", 32, 128, 32, 192, 1024), ("tmajor", 32, 128, 32, 192, 1024),
             ("packed", 16, 128, 32, 192, 1024), ("tmajor", 32, 128, 8, 192, 2048),
             ("tmajor", 32, 1000, 32, 1024, 1024))
    for layout, block_t, kv_limit, b, T, D in cases:
        q, caches = cs.stream_probe_inputs(dev, layout, 7, b, T, D)
        want = cs.stream_probe_call(layout, q, caches, block_t, None, kv_limit, plain=True)
        n_rows = pdk.chunk_rows(kv_limit, block_t, T)
        picked = pdk.plan(b, D, n_rows, block_t)
        grid = {pdk.make_plan(b, D, n_rows, block_t, width=w, max_threads=m)
                for w in (8, 16, 32, 64, 128) for m in (128, 256, 512) if w <= m}
        fn = {"tmajor": pdk.tmajor_stream, "packed": pdk.packed_stream}.get(layout)

        def run(p):
            if fn is None:
                return pdk.attn_stream_only(q, *caches, None, None, None, block_t,
                                            shape=pdk.Shape(kv_limit=kv_limit), plan=p)
            return fn(q, *caches, block_t=block_t, kv_limit=kv_limit, plan=p)
        times = []
        for p in sorted(grid):
            assert torch.equal(run(p).view(torch.int16), want.view(torch.int16)), (layout, p)
            times.append((cs.time_ms(lambda: run(p), 50, flush), p))
        times.sort(key=lambda x: x[0])
        case = f"{layout} block_t {block_t} kv_limit {kv_limit} (b, T, D) {(b, T, D)}"
        row = dict(case=case, picked=picked._asdict(),
                   picked_ms=next(ms for ms, p in times if p == picked),
                   picked_clean_ms=cs.time_ms(lambda: run(picked), 50, flush, clean=True),
                   plans=[dict(ms=ms, **p._asdict()) for ms, p in times])
        rows.append(row)
        print(f"[stream_plans] {card}: {case}: plan() picks {tuple(picked)} "
              f"({row['picked_ms']} ms, {row['picked_clean_ms']} ms with L2 clean); "
              "fastest first:", flush=True)
        for ms, p in times:
            print(f"[stream_plans]   {ms:.4f} ms  width {p.width} window {p.window} "
                  f"threads {p.threads} blocks {p.blocks} windows {p.windows}", flush=True)
        del q, caches
    # where a call's time goes: the T-major kernel over 8 to 192 rows
    # (block_t 32; 8 and 24 rows in one chunk of their own), L2 flushed and
    # clean; the floor is the launch, the slope over rows the read
    q, caches = cs.stream_probe_inputs(dev, "tmajor", 8)
    for kv_limit, block_t in ((8, 8), (24, 24), (32, 32), (64, 32), (96, 32), (128, 32),
                              (160, 32), (192, 32)):
        def fn():
            return pdk.tmajor_stream(q, *caches, block_t=block_t, kv_limit=kv_limit)
        n_bytes = 2 * kv_limit * q.numel() * 2
        row = dict(case=f"rows {kv_limit}", n_bytes=n_bytes, ms=cs.time_ms(fn, 50, flush),
                   clean_ms=cs.time_ms(fn, 50, flush, clean=True))
        rows.append(row)
        print(f"[stream_plans] {card}: T-major, {kv_limit} rows (block_t {block_t}, "
              f"{n_bytes} bytes): {row['ms']:.5f} ms, {row['clean_ms']:.5f} ms with L2 "
              "clean", flush=True)
    return rows


def levels(dev, card):
    """Whether the w8a8 mode's OPT-1.3B time takes a level per process, and
    what sets it: ``levels_one`` in ``LEVEL_PROCS`` fresh processes, one
    after another."""
    import subprocess
    runs = []
    for i in range(LEVEL_PROCS):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--levels-one"],
                              capture_output=True, text=True, cwd=REPO, timeout=600)
        if done.returncode != 0:
            raise RuntimeError(f"levels process {i}: {done.stderr[-3000:]}")
        run = json.loads(done.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(f"[levels] {card}: process {i}: the wrapper's calls: weight-only "
              f"{run['weight_only_ms']:.4f} ms ({run['weight_only_host_us']:.0f} us of host "
              f"time a call), w8a8 {run['w8a8_ms']:.4f} ms ({run['w8a8_host_us']:.0f} us); "
              f"launches on arguments built once: weight-only "
              f"{run['weight_only_direct_ms']:.4f} ms, w8a8 {run['w8a8_direct_ms']:.4f} ms",
              flush=True)
        for mode in ("weight_only", "w8a8"):
            sp = run[mode + "_split"]
            print(f"[levels]   {mode} phase split: busiest blocks' sum "
                  f"{sp['busiest_sum_us']} us of {sp['ms']:.4f} ms at {sp['clock_mhz']} MHz",
                  flush=True)
        for kind, d in run["w8a8_split"]["phases"].items():
            print(f"[levels]   {kind}: w8a8 {d} | weight-only "
                  f"{run['weight_only_split']['phases'][kind]}", flush=True)
        by = {}
        for r in run["placements"]:
            by.setdefault(r["buffer"], []).append(f"{r['address']} {r['ms']:.4f}")
        for name, items in by.items():
            print(f"[levels]   w8a8 with {name} moved: {'; '.join(items)}", flush=True)
    return runs


def mini_model(dev):
    """chip_smoke.py's flamingo-mini (gates open, int8 trunk and xattn,
    bf16) and a batch of 32 prompts with one image each."""
    import chip_smoke as cs
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    config = FlamingoConfig(**cs.MINI)
    model = FlamingoModel(config, device=dev, seed=0)
    for blk in model.params["xattn"].values():
        blk["alpha_attn"].fill_(0.5)
        blk["alpha_ffw"].fill_(0.5)
    model.quantize_int8().to_bf16()
    gen = torch.Generator(device=dev).manual_seed(0)
    b, L = cs.BATCH, cs.PROMPT_LEN
    ids = torch.randint(0, 1000, (b, L), generator=gen, device=dev)
    media = torch.zeros((b, L), dtype=torch.int32, device=dev)
    media[:, 0] = 1
    size = config.vision_arch.image_size
    pixels = torch.randn((b, 1, 3, size, size), generator=gen,
                         device=dev).to(torch.bfloat16)
    return config, model, ids, media, pixels


def traced_device(fn):
    """(wall ms, device ms, launches, kernel events) of ``fn`` under
    torch.profiler, ending in a synchronize."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS)
    return window_ms, device_ms, launches, kernels


def media_kernel(kernels) -> dict:
    """The media xattn kernel's device ms and calls in a trace, by name: the
    Hopper kernel (``media_xattn_sm90_kernel``) or the mma.sync tile in its
    kMedia mode for bf16 (``attention_kernel<__nv_bfloat16, 2>``)."""
    hits = [e for e in kernels if "media_xattn" in e.key
            or re.search(r"attention_kernel<__nv_bfloat16, *(\(int\))?2>", e.key)]
    return dict(ms=sum(e.self_device_time_total for e in hits) / 1e3,
                count=sum(e.count for e in hits), names=sorted({e.key for e in hits}))


def top_kernels(kernels, n=10):
    return [dict(name=k, ms=ms, count=c) for k, ms, c in sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in kernels),
        key=lambda r: -r[1])[:n]]


def fixed_cost(dev, card):
    """Each stage of a generate's fixed cost, use_pallas off and on."""
    from flamingo_mini_tpu_torch import generation
    from flamingo_mini_tpu_torch.models import clip_vit
    from flamingo_mini_tpu_torch.models import flamingo as F
    from flamingo_mini_tpu_torch.models.resampler import apply_resampler
    from flamingo_mini_tpu_torch.ops.layers import policy_for
    config, model, ids, media, pixels = mini_model(dev)
    p, b = model.params, ids.shape[0]
    mask = torch.ones_like(media)
    dc = generation.DecodeConfig(max_length=ids.shape[1] + 1)
    rows = []
    with torch.inference_mode():
        for use_pallas in (False, True):
            pol = policy_for("bfloat16", use_pallas)
            feats = clip_vit.apply_clip_vit(p["vision"], pixels[:, 0], arch=config.vision_arch,
                                            policy=pol)
            vf = F.encode_resample_visuals(p, config, pixels, policy=pol)
            stages = (
                ("vit", lambda: clip_vit.apply_clip_vit(
                    p["vision"], pixels[:, 0], arch=config.vision_arch, policy=pol)),
                ("resampler", lambda: apply_resampler(
                    p["resampler"], feats[:, None], heads=config.resampler_heads,
                    dim_head=config.resampler_dim_head, act=config.resampler_act,
                    policy=pol)),
                ("xattn K/V", lambda: F.compute_xattn_kv(p, config, vf, policy=pol)),
                ("prefill (xattn K/V included)", lambda: generation._prefill(
                    p, config, dc, pol, ids, media, mask, vf)))
            for stage, fn in stages:
                fn()                                          # warm-up
                torch.cuda.synchronize()
                window_ms, device_ms, launches, kernels = traced_device(fn)
                row = dict(use_pallas=use_pallas, stage=stage, batch=b,
                           window_ms=window_ms, device_ms=device_ms,
                           launches=launches, by_kernel=top_kernels(kernels, 6),
                           media=media_kernel(kernels))
                print(f"[fixed] {card}: use_pallas={use_pallas} {stage}, batch {b}: "
                      f"window {window_ms:.2f} ms, device {device_ms:.2f} ms, "
                      f"{launches} launches; media xattn kernel {row['media']['ms']:.4f} "
                      f"ms in {row['media']['count']} calls")
                for r in row["by_kernel"]:
                    print(f"[fixed]   {r['ms']:9.3f} ms  x{r['count']:<6} {r['name'][:90]}")
                rows.append(row)
    return rows


def sync_sites(fn):
    """The source lines at which ``fn`` makes the host wait on the card
    (``torch.cuda.set_sync_debug_mode``'s warnings) -> {"file:line": count}."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            where = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
            sites[where] = sites.get(where, 0) + 1
    return sites


def profile_forward(dev, card):
    """The uncached forward with its loss: flamingo-mini with use_pallas off
    and on, OPT-1.3B with use_pallas on (chip_smoke.py's forward cells)."""
    import chip_smoke as cs
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    b, n, pad = cs.FWD_B, cs.FWD_N, cs.GPT2_PAD
    rows = []
    for label, kw, seed, settings in (("flamingo-mini", cs.MINI, 0, (False, True)),
                                      ("OPT-1.3B", cs.OPT13, 1, (True,))):
        model = FlamingoModel(FlamingoConfig(**kw), device=dev, seed=seed)
        for blk in model.params["xattn"].values():
            blk["alpha_attn"].fill_(0.5)
            blk["alpha_ffw"].fill_(0.5)
        model.to_bf16()
        gen = torch.Generator(device=dev).manual_seed(1)
        ids = torch.randint(4, 1000, (b, n), generator=gen, device=dev)
        mask = torch.ones((b, n), dtype=torch.int32, device=dev)
        ids[:2, :pad], mask[:2, :pad] = 0, 0
        media = torch.zeros((b, n), dtype=torch.int32, device=dev)
        media[:2, pad], media[2:, 0] = 1, 1
        size = model.config.vision_arch.image_size
        pixels = torch.randn((b, 1, 3, size, size), generator=gen,
                             device=dev).to(torch.bfloat16)
        with torch.inference_mode():
            for use_pallas in settings:
                m = FlamingoModel(FlamingoConfig(**kw, use_pallas=use_pallas),
                                  params=model.params, device=dev)

                def fwd():
                    return m(ids, media_locations=media, attention_mask=mask,
                             pixel_values=pixels, labels=ids)
                fwd()                                             # warm-up
                torch.cuda.synchronize()
                walls = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    fwd()
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                sites = sync_sites(fwd)
                torch.cuda.synchronize()
                window_ms, device_ms, launches, kernels = traced_device(fwd)
                row = dict(model=label, use_pallas=use_pallas, batch=b, tokens=n,
                           wall_ms=sorted(walls)[2], walls=walls, window_ms=window_ms,
                           device_ms=device_ms, busy=device_ms / window_ms,
                           launches=launches, sync_sites=sites,
                           by_kernel=top_kernels(kernels, 8), media=media_kernel(kernels))
                print(f"[forward] {card}: {label}, use_pallas={use_pallas}, {b}x{n} "
                      f"tokens: wall median {row['wall_ms']:.2f} ms (runs "
                      f"{[round(w, 2) for w in walls]}); traced window {window_ms:.2f} ms, "
                      f"device {device_ms:.2f} ms (busy {100 * row['busy']:.1f} %), "
                      f"{launches} launches; the host waits on the card at {sites}; "
                      f"media xattn kernel {row['media']['ms']:.4f} ms in "
                      f"{row['media']['count']} calls")
                for r in row["by_kernel"]:
                    print(f"[forward]   {r['ms']:9.3f} ms  x{r['count']:<6} {r['name'][:90]}")
                rows.append(row)
        del model, m
        torch.cuda.empty_cache()
    return rows


def profile_paths(dev, card, opt=False):
    """Each decode path of flamingo-mini, or with ``opt`` of OPT-1.3B."""
    import chip_smoke as cs
    if opt:
        model = cs.opt_model(dev)
        config = model.config
        ids, media, mask, pixels = cs.trunk_batch(dev, np.random.RandomState(1), config)
        paths = ((False, 1, "OPT-1.3B per-layer"), (True, 1, "OPT-1.3B megakernel"))
    else:
        config, model, ids, media, pixels = mini_model(dev)
        mask = None
        paths = ((False, 1, "per-layer"), (True, 1, "megakernel"),
                 (False, cs.BEAMS, "beam per-layer"), (True, cs.BEAMS, "beam megakernel"))
    b, L = ids.shape

    def run(megakernel, beams, new_tokens):
        return model.generate(ids, media_locations=media, attention_mask=mask,
                              pixel_values=pixels,
                              max_length=L + new_tokens, max_new_tokens=new_tokens,
                              prefix_block=cs.PREFIX_BLOCK,
                              eos_token_id=config.lm_arch.vocab_size + 1,
                              pad_token_id=0, megakernel=megakernel,
                              num_beams=beams)

    def traced(megakernel, beams, new_tokens):
        """(wall ms, device ms, launches, kernel events) of one generate."""
        return traced_device(lambda: run(megakernel, beams, new_tokens))

    rows = []
    steps = PROFILE_NEW_TOKENS - 1
    for megakernel, beams, label in paths:
        run(megakernel, beams, PROFILE_NEW_TOKENS)           # warm-up
        torch.cuda.synchronize()
        window_ms, device_ms, launches, kernels = traced(megakernel, beams,
                                                         PROFILE_NEW_TOKENS)
        # the same generate with 1 new token: vision, resampler, prefill and
        # the first token, to take out of the decode loop's share
        window_1, device_1, launches_1, _ = traced(megakernel, beams, 1)
        row = dict(path=label, num_beams=beams, new_tokens=PROFILE_NEW_TOKENS,
                   window_ms=window_ms,
                   device_ms=device_ms, busy=device_ms / window_ms,
                   decode_busy=(device_ms - device_1) / (window_ms - window_1),
                   launches=launches,
                   launches_per_step=(launches - launches_1) / steps,
                   by_kernel=top_kernels(kernels))
        print(f"[profile] {card}: {label} path, generate of {PROFILE_NEW_TOKENS} "
              f"tokens: window {window_ms:.1f} ms, device {device_ms:.1f} ms "
              f"(busy {100 * row['busy']:.1f} %); decode loop busy "
              f"{100 * row['decode_busy']:.1f} %, "
              f"{row['launches_per_step']:.1f} launches per decode step")
        for r in row["by_kernel"]:
            print(f"[profile]   {r['ms']:9.3f} ms  x{r['count']:<6} {r['name'][:90]}")
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from flamingo_mini_tpu_torch.ops import cuda_build
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    if sys.argv[1:] == ["--levels-one"]:
        print(json.dumps(levels_one(dev, card)))
        return 0
    print(card)
    cuda_build.kernels()
    sections = {"sweep": sweep, "paths": profile_paths,
                "opt": lambda dev, card: profile_paths(dev, card, opt=True),
                "fixed": fixed_cost, "forward": profile_forward, "levels": levels,
                "phases": phases, "attn_plans": attn_plans, "media_plans": media_plans,
                "stream_plans": stream_plans}
    names = sys.argv[1:] or [n for n in sections
                             if n not in ("levels", "phases", "attn_plans", "media_plans",
                                          "stream_plans")]
    unknown = set(names) - set(sections)
    if unknown:
        print(f"profile_decode: unknown sections {sorted(unknown)}; choose from "
              f"{list(sections)}", file=sys.stderr)
        return 2
    result = {"card": card}
    for name in names:
        result[name] = sections[name](dev, card)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {os.path.relpath(OUT, REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
