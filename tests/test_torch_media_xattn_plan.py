"""The bf16 media xattn kernel's plan (``ops/media_xattn.plan``) and its
arithmetic, on the CPU (no card).

The plan is held at ``chip_smoke.MEDIA_SHAPES`` (the generate prefill, the
flamingo-mini forward, two images) and at OPT-1.3B's forward: shared memory
under the card's 227 KB a block, every (batch row, head, query row) owned
by exactly one warp of the grid (decoded as the kernel decodes
``blockIdx``), one wave on 132 SMs, the layouts ``profile_decode.py
media_plans`` measured, the cached plan returned on a repeated shape; and
at any number of keys, a slab of at most 16 tiles.

``_mirror`` repeats the kernel's walk and arithmetic in PyTorch under a
plan: each row's 16-key tiles from its ``text_time`` (its medium's, every
tile past the media count, none for 0); the block's windows of 64 tiles,
each starting at the least tile some row needs at or past the last one's
end; the block resident where its first window holds every need and their
union fits its slots, else streamed, each window's union in groups of
``slots`` tiles; a warp's scores over its own slice's tiles only (float32
min off a row's medium, -inf past ``n_kv``), the row max, exp, the sum in
chunks of 4 tiles and P = e x (1 / sum) before P V, rows with
``text_time`` 0 zeroed, P in two bf16 parts against bf16 V. It is held
against the plain version and against the JAX package's Pallas kernel in
interpret mode (``pallas_xattn.fused_media_xattn``, jitted once per
module), bf16 within 2 bf16 ulps of the output's scale and float32 within
1e-5 of it, under the mixes of ``text_time`` below at n_q 4, 5, 17 and 64,
where media straddle tiles (24 latents), where a slice needs more tiles
than one pass holds (12 media of 16 latents), and past the slots: 13 and
20 images of 64 latents (832 and 1,280 keys; 20 images take two windows).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flamingo_mini_tpu.ops.pallas_xattn import fused_media_xattn as j_media
from flamingo_mini_tpu_torch.ops import media_xattn as mx

H100_SMEM_BLOCK, H100_SMEM_SM, H100_SMS = 232448, 233472, 132
STATIC_SMEM = 1024           # the kernel's static arrays, with room to spare
HEADS = 8
# (b, n_q, n_media): chip_smoke's shapes and OPT-1.3B's forward (batch 8 x
# 64 tokens, one image; its xattn has 8 heads of 64, as flamingo-mini's)
SHAPES = dict(chip_smoke.MEDIA_SHAPES, **{"opt-1.3b forward": (8, 64, 1)})
N_VISUAL, SCALE = 64, 0.7
WINDOW, CHUNK = 64, 4
MIXES = ("tt 0", "each image", "past the media count", "slice spans two media",
         "slice all tt 0")


def _items(p: mx.Plan, b: int, h: int, n_q: int):
    """(batch row, head, first row, last row + 1, block) of every warp,
    rows past n_q included (first row >= n_q), as the kernel decodes
    blockIdx.x and its warp index."""
    n_groups = -(-(-(-n_q // 16)) // p.slices)
    for blk in range(p.blocks):
        sg, head, bb = blk % n_groups, blk // n_groups % h, blk // n_groups // h
        for warp in range(p.slices):
            row0 = (sg * p.slices + warp) * 16
            yield bb, head, row0, min(row0 + 16, n_q), blk


def _row_tiles(tt: int, n_kv: int, n_visual: int) -> range:
    n_tiles, n_media = -(-n_kv // 16), -(-n_kv // n_visual)
    if tt == 0:
        return range(0)
    if not 1 <= tt <= n_media:
        return range(n_tiles)
    k0, k1 = (tt - 1) * n_visual, min(tt * n_visual, n_kv)
    return range(k0 // 16, -(-k1 // 16))


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_fits_covers_and_fills_one_wave(shape):
    b, n_q, n_media = SHAPES[shape]
    n_kv = n_media * N_VISUAL
    p = mx.plan(b, HEADS, n_q, n_kv)
    assert p.smem == p.slots * mx.SLOT_BYTES <= H100_SMEM_BLOCK - STATIC_SMEM
    assert p.slots == -(-n_kv // 16) <= mx.MAX_SLOTS
    owners = {}
    for bb, head, r0, r1, _ in _items(p, b, HEADS, n_q):
        for r in range(r0, r1):
            owners[(bb, head, r)] = owners.get((bb, head, r), 0) + 1
    assert len(owners) == b * HEADS * n_q and set(owners.values()) == {1}
    # one wave: blocks an SM holds by shared memory (1 KB the card keeps a
    # block) and warps
    per_sm = min(32, 64 // p.slices, H100_SMEM_SM // (p.smem + STATIC_SMEM + 1024))
    assert p.blocks <= H100_SMS * per_sm
    # the model paths' shapes: the prefill one warp a block over 256 blocks
    # (2 an SM); the forwards two slices sharing a slab, 128 blocks
    assert (p.slices, p.blocks) == ((1, 256) if n_q == 4 else (2, 128))
    hits = mx.plan.cache_info().hits
    assert mx.plan(b, HEADS, n_q, n_kv) is p and mx.plan.cache_info().hits == hits + 1


@pytest.mark.parametrize("n_kv", [1, 64, 256, 257, 800, 832, 1024, 1025, 1280, 65536])
def test_plan_takes_any_number_of_keys(n_kv):
    """Past 256 keys the slab stays at 16 tiles (72 KB) and the kernel
    streams what a block needs beyond them: no call is refused for its
    keys."""
    for n_q in (4, 17, 64):
        p = mx.plan(2, HEADS, n_q, n_kv)
        assert p.slots == min(-(-n_kv // 16), mx.MAX_SLOTS)
        assert p.smem <= mx.MAX_SLOTS * mx.SLOT_BYTES == 73728


def _tt(mix: str, b: int, n_q: int, n_media: int) -> np.ndarray:
    r = np.arange(n_q)
    tt = np.ones((b, n_q), np.int32)
    if mix == "tt 0":
        tt[0] = 0
        tt[1, ::2] = 0
    elif mix == "each image":
        tt[:] = 1 + (np.arange(b)[:, None] + r) % n_media
    elif mix == "past the media count":
        tt[0] = n_media + 1
        tt[1, ::3], tt[1, 1::3] = n_media + 1, -1
    elif mix == "slice spans two media":
        tt[:] = 1 + ((r % 16) >= min(8, (n_q + 1) // 2))
    elif mix == "slice all tt 0":
        tt[:, :16] = 0
    return tt


def _walk(ranges, n_tiles: int, slots: int):
    """The kernel's walk for one block whose rows need the tile ranges
    ``ranges`` (one per warp: a list of its rows' ranges) -> (resident,
    [(window's first tile, [each warp's need], [groups of tiles])])."""
    windows, start = [], 0
    while True:
        if n_tiles > WINDOW:
            firsts = [max(r.start, start) for rs in ranges for r in rs if r.stop > start]
            if not firsts:
                break
            w0 = min(firsts)
        elif start > 0:
            break
        else:
            w0 = 0
        needs = [set().union(*(set(r) & set(range(w0, w0 + WINDOW)) for r in rs))
                 for rs in ranges]
        union = sorted(set().union(*needs))
        if not union:
            break
        more = any(r.stop > w0 + WINDOW for rs in ranges for r in rs)
        windows.append((w0, needs, union, more))
        start = w0 + WINDOW
    if not windows:
        return True, []
    w0, needs, union, more = windows[0]
    if not more and len(union) <= slots:
        return True, [(w0, needs, [union])]
    return False, [(w0, needs, [union[i:i + slots] for i in range(0, len(union), slots)])
                   for w0, needs, union, _ in windows]


def _mirror(q, k, v, tt, *, scale: float, n_visual: int, p: mx.Plan,
            walks: list = None) -> torch.Tensor:
    """The bf16 kernel's walk and arithmetic under the plan ``p`` (any dtype:
    bf16 takes P in two bf16 parts, float32 whole); ``walks`` collects each
    block's resident flag."""
    b, h, n_q, d = q.shape
    n_kv = k.shape[2]
    n_tiles = -(-n_kv // 16)
    tt = [[int(x) for x in row] for row in tt]
    out = torch.zeros((b, h, n_q, d), dtype=torch.float32)
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 16 * n_tiles - n_kv))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 16 * n_tiles - n_kv))
    blocks = {}
    for item in _items(p, b, h, n_q):
        blocks.setdefault(item[4], []).append(item[:4])
    for warps in blocks.values():
        ranges = [[_row_tiles(tt[bb][r], n_kv, n_visual) for r in range(r0, r1)]
                  for bb, _, r0, r1 in warps]
        resident, walk = _walk(ranges, n_tiles, p.slots)
        if walks is not None:
            walks.append(resident)
        for wi, (bb, head, r0, r1) in enumerate(warps):
            if r0 >= n_q:
                continue
            # the warp's chunks, in the kernel's order: window, group, 4 tiles
            chunks = []
            for w0, needs, groups in walk:
                for group in groups:
                    assert len(group) <= p.slots
                    mine = [t for t in group if t in needs[wi]]
                    chunks += [mine[i:i + CHUNK] for i in range(0, len(mine), CHUNK)]
            if not chunks:
                continue                   # zeros, no product
            need = [t for c in chunks for t in c]
            assert len(set(need)) == len(need) and set(need) == set().union(
                *(set(r) for r in ranges[wi]))
            keys = torch.tensor([16 * t + i for t in need for i in range(16)])
            s = torch.matmul(q[bb, head, r0:r1].float(), kf[bb, head, keys].T) * scale
            media = torch.div(keys, n_visual, rounding_mode="floor") + 1
            for i, r in enumerate(range(r0, r1)):
                s[i] = torch.where(keys >= n_kv, -torch.inf,
                                   torch.where(media == tt[bb][r], s[i], mx.NEG))
            m = torch.maximum(s.amax(dim=1, keepdim=True), torch.tensor(mx.NEG))
            e = torch.exp(s - m)
            bounds = np.cumsum([0] + [16 * len(c) for c in chunks])
            l = sum(e[:, j0:j1].sum(dim=1, keepdim=True)
                    for j0, j1 in zip(bounds[:-1], bounds[1:]))
            zero = torch.tensor([tt[bb][r] == 0 for r in range(r0, r1)])[:, None]
            pr = e * torch.where(zero, 0.0, 1.0 / l)
            vt = vf[bb, head, keys]
            if q.dtype == torch.bfloat16:
                hi = pr.to(torch.bfloat16).float()
                lo = (pr - hi).to(torch.bfloat16).float()
                out[bb, head, r0:r1] = hi @ vt + lo @ vt
            else:
                out[bb, head, r0:r1] = pr @ vt
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _jax_media():
    return jax.jit(functools.partial(j_media, scale=SCALE, n_visual=N_VISUAL,
                                     interpret=True))


def _inputs(rs, b, h, n_q, n_kv, dtype):
    q, k, v = (rs.randn(b, h, n, 64).astype(np.float32) for n in (n_q, n_kv, n_kv))
    return [torch.tensor(x).to(dtype) for x in (q, k, v)], (q, k, v)


def _held(got, want, dtype, label):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), label
    err = float((got - want).abs().max())
    tol = (1e-5 * float(want.abs().max()) if dtype == torch.float32
           else chip_smoke.bf16_ulps(want, 2))
    assert err <= tol, f"{label}: max err {err} > {tol}"


def _held_to_both(q, k, v, np_in, tt, n_media, dtype, label, **kw):
    """The mirror against the plain version and the JAX kernel, rows with
    text_time 0 exactly 0, rows past the media count the mean of V."""
    got = _mirror(q, k, v, tt, scale=SCALE, n_visual=N_VISUAL, **kw)
    plain = mx.fused_media_xattn_plain(q, k, v, torch.tensor(tt), scale=SCALE,
                                       n_visual=N_VISUAL)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in np_in)
    want = torch.tensor(np.asarray(_jax_media()(jq, jk, jv, jnp.asarray(tt))
                                   .astype(jnp.float32)))
    _held(got, plain, dtype, f"{label}: mirror vs plain")
    _held(got, want, dtype, f"{label}: mirror vs the JAX kernel")
    zero = torch.tensor(tt == 0)[:, None, :, None].expand_as(got)
    assert bool((got[zero] == 0).all()), label
    past = torch.tensor((tt > n_media) | (tt < 0))[:, None, :, None].expand_as(got)
    if bool(past.any()):
        mean_v = v.float().mean(dim=2, keepdim=True).expand_as(got)
        _held(got.float()[past], mean_v[past], dtype, f"{label}: rows past the media count")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_q", [4, 5, 17, 64])
def test_mirror_matches_plain_and_the_jax_kernel(n_q, dtype):
    b, h, n_media = 2, 2, 2
    n_kv = n_media * N_VISUAL
    rs = np.random.RandomState(n_q)
    (q, k, v), np_in = _inputs(rs, b, h, n_q, n_kv, dtype)
    p = mx.plan(b, h, n_q, n_kv)
    for mix in MIXES:
        _held_to_both(q, k, v, np_in, _tt(mix, b, n_q, n_media), n_media, dtype,
                      f"{mix}, n_q {n_q}", p=p)


@pytest.mark.parametrize("n_visual,n_media", [(24, 3), (16, 12)])
def test_mirror_where_media_straddle_tiles_or_outgrow_one_pass(n_visual, n_media):
    """24 latents: a tile holds keys of two media; 12 media of 16: a slice
    with a row past the media count needs 12 tiles, more than one pass's 4
    (the kernel's three passes over chunks)."""
    b, h, n_q = 2, 2, 40
    n_kv = n_visual * n_media
    rs = np.random.RandomState(n_kv)
    (q, k, v), _ = _inputs(rs, b, h, n_q, n_kv, torch.bfloat16)
    picked = mx.plan(b, h, n_q, n_kv)
    for p in (picked, *(mx.make_plan(b, h, n_q, n_kv, slices=slices) for slices in (1, 3))):
        for mix in MIXES:
            tt = _tt(mix, b, n_q, n_media)
            got = _mirror(q, k, v, tt, scale=SCALE, n_visual=n_visual, p=p)
            plain = mx.fused_media_xattn_plain(q, k, v, torch.tensor(tt), scale=SCALE,
                                               n_visual=n_visual)
            _held(got, plain, torch.bfloat16, f"{mix}, {n_media} media of {n_visual}, {p}")


@pytest.mark.parametrize("n_media", [13, 20])
def test_mirror_streams_past_the_slots(n_media):
    """13 images of 64 (52 tiles, one window) and 20 (80 tiles, two
    windows), n_q 40, every mix: a block whose rows attend one or two media
    stays resident (its union fits the 16 slots), one whose rows attend
    every medium, or lie past the media count, streams."""
    b, h, n_q = 2, 1, 40
    n_kv = n_media * N_VISUAL
    rs = np.random.RandomState(n_media)
    (q, k, v), np_in = _inputs(rs, b, h, n_q, n_kv, torch.bfloat16)
    p = mx.plan(b, h, n_q, n_kv)
    assert p.slots == mx.MAX_SLOTS
    for mix in MIXES + ("first and last",):
        tt = _tt(mix, b, n_q, n_media)
        if mix == "first and last":
            tt[:, n_q // 2:] = n_media
        walks = []
        _held_to_both(q, k, v, np_in, tt, n_media, torch.bfloat16,
                      f"{mix}, {n_media} images", p=p, walks=walks)
        streams = mix in ("each image", "past the media count") or (
            mix == "first and last" and n_media * 4 > WINDOW)
        assert (not all(walks)) == streams, (mix, walks)


def test_the_skip_halves_each_slice_at_two_images():
    """The two-image shape as chip_smoke.py times it (the first half of the
    rows after image 1, the second after image 2): each slice needs 4 of
    the 8 tiles; a slice of rows with text_time 0 needs none."""
    b, n_q, n_media = chip_smoke.MEDIA_SHAPES["two images"]
    n_kv = n_media * N_VISUAL
    tt = np.where(np.arange(n_q) < n_q // 2, 1, 2)
    for r0 in range(0, n_q, 16):
        need = set().union(*(set(_row_tiles(int(x), n_kv, N_VISUAL)) for x in tt[r0:r0 + 16]))
        assert len(need) == 4 and need == set(range(4 * (tt[r0] - 1), 4 * tt[r0]))
    assert not _row_tiles(0, n_kv, N_VISUAL)
