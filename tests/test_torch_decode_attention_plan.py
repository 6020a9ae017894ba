"""The decode attention kernels' plan (``ops/decode_attention.plan``) and
their split arithmetic, on the CPU (no JAX, no card).

The plan is held at the main path's shapes: flamingo-mini greedy (b=32,
16 heads, every live prefix of a 192-slot cache), OPT-1.3B (b=8, 32 heads),
OPT-2.7B and OPT-6.7B (b=8, 32 heads 80 and 128 wide; their 3 beams at 24
rows), beams at 96 rows in families of 3 and 160 in families of 5 (a 128-slot
cache), and a long prefix (b=8, 1,000 slots): shared memory under the
card's 227 KB, splits that tile the live prefix with no gap or overlap,
the warp count the kernel's loads need, the first plan by ``rank`` (a
grid the card holds in one wave with a block for every SM, unsplit where
that fits), two waves' worth of blocks (2 x 132) wherever the rows allow it
(an unsplit grid of that many blocks in one wave), and the cached plan
returned on a repeated shape.

``_split_mirror`` repeats the kernels' arithmetic in PyTorch on a plan's
splits: each split's scores against its own max, its probabilities rounded
to the cache dtype, a split with no valid slot left at (float32 min, 0),
a row with none uniform over its family's entries, the partials folded in
split order. It is held against the plain versions (the CPU oracle the
card's tests use) to the kernels' tolerances, float32 1e-5 and bf16 2 ulps
of the output's scale, under the plan ``plan`` picks and under plans of 2,
3 and 5 splits, at live prefixes on both sides of the first two and the
last split boundary, with rows whose valid range misses a whole split or
is empty. ``_swz`` mirrors the kernels' K swizzle: a permutation of each
head row's 16-byte chunks at every slot and width the kernels take.
"""
import numpy as np
import pytest
import torch

from flamingo_mini_tpu_torch.ops import decode_attention as da

H100_SMEM = 232448
# (rows, n_head, kb, head width): flamingo-mini greedy, OPT-1.3B greedy,
# beams 32 x 3, 32 x 5; OPT-2.7B and OPT-6.7B greedy and 8 x 3 beams
SHAPES = {"greedy": (32, 16, 1, 64), "opt-1.3b": (8, 32, 1, 64), "beam96": (96, 16, 3, 64),
          "beam160": (160, 16, 5, 64), "greedy b=1": (1, 16, 1, 64),
          "beam 3 rows": (3, 16, 3, 64), "opt-2.7b": (8, 32, 1, 80),
          "opt-6.7b": (8, 32, 1, 128), "opt-2.7b beam24": (24, 32, 3, 80),
          "opt-6.7b beam24": (24, 32, 3, 128)}
LIMITS = (1, 36, 37, 63, 64, 65, 68, 71, 127, 128, 129, 132, 192)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensors, many ops: one intra-op thread runs them faster, and
    leaves the other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boundaries(p: da.Plan, t_lim: int):
    return [(s * p.positions, min((s + 1) * p.positions, t_lim)) for s in range(p.splits)]


def _plans(rows, n_head, t_lim, itemsize, kb, head_dim):
    """Every plan the kernel takes at this shape."""
    for heads in (h for h in (4, 2, 1) if n_head % h == 0):
        for splits in range(1, min(da.MAX_SPLITS, t_lim) + 1):
            p = da.make_plan(rows, n_head, t_lim, itemsize, kb=kb, beam=kb > 1,
                             heads=heads, splits=splits, head_dim=head_dim)
            if p.splits == splits and p.smem <= da.SMEM_LIMIT:
                yield p


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_fills_the_card_and_tiles_the_prefix(shape, itemsize):
    rows, n_head, kb, hd = SHAPES[shape]
    for t_lim in LIMITS:
        p = da.plan(rows, n_head, t_lim, itemsize, kb=kb, beam=kb > 1, head_dim=hd)
        assert p.smem <= da.SMEM_LIMIT < H100_SMEM, (t_lim, p)
        assert p.blocks == (rows // kb) * (n_head // p.heads) * p.splits
        assert p.head_dim == hd and p.part_stride == hd + 4
        others = list(_plans(rows, n_head, t_lim, itemsize, kb, hd))
        assert p in others and all(da.rank(p) <= da.rank(o) for o in others)
        # a grid the card holds in one wave, a block for every SM, where
        # there is one: unsplit where that fits
        one_wave = [o for o in others
                    if da.waves(o) == 1 and o.blocks >= da.SM_COUNT]
        if one_wave:
            assert da.waves(p) == 1 and p.splits == min(o.splits for o in one_wave)
        # where the rows allow it (an unsplit grid of 2 x 132 blocks in one
        # wave): two waves' worth of blocks
        if any(o.blocks >= 2 * da.SM_COUNT and o.splits == 1 for o in one_wave):
            assert p.blocks >= 2 * da.SM_COUNT and p.splits == 1, (t_lim, p)
        spans = _boundaries(p, t_lim)
        assert spans[0][0] == 0 and spans[-1][1] == t_lim
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(t1 > t0 for t0, t1 in spans), (t_lim, p)
        chunks = p.heads * hd * itemsize // 16
        assert (32 * p.warps) % chunks == 0 and 1 <= p.warps <= da.MAX_WARPS
        # a (beam, head) pair a warp where the chunk columns allow it
        assert p.warps >= min(kb * p.heads, da.MAX_WARPS - 32 // np.gcd(32, chunks) + 1)
        assert n_head % p.heads == 0 and p.heads in (1, 2, 4)
        assert p.smem == da.plan_smem(kb, p.heads, p.positions, itemsize, kb > 1, hd)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_splits_a_prefix_too_long_for_one_wave(itemsize):
    """b=8 over 1,000 slots: 32 MB of bf16 K/V a call, more than the card's
    shared memory holds at once; the plan splits, and every split fits."""
    p = da.plan(8, 16, 1000, itemsize)
    assert p.splits > 1 and p.smem <= da.SMEM_LIMIT
    assert _boundaries(p, 1000)[-1][1] == 1000


def test_plan_is_cached_per_shape():
    da.plan.cache_clear()
    first = da.plan(32, 16, 132, 2)
    hits = da.plan.cache_info().hits
    assert da.plan(32, 16, 132, 2) is first
    assert da.plan.cache_info().hits == hits + 1
    assert da.plan(32, 16, 131, 2) is not first


def _split_mirror(q, k, v, npad, cur, *, n_head, scale, t_lim, p, kb=1, anc=None):
    """The kernels' arithmetic on the plan's splits, in PyTorch (float32,
    the probabilities rounded to the cache dtype) -> (rows, D)."""
    rows, D = q.shape
    dt = q.dtype
    dh = D // n_head
    hi = min(cur, t_lim - 1)
    qf = q.float().view(rows, n_head, dh)
    kf = k[:t_lim].float().view(t_lim, rows, n_head, dh)
    vf = v[:t_lim].float().view(t_lim, rows, n_head, dh)
    t = torch.arange(t_lim)
    fam = torch.arange(rows) // kb * kb
    if anc is None:
        src = torch.arange(rows)[:, None].expand(rows, t_lim)          # (rows, t)
    else:
        a = da._pad_anc(anc, t_lim)[:, :, :t_lim].reshape(rows, t_lim).long()
        src = fam[:, None] + a
    valid = (t[None] >= npad[:, None].long()) & (t[None] <= hi)        # (rows, t)
    empty = npad.long() > hi
    ks = kf[t[None], src]                                              # (rows, t, h, 64)
    vs = vf[t[None], src]
    s = torch.einsum("rhd,rthd->rht", qf, ks) * scale
    s = torch.where(valid[:, None], s, torch.full_like(s, da.NEG))
    parts = []
    for t0, t1 in _boundaries(p, t_lim):
        sl = s[..., t0:t1]
        ok = valid[:, None, t0:t1]
        m = torch.where(ok, sl, torch.full_like(sl, -torch.inf)).amax(-1)
        m = torch.where(torch.isinf(m), torch.full_like(m, da.NEG), m)
        pr = torch.where(ok, torch.exp(sl - m[..., None]), torch.zeros_like(sl))
        l = pr.sum(-1)
        acc = torch.einsum("rht,rthd->rhd", pr.to(dt).float(), vs[:, t0:t1])
        # no valid slot in the row: every family entry of the split at 1
        fam_v = vf[t0:t1].view(t1 - t0, rows // kb, kb, n_head, dh)
        uni = fam_v.sum(dim=(0, 2)).repeat_interleave(kb, dim=0)        # (rows, h, dh)
        acc = torch.where(empty[:, None, None], uni, acc)
        l = torch.where(empty[:, None], torch.full_like(l, kb * (t1 - t0)), l)
        m = torch.where(empty[:, None], torch.full_like(m, da.NEG), m)
        parts.append((m, l, acc))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(M)
    acc = torch.zeros_like(qf)
    for m, ls, a in parts:                                             # split order
        w = torch.exp(m - M)
        l = l + w * ls
        acc = acc + w[..., None] * a
    return (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(rows, D).to(dt)


def _tol(want: torch.Tensor) -> float:
    if want.dtype == torch.float32:
        return 1e-5
    return 2 * 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)


def _npad_cases(rows: int, kb: int, cur: int, p: da.Plan, t_lim: int):
    """Left padding 0-3 by family; then the same with one family's rows past
    ``cur`` (an empty range) and another's past the first split."""
    base = np.repeat(np.arange(rows // kb) % 4, kb)
    yield base
    masked = base.copy()
    masked[:kb] = cur + 1
    if p.splits > 1 and p.positions + 1 <= min(cur, t_lim - 1):
        masked[kb:2 * kb] = p.positions + 1
    yield masked


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["greedy", "opt-1.3b", "beam96", "beam160",
                                   "opt-2.7b", "opt-6.7b"])
def test_split_arithmetic_matches_plain(shape, dtype):
    rows, n_head, kb, hd = SHAPES[shape]
    T = 192 if kb == 1 else 128
    D = n_head * hd
    rs = np.random.RandomState(rows + kb)
    q, k, v = (torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32).to(dtype)
               for s in ((rows, D), (T, rows, D), (T, rows, D)))
    anc = None
    if kb > 1:
        anc = torch.tensor(rs.randint(0, kb, (rows // kb, kb, 68)), dtype=torch.int32)
    worst = 0.0
    # (kv_limit, splits): None is plan()'s own
    cases = ([(1, None), (65, 3), (128, None), (128, 2), (64, 5)] if kb > 1 else
             [(1, None), (63, None), (129, 3), (192, None), (192, 2), (71, 5)])
    for kv_limit, splits in cases:
        t_lim = min(kv_limit, T)
        p = da.plan(rows, n_head, t_lim, q.element_size(), kb=kb, beam=kb > 1,
                    head_dim=hd)
        if splits is not None:
            p = da.make_plan(rows, n_head, t_lim, q.element_size(), kb=kb, beam=kb > 1,
                             heads=p.heads, splits=min(splits, t_lim), head_dim=hd)
        inner = [t0 for t0, _ in _boundaries(p, t_lim)[1:]]
        curs = {t_lim - 1} | {c for t0 in inner[:2] + inner[-1:] for c in (t0 - 1, t0)}
        for cur in sorted(curs):
            for npad in _npad_cases(rows, kb, cur, p, t_lim):
                npad = torch.tensor(npad, dtype=torch.int32)
                kw = dict(n_head=n_head, scale=0.125, kv_limit=kv_limit)
                if kb == 1:
                    want = da.decode_attention_plain(q, k, v, npad, cur, **kw)
                else:
                    want = da.decode_attention_beam_plain(q, k, v, anc, npad, cur,
                                                          kb=kb, **kw)
                got = _split_mirror(q, k, v, npad, cur, n_head=n_head, scale=0.125,
                                    t_lim=t_lim, p=p, kb=kb, anc=anc)
                assert bool(torch.isfinite(got).all())
                err = float((got.float() - want.float()).abs().max())
                assert err <= _tol(want), (kv_limit, cur, p, err)
                worst = max(worst, err)
    print(f"{shape} {dtype}: worst {worst}")


def _swz(c: int, t: int, kch: int) -> int:
    """The kernels' K swizzle (``swz`` in csrc/decode_attention.cu): chunk c
    of a head row of ``kch`` 16-byte chunks at slot t."""
    base = kch & ~7
    tail = kch - base
    if c < base:
        return c ^ (t & 7)
    return c ^ (t & (tail - 1))


@pytest.mark.parametrize("hd", da.HEAD_DIMS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_k_swizzle_permutes_each_head_row(hd, itemsize):
    """At every width the kernels take, in both dtypes, and every slot
    residue: each chunk lands in its own row, no two on one place; where
    the row is a whole number of 8-chunk groups (or shorter) it is the
    plain XOR rule, c ^ (t & (min(kch, 8) - 1))."""
    kch = hd * itemsize // 16
    tail = kch % 8
    assert tail & (tail - 1) == 0, (hd, itemsize, kch)
    for t in range(16):
        got = [_swz(c, t, kch) for c in range(kch)]
        assert sorted(got) == list(range(kch)), (hd, itemsize, t, got)
        if tail == 0 or kch < 8:
            assert got == [c ^ (t & (min(kch, 8) - 1)) for c in range(kch)]
