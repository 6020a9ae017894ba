"""The decode stream probes' kernel layout (``plan`` in
``flamingo_mini_tpu_torch/tools/probe_decode_kernel.py``) and a PyTorch
mirror of the kernel's walk (``csrc/decode_stream_probe.cu``), no JAX.

The kernel deals the output's 16-byte column vectors to blocks in slices;
a block's threads each own one (group of rows, vector), write their float32
partials to shared memory, and one thread a vector folds them in order,
window by window. The mirror repeats that walk: the C entry points' strides
and pointers, each window's partials, the fold with its chunk sum carried
across windows, and checks that it gives ``_sum_plain``'s bits (the plain
versions, which ``tests/test_torch_probe_decode.py`` pins to the TPU
kernels) at the probe's shape and at the edges the card checks too.
"""
import numpy as np
import pytest
import torch

from flamingo_mini_tpu_torch.tools import probe_decode_kernel as pdk

# (b, T, D, block_t, kv_limit): the probe's shape, then its edges: odd and
# single rows, D of 5 vectors and OPT-1.3B's 2048, block_t 1, 3 and 24
# (one, one and eight rows a group), kv_limit dividing neither block_t nor
# 8, a long cache walked in windows, and chunks longer than a block holds
CASES = [
    (32, 192, 1024, 16, 128), (32, 192, 1024, 32, 128),
    (32, 192, 1024, 16, 100), (32, 192, 1024, 32, 100),
    (1, 192, 1024, 32, 128), (3, 192, 1024, 16, 100),
    (32, 192, 40, 32, 128), (8, 192, 2048, 32, 128),
    (3, 64, 64, 1, 50), (3, 64, 64, 3, 50), (3, 96, 64, 24, 50),
    (4, 1024, 64, 32, 1024), (4, 1024, 64, 32, 1000),
    (4, 512, 64, 256, 300), (2, 70, 64, 7, 64),
]
IDS = [f"b{b}-T{t}-D{d}-bt{bt}-kv{kv}" for b, t, d, bt, kv in CASES]
CARD_SMEM = 232_448      # a block's shared memory on the H100
CARD_THREADS = 1024


def _groups(n_rows, block_t):
    r = pdk.group_rows(block_t)
    return n_rows // r, block_t // r


def _threads(p, b, d, n_groups):
    """Every thread of the grid over every window -> (group, vector) of
    each thread that loads, in launch order."""
    n_vec = b * (d // 8)
    tid = np.arange(p.threads)
    s, gl = tid % p.width, tid // p.width
    c = (np.arange(p.blocks)[:, None] * p.width + s[None]).reshape(-1)
    gl = np.broadcast_to(gl, (p.blocks, p.threads)).reshape(-1)
    pairs = []
    for w in range(p.windows):
        g = w * p.window + gl
        live = (c < n_vec) & (g < n_groups)
        pairs.append((g[live], c[live]))
    return pairs


@pytest.mark.parametrize("b,t,d,block_t,kv_limit", CASES, ids=IDS)
def test_plan_covers_every_group_and_vector_once(b, t, d, block_t, kv_limit):
    n_rows = pdk.chunk_rows(kv_limit, block_t, t)
    n_groups, gpc = _groups(n_rows, block_t)
    n_vec = b * (d // 8)
    p = pdk.plan(b, d, n_rows, block_t)
    assert p.threads == p.width * p.window <= min(pdk.MAX_THREADS, CARD_THREADS)
    assert p.smem == p.threads * 32 <= CARD_SMEM
    assert p.width >= 1 and p.window >= 1
    assert p.windows == -(-n_groups // p.window)
    assert (p.blocks - 1) * p.width < n_vec <= p.blocks * p.width
    if gpc <= pdk.THREADS // p.width:
        assert p.window % gpc == 0 or p.window == n_groups   # whole chunks
    seen = np.zeros((n_groups, n_vec), dtype=np.int64)
    for g, c in _threads(p, b, d, n_groups):
        np.add.at(seen, (g, c), 1)
    assert (seen == 1).all()


def test_plan_at_the_probe_shape_is_one_wave_and_cached():
    # 256 blocks of 256 threads, two an SM (122 registers at 8 rows a
    # group): one wave on the H100's 132 SMs
    p = pdk.plan(32, 1024, 128, 32)
    assert p == pdk.Plan(width=16, window=16, threads=256, smem=8192, blocks=256,
                         windows=1)
    assert pdk.plan(32, 1024, 128, 32) is p
    # the long cache: 128 groups of 8 rows in eight windows of 16
    long = pdk.plan(32, 1024, 1024, 32)
    assert (long.width, long.window, long.windows) == (16, 16, 8)


def walk(q, k8, v8, t_stride, b_stride, n_rows, block_t, p):
    """The kernel's walk on the CPU: k8, v8 the C entry's K and V pointers
    as (N, 8) bf16 vectors, strides in vectors, the plan ``p``."""
    b, d = q.shape
    dvec = d // 8
    r = pdk.group_rows(block_t)
    n_groups, gpc = n_rows // r, block_t // r
    c = (torch.arange(p.blocks)[:, None] * p.width + torch.arange(p.width)).reshape(-1)
    c = c[c < b * dvec]                     # a slice at the edge is masked
    col_off = (c // dvec) * b_stride + c % dvec
    acc = torch.zeros((len(c), 8), dtype=torch.float32)
    cs, in_chunk = None, 0
    for g0 in range(0, n_groups, p.window):
        g = torch.arange(g0, min(g0 + p.window, n_groups))
        base = g[:, None] * r * t_stride + col_off[None]
        sk = k8[base].float()
        sv = v8[base].float()
        for i in range(1, r):
            sk = sk + k8[base + i * t_stride].float()
            sv = sv + v8[base + i * t_stride].float()
        part = sk + sv                      # (groups, vectors, 8), to shared
        for j in range(len(g)):             # the fold, one thread a vector
            cs = part[j] if in_chunk == 0 else cs + part[j]
            in_chunk += 1
            if in_chunk == gpc:
                acc = acc + cs
                in_chunk = 0
    out = (acc + q.reshape(-1, 8)[c].float()).to(torch.bfloat16)
    return out.reshape(b, d)


def _inputs(layout, b, t, d, seed):
    rs = np.random.RandomState(seed)

    def bf16(*shape):
        return torch.tensor(rs.randn(*shape), dtype=torch.float32).to(torch.bfloat16)
    q = bf16(b, d)
    if layout == "packed":
        return q, (bf16(t, b, 2 * d),)
    return q, (bf16(*((b, t, d) if layout == "bmajor" else (t, b, d))) for _ in range(2))


@pytest.mark.parametrize("layout", ["tmajor", "bmajor", "packed"])
@pytest.mark.parametrize("b,t,d,block_t,kv_limit", CASES, ids=IDS)
def test_walk_equals_plain_bit_for_bit(layout, b, t, d, block_t, kv_limit):
    q, caches = _inputs(layout, b, t, d, seed=b + t + d + block_t + kv_limit)
    caches = tuple(caches)
    n_rows = pdk.chunk_rows(kv_limit, block_t, t)
    dvec = d // 8
    if layout == "tmajor":
        want = pdk.tmajor_stream_plain(q, *caches, block_t=block_t, kv_limit=kv_limit)
        k8, v8 = (c.view(-1, 8) for c in caches)
        strides = (b * dvec, dvec)
    elif layout == "bmajor":
        want = pdk.attn_stream_only_plain(q, *caches, None, None, None, block_t,
                                          shape=pdk.Shape(kv_limit=kv_limit))
        k8, v8 = (c.view(-1, 8) for c in caches)
        strides = (dvec, t * dvec)
    else:
        want = pdk.packed_stream_plain(q, *caches, block_t=block_t, kv_limit=kv_limit)
        k8 = caches[0].view(-1, 8)
        v8 = k8[dvec:]                      # the C entry's k + D / 8
        strides = (2 * b * dvec, 2 * dvec)
    got = walk(q, k8, v8, *strides, n_rows, block_t, pdk.plan(b, d, n_rows, block_t))
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# other layouts than the rule's (narrower and wider slices, fewer threads,
# so more windows) keep the bits: the sweep in profile_decode.py times them
@pytest.mark.parametrize("width,max_threads", [(8, 512), (16, 256), (64, 512), (4, 64)])
def test_walk_equals_plain_under_other_plans(width, max_threads):
    b, t, d, block_t, kv_limit = 4, 192, 128, 16, 100
    q, (k, v) = _inputs("tmajor", b, t, d, seed=width + max_threads)
    n_rows = pdk.chunk_rows(kv_limit, block_t, t)
    p = pdk.make_plan(b, d, n_rows, block_t, width=width, max_threads=max_threads)
    assert p.threads <= max_threads
    got = walk(q, k.view(-1, 8), v.view(-1, 8), b * d // 8, d // 8, n_rows, block_t, p)
    want = pdk.tmajor_stream_plain(q, k, v, block_t=block_t, kv_limit=kv_limit)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
