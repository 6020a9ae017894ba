"""The weight-only megakernel's tile plan (``ops/megadecode.py``'s ``plan``),
on the CPU.

The Hopper kernel (``csrc/decode_megakernel_sm90.cuh``) runs only on the
card (tests/test_torch_gpu.py holds it against its plain version there);
its plan is Python, computed from the shapes and handed to it in the
arguments. Here, at flamingo-mini (D=1024), OPT-1.3B (D=2048), OPT-2.7B
(D=2560, heads 80 wide), OPT-6.7B (D=4096, heads 128 wide) and beam
shapes: every phase's work items cover each (output column tile, 64-k
chunk) exactly once over a grid of one block per SM, in the kernel's order
of dealing them; the row groups cover every row once at wgmma widths; the
staged activations, the ring and the shared memory of a launch stay within
what the plan and the card allow; the trunk widths the refusal names fit
or do not. Two pieces of the kernel's arithmetic are checked from first
principles, in numpy mirrors of its code: the k order its A fragments and
its staged B tile share, and its exact int8 -> bf16 conversion; and its
attention's lane map at each head width it takes, within the scratch it
reserves.
"""
import numpy as np
import pytest

from flamingo_mini_tpu_torch.ops import megadecode as md

H100_SMEM = 232448   # shared memory a block may opt in to on an H100
# (rows, D, Dff, XI, Dffx, t_lim, latents, layers with xattn)
SHAPES = {
    "flamingo-mini b=1": (1, 1024, 4096, 512, 4096, 132, 64, 24),
    "flamingo-mini b=32": (32, 1024, 4096, 512, 4096, 132, 64, 24),
    "flamingo-mini b=33": (33, 1024, 4096, 512, 4096, 132, 64, 24),
    "beams 96 rows": (96, 1024, 4096, 512, 4096, 68, 64, 24),
    "beams 160 rows": (160, 1024, 4096, 512, 4096, 68, 64, 24),
    "257 rows": (257, 1024, 4096, 512, 4096, 132, 64, 24),
    "OPT-1.3B b=8": (8, 2048, 8192, 512, 8192, 71, 64, 12),
    "OPT-1.3B b=32": (32, 2048, 8192, 512, 8192, 71, 64, 12),
    "OPT-2.7B b=8": (8, 2560, 10240, 512, 10240, 71, 64, 16),
    "OPT-2.7B beams 24 rows": (24, 2560, 10240, 512, 10240, 40, 64, 16),
    "OPT-6.7B b=8": (8, 4096, 16384, 512, 16384, 71, 64, 16),
    "OPT-6.7B beams 24 rows": (24, 4096, 16384, 512, 16384, 40, 64, 16),
}


def _items(n_tiles: int, s: int, block: int, blocks: int):
    """The kernel's ``item_at``: items block, block + blocks, ... of a phase
    of n_tiles x s items -> [(tile, slice)]."""
    return [(item // s, item % s) for item in range(block, n_tiles * s, blocks)]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_items_cover_every_column_tile_and_chunk_once(shape):
    rows, D, Dff, XI, Dffx, _t, _nv, nx = SHAPES[shape]
    p = md.plan(rows, D, Dff, XI, Dffx, n_xattn=nx)
    for name, s in zip(md.LINEARS, p["split"]):
        n_out, K = md.linear_shapes(D, Dff, XI, Dffx)[name]
        n_tiles, n_chunks = n_out // md.K_CHUNK, K // md.K_CHUNK
        assert 1 <= s <= n_chunks, (name, s)
        seen = np.zeros((n_tiles, n_chunks), dtype=np.int64)
        for block in range(md.N_SMS):
            for tile, slice_ in _items(n_tiles, s, block, md.N_SMS):
                c0, nc = md.slice_chunks(slice_, s, n_chunks)
                assert 1 <= nc <= -(-n_chunks // s)
                seen[tile, c0:c0 + nc] += 1
        assert (seen == 1).all(), (shape, name, s)


@pytest.mark.parametrize("rows", [1, 7, 8, 9, 31, 32, 33, 64, 65, 96, 160, 256, 257, 513, 1000])
def test_row_groups_cover_every_row_once(rows):
    """The passes over the rows, and within a pass the rows each warpgroup
    takes (all of them up to ROW_GROUP rows; past it a quarter each, N rows
    from wg N), cover every row once at wgmma widths; a warpgroup reads its
    N rows within the staged tiles and the N rows the union keeps past them."""
    p = md.plan(rows, 1024, 4096, 512, 4096, n_xattn=24)
    seen = np.zeros(rows, dtype=np.int64)
    n_pass = -(-rows // md.PASS_ROWS)
    for ps in range(n_pass):
        r0 = ps * md.PASS_ROWS
        r = min(md.PASS_ROWS, rows - r0)
        n, tr = md.pass_shape(rows, r)
        assert n in md.WGMMA_N and n <= p["n0"] and tr <= p["tile_rows"] and r <= tr
        if rows <= md.ROW_GROUP:
            assert n_pass == 1 and r <= n < r + 8 or n in (48, 64) and r <= n < r + 16
            seen[r0:r0 + r] += 1  # by every warpgroup, each a share of the chunks
        else:
            assert tr % 8 == 0 and r <= tr < r + 8
            for wg in range(md.GROUPS):
                lo, hi = wg * n, min(r, wg * n + n)
                if lo < r:
                    assert wg * n + n <= tr + n
                    seen[r0 + lo:r0 + hi] += 1
    assert (seen == 1).all()
    assert p["n_pass"] == n_pass and p["wide"] == (rows > md.ROW_GROUP)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_staging_ring_and_shared_memory_fit(shape):
    """A slice's staged activations fit the plan's budget; past one pass a
    slice's chunks fit the ring that holds them; the launch's shared memory
    fits the card; a split tile's partials fit ``parts``."""
    rows, D, Dff, XI, Dffx, t_lim, nv, nx = SHAPES[shape]
    p = md.plan(rows, D, Dff, XI, Dffx, n_xattn=nx)
    most = md.max_chunks(p, D, Dff, XI, Dffx)
    assert p["tile_rows"] * 128 * most <= md.STAGE_BUDGET
    if p["n_pass"] > 1:
        assert most <= md.RING_STAGES
    assert md.plan_smem_bytes(p, D, Dff, XI, Dffx, t_lim, nv) <= H100_SMEM
    for name, s in zip(md.LINEARS, p["split"]):
        n_out = md.linear_shapes(D, Dff, XI, Dffx)[name][0]
        if s > 1:
            assert (p["n_pass"] * n_out // md.K_CHUNK * s * md.K_CHUNK * p["tile_rows"]
                    <= p["parts_floats"])
        assert 2 + p["n_pass"] * n_out // md.K_CHUNK <= p["sync_words"]


def test_limits_of_wide_trunks():
    """What the refusal names: 28 rows at D=4096 fit the card's shared
    memory; a D=8192 trunk is refused (its LayerNorm rows do not fit the
    kernel's registers)."""
    p = md.plan(28, 4096, 16384, 512, 16384, n_xattn=1)
    assert md.plan_smem_bytes(p, 4096, 16384, 512, 16384, 16, 64) <= H100_SMEM
    with pytest.raises(ValueError, match="4096"):
        md.plan(8, 8192, 32768, 512, 32768, n_xattn=1)


def test_split_choice_spreads_the_main_path():
    """At flamingo-mini's b=32 the plan splits the narrow phases (to_q,
    c_proj, fc2 and mlp_proj: 8-16 column tiles) and leaves one item per
    block at most in every phase."""
    p = md.plan(32, 1024, 4096, 512, 4096, n_xattn=24)
    shapes = md.linear_shapes(1024, 4096, 512, 4096)
    for name, s in zip(md.LINEARS, p["split"]):
        assert shapes[name][0] // md.K_CHUNK * s <= md.N_SMS, (name, s)
    split = dict(zip(md.LINEARS, p["split"]))
    assert split["pr"] > 1 and split["xf2"] > 1 and split["xq"] > 1


@pytest.mark.parametrize("rows", [96, 160])
def test_split_choice_keeps_beam_widths_to_one_round(rows):
    """At the beams' 96 and 160 rows (one pass, a quarter of the rows for
    each warpgroup) no phase deals a block more than one item: the staged
    activations of a slice fit the budget without extra K-slices."""
    p = md.plan(rows, 1024, 4096, 512, 4096, n_xattn=24)
    shapes = md.linear_shapes(1024, 4096, 512, 4096)
    assert p["wide"] and p["n_pass"] == 1
    for name, s in zip(md.LINEARS, p["split"]):
        assert shapes[name][0] // md.K_CHUNK * s <= md.N_SMS, (rows, name, s)


def test_args_carry_the_plan():
    p = md.plan(32, 1024, 4096, 512, 4096, n_xattn=24)
    args = md._Args(b=32)
    md._plan_args(args, p)
    assert list(args.split) == p["split"] and args.n_xattn == 24
    assert md.ctypes.sizeof(md._Args) % 8 == 0


def _b_slot(k: int) -> int:
    """The wgmma k slot the staged B tile gives the pair (k, k + 1) of a
    64-k chunk: the kernel's ``b_offset`` before the swizzle."""
    return 16 * ((k >> 2) & 3) + 2 * (k >> 4) + 8 * ((k >> 1) & 1)


def _b_offset(r: int, k: int) -> int:
    """The kernel's ``b_offset``: byte offset of the pair in row r's tile."""
    p = _b_slot(k)
    return r * 128 + ((((p >> 3) ^ (r & 7)) << 4) | ((p & 7) << 1))


def test_b_tile_k_order_matches_the_a_fragments():
    """Lane t4 of a warp loads weights k = 16 t4 .. 16 t4 + 15 of a row and
    feeds step j the four bytes 4j .. 4j + 3: bytes 0, 1 to the fragment's
    slots 2 t4, 2 t4 + 1 and bytes 2, 3 to 2 t4 + 8, 2 t4 + 9 (wgmma's A
    layout). The staged B tile must give every slot the same k."""
    slot_k = {}
    for t4 in range(4):
        for j in range(4):
            k = 16 * t4 + 4 * j
            slot_k[16 * j + 2 * t4] = k
            slot_k[16 * j + 2 * t4 + 8] = k + 2
    for k in range(0, 64, 2):
        assert slot_k[_b_slot(k)] == k
    for r in range(16):  # every 4-byte word of a row once, swizzled by r % 8
        offs = sorted(_b_offset(r, k) for k in range(0, 64, 2))
        assert offs == list(range(r * 128, r * 128 + 128, 4))


def test_layer_norm_unit_order():
    """The kernel's LayerNorm statistics order (``_warp_sum_units``: lane l
    adds the 8-element units l, l + 32, ...), both modes: the same sum as
    float64's up to float32 rounding, and the same bits as an explicit walk
    over the lanes, at widths that fill the last round of units and widths
    that do not."""
    rs = np.random.RandomState(0)
    for D in (256, 320, 1024, 2048):
        x = md.torch.tensor(rs.randn(3, D).astype(np.float32))
        got = md._warp_sum_units(x)[:, 0].numpy()
        lanes = np.zeros((3, 32), dtype=np.float32)
        for v in range(-(-D // 256)):
            for lane in range(32):
                for j in range(8):
                    k = 256 * v + 8 * lane + j
                    if k < D:
                        lanes[:, lane] = lanes[:, lane] + x[:, k].numpy()
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ o]
        np.testing.assert_array_equal(got, lanes[:, 0])
        np.testing.assert_allclose(got, x.double().sum(dim=1).numpy(), rtol=1e-5, atol=1e-4)


def test_int8_to_bf16_is_exact():
    """The kernel's i8x4_to_bf16x4: byte b biased to b + 128 placed under
    the float32 exponent of 2^23, less 2^23 + 128, is b exactly, and its low
    16 bits are zero (its top half is the bf16 of b)."""
    b = np.arange(-128, 128, dtype=np.int32)
    bits = (0x4B000000 | ((b + 128) & 0xFF)).astype(np.uint32)
    f = bits.view(np.float32) - np.float32(8388736.0)
    assert (f == b.astype(np.float32)).all()
    assert (f.view(np.uint32) & 0xFFFF == 0).all()


def _attention_scratch_bytes(t_max: int, act_quant: bool, heads: int, dims: int) -> int:
    """The kernel's attention scratch (``att_bytes``) for items of ``heads``
    heads and ``dims`` dims over ``t_max`` positions: a float score row per
    head, each warp's V sums of the item's dims, each span's max (float)
    and sum (float64 in the w8a8 mode)."""
    warps, acc = 4 * md.GROUPS, 8 if act_quant else 4
    return 4 * heads * t_max + acc * warps * dims + (4 + acc) * warps * heads


@pytest.mark.parametrize("head_dim", md.HEAD_DIMS)
def test_attention_items_fit_the_lanes_and_the_scratch(head_dim):
    """The kernel's attention item (``Heads``): a lane 8 dims, a head
    head_dim / 8 lanes of a warp's 32, so four heads at 64, three at 80,
    two at 128; lane l takes head l // (head_dim / 8), dims 8 (l %
    (head_dim / 8)) .. + 7, every (head, dim) of the item once, the lanes
    past the last head idle (two at 80). Its scores, V sums and spans fit
    the scratch the kernel reserves for 64-wide items (``plan_smem_bytes``),
    in both modes and at every position count, and the float64 sums start
    8-byte aligned."""
    lanes = head_dim // 8
    heads = 32 // lanes
    dims = heads * head_dim
    seen = np.zeros((heads, head_dim), dtype=np.int64)
    for lane in range(heads * lanes):
        h, d0 = lane // lanes, 8 * (lane % lanes)
        seen[h, d0:d0 + 8] += 1
    assert (seen == 1).all() and dims <= 256
    assert heads == {64: 4, 80: 3, 128: 2}[head_dim]
    assert 32 - heads * lanes == {64: 0, 80: 2, 128: 0}[head_dim]
    for q in (False, True):
        for t in (1, 40, 71, 132, 257, 2049):
            reserved = _attention_scratch_bytes(t, q, 4, 4 * md.HEAD_DIM)
            assert _attention_scratch_bytes(t, q, heads, dims) <= reserved
            assert (4 * 4 * t) % 8 == 0
