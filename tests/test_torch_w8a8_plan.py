"""The megakernel's w8a8 mode's tile plan, on the CPU.

The Hopper kernel runs only on the card (tests/test_torch_gpu.py holds it
against its plain version there); its plan is a Python mirror of its code,
computed from the shapes. Here, for the megakernel's w8a8
mode (``plan(..., act_quant=True)``) at flamingo-mini (D=1024), OPT-1.3B
(D=2048) and beam shapes: every phase's items cover each (output column
tile, 64-k chunk) once over a grid of one block per SM; no K-slice of a
row-form input straddles one of its D-wide quantization slices (the
combine adds a slice's partials in int32, then the slices' scaled sums in
order); the launch's shared memory fits the card; the k order of its int8
A fragments and staged B tile agree. No JAX.
"""
import numpy as np
import pytest

from flamingo_mini_tpu_torch.ops import megadecode as md

H100_SMEM = 232448   # shared memory a block may opt in to on an H100
# (rows, D, Dff, XI, Dffx, t_lim, latents, layers with xattn)
SHAPES = {
    "flamingo-mini b=1": (1, 1024, 4096, 512, 4096, 132, 64, 24),
    "flamingo-mini b=3": (3, 1024, 4096, 512, 4096, 132, 64, 24),
    "flamingo-mini b=32": (32, 1024, 4096, 512, 4096, 132, 64, 24),
    "flamingo-mini b=33": (33, 1024, 4096, 512, 4096, 132, 64, 24),
    "beams 96 rows": (96, 1024, 4096, 512, 4096, 68, 64, 24),
    "beams 160 rows": (160, 1024, 4096, 512, 4096, 68, 64, 24),
    "257 rows": (257, 1024, 4096, 512, 4096, 132, 64, 24),
    "OPT-1.3B b=8": (8, 2048, 8192, 512, 8192, 71, 64, 12),
    "OPT-1.3B b=32": (32, 2048, 8192, 512, 8192, 71, 64, 12),
    "opt-6.7b width b=28": (28, 4096, 16384, 512, 16384, 16, 64, 1),
}
ROW_FORM = ("xo", "xf2", "pr")


def _items(n_tiles: int, s: int, block: int, blocks: int):
    """The kernel's ``item_at``: items block, block + blocks, ... of a phase."""
    return [(item // s, item % s) for item in range(block, n_tiles * s, blocks)]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_w8a8_items_cover_every_column_tile_and_chunk_once(shape):
    rows, D, Dff, XI, Dffx, _t, _nv, nx = SHAPES[shape]
    p = md.plan(rows, D, Dff, XI, Dffx, n_xattn=nx, act_quant=True)
    assert p["act_quant"]
    for name, s in zip(md.LINEARS, p["split"]):
        n_out, K = md.linear_shapes(D, Dff, XI, Dffx)[name]
        n_tiles, n_chunks = n_out // md.K_CHUNK, K // md.K_CHUNK
        assert 1 <= s <= n_chunks, (name, s)
        seen = np.zeros((n_tiles, n_chunks), dtype=np.int64)
        for block in range(md.N_SMS):
            for tile, slice_ in _items(n_tiles, s, block, md.N_SMS):
                c0, nc = md.slice_chunks(slice_, s, n_chunks)
                seen[tile, c0:c0 + nc] += 1
        assert (seen == 1).all(), (shape, name, s)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_w8a8_no_k_slice_straddles_a_quantization_slice(shape):
    """Each K-slice of every linear lies within one D-wide quantization
    slice of its input (the column form's input is one slice: K = D), so
    the slices' partials group by quantization slice in slice order."""
    rows, D, Dff, XI, Dffx, _t, _nv, nx = SHAPES[shape]
    p = md.plan(rows, D, Dff, XI, Dffx, n_xattn=nx, act_quant=True)
    quant = D // md.K_CHUNK
    for name, s in zip(md.LINEARS, p["split"]):
        K = md.linear_shapes(D, Dff, XI, Dffx)[name][1]
        n_chunks = K // md.K_CHUNK
        if name not in ROW_FORM:
            assert K == D, name
        qs = []
        for i in range(s):
            c0, nc = md.slice_chunks(i, s, n_chunks)
            assert c0 // quant == (c0 + nc - 1) // quant, (shape, name, s, i)
            qs.append(c0 // quant)
        assert qs == sorted(qs) and set(qs) == set(range(-(-K // D))), (name, qs)
        assert not md.straddles(s, n_chunks, quant)


def test_straddle_rule_and_split_choice():
    """``straddles`` at mlp_proj's 64 chunks in four 16-chunk slices: whole
    fractions of a slice pass, 3, 5 or 6 slices do not; ``choose_split``
    picks among the passing ones only."""
    assert not any(md.straddles(s, 64, 16) for s in (4, 8, 12, 16, 64))
    assert all(md.straddles(s, 64, 16) for s in (1, 2, 3, 5, 6))
    for rows in (1, 32, 96):
        s = md.choose_split(16, 64, md.N_SMS, 64, rows, quant=16)
        assert not md.straddles(s, 64, 16), (rows, s)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_w8a8_shared_memory_fits(shape):
    """The w8a8 launch's shared memory (int8 staging, float64 attention
    sums, four-word statistics) fits the card; a slice's staged int8
    activations fit the plan's budget; past one pass a slice's chunks fit
    the ring; a split tile's int32 partials fit ``parts``."""
    rows, D, Dff, XI, Dffx, t_lim, nv, nx = SHAPES[shape]
    p = md.plan(rows, D, Dff, XI, Dffx, n_xattn=nx, act_quant=True)
    most = md.max_chunks(p, D, Dff, XI, Dffx)
    assert p["tile_rows"] * 64 * most <= md.STAGE_BUDGET
    if p["n_pass"] > 1:
        assert most <= md.RING_STAGES
    need = md.plan_smem_bytes(p, D, Dff, XI, Dffx, t_lim, nv)
    assert need <= H100_SMEM
    for name, s in zip(md.LINEARS, p["split"]):
        n_out = md.linear_shapes(D, Dff, XI, Dffx)[name][0]
        if s > 1:
            assert (p["n_pass"] * n_out // md.K_CHUNK * s * md.K_CHUNK * p["tile_rows"]
                    <= p["parts_floats"])


@pytest.mark.parametrize("rows", [27, 28, 64, 65, 73, 128, 200, 255, 256, 257, 2048])
def test_w8a8_takes_every_row_count_at_opt_6_7b_width(rows):
    """At D=4096 (opt-6.7b) the w8a8 mode's shared memory fits the card at
    row counts on both sides of its wide mode and its passes: the plan's
    staging budget leaves room for the phase's LayerNorm scale and bias
    (8 D bytes), without which 73 to 255 rows outgrew the card."""
    D, Dff = 4096, 16384
    p = md.plan(rows, D, Dff, 512, Dff, n_xattn=1, act_quant=True)
    assert md.plan_smem_bytes(p, D, Dff, 512, Dff, 16, 64) <= H100_SMEM
    assert p["tile_rows"] * 64 * md.max_chunks(p, D, Dff, 512, Dff) + 8 * D <= md.STAGE_BUDGET


def test_w8a8_smem_formula_parts_from_weight_only():
    """The two modes' formulas differ where their layouts do: the float64
    attention sums and the four-word statistics in the w8a8 mode, and its
    staged chunk rows of 64 bytes where the weight-only mode's are 128."""
    D, Dff, XI, t, nv = 1024, 4096, 512, 132, 64
    for rows in (1, 32, 96):
        pw = md.plan(rows, D, Dff, XI, Dff, n_xattn=24)
        pq = md.plan(rows, D, Dff, XI, Dff, n_xattn=24, act_quant=True)
        assert not pw["act_quant"] and pq["act_quant"]
        assert md.plan_smem_bytes(pq, D, Dff, XI, Dff, t, nv) != \
            md.plan_smem_bytes(pw, D, Dff, XI, Dff, t, nv)


def _b_slot_s8(k: int) -> int:
    """The byte of step (k >> 3) & 1's 32 that the staged int8 B tile gives
    the word k .. k + 3 (k a multiple of 4): b_offset_s8 before the swizzle,
    less the step's 32 bytes."""
    return 16 * ((k >> 2) & 1) + 4 * (k >> 4)


def _b_offset_s8(r: int, k: int) -> int:
    """The kernel's ``b_offset_s8``."""
    p = 32 * ((k >> 3) & 1) + _b_slot_s8(k)
    return r * 64 + ((((p >> 4) ^ ((r >> 1) & 3)) << 4) | (p & 15))


def test_int8_b_tile_k_order_matches_the_a_fragments():
    """Lane t of a warp loads weights k = 16 t .. 16 t + 15 of a row and
    feeds k32 step j the words 2 j (wgmma slots 4 t .. 4 t + 3) and 2 j + 1
    (slots 16 + 4 t ..), the int8 A layout. The staged B tile must give
    every slot of every step the same k; its 16-byte units are a 64-byte
    swizzle of the row's (unit u of row r at u ^ ((r >> 1) & 3))."""
    slot_k = {}
    for t in range(4):
        for j in range(2):
            slot_k[(j, 4 * t)] = 16 * t + 8 * j
            slot_k[(j, 16 + 4 * t)] = 16 * t + 8 * j + 4
    for k in range(0, 64, 4):
        assert slot_k[((k >> 3) & 1, _b_slot_s8(k))] == k
    for r in range(16):
        offs = sorted(_b_offset_s8(r, k) for k in range(0, 64, 4))
        assert offs == list(range(r * 64, r * 64 + 64, 4))
        for k in range(0, 64, 4):
            p = 32 * ((k >> 3) & 1) + _b_slot_s8(k)
            assert _b_offset_s8(r, k) % 16 == p % 16
            assert (_b_offset_s8(r, k) - r * 64) // 16 == (p // 16) ^ ((r >> 1) & 3)
