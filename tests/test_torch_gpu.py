"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so that it runs on a machine with the card and without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest``: tests/conftest.py configures JAX for the CPU suite.)

Shapes are the main path's (flamingo-mini at batch 32). Tolerances:
float32 attention 1e-5 absolute (summation order); bf16 attention 2 bf16
ulps of the output scale (the kernel's online softmax rounds its
probabilities to bf16 against a running max, the plain version against the
global max); the head's tokens are equal, a planted exact tie across
chunks resolving to the first index, and at B in {1, 3, 8, 32, 33, 64, 65,
128} and D in {1024, 2048} equal or (printing the row's top-2 gap) within
1 bf16 ulp, exact ties planted across tiles, across one warpgroup's rounds
and across two blocks' shares resolving to the first index, n_valid at a
tile's edge; the whole-step megakernel's hidden row
and written K/V rows, 2 layers at a small width (D=256) and at
flamingo-mini's (D=1024, XI=512), 2 bf16 ulps of the output scale (float32
sums in another order round a few bf16 intermediates the other way); its
OPT mode (ReLU, q/k/v packed as one projection) at OPT-1.3B's width
(D=2048, 32 heads, ffn 8192, XI=512), 1 and 2 layers, to the same 2 ulps. The
beam kernels (``decode_attention_beam``, the megakernel's beam mode) are
held to the same tolerances at the beam path's shapes (96 rows in families
of 3, 160 in families of 5, a 128-slot cache, a 68-slot ancestry table).
Both decode attention kernels also at head widths 16 and 32 (the
test-scale models') and 80 and 128 (opt-2.7b's and opt-6.7b's, at their
trunks' 32 heads; the megakernel's self-attention, fused_attention and the
streaming kernel at those two widths too, a width of 96 refused by all
three), and at kv_limit 1, 63, 64, 65, 127, 128,
129 and 192 (greedy at flamingo-mini's and OPT-1.3B's shapes), with the
live prefix ending on each side of every split boundary of their plan, a
row whose [npad, cur] is empty and one whose first split is masked; under
layouts of 2, 3 and 8 splits and at a 1,000-slot prefix (the combine
launch); and bit-equal on a repeated call.
The attention kernels of the use_pallas path (``fused_attention``, its
streaming kernel, ``fused_media_xattn``) are held at the ViT, resampler,
GPT-2 forward, media prefill and forward shapes, with fully masked rows
(left-padded causal queries, text_time past the media count) and rows
zeroed (text_time 0): float32 within 1e-5 of the output's scale, bf16
within 2 bf16 ulps; the bf16 kernel of the first two (the Hopper tile) also
at its tile edges, back to back on one stream, and streaming past many
tiles of its ring. The megakernel's w8a8 mode (act_quant, the same Hopper
kernel): its linear alone, through the kernel's own machinery with a
one-linear schedule, bitwise equal to the plain version (column form at K
= 512, 1024, 2048; row form over D-wide slices of 4096 and 8192 and of K
= 512; b in {1, 3, 8, 32}, a zero row and .5 rounding boundaries
planted); the whole step at 2 layers (greedy at flamingo-mini width, beams
at 96 rows, OPT-1.3B width) within the larger of 1e-2 and 1.25 x the
plain version's CPU-vs-card spread, normwise, the deep checks' rule, and
bit for bit (the mode sums its attention in float64 and its LayerNorm in
the plain version's order); at the weight-only mode's edge rows, back to
back and on two streams bit for bit equal to the plain version, and two
launches bit-equal; its shared-memory formula equal to its mirror; its
section timer counting every block. A trunk too wide for the kernel
(D=8192: its LayerNorm rows do not fit its registers) raises ValueError
before vision and prefill in both modes; at D=4096 both modes take 27 to
2,048 rows. The fused head (lm_head_argmax) at its edges (rows around its
groups, ties across tiles, rounds and blocks, n_valid on a tile's edge) at
D=1024 and 2048, at a K tail (D=1040) and past one staged slice (D=8192),
and at widths of no model (40, 1000, 1001, 6208): picks within 1 bf16 ulp
of the plain version's; its shared-memory mirror equal to the kernel's.
The weight-only mode's Hopper kernel (decode_megakernel_sm90.cuh) at its
edges: its own grid barrier alone, rows on both sides of its wgmma N steps,
of its wide mode (past 64 rows) and of its 256-row passes (b in {1, 3, 8, 9,
31, 32, 33, 64, 65, 256, 257}) over a one-slot cache with left-padded rows
and two live prefixes, at D=1024 and 2048, within 2 bf16 ulps; four shapes
back to back on one stream; two launches on the same inputs bit-equal;
launches taking turns on two streams bit-equal to one stream's. The stream probe's kernel within 1e-5 relative of its plain
version. The in-situ decode probe's three stream kernels bit for bit
against their plain versions (which sum in the kernels' order) at the
probe's shape and the kernel's edges (b 1 and 3, D 40 and 2048, block_t 1,
3, 24 and 256, a long cache walked in windows), and each
probe loop replayed as a CUDA graph bit for bit against the same loop run
eagerly. The logits chain on the card against the same chain on the CPU:
each warper's mask identical but in rows whose cut a 1e-4 relative move of
its parameter moves on the CPU, kept values within 1e-6 relative, every
processor at once identical masks; top-k sampling on the megakernel, one
launch a step and no fused head, bit-equal under one seed; plain greedy
keeping its fused head on both decode paths, a processor or scores turning
it off. The random trunks and inputs are chip_smoke.py's.
"""
import numpy as np
import pytest
import torch

from flamingo_mini_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_beam, decode_attention_beam_plain,
    decode_attention_plain)
from flamingo_mini_tpu_torch.ops.lm_head import (lm_head_argmax,
                                                 lm_head_argmax_plain,
                                                 pad_head_weights)
from flamingo_mini_tpu_torch.ops.megadecode import decode_step_megakernel, max_rows

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulps(ref: np.ndarray, n: int) -> float:
    return n * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


# the live prefixes the kernels' tests cover: around 64-slot multiples and
# the cache's end
EDGE_LIMITS = (1, 63, 64, 65, 127, 128, 129, 192)
# (b, D, n_head, cache slots): flamingo-mini, OPT-1.3B
ATTN_SHAPES = {"flamingo-mini": (32, 1024, 16, 192), "opt-1.3b": (8, 2048, 32, 128)}


def _plan(rows: int, n_head: int, kb: int, kv_limit: int, T: int, itemsize: int):
    from flamingo_mini_tpu_torch.ops.decode_attention import plan
    return plan(rows, n_head, min(kv_limit, T), itemsize, kb=kb, beam=kb > 1)


def _worst(got, want, dtype, label):
    """Assert the kernel's tolerance -> (error, where: (row, value))."""
    want = want.float()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    where = tuple(int(i) for i in np.unravel_index(int(diff.argmax()), diff.shape))
    tol = 1e-5 if dtype == torch.float32 else _bf16_ulps(want.cpu().numpy(), 2)
    assert bool(torch.isfinite(got).all()), label
    assert err <= tol, (label, err, tol, where)
    return err, where


# (kv_limit, cur): live prefixes the flamingo-mini decode reaches, then the
# edge limits with cur at their last slot
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_limit,cur", [(36, 4), (68, 35), (132, 131)]
                         + [(k, k - 1) for k in EDGE_LIMITS])
@pytest.mark.parametrize("shape", sorted(ATTN_SHAPES))
def test_decode_attention_kernel_matches_plain(cuda, shape, dtype, kv_limit, cur):
    """At each side of every split boundary, with masked rows and splits."""
    import chip_smoke
    b, D, n_head, T = ATTN_SHAPES[shape]
    rs = np.random.RandomState(kv_limit)
    q, k, v = (torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32)
               .to(cuda, dtype) for s in ((b, D), (T, b, D), (T, b, D)))
    p = _plan(b, n_head, 1, kv_limit, T, q.element_size())
    for c, npad in chip_smoke.attention_edge_cases(b, 1, kv_limit, cur, T, p):
        npad = torch.tensor(npad, dtype=torch.int32, device=cuda)
        before = decode_attention.launches
        got = decode_attention(q, k, v, npad, c, n_head=n_head, scale=0.125,
                               kv_limit=kv_limit)
        want = decode_attention_plain(q, k, v, npad, c, n_head=n_head,
                                      scale=0.125, kv_limit=kv_limit)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        _worst(got, want, dtype, (shape, kv_limit, c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernels_are_deterministic(cuda, dtype):
    """Two calls on the same inputs give equal bits, both kernels, at the
    main path's shapes, and under a plan of three splits (the partials fold
    in split order)."""
    b, D, n_head, T = ATTN_SHAPES["flamingo-mini"]
    rs = np.random.RandomState(5)
    q, k, v = (torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32)
               .to(cuda, dtype) for s in ((b, D), (T, b, D), (T, b, D)))
    npad = torch.tensor(np.arange(b) % 4, dtype=torch.int32, device=cuda)
    kw = dict(n_head=n_head, scale=0.125, kv_limit=132)
    first = decode_attention(q, k, v, npad, 131, **kw)
    assert torch.equal(first, decode_attention(q, k, v, npad, 131, **kw))
    from flamingo_mini_tpu_torch.ops import decode_attention as da
    p = da.make_plan(b, n_head, 132, q.element_size(), kb=1, beam=False, heads=2, splits=3)
    first = da._launch(q, k, v, npad, None, 131, n_head=n_head, scale=0.125, kb=1,
                       t_lim=132, p=p)
    assert torch.equal(first, da._launch(q, k, v, npad, None, 131, n_head=n_head,
                                         scale=0.125, kb=1, t_lim=132, p=p))
    for rows, kb in ((96, 3), (160, 5)):
        q, k, v, anc, npad = _beam_attention_inputs(cuda, dtype, seed=rows, rows=rows,
                                                    kb=kb)
        kw = dict(n_head=16, scale=0.125, kb=kb, kv_limit=68)
        first = decode_attention_beam(q, k, v, anc, npad, 66, **kw)
        assert torch.equal(first, decode_attention_beam(q, k, v, anc, npad, 66, **kw))


# (heads, splits): layouts the decode paths' shapes do not pick (their whole
# slab fits one resident wave unsplit), as longer prefixes take them
SPLIT_PLANS = ((1, 2), (2, 3), (4, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["greedy", "beam"])
def test_decode_attention_split_plans_match_plain(cuda, kernel, dtype):
    """Split plans (the combine launch) at each side of every split
    boundary, with masked rows and splits, greedy at b=32 (kv_limit 129)
    and beams at 96 rows (kv_limit 68); then the plan a long prefix picks
    (b=8, 1,000 of 1,024 slots) through the wrapper."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops import decode_attention as da
    if kernel == "greedy":
        rows, kb, T, kv_limit = 32, 1, 192, 129
        rs = np.random.RandomState(129)
        q, k, v = (torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32)
                   .to(cuda, dtype) for s in ((rows, 1024), (T, rows, 1024), (T, rows, 1024)))
        anc = None
    else:
        rows, kb, T, kv_limit = 96, 3, 128, 68
        q, k, v, anc, _npad = _beam_attention_inputs(cuda, dtype, seed=68)
    kw = dict(n_head=16, scale=0.125, kv_limit=kv_limit)
    for heads, splits in SPLIT_PLANS:
        p = da.make_plan(rows, 16, kv_limit, q.element_size(), kb=kb, beam=kb > 1,
                         heads=heads, splits=splits)
        assert p.splits > 1
        for c, npad in chip_smoke.attention_edge_cases(rows, kb, kv_limit, kv_limit - 1, T, p):
            npad = torch.tensor(npad, dtype=torch.int32, device=cuda)
            got = da._launch(q, k, v, npad, anc, c, n_head=16, scale=0.125, kb=kb,
                             t_lim=kv_limit, p=p)
            if anc is None:
                want = decode_attention_plain(q, k, v, npad, c, **kw)
            else:
                want = decode_attention_beam_plain(q, k, v, anc, npad, c, kb=kb, **kw)
            torch.cuda.synchronize()
            _worst(got, want, dtype, (kernel, p, c))
    if kernel == "greedy":
        rs = np.random.RandomState(1000)
        q, k, v = (torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32)
                   .to(cuda, dtype) for s in ((8, 1024), (1024, 8, 1024), (1024, 8, 1024)))
        p = _plan(8, 16, 1, 1000, 1024, q.element_size())
        assert p.splits > 1
        for c, npad in chip_smoke.attention_edge_cases(8, 1, 1000, 999, 1024, p):
            npad = torch.tensor(npad, dtype=torch.int32, device=cuda)
            got = decode_attention(q, k, v, npad, c, n_head=16, scale=0.125, kv_limit=1000)
            want = decode_attention_plain(q, k, v, npad, c, n_head=16, scale=0.125,
                                          kv_limit=1000)
            torch.cuda.synchronize()
            _worst(got, want, dtype, ("long prefix", p, c))


def test_lm_head_kernel_matches_plain(cuda):
    """flamingo-mini head shape, with a planted exact tie across chunks."""
    V, D, B = 50258, 1024, 32
    rs = np.random.RandomState(4)
    w8 = rs.randint(-127, 128, (V, D)).astype(np.int8)
    scale = (np.abs(rs.randn(V)) * 0.01 + 1e-4).astype(np.float32)
    x = (rs.randn(B, D) * 0.1).astype(np.float32)
    x[0] = 0.0
    x[0, :8] = 1.0 / 127          # row 0: vocab rows 7 and 40000 tie at the top
    w8[[7, 40000], :8] = 127
    scale[[7, 40000]] = 1.0
    head = pad_head_weights({"w8": torch.tensor(w8).to(cuda),
                             "scale": torch.tensor(scale).to(cuda)}, 2048)
    xt = torch.tensor(x).to(cuda, torch.bfloat16)
    before = lm_head_argmax.launches
    got = lm_head_argmax(head["w8"], head["scale"], xt, n_valid=V)
    want = lm_head_argmax_plain(head["w8"], head["scale"], xt, n_valid=V)
    torch.cuda.synchronize()
    assert lm_head_argmax.launches == before + 1
    assert int(got[0]) == 7
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("head_dim", [16, 32])
@pytest.mark.parametrize("kb", [1, 3])
def test_decode_attention_narrow_heads_match_plain(cuda, kb, head_dim):
    """The test-scale models' head widths (16: the export example's and the
    fidelity tool's smoke model), greedy (8 rows) and beams (4 families of
    3), 4 heads, at the edges and split layouts of ``chip_smoke.py``'s
    ``attention_edges``, which asserts the tolerances."""
    import chip_smoke
    rows, T = (8, 192) if kb == 1 else (12, 128)
    edges = chip_smoke.attention_edges(cuda, rows, kb, 4 * head_dim, T, seed=head_dim,
                                       head_dim=head_dim)
    assert set(edges) == {str(torch.float32), str(torch.bfloat16)}


@pytest.mark.parametrize("head_dim", [80, 128])
@pytest.mark.parametrize("kb", [1, 3])
def test_decode_attention_wide_heads_match_plain(cuda, kb, head_dim):
    """opt-2.7b's and opt-6.7b's head widths at their trunks' shapes (32
    heads, 8 greedy rows or 8 families of 3, a 128-slot cache), at the edges
    and split layouts of ``chip_smoke.py``'s ``attention_edges``, which
    asserts the tolerances; each call through the wrapper one launch."""
    import chip_smoke
    rows = 8 * kb
    kernel = decode_attention if kb == 1 else decode_attention_beam
    before = kernel.launches
    edges = chip_smoke.attention_edges(cuda, rows, kb, 32 * head_dim, 128, seed=head_dim,
                                       head_dim=head_dim)
    assert set(edges) == {str(torch.float32), str(torch.bfloat16)}
    assert kernel.launches > before


def test_kernels_refuse_bad_input(cuda):
    q = torch.zeros((2, 192), device=cuda)
    kv = torch.zeros((64, 2, 192), device=cuda)
    npad = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):       # head dim 96: not 16, 32, 64, 80 or 128
        decode_attention(q, kv, kv, npad, 3, n_head=2, scale=1.0)
    with pytest.raises(ValueError):       # float32 hidden rows
        lm_head_argmax(torch.zeros((2048, 256), dtype=torch.int8, device=cuda),
                       torch.zeros((1, 2048), device=cuda),
                       torch.zeros((2, 256), device=cuda), n_valid=2000)


# the small width keeps head dim 64 (the kernel's) with fewer heads
MEGA_WIDTHS = {"small": dict(D=256, H=4, XI=128, XH=2, n_visual=16),
               "full": dict()}


def _mega(cuda, width, *, n_layer, xattn_every, b, seed):
    """chip_smoke.py's random trunk and one step's inputs at this width."""
    import chip_smoke
    dims = MEGA_WIDTHS[width]
    cfg, packed = chip_smoke.random_trunk(cuda, n_layer=n_layer,
                                          xattn_every=xattn_every, seed=seed, **dims)
    T, NMNV = (64, 16) if width == "small" else (192, 64)
    return cfg, packed, chip_smoke.mega_inputs(cuda, cfg, b, seed, T=T, NMNV=NMNV)


@pytest.mark.parametrize("b", [1, 3, 32])
@pytest.mark.parametrize("width", ["small", "full"])
def test_megakernel_matches_plain(cuda, width, b):
    """2 layers, xattn on the first only at the small width (the ragged
    schedule) and on both at full width; a left-padded row, a row with no
    image (b > 1), the live prefix ending before the cache does."""
    import chip_smoke
    cfg, packed, inputs = _mega(cuda, width, n_layer=2, b=b, seed=b,
                                xattn_every=2 if width == "small" else 1)
    cur, kv_limit = (35, 40) if width == "small" else (131, 132)
    before = decode_step_megakernel.launches
    errs = chip_smoke.mega_errors(cfg, packed, inputs, cur, kv_limit)
    assert decode_step_megakernel.launches == before + 1
    for name, (got, want) in errs.items():
        assert bool(torch.isfinite(got).all()), name
        err = float((got - want).abs().max())
        assert err <= 2 * 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7), \
            (name, err)


@pytest.mark.parametrize("b", [3, 8])
@pytest.mark.parametrize("n_layer", [1, 2])
def test_megakernel_opt_mode_matches_plain(cuda, n_layer, b):
    """xattn before the first layer only, a left-padded row, a row with no
    image, the greedy OPT-1.3B loop's last step (cur 70, kv_limit 71)."""
    import chip_smoke
    cfg, packed = chip_smoke.random_trunk(
        cuda, n_layer=n_layer, xattn_every=2, seed=b + n_layer, family="opt",
        D=chip_smoke.OPT_D, H=chip_smoke.OPT_H)
    inputs = chip_smoke.mega_inputs(cuda, cfg, b, seed=b, T=chip_smoke.OPT_T)
    before = decode_step_megakernel.launches
    errs = chip_smoke.mega_errors(cfg, packed, inputs, 70, 71)
    assert decode_step_megakernel.launches == before + 1
    chip_smoke.held_to_ulps(f"OPT mode layers={n_layer} b={b}", errs, [0.0, 0.0, None])


# (D, heads) of a small OPT trunk at each wide head width; xattn 2 heads of 64
WIDE_MEGA = {80: (320, 4), 128: (256, 2)}


@pytest.mark.parametrize("act_quant", [False, True], ids=["weight-only", "w8a8"])
@pytest.mark.parametrize("rows,kb", [(3, 1), (8, 1), (24, 3)])
@pytest.mark.parametrize("head_dim", [80, 128])
def test_megakernel_wide_heads_match_plain(cuda, head_dim, rows, kb, act_quant):
    """The OPT mode with self-attention heads 80 and 128 wide (xattn's 64),
    2 layers with xattn on the first, greedy and 3 beams (lazy ancestry),
    the live prefix ending before the cache: weight-only within 2 bf16
    ulps, w8a8 bit for bit its plain version; one launch a call."""
    import chip_smoke
    D, H = WIDE_MEGA[head_dim]
    cfg, packed = chip_smoke.random_trunk(
        cuda, n_layer=2, xattn_every=2, seed=head_dim + rows, family="opt", D=D, H=H,
        XI=128, XH=2, n_visual=16)
    inputs = list(chip_smoke.mega_inputs(cuda, cfg, rows, seed=rows, T=64, NMNV=16))
    anc = None
    if kb > 1:
        inputs[5] = chip_smoke.family_npad(cuda, rows // kb, kb)
        anc = chip_smoke.random_ancestry(cuda, rows // kb, kb, seed=rows, anc_len=64)
    before = decode_step_megakernel.launches
    errs = chip_smoke.mega_errors(cfg, packed, inputs, 35, 40, beam_anc=anc,
                                  act_quant=act_quant)
    assert decode_step_megakernel.launches == before + 1
    chip_smoke.held_to_ulps(f"heads of {head_dim} rows={rows}", errs, [0.0, 0.0, None])
    for name, (got, want) in errs.items():
        assert not act_quant or torch.equal(got, want), (name, "not bit-equal")


def test_megakernel_refuses_bad_input(cuda):
    cfg, packed, inputs = _mega(cuda, "small", n_layer=1, xattn_every=1, b=2,
                                seed=0)
    names = ("xk", "xv", "kc", "vc", "x_emb", "npad", "text_time")

    def call(cur=5, config=cfg, **over):
        args = [over.get(n, t) for n, t in zip(names, inputs)]
        return decode_step_megakernel(packed, *args, cur, config=config)

    call()                                   # the unchanged inputs run
    xk, xv, kc, vc, x, npad, tt = inputs
    bad = [dict(x_emb=x.float()),                              # dtype
           dict(npad=npad.cpu()),                              # device
           dict(kc=kc[:, :32].contiguous()),                   # shape
           dict(vc=vc.transpose(2, 3).contiguous().transpose(2, 3)),  # layout
           dict(text_time=tt.to(torch.int64)),                 # dtype
           dict(cur=64)]                                       # past the cache
    for over in bad:
        with pytest.raises(ValueError):
            call(**over)
    narrow = type(cfg)(**{**cfg.__dict__, "xattn_heads": 4, "xattn_dim_head": 32})
    with pytest.raises(ValueError):          # xattn head dim 32: not the kernel's 64
        call(config=narrow)


# ---------------------------------------------------------------------------
# beams
# ---------------------------------------------------------------------------


def _beam_attention_inputs(cuda, dtype, seed, rows=96, kb=3):
    """``rows`` rows in families of ``kb`` (96 in 32 of 3 unless said),
    D=1024, H=16, a 128-slot cache, a random valid 68-slot ancestry table,
    families left-padded by 0-3 slots."""
    import chip_smoke
    T, D = 128, 1024
    rs = np.random.RandomState(seed)
    q, k, v = (torch.tensor(rs.randn(*s) * 0.3, dtype=torch.float32)
               .to(cuda, dtype) for s in ((rows, D), (T, rows, D), (T, rows, D)))
    return (q, k, v, chip_smoke.random_ancestry(cuda, rows // kb, kb, seed),
            chip_smoke.family_npad(cuda, rows // kb, kb))


# (kv_limit, cur): the beam loop's segments end at 37 and 68; cur 2 leaves
# the families padded by 3 nothing to attend; cur 127 is past the table;
# then the edge limits (past the 128-slot cache: 128) with cur at their
# last slot
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_limit,cur", [(37, 4), (68, 66), (37, 2), (128, 127)]
                         + [(k, min(k, 128) - 1) for k in EDGE_LIMITS])
@pytest.mark.parametrize("rows,kb", [(96, 3), (160, 5)])
def test_decode_attention_beam_kernel_matches_plain(cuda, rows, kb, dtype, kv_limit, cur):
    """At each side of every split boundary, with masked rows and splits."""
    import chip_smoke
    q, k, v, anc, _npad = _beam_attention_inputs(cuda, dtype, seed=cur, rows=rows, kb=kb)
    kw = dict(n_head=16, scale=0.125, kb=kb, kv_limit=kv_limit)
    p = _plan(rows, 16, kb, kv_limit, 128, q.element_size())
    for c, npad in chip_smoke.attention_edge_cases(rows, kb, kv_limit, cur, 128, p):
        npad = torch.tensor(npad, dtype=torch.int32, device=cuda)
        before = decode_attention_beam.launches
        got = decode_attention_beam(q, k, v, anc, npad, c, **kw)
        want = decode_attention_beam_plain(q, k, v, anc, npad, c, **kw)
        torch.cuda.synchronize()
        assert decode_attention_beam.launches == before + 1
        _worst(got, want, dtype, (rows, kv_limit, c))


def test_decode_attention_beam_reads_only_ancestors(cuda):
    """Cache entries that no beam's ancestry names in [npad, cur], and
    slots past cur, hold NaN: the kernel never reads them."""
    q, k, v, anc, npad = _beam_attention_inputs(cuda, torch.bfloat16, seed=9)
    cur = 50
    kw = dict(n_head=16, scale=0.125, kb=3, kv_limit=68)
    ref = decode_attention_beam(q, k, v, anc, npad, cur, **kw)
    t = torch.arange(128, device=cuda)
    a = torch.nn.functional.pad(anc, (0, 60))                  # (32, 3, 128)
    named = torch.zeros((32, 3, 128), dtype=torch.bool, device=cuda)
    ok = (t <= cur) & (t >= npad.view(32, 3)[:, :1, None])     # (32, 1, 128)
    for j in range(3):
        named[:, j] = ((a == j) & ok).any(dim=1)
    dead = ~named.reshape(96, 128).t()                          # (T, rows)
    for c in (k, v):
        c[dead] = float("nan")
    got = decode_attention_beam(q, k, v, anc, npad, cur, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, ref)


@pytest.mark.parametrize("rows,kb", [(3, 3), (96, 3), (160, 5)])
def test_megakernel_beam_matches_plain(cuda, rows, kb):
    """Flamingo-mini width, 2 layers with xattn, beam mode: hidden row and
    written K/V rows within 2 bf16 ulps, at rows up to 160 (32 x 5 beams)."""
    import chip_smoke
    cfg, packed = chip_smoke.random_trunk(cuda, n_layer=2, xattn_every=1, seed=rows)
    inputs, anc = chip_smoke.beam_trunk_inputs(cuda, cfg, rows, kb, seed=rows)
    for cur, kv_limit in ((35, 37), (66, 68)):
        before = decode_step_megakernel.launches
        errs = chip_smoke.mega_errors(cfg, packed, inputs, cur, kv_limit, beam_anc=anc)
        assert decode_step_megakernel.launches == before + 1
        for name, (got, want) in errs.items():
            assert bool(torch.isfinite(got).all()), name
            err = float((got - want).abs().max())
            assert err <= 2 * 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7), \
                (name, cur, err)


def test_beam_kernels_refuse_bad_ancestry(cuda):
    import chip_smoke
    q, k, v, anc, npad = _beam_attention_inputs(cuda, torch.bfloat16, seed=1)
    kw = dict(n_head=16, scale=0.125, kb=3)
    cfg, packed = _mega(cuda, "small", n_layer=1, xattn_every=1, b=6, seed=0)[:2]
    inputs, manc = chip_smoke.beam_trunk_inputs(cuda, cfg, 6, 3, seed=0)
    for bad in (anc.long(), anc[:16], anc.reshape(48, 2, -1)):
        with pytest.raises(ValueError):
            decode_attention_beam(q, k, v, bad, npad, 5, **kw)
    for bad in (manc.long(), manc[:1], manc.reshape(2, 3, 2, -1), manc.cpu(),
                manc.transpose(0, 1)):
        with pytest.raises(ValueError):
            decode_step_megakernel(packed, *inputs, 5, config=cfg, beam_anc=bad)


def test_megakernel_refuses_rows_past_its_limit(cuda):
    """Past its row limit the megakernel raises, naming the limit; it never
    takes another path."""
    cfg, packed, inputs = _mega(cuda, "small", n_layer=1, xattn_every=1, b=2, seed=0)
    limit = max_rows(packed, cfg)
    x = torch.zeros((limit + 1, 256), dtype=torch.bfloat16, device=cuda)
    before = decode_step_megakernel.launches
    with pytest.raises(ValueError, match=str(limit)):
        decode_step_megakernel(packed, inputs[0], inputs[1], inputs[2], inputs[3],
                               x, inputs[5], inputs[6], 5, config=cfg)
    assert decode_step_megakernel.launches == before


# ---------------------------------------------------------------------------
# the attention kernels of the use_pallas path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["vit", "resampler", "gpt2 forward"])
def test_fused_attention_kernel_matches_plain(cuda, dtype, shape):
    """The ViT, resampler and GPT-2 forward shapes; the forward causal with
    two rows left-padded by 8, whose pad queries are fully masked (bf16:
    -inf before them, float32 min after)."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_plain)
    b, h, n_q, n_kv = chip_smoke.ATT_SHAPES[shape]
    q, k, v = chip_smoke.attention_inputs(cuda, dtype, b, h, n_q, n_kv, seed=3)
    kw = dict(scale=0.125)
    if shape == "gpt2 forward":
        kw.update(causal=True, row_bias=chip_smoke.left_pad_bias(
            cuda, dtype, b, n_q, [8, 8] + [0] * (b - 2)))
    before = fused_attention.launches
    got = fused_attention(q, k, v, **kw)
    assert fused_attention.launches == before + 1
    chip_smoke.held_to_plain(f"fused_attention {shape} {dtype}", got,
                             fused_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_kernel_bias_and_ragged_rows(cuda, dtype):
    """A full (b, h, n_q, n_kv) bias broadcast from (b, 1, n_q, n_kv), a row
    bias and causal together, n_q and n_kv not tile multiples."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_plain)
    b, h, n_q, n_kv = 3, 2, 70, 100
    q, k, v = chip_smoke.attention_inputs(cuda, dtype, b, h, n_q, n_kv, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(5)
    bias = torch.randn((b, 1, n_q, n_kv), generator=gen, device=cuda).to(dtype)
    kw = dict(scale=0.3, bias=bias, causal=True,
              row_bias=chip_smoke.left_pad_bias(cuda, dtype, b, n_kv, [0, 5, 90]))
    chip_smoke.held_to_plain(f"fused_attention with bias {dtype}",
                             fused_attention(q, k, v, **kw),
                             fused_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel_matches_plain(cuda, dtype, causal):
    """(2, 16, 4000, 64): 4000 keys pad to 4096 (blocks of 256); row 0 is
    left-padded by 8. fused_attention dispatches to it past 2048 keys."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        flash_attention, flash_attention_plain, fused_attention)
    b, h, n = chip_smoke.FLASH_SHAPE
    q, k, v = chip_smoke.attention_inputs(cuda, dtype, b, h, n, n, seed=6)
    kw = dict(scale=0.125, causal=causal,
              row_bias=chip_smoke.left_pad_bias(cuda, dtype, b, n, [8, 0]))
    before = (flash_attention.launches, fused_attention.launches)
    got = fused_attention(q, k, v, **kw)
    assert (flash_attention.launches, fused_attention.launches) == \
        (before[0] + 1, before[1])
    chip_smoke.held_to_plain(f"flash_attention causal={causal} {dtype}", got,
                             flash_attention_plain(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8, 64, 65, 257])
@pytest.mark.parametrize("head_dim", [80, 128])
def test_fused_attention_wide_heads_match_plain(cuda, head_dim, n, dtype):
    """opt-2.7b's and opt-6.7b's trunk attention in the use_pallas forward
    ((8, 32, n, head_dim), causal, two rows left-padded) and a contiguous
    layout with a bias; one launch a call, within the tolerances."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_plain)
    q, k, v = chip_smoke.attention_inputs(cuda, dtype, 8, 32, n, n, seed=n,
                                          head_dim=head_dim)
    gen = torch.Generator(device=cuda).manual_seed(n)
    for label, (qq, kk, vv, kw) in {
            "causal left-padded": (q, k, v, dict(
                scale=head_dim ** -0.5, causal=True, row_bias=chip_smoke.left_pad_bias(
                    cuda, dtype, 8, n, [min(2, n - 1)] * 2 + [0] * 6))),
            "contiguous, bias": (q.contiguous(), k.contiguous(), v.contiguous(), dict(
                scale=head_dim ** -0.5, bias=torch.randn((8, 1, n, n), generator=gen,
                                                         device=cuda)))}.items():
        before = fused_attention.launches
        got = fused_attention(qq, kk, vv, **kw)
        assert fused_attention.launches == before + 1
        chip_smoke.held_to_plain(f"fused_attention heads of {head_dim} {label} {dtype}",
                                 got, fused_attention_plain(qq, kk, vv, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [80, 128])
def test_flash_attention_wide_heads_match_plain(cuda, head_dim, dtype):
    """The streaming kernel at (1, 32, 4000, head_dim), causal, left-padded
    by 8: one launch, within the tolerances."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        flash_attention, flash_attention_plain)
    b, h, n = chip_smoke.WIDE_FLASH
    q, k, v = chip_smoke.attention_inputs(cuda, dtype, b, h, n, n, seed=head_dim,
                                          head_dim=head_dim)
    kw = dict(scale=head_dim ** -0.5, causal=True,
              row_bias=chip_smoke.left_pad_bias(cuda, dtype, b, n, [8]))
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    chip_smoke.held_to_plain(f"flash_attention heads of {head_dim} {dtype}", got,
                             flash_attention_plain(q, k, v, **kw), dtype)


def test_attention_kernels_refuse_an_untaken_head_width(cuda):
    """Head width 96 (no kernel takes it) raises on the card and never runs
    plain, in fused_attention, flash_attention and the megakernel."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.fused_attention import flash_attention, fused_attention
    q = torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16, device=cuda)
    for fn in (fused_attention, flash_attention):
        with pytest.raises(ValueError, match="96"):
            fn(q, q, q, scale=0.1)
    cfg, packed = chip_smoke.random_trunk(cuda, n_layer=1, xattn_every=1, seed=1,
                                          family="opt", D=192, H=2, XI=128, XH=2,
                                          n_visual=16)
    inputs = chip_smoke.mega_inputs(cuda, cfg, 2, seed=1, T=64, NMNV=16)
    with pytest.raises(ValueError, match="self-attention"):
        decode_step_megakernel(packed, *inputs, 3, config=cfg, kv_limit=8)


@pytest.mark.parametrize("n_kv", [1, 63, 64, 65, 127, 128, 129, 257])
@pytest.mark.parametrize("case", ["plain", "contiguous", "causal left-padded", "bias"])
def test_hopper_tile_edges_match_plain(cuda, case, n_kv):
    """The bf16 kernel (csrc/attention_sm90.cuh) at its tile edges: n_q in
    {1, 65, 129, 257} against n_kv around the 128-key tile and the 16- and
    64-key last tiles; split_heads views or contiguous inputs; causal with
    a left-padded row; a (b, 1, n_q, n_kv) bias."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        fused_attention, fused_attention_plain)
    gen = torch.Generator(device=cuda).manual_seed(n_kv)
    for n_q in (1, 65, 129, 257):
        q, k, v = chip_smoke.attention_inputs(cuda, torch.bfloat16, 2, 3, n_q, n_kv,
                                              seed=n_q + n_kv)
        kw = dict(scale=0.125)
        if case == "contiguous":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        elif case == "causal left-padded":
            kw.update(causal=True, row_bias=chip_smoke.left_pad_bias(
                cuda, torch.bfloat16, 2, n_kv, [min(5, n_kv - 1), 0]))
        elif case == "bias":
            kw["bias"] = torch.randn((2, 1, n_q, n_kv), generator=gen, device=cuda)
        chip_smoke.held_to_plain(f"fused_attention {case} (2, 3, {n_q}, {n_kv})",
                                 fused_attention(q, k, v, streaming=False, **kw),
                                 fused_attention_plain(q, k, v, **kw), torch.bfloat16)


def test_hopper_tile_back_to_back_and_long_stream(cuda):
    """Five shapes launched back to back on one stream before one
    synchronize (the last streams 5000 keys), and the streaming kernel at
    3000 keys (24 tiles, many times the ring's depth), causal with a
    left-padded row."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.fused_attention import (
        flash_attention, flash_attention_plain, fused_attention, fused_attention_plain)
    ins = [chip_smoke.attention_inputs(cuda, torch.bfloat16, *shape, seed=i)
           for i, shape in enumerate(chip_smoke.SM90_BACK_TO_BACK)]
    outs = [fused_attention(q, k, v, scale=0.125) for q, k, v in ins]
    for (q, k, v), got in zip(ins, outs):
        plain = flash_attention_plain if k.shape[2] > 2048 else fused_attention_plain
        chip_smoke.held_to_plain(f"back to back {tuple(k.shape)}", got,
                                 plain(q, k, v, scale=0.125), torch.bfloat16)
    q, k, v = chip_smoke.attention_inputs(cuda, torch.bfloat16, 1, 2, 100, 3000, seed=3)
    kw = dict(scale=0.125, causal=True,
              row_bias=chip_smoke.left_pad_bias(cuda, torch.bfloat16, 1, 3000, [8]))
    chip_smoke.held_to_plain("flash_attention 3000 keys", flash_attention(q, k, v, **kw),
                             flash_attention_plain(q, k, v, **kw), torch.bfloat16)


@pytest.mark.parametrize("lm", ["gpt2", "opt"])
def test_pallas_trunk_forward_under_inference_mode(cuda, lm):
    """The uncached bf16 use_pallas trunk with a left-padded row, head dim
    64, 2 layers: under torch.inference_mode() (whose tensors carry no
    version counter) it launches fused_attention once per layer and gives
    the same hidden states as under torch.no_grad()."""
    from flamingo_mini_tpu_torch import FlamingoConfig
    from flamingo_mini_tpu_torch.models import gpt2, opt
    from flamingo_mini_tpu_torch.ops.fused_attention import fused_attention
    from flamingo_mini_tpu_torch.ops.layers import Policy
    gen = torch.Generator(device=cuda).manual_seed(11)
    if lm == "gpt2":
        arch = FlamingoConfig(lm_arch_overrides=dict(
            vocab_size=256, n_positions=64, n_embd=128, n_layer=2, n_head=2)).lm_arch
        params, apply = gpt2.init_gpt2(gen, arch), gpt2.apply_gpt2
    else:
        arch = FlamingoConfig(lm="facebook/opt-1.3b", lm_arch_overrides=dict(
            vocab_size=256, max_position_embeddings=64, hidden_size=128, ffn_dim=512,
            num_hidden_layers=2, num_attention_heads=2, word_embed_proj_dim=128)).lm_arch
        params, apply = opt.init_opt(gen, arch), opt.apply_opt
    ids = torch.randint(0, 256, (4, 40), generator=gen, device=cuda)
    mask = torch.ones((4, 40), dtype=torch.int32, device=cuda)
    mask[1, :9] = 0
    kw = dict(arch=arch, policy=Policy(torch.bfloat16, pallas=True), attention_mask=mask)
    with torch.no_grad():
        want, _ = apply(params, ids, **kw)
    before = fused_attention.launches
    with torch.inference_mode():
        got, _ = apply(params, ids, **kw)
    assert fused_attention.launches == before + 2
    assert bool(torch.isfinite(got.float()).all())
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["prefill", "forward", "two images", "n_q 5", "n_q 17",
                                   "13 images", "20 images"])
def test_media_xattn_kernel_matches_plain(cuda, dtype, shape):
    """text_time 0 (rows zeroed), in range, and past the media count (rows
    fully masked: the mean of V), a 16-row slice spanning two media and a
    slice all 0 (chip_smoke.MEDIA_MIXES); one launch a call; bf16 runs the
    Hopper kernel, float32 the mma.sync tile; two calls bit-equal. 13 and 20
    images (832 and 1,280 keys) take the bf16 kernel past its 16 slots:
    resident where a block's rows attend few media, streamed where they
    attend many or lie past the media count, in two windows at 20."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.media_xattn import (
        fused_media_xattn, fused_media_xattn_plain)
    b, n_q, n_media = {**chip_smoke.MEDIA_SHAPES, **chip_smoke.MEDIA_EDGE_SHAPES}[shape]
    q, k, v = chip_smoke.attention_inputs(cuda, dtype, b, 8, n_q, 64 * n_media, seed=7)
    for mix in chip_smoke.MEDIA_MIXES:
        tt = chip_smoke.media_mix(cuda, mix, b, n_q, n_media, seed=8)
        before = fused_media_xattn.launches
        got = fused_media_xattn(q, k, v, tt, scale=1.0, n_visual=64)
        assert fused_media_xattn.launches == before + 1
        chip_smoke.held_to_plain(f"fused_media_xattn {shape} {mix} {dtype}", got,
                                 fused_media_xattn_plain(q, k, v, tt, scale=1.0,
                                                         n_visual=64), dtype)
        past = ((tt > n_media) | (tt < 0))[:, None, :, None].expand_as(got)
        if bool(past.any()):
            mean_v = v.float().mean(dim=2, keepdim=True).expand_as(got)
            chip_smoke.held_to_plain("rows past the media count", got.float()[past],
                                     mean_v[past], dtype)
        assert bool((got[(tt == 0)[:, None, :, None].expand_as(got)] == 0).all())
        again = fused_media_xattn(q, k, v, tt, scale=1.0, n_visual=64)
        torch.cuda.synchronize()
        assert torch.equal(got, again), mix


def test_media_xattn_skips_unattended_media(cuda):
    """The bf16 kernel's NaN contract: a NaN in the K and V of image 2 leaves
    the rows that attend image 1 finite and equal to the plain version on
    the same inputs without the NaN (the TPU kernel's 0 x V makes them NaN);
    a row attending image 2 is NaN."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.media_xattn import (
        fused_media_xattn, fused_media_xattn_plain)
    q, k, v = chip_smoke.attention_inputs(cuda, torch.bfloat16, 2, 8, 32, 128, seed=9)
    tt = torch.ones((2, 32), dtype=torch.int32, device=cuda)
    tt[1, 16:] = 2
    want = fused_media_xattn_plain(q, k, v, tt, scale=1.0, n_visual=64)
    k, v = k.clone(), v.clone()
    k[:, :, 64 + 5] = float("nan")
    v[:, :, 64 + 7] = float("nan")
    got = fused_media_xattn(q, k, v, tt, scale=1.0, n_visual=64)
    torch.cuda.synchronize()
    ones = (tt == 1)[:, None, :, None].expand_as(got)
    chip_smoke.held_to_plain("rows of image 1", got.float()[ones], want.float()[ones],
                             torch.bfloat16)
    assert bool(torch.isnan(got[1, :, 16:]).all())


def test_media_xattn_bf16_refusal_raises(cuda):
    """A bf16 call the kernel refuses (a plan of 0 or 9 slices a block)
    raises, with nothing written, instead of running the float32 tile; the
    same plans in float32 run the tile, which does not read them."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops.fused_attention import launch
    from flamingo_mini_tpu_torch.ops.media_xattn import fused_media_xattn_plain
    tt = torch.ones((2, 40), dtype=torch.int32, device=cuda)
    q, k, v = chip_smoke.attention_inputs(cuda, torch.bfloat16, 2, 8, 40, 128, seed=3)
    for slices in (0, 9):
        with pytest.raises(RuntimeError):
            launch("fmt_media_xattn", q, k, v, scale=1.0, text_time=tt, n_visual=64,
                   plan=(slices,))
        torch.cuda.synchronize()
    q, k, v = (t.float() for t in (q, k, v))
    for slices in (0, 9):
        chip_smoke.held_to_plain("float32, any plan", launch(
            "fmt_media_xattn", q, k, v, scale=1.0, text_time=tt, n_visual=64,
            plan=(slices,)), fused_media_xattn_plain(q, k, v, tt, scale=1.0, n_visual=64),
            torch.float32)


def test_attention_kernels_refuse_bad_input(cuda):
    """Head dim 32, a head dim that is not contiguous and misaligned strides
    are refused. Inputs that require grad (built on the CPU, moved to the
    card) are taken: the kernel's output, and the recompute backward's
    gradients bit for bit those of autograd through the plain version."""
    from flamingo_mini_tpu_torch.ops.fused_attention import (fused_attention,
                                                             fused_attention_plain)
    from flamingo_mini_tpu_torch.ops.media_xattn import (fused_media_xattn,
                                                         fused_media_xattn_plain)
    tt = torch.ones((2, 8), dtype=torch.int32, device=cuda)
    x = torch.zeros((2, 2, 8, 64), device=cuda)
    bad = [torch.zeros((2, 2, 8, 32), device=cuda),
           torch.zeros((2, 2, 64, 8), device=cuda).transpose(2, 3),
           torch.zeros((2, 2, 8, 70), device=cuda)[..., 3:67]]
    for t in bad:
        with pytest.raises(ValueError):
            fused_attention(t, t, t, scale=1.0)
        with pytest.raises(ValueError):
            fused_media_xattn(t, t, t, tt, scale=1.0, n_visual=4)
    g = torch.randn((2, 2, 8, 64), requires_grad=True).to(cuda)
    up = torch.randn((2, 2, 8, 64), device=cuda)
    for call, plain in (
            (lambda t: fused_attention(t, x, x, scale=1.0),
             lambda t: fused_attention_plain(t, x, x, scale=1.0)),
            (lambda t: fused_attention(x, t, x, scale=1.0, streaming=True),
             lambda t: fused_attention_plain(x, t, x, scale=1.0)),
            (lambda t: fused_media_xattn(x, x, t, tt, scale=1.0, n_visual=4),
             lambda t: fused_media_xattn_plain(x, x, t, tt, scale=1.0, n_visual=4))):
        out = call(g)
        assert out.requires_grad
        with torch.no_grad():
            assert torch.equal(out.detach(), call(g))
        (got,) = torch.autograd.grad(out, [g], up)
        (want,) = torch.autograd.grad(plain(g), [g], up)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the w8a8 mode, the shared-memory refusal, the stream probe
# ---------------------------------------------------------------------------


# (K, N, slice width or None: the column form): chip_smoke.W8A8_LINEAR
@pytest.mark.parametrize("b", [1, 3, 8, 32])
@pytest.mark.parametrize("K,N,width", [(1024, 3072, None), (2048, 8192, None),
                                       (512, 1024, None), (512, 1024, 1024),
                                       (4096, 1024, 1024), (8192, 2048, 2048)])
def test_w8a8_linear_is_bitwise(cuda, K, N, width, b):
    import chip_smoke
    got, want = chip_smoke.w8a8_linear_case(cuda, b, K, N, width, seed=K + b)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("mode", ["greedy", "beam", "opt"])
def test_megakernel_act_quant_matches_plain(cuda, mode):
    """2 layers: flamingo-mini width at b=32 (xattn on both), beams at 96
    rows in families of 3, OPT-1.3B width at b=8 (xattn on the first);
    within the normwise rule and bit for bit the plain version."""
    import chip_smoke
    if mode == "opt":
        cfg, packed = chip_smoke.random_trunk(cuda, n_layer=2, xattn_every=2, seed=5,
                                              family="opt", D=chip_smoke.OPT_D,
                                              H=chip_smoke.OPT_H)
        inputs, anc, cur, lim = (chip_smoke.mega_inputs(cuda, cfg, 8, 5, T=chip_smoke.OPT_T),
                                 None, 70, 71)
    else:
        cfg, packed = chip_smoke.random_trunk(cuda, n_layer=2, xattn_every=1, seed=6)
        if mode == "beam":
            inputs, anc = chip_smoke.beam_trunk_inputs(cuda, cfg, 96, 3, seed=6)
            cur, lim = 66, 68
        else:
            inputs, anc, cur, lim = chip_smoke.mega_inputs(cuda, cfg, 32, 6), None, 131, 132
    before = decode_step_megakernel.launches
    worst = {}
    chip_smoke.held_normwise(f"act_quant {mode}", cfg, packed, inputs, cur, lim,
                             beam_anc=anc, act_quant=True, worst=worst, bitwise=True)
    assert decode_step_megakernel.launches == before + 1
    assert worst["share"] <= 1.0, worst


def test_megakernel_refuses_a_wide_trunk_before_prefill(cuda):
    """D=8192: a w8a8 greedy call of 8 rows, w8a8 beams 3 x 3 and a
    weight-only greedy call of 8 rows: ValueError, no vision, no prefill, no
    launch; at D=4096 27 to 2,048 rows (chip_smoke.D4096_ROWS) pass in both
    modes."""
    import chip_smoke
    chip_smoke.phase2_refusal(cuda)


# ---------------------------------------------------------------------------
# the weight-only megakernel's Hopper kernel at its edges
# ---------------------------------------------------------------------------


def test_megakernel_grid_barrier_holds(cuda):
    """The kernel's own grid barrier alone: each block writes a stamp
    before each of 2,000 barriers and reads every block's back after it."""
    from flamingo_mini_tpu_torch.ops.megadecode import grid_sync_test
    assert grid_sync_test(cuda, 2000) == 0


@pytest.mark.parametrize("b", [1, 3, 8, 9, 31, 32, 33, 64, 65, 256, 257])
@pytest.mark.parametrize("every", [1, 2])
def test_megakernel_edge_rows_match_plain(cuda, every, b):
    """Flamingo-mini width, 2 layers: a one-slot cache (left-padded rows
    attend nothing), kv_limit 36 and 132; 2 bf16 ulps."""
    import chip_smoke
    cfg, packed = chip_smoke.random_trunk(cuda, n_layer=2, xattn_every=every,
                                          seed=900 + every)
    before = decode_step_megakernel.launches
    n = chip_smoke.edge_rows_case(cuda, cfg, packed, b, [0.0, 0.0, None])
    assert decode_step_megakernel.launches == before + n


@pytest.mark.parametrize("b", [9, 33])
def test_megakernel_opt_edge_rows_match_plain(cuda, b):
    """OPT-1.3B width (D=2048), 2 layers, a one-slot cache and kv_limit 71."""
    import chip_smoke
    cfg, packed = chip_smoke.random_trunk(cuda, n_layer=2, seed=930, family="opt",
                                          D=chip_smoke.OPT_D, H=chip_smoke.OPT_H,
                                          xattn_every=2)
    chip_smoke.edge_rows_case(cuda, cfg, packed, b, [0.0, 0.0, None])


@pytest.mark.parametrize("rows", [1, 32, 96, 257])
@pytest.mark.parametrize("width", ["flamingo-mini", "OPT-1.3B"])
def test_megakernel_smem_formula_matches_its_mirror(cuda, width, rows):
    """The kernel's shared-memory formula (``fmt_decode_megakernel_smem``)
    and ``megadecode.plan_smem_bytes``, which the CPU plan tests hold
    against the card's limit, agree byte for byte."""
    from flamingo_mini_tpu_torch.ops import megadecode as md
    D, Dff, nx, t_lim = (1024, 4096, 24, 132) if width == "flamingo-mini" else (2048, 8192, 12, 71)
    p = md.plan(rows, D, Dff, 512, Dff, n_xattn=nx)
    args = md._Args(b=rows, D=D, Dff=Dff, XI=512, Dffx=Dff, t_lim=t_lim, NMNV=64)
    md._plan_args(args, p)
    assert md._smem_need(args) == md.plan_smem_bytes(p, D, Dff, 512, Dff, t_lim, 64)


def test_megakernel_back_to_back_and_deterministic(cuda):
    """Greedy b=32 and 3, beams at 96 rows, OPT-1.3B width b=8 launched
    back to back before one synchronize, each against its plain version;
    each launched again on the same inputs, bit-equal."""
    import chip_smoke
    chip_smoke.back_to_back(cuda, [0.0, 0.0, None])


def test_megakernel_section_timer_counts_every_block(cuda):
    """With ``section_timer`` set, a weight-only launch writes each block's
    clock cycles per section: every block waits at the grid barriers, the
    grid runs products and attention, and the counts are left alone when
    the timer is off."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops import megadecode as md
    cfg, packed = chip_smoke.random_trunk(cuda, n_layer=2, xattn_every=1, seed=970)
    xk, xv, kc, vc, x, npad, tt = chip_smoke.mega_inputs(cuda, cfg, 32, seed=971)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    timer = torch.zeros((sms, len(md.SECTIONS)), dtype=torch.int64, device=x.device)
    md.section_timer = timer
    try:
        md.decode_step_megakernel(packed, xk, xv, kc, vc, x, npad, tt, 35, config=cfg,
                                  kv_limit=36)
    finally:
        md.section_timer = None
    first = timer.clone()
    md.decode_step_megakernel(packed, xk, xv, kc, vc, x, npad, tt, 35, config=cfg, kv_limit=36)
    torch.cuda.synchronize()
    t = dict(zip(md.SECTIONS, first.t().cpu()))
    assert bool((t["barrier"] > 0).all()) and int(first.min()) >= 0
    assert int(t["products"].sum()) > 0 and int(t["attention"].sum()) > 0
    assert torch.equal(timer, first), "a launch with the timer off wrote its counts"


def test_megakernel_streams_keep_their_own_barrier_words(cuda):
    """Weight-only launches taking turns on two streams (greedy b=32, beams
    at 160 rows) give the bits of the same launches on the current stream;
    each stream's launches count on barrier words of its own."""
    import chip_smoke
    chip_smoke.two_streams(cuda)


# ---------------------------------------------------------------------------
# the w8a8 mode at the weight-only mode's edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 3, 8, 9, 31, 32, 33, 64, 65, 256, 257])
@pytest.mark.parametrize("every", [1, 2])
def test_megakernel_w8a8_edge_rows_match_plain(cuda, every, b):
    """Flamingo-mini width, 2 layers, the w8a8 mode: a one-slot cache
    (left-padded rows attend nothing), kv_limit 36 and 132; bit for bit
    the plain version (and within 2 bf16 ulps)."""
    import chip_smoke
    cfg, packed = chip_smoke.random_trunk(cuda, n_layer=2, xattn_every=every,
                                          seed=900 + every)
    before = decode_step_megakernel.launches
    n = chip_smoke.edge_rows_case(cuda, cfg, packed, b, [0.0, 0.0, None], act_quant=True)
    assert decode_step_megakernel.launches == before + n


def test_megakernel_w8a8_back_to_back_and_deterministic(cuda):
    """The w8a8 mode: greedy b=32 and 3, beams at 96 rows, OPT-1.3B width
    b=8 launched back to back before one synchronize, each bit for bit its
    plain version; each launched again on the same inputs, bit-equal."""
    import chip_smoke
    chip_smoke.back_to_back(cuda, [0.0, 0.0, None], act_quant=True)


def test_megakernel_w8a8_streams_give_the_bits_of_one(cuda):
    """w8a8 launches taking turns on two streams (greedy b=32, beams at 160
    rows) give the bits of the same launches on the current stream."""
    import chip_smoke
    chip_smoke.two_streams(cuda, act_quant=True)


@pytest.mark.parametrize("rows", [1, 32, 96, 257])
@pytest.mark.parametrize("width", ["flamingo-mini", "OPT-1.3B"])
def test_megakernel_w8a8_smem_formula_matches_its_mirror(cuda, width, rows):
    """``fmt_decode_megakernel_smem`` for the w8a8 mode equals
    ``megadecode.plan_smem_bytes`` of its plan, byte for byte."""
    from flamingo_mini_tpu_torch.ops import megadecode as md
    D, Dff, nx, t_lim = (1024, 4096, 24, 132) if width == "flamingo-mini" else (2048, 8192, 12, 71)
    p = md.plan(rows, D, Dff, 512, Dff, n_xattn=nx, act_quant=True)
    args = md._Args(b=rows, D=D, Dff=Dff, XI=512, Dffx=Dff, t_lim=t_lim, NMNV=64,
                    act_quant=1)
    md._plan_args(args, p)
    assert md._smem_need(args) == md.plan_smem_bytes(p, D, Dff, 512, Dff, t_lim, 64)


def test_megakernel_w8a8_section_timer_counts_every_block(cuda):
    """The section timer covers the w8a8 mode: every block waits at the
    grid barriers, the grid runs products and attention."""
    import chip_smoke
    from flamingo_mini_tpu_torch.ops import megadecode as md
    cfg, packed = chip_smoke.random_trunk(cuda, n_layer=2, xattn_every=1, seed=970)
    xk, xv, kc, vc, x, npad, tt = chip_smoke.mega_inputs(cuda, cfg, 32, seed=971)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    timer = torch.zeros((sms, len(md.SECTIONS)), dtype=torch.int64, device=x.device)
    md.section_timer = timer
    try:
        md.decode_step_megakernel(packed, xk, xv, kc, vc, x, npad, tt, 35, config=cfg,
                                  kv_limit=36, act_quant=True)
        torch.cuda.synchronize()
    finally:
        md.section_timer = None
    t = dict(zip(md.SECTIONS, timer.t().cpu()))
    assert bool((t["barrier"] > 0).all()) and int(timer.min()) >= 0
    assert int(t["products"].sum()) > 0 and int(t["attention"].sum()) > 0


# ---------------------------------------------------------------------------
# the head at its edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [1024, 2048, 1040, 8192])
@pytest.mark.parametrize("B", [1, 3, 8, 32, 33, 64, 65, 128])
def test_lm_head_edges_match_plain(cuda, B, D):
    """Flamingo-mini's (V=50258) and OPT-1.3B's (V=50273) heads at B rows,
    and at D=1040 (a K tail: the last weight chunk 16 wide) and D=8192
    (hidden rows staged in K-slices): ties planted across tiles, across one
    warpgroup's rounds and across two blocks' shares resolve to the first
    index; every pick equals the plain version's, or (the row's top-2 gap
    printed) lies within 1 bf16 ulp of it; the same at n_valid on a tile's
    edge."""
    import chip_smoke
    V = 50273 if D == 2048 else 50258
    head, xt, ties = chip_smoke.head_inputs(cuda, B, D, V, seed=B + D)
    for n_valid in (V, V // 64 * 64):
        got, want, gap, ulp = chip_smoke.head_picks(head, xt, n_valid)
        for i, (first, _second) in ties.items():
            assert int(got[i]) == first, (i, ties[i], int(got[i]))
        parted = (got != want).nonzero().flatten().tolist()
        for i in parted:
            print(f"B={B} D={D} n_valid={n_valid} row {i}: kernel {int(got[i])}, plain "
                  f"{int(want[i])}, plain logits' gap {float(gap[i])} (1 ulp {float(ulp[i])})")
        assert bool((gap <= ulp).all()), (B, D, n_valid, parted)


@pytest.mark.parametrize("D", [40, 1000, 1001, 6208])
@pytest.mark.parametrize("B", [1, 8, 33])
def test_lm_head_odd_widths_match_plain(cuda, B, D):
    """Widths the JAX head takes and no model of the repo has: D=40 (one
    chunk, mostly tail), 1000 (rows of 1000 bytes: pad_head_weights pads
    the weight's columns to 1008), 1001 (an odd width: the hidden rows
    staged element by element) and 6208 (past the old limit of 6,144);
    planted ties to the first index, picks within 1 bf16 ulp of the plain
    version's."""
    import chip_smoke
    V = 50258
    head, xt, ties = chip_smoke.head_inputs(cuda, B, D, V, seed=B + D)
    assert head["w8"].shape[1] == -(-D // 16) * 16
    got, want, gap, ulp = chip_smoke.head_picks(head, xt, V)
    for i, (first, _second) in ties.items():
        assert int(got[i]) == first, (i, ties[i], int(got[i]))
    assert bool((gap <= ulp).all()), (B, D, (got != want).nonzero().flatten().tolist())


def test_lm_head_smem_mirror_matches_the_kernel(cuda):
    """``ops/lm_head.py``'s mirror of the head kernel's shape (``smem_bytes``,
    what the CPU tests of its deal use) equals the kernel's own layout
    (``fmt_lm_head_smem``) at every width up to 1,100, at every multiple of
    64 up to 16,384 and at the row counts of the edge tests; it fits the
    card's shared memory; the kernel answers -1 for no width or no rows."""
    from flamingo_mini_tpu_torch.ops import cuda_build
    from flamingo_mini_tpu_torch.ops import lm_head as lh
    lib = cuda_build.kernels()
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    for D in sorted(set(range(1, 1101)) | set(range(64, 16385, 64))):
        for B in (1, 3, 8, 32, 33, 64, 65, 128):
            assert lib.fmt_lm_head_smem(D, B) == lh.smem_bytes(D, B) <= limit, (D, B)
    assert lib.fmt_lm_head_smem(0, 1) == -1 and lib.fmt_lm_head_smem(64, 0) == -1


def test_stream_sum_matches_plain(cuda):
    from flamingo_mini_tpu_torch.tools.probe_stream import stream_sum, stream_sum_plain
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((32768, 1024), generator=gen, device=cuda).to(torch.bfloat16)
    acc = torch.tensor(2.0, device=cuda)
    before = stream_sum.launches
    got = stream_sum(x, acc, 1024)
    want = stream_sum_plain(x, acc, 1024)
    torch.cuda.synchronize()
    assert stream_sum.launches == before + 1
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# the in-situ decode probes: the three stream kernels, the graphed loops
# ---------------------------------------------------------------------------


# (block_t, block_b, kv_limit, b, T, D): the kernel's edges in each layout
# (chip_smoke.PROBE_EDGES): b of 1 and 3, D of 5 vectors and 2048, block_t
# 1, 3 and 24, a long cache walked in windows, chunks longer than a block
PROBE_EDGES = ((32, None, 128, 1, 192, 1024), (16, None, 100, 3, 192, 1024),
               (32, None, 128, 32, 192, 40), (32, None, 128, 8, 192, 2048),
               (1, None, 100, 32, 192, 1024), (3, None, 100, 32, 192, 1024),
               (24, None, 100, 32, 192, 1024), (32, None, 1024, 32, 1024, 1024),
               (32, None, 1000, 32, 1024, 1024), (256, None, 300, 4, 512, 1024))


# (layout, block_t, block_b, kv_limit, b, T, D): chip_smoke.PROBE_CASES, the
# probe's shape (32, 192, 1024) first
@pytest.mark.parametrize("layout,block_t,block_b,kv_limit,b,T,D", [
    ("tmajor", 16, None, 128, 32, 192, 1024), ("tmajor", 32, None, 128, 32, 192, 1024),
    ("tmajor", 32, None, 100, 32, 192, 1024), ("bmajor", 16, 32, 128, 32, 192, 1024),
    ("bmajor", 32, 32, 128, 32, 192, 1024), ("bmajor", 32, 8, 128, 32, 192, 1024),
    ("bmajor", 16, 8, 100, 32, 192, 1024), ("packed", 16, None, 128, 32, 192, 1024),
    ("packed", 32, None, 128, 32, 192, 1024), ("packed", 16, None, 100, 32, 192, 1024)]
    + [(layout,) + e for layout in ("tmajor", "bmajor", "packed") for e in PROBE_EDGES])
def test_decode_stream_kernel_matches_plain(cuda, layout, block_t, block_b, kv_limit,
                                            b, T, D):
    """Bit for bit: the plain version sums in the kernel's order."""
    import chip_smoke
    from flamingo_mini_tpu_torch.tools import probe_decode_kernel as pdk
    wrapper = {"tmajor": pdk.tmajor_stream, "bmajor": pdk.attn_stream_only,
               "packed": pdk.packed_stream}[layout]
    before = wrapper.launches
    got, want = chip_smoke.stream_probe_case(cuda, layout, block_t, block_b, kv_limit,
                                             block_t + kv_limit, b, T, D)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_decode_stream_kernel_walks_a_long_cache_in_windows(cuda):
    """T = 1,024, kv_limit 1,000: the rows outgrow one block's threads, so
    each block walks eight windows of whole chunks; bit for bit in each
    layout, with one launch each."""
    import chip_smoke
    from flamingo_mini_tpu_torch.tools import probe_decode_kernel as pdk
    n_rows = pdk.chunk_rows(1000, 32, 1024)
    p = pdk.plan(32, 1024, n_rows, 32)
    assert p.windows == 8 and p.window % (32 // pdk.group_rows(32)) == 0
    for layout, wrapper in (("tmajor", pdk.tmajor_stream), ("bmajor", pdk.attn_stream_only),
                            ("packed", pdk.packed_stream)):
        before = wrapper.launches
        got, want = chip_smoke.stream_probe_case(cuda, layout, 32, None, 1000, 5, 32, 1024,
                                                 1024)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), layout


def test_decode_stream_kernels_refuse_bad_input(cuda):
    from flamingo_mini_tpu_torch.tools import probe_decode_kernel as pdk
    q = torch.zeros((4, 60), dtype=torch.bfloat16, device=cuda)
    c = torch.zeros((32, 4, 60), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        pdk.tmajor_stream(q, c, c, block_t=8, kv_limit=16)
    with pytest.raises(ValueError):
        pdk.tmajor_stream(q, c.cpu(), c, block_t=8, kv_limit=16)


@pytest.mark.parametrize("name", ["tmajor_kernel", "stream_tmajor_bt32",
                                  "stream_tmajor_packed_bt16", "head_layout_attend",
                                  "stream_bmajor_bt32", "head_kernel"])
def test_graphed_loop_equals_eager(cuda, name):
    """Each probe loop, 2 steps at the probe's shape, replayed as a CUDA
    graph: bit for bit the eager run on the card (NaN-aware)."""
    from flamingo_mini_tpu_torch.tools import insitu
    from flamingo_mini_tpu_torch.tools import probe_decode_kernel as pdk
    from flamingo_mini_tpu_torch.tools import probe_lm_head as plh
    gen = torch.Generator(device=cuda).manual_seed(3)
    if name == "head_kernel":
        w8, scale, x0 = plh.inputs(cuda, gen)
        _, (_, run, args, _) = plh.variants(w8, scale, x0, 64)
    else:
        loops = dict(pdk.variants(full=True))
        loops["stream_bmajor_bt32"] = pdk.make_flat_loop(pdk.attn_stream_only, block_t=32)
        run, args = loops[name], pdk.inputs(cuda, gen)
    same, eager, replayed = insitu.graph_equals_eager(run, args, reps=2)
    assert same, (float(eager), float(replayed))


# ---------------------------------------------------------------------------
# the logits chain, sampling and greedy launch counts on the card
# ---------------------------------------------------------------------------


def _chain_inputs(seed, b=8, V=50272, T=72):
    rs = np.random.RandomState(seed)
    logits = torch.tensor(rs.randn(b, V).astype(np.float32) * 3)
    tokens = torch.tensor(rs.randint(4, 200, (b, T)))
    tokens[:, 40:44] = tokens[:, 10:14]
    mask = torch.ones((b, T), dtype=torch.int32)
    tokens[:2, :2], mask[:2, :2] = 1, 0
    return logits, tokens, mask


# each warper with the parameter whose cut a near-tie may move
CARD_WARPERS = [("top_k", 50), ("top_p", 0.9), ("min_p", 0.05), ("typical_p", 0.9),
                ("epsilon_cutoff", 1e-5), ("eta_cutoff", 1e-5)]


@pytest.mark.parametrize("name,value", CARD_WARPERS)
def test_warper_on_card_matches_cpu(cuda, name, value):
    """The warper on the card against the same function on the CPU, on the
    same (8, 50,272) logits: masks identical, except in a row whose cut
    moves when the parameter moves by 1e-4 relative on the CPU (a near-tie
    of the cumulative or probability sums, which run in another order);
    kept values within 1e-6 relative (the card may divide by the
    temperature as a product with its reciprocal)."""
    from flamingo_mini_tpu_torch.generation import NEG, apply_logit_filters
    logits, _, _ = _chain_inputs(1)
    kw = {name: value, "temperature": 0.9}
    got = apply_logit_filters(logits.to(cuda), **kw).cpu()
    want = apply_logit_filters(logits, **kw)
    parted = ((got == NEG) != (want == NEG)).any(dim=-1)
    if name != "top_k" and bool(parted.any()):
        lo = apply_logit_filters(logits, **{**kw, name: value * (1 - 1e-4)}) == NEG
        hi = apply_logit_filters(logits, **{**kw, name: value * (1 + 1e-4)}) == NEG
        near = (lo != hi).any(dim=-1)
        assert bool(near[parted].all()), parted.nonzero().flatten().tolist()
    else:
        assert not bool(parted.any())
    same = ~parted[:, None] & (want != NEG)
    torch.testing.assert_close(got[same], want[same], rtol=1e-6, atol=0)


def test_processors_on_card_match_cpu(cuda):
    """Every processor at once, at a step past every window: the same
    masks and values within 1e-6 relative on the card and on the CPU."""
    from flamingo_mini_tpu_torch.generation import NEG, DecodeConfig, process_logits
    logits, tokens, mask = _chain_inputs(2)
    dc = DecodeConfig(max_length=72, eos_token_id=50, pad_token_id=1,
                      sequence_bias=(((7,), 2.0), ((int(tokens[0, 47]), 9), -1.0)),
                      repetition_penalty=1.2, no_repeat_ngram_size=3,
                      bad_words_ids=((11,), (int(tokens[0, 47]), 12)),
                      min_new_tokens=4, exponential_decay_length_penalty=(3, 1.1),
                      suppress_tokens=(13,), begin_suppress_tokens=(14,))
    for idx in (8, 48):
        got = process_logits(logits.to(cuda), dc, tokens.to(cuda), mask.to(cuda), idx,
                             8).cpu()
        want = process_logits(logits, dc, tokens, mask, idx, 8)
        assert torch.equal(got == NEG, want == NEG), idx
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def _small_card_model(cuda):
    """A 2-layer GPT-2 trunk 256 wide (4 heads of 64, the kernels' head
    dim), xattn every layer (2 heads of 64), 16 latents, a small ViT;
    random weights, gates open, int8 trunk and xattn, bf16."""
    from flamingo_mini_tpu_torch import FlamingoConfig, FlamingoModel
    cfg = FlamingoConfig(
        lm="gpt2", dim=256, dim_visual=64, xattn_every=1, xattn_heads=2,
        xattn_dim_head=64, resampler_depth=1, resampler_num_latents=16,
        compute_dtype="bfloat16",
        lm_arch_overrides=dict(vocab_size=512, n_positions=128, n_embd=256,
                               n_layer=2, n_head=4),
        vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                                   num_hidden_layers=1, num_attention_heads=4,
                                   image_size=32, patch_size=16))
    model = FlamingoModel(cfg, device=cuda, seed=4)
    for blk in model.params["xattn"].values():
        blk["alpha_attn"].fill_(0.5)
        blk["alpha_ffw"].fill_(0.3)
    return model.quantize_int8().to_bf16()


def _small_generate(cuda, model, **kw):
    rs = np.random.RandomState(5)
    ids = torch.tensor(rs.randint(4, 500, (4, 6)), device=cuda)
    mask = torch.ones((4, 6), dtype=torch.int32, device=cuda)
    ids[1, :2], mask[1, :2] = 0, 0
    media = torch.zeros((4, 6), dtype=torch.int32, device=cuda)
    media[:, 2] = 1
    pixels = torch.tensor(rs.randn(4, 1, 3, 32, 32), dtype=torch.float32,
                          device=cuda).to(torch.bfloat16)
    return model.generate(ids, media_locations=media, attention_mask=mask,
                          pixel_values=pixels, max_length=38, prefix_block=16,
                          eos_token_id=9999, pad_token_id=0, **kw)


def test_sampling_on_megakernel_is_seeded(cuda):
    """Top-k sampling on the megakernel: every step one kernel launch and no
    fused head; two calls with one seed bit-equal, another seed other
    tokens."""
    model = _small_card_model(cuda)
    gen = lambda s: torch.Generator(device=cuda).manual_seed(s)
    mega, head = decode_step_megakernel.launches, lm_head_argmax.launches
    first = _small_generate(cuda, model, megakernel=True, do_sample=True, top_k=50,
                            generator=gen(3))
    assert decode_step_megakernel.launches - mega == 31
    assert lm_head_argmax.launches == head
    again = _small_generate(cuda, model, megakernel=True, do_sample=True, top_k=50,
                            generator=gen(3))
    other = _small_generate(cuda, model, megakernel=True, do_sample=True, top_k=50,
                            generator=gen(4))
    assert torch.equal(first, again)
    assert not torch.equal(first, other)


@pytest.mark.parametrize("megakernel", [False, True])
def test_greedy_launch_counts_unchanged_by_the_identity_chain(cuda, megakernel):
    """Plain greedy keeps the fused head (one launch a step) on both paths;
    a processor or scores turn it off (the full head runs)."""
    model = _small_card_model(cuda)
    counters = (decode_attention, decode_step_megakernel, lm_head_argmax)
    before = [fn.launches for fn in counters]
    _small_generate(cuda, model, megakernel=megakernel)
    got = [fn.launches - b for fn, b in zip(counters, before)]
    assert got == ([0, 31, 31] if megakernel else [2 * 31, 0, 31]), got
    for kw in (dict(repetition_penalty=1.2), dict(return_scores=True)):
        before = [fn.launches for fn in counters]
        _small_generate(cuda, model, megakernel=megakernel, **kw)
        got = [fn.launches - b for fn, b in zip(counters, before)]
        assert got == ([0, 31, 0] if megakernel else [2 * 31, 0, 0]), (kw, got)
