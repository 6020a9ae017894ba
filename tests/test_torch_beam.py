"""The port's lazy-ancestry beam search against the JAX package.

Same weights on both sides (the JAX package initialises them,
``from_jax_numpy`` carries them over) and the same numpy inputs. Two
models: a small one for the algorithm (GPT-2 trunk D=256, 4 heads of 64, 2
layers, xattn before each, vocab 256, a 1-layer ViT on 32-px images), and
``tests/test_megakernel.py``'s wide one for the megakernel (D=1024, 16
heads, 2 layers, xattn every other layer, vocab 512, int8, bf16), whose
beam test there holds JAX's megakernel to JAX's per-layer path.

Tolerances. float32 (JAX ``Precision.HIGHEST``): attention 1e-5, beam
tokens identical, scores 1e-5. bf16: attention 2 bf16 ulps of the output
scale (the kernel and the plain version round the probabilities against
another running max); one megakernel step 4 bf16 ulps
(``test_torch_megakernel.py``'s envelope). bf16 beam tokens: rows are equal,
or a row parts where the JAX and port runs chose differently at a near-tie:
JAX's own model, run over each finished hypothesis, scores the port's at
least as high as JAX's less 2e-2 (the score envelope of JAX's own
megakernel-vs-per-layer beam test), and at most a quarter of the rows part.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu import beam_search as jbs
from flamingo_mini_tpu.generation import DecodeConfig as JaxDecodeConfig
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops import pallas_decode as jpd
from flamingo_mini_tpu.ops import pallas_megadecode as jmega
from flamingo_mini_tpu.ops import quant as jq

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import beam_search as pbs
from flamingo_mini_tpu_torch.generation import DecodeConfig
from flamingo_mini_tpu_torch.models import gpt2 as pgpt2
from flamingo_mini_tpu_torch.ops import decode_attention as pda
from flamingo_mini_tpu_torch.ops import layers as pl
from flamingo_mini_tpu_torch.ops import megadecode as pmega
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

SMALL = dict(
    lm="gpt2", dim=256, dim_visual=64, xattn_every=1, xattn_dim_head=64,
    xattn_heads=4, resampler_depth=1, resampler_dim_head=16,
    resampler_heads=4, resampler_num_latents=8,
    lm_arch_overrides=dict(vocab_size=256, n_positions=64, n_embd=256,
                           n_layer=2, n_head=4),
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=1, num_attention_heads=4,
                               image_size=32, patch_size=16))
WIDE = dict(
    lm="gpt2", dim=1024, dim_visual=64, xattn_every=2, xattn_dim_head=64,
    xattn_heads=8, resampler_depth=1, resampler_dim_head=16,
    resampler_heads=4, resampler_num_latents=8, compute_dtype="bfloat16",
    lm_arch_overrides=dict(vocab_size=512, n_positions=128, n_embd=1024,
                           n_layer=2, n_head=16),
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=1, num_attention_heads=4,
                               image_size=32, patch_size=8))
MAX_LENGTH, PREFIX_BLOCK, NO_EOS, EOS = 14, 4, 9999, 31


def _bf16_ulps(ref: np.ndarray, n: int) -> float:
    return n * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _open_gates(params):
    for blk in params["xattn"].values():
        blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
        blk["alpha_ffw"] = jnp.full((1,), 0.3, jnp.float32)


def _int8_bf16(params):
    params["lm"] = jq.quantize_gpt2_lm(params["lm"])
    params["xattn"] = jq.quantize_xattn_blocks(params["xattn"])
    return jq.cast_params_bf16(params)


def _bridge(params):
    return from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def small():
    """(jax config, port config, jax params, port params), float32."""
    jc, pc = JaxConfig(**SMALL), port.FlamingoConfig(**SMALL)
    params = jflam.init_flamingo(jax.random.PRNGKey(0), jc)
    _open_gates(params)
    return jc, pc, params, _bridge(params)


@pytest.fixture(scope="module")
def small_eos(small):
    """The small model with EOS made likely: the EOS row (token 31) of the
    tied embedding scaled by 3, so that every row finishes hypotheses and
    the k=3 search stops before the length limit."""
    jc, pc, params, _ = small
    params = dict(params, lm=dict(params["lm"]))
    params["lm"]["wte"] = params["lm"]["wte"].at[EOS].multiply(3.0)
    return jc, pc, params, _bridge(params)


@pytest.fixture(scope="module")
def small_bf16():
    jc = JaxConfig(compute_dtype="bfloat16", **SMALL)
    pc = port.FlamingoConfig(compute_dtype="bfloat16", **SMALL)
    params = jflam.init_flamingo(jax.random.PRNGKey(1), jc)
    _open_gates(params)
    params = _int8_bf16(params)
    return jc, pc, params, _bridge(params)


@pytest.fixture(scope="module")
def wide():
    """The wide bf16 int8 model, no vision tower (visual features given)."""
    jc, pc = JaxConfig(**WIDE), port.FlamingoConfig(**WIDE)
    params = jflam.init_flamingo(jax.random.PRNGKey(0), jc, with_vision=False)
    _open_gates(params)
    params = _int8_bf16(params)
    return jc, pc, params, _bridge(params)


def _prompts(b, seed=0, L=5):
    """Row 1 (when b > 1) is left-padded and its image comes at slot 2."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 250, (b, L)).astype(np.int32)
    mask = np.ones((b, L), np.int32)
    media = np.zeros((b, L), np.int32)
    media[:, 0] = 1
    if b > 1:
        ids[1, :2], mask[1, :2] = 0, 0
        media[1] = 0
        media[1, 2] = 1
    pixels = rs.randn(b, 1, 3, 32, 32).astype(np.float32)
    return ids, media, mask, pixels


def _wide_inputs(b, seed, L=6):
    """tests/test_megakernel.py's inputs: row 1 left-padded, 8 latents."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 500, size=(b, L)).astype(np.int32)
    mask = np.ones((b, L), np.int32)
    if b > 1:
        ids[1, :2], mask[1, :2] = 0, 0
    media = np.zeros((b, L), np.int32)
    media[:, 0] = 1
    return ids, media, mask, rs.randn(b, 1, 8, 64).astype(np.float32)


def _jax_beam(jc, params, pol, ids, media, mask, *, pixels=None, feats=None,
              impl=None, **kw):
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, pad_token_id=0,
                         prefix_block=PREFIX_BLOCK, **kw)
    args = (params, jc, dc, pol, jnp.asarray(ids), jnp.asarray(media),
            jnp.asarray(mask), None if feats is None else jnp.asarray(feats))
    px = None if pixels is None else jnp.asarray(pixels)
    out = (impl or jbs.beam_generate)(*args, pixel_values=px)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_beam(pc, tp, pol, ids, media, mask, *, pixels=None, feats=None,
               impl=None, **kw):
    dc = DecodeConfig(max_length=MAX_LENGTH, pad_token_id=0,
                      prefix_block=PREFIX_BLOCK, **kw)
    vf = None if feats is None else torch.tensor(feats).to(pol.dtype)
    px = None if pixels is None else torch.tensor(pixels)
    out = (impl or pbs.beam_generate)(tp, pc, dc, pol, torch.tensor(ids).long(),
                                      torch.tensor(media), torch.tensor(mask),
                                      vf, pixel_values=px)
    return jax.tree_util.tree_map(lambda t: t.numpy(), out)


# ---------------------------------------------------------------------------
# decode_attention_beam
# ---------------------------------------------------------------------------


def _beam_case(b, kb, seed):
    """T=32 cache, H=4 heads of 32, permuted ancestry shorter than the
    cache, row families left-padded by 0-2 slots, cur=20, kv_limit 24."""
    H, D, T, cur = 4, 128, 32, 20
    rs = np.random.RandomState(seed)
    B = b * kb
    q, kc, vc = (rs.randn(*s).astype(np.float32) for s in ((B, D), (T, B, D), (T, B, D)))
    anc = rs.randint(0, kb, (b, kb, 26)).astype(np.int32)
    anc[:, :, cur] = np.arange(kb)
    npad = np.repeat(np.arange(b) % 3, kb).astype(np.int32)
    return q, kc, vc, anc, npad, cur, H


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,kb", [(8, 3), (2, 3)], ids=["pallas24", "reference6"])
def test_decode_attention_beam_matches_jax(b, kb, dtype):
    """24 rows run JAX's Pallas kernel in interpret mode; 6 rows (no
    lcm(8, 3) group divides them) its reference."""
    q, kc, vc, anc, npad, cur, H = _beam_case(b, kb, seed=b)
    kw = dict(n_head=H, scale=0.2, kb=kb, kv_limit=24)
    jd = getattr(jnp, dtype)
    jargs = (jnp.asarray(q, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd),
             jnp.asarray(anc), jnp.asarray(npad), jnp.int32(cur))
    if jpd.beam_kernel_group(b * kb, kb, H):
        want = jpd.decode_attention_beam(*jargs, interpret=True, **kw)
    else:
        want = jpd.decode_attention_beam_reference(*jargs, **kw)
    want = np.asarray(want.astype(jnp.float32))
    td = getattr(torch, dtype)
    got = pda.decode_attention_beam(
        torch.tensor(q).to(td), torch.tensor(kc).to(td), torch.tensor(vc).to(td),
        torch.tensor(anc), torch.tensor(npad), cur, **kw)
    assert got.dtype == td and got.shape == q.shape
    tol = 1e-5 if dtype == "float32" else _bf16_ulps(want, 2)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_beam_wrappers_refuse_bad_ancestry():
    q, kc, vc, anc, npad, cur, H = _beam_case(2, 3, seed=1)
    args = [torch.tensor(a) for a in (q, kc, vc)]
    for bad in (torch.tensor(anc).long(), torch.tensor(anc[:1]),
                torch.tensor(anc).reshape(3, 2, -1)):
        with pytest.raises(ValueError):
            pda.decode_attention_beam(*args, bad, torch.tensor(npad), cur,
                                      n_head=H, scale=0.2, kb=3)


# ---------------------------------------------------------------------------
# one megakernel step in beam mode
# ---------------------------------------------------------------------------


def test_megakernel_beam_step_matches_jax(small_bf16):
    """b*kb = 24 (8 families of 3): the hidden row and the K/V rows written
    at cur against JAX's megakernel in interpret mode with ``beam_anc``.
    Permuted ancestry, left-padded families, a family without an image."""
    jc, pc, params, tp = small_bf16
    b, kb, L, T, cur, kv_limit, D, NMNV = 8, 3, 2, 64, 12, 16, 256, 8
    B = b * kb
    rs = np.random.RandomState(11)
    x_emb = (rs.randn(B, D) * 0.5).astype(np.float32)
    kc, vc = ((rs.randn(L, T, B, D) * 0.5).astype(np.float32) for _ in range(2))
    npad = np.repeat(np.arange(b) % 3, kb).astype(np.int32)
    text_time = np.ones(B, np.int32)
    text_time[3 * kb:4 * kb] = 0
    anc = rs.randint(0, kb, (b, kb, 24)).astype(np.int32)
    anc[:, :, cur] = np.arange(kb)
    kv = {str(l): tuple((rs.randn(B, 4, NMNV, 64) * 0.5).astype(np.float32)
                        for _ in range(2)) for l in range(L)}

    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    jpacked = jmega.pack_decode_weights(params, jc)
    jxk, jxv = jmega.pack_xattn_kv_flat({k: (bf(a), bf(c)) for k, (a, c) in kv.items()}, L)
    want = jmega.decode_step_megakernel(
        jpacked, jxk, jxv, bf(kc), bf(vc), bf(x_emb), jnp.asarray(npad),
        jnp.asarray(text_time), jnp.int32(cur), config=jc, kv_limit=kv_limit,
        interpret=True, beam_anc=jnp.asarray(anc))
    want = [np.asarray(w.astype(jnp.float32)) for w in want]

    tb = lambda a: torch.tensor(a).to(torch.bfloat16)
    packed = pmega.pack_decode_weights(tp, pc)
    xk, xv = pmega.pack_xattn_kv_flat({k: (tb(a), tb(c)) for k, (a, c) in kv.items()}, L)
    pkc, pvc = tb(kc), tb(vc)
    hidden = pmega.decode_step_megakernel(
        packed, xk, xv, pkc, pvc, tb(x_emb), torch.tensor(npad),
        torch.tensor(text_time), cur, config=pc, kv_limit=kv_limit,
        beam_anc=torch.tensor(anc))
    got = [hidden.float().numpy(), pkc.float().numpy(), pvc.float().numpy()]
    for name, g, w in (("hidden", got[0], want[0]),
                       ("k row", got[1][:, cur], want[1][:, cur]),
                       ("v row", got[2][:, cur], want[2][:, cur])):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=_bf16_ulps(w, 4), rtol=0, err_msg=name)
    with pytest.raises(ValueError):            # the family axis must tile the rows
        pmega.decode_step_megakernel(
            packed, xk, xv, pkc, pvc, tb(x_emb), torch.tensor(npad),
            torch.tensor(text_time), cur, config=pc, beam_anc=torch.tensor(anc[:4]))


# ---------------------------------------------------------------------------
# beam search, float32
# ---------------------------------------------------------------------------


CASES = {
    "k2": dict(num_beams=2, return_scores=True),
    "k3": dict(num_beams=3),
    "k3_n2_lp07": dict(num_beams=3, num_return_sequences=2, return_scores=True,
                       length_penalty=0.7),
    # the whole pools come back, finished hypotheses among them
    "k3_eos": dict(num_beams=3, num_return_sequences=3, return_scores=True,
                   eos="reachable"),
    "k2_eos_lp13_late": dict(num_beams=2, num_return_sequences=2,
                             return_scores=True, length_penalty=1.3,
                             early_stopping=False, eos="reachable"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_f32_matches_jax(small, small_eos, case, monkeypatch):
    kw = dict(CASES[case])
    eos = EOS if kw.pop("eos", None) else NO_EOS
    jc, pc, params, tp = small_eos if eos == EOS else small
    ids, media, mask, pixels = _prompts(4)
    L = ids.shape[1]
    steps = []
    watch = pbs.select_candidates
    monkeypatch.setattr(pbs, "select_candidates",
                        lambda flat, n: steps.append(n) or watch(flat, n))
    want = _jax_beam(jc, params, jl.PARITY, ids, media, mask, pixels=pixels,
                     eos_token_id=eos, **kw)
    got = _port_beam(pc, tp, pl.PARITY, ids, media, mask, pixels=pixels,
                     eos_token_id=eos, **kw)
    n = kw.get("num_return_sequences", 1)
    toks, scores = (got, None) if not kw.get("return_scores") else got
    wtoks, wscores = (want, None) if not kw.get("return_scores") else want
    assert toks.shape == (4 * n, MAX_LENGTH)
    np.testing.assert_array_equal(toks, wtoks)
    if scores is not None:
        assert scores.shape == (4 * n,)
        np.testing.assert_allclose(scores, wscores, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(toks[::n, :L], ids)
    if eos != NO_EOS:
        # finished hypotheses keep EOS and pad after it
        done = [r for r in toks if eos in r[L:]]
        assert done, "no hypothesis finished"
        for r in done:
            first = L + int(np.argmax(r[L:] == eos))
            assert (r[first + 1:] == 0).all()
        if kw.get("early_stopping", True):   # every pool filled before M
            assert len(steps) < MAX_LENGTH - L, steps


def test_beam_generate_with_scores_f32_matches_jax(small_eos):
    """The best hypothesis of each row and its length-penalised score, EOS
    likely, length penalty 0.8."""
    jc, pc, params, tp = small_eos
    ids, media, mask, pixels = _prompts(4, seed=5)
    kw = dict(num_beams=3, eos_token_id=EOS, length_penalty=0.8, pixels=pixels)
    wt, ws = _jax_beam(jc, params, jl.PARITY, ids, media, mask,
                       impl=jbs.beam_generate_with_scores, **kw)
    gt, gs = _port_beam(pc, tp, pl.PARITY, ids, media, mask,
                        impl=pbs.beam_generate_with_scores, **kw)
    assert gt.shape == (4, MAX_LENGTH) and gs.shape == (4,)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)


def test_group_beam_f32_matches_jax(small_eos):
    """Diverse beams: 4 beams in 2 groups, diversity penalty 0.5, EOS
    likely; the whole sorted pool (b, k, max_length) and its scores."""
    jc, pc, params, tp = small_eos
    eos = EOS
    ids, media, mask, pixels = _prompts(4)
    kw = dict(num_beams=4, num_beam_groups=2, diversity_penalty=0.5,
              eos_token_id=eos, pixels=pixels)
    wseq, wsc = _jax_beam(jc, params, jl.PARITY, ids, media, mask,
                          impl=jbs._group_beam_impl, **kw)
    gseq, gsc = _port_beam(pc, tp, pl.PARITY, ids, media, mask,
                           impl=pbs.group_beam_impl, **kw)
    assert gseq.shape == (4, 4, MAX_LENGTH)
    np.testing.assert_array_equal(gseq, wseq)
    np.testing.assert_allclose(gsc, wsc, atol=1e-5, rtol=0)
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    out = model.generate(ids, media_locations=media, attention_mask=mask,
                         pixel_values=pixels, max_length=MAX_LENGTH,
                         eos_token_id=eos, pad_token_id=0, prefix_block=PREFIX_BLOCK,
                         num_beams=4, num_beam_groups=2, diversity_penalty=0.5)
    np.testing.assert_array_equal(out.numpy(), wseq[:, 0])


# ---------------------------------------------------------------------------
# beam search, bf16 + int8, megakernel
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("jc",))
def _jax_token_logp(params, seqs, media, mask, feats, *, jc):
    """JAX's bf16 log-prob of each token of ``seqs`` given its prefix, from
    one full forward -> (b, n - 1)."""
    pol = jl.FAST
    xkv = jflam.compute_xattn_kv(params, jc, pol.cast(feats), policy=pol)
    hook = jflam.make_layer_hook(params, jc, xkv, jnp.cumsum(media, axis=-1),
                                 policy=pol)
    pos = jnp.clip(jnp.cumsum(mask, axis=-1) - 1, 0)
    logits, _ = jflam.apply_lm(params, jc, seqs, policy=pol, layer_hook=hook,
                               attention_mask=mask, position_ids=pos)
    lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    return jnp.take_along_axis(lp, seqs[:, 1:, None], axis=-1)[..., 0]


def _agree_up_to_near_ties(wide, got, want, media, mask, feats):
    """Rows equal, or the port's hypothesis scored by JAX's model at least
    as high as JAX's own less 2e-2 (module docstring). EOS unreachable:
    every hypothesis runs to MAX_LENGTH. Returns the rows that part."""
    jc, _, params, _ = wide
    (gt, gs), (wt, ws) = got, want
    assert gt.shape == wt.shape
    L = media.shape[1]
    np.testing.assert_array_equal(gt[:, :L], wt[:, :L])
    parted = [r for r in range(gt.shape[0]) if not np.array_equal(gt[r], wt[r])]
    same = [r for r in range(gt.shape[0]) if r not in parted]
    np.testing.assert_allclose(gs[same], ws[same], atol=2e-2, rtol=0)
    if parted:
        ext = ((0, 0), (0, MAX_LENGTH - L))
        m, k = jnp.asarray(np.pad(media, ext)), jnp.asarray(np.pad(mask, ext, constant_values=1))
        f = jnp.asarray(feats)
        score = lambda t: np.asarray(_jax_token_logp(params, jnp.asarray(t, jnp.int32), m, k, f,
                                                     jc=jc))[:, L - 1:].mean(axis=1)
        sg, sw = score(gt), score(wt)
        for r in parted:
            assert sg[r] >= sw[r] - 2e-2, (r, sg[r], sw[r])
    assert len(parted) <= gt.shape[0] // 4, parted
    return parted


def _wide_beam(wide, b, seed, *, megakernel, jax_side, return_scores=True):
    jc, pc, params, tp = wide
    ids, media, mask, feats = _wide_inputs(b, seed)
    kw = dict(num_beams=3, eos_token_id=NO_EOS, megakernel=megakernel,
              return_scores=return_scores)
    if jax_side:
        return _jax_beam(jc, params, jl.FAST, ids, media, mask, feats=feats, **kw)
    return _port_beam(pc, tp, pl.FAST, ids, media, mask, feats=feats, **kw)


def test_megakernel_beam_matches_jax_megakernel(wide):
    """b=8, k=3: 24 rows, so JAX runs its megakernel (interpret mode)."""
    ids, media, mask, feats = _wide_inputs(8, 31)
    want = _wide_beam(wide, 8, 31, megakernel=True, jax_side=True)
    got = _wide_beam(wide, 8, 31, megakernel=True, jax_side=False)
    _agree_up_to_near_ties(wide, got, want, media, mask, feats)


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


@pytest.mark.parametrize("b,seed", [(2, 32), (3, 33)], ids=["b2", "odd_b3"])
def test_megakernel_beam_runs_where_jax_falls_back(wide, b, seed, monkeypatch):
    """b*k = 6 or 9: no lcm(8, 3) group divides the rows, so JAX's beam
    search runs per layer; the port's runs its megakernel all the same
    (every step, and no per-layer attention). An odd batch returns b rows
    (JAX's ``generate`` pads it with a row it never slices off)."""
    ids, media, mask, feats = _wide_inputs(b, seed)
    want = _wide_beam(wide, b, seed, megakernel=True, jax_side=True)
    mega = _count_calls(monkeypatch, pmega, "decode_step_megakernel")
    layer = _count_calls(monkeypatch, pgpt2, "decode_attention_beam")
    jc, pc, params, tp = wide
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    got = model.generate(ids, media_locations=media, attention_mask=mask,
                         visual_features=feats, max_length=MAX_LENGTH,
                         eos_token_id=NO_EOS, pad_token_id=0,
                         prefix_block=PREFIX_BLOCK, num_beams=3,
                         megakernel=True, return_scores=True)
    got = tuple(t.numpy() for t in got)
    assert got[0].shape == (b, MAX_LENGTH) and got[1].shape == (b,)
    assert len(mega) == MAX_LENGTH - ids.shape[1] - 1 and not layer
    _agree_up_to_near_ties(wide, got, want, media, mask, feats)


def test_megakernel_beam_matches_per_layer_beam(wide):
    """The port's two beam paths, b=8, k=3: tokens equal, scores within
    2e-2."""
    per_layer = _wide_beam(wide, 8, 31, megakernel=False, jax_side=False)
    mega = _wide_beam(wide, 8, 31, megakernel=True, jax_side=False)
    np.testing.assert_array_equal(mega[0], per_layer[0])
    np.testing.assert_allclose(mega[1], per_layer[1], atol=2e-2, rtol=0)


def test_bf16_per_layer_beam_matches_jax(small_bf16):
    """The small bf16 int8 model per layer, b=4, k=3, EOS unreachable:
    JAX runs its beam kernel's reference here (12 rows)."""
    jc, pc, params, tp = small_bf16
    ids, media, mask, pixels = _prompts(4, seed=2)
    kw = dict(num_beams=3, eos_token_id=NO_EOS, return_scores=True, pixels=pixels)
    wt, ws = _jax_beam(jc, params, jl.FAST, ids, media, mask, **kw)
    gt, gs = _port_beam(pc, tp, pl.FAST, ids, media, mask, **kw)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_allclose(gs, ws, atol=2e-2, rtol=0)
