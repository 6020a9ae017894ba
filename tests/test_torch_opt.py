"""The port's OPT trunk against the JAX package.

Same weights on both sides: the JAX package initialises them and
``from_jax_numpy`` carries them over. Two small OPT models with gated xattn
before every other layer (D=128, 4 heads, ffn 512, 2 layers, vocab 256, a
1-layer ViT on 32-px images): the pre-norm layout of opt-125m/1.3b and the
post-norm layout of opt-350m with ``project_in`` / ``project_out`` to a
64-wide embedding. Gates open. Batches have a left-padded row whose image
comes late.

Tolerances. float32 runs at full precision on both sides: the trunk's
prefill and decode step 1e-5 of the output's scale, forward logits 1e-4 of
their scale and the loss 1e-5 relative (summation order through the ViT,
the resampler and the trunk), greedy tokens and float32 beams identical,
beam scores within 1e-5. bf16 under the Pallas policy: 1e-2 normwise, as
bf16 rounds at points the two frameworks choose differently. One
megakernel step in the OPT mode against JAX's megakernel in interpret mode:
the hidden row and the written K/V rows within 4 bf16 ulps of the output's
scale (tests/test_torch_megakernel.py's rule: the TPU kernel sums its
row-chunked products in another order, which ReLU exposes on about 1
element in 3,072, and the frameworks round at other points). bf16 + int8
greedy tokens equal up to a row's first near-tie, where JAX's own top two
logits lie within 2 bf16 ulps; bf16 beams as tests/test_torch_beam.py holds
them.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu import beam_search as jbs
from flamingo_mini_tpu.generation import (DecodeConfig as JaxDecodeConfig,
                                          _generate_impl, _prefill as jax_prefill)
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.models import opt as jopt
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops import pallas_megadecode as jmega
from flamingo_mini_tpu.ops import quant as jq

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import beam_search as pbs
from flamingo_mini_tpu_torch.generation import DecodeConfig, _prefill
from flamingo_mini_tpu_torch.models import flamingo as pflam
from flamingo_mini_tpu_torch.models import opt as popt
from flamingo_mini_tpu_torch.ops import layers as pl
from flamingo_mini_tpu_torch.ops import megadecode as pmega
from flamingo_mini_tpu_torch.ops import quant as pq
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

ARCH = dict(vocab_size=256, max_position_embeddings=64, hidden_size=128,
            ffn_dim=512, num_hidden_layers=2, num_attention_heads=4)
LAYOUTS = {
    "pre": dict(lm="facebook/opt-1.3b",
                lm_arch_overrides=dict(ARCH, word_embed_proj_dim=128)),
    "post": dict(lm="facebook/opt-350m",
                 lm_arch_overrides=dict(ARCH, word_embed_proj_dim=64)),
}
SMALL = dict(
    dim=128, dim_visual=64, xattn_every=2, xattn_dim_head=32, xattn_heads=4,
    resampler_depth=1, resampler_dim_head=16, resampler_heads=4,
    resampler_num_latents=8,
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=1, num_attention_heads=4,
                               image_size=32, patch_size=16))
J_PALLAS_F32 = jl.Policy(jnp.float32, jax.lax.Precision.HIGHEST, pallas=True)
P_PALLAS_F32 = pl.Policy(torch.float32, pallas=True)
MAX_LENGTH, PREFIX_BLOCK, EOS = 16, 4, 999   # EOS unreachable (vocab 257)


def _bf16_ulps(ref: np.ndarray, n: int) -> float:
    """n bf16 ulps at the scale of the largest |value| (8 significant bits)."""
    return n * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _build(layout, dtype):
    """(jax config, port config, jax params, port params); bf16 adds the
    int8 trunk and xattn and the bf16 cast."""
    kw = dict(SMALL, **LAYOUTS[layout], compute_dtype=dtype)
    jc, pc = JaxConfig(**kw), port.FlamingoConfig(**kw)
    params = jflam.init_flamingo(jax.random.PRNGKey(len(layout)), jc)
    for blk in params["xattn"].values():
        blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
        blk["alpha_ffw"] = jnp.full((1,), 0.3, jnp.float32)
    if dtype == "bfloat16":
        params["lm"] = jq.quantize_opt_lm(params["lm"])
        params["xattn"] = jq.quantize_xattn_blocks(params["xattn"])
        params = jq.cast_params_bf16(params)
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jc, pc, params, tp


@pytest.fixture(scope="module")
def models():
    """(layout, dtype) -> ``_build(layout, dtype)``, filled on first use."""
    return {}


def _model(models, layout, dtype="float32"):
    if (layout, dtype) not in models:
        models[layout, dtype] = _build(layout, dtype)
    return models[layout, dtype]


def _prompts(b=4, seed=0, L=5, size=32):
    """Row 1 is left-padded by 2 and its image comes at slot 2; the image
    is at slot 0 elsewhere."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 250, (b, L)).astype(np.int32)
    mask = np.ones((b, L), np.int32)
    ids[1, :2], mask[1, :2] = 0, 0
    media = np.zeros((b, L), np.int32)
    media[:, 0] = 1
    media[1] = 0
    media[1, 2] = 1
    return ids, media, mask, rs.randn(b, 1, 3, size, size).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------


def test_opt_position_ids():
    """HF's scheme: real tokens count from 0, pads get -1 (row 1 of the
    offset table)."""
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]], np.int32)
    got = popt.opt_position_ids(_t(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jopt.opt_position_ids(jnp.asarray(mask))))
    np.testing.assert_array_equal(got[0], [-1, -1, 0, 1, 2])


@pytest.mark.parametrize("layout", ["pre", "post"])
def test_apply_opt_prefill_and_step_f32_matches_jax(models, layout):
    """The flat-cache prefill of a left-padded prompt (positions from the
    mask, clipped at 0), then one decode step through ``decode_attention``
    over the live prefix: hidden rows and every layer's K/V rows."""
    jc, pc, params, tp = _model(models, layout)
    arch = jc.lm_arch
    b, L, T, kv_limit = 3, 5, 64, 8
    ids, _, mask, _ = _prompts(b, seed=1, L=L)
    mask_buf = np.zeros((b, T), np.int32)
    mask_buf[:, :L + 1] = np.pad(mask, ((0, 0), (0, 1)), constant_values=1)
    pos = np.clip(np.cumsum(mask, axis=-1) - 1, 0, None)
    nxt = np.array([[7], [11], [13]], np.int32)
    pos_next = mask.sum(-1, keepdims=True)

    jcache = jopt.init_cache(arch, b, T, jnp.float32, flat=True)
    jh0, jcache = jopt.apply_opt(params["lm"], jnp.asarray(ids), arch=arch,
                                 policy=jl.PARITY, attention_mask=jnp.asarray(mask_buf),
                                 position_ids=jnp.asarray(pos), cache=jcache,
                                 cache_index=0)
    jh1, jcache = jopt.apply_opt(params["lm"], jnp.asarray(nxt), arch=arch,
                                 policy=jl.PARITY, attention_mask=jnp.asarray(mask_buf),
                                 position_ids=jnp.asarray(pos_next), cache=jcache,
                                 cache_index=L, kv_limit=kv_limit)

    kc, vc, cache = popt.init_cache(pc.lm_arch, b, T, torch.float32, "cpu")
    ph0, _ = popt.apply_opt(tp["lm"], _t(ids).long(), arch=pc.lm_arch, policy=pl.PARITY,
                            attention_mask=_t(mask_buf), position_ids=_t(pos),
                            cache=cache, cache_index=0)
    ph1, _ = popt.apply_opt(tp["lm"], _t(nxt).long(), arch=pc.lm_arch, policy=pl.PARITY,
                            attention_mask=_t(mask_buf), position_ids=_t(pos_next),
                            cache=cache, cache_index=L, kv_limit=kv_limit)
    assert ph0.shape == (b, L, arch.word_embed_proj_dim)
    for name, g, w in (("prefill", ph0, jh0), ("step", ph1, jh1),
                       ("k", kc[:, :L + 1], np.stack([c["kf"][:L + 1] for c in jcache])),
                       ("v", vc[:, :L + 1], np.stack([c["vf"][:L + 1] for c in jcache]))):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_quantize_opt_lm_matches_jax(models):
    """int8 values and scales equal; opt-350m's projections stay float."""
    jc, pc, params, tp = _model(models, "post")
    want = jq.quantize_opt_lm(params["lm"])
    got = pq.quantize_opt_lm(tp["lm"])
    assert "embed_tokens" not in got and "w" in got["project_in"]
    np.testing.assert_array_equal(got["embed_tokens_q"]["w8"].numpy(),
                                  np.asarray(want["embed_tokens_q"]["w8"]))
    for name in ("q_proj", "fc2"):
        g, w = got["layers"][1][name], want["layers"][1][name]
        np.testing.assert_array_equal(g["w8"].numpy(), np.asarray(w["w8"]))
        np.testing.assert_allclose(g["scale"].numpy(), np.asarray(w["scale"]), rtol=1e-7)


# ---------------------------------------------------------------------------
# the uncached forward
# ---------------------------------------------------------------------------


def _batch(seed=0, b=3, n=12, pad=4):
    """Row 1 left-padded by ``pad``; each row's image at its first real
    token; labels = the ids (pads included, as the reference's loss)."""
    ids, media, mask, pixels = _prompts(b, seed, L=n)
    ids[1, :pad], mask[1] = 0, (np.arange(n) >= pad)
    media[1] = 0
    media[1, pad] = 1
    return ids, media, mask, pixels


def _forward_both(jc, pc, params, tp, jpol, ppol, batch):
    ids, media, mask, pixels = batch
    want = jflam.forward(params, jc, jnp.asarray(ids), policy=jpol,
                         media_locations=jnp.asarray(media),
                         attention_mask=jnp.asarray(mask),
                         pixel_values=jnp.asarray(pixels), labels=jnp.asarray(ids))
    got = pflam.forward(tp, pc, _t(ids).long(), policy=ppol, media_locations=_t(media),
                        attention_mask=_t(mask), pixel_values=_t(pixels),
                        labels=_t(ids).long())
    return got, want


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "pallas"])
@pytest.mark.parametrize("layout", ["pre", "post"])
def test_forward_f32_matches_jax(models, layout, pallas):
    """Logits and loss with a left-padded row. Its pad queries see only
    pads, whose embeddings read row 1 of the position table
    (``opt_position_ids``), so their logits, which the loss counts, catch
    a position mix-up."""
    jc, pc, params, tp = _model(models, layout)
    jpol, ppol = (J_PALLAS_F32, P_PALLAS_F32) if pallas else (jl.PARITY, pl.PARITY)
    batch = _batch()
    got, want = _forward_both(jc, pc, params, tp, jpol, ppol, batch)
    wl = np.asarray(want.logits)
    assert got.logits.shape == wl.shape == (3, 12, 257)
    np.testing.assert_allclose(got.logits.numpy(), wl, rtol=0, atol=1e-4 * np.abs(wl).max())
    assert abs(float(got.loss) - float(want.loss)) <= 1e-5 * abs(float(want.loss))
    # the pad rows would move by far more than that with positions clipped at 0
    lm = dict(tp["lm"], embed_positions=tp["lm"]["embed_positions"].clone())
    lm["embed_positions"][1] = lm["embed_positions"][2]
    ids, media, mask, pixels = batch
    moved = pflam.forward(dict(tp, lm=lm), pc, _t(ids).long(), policy=ppol,
                          media_locations=_t(media), attention_mask=_t(mask),
                          pixel_values=_t(pixels)).logits
    assert np.abs(moved[1, :4].numpy() - wl[1, :4]).max() > 1e-2 * np.abs(wl).max()


def test_forward_bf16_pallas_matches_jax(models):
    """FAST_PALLAS on both sides: the port's kernels' plain versions, JAX's
    Pallas kernels in interpret mode."""
    jc, pc, params, tp = _model(models, "pre", "bfloat16")
    batch = _batch(1)
    got, want = _forward_both(jc, pc, params, tp, jl.FAST_PALLAS, pl.FAST_PALLAS, batch)
    assert got.logits.dtype == torch.bfloat16
    assert torch.isfinite(got.logits.float()).all()
    wl = np.asarray(want.logits, np.float32)
    assert _rel(got.logits.float().numpy(), wl) <= 1e-2
    assert _rel(got.logits[1].float().numpy(), wl[1]) <= 1e-2     # the left-padded row
    assert _rel(float(got.loss), float(want.loss)) <= 1e-2


# ---------------------------------------------------------------------------
# one megakernel step in the OPT mode
# ---------------------------------------------------------------------------


def test_megakernel_opt_step_matches_jax_interpret(models):
    """Hidden row and the K/V rows written at ``cur``, against the JAX
    megakernel in interpret mode on JAX-packed inputs: two images (16
    latents), row 2 without an image (text_time 0), row 3 sees the second;
    rows left-padded by 0-3 slots; the live prefix ends before the cache."""
    jc, pc, params, tp = _model(models, "pre", "bfloat16")
    b, L, T, cur, kv_limit = 4, 2, 64, 10, 16
    D, XH, dh, NMNV = 128, 4, 32, 16
    rs = np.random.RandomState(7)
    x_emb = (rs.randn(b, D) * 0.5).astype(np.float32)
    kc = (rs.randn(L, T, b, D) * 0.5).astype(np.float32)
    vc = (rs.randn(L, T, b, D) * 0.5).astype(np.float32)
    npad = np.array([0, 2, 3, 1], np.int32)
    text_time = np.array([1, 1, 0, 2], np.int32)
    kv = {"0": tuple((rs.randn(b, XH, NMNV, dh) * 0.5).astype(np.float32)
                     for _ in range(2))}

    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    jxk, jxv = jmega.pack_xattn_kv_flat({k: (bf(a), bf(c)) for k, (a, c) in kv.items()}, L)
    want = jmega.decode_step_megakernel(
        jmega.pack_decode_weights(params, jc), jxk, jxv, bf(kc), bf(vc), bf(x_emb),
        jnp.asarray(npad), jnp.asarray(text_time), jnp.int32(cur), config=jc,
        kv_limit=kv_limit, interpret=True)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]

    tb = lambda a: torch.tensor(a).to(torch.bfloat16)
    packed = pmega.pack_decode_weights(tp, pc)
    assert packed["w_qkv"].shape == (L, 3 * D, D) and packed["hasx"].tolist() == [1, 0]
    # the qkv rows are q | k | v, each (d_out, d_in), biases alike
    blk = tp["lm"]["layers"][1]
    torch.testing.assert_close(packed["w_qkv"][1, D:2 * D], blk["k_proj"]["w8"].t())
    torch.testing.assert_close(packed["b_qkv"][1, 2 * D:], blk["v_proj"]["b"])
    xk, xv = pmega.pack_xattn_kv_flat({k: (tb(a), tb(c)) for k, (a, c) in kv.items()}, L)
    pkc, pvc = tb(kc), tb(vc)
    hidden = pmega.decode_step_megakernel(
        packed, xk, xv, pkc, pvc, tb(x_emb), torch.tensor(npad),
        torch.tensor(text_time), cur, config=pc, kv_limit=kv_limit)
    got = [hidden.float().numpy(), pkc.float().numpy(), pvc.float().numpy()]
    for name, g, w in (("hidden", got[0], want[0]),
                       ("k row", got[1][:, cur], want[1][:, cur]),
                       ("v row", got[2][:, cur], want[2][:, cur])):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=_bf16_ulps(w, 4), rtol=0, err_msg=name)


def test_opt350m_refuses_the_megakernel(models):
    """Post-norm with project_in/out: ``supports_arch`` is False, and the
    packing and ``generate(megakernel=True)`` raise ``ValueError``, as JAX's
    generate does."""
    jc, pc, params, tp = _model(models, "post", "bfloat16")
    assert not pmega.supports_arch(pc.lm_arch) and not jmega.supports_arch(jc.lm_arch)
    assert pmega.supports_arch(port.FlamingoConfig(**LAYOUTS["pre"]).lm_arch)
    with pytest.raises(ValueError):
        pmega.pack_decode_weights(tp, pc)
    m = port.FlamingoModel(pc, params=tp, device="cpu")
    for beams in (1, 3):
        with pytest.raises(ValueError):
            m.generate(np.ones((2, 3), np.int32), max_length=8, megakernel=True,
                       num_beams=beams)


# ---------------------------------------------------------------------------
# greedy tokens
# ---------------------------------------------------------------------------


def _jax_generate(jc, params, pol, ids, media, mask, pixels, **kw):
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0,
                         prefix_block=PREFIX_BLOCK, **kw)
    toks, n, _, _ = _generate_impl(params, jc, dc, pol, jnp.asarray(ids),
                                   jnp.asarray(media), jnp.asarray(mask), None,
                                   jnp.asarray(pixels), jax.random.PRNGKey(0))
    assert int(n) == MAX_LENGTH
    return np.asarray(toks)


def _port_generate(pc, tp, ids, media, mask, pixels, **kw):
    m = port.FlamingoModel(pc, params=tp, device="cpu")
    return m.generate(ids, media_locations=media, attention_mask=mask,
                      pixel_values=pixels, max_length=MAX_LENGTH, eos_token_id=EOS,
                      pad_token_id=0, prefix_block=PREFIX_BLOCK, **kw).numpy()


@pytest.mark.parametrize("layout", ["pre", "post"])
def test_greedy_f32_tokens_identical(models, layout):
    jc, pc, params, tp = _model(models, layout)
    ids, media, mask, pixels = _prompts()
    want = _jax_generate(jc, params, jl.PARITY, ids, media, mask, pixels)
    got = _port_generate(pc, tp, ids, media, mask, pixels)
    assert got.shape == (4, MAX_LENGTH)
    np.testing.assert_array_equal(got, want)
    # the prefill logits (the first generated token's distribution)
    vf = jflam.encode_resample_visuals(params, jc, jnp.asarray(pixels), policy=jl.PARITY)
    dc = JaxDecodeConfig(max_length=MAX_LENGTH)
    jlog, _, _ = jax_prefill(params, jc, dc, jl.PARITY, jnp.asarray(ids),
                             jnp.asarray(media), jnp.asarray(mask), vf, flat=True)
    plog, _, _ = _prefill(tp, pc, DecodeConfig(max_length=MAX_LENGTH), pl.PARITY,
                          _t(ids).long(), _t(media), _t(mask), _t(np.asarray(vf)))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=1e-5, rtol=0)


def _agree_up_to_near_ties(jc, params, got, want, media, mask, pixels, ulps=2):
    """Rows equal, or parting where JAX's own top two logits for that slot
    (its per-layer prefill of the prefix) are within ``ulps`` bf16 ulps and
    ``got``'s pick is among them. Returns the number of tokens compared."""
    L = media.shape[1]
    np.testing.assert_array_equal(got[:, :L], want[:, :L])
    vf = None    # JAX's visual features, made at the first parting
    compared = 0
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r, L:] != want[r, L:])[0]
        if not len(diff):
            compared += MAX_LENGTH - L
            continue
        if vf is None:
            vf = jflam.encode_resample_visuals(
                params, jc, jl.FAST.cast(jnp.asarray(pixels)), policy=jl.FAST)
        t = L + int(diff[0])
        compared += t - L
        ext = ((0, 0), (0, t - L))
        logits, _, _ = jax_prefill(
            params, jc, JaxDecodeConfig(max_length=MAX_LENGTH), jl.FAST,
            jnp.asarray(want[:, :t]), jnp.asarray(np.pad(media, ext)),
            jnp.asarray(np.pad(mask, ext, constant_values=1)), vf, flat=True)
        row = np.asarray(logits[r], np.float32)
        top = np.sort(row)[::-1]
        ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
        assert top[0] - top[1] <= ulps * ulp, (r, t, top[:2])
        assert row[got[r, t]] >= top[0] - ulps * ulp, (r, t, got[r, t])
    assert compared >= 0.5 * want.shape[0] * (MAX_LENGTH - L), compared
    return compared


@pytest.mark.parametrize("layout,megakernel", [("pre", False), ("pre", True),
                                               ("post", False)],
                         ids=["pre-per_layer", "pre-megakernel", "post-per_layer"])
def test_greedy_bf16_int8_near_ties(models, layout, megakernel):
    """The int8 trunk and xattn with the fused head; the megakernel path
    against JAX's megakernel (interpret mode)."""
    jc, pc, params, tp = _model(models, layout, "bfloat16")
    ids, media, mask, pixels = _prompts(seed=3)
    want = _jax_generate(jc, params, jl.FAST, ids, media, mask, pixels,
                         megakernel=megakernel)
    got = _port_generate(pc, tp, ids, media, mask, pixels, megakernel=megakernel)
    _agree_up_to_near_ties(jc, params, got, want, media, mask, pixels)


# ---------------------------------------------------------------------------
# beams
# ---------------------------------------------------------------------------


def _beam(jax_side, jc, pc, params, tp, pol, ids, media, mask, pixels, **kw):
    kw = dict(max_length=MAX_LENGTH, pad_token_id=0, prefix_block=PREFIX_BLOCK,
              eos_token_id=EOS, num_beams=3, return_scores=True, **kw)
    if jax_side:
        out = jbs.beam_generate(params, jc, JaxDecodeConfig(**kw), pol[0], jnp.asarray(ids),
                                jnp.asarray(media), jnp.asarray(mask), None,
                                pixel_values=jnp.asarray(pixels))
        return tuple(np.asarray(t) for t in out)
    out = pbs.beam_generate(tp, pc, DecodeConfig(**kw), pol[1], _t(ids).long(),
                            _t(media), _t(mask), None, pixel_values=_t(pixels))
    return tuple(t.numpy() for t in out)


@pytest.mark.parametrize("layout", ["pre", "post"])
def test_beam_f32_matches_jax(models, layout):
    """k=3, per layer: tokens identical, sequence scores within 1e-5."""
    jc, pc, params, tp = _model(models, layout)
    args = (jc, pc, params, tp, (jl.PARITY, pl.PARITY)) + _prompts(seed=4)
    wt, ws = _beam(True, *args)
    gt, gs = _beam(False, *args)
    assert gt.shape == (4, MAX_LENGTH) and gs.shape == (4,)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)


def test_beam_bf16_megakernel_matches_jax_megakernel(models):
    """b=8, k=3 (24 rows: JAX runs its megakernel in interpret mode), bf16
    int8: rows equal to JAX's with scores within 2e-2, at most a quarter of
    them parting (tests/test_torch_beam.py's rule); the port's megakernel
    beams equal its per-layer beams."""
    jc, pc, params, tp = _model(models, "pre", "bfloat16")
    args = (jc, pc, params, tp, (jl.FAST, pl.FAST)) + _prompts(b=8, seed=5)
    wt, ws = _beam(True, *args, megakernel=True)
    gt, gs = _beam(False, *args, megakernel=True)
    assert gt.shape == (8, MAX_LENGTH)
    same = [r for r in range(8) if np.array_equal(gt[r], wt[r])]
    assert len(same) >= 6, same
    np.testing.assert_allclose(gs[same], ws[same], atol=2e-2, rtol=0)
    lt, ls = _beam(False, *args, megakernel=False)
    np.testing.assert_array_equal(gt, lt)
    np.testing.assert_allclose(gs, ls, atol=2e-2, rtol=0)
