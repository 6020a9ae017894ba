"""Multi-image and video prompts through the port, against the JAX package.

Same weights on both sides (the JAX package initialises them,
``from_jax_numpy`` carries them over) and the same numpy inputs. Two small
models, each built once: ``tests/test_torch_forward.py``'s (GPT-2 D=128, 2
layers, xattn before each, a 2-layer ViT on 64-px images, a 2-layer
resampler of 8 latents, vocab 256), float32, bf16 with an int8 trunk and
xattn (the megakernel), and with ``resampler_num_time_embeds=8`` (8-frame
clips); and ``tests/test_torch_beam.py``'s small float32 one for the 4-D
pixel repeat and beams. Prompts carry four images (or two clips of 8
frames) at the places BASELINE's few-shot and video configurations put
them, rows whose first tokens come before any image (``text_time`` 0), a
row that sees images 1-4 at 16-token steps (``bench_extended.py:58-60``),
and a left-padded row.

Tolerances: float32 logits 1e-4 of their scale and the loss 1e-5 relative
(``test_torch_forward.py``'s), visual features and xattn outputs 1e-5;
float32 greedy and beam tokens identical, beam scores 1e-5; sampled step
scores 1e-5 against JAX, and the 4-D and 5-D pixels' runs of the port
within 1e-6 of each other (the same float32 arithmetic). The bf16
megakernel (its plain version here, JAX's Pallas megakernel in interpret
mode there): rows equal, or a row parts where JAX's own top two logits lie
within 2 bf16 ulps and the port's pick among them
(``test_torch_megakernel.py``'s rule), over at least half the tokens.
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
from flamingo_mini_tpu.models import xattn as jxattn
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops import quant as jq

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import beam_search as pbs
from flamingo_mini_tpu_torch import generation as pgen
from flamingo_mini_tpu_torch.generation import DecodeConfig, generate_impl
from flamingo_mini_tpu_torch.models import flamingo as pflam
from flamingo_mini_tpu_torch.models import xattn as pxattn
from flamingo_mini_tpu_torch.ops import layers as pl
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy
from test_torch_beam import SMALL as BEAM_SMALL, _open_gates
from test_torch_sampling import _feed_jax_noise

SMALL = dict(
    lm="gpt2", dim=128, dim_visual=64, xattn_every=1, xattn_dim_head=32,
    xattn_heads=4, resampler_depth=2, resampler_dim_head=16,
    resampler_heads=4, resampler_num_latents=8,
    lm_arch_overrides=dict(vocab_size=256, n_positions=128, n_embd=128,
                           n_layer=2, n_head=4),
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=2, num_attention_heads=4,
                               image_size=64, patch_size=16))
J_PALLAS_F32 = jl.Policy(jnp.float32, jax.lax.Precision.HIGHEST, pallas=True)
P_PALLAS_F32 = pl.Policy(torch.float32, pallas=True)
POLICIES = {"plain": (jl.PARITY, pl.PARITY), "use_pallas": (J_PALLAS_F32, P_PALLAS_F32)}
N_MEDIA, LATENTS, FRAMES = 4, 8, 8
MAX_LENGTH, PREFIX_BLOCK, EOS = 32, 8, 999   # EOS unreachable (vocab 257)


def _build(compute_dtype="float32", quantize=False, **over):
    """(jax config, port config, jax params, port params), gates open."""
    cfg = dict(SMALL, **over)
    jc = JaxConfig(compute_dtype=compute_dtype, **cfg)
    pc = port.FlamingoConfig(compute_dtype=compute_dtype, **cfg)
    params = jflam.init_flamingo(jax.random.PRNGKey(7), jc)
    _open_gates(params)
    if quantize:
        params["lm"] = jq.quantize_gpt2_lm(params["lm"])
        params["xattn"] = jq.quantize_xattn_blocks(params["xattn"])
    if compute_dtype == "bfloat16":
        params = jq.cast_params_bf16(params)
    return jc, pc, params, from_jax_numpy(jax.tree_util.tree_map(np.asarray, params),
                                          device="cpu")


@pytest.fixture(scope="module")
def f32():
    return _build()


@pytest.fixture(scope="module")
def int8_bf16():
    return _build("bfloat16", quantize=True)


@pytest.fixture(scope="module")
def video():
    return _build(resampler_num_time_embeds=FRAMES)


@pytest.fixture(scope="module")
def beam_small():
    """``tests/test_torch_beam.py``'s small float32 model, gates open."""
    jc, pc = JaxConfig(**BEAM_SMALL), port.FlamingoConfig(**BEAM_SMALL)
    params = jflam.init_flamingo(jax.random.PRNGKey(0), jc)
    _open_gates(params)
    return jc, pc, params, from_jax_numpy(jax.tree_util.tree_map(np.asarray, params),
                                          device="cpu")


def _four_images(n, seed=0, image_size=64):
    """Four rows of ``n`` tokens over four images each: row 0 sees images
    1-4 at n/4-token steps (n = 64: bench_extended.py's 16); row 1's first
    3 tokens come before any image (text_time 0); row 2 is left-padded by 4,
    its first two images back to back; row 3 takes its last two images in
    its last two tokens."""
    rs = np.random.RandomState(seed)
    b = 4
    ids = rs.randint(5, 250, (b, n)).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    media = np.zeros((b, n), np.int32)
    step = n // N_MEDIA
    media[0, ::step] = 1
    media[1, [3, 3 + step, 3 + 2 * step, n - 2]] = 1
    ids[2, :4], mask[2, :4] = 0, 0
    media[2, [4, 5, n - 2, n - 1]] = 1
    media[3, [0, step, n - 2, n - 1]] = 1
    pixels = rs.randn(b, N_MEDIA, 3, image_size, image_size).astype(np.float32)
    return ids, media, mask, pixels


def _jax_generate(jc, params, pol, ids, media, mask, *, pixels=None, feats=None,
                  **kw):
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0,
                         prefix_block=PREFIX_BLOCK, **kw)
    out, _, _, _ = _generate_impl(
        params, jc, dc, pol, jnp.asarray(ids), jnp.asarray(media), jnp.asarray(mask),
        None if feats is None else jnp.asarray(feats),
        None if pixels is None else jnp.asarray(pixels), jax.random.PRNGKey(0))
    return np.asarray(out)


def _port_generate(pc, tp, pol, ids, media, mask, *, pixels=None, feats=None, **kw):
    dc = DecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0,
                      prefix_block=PREFIX_BLOCK, **kw)
    with torch.inference_mode():
        return generate_impl(
            tp, pc, dc, pol, torch.tensor(ids).long(), torch.tensor(media),
            torch.tensor(mask), visual_features=None if feats is None else
            torch.tensor(feats).to(pol.dtype),
            pixel_values=None if pixels is None else torch.tensor(pixels)).numpy()


# ---------------------------------------------------------------------------
# 4-D pixels: one prompt's media, repeated as a row before sampling's
# num_return_sequences and beams
# ---------------------------------------------------------------------------


def _one_prompt(seed=2):
    """A 1 x 6 prompt with images at slots 0 and 3, its pixels 4-D."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 250, (1, 6)).astype(np.int32)
    media = np.zeros((1, 6), np.int32)
    media[0, [0, 3]] = 1
    return ids, media, np.ones((1, 6), np.int32), \
        rs.randn(2, 3, 32, 32).astype(np.float32)


@pytest.mark.parametrize("n", [2, 1])
def test_4d_pixels_sampled_return_sequences(beam_small, n, monkeypatch):
    """Sampling n sequences from 4-D (N c h w) pixels: the step scores and
    tokens equal those from the same images given as (1, N, c, h, w), and
    JAX's on the 5-D form (JAX's own noise). Before the repair a 4-D input
    was repeated on N, so the row of text_time 2 attended a copy of image 1
    (step scores off by up to 1.9e-3 at n = 2)."""
    from test_torch_sampling import _jax_generate as jax_sample
    from test_torch_sampling import _port_generate as port_sample
    jc, pc, params, tp = beam_small
    ids, media, mask, px4 = _one_prompt()
    px5 = px4[None]
    key = jax.random.PRNGKey(5)
    kw = dict(do_sample=True, num_return_sequences=n, eos_token_id=9999,
              return_scores=True, output_scores=True)
    want = jax_sample(jc, params, jl.PARITY, ids, media, mask, pixels=px5, key=key, **kw)
    runs = {}
    for name, px in (("4-D", px4), ("5-D", px5)):
        _feed_jax_noise(monkeypatch, key, ids.shape[1])
        runs[name] = port_sample(pc, tp, ids, media, mask, pixels=px, **kw)
    for (t4, s4, st4), (t5, s5, st5) in [(runs["4-D"], runs["5-D"])]:
        assert t4.shape == (n, want[0].shape[1])
        np.testing.assert_array_equal(t4, t5)
        np.testing.assert_allclose(st4, st5, rtol=0, atol=1e-6)
        np.testing.assert_allclose(s4, s5, rtol=0, atol=1e-6)
    tokens, scores, steps = runs["4-D"]
    np.testing.assert_array_equal(tokens, want[0])
    np.testing.assert_allclose(scores, want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(steps, want[2], rtol=0, atol=1e-5)


def test_4d_pixels_beams(beam_small):
    """Beams (k=3, the top 2 returned with their scores) from 4-D pixels,
    through ``beam_generate`` and through ``FlamingoModel.generate``: the
    same as from the 5-D form, and as JAX's beams on the 5-D form."""
    from test_torch_beam import MAX_LENGTH as BEAM_MAX, PREFIX_BLOCK as BEAM_PB
    from test_torch_beam import _jax_beam, _port_beam
    jc, pc, params, tp = beam_small
    ids, media, mask, px4 = _one_prompt(seed=3)
    kw = dict(num_beams=3, num_return_sequences=2, return_scores=True,
              eos_token_id=9999)
    wt, ws = _jax_beam(jc, params, jl.PARITY, ids, media, mask, pixels=px4[None], **kw)
    for px in (px4, px4[None]):
        gt, gs = _port_beam(pc, tp, pl.PARITY, ids, media, mask, pixels=px, **kw)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    gt, gs = model.generate(ids, media_locations=media, attention_mask=mask,
                            pixel_values=px4, max_length=BEAM_MAX, pad_token_id=0,
                            prefix_block=BEAM_PB, **kw)
    np.testing.assert_array_equal(gt.numpy(), wt)
    np.testing.assert_allclose(gs.numpy(), ws, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# masked cross-attention over four media
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", list(POLICIES))
def test_xattn_four_media_matches_jax(f32, policy):
    """``apply_masked_xattn`` over 4 x 8 latents, text_time 0-4 (and one
    row past the media count): within 1e-5 of JAX; rows of text_time 0
    exactly 0."""
    jc, pc, params, tp = f32
    jpol, ppol = POLICIES[policy]
    rs = np.random.RandomState(4)
    b, n = 4, 40
    y = rs.randn(b, n, jc.dim).astype(np.float32)
    feats = rs.randn(b, N_MEDIA, LATENTS, jc.dim_visual).astype(np.float32)
    text_time = np.cumsum(_four_images(n, seed=4)[1], axis=1).astype(np.int32)
    text_time[3, -3:] = N_MEDIA + 1          # past the media count
    kw = dict(n_visual=LATENTS, heads=jc.xattn_heads, dim_head=jc.xattn_dim_head)
    blk, pblk = params["xattn"]["0"]["attn"], tp["xattn"]["0"]["attn"]
    jkv = jxattn.compute_visual_kv(blk, jnp.asarray(feats), heads=jc.xattn_heads,
                                   policy=jpol)
    want = np.asarray(jxattn.apply_masked_xattn(blk, jnp.asarray(y), jkv,
                                                jnp.asarray(text_time), policy=jpol, **kw))
    pkv = pxattn.compute_visual_kv(pblk, torch.tensor(feats), heads=jc.xattn_heads)
    got = pxattn.apply_masked_xattn(pblk, torch.tensor(y), pkv, torch.tensor(text_time),
                                    policy=ppol, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (text_time == 0).sum() == 3 + 4      # row 1's first 3, row 2's pads
    assert (got[text_time == 0] == 0).all()


# ---------------------------------------------------------------------------
# forward and loss, greedy: four images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", list(POLICIES))
def test_forward_four_images_matches_jax(f32, policy):
    """The uncached forward with its loss over 64-token rows of four images
    (row 0 at 16-token steps, row 1's first tokens before any image, row 2
    left-padded)."""
    jc, pc, params, tp = f32
    jpol, ppol = POLICIES[policy]
    ids, media, mask, pixels = _four_images(64, seed=1)
    want = jflam.forward(params, jc, jnp.asarray(ids), policy=jpol,
                         media_locations=jnp.asarray(media),
                         attention_mask=jnp.asarray(mask),
                         pixel_values=jnp.asarray(pixels), labels=jnp.asarray(ids))
    got = pflam.forward(tp, pc, torch.tensor(ids).long(), policy=ppol,
                        media_locations=torch.tensor(media),
                        attention_mask=torch.tensor(mask),
                        pixel_values=torch.tensor(pixels),
                        labels=torch.tensor(ids).long())
    wl = np.asarray(want.logits)
    assert got.logits.shape == wl.shape == (4, 64, jc.lm_arch.vocab_size + 1)
    np.testing.assert_allclose(got.logits.numpy(), wl, rtol=0, atol=1e-4 * np.abs(wl).max())
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-5)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_greedy_four_images_matches_jax(f32, policy):
    """Greedy per layer over a 24-token prompt of four images a row
    (``prefix_block`` segments): tokens identical to JAX's; under
    use_pallas the media prefill runs ``fused_media_xattn``'s plain
    version over the 32 keys."""
    jc, pc, params, tp = f32
    jpol, ppol = POLICIES[policy]
    ids, media, mask, pixels = _four_images(24, seed=2)
    want = _jax_generate(jc, params, jpol, ids, media, mask, pixels=pixels)
    got = _port_generate(pc, tp, ppol, ids, media, mask, pixels=pixels)
    assert got.shape == (4, MAX_LENGTH)
    np.testing.assert_array_equal(got, want)


def test_beams_four_images_matches_jax(beam_small):
    """Beams over four images a row: each family tiles its row's text_time
    and xattn K/V; tokens identical, scores within 1e-5."""
    from test_torch_beam import _jax_beam, _port_beam
    jc, pc, params, tp = beam_small
    ids, media, mask, pixels = _four_images(8, seed=6, image_size=32)
    kw = dict(num_beams=3, return_scores=True, eos_token_id=9999)
    wt, ws = _jax_beam(jc, params, jl.PARITY, ids, media, mask, pixels=pixels, **kw)
    gt, gs = _port_beam(pc, tp, pl.PARITY, ids, media, mask, pixels=pixels, **kw)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the megakernel: four images, 32 latents a row
# ---------------------------------------------------------------------------


@jax.jit
def _jax_next_logits(params, ids, media, mask, feats):
    """JAX's bf16 logits for the token after ``ids`` (flat-cache prefill)."""
    jc = JaxConfig(compute_dtype="bfloat16", **SMALL)
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0)
    logits, _, _ = jax_prefill(params, jc, dc, jl.FAST, ids, media, mask, feats,
                               flat=True)
    return logits


def test_megakernel_four_images_matches_jax(int8_bf16, monkeypatch):
    """The megakernel path (its plain version) over 4 x 8 media latents a
    row against JAX's megakernel in interpret mode; the port's fit check
    is asked for 32 latents a row, from the pixels and from the features."""
    jc, pc, params, tp = int8_bf16
    ids, media, mask, pixels = _four_images(24, seed=3)
    L = ids.shape[1]
    feats = np.asarray(jflam.encode_resample_visuals(
        params, jc, jnp.asarray(pixels, jnp.bfloat16), policy=jl.FAST).astype(jnp.float32))
    want = _jax_generate(jc, params, jl.FAST, ids, media, mask, feats=feats,
                         megakernel=True)
    asked = []
    check = pgen.megadecode.check_fits
    monkeypatch.setattr(pgen.megadecode, "check_fits",
                        lambda *a, **k: asked.append(a[3]) or check(*a, **k))
    got = _port_generate(pc, tp, pl.FAST, ids, media, mask, feats=feats, megakernel=True)
    _port_generate(pc, tp, pl.FAST, ids[:1], media[:1], mask[:1], megakernel=True,
                   pixels=pixels[:1])
    assert asked == [N_MEDIA * LATENTS] * 2, asked
    np.testing.assert_array_equal(got[:, :L], want[:, :L])
    compared = 0
    for r in range(ids.shape[0]):
        diff = np.nonzero(got[r, L:] != want[r, L:])[0]
        if not len(diff):
            compared += MAX_LENGTH - L
            continue
        t = L + int(diff[0])
        compared += t - L
        ext = ((0, 0), (0, t - L))
        row = np.asarray(_jax_next_logits(
            params, jnp.asarray(want[:, :t]), jnp.asarray(np.pad(media, ext)),
            jnp.asarray(np.pad(mask, ext, constant_values=1)),
            jnp.asarray(feats, jnp.bfloat16))[r], np.float32)
        top = np.sort(row)[::-1]
        ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
        assert top[0] - top[1] <= 2 * ulp, (r, t, top[:2])
        assert row[got[r, t]] >= top[0] - 2 * ulp, (r, t, got[r, t])
    assert compared >= 0.5 * ids.shape[0] * (MAX_LENGTH - L), compared


# ---------------------------------------------------------------------------
# video: 8-frame clips through the resampler's time embeddings
# ---------------------------------------------------------------------------


def _clips(seed=8):
    """Two rows of 6 tokens over two 8-frame clips: row 0's clips at slots
    0 and 3, row 1 left-padded by 2 with its clips at 2 and 4."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 250, (2, 6)).astype(np.int32)
    mask = np.ones((2, 6), np.int32)
    media = np.zeros((2, 6), np.int32)
    media[0, [0, 3]] = 1
    ids[1, :2], mask[1, :2] = 0, 0
    media[1, [2, 4]] = 1
    return ids, media, mask, rs.randn(2, 2, FRAMES, 3, 64, 64).astype(np.float32)


@pytest.mark.parametrize("policy", list(POLICIES))
def test_video_matches_jax(video, policy):
    """6-D pixels (b, N, T=8, c, h, w) with resampler_num_time_embeds=8:
    ``encode_resample_visuals`` within 1e-5 of JAX, greedy tokens identical
    (under use_pallas the resampler's fused attention runs over 8 x 17 + 8
    keys)."""
    jc, pc, params, tp = video
    jpol, ppol = POLICIES[policy]
    ids, media, mask, pixels = _clips()
    want = jflam.encode_resample_visuals(params, jc, jnp.asarray(pixels), policy=jpol)
    got = pflam.encode_resample_visuals(tp, pc, torch.tensor(pixels), policy=ppol)
    assert got.shape == (2, 2, LATENTS, jc.dim_visual)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the time embeddings matter: the frames reversed give other features
    rev = pflam.encode_resample_visuals(tp, pc, torch.tensor(pixels[:, :, ::-1].copy()),
                                        policy=ppol)
    assert not np.allclose(rev.numpy(), got.numpy(), atol=1e-3)
    wt = _jax_generate(jc, params, jpol, ids, media, mask, pixels=pixels)
    gt = _port_generate(pc, tp, ppol, ids, media, mask, pixels=pixels)
    np.testing.assert_array_equal(gt, wt)
