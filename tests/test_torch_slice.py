"""The port's greedy captioning slice against the JAX package.

Same weights on both sides: the JAX package initialises them, and
``utils.params_bridge.from_jax_numpy`` carries them into the port through
numpy. Inputs come from ``numpy.random.RandomState``. The model is small:
2 GPT-2 layers (D=128, H=4) with xattn before each, a 2-layer ViT on 64-px
images, vocab 256, batch 4 with a left-padded row, 24 tokens, live-prefix
segments of 8. The xattn gates are set nonzero so that the image changes
the tokens.

Tolerances. float32 runs at full precision on both sides (JAX PARITY is
``Precision.HIGHEST``): modules agree to 1e-5 absolute (summation order
only), prefill logits to 1e-5, and greedy tokens are identical. The bf16 +
int8 + fused-head run rounds to bf16 at points the two frameworks choose
differently (XLA may keep float32 across a fused elementwise chain), so a
row's tokens may part where JAX's own top two logits are within 2 bf16
ulps; the test asserts that at the first difference of each row and stops
comparing that row there.
"""
import functools
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu.generation import (DecodeConfig as JaxDecodeConfig,
                                          _generate_impl, _prefill as jax_prefill)
from flamingo_mini_tpu.models import clip_vit as jvit
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.models import resampler as jres
from flamingo_mini_tpu.models import xattn as jx
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops import quant as jq

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.generation import DecodeConfig, _prefill
from flamingo_mini_tpu_torch.models import clip_vit as pvit
from flamingo_mini_tpu_torch.models import flamingo as pflam
from flamingo_mini_tpu_torch.models import resampler as pres
from flamingo_mini_tpu_torch.models import xattn as px
from flamingo_mini_tpu_torch.ops import layers as pl
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(
    lm="gpt2", dim=128, dim_visual=64, xattn_every=1, xattn_dim_head=32,
    xattn_heads=4, resampler_depth=2, resampler_dim_head=16,
    resampler_heads=4, resampler_num_latents=8,
    lm_arch_overrides=dict(vocab_size=256, n_positions=64, n_embd=128,
                           n_layer=2, n_head=4),
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=2, num_attention_heads=4,
                               image_size=64, patch_size=16))
MAX_LENGTH, PREFIX_BLOCK, EOS = 24, 8, 999   # EOS unreachable (vocab 257)


def _small(compute_dtype):
    """(jax config, port config, jax params, port params, jax policy,
    port policy); bf16 adds the int8 trunk + xattn and the bf16 cast."""
    jc = JaxConfig(compute_dtype=compute_dtype, **SMALL)
    pc = port.FlamingoConfig(compute_dtype=compute_dtype, **SMALL)
    params = jflam.init_flamingo(jax.random.PRNGKey(0), jc)
    for blk in params["xattn"].values():
        blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
        blk["alpha_ffw"] = jnp.full((1,), 0.5, jnp.float32)
    if compute_dtype == "bfloat16":
        params["lm"] = jq.quantize_gpt2_lm(params["lm"])
        params["xattn"] = jq.quantize_xattn_blocks(params["xattn"])
        params = jq.cast_params_bf16(params)
        pols = jl.FAST, pl.FAST
    else:
        pols = jl.PARITY, pl.PARITY
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return (jc, pc, params, tp) + pols


@pytest.fixture(scope="module")
def f32():
    return _small("float32")


@pytest.fixture(scope="module")
def bf16():
    return _small("bfloat16")


def _prompts(seed=0, b=4, L=5):
    """Left-padded row 1 (its image at slot 2), image at slot 0 elsewhere."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 250, (b, L)).astype(np.int32)
    mask = np.ones((b, L), np.int32)
    ids[1, :2], mask[1, :2] = 0, 0
    media = np.zeros((b, L), np.int32)
    media[:, 0] = 1
    media[1] = 0
    media[1, 2] = 1
    pixels = rs.randn(b, 1, 3, 64, 64).astype(np.float32)
    return ids, media, mask, pixels


def _jax_generate(jc, params, pol, ids, media, mask, pixels, eos=EOS):
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=eos,
                         pad_token_id=0, prefix_block=PREFIX_BLOCK)
    toks, n, _, _ = _generate_impl(
        params, jc, dc, pol, jnp.asarray(ids), jnp.asarray(media),
        jnp.asarray(mask), None, jnp.asarray(pixels), jax.random.PRNGKey(0))
    return np.asarray(toks), int(n)


@functools.partial(jax.jit, static_argnames=("jc", "pol"))
def _jax_next_logits(params, ids, media, mask, pixels, *, jc, pol):
    """JAX's logits for the token after ``ids`` (vision + prefill), and the
    resampled visual features."""
    vf = jflam.encode_resample_visuals(params, jc, pol.cast(pixels), policy=pol)
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0)
    logits, _, _ = jax_prefill(params, jc, dc, pol, ids, media, mask, vf,
                               flat=True)
    return logits, vf


def _port_generate(pc, tp, ids, media, mask, pixels, eos=EOS):
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    out = model.generate(ids, media_locations=media, attention_mask=mask,
                         pixel_values=pixels, max_length=MAX_LENGTH,
                         eos_token_id=eos, pad_token_id=0,
                         prefix_block=PREFIX_BLOCK)
    return out.numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# modules, float32
# ---------------------------------------------------------------------------


def test_clip_vit_matches_jax(f32):
    jc, pc, params, tp, jpol, ppol = f32
    pixels = _prompts()[3][:, 0]
    want = jvit.apply_clip_vit(params["vision"], jnp.asarray(pixels),
                               arch=jc.vision_arch, policy=jpol)
    got = pvit.apply_clip_vit(tp["vision"], _t(pixels), arch=pc.vision_arch,
                              policy=ppol)
    assert got.shape == (4, 17, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("frames", [1, 3])
def test_resampler_matches_jax(f32, frames):
    jc, pc, params, tp, jpol, ppol = f32
    feats = np.random.RandomState(frames).randn(2, frames, 17, 64).astype(np.float32)
    kw = dict(heads=jc.resampler_heads, dim_head=jc.resampler_dim_head,
              act=jc.resampler_act)
    want = jres.apply_resampler(params["resampler"], jnp.asarray(feats),
                                policy=jpol, **kw)
    got = pres.apply_resampler(tp["resampler"], _t(feats), policy=ppol, **kw)
    assert got.shape == (2, 8, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_gated_xattn_block_matches_jax(f32):
    """Two images; tokens before the first image (text_time 0) get no
    visual attention; alphas are nonzero."""
    jc, pc, params, tp, jpol, ppol = f32
    rs = np.random.RandomState(5)
    vis = rs.randn(2, 2, 8, 64).astype(np.float32)
    y = rs.randn(2, 7, 128).astype(np.float32)
    media = np.zeros((2, 7), np.int32)
    media[0, [1, 4]] = 1
    media[1, 3] = 1
    text_time = np.cumsum(media, axis=-1)
    kw = dict(n_visual=8, heads=jc.xattn_heads, dim_head=jc.xattn_dim_head,
              act=jc.xattn_act)
    jblk = params["xattn"]["0"]
    jkv = jx.compute_visual_kv(jblk["attn"], jnp.asarray(vis),
                               heads=jc.xattn_heads, policy=jpol)
    want = jx.apply_gated_xattn_block(jblk, jnp.asarray(y), jkv,
                                      jnp.asarray(text_time), policy=jpol, **kw)
    pblk = tp["xattn"]["0"]
    pkv = px.compute_visual_kv(pblk["attn"], _t(vis), heads=jc.xattn_heads)
    got = px.apply_gated_xattn_block(pblk, _t(y), pkv, _t(text_time),
                                     policy=ppol, **kw)
    for g, w in zip(pkv, jkv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    assert not np.allclose(np.asarray(want), y)   # the gates are open
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def f32_jax_tokens(f32):
    jc, pc, params, tp, jpol, ppol = f32
    return _jax_generate(jc, params, jpol, *_prompts())


def test_greedy_slice_f32_tokens_identical(f32, f32_jax_tokens):
    jc, pc, params, tp, jpol, ppol = f32
    ids, media, mask, pixels = _prompts()
    want, n = f32_jax_tokens
    got = _port_generate(pc, tp, ids, media, mask, pixels)
    assert n == MAX_LENGTH and got.shape == (4, MAX_LENGTH)
    np.testing.assert_array_equal(got, want)

    # prefill logits (the first generated token's distribution)
    jlog, vf = _jax_next_logits(params, ids, media, mask, pixels, jc=jc, pol=jpol)
    pvf = pflam.encode_resample_visuals(tp, pc, _t(pixels), policy=ppol)
    np.testing.assert_allclose(pvf.numpy(), np.asarray(vf), atol=1e-5, rtol=1e-5)
    plog, _, _ = _prefill(tp, pc, DecodeConfig(max_length=MAX_LENGTH), ppol,
                          _t(ids).long(), _t(media), _t(mask), pvf)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=1e-5, rtol=0)


def test_greedy_slice_f32_eos_pads_identical(f32, f32_jax_tokens):
    """EOS reachable: a token row 0 emits early becomes the EOS id, so rows
    finish mid-segment and emit pad from the next step on."""
    jc, pc, params, tp, jpol, ppol = f32
    ids, media, mask, pixels = _prompts()
    L = ids.shape[1]
    eos = int(f32_jax_tokens[0][0, L + 2])
    assert eos != 0                       # pad stays distinct from EOS
    want, _ = _jax_generate(jc, params, jpol, ids, media, mask, pixels, eos=eos)
    got = _port_generate(pc, tp, ids, media, mask, pixels, eos=eos)
    np.testing.assert_array_equal(got, want)
    first = L + int(np.argmax(got[0, L:] == eos))
    assert first < MAX_LENGTH - 1 and (got[0, first + 1:] == 0).all()


def test_greedy_slice_bf16_int8_fused_head(bf16):
    jc, pc, params, tp, jpol, ppol = bf16
    ids, media, mask, pixels = _prompts()
    want, n = _jax_generate(jc, params, jpol, ids, media, mask, pixels)
    got = _port_generate(pc, tp, ids, media, mask, pixels)
    assert n == MAX_LENGTH and got.shape == want.shape
    L = ids.shape[1]
    np.testing.assert_array_equal(got[:, :L], want[:, :L])
    compared = 0
    for r in range(ids.shape[0]):
        diff = np.nonzero(got[r, L:] != want[r, L:])[0]
        if not len(diff):
            compared += MAX_LENGTH - L
            continue
        t = L + int(diff[0])
        compared += t - L
        # JAX's own logits for the token at slot t, from the prompt plus
        # the tokens JAX generated before it
        ext = ((0, 0), (0, t - L))
        logits, _ = _jax_next_logits(
            params, want[:, :t], np.pad(media, ext),
            np.pad(mask, ext, constant_values=1), pixels, jc=jc, pol=jpol)
        row = np.asarray(logits[r], np.float32)
        top = np.sort(row)[::-1]
        ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
        assert top[0] - top[1] <= 2 * ulp, (r, t, top[:2])
        assert row[got[r, t]] >= top[0] - 2 * ulp, (r, t, got[r, t])
    # the near-tie rule must not carry the test: most tokens are compared
    assert compared >= 0.5 * ids.shape[0] * (MAX_LENGTH - L), compared


# ---------------------------------------------------------------------------
# the package boundary
# ---------------------------------------------------------------------------


def test_generate_rejects_unported_options(f32):
    jc, pc, params, tp, jpol, ppol = f32
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    # the searches run per layer (tests/test_torch_beam_sample.py,
    # test_torch_constrained.py and test_torch_contrastive.py hold them to
    # JAX), and so do the KV-cache variants (tests/test_torch_kv_cache.py)
    for knob in (dict(num_beams=3, do_sample=True),
                 dict(penalty_alpha=0.6, top_k=4),
                 dict(num_beams=3, force_words_ids=[[5]]),
                 dict(num_beams=3, beam_reorder="gather"), dict(int8_kv_cache=True),
                 dict(flat_kv_cache=False)):
        out = model.generate(np.ones((1, 3), np.int32), max_length=8, **knob)
        assert out.shape == (1, 8), knob
    # w8a8 is a megakernel tier: without the megakernel it is refused, as
    # JAX's DecodeConfig refuses it; the megakernel refuses the int8 KV cache
    for knob in (dict(w8a8=True), dict(megakernel=True, int8_kv_cache=True)):
        with pytest.raises(ValueError):
            model.generate(np.ones((1, 3), np.int32), max_length=8, **knob)


def test_import_without_jax():
    """The port imports no jax and loads no file of the JAX package, by
    import or by path: every module of the package, found by
    ``pkgutil.walk_packages`` (the tools, the examples and the training
    entry point included)."""
    jax_pkg = os.path.join(REPO, "flamingo_mini_tpu") + os.sep
    code = ("import importlib, pkgutil, sys; sys.modules['jax'] = None; "
            "sys.modules['flamingo_mini_tpu'] = None; "
            "import flamingo_mini_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]; "
            "assert {'flamingo_mini_tpu_torch.utils.profiling', "
            "'flamingo_mini_tpu_torch.tools.int8_fidelity', "
            "'flamingo_mini_tpu_torch.examples.export_to_torch', "
            "'flamingo_mini_tpu_torch.train.__main__'} <= set(names), names; "
            "[importlib.import_module(n) for n in names]; "
            "assert 'jax' not in {m.split('.')[0] for m in sys.modules "
            "if sys.modules[m] is not None}; "
            f"bad = [m for m, v in list(sys.modules.items()) if "
            f"(getattr(v, '__file__', None) or '').startswith({jax_pkg!r})]; "
            "assert not bad, bad; print(p.FlamingoModel.__name__)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "FlamingoModel"


def test_entry_points_default_to_the_card():
    """``FlamingoModel`` and ``from_jax_numpy`` run on the card unless the
    caller asks for another device (checked on the signatures: this test
    needs no card)."""
    for fn in (port.FlamingoModel.__init__, from_jax_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_cuda(where, tmp_path):
    """With no card, or without the rest of the repository, chip_smoke.py
    exits nonzero and prints no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
