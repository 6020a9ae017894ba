"""The port's KV-cache variants against the JAX package: the head-major
cache (``flat_kv_cache=False``), the int8 KV cache (``int8_kv_cache``) and
the gather beam reorder (``beam_reorder="gather"``), all plain torch as
they are plain XLA in the JAX package.

Same weights on both sides (the JAX package initialises them,
``from_jax_numpy`` carries them over) and the same numpy inputs. Models,
each built once: ``tests/test_torch_beam.py``'s small GPT-2 (D=256, 4
heads of 64, 2 layers, xattn before each, vocab 256, a 1-layer ViT on
32-px images) in float32, with EOS made likely (beams), and int8/bf16;
``tests/test_torch_opt.py``'s pre-norm OPT (D=128, 4 heads, 2 layers,
xattn every other layer) in float32. Gates open; batches have a
left-padded row whose image comes late.

Tolerances. The int8 codes and their bf16 scales equal JAX's bit for bit
on the same values (exact .5 quotients planted: both round half to even),
and so do the dequantized values. In a model the K/V reach the quantizer
from float32 sums in another order: a value whose quotient lies within
that rounding of a .5 boundary takes the neighbouring code, one step (the
OPT prefill here: 1 code in 7,168). So the float32 prefill logits over
the int8 cache agree within 1e-5 of their scale where every code agrees,
else within 2e-4 (one flipped code moves them by 1.1e-4 of their scale
here), and codes differ by one step at most, in under 0.1 % of them; the
bf16 head-major cache's logits within 1e-5 of their scale; the int8
cache's against the float cache within JAX's own envelope
(``tests/test_quant.py:77-100``: 0.05 x absmax + 0.05). float32 greedy and
beam tokens identical, beam scores within 1e-5, over the int8 cache within
5e-4 relative (a flipped code's 1.1e-3 summed over 8 steps of log-probs
near -4). bf16 with int8 weights:
rows equal, or a row parts where JAX's own top two logits (its int8-KV
prefill over the prefix) lie within 2 bf16 ulps and the port's pick among
them, over at least half the tokens.
"""
from dataclasses import replace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu import beam_search as jbs
from flamingo_mini_tpu.generation import (DecodeConfig as JaxDecodeConfig,
                                          _prefill as jax_prefill)
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops import quant as jq

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import beam_search as pbs
from flamingo_mini_tpu_torch import generation as pgen
from flamingo_mini_tpu_torch.generation import DecodeConfig, _prefill
from flamingo_mini_tpu_torch.models import flamingo as pflam
from flamingo_mini_tpu_torch.ops import layers as pl
from flamingo_mini_tpu_torch.ops import quant as pq
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy
from test_torch_beam import (EOS, SMALL, _bridge, _int8_bf16, _jax_beam,
                             _open_gates, _port_beam, _prompts)
from test_torch_opt import LAYOUTS, SMALL as OPT_SMALL
from test_torch_sampling import (MAX_LENGTH, _jax_generate as jax_generate,
                                 _port_generate as port_generate)

NO_EOS = 9999


def _build(cfg, seed, dtype="float32", eos_likely=False):
    jc = JaxConfig(compute_dtype=dtype, **cfg)
    pc = port.FlamingoConfig(compute_dtype=dtype, **cfg)
    params = jflam.init_flamingo(jax.random.PRNGKey(seed), jc)
    _open_gates(params)
    if eos_likely:
        params["lm"]["wte"] = params["lm"]["wte"].at[EOS].multiply(3.0)
    if dtype == "bfloat16":
        params = _int8_bf16(params)
    return jc, pc, params, _bridge(params)


@pytest.fixture(scope="module")
def models():
    """name -> (jax config, port config, jax params, port params), built on
    first use: "gpt2", "gpt2 eos" (EOS likely), "gpt2 int8" (int8 weights,
    bf16), "opt" (pre-norm)."""
    return {}


MAKERS = {"gpt2": lambda: _build(SMALL, 0),
            "gpt2 eos": lambda: _build(SMALL, 0, eos_likely=True),
            "gpt2 int8": lambda: _build(SMALL, 1, dtype="bfloat16"),
            "opt": lambda: _build(dict(OPT_SMALL, **LAYOUTS["pre"]), 3)}


def _model(models, name):
    if name not in models:
        models[name] = MAKERS[name]()
    return models[name]


def _policies(jc):
    return (jl.PARITY, pl.PARITY) if jc.compute_dtype == "float32" else (jl.FAST, pl.FAST)


# ---------------------------------------------------------------------------
# the int8 codes
# ---------------------------------------------------------------------------


def _kv_values(seed=0):
    """(3, 4, 37, 64) values over a wide range of row scales: a zero row,
    and rows whose quotients by their scale land exactly on .5 (absmax
    127 / 8, so the float32 scale is 1/8 exactly)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(3, 4, 37, 64) * np.exp(rs.uniform(-6, 4, (3, 4, 37, 1)))
    x[0, 0, 0] = 0.0
    halves = (rs.randint(-126, 126, (5, 63)) + 0.5) / 8.0
    x[1, 2, :5, :63] = halves
    x[1, 2, :5, 63] = 127 / 8.0
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax_bitwise(dtype):
    x = _kv_values()
    jx = jnp.asarray(x, getattr(jnp, dtype))
    px = torch.tensor(x).to(getattr(torch, dtype))
    w8, ws = jq.quantize_kv_write(jx)
    g8, gs = pq.quantize_kv_write(px)
    assert g8.dtype == torch.int8 and gs.dtype == torch.bfloat16
    assert g8.shape == x.shape and gs.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(g8.numpy(), np.asarray(w8))
    np.testing.assert_array_equal(gs.view(torch.int16).numpy(),
                                  np.asarray(ws).view(np.int16))
    # the planted .5 quotients round half to even, on both sides
    q = x[1, 2, :5, :63] * 8.0
    np.testing.assert_array_equal(g8[1, 2, :5, :63].numpy(), np.round(q))
    assert (g8[0, 0, 0] == 0).all()
    for out_dtype in ("float32", "bfloat16"):
        want = np.asarray(jq.dequantize_kv(w8, ws, getattr(jnp, out_dtype)))
        got = pq.dequantize_kv(g8, gs, getattr(torch, out_dtype))
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    pair = pq.quantize_kv_pair((px, -px))
    jpair = jq.quantize_kv_pair((jx, -jx))
    for name in ("k8", "v8"):
        np.testing.assert_array_equal(pair[name].numpy(), np.asarray(jpair[name]))
    for name in ("ks", "vs"):
        np.testing.assert_array_equal(pair[name].view(torch.int16).numpy(),
                                      np.asarray(jpair[name]).view(np.int16))


# ---------------------------------------------------------------------------
# prefill into the head-major and int8 caches
# ---------------------------------------------------------------------------


def _prefill_both(jc, pc, params, tp, ids, media, mask, pixels, **dc_kw):
    """JAX's and the port's prefill over the head-major cache -> (port
    logits, JAX logits, port state, JAX state)."""
    jpol, ppol = _policies(jc)
    jdc = JaxDecodeConfig(max_length=MAX_LENGTH, pad_token_id=0, **dc_kw)
    pdc = DecodeConfig(max_length=MAX_LENGTH, pad_token_id=0, **dc_kw)
    jvf = jflam.encode_resample_visuals(params, jc, jnp.asarray(pixels), policy=jpol)
    pvf = pflam.encode_resample_visuals(tp, pc, torch.tensor(pixels), policy=ppol)
    wl, _, wst = jax_prefill(params, jc, jdc, jpol, jnp.asarray(ids), jnp.asarray(media),
                             jnp.asarray(mask), jvf, flat=False)
    gl, _, gst = _prefill(tp, pc, pdc, ppol, torch.tensor(ids).long(),
                          torch.tensor(media), torch.tensor(mask), pvf, flat=False)
    return gl.float().numpy(), np.asarray(wl, np.float32), gst, wst


@pytest.mark.parametrize("trunk", ["gpt2", "opt"])
def test_int8_kv_prefill_matches_jax(models, trunk):
    """float32: the head-major prefill's logits, over the bf16 and the int8
    cache, and the int8 cache's codes and scales against JAX's (module
    docstring); the int8 logits against the float cache's within 0.05 x
    absmax + 0.05."""
    jc, pc, params, tp = _model(models, trunk)
    ids, media, mask, pixels = _prompts(4, seed=7)
    got, want, _, _ = _prefill_both(jc, pc, params, tp, ids, media, mask, pixels)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    g8, w8, gst, wst = _prefill_both(jc, pc, params, tp, ids, media, mask, pixels,
                                     int8_kv_cache=True)
    assert "k8" in gst["cache"][0] and gst["kc"] is None
    flipped = 0
    for layer, (gc, wc) in enumerate(zip(gst["cache"], wst["cache"])):
        for name in ("k8", "v8"):
            d = np.abs(gc[name].numpy().astype(np.int32) - np.asarray(wc[name], np.int32))
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, (layer, name, d.max())
            flipped += int((d > 0).sum())
        for name in ("ks", "vs"):
            np.testing.assert_allclose(gc[name].float().numpy(),
                                       np.asarray(wc[name], np.float32), rtol=2 ** -7)
    tol = 1e-5 if flipped == 0 else 2e-4
    np.testing.assert_allclose(g8, w8, rtol=0, atol=tol * np.abs(w8).max())
    ref = np.abs(want).max()
    assert np.abs(g8 - got).max() < 0.05 * ref + 0.05


# ---------------------------------------------------------------------------
# greedy over the head-major and int8 caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trunk", ["gpt2", "opt"])
def test_head_major_greedy_matches_jax_and_flat(models, trunk):
    """``flat_kv_cache=False`` with ``prefix_block``: tokens equal JAX's
    and the port's flat-cache run's."""
    jc, pc, params, tp = _model(models, trunk)
    _, ppol = _policies(jc)
    ids, media, mask, pixels = _prompts(4, seed=8)
    kw = dict(eos_token_id=NO_EOS)
    want = jax_generate(jc, params, jl.PARITY, ids, media, mask, pixels=pixels,
                        flat_kv_cache=False, **kw)
    got = port_generate(pc, tp, ids, media, mask, pixels=pixels, flat_kv_cache=False, **kw)
    flat = port_generate(pc, tp, ids, media, mask, pixels=pixels, **kw)
    assert got.shape == (4, MAX_LENGTH)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, flat)


@pytest.mark.parametrize("trunk", ["gpt2", "opt"])
def test_int8_kv_greedy_matches_jax(models, trunk):
    """``int8_kv_cache`` (over ``flat_kv_cache=True``, which it overrides)
    with ``prefix_block``, float32: tokens equal JAX's."""
    jc, pc, params, tp = _model(models, trunk)
    ids, media, mask, pixels = _prompts(4, seed=9)
    kw = dict(eos_token_id=NO_EOS, int8_kv_cache=True)
    want = jax_generate(jc, params, jl.PARITY, ids, media, mask, pixels=pixels, **kw)
    got = port_generate(pc, tp, ids, media, mask, pixels=pixels, **kw)
    np.testing.assert_array_equal(got, want)


@jax.jit
def _jax_int8_kv_logits(params, ids, media, mask, pixels):
    """JAX's bf16 logits for the token after ``ids`` over the int8 cache."""
    jc = JaxConfig(compute_dtype="bfloat16", **SMALL)
    vf = jflam.encode_resample_visuals(params, jc, pixels, policy=jl.FAST)
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, pad_token_id=0, int8_kv_cache=True)
    logits, _, _ = jax_prefill(params, jc, dc, jl.FAST, ids, media, mask, vf)
    return logits


def test_int8_kv_int8_weights_prefix_block(models):
    """int8 KV with the int8 trunk and xattn in bf16, ``prefix_block``:
    rows equal to JAX's up to their first near-tie (module docstring)."""
    jc, pc, params, tp = _model(models, "gpt2 int8")
    ids, media, mask, pixels = _prompts(4, seed=10)
    L = ids.shape[1]
    kw = dict(eos_token_id=NO_EOS, int8_kv_cache=True)
    want = jax_generate(jc, params, jl.FAST, ids, media, mask, pixels=pixels, **kw)
    got = port_generate(pc, tp, ids, media, mask, pixels=pixels, **kw)
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
        row = np.asarray(_jax_int8_kv_logits(
            params, jnp.asarray(want[:, :t]), jnp.asarray(np.pad(media, ext)),
            jnp.asarray(np.pad(mask, ext, constant_values=1)),
            jnp.asarray(pixels))[r], np.float32)
        top = np.sort(row)[::-1]
        ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
        assert top[0] - top[1] <= 2 * ulp, (r, t, top[:2])
        assert row[got[r, t]] >= top[0] - 2 * ulp, (r, t, got[r, t])
    assert compared >= 0.5 * ids.shape[0] * (MAX_LENGTH - L), compared


# ---------------------------------------------------------------------------
# beams over the head-major cache: gather and lazy, plain and diverse
# ---------------------------------------------------------------------------


BEAMS = {
    "gather": dict(beam_reorder="gather"),
    "lazy head-major": dict(flat_kv_cache=False),
    "gather int8": dict(beam_reorder="gather", int8_kv_cache=True),
    "lazy int8": dict(int8_kv_cache=True),
    "diverse gather": dict(beam_reorder="gather", num_beams=4, num_beam_groups=2,
                           diversity_penalty=0.5),
    "diverse lazy head-major": dict(flat_kv_cache=False, num_beams=4, num_beam_groups=2,
                                    diversity_penalty=0.5),
    "opt gather": dict(beam_reorder="gather", model="opt"),
    "opt lazy head-major": dict(flat_kv_cache=False, model="opt"),
}


@pytest.mark.parametrize("case", list(BEAMS))
def test_head_major_beams_match_jax(models, case):
    """float32, EOS likely (GPT-2) so that pools fill before the length
    limit: the whole sorted pools and their scores, or the returned
    sequences with HF's sequences_scores, equal JAX's."""
    kw = dict(BEAMS[case])
    name = kw.pop("model", "gpt2 eos")
    jc, pc, params, tp = _model(models, name)
    ids, media, mask, pixels = _prompts(4, seed=11)
    kw.setdefault("num_beams", 3)
    kw.update(eos_token_id=EOS if name == "gpt2 eos" else NO_EOS)
    if kw.get("num_beam_groups", 1) > 1:
        impls = dict(impl=jbs._group_beam_impl), dict(impl=pbs.group_beam_impl)
    else:
        kw.update(num_return_sequences=2, return_scores=True)
        impls = {}, {}
    want = _jax_beam(jc, params, jl.PARITY, ids, media, mask, pixels=pixels,
                     **impls[0], **kw)
    got = _port_beam(pc, tp, pl.PARITY, ids, media, mask, pixels=pixels, **impls[1], **kw)
    np.testing.assert_array_equal(got[0], want[0])
    if kw.get("int8_kv_cache"):
        np.testing.assert_allclose(got[1], want[1], rtol=5e-4, atol=0)
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


def test_gather_reorder_moves_only_the_live_prefix(models, monkeypatch):
    """With ``prefix_block`` the gather reorder permutes the cache's slots
    [0, lim) only: the slots past the live prefix stay the families'
    unwritten zeros, and lim follows the segments."""
    jc, pc, params, tp = _model(models, "gpt2")
    ids, media, mask, pixels = _prompts(2, seed=12)
    limits = []
    reorder = pbs._Decoder.reorder

    def watch(self, parent, lim):
        limits.append(lim)
        reorder(self, parent, lim)
        buf = self.cache[0]["k"]
        if lim is not None and lim < buf.shape[2]:
            assert (buf[:, :, lim:] == 0).all()
    monkeypatch.setattr(pbs._Decoder, "reorder", watch)
    _port_beam(pc, tp, pl.PARITY, ids, media, mask, pixels=pixels, num_beams=3,
               beam_reorder="gather", eos_token_id=NO_EOS)
    L = ids.shape[1]
    assert limits and limits[0] == L + 1 + 4 and limits[-1] == MAX_LENGTH, limits


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knob", [dict(int8_kv_cache=True),
                                  dict(int8_kv_cache=True, num_beams=3),
                                  dict(beam_reorder="gather", num_beams=3)],
                         ids=["int8 greedy", "int8 beams", "gather beams"])
def test_megakernel_refuses_before_vision(models, monkeypatch, knob):
    """``megakernel=True`` with the int8 KV cache (greedy and beams), or
    with the gather reorder on beams, raises ``ValueError`` before any
    vision work or prefill."""
    jc, pc, params, tp = _model(models, "gpt2")

    def no_work(*a, **k):
        raise AssertionError("vision or prefill ran")
    monkeypatch.setattr(pflam, "encode_resample_visuals", no_work)
    monkeypatch.setattr(pgen, "_prefill", no_work)
    monkeypatch.setattr(pbs, "_prefill", no_work)
    ids, media, mask, pixels = _prompts(2, seed=13)
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    with pytest.raises(ValueError, match="megakernel"):
        model.generate(ids, media_locations=media, attention_mask=mask,
                       pixel_values=pixels, max_length=MAX_LENGTH, megakernel=True,
                       **knob)
    with pytest.raises(ValueError, match="megakernel"):
        replace(DecodeConfig(), megakernel=True, **knob)
