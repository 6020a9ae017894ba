"""The port's whole-step megakernel path against the JAX package.

``flamingo_mini_tpu_torch.ops.megadecode.decode_step_megakernel`` runs its
plain PyTorch version on CPU tensors; here it is held against the JAX
Pallas megakernel in interpret mode, on the same weights (the JAX package
initialises them, ``from_jax_numpy`` carries them over) and the same numpy
inputs. The CUDA kernel itself is held against the plain version on the
card by tests/test_torch_gpu.py and chip_smoke.py.

The model is test_torch_slice.py's small config (D=128, 4 heads, 2 GPT-2 layers,
XI=128, 8 latents, vocab 256), int8 trunk and xattn, bf16, gates open, with
xattn before every layer or every other layer.

Tolerances. One step: the hidden row and the K/V rows written at ``cur``
agree to 4 bf16 ulps at the output's scale: the +-1-2 ulp association
envelope of ``pallas_megadecode.py`` (the TPU kernel sums its row-chunked
products in another order), doubled because the two frameworks also round
at other points: JAX evaluates ``gelu_new`` on a bf16 input in bf16
arithmetic, which parts from the port's float32 evaluation (rounded once)
by an ulp on about 45 % of elements. Greedy tokens are
identical, or a row parts where the reference's own top two logits are
within 2 bf16 ulps (the rule of test_torch_slice.py), checked at the first
difference of each row.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu.generation import (DecodeConfig as JaxDecodeConfig,
                                          _generate_impl, _prefill as jax_prefill,
                                          generate as jax_generate)
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops import pallas_megadecode as jmega
from flamingo_mini_tpu.ops import quant as jq

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.configuration_flamingo import OPTArch
from flamingo_mini_tpu_torch.generation import DecodeConfig, _prefill
from flamingo_mini_tpu_torch.models import flamingo as pflam
from flamingo_mini_tpu_torch.ops import layers as pl
from flamingo_mini_tpu_torch.ops import megadecode as pmega
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

SMALL = dict(
    lm="gpt2", dim=128, dim_visual=64, xattn_dim_head=32,
    xattn_heads=4, resampler_depth=2, resampler_dim_head=16,
    resampler_heads=4, resampler_num_latents=8, compute_dtype="bfloat16",
    lm_arch_overrides=dict(vocab_size=256, n_positions=64, n_embd=128,
                           n_layer=2, n_head=4),
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=2, num_attention_heads=4,
                               image_size=64, patch_size=16))
MAX_LENGTH, PREFIX_BLOCK, EOS = 24, 8, 999   # EOS unreachable (vocab 257)


def _bf16_ulps(ref: np.ndarray, n: int) -> float:
    """n bf16 ulps at the scale of the largest |value| (8 significant bits)."""
    return n * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _build(xattn_every):
    """(jax config, port config, jax params, port params): int8 trunk and
    xattn, bf16, gates open."""
    jc = JaxConfig(xattn_every=xattn_every, **SMALL)
    pc = port.FlamingoConfig(xattn_every=xattn_every, **SMALL)
    params = jflam.init_flamingo(jax.random.PRNGKey(xattn_every), jc)
    for blk in params["xattn"].values():
        blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
        blk["alpha_ffw"] = jnp.full((1,), 0.3, jnp.float32)
    params["lm"] = jq.quantize_gpt2_lm(params["lm"])
    params["xattn"] = jq.quantize_xattn_blocks(params["xattn"])
    params = jq.cast_params_bf16(params)
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jc, pc, params, tp


@pytest.fixture(scope="module")
def models():
    """xattn_every -> ``_build(xattn_every)``, filled on first use."""
    return {}


@pytest.fixture(params=[1, 2], ids=["xattn_every1", "xattn_every2"])
def model(request, models):
    if request.param not in models:
        models[request.param] = _build(request.param)
    return models[request.param]


def _prompts(b=4, seed=0, L=5):
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
    pixels = rs.randn(b, 1, 3, 64, 64).astype(np.float32)
    return ids, media, mask, pixels


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------


def test_one_step_matches_jax_interpret(model):
    """Hidden row and the K/V rows written at ``cur``, against the JAX
    megakernel in interpret mode on JAX-packed inputs. Two images (16
    latents); row 2 has no image yet (text_time 0), row 3 sees the second;
    rows are left-padded by 0-3 slots; the live prefix ends before the
    cache does. Measured maximum difference at the output's scale: hidden
    row 1 bf16 ulp (xattn every layer) and 3 (every other layer); K/V rows
    1 ulp, 0 in layer 0 with the gates closed."""
    jc, pc, params, tp = model
    b, L, T, cur, kv_limit = 4, 2, 64, 10, 16
    D, XH, dh, NMNV = 128, 4, 32, 16
    rs = np.random.RandomState(7)
    x_emb = (rs.randn(b, D) * 0.5).astype(np.float32)
    kc = (rs.randn(L, T, b, D) * 0.5).astype(np.float32)
    vc = (rs.randn(L, T, b, D) * 0.5).astype(np.float32)
    npad = np.array([0, 2, 3, 1], np.int32)
    text_time = np.array([1, 1, 0, 2], np.int32)
    kv = {str(l): tuple((rs.randn(b, XH, NMNV, dh) * 0.5).astype(np.float32)
                        for _ in range(2)) for l in range(0, L, jc.xattn_every)}

    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    jpacked = jmega.pack_decode_weights(params, jc)
    jxk, jxv = jmega.pack_xattn_kv_flat(
        {k: (bf(a), bf(c)) for k, (a, c) in kv.items()}, L)
    want = jmega.decode_step_megakernel(
        jpacked, jxk, jxv, bf(kc), bf(vc), bf(x_emb), jnp.asarray(npad),
        jnp.asarray(text_time), jnp.int32(cur), config=jc, kv_limit=kv_limit,
        interpret=True)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]

    tb = lambda a: torch.tensor(a).to(torch.bfloat16)
    packed = pmega.pack_decode_weights(tp, pc)
    xk, xv = pmega.pack_xattn_kv_flat(
        {k: (tb(a), tb(c)) for k, (a, c) in kv.items()}, L)
    pkc, pvc = tb(kc), tb(vc)
    before = pkc.clone()
    hidden = pmega.decode_step_megakernel(
        packed, xk, xv, pkc, pvc, tb(x_emb), torch.tensor(npad),
        torch.tensor(text_time), cur, config=pc, kv_limit=kv_limit)
    assert hidden.shape == (b, D) and hidden.dtype == torch.bfloat16
    # only the row at cur is written
    changed = (pkc != before).any(dim=(0, 2, 3)).nonzero().flatten().tolist()
    assert changed == [cur]
    got = [hidden.float().numpy(), pkc.float().numpy(), pvc.float().numpy()]
    for name, g, w in (("hidden", got[0], want[0]),
                       ("k row", got[1][:, cur], want[1][:, cur]),
                       ("v row", got[2][:, cur], want[2][:, cur])):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=_bf16_ulps(w, 4), rtol=0,
                                   err_msg=name)


def test_masked_positions_add_exact_zero(model):
    """The no-image row's xattn contributes exactly nothing: with the xattn
    K/V of that row replaced by NaN, its hidden row is unchanged (masked
    positions must add an exact 0, never 0 * NaN)."""
    jc, pc, params, tp = model
    b, L, T, cur, D, NMNV = 2, 2, 64, 6, 128, 8
    rs = np.random.RandomState(3)
    tb = lambda a: torch.tensor(a).to(torch.bfloat16)
    x_emb = tb(rs.randn(b, D) * 0.5)
    kc, vc = tb(rs.randn(L, T, b, D) * 0.5), tb(rs.randn(L, T, b, D) * 0.5)
    kv = {str(l): (tb(rs.randn(b, 4, NMNV, 32)), tb(rs.randn(b, 4, NMNV, 32)))
          for l in range(0, L, jc.xattn_every)}
    packed = pmega.pack_decode_weights(tp, pc)
    xk, xv = pmega.pack_xattn_kv_flat(kv, L)
    tt = torch.tensor([1, 0], dtype=torch.int32)
    npad = torch.zeros(b, dtype=torch.int32)
    ref = pmega.decode_step_megakernel(packed, xk, xv, kc.clone(), vc.clone(),
                                       x_emb, npad, tt, cur, config=pc)
    xk[:, :, 1], xv[:, :, 1] = float("nan"), float("nan")
    kc[:, cur + 1:, 1] = float("nan")          # past cur: never attended
    got = pmega.decode_step_megakernel(packed, xk, xv, kc, vc, x_emb, npad,
                                       tt, cur, config=pc)
    assert torch.equal(got[1], ref[1])


# ---------------------------------------------------------------------------
# greedy tokens
# ---------------------------------------------------------------------------


def _jax_logits(jc, params, ids, media, mask, pixels):
    """JAX's logits for the token after ``ids`` (per-layer prefill)."""
    vf = jflam.encode_resample_visuals(params, jc, jl.FAST.cast(jnp.asarray(pixels)),
                                       policy=jl.FAST)
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0)
    logits, _, _ = jax_prefill(params, jc, dc, jl.FAST, jnp.asarray(ids),
                               jnp.asarray(media), jnp.asarray(mask), vf, flat=True)
    return np.asarray(logits, np.float32)


def _port_logits(pc, tp, ids, media, mask, pixels):
    """The port's logits for the token after ``ids`` (per-layer prefill)."""
    vf = pflam.encode_resample_visuals(tp, pc, torch.tensor(pixels).to(torch.bfloat16),
                                       policy=pl.FAST)
    logits, _, _ = _prefill(tp, pc, DecodeConfig(max_length=MAX_LENGTH), pl.FAST,
                            torch.tensor(ids).long(), torch.tensor(media),
                            torch.tensor(mask), vf)
    return logits.float().numpy()


def _agree_up_to_near_ties(got, want, L, logits_fn, ulps=2):
    """Rows equal, or parting where the reference's top two logits for that
    slot (from ``logits_fn(prefix)``) are within ``ulps`` bf16 ulps and
    ``got``'s pick is among them. Returns the number of tokens compared."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :L], want[:, :L])
    n_new = want.shape[1] - L
    compared = 0
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r, L:] != want[r, L:])[0]
        if not len(diff):
            compared += n_new
            continue
        t = L + int(diff[0])
        compared += t - L
        row = logits_fn(want[:, :t])[r]
        top = np.sort(row)[::-1]
        ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
        assert top[0] - top[1] <= ulps * ulp, (r, t, top[:2])
        assert row[got[r, t]] >= top[0] - ulps * ulp, (r, t, got[r, t])
    return compared


def _port_generate(pc, tp, ids, media, mask, pixels, *, megakernel,
                   max_length=MAX_LENGTH):
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    return model.generate(ids, media_locations=media, attention_mask=mask,
                          pixel_values=pixels, max_length=max_length,
                          eos_token_id=EOS, pad_token_id=0,
                          prefix_block=PREFIX_BLOCK,
                          megakernel=megakernel).numpy()


def _extend(media, mask, n):
    ext = ((0, 0), (0, n))
    return np.pad(media, ext), np.pad(mask, ext, constant_values=1)


def test_greedy_megakernel_matches_jax(model):
    """Batch 4 with a left-padded row whose image comes late, through
    JAX's megakernel (interpret mode) and the port's megakernel path."""
    jc, pc, params, tp = model
    ids, media, mask, pixels = _prompts()
    L = ids.shape[1]
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0,
                         prefix_block=PREFIX_BLOCK, megakernel=True)
    want, n, _, _ = _generate_impl(
        params, jc, dc, jl.FAST, jnp.asarray(ids), jnp.asarray(media),
        jnp.asarray(mask), None, jnp.asarray(pixels), jax.random.PRNGKey(0))
    want = np.asarray(want)
    assert int(n) == MAX_LENGTH
    got = _port_generate(pc, tp, ids, media, mask, pixels, megakernel=True)

    def logits(prefix):
        return _jax_logits(jc, params, prefix, *_extend(media, mask, prefix.shape[1] - L),
                           pixels)

    compared = _agree_up_to_near_ties(got, want, L, logits)
    assert compared >= 0.5 * want.shape[0] * (MAX_LENGTH - L), compared


@pytest.mark.parametrize("b", [3, 1])
def test_greedy_megakernel_odd_batch(model, b):
    """Odd batches go through the port's kernel path as they are; JAX pads
    them to even with a duplicate row for its megakernel and slices it off."""
    jc, pc, params, tp = model
    ids, media, mask, pixels = _prompts(b=b, seed=10 + b)
    L = ids.shape[1]
    max_length = 16
    dc = JaxDecodeConfig(max_length=max_length, eos_token_id=EOS, pad_token_id=0,
                         prefix_block=PREFIX_BLOCK, megakernel=True)
    want = np.asarray(jax_generate(
        params, jc, jnp.asarray(ids), policy=jl.FAST, dc=dc,
        media_locations=jnp.asarray(media), attention_mask=jnp.asarray(mask),
        pixel_values=jnp.asarray(pixels)))
    assert want.shape == (b, max_length)
    got = _port_generate(pc, tp, ids, media, mask, pixels, megakernel=True,
                         max_length=max_length)

    def logits(prefix):
        return _jax_logits(jc, params, prefix, *_extend(media, mask, prefix.shape[1] - L),
                           pixels)

    compared = _agree_up_to_near_ties(got, want, L, logits)
    assert compared >= 0.5 * b * (max_length - L), compared


def test_megakernel_path_matches_per_layer_path(model):
    """The port's two decode paths, under the near-tie rule with the port's
    own per-layer logits as the reference."""
    jc, pc, params, tp = model
    ids, media, mask, pixels = _prompts(seed=5)
    L = ids.shape[1]
    want = _port_generate(pc, tp, ids, media, mask, pixels, megakernel=False)
    got = _port_generate(pc, tp, ids, media, mask, pixels, megakernel=True)

    def logits(prefix):
        return _port_logits(pc, tp, prefix, *_extend(media, mask, prefix.shape[1] - L),
                            pixels)

    compared = _agree_up_to_near_ties(got, want, L, logits)
    assert compared >= 0.5 * want.shape[0] * (MAX_LENGTH - L), compared


def test_megakernel_path_unfused_head(model):
    """``fused_head=False`` takes the full ``lm_head`` + argmax after the
    megakernel: the same tokens as the fused head (both round the logits
    to bf16 and take the first maximum)."""
    jc, pc, params, tp = model
    ids, media, mask, pixels = _prompts(seed=6)
    m = port.FlamingoModel(pc, params=tp, device="cpu")
    kw = dict(media_locations=media, attention_mask=mask, pixel_values=pixels,
              max_length=16, eos_token_id=EOS, pad_token_id=0, megakernel=True)
    np.testing.assert_array_equal(m.generate(ids, fused_head=False, **kw).numpy(),
                                  m.generate(ids, **kw).numpy())


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def _gelu_rational_reference(x: np.ndarray) -> np.ndarray:
    """pallas_megadecode.py:823-837 (``_gelu_erf_mosaic``) in numpy float32."""
    x32 = x.astype(np.float32)
    z = x32 * np.float32(2.0 ** -0.5)
    s = np.sign(z)
    a = np.abs(z)
    t = np.float32(1.0) / (np.float32(1.0) + np.float32(0.3275911) * a)
    c = [np.float32(v) for v in (0.254829592, -0.284496736, 1.421413741,
                                 -1.453152027, 1.061405429)]
    poly = t * (c[0] + t * (c[1] + t * (c[2] + t * (c[3] + t * c[4]))))
    erf = s * (np.float32(1.0) - poly * np.exp(-a * a))
    return np.float32(0.5) * x32 * (np.float32(1.0) + erf)


def test_gelu_erf_rational():
    """The formula to float32 rounding: the two frameworks' exp and the
    order of the float32 products differ, so the factor (1 + erf) may part
    by an ulp or two of 1, i.e. 2 float32 eps times |x| (measured 1.1).
    Within 1e-6 of the exact-erf GELU (measured 4.5e-7)."""
    x = np.linspace(-8.0, 8.0, 20001).astype(np.float32)
    got = pmega.gelu_erf_rational(torch.tensor(x)).numpy()
    eps = np.finfo(np.float32).eps
    assert (np.abs(got - _gelu_rational_reference(x)) <= 2 * eps * np.abs(x)).all()
    exact = torch.nn.functional.gelu(torch.tensor(x, dtype=torch.float64)).numpy()
    assert np.abs(got - exact).max() <= 1e-6
    xb = torch.tensor(x).to(torch.bfloat16)
    assert pmega.gelu_erf_rational(xb).dtype == torch.bfloat16


def test_packing_keeps_the_ragged_schedule(models):
    """xattn every other layer: layer 1 packs no xattn weights, and its
    xattn K/V slab is zero; the trunk packs every layer, transposed."""
    if 2 not in models:
        models[2] = _build(2)
    jc, pc, params, tp = models[2]
    packed = pmega.pack_decode_weights(tp, pc)
    assert packed["hasx"].tolist() == [1, 0]
    assert packed["xlayers"] == (0,)
    np.testing.assert_array_equal(packed["hasx"].numpy(),
                                  np.asarray(jmega.pack_decode_weights(params, jc)["hasx"]))
    for name in ("w_xq", "w_xo", "w_xf1", "w_xf2", "s_xq", "gates", "xn_s"):
        assert packed[name].shape[0] == 1, name
    assert packed["w_qkv"].shape == (2, 3 * 128, 128)
    torch.testing.assert_close(packed["w_qkv"][1],
                               tp["lm"]["blocks"][1]["c_attn"]["w8"].t())
    assert packed["w_xf2"].shape == (1, 128, 512)
    kv = {"0": (torch.ones(3, 4, 8, 32), torch.ones(3, 4, 8, 32))}
    xk, xv = pmega.pack_xattn_kv_flat(kv, 2)
    assert xk.shape == (2, 8, 3, 128) and xk.dtype == torch.bfloat16
    assert bool((xk[0] == 1).all()) and bool((xk[1] == 0).all())


def test_unported_modes_raise(model):
    jc, pc, params, tp = model
    m = port.FlamingoModel(pc, params=tp, device="cpu")
    ids = np.ones((1, 3), np.int32)
    # beam-sample runs on the megakernel (tests/test_torch_beam_sample.py)
    out = m.generate(ids, max_length=8, megakernel=True, num_beams=3, do_sample=True)
    assert out.shape == (1, 8)
    # ported per layer, refused by the megakernel: the int8 KV cache, the
    # gather reorder of beams (tests/test_torch_kv_cache.py), contrastive
    # and constrained search (tests/test_torch_contrastive.py,
    # tests/test_torch_constrained.py)
    for knob in (dict(num_beams=3, beam_reorder="gather"), dict(int8_kv_cache=True),
                 dict(penalty_alpha=0.6, top_k=4),
                 dict(num_beams=3, force_words_ids=[[5]])):
        with pytest.raises(ValueError, match="megakernel"):
            m.generate(ids, max_length=8, megakernel=True, **knob)
    # opt-350m: post-norm with project_in/out, which the kernel does not take
    opt350 = port.FlamingoConfig(lm="facebook/opt-350m", dim=1024)
    assert not pmega.supports_arch(opt350.lm_arch)
    assert pmega.supports_arch(OPTArch(hidden_size=2048, ffn_dim=8192,
                                       word_embed_proj_dim=2048))
    with pytest.raises(ValueError):
        pmega.pack_decode_weights(tp, opt350)
