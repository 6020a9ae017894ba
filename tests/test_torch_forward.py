"""The port's uncached forward and its pallas-policy generate against the JAX
package.

Same weights on both sides (the JAX package initialises them and
``from_jax_numpy`` carries them over). The model is small: 2 GPT-2 layers
(D=128, H=4) with xattn before each, a 2-layer ViT on 64-px images, a
2-layer resampler, vocab 256; batch 3 with a left-padded row and the image
at each row's first real token. Under a ``pallas`` policy the ViT, the
resampler, the xattn over several tokens and the uncached GPT-2 attention
run the attention kernels: their plain versions here, JAX's Pallas kernels
in interpret mode there. The float32 pallas policy is built directly on
both sides, since ``policy_for("float32", True)`` is PARITY in both.

Tolerances: float32 logits 1e-4 of their scale and the loss 1e-5 relative
(summation order through 2 + 2 + 2 layers); bf16 (weights cast, not
quantized) 1e-2 normwise, as bf16 rounds at points the two frameworks
choose differently; float32 greedy tokens identical; bf16 + int8 tokens
equal up to a row's first near-tie, where JAX's own top two logits lie
within 2 bf16 ulps.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu.generation import (DecodeConfig as JaxDecodeConfig,
                                          _generate_impl, _prefill as jax_prefill)
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops import quant as jq

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.generation import DecodeConfig, generate_impl
from flamingo_mini_tpu_torch.models import flamingo as pflam
from flamingo_mini_tpu_torch.ops import layers as pl
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

SMALL = dict(
    lm="gpt2", dim=128, dim_visual=64, xattn_every=1, xattn_dim_head=32,
    xattn_heads=4, resampler_depth=2, resampler_dim_head=16,
    resampler_heads=4, resampler_num_latents=8,
    lm_arch_overrides=dict(vocab_size=256, n_positions=64, n_embd=128,
                           n_layer=2, n_head=4),
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=2, num_attention_heads=4,
                               image_size=64, patch_size=16))
J_PALLAS_F32 = jl.Policy(jnp.float32, jax.lax.Precision.HIGHEST, pallas=True)
P_PALLAS_F32 = pl.Policy(torch.float32, pallas=True)
MAX_LENGTH, PREFIX_BLOCK, EOS = 20, 8, 999   # EOS unreachable (vocab 257)


def _params(compute_dtype, quantize=False):
    """(jax config, port config, jax params, port params), gates open."""
    jc = JaxConfig(compute_dtype=compute_dtype, **SMALL)
    pc = port.FlamingoConfig(compute_dtype=compute_dtype, use_pallas=True, **SMALL)
    params = jflam.init_flamingo(jax.random.PRNGKey(3), jc)
    for blk in params["xattn"].values():
        blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
        blk["alpha_ffw"] = jnp.full((1,), 0.5, jnp.float32)
    if quantize:
        params["lm"] = jq.quantize_gpt2_lm(params["lm"])
        params["xattn"] = jq.quantize_xattn_blocks(params["xattn"])
    if compute_dtype == "bfloat16":
        params = jq.cast_params_bf16(params)
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jc, pc, params, tp


@pytest.fixture(scope="module")
def f32():
    return _params("float32")


@pytest.fixture(scope="module")
def bf16():
    return _params("bfloat16")


def _batch(seed=0, b=3, n=12, pad=4):
    """Row 1 left-padded by ``pad``; each row's image at its first real
    token; labels = the ids (pads included, as the reference's loss)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 250, (b, n)).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    ids[1, :pad], mask[1, :pad] = 0, 0
    media = np.zeros((b, n), np.int32)
    media[:, 0] = 1
    media[1] = 0
    media[1, pad] = 1
    pixels = rs.randn(b, 1, 3, 64, 64).astype(np.float32)
    return ids, media, mask, pixels


def _forward_both(jc, pc, params, tp, jpol, ppol, batch, **kw):
    ids, media, mask, pixels = batch
    want = jflam.forward(params, jc, jnp.asarray(ids), policy=jpol,
                         media_locations=jnp.asarray(media),
                         attention_mask=jnp.asarray(mask),
                         pixel_values=jnp.asarray(pixels), labels=jnp.asarray(ids), **kw)
    got = pflam.forward(tp, pc, torch.tensor(ids).long(), policy=ppol,
                        media_locations=torch.tensor(media),
                        attention_mask=torch.tensor(mask),
                        pixel_values=torch.tensor(pixels),
                        labels=torch.tensor(ids).long(), **kw)
    return got, want


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


def test_policy_for_float32_pallas_is_parity():
    """float32 keeps the kernels off even with use_pallas, in both packages;
    bf16 with use_pallas turns them on."""
    assert jl.policy_for("float32", True) == jl.PARITY
    assert pl.policy_for("float32", True) == pl.PARITY
    assert jl.policy_for("bfloat16", True) == jl.FAST_PALLAS
    assert pl.policy_for("bfloat16", True) == pl.FAST_PALLAS
    assert pl.FAST_PALLAS.pallas and not pl.FAST.pallas and not pl.PARITY.pallas
    assert pl.policy_for("bfloat16", False) == pl.FAST
    assert port.FlamingoModel(port.FlamingoConfig(compute_dtype="bfloat16",
                                                  use_pallas=True, **SMALL),
                              device="cpu").policy == pl.FAST_PALLAS


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pallas", [True, False])
def test_forward_f32_matches_jax(f32, pallas):
    """The uncached forward and its loss, with and without the kernels."""
    jc, pc, params, tp = f32
    jpol, ppol = (J_PALLAS_F32, P_PALLAS_F32) if pallas else (jl.PARITY, pl.PARITY)
    got, want = _forward_both(jc, pc, params, tp, jpol, ppol, _batch())
    wl = np.asarray(want.logits)
    assert got.logits.shape == wl.shape == (3, 12, 257)
    np.testing.assert_allclose(got.logits.numpy(), wl, rtol=0,
                               atol=1e-4 * np.abs(wl).max())
    assert abs(float(got.loss) - float(want.loss)) <= 1e-5 * abs(float(want.loss))
    for g, w in zip(got.xattn_kv["0"], want.xattn_kv["0"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_forward_bf16_pallas_matches_jax(bf16):
    jc, pc, params, tp = bf16
    got, want = _forward_both(jc, pc, params, tp, jl.FAST_PALLAS, pl.FAST_PALLAS,
                              _batch(1))
    assert got.logits.dtype == torch.bfloat16
    assert torch.isfinite(got.logits.float()).all()
    assert _rel(got.logits.float().numpy(), np.asarray(want.logits, np.float32)) <= 1e-2
    assert _rel(float(got.loss), float(want.loss)) <= 1e-2
    # the left-padded row alone
    assert _rel(got.logits[1].float().numpy(),
                np.asarray(want.logits[1], np.float32)) <= 1e-2


def test_forward_without_media_matches_jax(f32):
    """No pixels and no features: zero features, text_time 0, xattn off."""
    jc, pc, params, tp = f32
    ids = np.random.RandomState(4).randint(5, 250, (2, 9)).astype(np.int32)
    want = jflam.forward(params, jc, jnp.asarray(ids), policy=J_PALLAS_F32,
                         labels=jnp.asarray(ids))
    got = pflam.forward(tp, pc, torch.tensor(ids).long(), policy=P_PALLAS_F32,
                        labels=torch.tensor(ids).long())
    wl = np.asarray(want.logits)
    np.testing.assert_allclose(got.logits.numpy(), wl, rtol=0, atol=1e-4 * np.abs(wl).max())
    assert abs(float(got.loss) - float(want.loss)) <= 1e-5 * abs(float(want.loss))


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_loss_matches_jax(reduction, weighted):
    rs = np.random.RandomState(int(weighted))
    logits = rs.randn(3, 7, 50).astype(np.float32) * 3
    labels = rs.randint(0, 50, (3, 7)).astype(np.int32)
    weights = (rs.rand(3, 7) > 0.3).astype(np.float32) if weighted else None
    want = jflam.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    reduction=reduction,
                                    weights=None if weights is None else jnp.asarray(weights))
    got = pflam.cross_entropy_loss(torch.tensor(logits), torch.tensor(labels),
                                   reduction=reduction,
                                   weights=None if weights is None else torch.tensor(weights))
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        pflam.cross_entropy_loss(torch.tensor(logits), torch.tensor(labels),
                                 reduction="sum")


def test_model_forward_entry_point(bf16):
    """``FlamingoModel.forward``/``__call__`` with ``use_pallas`` is the
    functional forward under FAST_PALLAS; ``encode_resample_visuals``
    matches JAX's; a ``context_mesh`` of one rank is the plain forward
    (tests/test_torch_ring_attention.py splits the sequence over ranks)."""
    jc, pc, params, tp = bf16
    ids, media, mask, pixels = _batch(2)
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    out = model(ids, media_locations=media, attention_mask=mask, pixel_values=pixels,
                labels=ids, loss_reduction="none")
    ref = pflam.forward(tp, pc, torch.tensor(ids).long(), policy=pl.FAST_PALLAS,
                        media_locations=torch.tensor(media),
                        attention_mask=torch.tensor(mask),
                        pixel_values=torch.tensor(pixels),
                        labels=torch.tensor(ids).long(), loss_reduction="none")
    assert torch.equal(out.logits, ref.logits) and torch.equal(out.loss, ref.loss)
    assert out.loss.shape == (3 * 11,)
    vf = model.encode_resample_visuals(pixels)
    jvf = jflam.encode_resample_visuals(params, jc, jl.FAST_PALLAS.cast(jnp.asarray(pixels)),
                                        policy=jl.FAST_PALLAS)
    assert vf.shape == (3, 1, 8, 64)
    assert _rel(vf.float().numpy(), np.asarray(jvf, np.float32)) <= 1e-2
    class OneRank:
        def size(self):
            return 1
    ring = model(ids, media_locations=media, attention_mask=mask, pixel_values=pixels,
                 labels=ids, loss_reduction="none", context_mesh=OneRank())
    assert torch.equal(ring.logits, out.logits) and torch.equal(ring.loss, out.loss)


# ---------------------------------------------------------------------------
# generate under the pallas policy
# ---------------------------------------------------------------------------


def _jax_generate(jc, params, pol, ids, media, mask, pixels):
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0,
                         prefix_block=PREFIX_BLOCK)
    toks, _, _, _ = _generate_impl(
        params, jc, dc, pol, jnp.asarray(ids), jnp.asarray(media), jnp.asarray(mask),
        None, jnp.asarray(pixels), jax.random.PRNGKey(0))
    return np.asarray(toks)


def _port_generate(pc, tp, pol, ids, media, mask, pixels):
    dc = DecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0,
                      prefix_block=PREFIX_BLOCK)
    with torch.inference_mode():
        return generate_impl(tp, pc, dc, pol, torch.tensor(ids).long(),
                             torch.tensor(media), torch.tensor(mask),
                             pixel_values=torch.tensor(pixels)).numpy()


def test_generate_pallas_f32_tokens_identical(f32):
    jc, pc, params, tp = f32
    ids, media, mask, pixels = _batch(5, n=5, pad=2)
    want = _jax_generate(jc, params, J_PALLAS_F32, ids, media, mask, pixels)
    got = _port_generate(pc, tp, P_PALLAS_F32, ids, media, mask, pixels)
    assert got.shape == (3, MAX_LENGTH)
    np.testing.assert_array_equal(got, want)


@jax.jit
def _jax_pallas_next_logits(params, ids, media, mask, pixels):
    """JAX's FAST_PALLAS logits for the token after ``ids`` (bf16 int8 model)."""
    jc = JaxConfig(compute_dtype="bfloat16", **SMALL)
    pol = jl.FAST_PALLAS
    vf = jflam.encode_resample_visuals(params, jc, pol.cast(pixels), policy=pol)
    dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0)
    logits, _, _, _ = jax_prefill(params, jc, dc, pol, ids, media, mask, vf, flat=True)
    return logits


def test_generate_pallas_bf16_int8_near_ties():
    """FAST_PALLAS with the int8 trunk and xattn and the fused head: rows
    equal to JAX's up to their first near-tie."""
    jc, pc, params, tp = _params("bfloat16", quantize=True)
    ids, media, mask, pixels = _batch(6, n=5, pad=2)
    want = _jax_generate(jc, params, jl.FAST_PALLAS, ids, media, mask, pixels)
    got = _port_generate(pc, tp, pl.FAST_PALLAS, ids, media, mask, pixels)
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
        ext = ((0, 0), (0, t - L))
        logits = _jax_pallas_next_logits(
            params, jnp.asarray(want[:, :t]), jnp.asarray(np.pad(media, ext)),
            jnp.asarray(np.pad(mask, ext, constant_values=1)), jnp.asarray(pixels))
        row = np.asarray(logits[r], np.float32)
        top = np.sort(row)[::-1]
        ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
        assert top[0] - top[1] <= 2 * ulp, (r, t, top[:2])
        assert row[got[r, t]] >= top[0] - 2 * ulp, (r, t, got[r, t])
    assert compared >= 0.5 * ids.shape[0] * (MAX_LENGTH - L), compared
