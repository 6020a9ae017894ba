"""The port's attention kernel modules and the modules that call them,
against the JAX package.

``flamingo_mini_tpu_torch.ops.fused_attention`` and ``.ops.media_xattn`` run
their plain PyTorch versions on CPU tensors; here those are held against the
JAX Pallas kernels in interpret mode (``pallas_attn.fused_attention`` with
its full-KV and streaming kernels, ``pallas_xattn.fused_media_xattn``) on
the same numpy inputs. The CUDA kernels themselves are held against the
plain versions on the card by tests/test_torch_gpu.py. Then the four
modules with a ``pallas`` branch (ViT, resampler, media-masked xattn over
several tokens, uncached GPT-2) under a float32 ``pallas`` policy built
directly on both sides (``policy_for("float32", True)`` is PARITY, kernels
off, in both packages).

Tolerances: float32 kernels differ only in summation order, 1e-5 of the
output's scale; bf16 outputs are rounded once after float32 math, 2 bf16
ulps of the output's scale; float32 modules 1e-5 normwise.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu.models import clip_vit as jvit
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.models import gpt2 as jgpt2
from flamingo_mini_tpu.models import resampler as jres
from flamingo_mini_tpu.models import xattn as jx
from flamingo_mini_tpu.ops import layers as jl
from flamingo_mini_tpu.ops.pallas_attn import fused_attention as j_attn
from flamingo_mini_tpu.ops.pallas_xattn import fused_media_xattn as j_media

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.models import clip_vit as pvit
from flamingo_mini_tpu_torch.models import gpt2 as pgpt2
from flamingo_mini_tpu_torch.models import resampler as pres
from flamingo_mini_tpu_torch.models import xattn as px
from flamingo_mini_tpu_torch.ops import layers as pl
from flamingo_mini_tpu_torch.ops.fused_attention import (
    NEG, flash_attention, flash_attention_plain, fused_attention)
from flamingo_mini_tpu_torch.ops.media_xattn import fused_media_xattn
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
J_PALLAS_F32 = jl.Policy(jnp.float32, jax.lax.Precision.HIGHEST, pallas=True)
P_PALLAS_F32 = pl.Policy(torch.float32, pallas=True)


def _held(got, want, dtype):
    """float32 within 1e-5 of the output's scale, bf16 within 2 bf16 ulps."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    tol = 1e-5 * scale if dtype == "float32" else 2 * 2.0 ** (np.floor(np.log2(scale)) - 7)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _both(a, dtype):
    jdt, tdt = DT[dtype]
    return jnp.asarray(a, jdt), torch.tensor(a, dtype=torch.float32).to(tdt)


def _pad_bias(b, n, pads, dtype):
    """GPT-2's padding row bias: 0 on real tokens, float32 min cast to the
    dtype on the first pads[r] slots (bf16: -inf)."""
    real = np.arange(n)[None, :] >= np.asarray(pads)[:, None]
    return _both(np.where(real, 0.0, np.finfo(np.float32).min), dtype)


# ---------------------------------------------------------------------------
# fused_attention: full-KV and streaming kernels
# ---------------------------------------------------------------------------

# name: (b, h, n_q, n_kv, d, causal, bias, row-bias pads, block_q, streaming)
ATTN_CASES = {
    "plain": (2, 3, 40, 40, 16, False, False, None, 16, None),
    "causal": (2, 3, 40, 40, 16, True, False, None, 16, None),
    "bias": (2, 2, 24, 30, 16, False, True, None, 8, None),
    # causal + left padding: the first pad queries see only masked keys
    "row_bias_left_pad": (3, 2, 24, 24, 8, True, False, [0, 5, 11], 8, None),
    "ragged_q": (1, 2, 37, 45, 16, True, True, [3], 16, None),
    # 100 keys in blocks of 32: four blocks, the last padded by 28
    "streaming_padded_tail": (2, 2, 24, 100, 8, True, False, [0, 6], 32, True),
    "streaming_no_row_bias": (1, 2, 16, 70, 8, False, False, None, 32, True),
    # past 2048 keys fused_attention streams on its own
    "streaming_by_length": (1, 1, 8, 2100, 8, False, False, [4], 256, None),
    # head dim 64 at the card's tile edges: 128-key tiles, a last tile of
    # 1 key (the ViT's 257), causal with left padding, a bias, streaming
    "d64_kv127": (1, 2, 33, 127, 64, False, False, None, 32, None),
    "d64_kv128_causal_left_pad": (2, 2, 40, 128, 64, True, False, [0, 7], 32, None),
    "d64_kv129_bias": (1, 2, 24, 129, 64, False, True, None, 16, None),
    "d64_kv257": (1, 2, 65, 257, 64, False, False, None, 64, None),
    "d64_streaming_kv257_causal_left_pad": (1, 2, 32, 257, 64, True, False, [3], 64, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_fused_attention_plain_matches_jax_kernel(case, dtype):
    b, h, n_q, n_kv, d, causal, has_bias, pads, block_q, streaming = ATTN_CASES[case]
    rs = np.random.RandomState(len(case))
    jq, tq = _both(rs.randn(b, h, n_q, d), dtype)
    jk, tk = _both(rs.randn(b, h, n_kv, d), dtype)
    jv, tv = _both(rs.randn(b, h, n_kv, d), dtype)
    jkw, tkw = {}, {}
    if has_bias:
        jkw["bias"], tkw["bias"] = _both(rs.randn(b, 1, n_q, n_kv), dtype)
    if pads is not None:
        jkw["row_bias"], tkw["row_bias"] = _pad_bias(b, n_kv, pads, dtype)
    scale = d ** -0.5
    with jax.default_matmul_precision("float32"):
        want = j_attn(jq, jk, jv, scale=scale, causal=causal, block_q=block_q,
                      streaming=streaming, interpret=True, **jkw)
    before = (fused_attention.launches, flash_attention.launches)
    got = fused_attention(tq, tk, tv, scale=scale, causal=causal, block_q=block_q,
                          streaming=streaming, **tkw)
    assert (fused_attention.launches, flash_attention.launches) == before  # CPU: plain
    assert got.dtype == DT[dtype][1]
    _held(got, want, dtype)


def test_fully_masked_rows_average_the_masked_keys():
    """bf16 causal + left padding: a pad query's earlier keys are -inf and
    its later ones float32 min, so it averages V over its later keys
    (uniformly), as JAX's kernel does; no NaN."""
    b, h, n, d = 1, 1, 6, 8
    rs = np.random.RandomState(0)
    q, k, v = (torch.tensor(rs.randn(b, h, n, d), dtype=torch.bfloat16) for _ in range(3))
    _, rb = _pad_bias(b, n, [3], "bfloat16")
    assert torch.isinf(rb[0, :3]).all()
    out = fused_attention(q, k, v, scale=0.125, causal=True, row_bias=rb).float()
    for i in range(3):
        want = v[0, 0, i + 1:].float().mean(dim=0)
        torch.testing.assert_close(out[0, 0, i], want.to(torch.bfloat16).float(),
                                   atol=2 ** -7, rtol=0)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("lm", ["gpt2", "opt"])
def test_trunk_builds_the_float32_row_bias_once(lm, monkeypatch):
    """An uncached bf16 pallas forward with a left-padded row hands every
    layer's fused_attention one float32 contiguous (b, n) row bias, built
    once per forward: the bf16 pad bias's values (-inf on the pads), so the
    wrapper converts nothing."""
    from flamingo_mini_tpu_torch.models import opt as popt
    module = pgpt2 if lm == "gpt2" else popt
    seen = []

    def recorder(*args, row_bias=None, **kw):
        seen.append(row_bias)
        return fused_attention(*args, row_bias=row_bias, **kw)

    monkeypatch.setattr(module, "fused_attention", recorder)
    gen = torch.Generator().manual_seed(0)
    if lm == "gpt2":
        arch = port.FlamingoConfig(**SMALL).lm_arch
        params, apply = pgpt2.init_gpt2(gen, arch), pgpt2.apply_gpt2
        n_layer = arch.n_layer
    else:
        arch = port.FlamingoConfig(lm="facebook/opt-1.3b", lm_arch_overrides=dict(
            vocab_size=256, max_position_embeddings=64, hidden_size=128, ffn_dim=512,
            num_hidden_layers=2, num_attention_heads=4, word_embed_proj_dim=128)).lm_arch
        params, apply = popt.init_opt(gen, arch), popt.apply_opt
        n_layer = arch.num_hidden_layers
    ids = torch.randint(0, 256, (3, 10), generator=gen)
    mask = torch.ones((3, 10), dtype=torch.int32)
    mask[1, :4] = 0
    out, _ = apply(params, ids, arch=arch, policy=pl.Policy(torch.bfloat16, pallas=True),
                   attention_mask=mask)
    assert torch.isfinite(out.float()).all()
    assert len(seen) == n_layer and all(rb is seen[0] for rb in seen)
    rb = seen[0]
    assert rb.dtype == torch.float32 and rb.is_contiguous() and rb.shape == (3, 10)
    assert torch.isinf(rb[1, :4]).all() and (rb[1, 4:] == 0).all()
    assert (rb[[0, 2]] == 0).all()


def test_streaming_plain_pads_the_tail_like_jax():
    """A fully masked row in the streaming kernel also weighs the padded
    tail keys (V = 0): the mean over n_kv_pad keys, not n_kv."""
    q = torch.zeros(1, 1, 2, 8)
    k = torch.randn(1, 1, 40, 8)
    v = torch.ones(1, 1, 40, 8)
    rb = torch.full((1, 40), NEG)
    out = flash_attention_plain(q, k, v, row_bias=rb, block_q=32)
    torch.testing.assert_close(out, torch.full_like(out, 40 / 64))


# ---------------------------------------------------------------------------
# fused_media_xattn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_media", [1, 2])
def test_media_xattn_plain_matches_jax_kernel(dtype, n_media):
    """text_time 0 (zeroed), each image, and past the media count (fully
    masked: the mean of V)."""
    b, h, n_q, d, n_visual = 2, 4, 22, 16, 8
    rs = np.random.RandomState(n_media)
    jq, tq = _both(rs.randn(b, h, n_q, d), dtype)
    jk, tk = _both(rs.randn(b, h, n_media * n_visual, d), dtype)
    jv, tv = _both(rs.randn(b, h, n_media * n_visual, d), dtype)
    tt = rs.randint(0, n_media + 2, (b, n_q)).astype(np.int32)
    tt[:, :n_media + 2] = np.arange(n_media + 2)
    with jax.default_matmul_precision("float32"):
        want = j_media(jq, jk, jv, jnp.asarray(tt), scale=0.25, n_visual=n_visual,
                       block_q=8, interpret=True)
    before = fused_media_xattn.launches
    got = fused_media_xattn(tq, tk, tv, torch.tensor(tt), scale=0.25, n_visual=n_visual)
    assert fused_media_xattn.launches == before
    _held(got, want, dtype)
    got = got.float()
    assert (got[torch.tensor(tt == 0)[:, None, :, None].expand_as(got)] == 0).all()
    past = got[:, :, n_media + 1]                      # text_time n_media + 1
    mean_v = tv.float().mean(dim=2)
    tol = 1e-5 if dtype == "float32" else 2 ** -6
    torch.testing.assert_close(past, mean_v, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the modules' pallas branches, float32
# ---------------------------------------------------------------------------

SMALL = dict(
    lm="gpt2", dim=128, dim_visual=64, xattn_every=1, xattn_dim_head=32,
    xattn_heads=4, resampler_depth=2, resampler_dim_head=16,
    resampler_heads=4, resampler_num_latents=8,
    lm_arch_overrides=dict(vocab_size=256, n_positions=64, n_embd=128,
                           n_layer=2, n_head=4),
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=2, num_attention_heads=4,
                               image_size=64, patch_size=16))


@pytest.fixture(scope="module")
def small():
    """(jax config, port config, jax params, port params), float32, gates open."""
    jc = JaxConfig(compute_dtype="float32", **SMALL)
    pc = port.FlamingoConfig(compute_dtype="float32", **SMALL)
    params = jflam.init_flamingo(jax.random.PRNGKey(1), jc)
    for blk in params["xattn"].values():
        blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
        blk["alpha_ffw"] = jnp.full((1,), 0.5, jnp.float32)
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jc, pc, params, tp


def test_clip_vit_pallas_matches_jax(small):
    jc, pc, params, tp = small
    pixels = np.random.RandomState(2).randn(3, 3, 64, 64).astype(np.float32)
    want = jvit.apply_clip_vit(params["vision"], jnp.asarray(pixels),
                               arch=jc.vision_arch, policy=J_PALLAS_F32)
    got = pvit.apply_clip_vit(tp["vision"], torch.tensor(pixels), arch=pc.vision_arch,
                              policy=P_PALLAS_F32)
    assert got.shape == (3, 17, 64)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("frames", [1, 2])
def test_resampler_pallas_matches_jax(small, frames):
    jc, pc, params, tp = small
    feats = np.random.RandomState(frames).randn(2, frames, 17, 64).astype(np.float32)
    kw = dict(heads=jc.resampler_heads, dim_head=jc.resampler_dim_head,
              act=jc.resampler_act)
    want = jres.apply_resampler(params["resampler"], jnp.asarray(feats),
                                policy=J_PALLAS_F32, **kw)
    got = pres.apply_resampler(tp["resampler"], torch.tensor(feats),
                               policy=P_PALLAS_F32, **kw)
    assert got.shape == (2, 8, 64)
    assert _rel(got.numpy(), want) <= 1e-5


def test_masked_xattn_pallas_matches_jax(small):
    """Seven tokens, two images: text_time 0, 1, 2 and 3 (past the media
    count) all occur."""
    jc, pc, params, tp = small
    rs = np.random.RandomState(5)
    vis = rs.randn(2, 2, 8, 64).astype(np.float32)
    y = rs.randn(2, 7, 128).astype(np.float32)
    text_time = np.array([[0, 1, 1, 2, 2, 3, 3], [0, 0, 1, 1, 1, 2, 3]], np.int32)
    kw = dict(n_visual=8, heads=jc.xattn_heads, dim_head=jc.xattn_dim_head)
    jblk, pblk = params["xattn"]["0"]["attn"], tp["xattn"]["0"]["attn"]
    jkv = jx.compute_visual_kv(jblk, jnp.asarray(vis), heads=jc.xattn_heads,
                               policy=J_PALLAS_F32)
    want = jx.apply_masked_xattn(jblk, jnp.asarray(y), jkv, jnp.asarray(text_time),
                                 policy=J_PALLAS_F32, **kw)
    pkv = px.compute_visual_kv(pblk, torch.tensor(vis), heads=jc.xattn_heads)
    before = fused_media_xattn.launches
    got = px.apply_masked_xattn(pblk, torch.tensor(y), pkv, torch.tensor(text_time),
                                policy=P_PALLAS_F32, **kw)
    assert fused_media_xattn.launches == before
    assert _rel(got.numpy(), want) <= 1e-5
    assert np.abs(got.numpy()[text_time == 0]).max() == 0


def test_gpt2_uncached_pallas_matches_jax(small):
    """The uncached trunk with a left-padded row: causal attention in the
    kernel, the padding as its row bias."""
    jc, pc, params, tp = small
    rs = np.random.RandomState(6)
    ids = rs.randint(0, 256, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, :4] = 0
    want, _ = jgpt2.apply_gpt2(params["lm"], jnp.asarray(ids), arch=jc.lm_arch,
                               policy=J_PALLAS_F32, attention_mask=jnp.asarray(mask))
    got, _ = pgpt2.apply_gpt2(tp["lm"], torch.tensor(ids).long(), arch=pc.lm_arch,
                              policy=P_PALLAS_F32, attention_mask=torch.tensor(mask))
    assert np.isfinite(got.numpy()).all()
    assert _rel(got.numpy(), want) <= 1e-5
