"""Heads 80 and 128 wide (opt-2.7b's and opt-6.7b's trunks): the port
against the JAX package at a small size.

The CUDA kernels take these widths on the card (tests/test_torch_gpu.py and
chip_smoke.py hold them against their plain versions there); here the plain
versions, which the wrappers run on CPU tensors, are held against JAX's
Pallas kernels in interpret mode on the same numpy inputs:
``decode_attention`` and ``decode_attention_beam`` at 2 heads of 80 and of
128, ``fused_attention`` at (2, 2, 24, 80 / 128) causal with a left-padding
row bias, one megakernel step in the OPT mode (D=640 with 8 heads of 80,
the narrowest width JAX's ``D % 128`` takes; D=256 with 2 heads of 128)
against JAX's megakernel in interpret mode, and greedy tokens of the same
2-layer int8 models, per layer and on the megakernel, against JAX's
generate per layer, the weights carried by ``from_jax_numpy``.

Tolerances (tests/test_torch_kernels.py's and test_torch_megakernel.py's):
float32 attention 1e-5 (summation order), bf16 attention 2 bf16 ulps of the
output's scale (probabilities rounded at other points); the megakernel
step's hidden row and K/V rows 4 bf16 ulps; tokens equal up to a row's
first near-tie, where JAX's own top two logits lie within 2 bf16 ulps.
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
from flamingo_mini_tpu.ops import pallas_decode as jpd
from flamingo_mini_tpu.ops import pallas_megadecode as jmega
from flamingo_mini_tpu.ops import quant as jq
from flamingo_mini_tpu.ops.pallas_attn import fused_attention as j_attn

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.ops import decode_attention as pda
from flamingo_mini_tpu_torch.ops import fused_attention as pfa
from flamingo_mini_tpu_torch.ops import megadecode as pmega
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WIDTHS = (80, 128)
# the OPT trunks: (D, heads) at each head width, ffn 4 D, 2 layers, xattn
# before the first
TRUNKS = {80: (640, 8), 128: (256, 2)}
SMALL = dict(
    xattn_every=2, xattn_dim_head=32, xattn_heads=4, dim_visual=64,
    resampler_depth=1, resampler_dim_head=16, resampler_heads=4,
    resampler_num_latents=8,
    vision_arch_overrides=dict(hidden_size=64, intermediate_size=128,
                               num_hidden_layers=1, num_attention_heads=4,
                               image_size=32, patch_size=16))
MAX_LENGTH, PREFIX_BLOCK, EOS = 13, 4, 999   # EOS unreachable (vocab 257)


def _bf16_ulps(ref: np.ndarray, n: int) -> float:
    """n bf16 ulps at the scale of the largest |value| (8 significant bits)."""
    return n * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _held(got: torch.Tensor, want, dtype: str) -> None:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    tol = 1e-5 if dtype == "float32" else _bf16_ulps(want, 2)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the attention kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", WIDTHS)
def test_decode_attention_plain_matches_jax_kernel(hd, dtype):
    """3 rows left-padded by 0-2, 2 heads of ``hd``, the live prefix ending
    before the 64-slot cache; JAX's kernel in 16-slot chunks."""
    b, T, H, cur, kv_limit = 3, 64, 2, 50, 56
    rs = np.random.RandomState(hd)
    q, k, v = (rs.randn(*s) * 0.3 for s in ((b, H * hd), (T, b, H * hd), (T, b, H * hd)))
    npad = np.array([0, 1, 2], np.int32)
    jdt, tdt = DT[dtype]
    kw = dict(n_head=H, scale=hd ** -0.5, kv_limit=kv_limit)
    with jax.default_matmul_precision("float32"):
        want = jpd.decode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                    jnp.asarray(npad), jnp.int32(cur), block_t=16,
                                    interpret=True, **kw)
    got = pda.decode_attention(*(torch.tensor(a, dtype=torch.float32).to(tdt)
                                 for a in (q, k, v)), torch.tensor(npad), cur, **kw)
    assert got.dtype == tdt
    _held(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", WIDTHS)
def test_decode_attention_beam_plain_matches_jax_kernel(hd, dtype):
    """8 families of 3 beams (24 rows: JAX's beam kernel), 2 heads of
    ``hd``, an ancestry shorter than the 32-slot cache, families
    left-padded by 0-2 slots."""
    b, kb, H, T, cur = 8, 3, 2, 32, 20
    assert jpd.beam_kernel_group(b * kb, kb, H)
    rs = np.random.RandomState(hd + 1)
    B, D = b * kb, H * hd
    q, kc, vc = (rs.randn(*s).astype(np.float32) for s in ((B, D), (T, B, D), (T, B, D)))
    anc = rs.randint(0, kb, (b, kb, 26)).astype(np.int32)
    anc[:, :, cur] = np.arange(kb)
    npad = np.repeat(np.arange(b) % 3, kb).astype(np.int32)
    kw = dict(n_head=H, scale=hd ** -0.5, kb=kb, kv_limit=24)
    jdt, tdt = DT[dtype]
    with jax.default_matmul_precision("float32"):
        want = jpd.decode_attention_beam(
            jnp.asarray(q, jdt), jnp.asarray(kc, jdt), jnp.asarray(vc, jdt),
            jnp.asarray(anc), jnp.asarray(npad), jnp.int32(cur), interpret=True, **kw)
    got = pda.decode_attention_beam(
        torch.tensor(q).to(tdt), torch.tensor(kc).to(tdt), torch.tensor(vc).to(tdt),
        torch.tensor(anc), torch.tensor(npad), cur, **kw)
    assert got.dtype == tdt and got.shape == q.shape
    _held(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", WIDTHS)
def test_fused_attention_plain_matches_jax_kernel(hd, dtype):
    """(2, 2, 24, hd), causal, row 1 left-padded by 5 (its first queries
    see only masked keys); JAX's full-KV kernel in 8-row blocks."""
    b, h, n = 2, 2, 24
    rs = np.random.RandomState(hd + 2)
    jdt, tdt = DT[dtype]
    q, k, v = (rs.randn(b, h, n, hd) for _ in range(3))
    real = np.arange(n)[None, :] >= np.array([0, 5])[:, None]
    rb = np.where(real, 0.0, np.finfo(np.float32).min)
    with jax.default_matmul_precision("float32"):
        want = j_attn(*(jnp.asarray(a, jdt) for a in (q, k, v)), scale=hd ** -0.5,
                      causal=True, block_q=8, row_bias=jnp.asarray(rb, jdt),
                      interpret=True)
    before = pfa.fused_attention.launches
    got = pfa.fused_attention(*(torch.tensor(a, dtype=torch.float32).to(tdt)
                                for a in (q, k, v)), scale=hd ** -0.5, causal=True,
                              row_bias=torch.tensor(rb, dtype=torch.float32).to(tdt))
    assert pfa.fused_attention.launches == before       # the CPU runs plain
    assert got.dtype == tdt
    _held(got, want, dtype)


# ---------------------------------------------------------------------------
# the OPT trunk: one megakernel step, greedy tokens
# ---------------------------------------------------------------------------


def _build(hd):
    """(jax config, port config, jax params, port params): an int8 bf16
    pre-norm OPT of 2 layers with heads ``hd`` wide (TRUNKS), gates open;
    made under one ``jax.jit`` (op by op, each op compiles on its own)."""
    D, H = TRUNKS[hd]
    kw = dict(SMALL, lm="facebook/opt-1.3b", dim=D, compute_dtype="bfloat16",
              lm_arch_overrides=dict(vocab_size=256, max_position_embeddings=64,
                                     hidden_size=D, ffn_dim=4 * D, num_hidden_layers=2,
                                     num_attention_heads=H, word_embed_proj_dim=D))
    jc, pc = JaxConfig(**kw), port.FlamingoConfig(**kw)

    def make(key):
        params = jflam.init_flamingo(key, jc)
        for blk in params["xattn"].values():
            blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
            blk["alpha_ffw"] = jnp.full((1,), 0.3, jnp.float32)
        params["lm"] = jq.quantize_opt_lm(params["lm"])
        params["xattn"] = jq.quantize_xattn_blocks(params["xattn"])
        return jq.cast_params_bf16(params)
    params = jax.jit(make)(jax.random.PRNGKey(hd))
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jc, pc, params, tp


@pytest.fixture(scope="module")
def models():
    """hd -> ``_build(hd)``, and ("tokens", hd) -> JAX's greedy tokens on
    ``_prompts(seed=hd)``; filled on first use."""
    return {}


def _model(models, hd):
    if hd not in models:
        models[hd] = _build(hd)
    return models[hd]


@pytest.mark.parametrize("hd", WIDTHS)
def test_megakernel_opt_step_matches_jax_interpret(models, hd):
    """The hidden row and the K/V rows written at ``cur``, against JAX's
    megakernel in interpret mode on JAX-packed inputs: rows left-padded by
    0-3 slots, row 2 without an image, row 3 on the second of two."""
    jc, pc, params, tp = _model(models, hd)
    assert pmega.supports_arch(pc.lm_arch) and jmega.supports_arch(jc.lm_arch)
    D, _H = TRUNKS[hd]
    b, L, T, cur, kv_limit, XH, xdh, NMNV = 4, 2, 16, 10, 16, 4, 32, 16
    rs = np.random.RandomState(hd + 3)
    x_emb = (rs.randn(b, D) * 0.5).astype(np.float32)
    kc, vc = ((rs.randn(L, T, b, D) * 0.5).astype(np.float32) for _ in range(2))
    npad = np.array([0, 2, 3, 1], np.int32)
    text_time = np.array([1, 1, 0, 2], np.int32)
    kv = {"0": tuple((rs.randn(b, XH, NMNV, xdh) * 0.5).astype(np.float32)
                     for _ in range(2))}

    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    jxk, jxv = jmega.pack_xattn_kv_flat({k: (bf(a), bf(c)) for k, (a, c) in kv.items()}, L)
    want = jmega.decode_step_megakernel(
        jmega.pack_decode_weights(params, jc), jxk, jxv, bf(kc), bf(vc), bf(x_emb),
        jnp.asarray(npad), jnp.asarray(text_time), jnp.int32(cur), config=jc,
        kv_limit=kv_limit, interpret=True)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]

    tb = lambda a: torch.tensor(a).to(torch.bfloat16)
    xk, xv = pmega.pack_xattn_kv_flat({k: (tb(a), tb(c)) for k, (a, c) in kv.items()}, L)
    pkc, pvc = tb(kc), tb(vc)
    hidden = pmega.decode_step_megakernel(
        pmega.pack_decode_weights(tp, pc), xk, xv, pkc, pvc, tb(x_emb),
        torch.tensor(npad), torch.tensor(text_time), cur, config=pc, kv_limit=kv_limit)
    got = [hidden.float().numpy(), pkc.float().numpy(), pvc.float().numpy()]
    for name, g, w in (("hidden", got[0], want[0]),
                       ("k row", got[1][:, cur], want[1][:, cur]),
                       ("v row", got[2][:, cur], want[2][:, cur])):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=_bf16_ulps(w, 4), rtol=0, err_msg=name)


def _prompts(b=4, seed=0, L=5, size=32):
    """Row 1 left-padded by 2, its image at slot 2; the image at slot 0
    elsewhere."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(5, 250, (b, L)).astype(np.int32)
    mask = np.ones((b, L), np.int32)
    ids[1, :2], mask[1, :2] = 0, 0
    media = np.zeros((b, L), np.int32)
    media[:, 0] = 1
    media[1] = 0
    media[1, 2] = 1
    return ids, media, mask, rs.randn(b, 1, 3, size, size).astype(np.float32)


def _agree_up_to_near_ties(jc, params, got, want, media, mask, pixels, ulps=2):
    """Rows equal, or parting where JAX's own top two logits for that slot
    (its per-layer prefill of the prefix) lie within ``ulps`` bf16 ulps and
    ``got``'s pick is among them; at least half the tokens compared."""
    L = media.shape[1]
    np.testing.assert_array_equal(got[:, :L], want[:, :L])
    vf, compared = None, 0

    @jax.jit     # op by op, each op compiles on its own
    def prefill_logits(params, ids, media, mask, vf):
        return jax_prefill(params, jc, JaxDecodeConfig(max_length=MAX_LENGTH), jl.FAST,
                           ids, media, mask, vf, flat=True)[0]
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r, L:] != want[r, L:])[0]
        if not len(diff):
            compared += MAX_LENGTH - L
            continue
        if vf is None:
            vf = jax.jit(lambda p, x: jflam.encode_resample_visuals(
                p, jc, jl.FAST.cast(x), policy=jl.FAST))(params, jnp.asarray(pixels))
        t = L + int(diff[0])
        compared += t - L
        ext = ((0, 0), (0, t - L))
        logits = prefill_logits(params, jnp.asarray(want[:, :t]),
                                jnp.asarray(np.pad(media, ext)),
                                jnp.asarray(np.pad(mask, ext, constant_values=1)), vf)
        row = np.asarray(logits[r], np.float32)
        top = np.sort(row)[::-1]
        ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
        assert top[0] - top[1] <= ulps * ulp, (r, t, top[:2])
        assert row[got[r, t]] >= top[0] - ulps * ulp, (r, t, got[r, t])
    assert compared >= 0.5 * want.shape[0] * (MAX_LENGTH - L), compared


@pytest.mark.parametrize("megakernel", [False, True], ids=["per_layer", "megakernel"])
@pytest.mark.parametrize("hd", WIDTHS)
def test_greedy_tokens_match_jax(models, hd, megakernel):
    """int8 trunk and xattn, the fused head; both of the port's paths
    against one JAX generate per width, per layer (JAX's megakernel makes
    the same tokens up to its near-ties, and
    test_megakernel_opt_step_matches_jax_interpret holds the two
    megakernels to each other)."""
    jc, pc, params, tp = _model(models, hd)
    ids, media, mask, pixels = _prompts(seed=hd)
    if ("tokens", hd) not in models:
        dc = JaxDecodeConfig(max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0,
                             prefix_block=PREFIX_BLOCK)
        toks, n, _, _ = _generate_impl(params, jc, dc, jl.FAST, jnp.asarray(ids),
                                       jnp.asarray(media), jnp.asarray(mask), None,
                                       jnp.asarray(pixels), jax.random.PRNGKey(0))
        assert int(n) == MAX_LENGTH
        models[("tokens", hd)] = np.asarray(toks)
    want = models[("tokens", hd)]
    m = port.FlamingoModel(pc, params=tp, device="cpu")
    got = m.generate(ids, media_locations=media, attention_mask=mask, pixel_values=pixels,
                     max_length=MAX_LENGTH, eos_token_id=EOS, pad_token_id=0,
                     prefix_block=PREFIX_BLOCK, megakernel=megakernel).numpy()
    assert got.shape == (4, MAX_LENGTH)
    _agree_up_to_near_ties(jc, params, got, want, media, mask, pixels)
