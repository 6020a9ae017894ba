"""``score_sequences`` and ``generate_captions``: the port against the JAX
package on the CPU, float32.

Small models (2 trunk layers, a 1-layer ViT on 32-px images, gates open):
GPT-2 with xattn before every layer and a pre-norm OPT with xattn every
other layer. Scores hold to JAX's within rtol 1e-4 with the same top-k set
(every other row at ``finfo(float32).min`` on both sides), in these cases:
``k`` < n with candidates that share their first suffix token (tied
candidate logits: ``ops.topk.top_k`` sends ties to the lower index, as
``lax.top_k`` does), no common prefix (``n_reuse == 0``: every row kept),
all rows equal (the clamp), media only in the prefix, a second image in
the suffix, and visual features passed in place of pixels. The port runs
the passes at the prefix's own length; JAX runs them unbucketed
(``reuse_block`` 0) and bucketed (4: pass 1 past the prefix, pass 2 from
below it, which JAX's jit needs and the port does not), and the port holds
to both. ``get_common_prefix_length`` equals JAX's.

``generate_captions`` on the GPT-2 model with a toy vocabulary
(``torch_toy_vocab``) gives JAX's strings, from the same pixels and from
the same uint8 images (each side's own pipeline, within 1e-4 of each
other), greedy and with beams.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu import modeling_flamingo as jmf
from flamingo_mini_tpu import scoring as jscoring
from flamingo_mini_tpu.flamingo_processor import FlamingoProcessor as JaxProcessor
from flamingo_mini_tpu.models import flamingo as jflam

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import scoring as pscoring
from flamingo_mini_tpu_torch.utils.params_bridge import from_jax_numpy
from torch_toy_vocab import write_toy_vocab

VISION = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=1,
              num_attention_heads=4, image_size=32, patch_size=16)
BASE = dict(dim=128, dim_visual=64, xattn_dim_head=32, xattn_heads=4,
            resampler_depth=1, resampler_dim_head=16, resampler_heads=4,
            resampler_num_latents=8, vision_arch_overrides=VISION)
CONFIGS = {
    "gpt2": dict(BASE, lm="gpt2", xattn_every=1,
                 lm_arch_overrides=dict(vocab_size=256, n_positions=64, n_embd=128,
                                        n_layer=2, n_head=4)),
    "opt": dict(BASE, lm="facebook/opt-1.3b", xattn_every=2,
                lm_arch_overrides=dict(vocab_size=256, max_position_embeddings=64,
                                       hidden_size=128, ffn_dim=512,
                                       num_hidden_layers=2, num_attention_heads=4,
                                       word_embed_proj_dim=128)),
}
RTOL = 1e-4
F32_MIN = np.finfo(np.float32).min


def _models(family, overrides=None, seed=3):
    cfg = dict(CONFIGS[family])
    if overrides:
        cfg["lm_arch_overrides"] = dict(cfg["lm_arch_overrides"], **overrides)
    jc = JaxConfig(**cfg)
    params = jflam.init_flamingo(jax.random.PRNGKey(seed), jc)
    for blk in params["xattn"].values():
        blk["alpha_attn"] = jnp.full((1,), 0.5, jnp.float32)
        blk["alpha_ffw"] = jnp.full((1,), 0.5, jnp.float32)
    tp = from_jax_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jmf.FlamingoModel(jc, params), port.FlamingoModel(port.FlamingoConfig(**cfg),
                                                             tp, device="cpu")


@pytest.fixture(scope="module")
def gpt2():
    return _models("gpt2")


@pytest.fixture(scope="module")
def opt():
    return _models("opt")


def _candidates(case, seed=0, n=8, L=12, prefix=5):
    """(ids, media, mask, n_images) for n candidates of length L."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(3, 250, (n, L)).astype(np.int32)
    ids[:, :prefix] = ids[0, :prefix]
    # rows 0-2 and 4-5 share their first suffix token: tied candidate logits
    ids[1:3, prefix] = ids[0, prefix]
    ids[5, prefix] = ids[4, prefix]
    media = np.zeros_like(ids)
    media[:, 0] = 1
    mask = np.ones_like(ids)
    n_images = 1
    if case == "no common prefix":
        ids[:, 0] = np.arange(n) + 10
    elif case == "all equal":
        ids[:] = ids[0]
    elif case == "second image in the suffix":
        media[:, prefix + 2] = 1
        n_images = 2
    elif case == "left-padded prefix":
        mask[:, :2] = 0
        media[:, 0], media[:, 2] = 0, 1
    return ids, media, mask, n_images


def _pixels(config, n_images, seed=1):
    size = config.vision_arch.image_size
    return np.random.RandomState(seed).randn(n_images, 3, size, size).astype(np.float32)


def _held(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    kept = want != F32_MIN
    np.testing.assert_array_equal(got != F32_MIN, kept)
    assert (got[~kept] == F32_MIN).all()
    np.testing.assert_allclose(got[kept], want[kept], rtol=RTOL, atol=0)
    return int(kept.sum())


CASES = [("media only in the prefix", 3, 0), ("media only in the prefix", 8, 0),
         ("media only in the prefix", 3, 4), ("media only in the prefix", 100000, 4),
         ("second image in the suffix", 4, 0), ("second image in the suffix", 4, 4),
         ("no common prefix", 3, 0), ("all equal", 2, 0), ("all equal", 2, 4),
         ("left-padded prefix", 5, 4)]


@pytest.mark.parametrize("case,k,jax_reuse_block", CASES)
def test_score_sequences_matches_jax(gpt2, case, k, jax_reuse_block):
    jm, pm = gpt2
    ids, media, mask, n_images = _candidates(case)
    pixels = _pixels(pm.config, n_images)
    want = jm.score_sequences(jnp.asarray(ids), jnp.asarray(media), jnp.asarray(mask),
                              pixel_values=jnp.asarray(pixels), k=k,
                              reuse_block=jax_reuse_block)
    got = pm.score_sequences(ids, media, mask, pixel_values=pixels, k=k)
    kept = _held(got, want)
    expect = len(ids) if case == "no common prefix" else min(k, len(ids))
    assert kept == expect


def test_score_sequences_ties_go_to_the_lower_index(gpt2):
    """Two groups of rows, each with one candidate logit (rows 0-5 and
    rows 6-7); k = 2 keeps the first two rows of the better group."""
    jm, pm = gpt2
    ids, media, mask, _ = _candidates("media only in the prefix")
    ids[:6, 5] = ids[0, 5]
    ids[6:, 5] = ids[0, 5] + 1
    pixels = _pixels(pm.config, 1)
    got = pm.score_sequences(ids, media, mask, pixel_values=pixels, k=2)
    want = jm.score_sequences(jnp.asarray(ids), jnp.asarray(media), jnp.asarray(mask),
                              pixel_values=jnp.asarray(pixels), k=2)
    _held(got, want)
    assert (got.numpy() != F32_MIN).nonzero()[0].tolist() in ([0, 1], [6, 7])


@pytest.mark.parametrize("jax_reuse_block", [0, 4])
def test_score_sequences_opt_and_features_match_jax(opt, jax_reuse_block):
    jm, pm = opt
    ids, media, mask, n_images = _candidates("second image in the suffix", seed=2)
    pixels = _pixels(pm.config, n_images, seed=2)
    want = jm.score_sequences(jnp.asarray(ids), jnp.asarray(media), jnp.asarray(mask),
                              pixel_values=jnp.asarray(pixels), k=5,
                              reuse_block=jax_reuse_block)
    _held(pm.score_sequences(ids, media, mask, pixel_values=pixels, k=5), want)
    feats = pm.encode_resample_visuals(pixels[None])[0]           # (N, q, d)
    _held(pm.score_sequences(ids, media, mask, visual_features=feats, k=5), want)


def test_common_prefix_length_matches_jax():
    rs = np.random.RandomState(3)
    for n, L, prefix in ((1, 7, 7), (4, 9, 0), (4, 9, 3), (5, 6, 6), (3, 10, 9)):
        ids = rs.randint(0, 5, (n, L))
        ids[:, :prefix] = ids[0, :prefix]
        if prefix < L and n > 1:
            ids[1, prefix] = ids[0, prefix] + 1
        assert pscoring.get_common_prefix_length(ids) == \
            jscoring.get_common_prefix_length(ids)
        assert pscoring.get_common_prefix_length(torch.tensor(ids)) == \
            jscoring.get_common_prefix_length(ids)


@pytest.fixture(scope="module")
def captioners(tmp_path_factory):
    path = write_toy_vocab(str(tmp_path_factory.mktemp("vocab")))
    tok = port.FlamingoProcessor(port.FlamingoConfig(lm="gpt2"), vocab_path=path,
                                 device="cpu").tokenizer
    eos = tok.eos_token_id
    jm, pm = _models("gpt2", dict(vocab_size=tok.vocab_size, eos_token_id=eos,
                                  bos_token_id=eos), seed=11)
    jproc = JaxProcessor(jm.config, vocab_path=path)
    pproc = port.FlamingoProcessor(pm.config, vocab_path=path, device="cpu")
    return jm, pm, jproc, pproc


@pytest.mark.parametrize("num_beams", [1, 2])
def test_generate_captions_match_jax(captioners, num_beams):
    jm, pm, jproc, pproc = captioners
    rs = np.random.RandomState(4)
    images = [rs.randint(0, 256, shape).astype(np.uint8)
              for shape in ((40, 60, 3), (64, 48, 3), (50, 50))]
    prompt = "<image>A picture of"
    want = jm.generate_captions(jproc, images=images, prompt=prompt, max_length=14,
                                num_beams=num_beams)
    got = pm.generate_captions(pproc, images=images, prompt=prompt, max_length=14,
                               num_beams=num_beams)
    assert got == want and len(got) == 3
    pixels = pproc.preprocess_images(images)
    want = jm.generate_captions(jproc, pixel_values=jnp.asarray(pixels.numpy()),
                                prompt=prompt, max_length=14, num_beams=num_beams)
    got = pm.generate_captions(pproc, pixel_values=pixels, prompt=prompt,
                               max_length=14, num_beams=num_beams)
    assert got == want
    with pytest.raises(ValueError, match="either images or pixel_values"):
        pm.generate_captions(pproc, images=images, pixel_values=pixels)
