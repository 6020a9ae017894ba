"""The port's contrastive search (``penalty_alpha``) against the JAX
package's ``contrastive_generate``, and the prompt's hidden states it
penalises against (``_prefill(with_hidden=True)``).

Same weights on both sides (the JAX package initialises them,
``from_jax_numpy`` carries them over) and the same numpy inputs:
``tests/test_torch_beam.py``'s small float32 GPT-2 (D=256, 2 layers, vocab
256, a 1-layer ViT), also with EOS made likely, and
``tests/test_torch_opt.py``'s small OPT trunks, pre-norm and opt-350m's
post-norm with ``project_in``/``project_out``; gates open, a left-padded
row whose image comes late. Both sides run over the head-major cache and
the lazy ancestry, in plain ops.

Tolerances: tokens identical (float32); the prompt's hidden states within
1e-5 of their scale.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import contrastive as jcon
from flamingo_mini_tpu.generation import (DecodeConfig as JaxDecodeConfig,
                                          _prefill as jax_prefill)
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.ops import layers as jl

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import contrastive as pcon
from flamingo_mini_tpu_torch import generation as pgen
from flamingo_mini_tpu_torch.generation import DecodeConfig, _prefill
from flamingo_mini_tpu_torch.models import flamingo as pflam
from flamingo_mini_tpu_torch.ops import layers as pl
from test_torch_beam import (EOS, MAX_LENGTH, NO_EOS, _prompts, small,
                             small_eos)  # noqa: F401
from test_torch_kv_cache import _build
from test_torch_opt import LAYOUTS, SMALL as OPT_SMALL


@pytest.fixture(scope="module")
def trunks(small):
    """name -> (jax config, port config, jax params, port params)."""
    return {"gpt2": small,
            "opt pre-norm": _build(dict(OPT_SMALL, **LAYOUTS["pre"]), 3),
            "opt post-norm": _build(dict(OPT_SMALL, **LAYOUTS["post"]), 4)}


def _both(model, ids, media, mask, pixels, **kw):
    """(JAX's contrastive_generate, the port's) on the same inputs."""
    jc, pc, params, tp = model
    dc_kw = dict(max_length=MAX_LENGTH, pad_token_id=0, **kw)
    want = jcon.contrastive_generate(
        params, jc, JaxDecodeConfig(**dc_kw), jl.PARITY, jnp.asarray(ids),
        jnp.asarray(media), jnp.asarray(mask), None, pixel_values=jnp.asarray(pixels))
    got = pcon.contrastive_generate(
        tp, pc, DecodeConfig(**dc_kw), pl.PARITY, torch.tensor(ids).long(),
        torch.tensor(media), torch.tensor(mask), None,
        pixel_values=torch.tensor(pixels))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("trunk", ["gpt2", "opt pre-norm", "opt post-norm"])
def test_contrastive_matches_jax(trunks, trunk):
    """top_k 4, penalty_alpha 0.6."""
    ids, media, mask, pixels = _prompts(4, seed=10)
    want, got = _both(trunks[trunk], ids, media, mask, pixels, top_k=4,
                      penalty_alpha=0.6, eos_token_id=NO_EOS)
    assert got.shape == (4, MAX_LENGTH)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :ids.shape[1]], ids)


def test_contrastive_with_processor_matches_jax(small):
    """The chain picks the candidates: repetition penalty and no repeated
    bigram, alpha 0.4, 5 candidates."""
    ids, media, mask, pixels = _prompts(4, seed=11)
    want, got = _both(small, ids, media, mask, pixels, top_k=5, penalty_alpha=0.4,
                      eos_token_id=NO_EOS, repetition_penalty=1.3,
                      no_repeat_ngram_size=2)
    np.testing.assert_array_equal(got, want)


def test_contrastive_eos_pads_matches_jax(small_eos):
    """EOS likely: rows that emit it pad after it, as JAX's do."""
    ids, media, mask, pixels = _prompts(4, seed=12)
    want, got = _both(small_eos, ids, media, mask, pixels, top_k=4,
                      penalty_alpha=0.6, eos_token_id=EOS)
    np.testing.assert_array_equal(got, want)
    L = ids.shape[1]
    done = [r for r in got if EOS in r[L:]]
    assert done, "no row emitted EOS"
    for r in done:
        first = L + int(np.argmax(r[L:] == EOS))
        assert (r[first + 1:] == 0).all()


def test_alpha_zero_is_greedy(small):
    """penalty_alpha 0: the most probable candidate, the port's greedy over
    the head-major cache (``generate`` sends alpha 0 to greedy)."""
    _, pc, _, tp = small
    ids, media, mask, pixels = _prompts(4, seed=13)
    got = pcon.contrastive_generate(
        tp, pc, DecodeConfig(max_length=MAX_LENGTH, pad_token_id=0, top_k=4,
                             eos_token_id=NO_EOS), pl.PARITY,
        torch.tensor(ids).long(), torch.tensor(media), torch.tensor(mask), None,
        pixel_values=torch.tensor(pixels))
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    greedy = model.generate(ids, media_locations=media, attention_mask=mask,
                            pixel_values=pixels, max_length=MAX_LENGTH,
                            eos_token_id=NO_EOS, pad_token_id=0, flat_kv_cache=False)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())


@pytest.mark.parametrize("trunk", ["gpt2", "opt pre-norm", "opt post-norm"])
def test_prompt_hidden_matches_jax(trunks, trunk):
    """``_prefill(with_hidden=True)``'s "prompt_hidden": the trunk's output
    that the head reads (GPT-2 after ``ln_f``, OPT after its final
    LayerNorm, opt-350m after ``project_out``), JAX's ``with_hidden``."""
    jc, pc, params, tp = trunks[trunk]
    ids, media, mask, pixels = _prompts(4, seed=14)
    dc_kw = dict(max_length=MAX_LENGTH, pad_token_id=0)
    vf = jflam.encode_resample_visuals(params, jc, jnp.asarray(pixels), policy=jl.PARITY)
    _, _, jst = jax_prefill(params, jc, JaxDecodeConfig(**dc_kw), jl.PARITY,
                            jnp.asarray(ids), jnp.asarray(media), jnp.asarray(mask),
                            vf, with_hidden=True)
    pvf = pflam.encode_resample_visuals(tp, pc, torch.tensor(pixels), policy=pl.PARITY)
    _, _, st = _prefill(tp, pc, DecodeConfig(**dc_kw), pl.PARITY, torch.tensor(ids).long(),
                        torch.tensor(media), torch.tensor(mask), pvf, flat=False,
                        with_hidden=True)
    want = np.asarray(jst["prompt_hidden"])
    got = st["prompt_hidden"].numpy()
    width = tp["lm"]["wte" if trunk == "gpt2" else "embed_tokens"].shape[1]
    assert got.shape == want.shape == ids.shape + (width,)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    _, _, flat_st = _prefill(tp, pc, DecodeConfig(**dc_kw), pl.PARITY,
                             torch.tensor(ids).long(), torch.tensor(media),
                             torch.tensor(mask), pvf)
    assert "prompt_hidden" not in flat_st


@pytest.mark.parametrize("knob", [dict(top_k=1), dict(top_k=4, do_sample=True),
                                  dict(top_k=4, num_beams=2),
                                  dict(top_k=4, output_scores=True)],
                         ids=["one_candidate", "do_sample", "beams", "output_scores"])
def test_config_refuses_as_jax(knob):
    with pytest.raises(ValueError):
        JaxDecodeConfig(penalty_alpha=0.6, **knob)
    with pytest.raises(ValueError):
        DecodeConfig(penalty_alpha=0.6, **knob)


@pytest.mark.parametrize("knob", [dict(return_scores=True), dict(megakernel=True)],
                         ids=["return_scores", "megakernel"])
def test_generate_refuses_before_vision_and_prefill(small, monkeypatch, knob):
    _, pc, _, tp = small
    model = port.FlamingoModel(pc, params=tp, device="cpu")

    def boom(*a, **k):
        raise AssertionError("ran before the refusal")
    monkeypatch.setattr(pflam, "encode_resample_visuals", boom)
    monkeypatch.setattr(pgen, "_prefill", boom)
    ids, media, mask, pixels = _prompts(2)
    with pytest.raises(ValueError):
        model.generate(ids, media_locations=media, attention_mask=mask,
                       pixel_values=pixels, max_length=MAX_LENGTH, top_k=4,
                       penalty_alpha=0.6, **knob)
