"""The port's beam-sample (``do_sample`` with ``num_beams > 1``) against the
JAX package's ``_beam_impl``.

Same weights on both sides (the JAX package initialises them,
``from_jax_numpy`` carries them over) and the same numpy inputs:
``tests/test_torch_beam.py``'s small float32 model (GPT-2 D=256, 2 layers,
vocab 256, a 1-layer ViT), also with EOS made likely, and its wide
int8/bf16 one (D=1024, 2 layers, vocab 512) for the megakernel. The port
draws JAX's noise: its ``beam_search.uniform_noise`` is replaced by
``jax.random.uniform(fold_in(rng, cur), shape, minval=1e-20)``, the draw
JAX makes for the candidates of position ``cur`` (the prefill's fill at
``cur = L``, then one a step).

Tolerances. float32: sequences identical, scores within 1e-5. The wide
model on the megakernel (the port's plain version against JAX's kernel in
interpret mode, weight-only and w8a8), sampled at temperature 0.7 over
the whole vocabulary (a top-k cut would add partings where bf16 rounding
moves a token across it), the whole pool of each row returned
(``num_return_sequences=3``):

* every returned hypothesis, scored by JAX's own model (one uncached
  forward; the mean generated log-prob over the temperature), has the
  score the port reports within 2e-2 (``tests/test_torch_beam.py``'s score
  envelope; measured 7.9e-3 weight-only, 1.3e-2 w8a8 against JAX's
  weight-only model, JAX's own hypotheses 5.7e-3 and 1.0e-2);
* a row's best hypothesis equals JAX's, its score within 2e-2, or the row
  parts where the port's own run had a near-tie, read on the noisy keys
  (JAX's candidates are not visible) and on the candidates' scores, at a
  decision that chooses: the 2k-th and (2k+1)-th keys (which candidates
  are drawn), two neighbours among the k + 1 best scores of the 2k (which
  run on, in which slot: a slot picks its beam's noise at the next step);
  at the last step the k-th and (k+1)-th keys (which enter the pool) and
  the two best pool scores (which is returned). Near: within 4 bf16 ulps of
  the value (half the card's beam rule). At most half the rows part: the
  noisy keys of 1,539 candidates a row lie a few bf16 ulps apart near the
  top at many steps, so rows part often at bf16 (measured 3 and 4 of 8;
  JAX's own megakernel and per-layer paths part on 2 of 8 with a top-50
  cut).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import beam_search as jbs
from flamingo_mini_tpu.generation import DecodeConfig as JaxDecodeConfig
from flamingo_mini_tpu.ops import layers as jl

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import beam_search as pbs
from flamingo_mini_tpu_torch.generation import DecodeConfig
from flamingo_mini_tpu_torch.models import gpt2 as pgpt2
from flamingo_mini_tpu_torch.ops import layers as pl
from flamingo_mini_tpu_torch.ops import megadecode as pmega
from test_torch_beam import (EOS, MAX_LENGTH, NO_EOS, PREFIX_BLOCK, _count_calls,
                             _jax_token_logp, _prompts, _wide_inputs, small,
                             small_eos, wide)  # noqa: F401

KEY = jax.random.PRNGKey(7)
NEG = np.finfo(np.float32).min


def _feed_jax_uniform(monkeypatch, L):
    """The k-th draw of the port is JAX's ``uniform(fold_in(KEY, L + k))``.
    Each step's candidates are recorded: (the n + 1 best keys, the n
    candidates' scores), in key order."""
    calls, keys = [], []

    def noise(shape, generator, device):
        key = jax.random.fold_in(KEY, L + len(calls))
        calls.append(key)
        u = jax.random.uniform(key, tuple(shape), minval=1e-20, maxval=1.0)
        return torch.tensor(np.asarray(u), device=device)
    monkeypatch.setattr(pbs, "uniform_noise", noise)
    select = pbs.select_candidates

    def record(flat, n, noise=None):
        out = select(flat, n, noise)
        keys.append(((flat + noise).topk(n + 1).values.numpy(), out[0].numpy().copy()))
        return out
    monkeypatch.setattr(pbs, "select_candidates", record)
    return calls, keys


def _run(model, ids, media, mask, *, pixels=None, feats=None, pol_j, pol_p,
         monkeypatch, **kw):
    """(JAX's beam_generate, the port's) on one set of inputs and JAX's
    noise -> both outputs and the port's recorded noisy keys."""
    jc, pc, params, tp = model
    dc_kw = dict(max_length=MAX_LENGTH, pad_token_id=0, prefix_block=PREFIX_BLOCK,
                 do_sample=True, **kw)
    want = jbs.beam_generate(
        params, jc, JaxDecodeConfig(**dc_kw), pol_j, jnp.asarray(ids),
        jnp.asarray(media), jnp.asarray(mask),
        None if feats is None else jnp.asarray(feats),
        pixel_values=None if pixels is None else jnp.asarray(pixels), rng=KEY)
    calls, keys = _feed_jax_uniform(monkeypatch, ids.shape[1])
    got = pbs.beam_generate(
        tp, pc, DecodeConfig(**dc_kw), pol_p, torch.tensor(ids).long(),
        torch.tensor(media), torch.tensor(mask),
        None if feats is None else torch.tensor(feats).to(pol_p.dtype),
        pixel_values=None if pixels is None else torch.tensor(pixels))
    assert len(calls) == len(keys) >= 1
    as_np = lambda out: jax.tree_util.tree_map(np.asarray, out)
    return as_np(want), jax.tree_util.tree_map(lambda t: t.numpy(), got), keys


CASES = {
    "temperature_top_k": dict(num_beams=3, temperature=0.7, top_k=20,
                              return_scores=True),
    "top_p": dict(num_beams=3, top_p=0.9),
    # one finite token a beam: 3 of the 2k = 6 candidates are finite, the
    # rest tie at float32's finfo.min and enter in index order
    "few_finite": dict(num_beams=3, top_k=1, return_scores=True),
    "return_sequences": dict(num_beams=3, num_return_sequences=2, top_k=40,
                             return_scores=True, length_penalty=0.7),
    "scores": dict(num_beams=2, temperature=1.3, return_scores=True),
    "eos": dict(num_beams=3, top_k=30, num_return_sequences=3, return_scores=True,
                eos="reachable"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_beam_sample_f32_matches_jax(small, small_eos, case, monkeypatch):
    kw = dict(CASES[case])
    eos = EOS if kw.pop("eos", None) else NO_EOS
    model = small_eos if eos == EOS else small
    ids, media, mask, pixels = _prompts(4, seed=3)
    want, got, keys = _run(model, ids, media, mask, pixels=pixels, pol_j=jl.PARITY,
                           pol_p=pl.PARITY, monkeypatch=monkeypatch,
                           eos_token_id=eos, **kw)
    n = kw.get("num_return_sequences", 1)
    toks, scores = (got, None) if not kw.get("return_scores") else got
    wtoks, wscores = (want, None) if not kw.get("return_scores") else want
    assert toks.shape == (4 * n, MAX_LENGTH)
    np.testing.assert_array_equal(toks, wtoks)
    if scores is not None:
        assert scores.shape == (4 * n,) and scores.dtype == np.float32
        np.testing.assert_allclose(scores, wscores, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(toks[::n, :ids.shape[1]], ids)
    if case == "few_finite":
        # the candidates past the finite ones sit at finfo.min, noise and
        # all, and never overflow to -inf
        assert all((k[:, 3:] == NEG).all() and np.isfinite(k).all() for k, _ in keys)
    if eos != NO_EOS:
        done = [r for r in toks if eos in r[ids.shape[1]:]]
        assert done, "no hypothesis finished"


def test_beam_sample_generate_seeds_and_generator(small):
    """Through ``FlamingoModel.generate``: no generator is a generator
    seeded 0; one seed gives one result, and another seed another."""
    _, pc, _, tp = small
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    ids, media, mask, pixels = _prompts(4, seed=4)

    def gen(generator):
        return model.generate(ids, media_locations=media, attention_mask=mask,
                              pixel_values=pixels, max_length=MAX_LENGTH,
                              eos_token_id=NO_EOS, pad_token_id=0, num_beams=3,
                              do_sample=True, top_k=50, generator=generator)
    seeded = lambda s: torch.Generator().manual_seed(s)
    default = gen(None)
    assert torch.equal(default, gen(seeded(0)))
    assert torch.equal(gen(seeded(5)), gen(seeded(5)))
    assert not torch.equal(gen(seeded(5)), default)


# ---------------------------------------------------------------------------
# the wide model on the megakernel (plain version) against JAX's kernel
# ---------------------------------------------------------------------------


def _ulps(x: float, n: int = 8) -> float:
    """n bf16 ulps of x (8 significant bits)."""
    return n * 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _held_up_to_near_ties(wide, got, want, keys, inputs, k, temperature):
    """The module docstring's rule over whole pools (b*k rows, k a row) ->
    the rows that part."""
    jc, _, params, _ = wide
    ids, media, mask, feats = inputs
    b, L = ids.shape
    (gt, gs), (wt, ws) = got, want
    assert gt.shape == wt.shape == (b * k, MAX_LENGTH)
    ext = ((0, 0), (0, MAX_LENGTH - L))
    pool = lambda a: jnp.asarray(np.repeat(a, k, axis=0))
    lp = _jax_token_logp(params, jnp.asarray(gt, jnp.int32), pool(np.pad(media, ext)),
                         pool(np.pad(mask, ext, constant_values=1)), pool(feats), jc=jc)
    np.testing.assert_allclose(np.asarray(lp)[:, L - 1:].mean(axis=1) / temperature,
                               gs, atol=2e-2, rtol=0)
    best_g, best_w = gt[::k], wt[::k]
    parted = [r for r in range(b) if not np.array_equal(best_g[r], best_w[r])]
    same = [r * k for r in range(b) if r not in parted]
    np.testing.assert_allclose(gs[same], ws[same], atol=2e-2, rtol=0)
    near = lambda hi, lo: hi - lo <= _ulps(hi, 4)
    for r in parted:
        ties = []
        for key, score in keys[:-1]:
            by_score = np.sort(score[r])[::-1]
            ties += [near(key[r, 2 * k - 1], key[r, 2 * k])]
            ties += [near(by_score[i], by_score[i + 1]) for i in range(k)]
        key, _ = keys[-1]
        ties += [near(key[r, k - 1], key[r, k]), near(gs[r * k], gs[r * k + 1])]
        assert any(ties), (r, keys, gs[r * k:r * k + 2])
    assert len(parted) <= b // 2, parted
    return parted


@pytest.mark.parametrize("w8a8", [False, True], ids=["weight_only", "w8a8"])
def test_megakernel_beam_sample_matches_jax_megakernel(wide, w8a8, monkeypatch):
    """b=8, k=3: 24 rows, so JAX runs its megakernel beam mode (interpret
    mode) with beam-sample, weight-only and w8a8."""
    b, k, temperature = 8, 3, 0.7
    inputs = ids, media, mask, feats = _wide_inputs(b, 41)
    mega = _count_calls(monkeypatch, pmega, "decode_step_megakernel")
    want, got, keys = _run(wide, ids, media, mask, feats=feats, pol_j=jl.FAST,
                           pol_p=pl.FAST, monkeypatch=monkeypatch, num_beams=k,
                           num_return_sequences=k, return_scores=True,
                           eos_token_id=NO_EOS, temperature=temperature,
                           megakernel=True, w8a8=w8a8)
    assert len(mega) == MAX_LENGTH - ids.shape[1] - 1
    parted = _held_up_to_near_ties(wide, got, want, keys, inputs, k, temperature)
    print(f"beam-sample megakernel (w8a8={w8a8}): rows parted {parted}")


def test_megakernel_beam_sample_odd_rows_runs(wide, monkeypatch):
    """b=3, k=3: 9 rows, where JAX falls back to per layer; the port runs
    its megakernel every step and no per-layer attention, and one seed
    gives one result."""
    ids, media, mask, feats = _wide_inputs(3, 42)
    _, pc, _, tp = wide
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    mega = _count_calls(monkeypatch, pmega, "decode_step_megakernel")
    layer = _count_calls(monkeypatch, pgpt2, "decode_attention_beam")

    def gen():
        return model.generate(ids, media_locations=media, attention_mask=mask,
                              visual_features=feats, max_length=MAX_LENGTH,
                              eos_token_id=NO_EOS, pad_token_id=0,
                              prefix_block=PREFIX_BLOCK, num_beams=3,
                              do_sample=True, top_k=50, megakernel=True,
                              return_scores=True,
                              generator=torch.Generator().manual_seed(3))
    toks, scores = gen()
    assert toks.shape == (3, MAX_LENGTH) and scores.shape == (3,)
    assert len(mega) == MAX_LENGTH - ids.shape[1] - 1 and not layer
    np.testing.assert_array_equal(toks[:, :ids.shape[1]].numpy(), ids)
    assert bool(((toks >= 0) & (toks < 513)).all()) and bool(torch.isfinite(scores).all())
    again, _ = gen()
    assert torch.equal(toks, again)
