"""The port's ``generate`` with the logits chain, sampling and scores,
against the JAX package's.

Models: ``tests/test_torch_beam.py``'s small float32 one (GPT-2 D=256, 2
layers, vocab 256, a 1-layer ViT; JAX's ``Precision.HIGHEST`` policy), and
with EOS made likely, and its wide int8/bf16 one (D=1024, 2 layers,
vocab 512) for the megakernel. Weights come from JAX's initialiser through
``from_jax_numpy``; inputs from a numpy seed. Sampled runs take JAX's
noise: the port's ``gumbel_noise`` is replaced by JAX's
``gumbel(fold_in(rng, position), shape)``, the draw JAX's
``categorical`` makes for the token at that position.

Tolerances: float32 tokens identical and scores within 1e-5. bf16
megakernel (the port's plain version against JAX's kernel in interpret
mode): rows equal, or a row parts at a near-tie of the reference, as in
``tests/test_torch_beam.py``: at the first differing position, JAX's own
step values there (its logits for the prefix, through its chain, warpers
and noise) have their top two within 4 bf16 ulps of the logits' scale and
the port's pick within 4 ulps of the top; at most a quarter of the rows
part.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu import generation as jgen
from flamingo_mini_tpu.models import flamingo as jflam
from flamingo_mini_tpu.ops import layers as jl

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import generation as pgen
from test_torch_beam import (EOS, NO_EOS, SMALL, WIDE, _bridge, _int8_bf16,
                             _open_gates, _prompts, _wide_inputs)

MAX_LENGTH, PREFIX_BLOCK = 14, 4
NEG = np.finfo(np.float32).min


@pytest.fixture(scope="module")
def small():
    """(jax config, port config, jax params, port params), float32, EOS
    (token 31) likely: its row of the tied embedding scaled by 3."""
    jc, pc = JaxConfig(**SMALL), port.FlamingoConfig(**SMALL)
    params = jflam.init_flamingo(jax.random.PRNGKey(0), jc)
    _open_gates(params)
    params["lm"]["wte"] = params["lm"]["wte"].at[EOS].multiply(3.0)
    return jc, pc, params, _bridge(params)


@pytest.fixture(scope="module")
def wide():
    jc, pc = JaxConfig(**WIDE), port.FlamingoConfig(**WIDE)
    params = jflam.init_flamingo(jax.random.PRNGKey(0), jc, with_vision=False)
    _open_gates(params)
    params = _int8_bf16(params)
    return jc, pc, params, _bridge(params)


def _jax_kw(kw):
    """FlamingoModel.generate's normalisation, for JAX's DecodeConfig."""
    kw = dict(kw)
    if kw.get("bad_words_ids") is not None:
        kw["bad_words_ids"] = tuple(tuple(w) for w in kw["bad_words_ids"]
                                    if list(w) != [kw["eos_token_id"]])
    if isinstance(kw.get("sequence_bias"), dict):
        kw["sequence_bias"] = tuple(kw["sequence_bias"].items())
    for name in ("suppress_tokens", "begin_suppress_tokens"):
        if kw.get(name) is not None:
            kw[name] = tuple(kw[name])
    return kw


def _jax_generate(jc, params, pol, ids, media, mask, *, pixels=None, feats=None,
                  key=None, **kw):
    dc = jgen.DecodeConfig(max_length=MAX_LENGTH, pad_token_id=0,
                           prefix_block=PREFIX_BLOCK, **_jax_kw(kw))
    out = jgen.generate(params, jc, jnp.asarray(ids), policy=pol, dc=dc,
                        media_locations=jnp.asarray(media),
                        attention_mask=jnp.asarray(mask),
                        pixel_values=None if pixels is None else jnp.asarray(pixels),
                        visual_features=None if feats is None else jnp.asarray(feats),
                        rng=key)
    return jax.tree_util.tree_map(np.asarray, out)


def _port_generate(pc, tp, ids, media, mask, *, pixels=None, feats=None, **kw):
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    out = model.generate(ids, media_locations=media, attention_mask=mask,
                         pixel_values=pixels, visual_features=feats,
                         max_length=MAX_LENGTH, pad_token_id=0,
                         prefix_block=PREFIX_BLOCK, **kw)
    return jax.tree_util.tree_map(lambda t: t.numpy(), out)


def _feed_jax_noise(monkeypatch, key, first):
    """The port draws JAX's noise: the k-th call gets
    ``gumbel(fold_in(key, first + k), shape)``, as JAX's prefill pick
    (position L) and step picks (position cur + 1) do."""
    calls = []

    def noise(shape, generator, device):
        k = jax.random.fold_in(key, first + len(calls))
        calls.append(k)
        return torch.tensor(np.asarray(jax.random.gumbel(k, tuple(shape))), device=device)
    monkeypatch.setattr(pgen, "gumbel_noise", noise)
    return calls


def _same_outputs(got, want, n_out):
    got = got if n_out > 1 else (got,)
    want = want if n_out > 1 else (want,)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# float32: greedy with each processor, with both score outputs
# ---------------------------------------------------------------------------


GREEDY = {
    "sequence_bias": dict(sequence_bias={(40,): 3.0, (17, 52): -1.5}),
    "repetition_penalty": dict(repetition_penalty=1.5),
    "no_repeat_ngram": dict(no_repeat_ngram_size=2),
    # the lone-EOS word is dropped, as HF does
    "bad_words": dict(bad_words_ids=[[EOS], [100], [17, 52]]),
    "min_new_tokens": dict(min_new_tokens=5),
    "min_length": dict(min_length=10),
    "forced_eos": dict(forced_eos_token_id=EOS, max_new_tokens=6),
    "decay": dict(exponential_decay_length_penalty=(2, 1.6)),
    "suppress": dict(suppress_tokens=[EOS, 12], begin_suppress_tokens=[40]),
}


# the score outputs each case asks for: both, return_scores alone,
# output_scores alone, in turn
SCORES = [dict(return_scores=True, output_scores=True), dict(return_scores=True),
          dict(output_scores=True)]


@pytest.mark.parametrize("case", list(GREEDY))
def test_greedy_with_processor_matches_jax(small, case):
    """Tokens identical; ``return_scores`` and ``output_scores`` within
    1e-5. EOS likely, so the length processors decide where rows end."""
    jc, pc, params, tp = small
    ids, media, mask, pixels = _prompts(4, seed=3)
    scores = SCORES[list(GREEDY).index(case) % len(SCORES)]
    kw = dict(eos_token_id=EOS, **scores, **GREEDY[case])
    want = _jax_generate(jc, params, jl.PARITY, ids, media, mask, pixels=pixels, **kw)
    got = _port_generate(pc, tp, ids, media, mask, pixels=pixels, **kw)
    _same_outputs(got, want, 1 + len(scores))
    if len(scores) == 2:
        tokens, total, steps = got
        assert (steps[:, :ids.shape[1]] == 0).all()
        np.testing.assert_allclose(steps.sum(axis=1), total, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# float32: sampling with JAX's noise
# ---------------------------------------------------------------------------


SAMPLE = {
    "top_k": dict(top_k=8),
    "top_p": dict(top_p=0.8),
    "temperature": dict(temperature=0.6),
    "min_p": dict(min_p=0.1),
    "typical_p": dict(typical_p=0.7),
    "epsilon": dict(epsilon_cutoff=3e-3),
    "eta": dict(eta_cutoff=3e-3),
    "warpers and processors": dict(top_k=20, top_p=0.9, temperature=0.8,
                                   repetition_penalty=1.2, no_repeat_ngram_size=2),
}


@pytest.mark.parametrize("case", list(SAMPLE))
def test_sampling_matches_jax(small, case, monkeypatch):
    """Tokens identical given JAX's noise; the scores (under the warped
    step distribution) within 1e-5."""
    jc, pc, params, tp = small
    ids, media, mask, pixels = _prompts(4, seed=5)
    key = jax.random.PRNGKey(11)
    kw = dict(do_sample=True, eos_token_id=EOS, return_scores=True, **SAMPLE[case])
    want = _jax_generate(jc, params, jl.PARITY, ids, media, mask, pixels=pixels,
                         key=key, **kw)
    calls = _feed_jax_noise(monkeypatch, key, ids.shape[1])
    got = _port_generate(pc, tp, ids, media, mask, pixels=pixels, **kw)
    _same_outputs(got, want, 2)
    assert len(calls) >= 2
    # the draw matters: another key gives other tokens
    other = _jax_generate(jc, params, jl.PARITY, ids, media, mask, pixels=pixels,
                          key=jax.random.PRNGKey(12), **kw)
    assert not np.array_equal(other[0], want[0])


def test_num_return_sequences_repeats_rows(small, monkeypatch):
    """Sampling with n=3: rows i*3 .. i*3+2 sample prompt i, the same tokens
    as JAX's; greedy with n > 1 raises ValueError on both sides."""
    jc, pc, params, tp = small
    ids, media, mask, pixels = _prompts(2, seed=6)
    key = jax.random.PRNGKey(3)
    kw = dict(do_sample=True, top_k=30, eos_token_id=NO_EOS, num_return_sequences=3)
    want = _jax_generate(jc, params, jl.PARITY, ids, media, mask, pixels=pixels,
                         key=key, **kw)
    _feed_jax_noise(monkeypatch, key, ids.shape[1])
    got = _port_generate(pc, tp, ids, media, mask, pixels=pixels, **kw)
    assert got.shape == (6, MAX_LENGTH)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :ids.shape[1]], np.repeat(ids, 3, axis=0))
    assert len({tuple(r) for r in got[:3]}) > 1           # three draws, not one
    with pytest.raises(ValueError):
        _port_generate(pc, tp, ids, media, mask, num_return_sequences=2)
    with pytest.raises(ValueError):
        _jax_generate(jc, params, jl.PARITY, ids, media, mask, num_return_sequences=2,
                      eos_token_id=NO_EOS)


def test_own_generator_is_seeded(small):
    """No generator: seeded 0, as JAX's rng defaults to PRNGKey(0); a
    generator seeded alike gives the same tokens, another seed others."""
    _, pc, _, tp = small
    ids, media, mask, pixels = _prompts(4, seed=7)
    kw = dict(do_sample=True, top_k=40, eos_token_id=NO_EOS, pixels=pixels)
    first = _port_generate(pc, tp, ids, media, mask, **kw)
    again = _port_generate(pc, tp, ids, media, mask, **kw)
    seeded = _port_generate(pc, tp, ids, media, mask,
                            generator=torch.Generator().manual_seed(0), **kw)
    other = _port_generate(pc, tp, ids, media, mask,
                           generator=torch.Generator().manual_seed(1), **kw)
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(first, seeded)
    assert not np.array_equal(first, other)


# ---------------------------------------------------------------------------
# float32: beams with processors
# ---------------------------------------------------------------------------


BEAM_PROCESSORS = dict(no_repeat_ngram_size=2, repetition_penalty=1.3,
                       bad_words_ids=[[EOS], [100], [17, 52]], suppress_tokens=[12])


@pytest.mark.parametrize("kind", ["beams", "diverse beams"])
def test_beams_with_processors_match_jax(small, kind):
    """The chain on the post-log_softmax scores (each group's rows after
    its Hamming penalty): tokens identical, sequences_scores within 1e-5."""
    jc, pc, params, tp = small
    ids, media, mask, pixels = _prompts(4, seed=8)
    beams = dict(num_beams=3, num_return_sequences=2) if kind == "beams" else \
        dict(num_beams=4, num_beam_groups=2, diversity_penalty=0.5)
    kw = dict(eos_token_id=EOS, return_scores=True, **beams, **BEAM_PROCESSORS)
    want = _jax_generate(jc, params, jl.PARITY, ids, media, mask, pixels=pixels, **kw)
    got = _port_generate(pc, tp, ids, media, mask, pixels=pixels, **kw)
    _same_outputs(got, want, 2)
    # the processors change the result
    plain = _port_generate(pc, tp, ids, media, mask, pixels=pixels, eos_token_id=EOS,
                           return_scores=True, **beams)
    assert not np.array_equal(plain[0], got[0])


# ---------------------------------------------------------------------------
# bf16 int8 on the megakernel
# ---------------------------------------------------------------------------


def _jax_step_values(wide, prefix, media, mask, feats, dc, key):
    """JAX's values for the pick after ``prefix`` (b, t): its bf16 logits
    from a prefill of the prefix, through its chain, warpers and the noise
    of that position -> (values (b, V), the logits' bf16 ulp (b,))."""
    jc, _, params, _ = wide
    L, t = media.shape[1], prefix.shape[1]
    ext = ((0, 0), (0, t - L))
    m, k = np.pad(media, ext), np.pad(mask, ext, constant_values=1)
    pdc = jgen.DecodeConfig(max_length=MAX_LENGTH, pad_token_id=0)
    logits, _, _ = jgen._prefill(params, jc, pdc, jl.FAST, jnp.asarray(prefix),
                                 jnp.asarray(m), jnp.asarray(k),
                                 jnp.asarray(feats).astype(jnp.bfloat16), flat=True)
    tokens = np.zeros((prefix.shape[0], MAX_LENGTH), np.int32)
    tokens[:, :t] = prefix
    buf = np.pad(k, ((0, 0), (0, MAX_LENGTH - t)))
    vals = jgen.process_logits(logits, dc, jnp.asarray(tokens), jnp.asarray(buf),
                               jnp.asarray(t, jnp.int32), L)
    top = np.abs(np.asarray(logits, np.float32).max(axis=-1))
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    if dc.do_sample:
        vals = jgen.apply_logit_filters(vals, top_k=dc.top_k, top_p=dc.top_p,
                                        temperature=dc.temperature)
        vals = vals + jax.random.gumbel(jax.random.fold_in(key, t), vals.shape)
    return np.asarray(vals), ulp


def _agree_up_to_near_ties(wide, got, want, media, mask, feats, dc, key=None, ulps=4):
    """Rows equal, or parting at a near-tie of JAX's step values (module
    docstring); at most a quarter of the rows part. -> rows that part."""
    L = media.shape[1]
    np.testing.assert_array_equal(got[:, :L], want[:, :L])
    parted = []
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r, L:] != want[r, L:])[0]
        if not len(diff):
            continue
        t = L + int(diff[0])
        parted.append(r)
        vals, ulp = _jax_step_values(wide, want[:, :t], media, mask, feats, dc, key)
        row, top = vals[r], np.sort(vals[r])[::-1]
        assert top[0] - top[1] <= ulps * ulp[r], (r, t, top[:2], ulp[r])
        assert row[got[r, t]] >= top[0] - ulps * ulp[r], (r, t, got[r, t])
    assert len(parted) <= want.shape[0] // 4, parted
    return parted


@pytest.mark.parametrize("case", ["greedy with a processor", "sampling"])
def test_megakernel_chain_matches_jax_megakernel(wide, case, monkeypatch):
    """b=4 (even, so JAX runs its megakernel, in interpret mode), row 1
    left-padded: the port's megakernel path (its plain version here)."""
    jc, pc, params, tp = wide
    ids, media, mask, feats = _wide_inputs(4, seed=40)
    key = jax.random.PRNGKey(5)
    kw = dict(eos_token_id=NO_EOS, megakernel=True)
    kw.update(dict(no_repeat_ngram_size=2, repetition_penalty=1.3)
              if case.startswith("greedy") else dict(do_sample=True, top_k=50))
    want = _jax_generate(jc, params, jl.FAST, ids, media, mask, feats=feats, key=key, **kw)
    if kw.get("do_sample"):
        _feed_jax_noise(monkeypatch, key, ids.shape[1])
    got = _port_generate(pc, tp, ids, media, mask, feats=feats, **kw)
    assert got.shape == want.shape == (4, MAX_LENGTH)
    dc = jgen.DecodeConfig(max_length=MAX_LENGTH, pad_token_id=0,
                           prefix_block=PREFIX_BLOCK, **kw)
    _agree_up_to_near_ties(wide, got, want, media, mask, feats, dc, key)


@pytest.mark.parametrize("case", ["plain greedy", "repetition_penalty", "suppress",
                                  "sampling", "return_scores", "output_scores",
                                  "fused_head=False"])
def test_fused_head_only_for_plain_greedy(wide, case, monkeypatch):
    """``lm_head_argmax`` picks only plain greedy's tokens: never when the
    chain is not the identity, or sampling or scores are asked for (or the
    head is turned off), on either decode path."""
    _, pc, _, tp = wide
    ids, media, mask, feats = _wide_inputs(2, seed=41)
    calls = []
    head = pgen.lm_head_argmax
    monkeypatch.setattr(pgen, "lm_head_argmax",
                        lambda *a, **k: calls.append(1) or head(*a, **k))
    kw = {"plain greedy": {}, "repetition_penalty": dict(repetition_penalty=1.2),
          "suppress": dict(suppress_tokens=[7]), "sampling": dict(do_sample=True),
          "return_scores": dict(return_scores=True),
          "output_scores": dict(output_scores=True),
          "fused_head=False": dict(fused_head=False)}[case]
    for megakernel in (False, True):
        calls.clear()
        out = _port_generate(pc, tp, ids, media, mask, feats=feats, max_new_tokens=4,
                             eos_token_id=NO_EOS, megakernel=megakernel, **kw)
        tokens = out[0] if isinstance(out, tuple) else out
        assert tokens.shape == (2, MAX_LENGTH)
        assert len(calls) == (3 if case == "plain greedy" else 0), (megakernel, calls)


def test_odd_batch_samples_on_the_megakernel(wide, monkeypatch):
    """An odd batch samples on the port's megakernel path as given (JAX
    falls back to its per-layer path there): every step on the kernel,
    the prompts intact, every token in the vocabulary. Run, not compared."""
    _, pc, _, tp = wide
    ids, media, mask, feats = _wide_inputs(3, seed=42)
    from flamingo_mini_tpu_torch.ops import megadecode as pmega
    steps = []
    mega = pmega.decode_step_megakernel
    monkeypatch.setattr(pmega, "decode_step_megakernel",
                        lambda *a, **k: steps.append(1) or mega(*a, **k))
    out = _port_generate(pc, tp, ids, media, mask, feats=feats, do_sample=True,
                         top_k=20, eos_token_id=NO_EOS, megakernel=True)
    assert len(steps) == MAX_LENGTH - ids.shape[1] - 1
    assert out.shape == (3, MAX_LENGTH)
    np.testing.assert_array_equal(out[:, :ids.shape[1]], ids)
    assert ((out >= 0) & (out < pc.lm_arch.vocab_size + 1)).all()
