"""The port's logits-processor chain, sampling warpers and token selection
against the JAX package's.

Same (b, V) float32 logits and (b, max_length) token and mask buffers,
made from a numpy seed, through ``flamingo_mini_tpu.generation`` and
``flamingo_mini_tpu_torch.generation``. Tolerances: the masks (entries at
float32's ``finfo.min``) identical, the other values within 1e-6 relative;
a sampled token identical given the same Gumbel noise, its log-prob within
1e-6. The port's own draw (a ``torch.Generator``) is held to the
distribution the warped logits define.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import generation as jgen

from flamingo_mini_tpu_torch import generation as pgen

B, V, T, L, EOS = 4, 64, 24, 6, 3
NEG = np.finfo(np.float32).min


def _logits(seed, b=B, v=V, scale=3.0):
    return (np.random.RandomState(seed).randn(b, v) * scale).astype(np.float32)


def _buffers(seed):
    """Token and mask buffers with repeats to match: rows 0 and 2 repeat
    their prompt's n-grams, row 1 is left-padded by 2 (pad id 0)."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(4, 20, (B, T)).astype(np.int32)
    tokens[0, 10:14] = tokens[0, 2:6]
    tokens[2, 12:15] = tokens[2, 0:3]
    mask = np.ones((B, T), np.int32)
    tokens[1, :2], mask[1, :2] = 0, 0
    return tokens, mask


def _same(got: np.ndarray, want: np.ndarray):
    np.testing.assert_array_equal(got == NEG, want == NEG)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# the warpers
# ---------------------------------------------------------------------------


WARPERS = {
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=5),
    "top_k past the vocab": dict(top_k=1000),
    "top_p": dict(top_p=0.8),
    "min_p": dict(min_p=0.1),
    "typical_p": dict(typical_p=0.9),
    "epsilon": dict(epsilon_cutoff=0.02),
    "eta": dict(eta_cutoff=0.02),
    "all": dict(temperature=0.8, top_k=10, top_p=0.9, min_p=0.05,
                typical_p=0.95, epsilon_cutoff=1e-3, eta_cutoff=1e-3),
}


@pytest.mark.parametrize("case", list(WARPERS))
def test_warper_matches_jax(case):
    kw = WARPERS[case]
    logits = _logits(1)
    want = np.asarray(jgen.apply_logit_filters(jnp.asarray(logits), **kw))
    got = pgen.apply_logit_filters(torch.tensor(logits), **kw)
    assert got.dtype == torch.float32
    _same(got.numpy(), want)


def _tied_at_cut(kind):
    """Logits with tied values where the cut falls: for top-k the 4th to
    7th largest equal (k=5 cuts inside the tie); for top-p six tokens share
    one logit where the cumulative mass crosses 1 - top_p, so the stable
    sort's order decides."""
    logits = _logits(2, scale=1.0)
    if kind == "top_k":
        order = np.argsort(-logits, axis=-1)
        for r in range(B):
            logits[r, order[r, 3:7]] = logits[r, order[r, 3]]
        return logits, dict(top_k=5)
    logits = np.full((B, V), -4.0, np.float32)
    logits[:, :6] = 1.0                       # six tied tokens in front
    logits[:, 40:44] = 2.0
    logits[:, 50] = 3.0
    return logits, dict(top_p=0.85)


@pytest.mark.parametrize("kind", ["top_k", "top_p"])
def test_warper_ties_at_the_cut_match_jax(kind):
    logits, kw = _tied_at_cut(kind)
    want = np.asarray(jgen.apply_logit_filters(jnp.asarray(logits), **kw))
    got = pgen.apply_logit_filters(torch.tensor(logits), **kw).numpy()
    kept = (want != NEG).sum(axis=-1)
    if kind == "top_k":
        assert (kept == 7).all(), kept        # every token tied with the k-th stays
    else:
        assert ((kept > 5) & (kept < 11)).all(), kept   # the cut falls inside the tie
    _same(got, want)


# ---------------------------------------------------------------------------
# the processors
# ---------------------------------------------------------------------------


def _bad_words(tokens):
    """A one-token word, EOS as a word, and words whose prefix ends the
    sequence at idx 14 in row 0 (2 and 3 tokens long)."""
    return ((7,), (EOS,), (int(tokens[0, 13]), 11), (int(tokens[0, 12]),
                                                     int(tokens[0, 13]), 12))


def _seq_bias(tokens):
    return (((5,), 1.5), ((int(tokens[0, 13]), 9), -2.0),
            ((int(tokens[0, 12]), int(tokens[0, 13]), 10), 4.0), ((V + 3,), 1.0))


PROCESSORS = {
    "sequence_bias": lambda t: dict(sequence_bias=_seq_bias(t)),
    "repetition_penalty": lambda t: dict(repetition_penalty=1.3),
    "no_repeat_ngram 1": lambda t: dict(no_repeat_ngram_size=1),
    "no_repeat_ngram 2": lambda t: dict(no_repeat_ngram_size=2),
    "no_repeat_ngram 3": lambda t: dict(no_repeat_ngram_size=3),
    "bad_words": lambda t: dict(bad_words_ids=_bad_words(t)),
    "min_length": lambda t: dict(min_length=12),
    "min_new_tokens": lambda t: dict(min_new_tokens=4),
    "forced_bos": lambda t: dict(forced_bos_token_id=9),
    "forced_eos": lambda t: dict(forced_eos_token_id=9, max_new_tokens=8),
    "decay": lambda t: dict(exponential_decay_length_penalty=(3, 1.5)),
    "suppress": lambda t: dict(suppress_tokens=(1, 2, 40)),
    "begin_suppress": lambda t: dict(begin_suppress_tokens=(6, 8)),
    "begin_suppress after forced_bos": lambda t: dict(
        begin_suppress_tokens=(6,), forced_bos_token_id=9),
    "all": lambda t: dict(sequence_bias=_seq_bias(t), repetition_penalty=1.3,
                          no_repeat_ngram_size=2, bad_words_ids=_bad_words(t),
                          min_new_tokens=4, forced_eos_token_id=9,
                          exponential_decay_length_penalty=(3, 1.5),
                          suppress_tokens=(1, 2), begin_suppress_tokens=(6,)),
}
# idx 1 and 2: shorter than every window (n-grams, bad words, sequence
# bias) and forced BOS's step; 6 = L: the first pick (begin suppress, min
# new tokens); 9: before the decay's start, 10 and 14 after it; 13 =
# L + 8 - 1: forced EOS's step with max_new_tokens=8
IDXS = [1, 2, 6, 9, 10, 13, 14]


@pytest.mark.parametrize("idx", IDXS)
@pytest.mark.parametrize("case", list(PROCESSORS))
def test_processor_matches_jax(case, idx):
    tokens, mask = _buffers(3)
    kw = dict(max_length=T, eos_token_id=EOS, pad_token_id=0, **PROCESSORS[case](tokens))
    prompt_len = 1 if "bos" in case else L
    logits = _logits(4)
    want = np.asarray(jgen.process_logits(
        jnp.asarray(logits), jgen.DecodeConfig(**kw), jnp.asarray(tokens),
        jnp.asarray(mask), jnp.asarray(idx, jnp.int32), prompt_len))
    got = pgen.process_logits(torch.tensor(logits), pgen.DecodeConfig(**kw),
                              torch.tensor(tokens).long(), torch.tensor(mask), idx,
                              prompt_len)
    assert got.dtype == torch.float32
    _same(got.numpy(), want)
    assert pgen._logits_chain_is_identity(pgen.DecodeConfig(**kw)) is False
    assert jgen._logits_chain_is_identity(jgen.DecodeConfig(**kw)) is False


def test_processors_bite():
    """The cases above change the logits where they should: the window
    tests are not vacuous."""
    tokens, mask = _buffers(3)
    t, m = torch.tensor(tokens).long(), torch.tensor(mask)
    logits = torch.tensor(_logits(4))

    def run(idx, prompt_len=L, **kw):
        dc = pgen.DecodeConfig(max_length=T, eos_token_id=EOS, pad_token_id=0, **kw)
        return pgen.process_logits(logits, dc, t, m, idx, prompt_len) == float(NEG)

    # no_repeat 2 at idx 14: row 0 ends with tokens[0, 13], which followed
    # tokens[0, 13 - 8] = tokens[0, 5] before
    assert run(14, no_repeat_ngram_size=2)[0, tokens[0, 6]]
    assert not run(1, no_repeat_ngram_size=2).any()
    words = _bad_words(tokens)
    banned = run(14, bad_words_ids=words)
    assert banned[0, 11] and banned[0, 12] and banned[:, 7].all() and banned[:, EOS].all()
    assert not run(2, bad_words_ids=words)[0, 12]      # 3-token word, idx < 3
    assert run(6, min_new_tokens=4)[:, EOS].all() and not run(10, min_new_tokens=4).any()
    assert run(1, 1, forced_bos_token_id=9)[:, :9].all()
    assert run(13, forced_eos_token_id=9, max_new_tokens=8)[:, 10:].all()
    assert run(6, begin_suppress_tokens=(6,))[:, 6].all()
    assert not run(7, begin_suppress_tokens=(6,)).any()


def test_chain_is_identity_by_default():
    for mod in (jgen, pgen):
        dc = mod.DecodeConfig(max_length=T)
        assert mod._logits_chain_is_identity(dc)
    tokens, mask = _buffers(3)
    logits = torch.tensor(_logits(4))
    out = pgen.process_logits(logits, pgen.DecodeConfig(max_length=T),
                              torch.tensor(tokens).long(), torch.tensor(mask), 10, L)
    assert torch.equal(out, logits)


# ---------------------------------------------------------------------------
# token selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["greedy", "top_k", "top_p", "temperature", "all"])
def test_select_token_matches_jax(case):
    """Given JAX's own ``gumbel(key, shape)`` as the noise, the port picks
    exactly ``jax.random.categorical(key, filtered)``; scores within 1e-6."""
    kw = {} if case == "greedy" else dict(
        do_sample=True, **(WARPERS[case] if case in WARPERS else dict(temperature=0.6)))
    b, v = 64, V
    logits = _logits(5, b=b)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jdc = jgen.DecodeConfig(return_scores=True, **kw)
        want, want_lp = jgen._select_token(jnp.asarray(logits), jdc, key)
        if kw:
            filtered = jgen.apply_logit_filters(
                jnp.asarray(logits), **{k: w for k, w in kw.items() if k != "do_sample"})
            np.testing.assert_array_equal(want, jax.random.categorical(key, filtered))
        noise = torch.tensor(np.asarray(jax.random.gumbel(key, (b, v))))
        got, got_lp = pgen._select_token(torch.tensor(logits),
                                         pgen.DecodeConfig(return_scores=True, **kw),
                                         noise if kw else None)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=1e-6, atol=1e-6)
    # without scores no log-prob is made
    assert pgen._select_token(torch.tensor(logits), pgen.DecodeConfig(**kw),
                              noise if kw else None)[1] is None


def test_greedy_ties_pick_the_first_index():
    logits = np.zeros((2, V), np.float32)
    logits[:, [7, 30]] = 5.0
    got, _ = pgen._select_token(torch.tensor(logits), pgen.DecodeConfig(), None)
    assert got.tolist() == [7, 7]


@pytest.mark.parametrize("kw", [dict(top_k=4), dict(top_p=0.7, temperature=0.8)],
                         ids=["top_k", "top_p"])
def test_own_draw_follows_the_warped_distribution(kw):
    """20,000 draws with the port's own noise (a CPU generator): no mass
    outside the kept set, each kept token's frequency within 5 standard
    errors of its softmax probability."""
    n, v = 20_000, 12
    row = (np.random.RandomState(6).randn(1, v) * 0.8).astype(np.float32)
    logits = torch.tensor(row).expand(n, v)
    dc = pgen.DecodeConfig(do_sample=True, **kw)
    gen = torch.Generator().manual_seed(7)
    noise = pgen.gumbel_noise(logits.shape, gen, "cpu")
    assert noise.dtype == torch.float32 and bool(torch.isfinite(noise).all())
    tok, _ = pgen._select_token(logits, dc, noise)
    freq = np.bincount(tok.numpy(), minlength=v) / n
    filtered = pgen.apply_logit_filters(torch.tensor(row), **{
        k: w for k, w in kw.items()})[0]
    kept = (filtered != float(NEG)).numpy()
    p = torch.softmax(filtered.double(), dim=-1).numpy()
    assert 1 < kept.sum() < v
    assert freq[~kept].sum() == 0.0
    se = np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p)[kept] <= 5 * se[kept]).all(), (freq, p)
    # a generator seeded alike draws alike; another seed does not
    again = pgen.gumbel_noise(logits.shape, torch.Generator().manual_seed(7), "cpu")
    other = pgen.gumbel_noise(logits.shape, torch.Generator().manual_seed(8), "cpu")
    assert torch.equal(noise, again) and not torch.equal(noise, other)
