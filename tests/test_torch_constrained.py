"""The port's constrained beam search (``force_words_ids``) against the JAX
package's ``constrained_beam_generate``.

Same weights on both sides (the JAX package initialises them,
``from_jax_numpy`` carries them over) and the same numpy inputs:
``tests/test_torch_beam.py``'s small float32 GPT-2 (D=256, 2 layers, vocab
256, a 1-layer ViT), also with EOS made likely, and
``tests/test_torch_opt.py``'s small pre-norm OPT; gates open, a
left-padded row whose image comes late. Both sides run over the head-major
cache (the int8 one too) and the lazy ancestry, in plain ops.

Tolerances: sequences identical and scores within 1e-5 (float32); over
the int8 KV cache sequences identical and scores within 5e-4 relative
(``tests/test_torch_kv_cache.py``: a K/V value within float32 rounding of
a .5 code boundary takes the neighbouring code on one side, which moves
the log-probs by about 1e-4; measured here 2.9e-4 absolute on a score of
-5.2). The constraint tables and every state transition equal JAX's.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flamingo_mini_tpu import constrained_beam as jcb
from flamingo_mini_tpu.generation import DecodeConfig as JaxDecodeConfig
from flamingo_mini_tpu.ops import layers as jl

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch import constrained_beam as pcb
from flamingo_mini_tpu_torch import generation as pgen
from flamingo_mini_tpu_torch import modeling_flamingo as pmod
from flamingo_mini_tpu_torch.generation import DecodeConfig
from flamingo_mini_tpu_torch.models import flamingo as pflam
from flamingo_mini_tpu_torch.ops import layers as pl
from test_torch_beam import (EOS, MAX_LENGTH, NO_EOS, PREFIX_BLOCK, _prompts,
                             small, small_eos)  # noqa: F401
from test_torch_kv_cache import _build
from test_torch_opt import LAYOUTS, SMALL as OPT_SMALL

PHRASE = [40, 41, 42]
ALTS = [[60, 61], [70, 71]]


@pytest.fixture(scope="module")
def opt_pre():
    return _build(dict(OPT_SMALL, **LAYOUTS["pre"]), 3)


def _impls(model, ids, media, mask, pixels, force, impl=False, **kw):
    """(JAX's, the port's) outputs of constrained_beam_generate, or with
    ``impl`` of the whole-pool impls (sequences, scores, complete flags)."""
    jc, pc, params, tp = model
    spec = jcb.normalize_force_words(force)
    dc_kw = dict(max_length=MAX_LENGTH, pad_token_id=0, prefix_block=PREFIX_BLOCK,
                 force_words_ids=spec, **kw)
    jdc, pdc = JaxDecodeConfig(**dc_kw), DecodeConfig(**dc_kw)
    jargs = (jnp.asarray(ids), jnp.asarray(media), jnp.asarray(mask), None)
    pargs = (torch.tensor(ids).long(), torch.tensor(media), torch.tensor(mask), None)
    jpx, ppx = jnp.asarray(pixels), torch.tensor(pixels)
    if impl:
        want = jcb._constrained_beam_impl(params, jc, jdc, jl.PARITY, spec, *jargs, jpx)
        got = pcb.constrained_beam_impl(tp, pc, pdc, pl.PARITY, spec, *pargs, ppx)
    else:
        want = jcb.constrained_beam_generate(params, jc, jdc, jl.PARITY, *jargs,
                                             pixel_values=jpx)
        got = pcb.constrained_beam_generate(tp, pc, pdc, pl.PARITY, *pargs,
                                            pixel_values=ppx)
    return (jax.tree_util.tree_map(np.asarray, want),
            jax.tree_util.tree_map(lambda t: t.numpy(), got))


def _contains(row, phrase) -> bool:
    n = len(phrase)
    return any(list(row[i:i + n]) == list(phrase) for i in range(len(row) - n + 1))


CASES = {
    "phrasal": dict(force=[PHRASE]),
    # a hypothesis of the pools ends in EOS
    "phrasal_eos": dict(force=[[30]], eos="reachable"),
    "disjunctive": dict(force=[ALTS]),
    "two_constraints": dict(force=[[50, 51], [90]], length_penalty=0.8),
    "no_repeat_ngram": dict(force=[PHRASE], no_repeat_ngram_size=2),
    "int8_kv_cache": dict(force=[PHRASE, [90]], int8_kv_cache=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_constrained_f32_matches_jax(small, small_eos, case):
    """The whole pools (b, k, max_length), their scores and complete flags."""
    kw = dict(CASES[case])
    force = kw.pop("force")
    eos = EOS if kw.pop("eos", None) else NO_EOS
    model = small_eos if eos == EOS else small
    ids, media, mask, pixels = _prompts(4, seed=6)
    (wt, ws, wf), (gt, gs, gf) = _impls(model, ids, media, mask, pixels, force,
                                        impl=True, num_beams=3, eos_token_id=eos, **kw)
    assert gt.shape == (4, 3, MAX_LENGTH) and gs.shape == gf.shape == (4, 3)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(gf, wf)
    if kw.get("int8_kv_cache"):
        np.testing.assert_allclose(gs, ws, atol=0, rtol=5e-4)
    else:
        np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
    # every hypothesis flagged complete holds its constraints after the prompt
    spec = jcb.normalize_force_words(force)
    assert gf[:, 0].all()
    for row in gt[gf][:, ids.shape[1]:]:
        for alts in spec:
            assert any(_contains(row, alt) for alt in alts), (row, alts)
    if eos != NO_EOS:
        assert any(eos in row for row in gt[gf][:, ids.shape[1]:])


def test_constrained_return_sequences_fallback_matches_jax(small):
    """A 3-token phrase and 2 new tokens: no hypothesis can complete, so
    the finalize fallback fills the pool with the best incomplete beams
    (flagged incomplete, their true scores)."""
    ids, media, mask, pixels = _prompts(4, seed=7)
    kw = dict(num_beams=3, eos_token_id=NO_EOS, num_return_sequences=2,
              max_new_tokens=2, return_scores=True)
    (wt, ws, wf), (gt, gs, gf) = _impls(small, ids, media, mask, pixels, [PHRASE],
                                        impl=True, **kw)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(gf, wf)
    assert not gf[:, :2].any() and (gs[:, :2] > -1e8).all()
    # constrained_beam_generate returns the top 2 of each pool, interleaved
    _, pc, _, tp = small
    dc = DecodeConfig(max_length=MAX_LENGTH, pad_token_id=0, prefix_block=PREFIX_BLOCK,
                      force_words_ids=jcb.normalize_force_words([PHRASE]), **kw)
    gt2, gs2 = pcb.constrained_beam_generate(
        tp, pc, dc, pl.PARITY, torch.tensor(ids).long(), torch.tensor(media),
        torch.tensor(mask), None, pixel_values=torch.tensor(pixels))
    assert gt2.shape == (8, MAX_LENGTH) and gs2.shape == (8,)
    np.testing.assert_array_equal(gt2.numpy(), gt[:, :2].reshape(8, MAX_LENGTH))
    np.testing.assert_array_equal(gs2.numpy(), gs[:, :2].reshape(8))


def test_constrained_opt_matches_jax(opt_pre):
    """The pre-norm OPT trunk over its head-major cache."""
    ids, media, mask, pixels = _prompts(4, seed=8)
    (wt, ws), (gt, gs) = _impls(opt_pre, ids, media, mask, pixels, [PHRASE, ALTS],
                                num_beams=3, eos_token_id=NO_EOS, return_scores=True)
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_allclose(gs, ws, atol=1e-5, rtol=0)


def test_lists_and_tuples_give_the_same_tokens(small, monkeypatch):
    """``FlamingoModel.generate`` normalises HF's nested lists as JAX's
    does: a phrase becomes one alternative, a disjunctive set stays nested;
    given as lists or as tuples, the same tokens, and the normalised
    spec's."""
    jc, pc, params, tp = small
    model = port.FlamingoModel(pc, params=tp, device="cpu")
    ids, media, mask, pixels = _prompts(4, seed=9)

    def gen(force):
        return model.generate(ids, media_locations=media, attention_mask=mask,
                              pixel_values=pixels, max_length=MAX_LENGTH,
                              eos_token_id=NO_EOS, pad_token_id=0,
                              prefix_block=PREFIX_BLOCK, num_beams=3,
                              force_words_ids=force).numpy()
    as_lists = gen([list(PHRASE), [list(a) for a in ALTS]])
    as_tuples = gen((tuple(PHRASE), tuple(tuple(a) for a in ALTS)))
    np.testing.assert_array_equal(as_lists, as_tuples)
    spec = ((tuple(PHRASE),), tuple(tuple(a) for a in ALTS))
    np.testing.assert_array_equal(as_lists, gen(spec))
    # the config holds the normalised, hashable spec
    configs = []
    impl = pmod.generate_impl
    monkeypatch.setattr(pmod, "generate_impl",
                        lambda params, config, dc, *a, **k:
                        configs.append(dc) or impl(params, config, dc, *a, **k))
    gen([list(PHRASE), [list(a) for a in ALTS]])
    assert configs[0].force_words_ids == spec
    hash(configs[0])


# ---------------------------------------------------------------------------
# the constraint tables, the states, the checks
# ---------------------------------------------------------------------------


SPECS = {
    "phrase": [[5, 6, 7]],
    "disjunctive": [[[4, 5], [4, 6, 9], [7]]],
    "mixed": [[1, 2, 3], [[4, 5], [4, 6], [7]], [8], [2, 2]],
}


@pytest.mark.parametrize("spec", list(SPECS))
def test_constraint_tables_match_jax(spec):
    want_spec = jcb.normalize_force_words(SPECS[spec])
    got_spec = pcb.normalize_force_words(SPECS[spec])
    assert got_spec == want_spec
    w, g = jcb.ConstraintTables(want_spec), pcb.ConstraintTables(got_spec)
    for name in ("edge_node", "edge_tok", "edge_next", "edge_cidx", "edge_leaf",
                 "edge_is_root", "node_bank", "roots"):
        np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
    for name in ("max_seqlen", "full_mask", "n_edges", "n_nodes", "n_constraints"):
        assert getattr(g, name) == getattr(w, name), name


@pytest.mark.parametrize("spec", list(SPECS))
def test_state_walks_match_jax(spec):
    """64 walks of 12 tokens drawn from the constraints' tokens and others:
    every state (mask, constraint, node) and bank equals JAX's."""
    norm = jcb.normalize_force_words(SPECS[spec])
    jt, pt = jcb.ConstraintTables(norm), pcb.ConstraintTables(norm)
    rs = np.random.RandomState(len(spec))
    vocab = sorted({t for alts in norm for a in alts for t in a} | {0, 30})
    toks = rs.choice(vocab, size=(12, 64)).astype(np.int32)
    jm = jnp.zeros(64, jnp.int32)
    jc_ = jn = jnp.full(64, -1, jnp.int32)
    pm = torch.zeros(64, dtype=torch.int32)
    pc_ = pn = torch.full((64,), -1, dtype=torch.int32)
    for tok in toks:
        jm, jc_, jn = jcb._state_add_token(jt, jm, jc_, jn, jnp.asarray(tok))
        pm, pc_, pn = pcb._state_add_token(pt, pm, pc_, pn, torch.tensor(tok))
        for g, w in ((pm, jm), (pc_, jc_), (pn, jn)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(pcb._state_bank(pt, pm, pc_, pn).numpy(),
                                      np.asarray(jcb._state_bank(jt, jm, jc_, jn)))
    assert int((pm == pt.full_mask).sum()) > 0 or spec == "mixed"


@pytest.mark.parametrize("bad", [[[]], [[[3, 4], [3]]], [[3, -1]], [[[]]]],
                         ids=["empty", "subset", "negative", "empty_alternative"])
def test_normalize_refuses_as_jax(bad):
    with pytest.raises(ValueError):
        jcb.normalize_force_words(bad)
    with pytest.raises(ValueError):
        pcb.normalize_force_words(bad)


@pytest.mark.parametrize("knob", [dict(), dict(num_beams=3, do_sample=True),
                                  dict(num_beams=4, num_beam_groups=2),
                                  dict(num_beams=3, output_scores=True)],
                         ids=["one_beam", "do_sample", "groups", "output_scores"])
def test_config_refuses_as_jax(knob):
    spec = (((5,),),)
    with pytest.raises(ValueError):
        JaxDecodeConfig(force_words_ids=spec, **knob)
    with pytest.raises(ValueError):
        DecodeConfig(force_words_ids=spec, **knob)


def test_megakernel_refused_before_vision_and_prefill(small, monkeypatch):
    _, pc, _, tp = small
    model = port.FlamingoModel(pc, params=tp, device="cpu")

    def boom(*a, **k):
        raise AssertionError("ran before the refusal")
    monkeypatch.setattr(pflam, "encode_resample_visuals", boom)
    monkeypatch.setattr(pgen, "_prefill", boom)
    ids, media, mask, pixels = _prompts(2)
    with pytest.raises(ValueError, match="megakernel"):
        model.generate(ids, media_locations=media, attention_mask=mask,
                       pixel_values=pixels, max_length=MAX_LENGTH, num_beams=3,
                       force_words_ids=[PHRASE], megakernel=True)
