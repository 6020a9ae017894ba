"""The port's tokenizer against the JAX package's.

* ``pre_tokenize`` (``re`` over classes built from ``unicodedata``) equals
  JAX's ``_PAT.findall`` (the ``regex`` package): explicit cases
  (contractions, whitespace runs before text and at the end, U+001C..1F,
  which ``re``'s ``\\s`` takes and White_Space does not, digits of
  categories Nd, No and Nl, combining marks, emoji) and Hypothesis text.
  Hypothesis draws only code points assigned in the interpreter's
  ``unicodedata`` (``unicodedata.unidata_version``, 15.0.0 on Python
  3.12): ``regex`` may know a newer Unicode, whose new letters and digits
  are unassigned here. Lone surrogates (Cs) cannot be encoded and are
  left out too.
* ``encode`` / ``decode`` equal JAX's over GPT-2- and OPT-flavoured toy
  vocabularies (``torch_toy_vocab``): the BOS defaults, ``add_bos``,
  ``<EOC>``, ``<|endoftext|>`` inside text, ``skip_special_tokens``.
* the C++ merger (built under ``build/native/``) equals the Python merger
  and JAX's ``NativeBPE``; a rank table that does not resolve to vocab ids,
  or a vocab without every byte symbol, keeps the Python merger; a failed
  build raises with g++'s output.
* ``build_toy_tokenizer`` gives JAX's vocab and merges.
"""
import os
import unicodedata

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from flamingo_mini_tpu import tokenizer as jtok
from flamingo_mini_tpu_torch import native as pnative
from flamingo_mini_tpu_torch import tokenizer as ptok
from torch_toy_vocab import WORDS, write_toy_vocab

PRE_CASES = [
    "", "a", "Hello world", "I'm you're we've they'll he'd it's don't",
    "'S 'T 'Re uppercase are not contractions", "x's'' 's", "?!'s end's",
    "a   b", "   lead", "trail   ", "two  spaces then\n\n\nnewlines \n x",
    "tabs\t\tx\t", "　　x　", "x\x1c\x1dy \x1f z", "nbsp\xa0x \x85y",
    "123 4567 ²³ Ⅻ Ⅷ ١٢٣ ½ ⅞ 12ab34", "été café ́x",
    "hi 👋🏽 🇫🇷 👨‍👩‍👧 ok", "<image>A picture of<|endoftext|>",
    "mixed-case_ID = 42; // comment", "日本語のテキスト と 中文", "   ",
]


@pytest.mark.parametrize("text", PRE_CASES)
def test_pre_tokenize_matches_jax(text):
    assert ptok.pre_tokenize(text) == jtok._PAT.findall(text)


ASSIGNED = st.characters(exclude_categories=("Cs", "Cn")).filter(
    lambda c: unicodedata.category(c) != "Cn")
TEXT = st.text(alphabet=st.one_of(
    ASSIGNED, st.sampled_from([" ", " ", "'", "s", "\n", "\t", "　", "\x1c",
                               "́", "1", "²"])), max_size=40)


@settings(max_examples=400, deadline=None)
@given(TEXT)
def test_pre_tokenize_matches_jax_on_drawn_text(text):
    assert ptok.pre_tokenize(text) == jtok._PAT.findall(text)


@pytest.fixture(scope="module")
def vocab_dirs(tmp_path_factory):
    return {fam: write_toy_vocab(str(tmp_path_factory.mktemp(fam)), fam)
            for fam in ("gpt2", "opt")}


TEXTS = ["a cat", "a cat a dog of a picture", "<image>a red dog<EOC>",
         " a cat  of", "a cat<|endoftext|>the dog", "<image>photo of</s> a mat",
         "unknownwordxyz with cat's mat", "it's you're here", "",
         "tokenization tokenization", "ünïcödé <image> 12"]


def _pair(vocab_dirs, family, add_bos):
    ctor = "gpt2" if family == "gpt2" else "opt"
    kw = {} if add_bos is None else {"add_bos": add_bos}
    j = getattr(jtok.BPETokenizer, ctor)(vocab_dirs[family], **kw)
    p = getattr(ptok.BPETokenizer, ctor)(vocab_dirs[family], **kw)
    assert j.add_token("<EOC>") == p.add_token("<EOC>")
    return j, p


@pytest.mark.parametrize("add_bos", [None, True, False])
@pytest.mark.parametrize("family", ["gpt2", "opt"])
def test_encode_decode_match_jax(vocab_dirs, family, add_bos):
    j, p = _pair(vocab_dirs, family, add_bos)
    assert p.add_bos == j.add_bos and p.bos_token_id == j.bos_token_id
    assert p.eos_token_id == j.eos_token_id and len(p) == len(j)
    for text in TEXTS:
        ids = p.encode(text)
        assert ids == j.encode(text), text
        assert p.encode(text, add_special_tokens=False) == \
            j.encode(text, add_special_tokens=False)
        for skip in (False, True):
            assert p.decode(ids, skip_special_tokens=skip) == \
                j.decode(ids, skip_special_tokens=skip)
    rows = [p.encode(t) for t in TEXTS[:4]]
    width = max(map(len, rows))
    padded = np.array([r + [p.pad_token_id] * (width - len(r)) for r in rows])
    assert p.batch_decode(padded, skip_special_tokens=True) == \
        j.batch_decode(padded, skip_special_tokens=True)
    # the leading-space '<' differs from the bare one (media locations)
    assert p.encode(" <", add_special_tokens=False)[-1] != \
        p.encode("<", add_special_tokens=False)[-1]


def test_special_tokens_split_out(vocab_dirs):
    j, p = _pair(vocab_dirs, "gpt2", None)
    ids = p.encode("a<|endoftext|><EOC>cat")
    assert ids == j.encode("a<|endoftext|><EOC>cat")
    assert p.eos_token_id in ids and p.added_tokens["<EOC>"] in ids


def test_native_merger_matches_python_and_jax(vocab_dirs):
    from flamingo_mini_tpu.native import NativeBPE as JaxNative
    p = ptok.BPETokenizer.gpt2(vocab_dirs["gpt2"])
    native = p._get_native()
    assert isinstance(native, pnative.NativeBPE)
    lib = pnative.library_path()
    assert os.path.isfile(lib)
    assert os.path.dirname(lib) == pnative.BUILD_DIR
    assert pnative.BUILD_DIR.endswith(os.path.join("build", "native"))
    jax_native = JaxNative(p.native_triples())
    rs = np.random.RandomState(0)
    text = " ".join(rs.choice(WORDS + ["xyzzy", "catdog", "aaaa", "ofof"], 300))
    for token in ptok.pre_tokenize(text):
        token_b = "".join(p.byte_encoder[b] for b in token.encode("utf-8"))
        sym = [p.encoder[c] for c in token_b]
        python = [p.encoder[s] for s in p._bpe(token_b).split(" ")]
        assert native.encode_word(sym) == python == jax_native.encode_word(sym), token


def test_incomplete_rank_table_keeps_python_merger(vocab_dirs):
    """JAX's exactness gate: a merge whose result is not in the vocab, or a
    vocab missing a byte symbol, keeps the Python merger (not an error)."""
    for plant in ("merge", "byte"):
        j = jtok.BPETokenizer.gpt2(vocab_dirs["gpt2"])
        p = ptok.BPETokenizer.gpt2(vocab_dirs["gpt2"])
        for t in (j, p):
            if plant == "merge":
                t.bpe_ranks[("x", "q")] = len(t.bpe_ranks)   # "xq" not in vocab
            else:
                del t.encoder["Ā"]                          # byte 0's symbol
                t.decoder = {v: k for k, v in t.encoder.items()}
        assert p.native_triples() is None and p._get_native() is None
        assert j._get_native() is None
        for text in TEXTS:
            assert p.encode(text) == j.encode(text), (plant, text)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bpe.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pnative, "SOURCE", str(bad))
    monkeypatch.setattr(pnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pnative.build()
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path / "build"))


@pytest.mark.parametrize("words", [WORDS, ["aaaa", "aaab", "ab", "ba", "été", "日本"]])
def test_build_toy_tokenizer_matches_jax(words):
    j = jtok.build_toy_tokenizer(list(words))
    p = ptok.build_toy_tokenizer(list(words))
    assert p.encoder == j.encoder
    assert p.bpe_ranks == j.bpe_ranks
    assert ptok.bytes_to_unicode() == jtok.bytes_to_unicode()
