"""The port's FlamingoProcessor against the JAX package's, both families
(GPT-2- and OPT-flavoured toy vocabularies from ``torch_toy_vocab``, the
families' BOS defaults and overrides): ``encode_text`` ids, media
locations and mask (left and right padding, ``length``, ``max_length``),
``get_media_locations`` (the two ``"<"`` ids OR-ed, also where they are
one id), ``prepare_caption(s)``, ``remove_tags`` and ``__call__``, with
the port's tensors on the CPU compared as numpy, values exact and pixels
within 1e-4."""
import numpy as np
import pytest
import torch

from flamingo_mini_tpu import FlamingoConfig as JaxConfig
from flamingo_mini_tpu.flamingo_processor import FlamingoProcessor as JaxProcessor

import flamingo_mini_tpu_torch as port
from flamingo_mini_tpu_torch.tokenizer import build_toy_tokenizer
from torch_toy_vocab import write_toy_vocab

LM = {"gpt2": "gpt2", "opt": "facebook/opt-125m"}
PROMPTS = ["<image>A picture of", "<image>a cat sat on the mat<EOC>",
           "a dog <image>photo of a red<|endoftext|>", "of",
           "<image>one <image>two <image>"]


@pytest.fixture(scope="module")
def vocab_dirs(tmp_path_factory):
    return {fam: write_toy_vocab(str(tmp_path_factory.mktemp(fam)), fam)
            for fam in ("gpt2", "opt")}


def _pair(vocab_dirs, family, add_bos=None):
    j = JaxProcessor(JaxConfig(lm=LM[family]), vocab_path=vocab_dirs[family],
                     add_bos=add_bos)
    p = port.FlamingoProcessor(port.FlamingoConfig(lm=LM[family]),
                               vocab_path=vocab_dirs[family], add_bos=add_bos,
                               device="cpu")
    assert p.leq_ids == j.leq_ids and p.eoc_token_id == j.eoc_token_id
    return j, p


def _same(got, want):
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [{}, {"pad_side": "right"}, {"length": 6},
                                {"length": 30, "pad_side": "right"},
                                {"max_length": 5}, {"max_length": 50}])
@pytest.mark.parametrize("add_bos", [None, True, False])
@pytest.mark.parametrize("family", ["gpt2", "opt"])
def test_encode_text_matches_jax(vocab_dirs, family, add_bos, kw):
    j, p = _pair(vocab_dirs, family, add_bos)
    for text in (PROMPTS, PROMPTS[0], PROMPTS[2:4]):
        got = p.encode_text(text, **kw)
        want = j.encode_text(text, **kw)
        assert got[0].dtype == torch.int64
        assert got[1].dtype == got[2].dtype == torch.int32
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("family", ["gpt2", "opt"])
def test_captions_tags_and_call_match_jax(vocab_dirs, family):
    j, p = _pair(vocab_dirs, family)
    caps = ["a cat", " on the mat ", ""]
    assert p.prepare_caption(caps[0]) == j.prepare_caption(caps[0])
    assert p.prepare_captions(caps) == j.prepare_captions(caps)
    texts = [p.tokenizer.decode(p.tokenizer.encode(c)) for c in p.prepare_captions(caps)]
    assert p.remove_tags(texts) == j.remove_tags(texts)
    assert p.remove_tags(texts[0]) == j.remove_tags(texts[0])
    rs = np.random.RandomState(0)
    images = [rs.randint(0, 256, (240, 320, 3)).astype(np.uint8),
              rs.randint(0, 256, (300, 200)).astype(np.uint8)]
    got, want = p(images=images, text=PROMPTS[:3]), j(images=images, text=PROMPTS[:3])
    assert sorted(got) == sorted(want)
    for key in ("input_ids", "media_locations", "attention_mask"):
        _same(got[key], want[key])
    np.testing.assert_allclose(got["pixel_values"].numpy(),
                               np.asarray(want["pixel_values"]), rtol=0, atol=1e-4)
    assert sorted(p(text="a cat")) == ["attention_mask", "input_ids", "media_locations"]


def test_media_locations_or_where_both_lt_ids_agree():
    """A vocab without the " <" merge gives "<" and " <" one id: the two
    matches are OR-ed, so each tag counts once."""
    words = ["a", "cat", "image"]
    j = JaxProcessor(JaxConfig(lm="gpt2"), tokenizer=build_toy_tokenizer(words))
    p = port.FlamingoProcessor(port.FlamingoConfig(lm="gpt2"),
                               tokenizer=build_toy_tokenizer(words), device="cpu")
    assert p.leq_ids[0] == p.leq_ids[1] == j.leq_ids[0]
    ids, media, _ = p.encode_text(["<image>a cat <image>"])
    _same(media, j.get_media_locations(np.asarray(ids)))
    assert int(media.sum()) == 2
    _same(p.get_media_locations(ids.numpy()), media.numpy())


def test_processor_tensors_on_its_device(vocab_dirs):
    p = port.FlamingoProcessor(port.FlamingoConfig(lm="gpt2"),
                               vocab_path=vocab_dirs["gpt2"], device="cpu")
    assert p.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in p.encode_text("a cat"))
    with pytest.raises(ValueError, match="unsupported lm"):
        port.FlamingoProcessor(port.FlamingoConfig(lm="gpt2").__class__(lm="llama"),
                               vocab_path=vocab_dirs["gpt2"], device="cpu")
