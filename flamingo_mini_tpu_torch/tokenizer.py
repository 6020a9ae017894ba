"""Byte-level BPE tokenizer (GPT-2 / OPT families), port of
``flamingo_mini_tpu/tokenizer.py``.

Vocabularies load from local files (``vocab.json`` + ``merges.txt``, the
GPT-2 artifact format found in any HF checkpoint directory or cache).
Behaviour is the JAX package's:

* byte-level pre-tokenization with the GPT-2 pattern;
* GPT-2: no BOS by default (the reference's fast tokenizer ignores
  ``add_bos_token``); OPT prepends ``</s>`` (id 2); ``add_bos`` overrides;
* added tokens (``<EOC>``) get ids after the base vocab;
* ``encode(" <")[-1] != encode("<")[-1]``: the leading-space split that
  the processor's media locations depend on.

The GPT-2 pattern's ``\\p{L}`` and ``\\p{N}`` are Unicode general
categories (L*, N*), which Python's ``re`` has no syntax for, and its
``\\s`` is the Unicode ``White_Space`` property, which is not ``re``'s
``\\s`` (that one also takes U+001C..U+001F). ``pre_tokenize`` therefore
runs ``re`` over explicit character classes built once from
``unicodedata``: the same tokens for every assigned code point of the
interpreter's Unicode version.

Words merge in the C++ merger (``native/bpe.cpp``) when the rank table
resolves to vocab ids and every byte symbol is in the vocab; otherwise in
the Python merger, which gives the same result. A failed build or load of
the merger raises.
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

# the Unicode White_Space property (the GPT-2 pattern's \s)
_WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029"
                "\u202f\u205f\u3000")


def _char_class(code_points: List[int]) -> str:
    """A character class body of the sorted code points, as ranges."""
    parts, i = [], 0
    while i < len(code_points):
        j = i
        while j + 1 < len(code_points) and code_points[j + 1] == code_points[j] + 1:
            j += 1
        lo, hi = code_points[i], code_points[j]
        parts.append(f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}")
        i = j + 1
    return "".join(parts)


@lru_cache()
def _pattern() -> "re.Pattern[str]":
    """GPT-2's ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`` with its classes spelled out."""
    letters, numbers = [], []
    for c in range(0x110000):
        major = unicodedata.category(chr(c))[0]
        if major == "L":
            letters.append(c)
        elif major == "N":
            numbers.append(c)
    L, N, S = _char_class(letters), _char_class(numbers), _WHITE_SPACE
    return re.compile(
        rf"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+"
        rf"|[{S}]+(?![^{S}])|[{S}]+")


def pre_tokenize(text: str) -> List[str]:
    """The GPT-2 pattern's ``findall``: the words BPE merges within."""
    return _pattern().findall(text)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->unicode table (printable chars for all 256
    byte values so BPE operates on unicode strings)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class BPETokenizer:
    """Byte-level BPE with the GPT-2 algorithm.

    Interface consumed by FlamingoProcessor:
      encode(text) -> List[int]           (BOS per ``add_bos``)
      decode(ids, skip_special_tokens)    -> str
      eos_token / eos_token_id / pad_token / pad_token_id
      add_token(tok) -> id
      vocab_size / __len__
    """

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: List[Tuple[str, str]],
        *,
        eos_token: str = "<|endoftext|>",
        bos_token: Optional[str] = None,
        unk_token: Optional[str] = None,
        add_bos: bool = True,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: Dict[str, str] = {}
        self.eos_token = eos_token
        self.bos_token = bos_token if bos_token is not None else eos_token
        self.unk_token = unk_token if unk_token is not None else eos_token
        self.pad_token = eos_token  # the reference sets pad = eos
        self.add_bos = add_bos
        self.added_tokens: Dict[str, int] = {}
        self.added_ids: Dict[int, str] = {}
        self._id_cache: Dict[str, List[int]] = {}
        self._native = None          # the C++ merger, built at first encode
        self._native_tried = False

    # -- vocab -----------------------------------------------------------
    @property
    def eos_token_id(self) -> int:
        return self.encoder[self.eos_token]

    @property
    def bos_token_id(self) -> int:
        return self.encoder[self.bos_token]

    @property
    def pad_token_id(self) -> int:
        return self.encoder[self.pad_token]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def __len__(self) -> int:
        return len(self.encoder) + len(self.added_tokens)

    def add_token(self, token: str) -> int:
        """Register an added token (id continues after base vocab)."""
        if token in self.added_tokens:
            return self.added_tokens[token]
        idx = len(self)
        self.added_tokens[token] = idx
        self.added_ids[idx] = token
        return idx

    # -- BPE -------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        """The Python merger: the word's symbols joined by spaces."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        if len(word) < 2:
            self.cache[token] = token
            return token
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
        out = " ".join(word)
        self.cache[token] = out
        return out

    def native_triples(self) -> Optional[List[Tuple[int, int, int]]]:
        """The rank table as (left, right, merged) vocab ids in rank order,
        or None where the C++ merger would not give the Python merger's
        ids: a merge whose parts or result are not in the vocab, or a byte
        symbol missing from it."""
        triples = []
        for (a, b), _rank in sorted(self.bpe_ranks.items(), key=lambda kv: kv[1]):
            ia, ib = self.encoder.get(a), self.encoder.get(b)
            im = self.encoder.get(a + b)
            if ia is None or ib is None or im is None:
                return None
            triples.append((ia, ib, im))
        if any(c not in self.encoder for c in self.byte_encoder.values()):
            return None
        return triples

    def _get_native(self):
        """The C++ merger, built on first use where ``native_triples``
        allows it; None keeps the Python merger."""
        if not self._native_tried:
            self._native_tried = True
            triples = self.native_triples()
            if triples is not None:
                from .native import NativeBPE
                self._native = NativeBPE(triples)
        return self._native

    def _encode_plain(self, text: str) -> List[int]:
        ids: List[int] = []
        native = self._get_native()
        for token in pre_tokenize(text):
            token_b = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            cached = self._id_cache.get(token_b)
            if cached is None:
                if native is not None:
                    cached = native.encode_word([self.encoder[c] for c in token_b])
                else:
                    cached = [self.encoder.get(p, self.encoder.get(self.unk_token, 0))
                              for p in self._bpe(token_b).split(" ")]
                self._id_cache[token_b] = cached
            ids.extend(cached)
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        """Tokenize; splits out added tokens first (HF added-token semantics)."""
        ids: List[int] = []
        if add_special_tokens and self.add_bos:
            ids.append(self.bos_token_id)
        # split out added tokens and the special tokens that are single vocab
        # entries (<|endoftext|>), so BPE never fragments them: a fragmented
        # eos would leak a '<' token into the media locations
        specials = {t: self.encoder[t]
                    for t in {self.eos_token, self.bos_token, self.pad_token}
                    if t in self.encoder}
        table = {**specials, **self.added_tokens}
        if table:
            pattern = "(" + "|".join(
                re.escape(t) for t in sorted(table, key=len, reverse=True)) + ")"
            parts = re.split(pattern, text)
        else:
            parts = [text]
        for part in parts:
            if not part:
                continue
            if part in table:
                ids.append(table[part])
            else:
                ids.extend(self._encode_plain(part))
        return ids

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        """Ids -> text. Added tokens (``<EOC>``) are kept, as HF keeps
        non-special added tokens; ``skip_special_tokens`` drops eos, bos
        and pad."""
        pieces: List[str] = []
        special = {self.eos_token_id, self.bos_token_id, self.pad_token_id}
        for i in ids:
            i = int(i)
            if i in self.added_ids:
                pieces.append(self.added_ids[i])
            elif i in self.decoder:
                if skip_special_tokens and i in special:
                    continue
                tok = self.decoder[i]
                pieces.append(bytes(self.byte_decoder[c] for c in tok)
                              .decode("utf-8", errors="replace"))
        return "".join(pieces)

    def batch_decode(self, batch, skip_special_tokens: bool = False) -> List[str]:
        """Rows of ids (lists, a 2-D array or tensor) -> texts."""
        if hasattr(batch, "tolist"):
            batch = batch.tolist()
        return [self.decode(row, skip_special_tokens=skip_special_tokens)
                for row in batch]

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str, **kw) -> "BPETokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_file, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    @classmethod
    def from_dir(cls, path: str, **kw) -> "BPETokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"), **kw)

    @classmethod
    def gpt2(cls, path: Optional[str] = None,
             add_bos: bool = False) -> "BPETokenizer":
        """GPT-2 tokenizer: BOS/EOS = <|endoftext|> (50256), no BOS by
        default (the reference's fast tokenizer ignores ``add_bos_token``);
        ``add_bos=True`` gives its slow (``use_fast=False``) path."""
        if path is None:
            path = _find_local_vocab("gpt2")
        return cls.from_dir(path, eos_token="<|endoftext|>", add_bos=add_bos)

    @classmethod
    def opt(cls, path: Optional[str] = None,
            add_bos: bool = True) -> "BPETokenizer":
        """OPT tokenizer: GPT-2 BPE files with </s> BOS=EOS (id 2); OPT's
        fast tokenizer prepends </s>, so add_bos defaults on."""
        if path is None:
            path = _find_local_vocab("opt")
        return cls.from_dir(path, eos_token="</s>", bos_token="</s>",
                            unk_token="</s>", add_bos=add_bos)


def _find_local_vocab(family: str) -> str:
    """Search well-known local paths for vocab files (HF cache layouts)."""
    candidates = [
        os.path.expanduser(f"~/.cache/flamingo_mini_tpu/{family}"),
    ]
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    hub = os.path.join(hf_home, "hub")
    if os.path.isdir(hub):
        # all OPT models share one GPT-2-style vocab: accept any cached size
        prefixes = {"gpt2": ("models--gpt2",),
                    "opt": ("models--facebook--opt-",)}[family]
        for entry in sorted(os.listdir(hub)):
            if not any(entry == p or entry.startswith(p) for p in prefixes):
                continue
            root = os.path.join(hub, entry, "snapshots")
            if os.path.isdir(root):
                for snap in sorted(os.listdir(root)):
                    candidates.append(os.path.join(root, snap))
    for c in candidates:
        if c and os.path.isfile(os.path.join(c, "vocab.json")):
            return c
    raise FileNotFoundError(
        f"No local {family} vocab found. Place vocab.json + merges.txt in "
        f"~/.cache/flamingo_mini_tpu/{family}/, or pass its directory.")


def build_toy_tokenizer(words: List[str], **kw) -> BPETokenizer:
    """Tiny tokenizer for tests: single-byte vocab + whole-word merges built
    greedily from the given words (the JAX package's vocab and merges)."""
    byte_enc = bytes_to_unicode()
    vocab: Dict[str, int] = {}
    for ch in byte_enc.values():
        vocab.setdefault(ch, len(vocab))
    merges: List[Tuple[str, str]] = []
    seen = set()

    def add_word(w: str):
        sym = [byte_enc[b] for b in w.encode("utf-8")]
        while len(sym) > 1:
            pair = (sym[0], sym[1])
            if pair not in seen:
                seen.add(pair)
                merges.append(pair)
            merged = sym[0] + sym[1]
            vocab.setdefault(merged, len(vocab))
            sym = [merged] + sym[2:]

    for w in words:
        add_word(w)
        add_word(" " + w)
    eos = "<|endoftext|>"
    vocab[eos] = len(vocab)
    kw.setdefault("eos_token", eos)
    return BPETokenizer(vocab, merges, **kw)
