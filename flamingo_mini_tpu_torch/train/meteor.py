"""Pure-python METEOR approximation for the zero-egress fallback evaluator;
the port's copy of ``flamingo_mini_tpu/train/meteor.py`` (stdlib only).

The reference's evaluator emits METEOR via pycocoevalcap's bundled Java jar
(the reference's training/eval.py:58-62), which is unavailable without
external resources. This module implements the METEOR algorithm (Banerjee &
Lavie 2005; Denkowski & Lavie 2014 parameters) with the EXACT and STEM
matcher stages only — no WordNet synonym or paraphrase stages, which need
external data. Documented as an approximation; on typical caption corpora
exact+stem covers the large majority of alignments.

Algorithm per (candidate, reference) pair:
  1. unigram alignment: greedy left-to-right exact matches first, then stem
     matches (Porter stemmer) over the unmatched words — the same staged
     greedy NLTK's ``meteor_score`` uses;
  2. m = matched unigrams, P = m/|cand|, R = m/|ref|,
     F = P*R / (alpha*P + (1-alpha)*R);
  3. chunks = number of maximal runs of alignment pairs that are contiguous
     and increasing in BOTH strings; penalty = gamma * (chunks/m)**beta;
  4. score = F * (1 - penalty). Sentence score = max over references;
     corpus score = arithmetic mean of sentence scores (the Java jar
     micro-averages corpus statistics instead — a small, documented
     difference).

Defaults alpha=0.9, beta=3.0, gamma=0.5 (METEOR 1.5 English task defaults,
the ones the pycocoevalcap jar ships).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

__all__ = ["porter_stem", "meteor_score", "corpus_meteor"]


# ---------------------------------------------------------------------------
# Porter stemmer (Porter 1980, the classic public algorithm; compact form)
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """The m in [C](VC)^m[V]."""
    forms = ""
    for i in range(len(stem)):
        forms += "c" if _is_cons(stem, i) else "v"
    m = 0
    prev = None
    for ch in forms:
        if prev == "v" and ch == "c":
            m += 1
        prev = ch
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (_is_cons(word, len(word) - 3)
            and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1)
            and word[-1] not in "wxy")


def porter_stem(word: str) -> str:
    """Porter (1980) stemmer, steps 1a-5b."""
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]
    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w, flag = w[:-2], True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w, flag = w[:-3], True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                     ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                     ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                     ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                     ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                     ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                "ive", "ize"):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 1:
                w = w[: -len(suf)]
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" \
                and _measure(w[:-3]) > 1:
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        if _measure(stem) > 1 or (_measure(stem) == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# METEOR
# ---------------------------------------------------------------------------


def _align(cand: Sequence[str], ref: Sequence[str]) -> List[Tuple[int, int]]:
    """Greedy staged alignment: exact matches, then Porter-stem matches."""
    pairs: List[Tuple[int, int]] = []
    used_c, used_r = set(), set()
    # stage 1: exact
    for ci, cw in enumerate(cand):
        for ri, rw in enumerate(ref):
            if ri in used_r:
                continue
            if cw == rw:
                pairs.append((ci, ri))
                used_c.add(ci)
                used_r.add(ri)
                break
    # stage 2: stem over the leftovers
    cstem = {i: porter_stem(w) for i, w in enumerate(cand) if i not in used_c}
    rstem = {i: porter_stem(w) for i, w in enumerate(ref) if i not in used_r}
    for ci, cs in cstem.items():
        for ri, rs in rstem.items():
            if ri in used_r:
                continue
            if cs == rs:
                pairs.append((ci, ri))
                used_r.add(ri)
                break
    return sorted(pairs)


def _chunks(pairs: List[Tuple[int, int]]) -> int:
    """Maximal runs contiguous and increasing in both strings."""
    if not pairs:
        return 0
    n = 1
    for (c0, r0), (c1, r1) in zip(pairs, pairs[1:]):
        if not (c1 == c0 + 1 and r1 == r0 + 1):
            n += 1
    return n


def meteor_score(candidate: str, references: Sequence[str], *,
                 alpha: float = 0.9, beta: float = 3.0,
                 gamma: float = 0.5) -> float:
    """Sentence METEOR (exact+stem stages): max over references."""
    cand = candidate.lower().split()
    best = 0.0
    for ref in references:
        rt = ref.lower().split()
        if not cand or not rt:
            continue
        pairs = _align(cand, rt)
        m = len(pairs)
        if m == 0:
            continue
        p = m / len(cand)
        r = m / len(rt)
        f = p * r / (alpha * p + (1 - alpha) * r)
        penalty = gamma * (_chunks(pairs) / m) ** beta
        best = max(best, f * (1.0 - penalty))
    return best


def corpus_meteor(candidates: Sequence[str],
                  references: Sequence[Sequence[str]], **kw) -> float:
    """Mean sentence METEOR over the corpus (see module docstring for the
    difference vs the Java jar's micro-average)."""
    if not candidates:
        return 0.0
    return float(sum(meteor_score(c, r, **kw)
                     for c, r in zip(candidates, references))
                 / len(candidates))
