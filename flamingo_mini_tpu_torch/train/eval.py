"""Captioning evaluation harness, the port's copy of
``flamingo_mini_tpu/train/eval.py``.

Mirrors the reference's training/eval.py:12-62: batched caption generation
over an (image, references) dataset, then COCO metrics (BLEU/METEOR/ROUGE-L/
CIDEr/SPICE) via pycocoevalcap when installed. Zero-egress fallback:
self-contained corpus BLEU, ROUGE-L, and a CIDEr-style consensus score so
training runs can still regression-track quality without Java/pycocoevalcap
(METEOR/SPICE need external resources and are pycocoevalcap-only).
"""
from __future__ import annotations

import logging
import math
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

logger = logging.getLogger("flamingo_mini_tpu_torch.eval")


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(candidates: List[str], references: List[List[str]],
                max_n: int = 4) -> Dict[str, float]:
    """Standard corpus BLEU-1..4 with brevity penalty (no smoothing),
    matching pycocoevalcap's Bleu layout."""
    weights_len = max_n
    p_nums = [0] * max_n
    p_dens = [0] * max_n
    cand_len, ref_len = 0, 0
    for cand, refs in zip(candidates, references):
        c = cand.lower().split()
        rs = [r.lower().split() for r in refs]
        cand_len += len(c)
        ref_len += min((abs(len(r) - len(c)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(c, n)
            maxref: Counter = Counter()
            for r in rs:
                rn = _ngrams(r, n)
                for g, k in rn.items():
                    maxref[g] = max(maxref[g], k)
            p_nums[n - 1] += sum(min(k, maxref[g]) for g, k in cn.items())
            p_dens[n - 1] += max(sum(cn.values()), 0)
    bp = 1.0 if cand_len > ref_len else math.exp(1 - ref_len / max(cand_len, 1))
    out = {}
    log_sum = 0.0
    for n in range(1, max_n + 1):
        p = p_nums[n - 1] / p_dens[n - 1] if p_dens[n - 1] else 0.0
        log_sum += math.log(p) if p > 0 else -9999.0
        out[f"Bleu_{n}"] = bp * math.exp(log_sum / n)
    return out


def rouge_l(candidates: List[str], references: List[List[str]],
            beta: float = 1.2) -> float:
    """ROUGE-L exactly as pycocoevalcap's Rouge scorer: per pair, LCS-based
    precision/recall combined with beta=1.2; max over a candidate's
    references; corpus mean (reference training/eval.py:58-62 emits ROUGE_L)."""

    def lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
        prev = [0] * (len(b) + 1)
        for x in a:
            cur = [0]
            for j, y in enumerate(b):
                cur.append(prev[j] + 1 if x == y else max(cur[-1], prev[j + 1]))
            prev = cur
        return prev[-1]

    scores = []
    for cand, refs in zip(candidates, references):
        c = cand.lower().split()
        best = 0.0
        for r in refs:
            rt = r.lower().split()
            lcs = lcs_len(c, rt)
            if lcs == 0 or not c or not rt:
                continue
            prec, rec = lcs / len(c), lcs / len(rt)
            best = max(best, ((1 + beta ** 2) * prec * rec)
                       / (rec + beta ** 2 * prec))
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


def cider_d(candidates: List[str], references: List[List[str]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """CIDEr-D: tf-idf weighted n-gram consensus (self-contained)."""
    doc_freq: Counter = Counter()
    for refs in references:
        seen = set()
        for r in refs:
            for n in range(1, max_n + 1):
                seen |= set(_ngrams(r.lower().split(), n))
        doc_freq.update(seen)
    n_docs = max(len(references), 1)

    def vec(tokens, n):
        cn = _ngrams(tokens, n)
        total = max(sum(cn.values()), 1)
        return {g: (k / total) * math.log(max(n_docs / max(doc_freq[g], 1), 1.0))
                for g, k in cn.items()}

    scores = []
    for cand, refs in zip(candidates, references):
        c = cand.lower().split()
        s = 0.0
        for n in range(1, max_n + 1):
            vc = vec(c, n)
            norm_c = math.sqrt(sum(v * v for v in vc.values()))
            best = 0.0
            for r in refs:
                rt = r.lower().split()
                vr = vec(rt, n)
                norm_r = math.sqrt(sum(v * v for v in vr.values()))
                num = sum(min(vc.get(g, 0), vr.get(g, 0)) * vr.get(g, 0)
                          for g in vc)
                sim = num / (norm_c * norm_r) if norm_c * norm_r > 0 else 0.0
                delta = len(c) - len(rt)
                sim *= math.exp(-delta * delta / (2 * sigma ** 2))
                best += sim
            s += best / max(len(refs), 1)
        scores.append(10.0 * s / max_n)
    return float(np.mean(scores)) if scores else 0.0


def evaluate_image_captioning(
    dataset,                      # indexable of (image, List[str] references)
    model,                        # FlamingoModel
    processor,
    *,
    prefix: str = "<image>A picture of",
    start: int = 0,
    end: int = 1000,
    batch_size: int = 64,
    max_length: int = 150,
    num_beams: int = 1,
    **generate_kw,
) -> Dict[str, float]:
    """Generate captions over dataset[start:end] and score them;
    ``generate_kw`` go to ``generate`` (a trainer's ``mesh``).

    Uses pycocoevalcap when importable (reference training/eval.py:58-62);
    otherwise the self-contained BLEU + CIDEr-D above.
    """
    end = min(end, len(dataset))
    candidates: List[str] = []
    references: List[List[str]] = []
    for lo in range(start, end, batch_size):
        hi = min(lo + batch_size, end)
        items = [dataset[i] for i in range(lo, hi)]
        images = [im for im, _ in items]
        references.extend([list(refs) for _, refs in items])
        candidates.extend(model.generate_captions(
            processor, images=images, prompt=prefix,
            max_length=max_length, num_beams=num_beams, **generate_kw))

    try:
        return _pycoco_metrics(candidates, references)
    except ImportError:
        logger.info("pycocoevalcap unavailable; using built-in "
                    "BLEU/ROUGE-L/CIDEr-D and an exact+stem METEOR "
                    "approximation (train/meteor.py; SPICE needs "
                    "pycocoevalcap+Java and has no pure-python fallback)")
        from .meteor import corpus_meteor
        metrics = corpus_bleu(candidates, references)
        metrics["ROUGE_L"] = rouge_l(candidates, references)
        metrics["CIDEr"] = cider_d(candidates, references)
        metrics["METEOR"] = corpus_meteor(candidates, references)
        return metrics


def _pycoco_metrics(candidates: List[str],
                    references: List[List[str]]) -> Dict[str, float]:
    from pycocoevalcap.bleu.bleu import Bleu
    from pycocoevalcap.cider.cider import Cider
    from pycocoevalcap.meteor.meteor import Meteor
    from pycocoevalcap.rouge.rouge import Rouge
    gts = {i: [{"caption": r} for r in refs] for i, refs in enumerate(references)}
    res = {i: [{"caption": c}] for i, c in enumerate(candidates)}
    from pycocoevalcap.tokenizer.ptbtokenizer import PTBTokenizer
    tok = PTBTokenizer()
    gts, res = tok.tokenize(gts), tok.tokenize(res)
    out: Dict[str, float] = {}
    bleu, _ = Bleu(4).compute_score(gts, res)
    for i, b in enumerate(bleu):
        out[f"Bleu_{i+1}"] = float(b)
    for scorer, name in ((Meteor(), "METEOR"), (Rouge(), "ROUGE_L"),
                         (Cider(), "CIDEr")):
        s, _ = scorer.compute_score(gts, res)
        out[name] = float(s)
    return out
