"""CIDEr-D — pure-Python replacement for the ``coco_caption`` package's
COCOEvalCap CIDEr metric (the reference's `xevaluator.py:16-17,1005-1016`).
The port's own copy of `m3p_tpu/eval/cider.py`, the same arithmetic in the
same order, so the scores are equal.

Standard CIDEr-D: TF-IDF-weighted n-gram (n=1..4) cosine similarity between a
candidate and each reference, with length-difference Gaussian penalty and count
clipping; document frequencies computed over the reference corpus.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def cider_score(
    hypotheses: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
    sigma: float = 6.0,
) -> float:
    """Corpus CIDEr-D in [0, ~10] (conventionally reported x100 elsewhere;
    here the raw 0-10 scale as in coco_caption)."""
    assert len(hypotheses) == len(references)
    n_docs = len(references)

    # document frequency over reference sets
    df: List[Dict[tuple, int]] = [defaultdict(int) for _ in range(max_n)]
    for refs in references:
        seen = [set() for _ in range(max_n)]
        for r in refs:
            toks = r.split()
            for n in range(max_n):
                seen[n].update(_ngrams(toks, n + 1).keys())
        for n in range(max_n):
            for g in seen[n]:
                df[n][g] += 1

    log_ndocs = math.log(max(n_docs, 1))

    def tfidf_vec(tokens: List[str]):
        vecs = []
        norms = []
        for n in range(max_n):
            counts = _ngrams(tokens, n + 1)
            vec = {}
            total = 0.0
            for g, c in counts.items():
                idf = log_ndocs - math.log(max(df[n][g], 1))
                w = c * idf
                vec[g] = w
                total += w * w
            vecs.append(vec)
            norms.append(math.sqrt(total))
        return vecs, norms

    scores = []
    for hyp, refs in zip(hypotheses, references):
        h_toks = hyp.split()
        h_vecs, h_norms = tfidf_vec(h_toks)
        sim_total = 0.0
        for r in refs:
            r_toks = r.split()
            r_vecs, r_norms = tfidf_vec(r_toks)
            delta = len(h_toks) - len(r_toks)
            length_pen = math.exp(-(delta ** 2) / (2 * sigma ** 2))
            for n in range(max_n):
                # CIDEr-D: clip candidate counts at reference counts
                num = 0.0
                for g, w in h_vecs[n].items():
                    if g in r_vecs[n]:
                        num += min(w, r_vecs[n][g]) * r_vecs[n][g]
                denom = h_norms[n] * r_norms[n]
                if denom > 0:
                    sim_total += length_pen * num / denom
        scores.append(10.0 * sim_total / (max_n * max(len(refs), 1)))
    return sum(scores) / max(len(scores), 1)
