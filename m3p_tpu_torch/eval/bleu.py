"""Corpus BLEU — pure-Python replacement for Moses ``multi-bleu.perl``
(the reference's `src/evaluation/multi-bleu.perl`, invoked via subprocess at
`xevaluator.py:1747-1761`).  The port's own copy of `m3p_tpu/eval/bleu.py`,
the same arithmetic in the same order, so the scores are equal.

Matches Moses semantics: space-tokenized hypotheses/references, up to 4-gram
clipped precision, geometric mean, brevity penalty exp(1 - ref_len/hyp_len),
multiple references supported (closest-length reference for BP, max clip count
per n-gram).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    hypotheses: Sequence[str],
    references: Sequence[Sequence[str]],
    max_n: int = 4,
) -> float:
    """BLEU in [0, 100].  ``references[i]`` is the list of refs for hyp i."""
    assert len(hypotheses) == len(references)
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0
    for hyp, refs in zip(hypotheses, references):
        h = hyp.split()
        rs = [r.split() for r in refs]
        hyp_len += len(h)
        # closest reference length (ties -> shorter), Moses convention
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        for n in range(1, max_n + 1):
            h_ngrams = _ngrams(h, n)
            max_ref: Counter = Counter()
            for r in rs:
                for g, c in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], c)
            totals[n - 1] += max(len(h) - n + 1, 0)
            clipped[n - 1] += sum(min(c, max_ref[g])
                                  for g, c in h_ngrams.items())
    if min(totals) == 0 or min(clipped) == 0:
        return 0.0
    log_prec = sum(math.log(c / t) for c, t in zip(clipped, totals)) / max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(hyp_len, 1))
    return 100.0 * bp * math.exp(log_prec)
