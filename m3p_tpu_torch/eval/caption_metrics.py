"""ROUGE-L and METEOR caption metrics (host-side, pure Python).

Completes the `--coco_method` surface: the reference reports every
`COCOEvalCap` metric the flag selects (Bleu / METEOR / ROUGE_L / CIDEr,
the reference's `xevaluator.py:1005-1016`).  BLEU and CIDEr live in
`bleu.py` / `cider.py`; this module adds the other two.  The port's own
copy of `m3p_tpu/eval/caption_metrics.py`, the same arithmetic in the same
order, so the scores are equal:

* **ROUGE-L** — pycocoevalcap semantics: per hypothesis, LCS-based
  precision/recall against each reference, F-beta with beta=1.2, max over
  references, mean over the corpus.
* **METEOR** — the exact + stem matching variant (documented deviation: the
  reference shells out to the Java METEOR-1.5 jar, whose synonym/paraphrase
  stages need WordNet + paraphrase tables that are unavailable offline; the
  exact/stem stages dominate its score on caption-length text).  Standard
  parameters alpha=0.9, beta=3, gamma=0.5; matches are maximised over
  references.
"""

from __future__ import annotations

from typing import List, Sequence

# ---------------------------------------------------------------------------
# ROUGE-L
# ---------------------------------------------------------------------------


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Classic O(len(a)*len(b)) LCS table, one rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l_score(hyps: List[str], refs_per_hyp: List[List[str]],
                  beta: float = 1.2) -> float:
    """Corpus ROUGE-L: mean over hypotheses of the LCS F-measure built from
    the max precision and max recall taken SEPARATELY over references —
    pycocoevalcap `rouge.py::calc_score` semantics (prec_max/rec_max may come
    from different references; golden-pinned in tests/test_eval.py)."""
    assert len(hyps) == len(refs_per_hyp)
    if not hyps:
        return 0.0
    total = 0.0
    for hyp, refs in zip(hyps, refs_per_hyp):
        h = hyp.split()
        prec_max = 0.0
        rec_max = 0.0
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(h, r)
            if lcs == 0 or not h or not r:
                continue
            prec_max = max(prec_max, lcs / len(h))
            rec_max = max(rec_max, lcs / len(r))
        if prec_max > 0 and rec_max > 0:
            total += ((1 + beta ** 2) * prec_max * rec_max) / (
                rec_max + beta ** 2 * prec_max)
    return 100.0 * total / len(hyps)


# ---------------------------------------------------------------------------
# METEOR (exact + stem)
# ---------------------------------------------------------------------------

_VOWELS = set("aeiou")


def _cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: the number of VC sequences in the stem."""
    forms = "".join("c" if _cons(stem, i) else "v" for i in range(len(stem)))
    return forms.count("vc")


def _ends_cvc(stem: str) -> bool:
    if len(stem) < 3:
        return False
    return (_cons(stem, len(stem) - 3)
            and not _cons(stem, len(stem) - 2)
            and _cons(stem, len(stem) - 1)
            and stem[-1] not in "wxy")


def porter_stem(word: str) -> str:
    """Compact Porter stemmer (steps 1a-5b) — enough for METEOR's stem
    module, which only needs hypothesis/reference stems to AGREE, not a
    canonical dictionary form."""
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
        for suf in ("ed", "ing"):
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if any(not _cons(stem, i) for i in range(len(stem))):
                    w, flag = stem, True
                break
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif (len(w) > 1 and w[-1] == w[-2] and _cons(w, len(w) - 1)
                  and w[-1] not in "lsz"):
                w = w[:-1]
            elif _measure(w) == 1 and _ends_cvc(w):
                w += "e"

    # step 1c
    if w.endswith("y") and any(not _cons(w[:-1], i)
                               for i in range(len(w) - 1)):
        w = w[:-1] + "i"

    # steps 2-4: the common suffix map (m-condition checked per rule)
    for cond_m, pairs in (
        (0, ()),
        (0, (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
             ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
             ("alli", "al"), ("entli", "ent"), ("eli", "e"),
             ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
             ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
             ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
             ("iviti", "ive"), ("biliti", "ble"))),
        (0, (("icate", "ic"), ("ative", ""), ("alize", "al"),
             ("iciti", "ic"), ("ical", "ic"), ("ful", ""), ("ness", ""))),
        (1, (("al", ""), ("ance", ""), ("ence", ""), ("er", ""),
             ("ic", ""), ("able", ""), ("ible", ""), ("ant", ""),
             ("ement", ""), ("ment", ""), ("ent", ""), ("ou", ""),
             ("ism", ""), ("ate", ""), ("iti", ""), ("ous", ""),
             ("ive", ""), ("ize", ""))),
    ):
        for suf, rep in pairs:
            if w.endswith(suf):
                stem = w[: -len(suf)] + rep if suf else w
                if _measure(w[: -len(suf)]) > cond_m:
                    w = w[: -len(suf)] + rep
                break

    # step 5a/5b
    if w.endswith("e"):
        m = _measure(w[:-1])
        if m > 1 or (m == 1 and not _ends_cvc(w[:-1])):
            w = w[:-1]
    if w.endswith("ll") and _measure(w) > 1:
        w = w[:-1]
    return w


def _meteor_single(hyp: List[str], ref: List[str],
                   alpha: float, beta: float, gamma: float) -> float:
    """Alignment score for one (hyp, ref) pair: greedy exact matching first,
    then stem matching on the leftovers; chunk count over the final
    alignment (METEOR fragmentation penalty)."""
    if not hyp or not ref:
        return 0.0
    align = [-1] * len(hyp)          # hyp index -> ref index
    used = [False] * len(ref)
    for stage in (lambda t: t, porter_stem):
        keyed = {}
        for j, r in enumerate(ref):
            if not used[j]:
                keyed.setdefault(stage(r), []).append(j)
        for i, h in enumerate(hyp):
            if align[i] >= 0:
                continue
            cands = keyed.get(stage(h))
            while cands:
                j = cands.pop(0)
                if not used[j]:
                    align[i], used[j] = j, True
                    break
    matches = sum(1 for a in align if a >= 0)
    if matches == 0:
        return 0.0
    prec = matches / len(hyp)
    rec = matches / len(ref)
    fmean = prec * rec / (alpha * prec + (1 - alpha) * rec)
    # chunks: maximal runs of matched hyp words whose ref indices are
    # consecutive and increasing
    chunks = 0
    prev_ref = None
    for a in align:
        if a < 0:
            prev_ref = None
            continue
        if prev_ref is None or a != prev_ref + 1:
            chunks += 1
        prev_ref = a
    penalty = gamma * (chunks / matches) ** beta
    return fmean * (1.0 - penalty)


def meteor_score(hyps: List[str], refs_per_hyp: List[List[str]],
                 alpha: float = 0.9, beta: float = 3.0,
                 gamma: float = 0.5) -> float:
    """Corpus METEOR (exact+stem): mean over hypotheses of the best
    per-reference alignment score."""
    assert len(hyps) == len(refs_per_hyp)
    if not hyps:
        return 0.0
    total = 0.0
    for hyp, refs in zip(hyps, refs_per_hyp):
        h = hyp.lower().split()
        total += max((_meteor_single(h, ref.lower().split(),
                                     alpha, beta, gamma) for ref in refs),
                     default=0.0)
    return 100.0 * total / len(hyps)
