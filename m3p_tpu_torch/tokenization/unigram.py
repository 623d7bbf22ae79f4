"""Unigram-LM subword model: load, save, encode, decode, and the trainer (a
copy of `m3p_tpu/tokenization/unigram.py`).  The Python Viterbi is the
ground truth the native encoder (`csrc/tokenizer.cpp`) matches id for id,
and `train_unigram` the one the native trainer (`csrc/trainer.cpp`)
matches piece for piece.

Model file: UTF-8 TSV lines ``<piece>\\t<log_prob>[\\t<type>]``, line number
== piece id, or a SentencePiece ``.spm``/``.model`` protobuf.  Pieces of a
non-matchable type (UNKNOWN/CONTROL/UNUSED) keep their id but never take part
in segmentation.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Iterable, List, Optional, Tuple

from m3p_tpu_torch.tokenization.spm_reader import (
    MATCHABLE_TYPES, TYPE_NORMAL, load_spm, looks_like_spm)

SPIECE_UNDERLINE = "▁"

_UNK_PENALTY = 10.0


class UnigramModel:
    def __init__(self, pieces: List[str], scores: List[float],
                 types: Optional[List[int]] = None):
        if types is None:
            types = [TYPE_NORMAL] * len(pieces)
        if not len(pieces) == len(scores) == len(types):
            raise ValueError("pieces, scores and types differ in length")
        self.pieces = pieces
        self.scores = scores
        self.types = types
        self.piece_to_id: Dict[str, int] = {
            p: i for i, p in enumerate(pieces)
            if self.types[i] in MATCHABLE_TYPES}
        matchable_scores = [s for s, t in zip(scores, self.types)
                            if t in MATCHABLE_TYPES]
        self.min_score = min(matchable_scores) if matchable_scores else 0.0
        self.max_piece_len = max(
            (len(p) for p, t in zip(pieces, self.types)
             if t in MATCHABLE_TYPES), default=1)

    @classmethod
    def load(cls, path: str) -> "UnigramModel":
        if looks_like_spm(path):
            return cls.from_spm(path)
        pieces, scores, types = [], [], []
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                cols = line.split("\t")
                pieces.append(cols[0])
                scores.append(float(cols[1]))
                types.append(int(cols[2]) if len(cols) > 2 else TYPE_NORMAL)
        return cls(pieces, scores, types)

    @classmethod
    def from_spm(cls, path: str) -> "UnigramModel":
        """Load a SentencePiece .spm/.model protobuf."""
        return cls(*load_spm(path))

    def save(self, path: str) -> None:
        """Write the TSV model; the type column only when a piece is not
        NORMAL."""
        plain = all(t == TYPE_NORMAL for t in self.types)
        with open(path, "w", encoding="utf-8") as f:
            for p, s, t in zip(self.pieces, self.scores, self.types):
                if plain:
                    f.write(f"{p}\t{s}\n")
                else:
                    f.write(f"{p}\t{s}\t{t}\n")

    def __len__(self) -> int:
        return len(self.pieces)

    def _viterbi(self, text: str) -> List[int]:
        """Best segmentation of a ▁-prefixed word; -1 marks an unknown
        character (mapped to <unk> by the tokenizer)."""
        n = len(text)
        if n == 0:
            return []
        best = [-1e30] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)
        best[0] = 0.0
        unk_penalty = self.min_score - _UNK_PENALTY
        for i in range(n):
            if best[i] <= -1e29:
                continue
            upper = min(n, i + self.max_piece_len)
            for j in range(i + 1, upper + 1):
                pid = self.piece_to_id.get(text[i:j])
                if pid is not None:
                    s = best[i] + self.scores[pid]
                    if s > best[j]:
                        best[j] = s
                        back[j] = (i, pid)
            s = best[i] + unk_penalty
            if s > best[i + 1]:
                best[i + 1] = s
                back[i + 1] = (i, -1)
        out: List[int] = []
        pos = n
        while pos > 0:
            prev, pid = back[pos]
            out.append(pid)
            pos = prev
        out.reverse()
        return out

    def encode(self, text: str) -> List[int]:
        """Whitespace pretokenize, ▁-prefix each word, Viterbi segment."""
        ids: List[int] = []
        for word in text.split():
            ids.extend(self._viterbi(SPIECE_UNDERLINE + word))
        return ids

    def id_to_piece(self, idx: int) -> str:
        return self.pieces[idx]

    def decode(self, ids: Iterable[int]) -> str:
        s = "".join(self.pieces[i] if 0 <= i < len(self.pieces) else "⁇"
                    for i in ids)
        return s.replace(SPIECE_UNDERLINE, " ").strip()


def train_unigram(
    corpus: Iterable[str],
    vocab_size: int = 8000,
    max_piece_len: int = 12,
    seed_factor: int = 4,
    n_em_iters: int = 2,
) -> UnigramModel:
    """Train a unigram model: substring seeding + EM pruning.

    1. Count ▁-prefixed word frequencies.
    2. Seed vocabulary: all single characters (never pruned, guarantees
       coverage) + the ``seed_factor * vocab_size`` highest-count substrings.
    3. EM: the E-step segments the corpus with the current model (Viterbi
       approximation), the M-step re-estimates piece probabilities; the
       lowest-utility pieces are pruned until ``vocab_size`` remain.
    """
    word_counts: collections.Counter = collections.Counter()
    for line in corpus:
        for w in line.split():
            word_counts[SPIECE_UNDERLINE + w] += 1

    # seed: substring counts
    sub_counts: collections.Counter = collections.Counter()
    chars: collections.Counter = collections.Counter()
    for word, c in word_counts.items():
        n = len(word)
        for i in range(n):
            chars[word[i]] += c
            for j in range(i + 2, min(n, i + max_piece_len) + 1):
                sub_counts[word[i:j]] += c

    required = list(chars.keys())
    n_seed = max(vocab_size * seed_factor - len(required), 0)
    # explicit (-count, piece) tie-break, which the native trainer
    # reproduces exactly
    ranked = sorted(sub_counts.items(), key=lambda kv: (-kv[1], kv[0]))
    seeds = [p for p, _ in ranked[:n_seed]]
    pieces = required + [p for p in seeds if p not in chars]
    counts = {p: (chars[p] if p in chars else sub_counts[p]) for p in pieces}
    total = sum(counts.values())
    scores = {p: math.log(c / total) for p, c in counts.items()}

    def make_model(score_map: Dict[str, float]) -> UnigramModel:
        ps = list(score_map.keys())
        return UnigramModel(ps, [score_map[p] for p in ps])

    model = make_model(scores)
    for _ in range(n_em_iters):
        # E-step: Viterbi counts
        new_counts: collections.Counter = collections.Counter()
        for word, c in word_counts.items():
            for pid in model._viterbi(word):
                if pid >= 0:
                    new_counts[model.pieces[pid]] += c
        # M-step + prune: keep required chars and the most-used pieces
        total = sum(new_counts.values()) or 1
        kept = set(required)
        budget = vocab_size - len(required)
        for p, _ in sorted(new_counts.items(), key=lambda kv: (-kv[1], kv[0])):
            if budget <= 0:
                break
            if p not in kept:
                kept.add(p)
                budget -= 1
        scores = {}
        for p in kept:
            c = new_counts.get(p, 0)
            scores[p] = math.log((c + 0.1) / (total + 0.1 * len(kept)))
        model = make_model(scores)

    # deterministic piece order: required chars first, then by (-score, piece)
    score_of = {p: model.scores[model.piece_to_id[p]] for p in model.pieces}
    ordered = sorted(model.pieces,
                     key=lambda p: (len(p) > 1, -score_of[p], p))
    return UnigramModel(ordered, [score_of[p] for p in ordered])
