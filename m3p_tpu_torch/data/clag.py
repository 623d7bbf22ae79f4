"""Multimodal Code-switched Training (MCT) augmentation, the "Clager" (a
copy of `m3p_tpu/data/clag.py`, drawing in its order from one
``np.random.RandomState``, so the same seed gives the same strings):
  * ``clag``  — with prob ``sent_ratio`` per sentence, replace each in-lexicon
    word with prob ``word_ratio`` by a random translation in a random language
  * ``clag_word`` — switch one word (positive: its own translations; negative:
    translations of a random lexicon word)
  * ``dclag`` — pick one in-lexicon word; positives substitute its
    translations, negatives substitute translations of random lexicon words

The lexicon maps  lang -> word -> {target_lang: [translations]}  built from
MUSE-style bilingual dictionaries (``<l1>-<l2>.txt``, one ``src tgt`` pair
a line; `load_bilingual_dict` adds both directions).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

Lexicon = Dict[str, Dict[str, Dict[str, List[str]]]]


def load_bilingual_dict(path: str, src_lang: str, tgt_lang: str,
                        lexicon: Optional[Lexicon] = None) -> Lexicon:
    """Merge a MUSE-format dictionary (``src_word tgt_word`` per line) into a
    lexicon (both directions are added, `loader.py:672-684`)."""
    lexicon = lexicon if lexicon is not None else {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            a, b = parts
            lexicon.setdefault(src_lang, {}).setdefault(a, {}) \
                .setdefault(tgt_lang, []).append(b)
            lexicon.setdefault(tgt_lang, {}).setdefault(b, {}) \
                .setdefault(src_lang, []).append(a)
    return lexicon


class Clager:
    def __init__(self, lexicon: Optional[Lexicon], sent_ratio: float,
                 word_ratio: float):
        self.lexicon = lexicon
        self.sent_ratio = sent_ratio
        self.word_ratio = word_ratio

    def _random_translation(self, rng: np.random.RandomState, lang: str,
                            word: str) -> str:
        entry = self.lexicon[lang][word]
        langs = list(entry.keys())
        tgt_lang = langs[rng.randint(len(langs))]
        translations = entry[tgt_lang]
        return translations[rng.randint(len(translations))]

    def clag(self, rng: np.random.RandomState, sent: str, cur_lang: str) -> str:
        if self.lexicon is None or cur_lang not in self.lexicon:
            return sent
        if rng.random_sample() >= self.sent_ratio:
            return sent
        lex = self.lexicon[cur_lang]
        words = []
        for word in sent.split(" "):
            if word not in lex or rng.random_sample() >= self.word_ratio:
                words.append(word)
            else:
                words.append(self._random_translation(rng, cur_lang, word))
        return " ".join(words)

    def clag_word(self, rng: np.random.RandomState, word: str, cur_lang: str,
                  is_pos: bool = True) -> str:
        if self.lexicon is None or cur_lang not in self.lexicon:
            return word
        lex = self.lexicon[cur_lang]
        if is_pos:
            if word not in lex:
                return word
        else:
            word_list = list(lex.keys())
            word = word_list[rng.randint(len(word_list))]
        return self._random_translation(rng, cur_lang, word)

    def dclag(self, rng: np.random.RandomState, sent: str, cur_lang: str,
              num_pos: int, num_neg: int) -> List[str]:
        """num_pos positive code-switched variants + num_neg negatives
        (random-word substitution at the same position)."""
        total = num_pos + num_neg
        if self.lexicon is None or cur_lang not in self.lexicon:
            return [sent] * total
        if rng.random_sample() >= self.sent_ratio:
            return [sent] * total
        lex = self.lexicon[cur_lang]
        indexed = list(enumerate(sent.split(" ")))
        order = rng.permutation(len(indexed))
        idx = None
        for oi in order:
            if indexed[oi][1] in lex:
                idx, word = indexed[oi]
                break
        if idx is None:
            return [sent] * total
        entry = lex[word]
        langs = list(entry.keys())
        lang = langs[rng.randint(len(langs))]
        translations = entry[lang]
        words = sent.split(" ")
        pos_variants = []
        for tgt in translations:
            v = list(words)
            v[idx] = tgt
            pos_variants.append(v)
        neg_variants = []
        for _ in range(num_neg):
            v = list(words)
            v[idx] = self.clag_word(rng, word, cur_lang, is_pos=False)
            neg_variants.append(v)
        pos_idx = rng.choice(len(pos_variants), size=num_pos, replace=True)
        chosen = [pos_variants[i] for i in pos_idx] + neg_variants
        return [" ".join(v) for v in chosen]
