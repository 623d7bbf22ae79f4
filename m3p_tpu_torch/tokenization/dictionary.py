"""Legacy word-level dictionary (a copy of
`m3p_tpu/tokenization/dictionary.py`, the XLM `Dictionary` of the legacy
binarizer path).

Fixed specials <s>=0 <pad>=1 </s>=2 <unk>=3 followed by the vocabulary's
words in file order; vocab files are ``word count`` lines; `index_data`
produces a flat token stream with sentence positions, saved as .npz.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from m3p_tpu_torch.config import BOS_IDX, EOS_IDX, PAD_IDX, UNK_IDX

logger = logging.getLogger("m3p_tpu_torch")

SPECIAL_WORDS = {"<s>": BOS_IDX, "<pad>": PAD_IDX, "</s>": EOS_IDX,
                 "<unk>": UNK_IDX}


class Dictionary:
    def __init__(self, id2word: Dict[int, str], word2id: Dict[str, int],
                 counts: Optional[Dict[str, int]] = None):
        if len(id2word) != len(word2id):
            raise ValueError("id2word and word2id differ in size")
        self.id2word = id2word
        self.word2id = word2id
        self.counts = counts or {}
        self.check_valid()

    def __len__(self) -> int:
        return len(self.id2word)

    def index(self, word: str) -> int:
        return self.word2id.get(word, UNK_IDX)

    def check_valid(self) -> None:
        for w, i in SPECIAL_WORDS.items():
            if self.id2word.get(i) != w:
                raise ValueError(f"special {w} misplaced")
        if len(self.id2word) != len(set(self.id2word.values())):
            raise ValueError("a word has two ids")

    @classmethod
    def read_vocab(cls, vocab_path: str,
                   max_vocab: int = -1, min_count: int = 0) -> "Dictionary":
        word2id = dict(SPECIAL_WORDS)
        counts: Dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                parts = line.rstrip("\n").split(" ")
                word = parts[0]
                count = int(parts[1]) if len(parts) > 1 else 1
                if word in word2id:
                    logger.warning("duplicate word %r at line %d", word, i)
                    continue
                if min_count and count < min_count:
                    continue
                if (max_vocab > 0
                        and len(word2id) >= max_vocab + len(SPECIAL_WORDS)):
                    break
                word2id[word] = len(word2id)
                counts[word] = count
        id2word = {v: k for k, v in word2id.items()}
        logger.info("read %d words from %s", len(word2id), vocab_path)
        return cls(id2word, word2id, counts)

    def index_data(self, txt_path: str, out_path: Optional[str] = None):
        """Binarize a text file: a flat int32 stream with EOS terminators
        and the sentences' start positions.  Returns dict(sentences,
        positions, unk_words); saved as .npz when ``out_path`` is given."""
        positions: List[int] = []
        stream: List[int] = []
        unk_counts: Dict[str, int] = {}
        with open(txt_path, encoding="utf-8") as f:
            for line in f:
                words = line.rstrip("\n").split()
                positions.append(len(stream))
                for w in words:
                    idx = self.index(w)
                    stream.append(idx)
                    if idx == UNK_IDX:
                        unk_counts[w] = unk_counts.get(w, 0) + 1
                stream.append(EOS_IDX)
        data = {
            "sentences": np.asarray(stream, np.int32),
            "positions": np.asarray(positions, np.int64),
        }
        if out_path:
            np.savez(out_path, **data)
        logger.info("indexed %d sentences (%d tokens, %d unk types)",
                    len(positions), len(stream), len(unk_counts))
        data["unk_words"] = unk_counts
        return data
