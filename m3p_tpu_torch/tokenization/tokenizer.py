"""XLM-R tokenizer over a unigram model (counterpart of
`m3p_tpu/tokenization/tokenizer.py`).

fairseq id conventions: <s>=0 <pad>=1 </s>=2 <unk>=3, subword ids are the
model's ids shifted by 1, ``<mask>`` is the last id; ``encode`` returns ids
without specials, which `batch_sentences` adds.

``encode`` and ``encode_batch`` run the native C++ encoder
(`tokenization/native.py`) unless ``use_native=False``; its ids equal the
pure-Python model's.  As in JAX, native ``encode`` cuts at 4096 ids and
``encode_batch`` at ``max_ids``.  The native encoder reads TSV only, so a
SentencePiece ``.spm``/``.model`` protobuf is converted once to a cached
TSV.  Unlike the JAX wrapper, a native encoder that cannot be built raises
instead of falling back to Python.
"""

from __future__ import annotations

import os
import tempfile
import unicodedata
from typing import List, Optional, Sequence, Tuple

import numpy as np

from m3p_tpu_torch.config import BOS_IDX, EOS_IDX, PAD_IDX, UNK_IDX
from m3p_tpu_torch.tokenization.spm_reader import looks_like_spm
from m3p_tpu_torch.tokenization.unigram import SPIECE_UNDERLINE, UnigramModel

FAIRSEQ_TOKENS = {"<s>": BOS_IDX, "<pad>": PAD_IDX, "</s>": EOS_IDX,
                  "<unk>": UNK_IDX}
# the native ``encode`` returns at most this many ids (its buffer)
ENCODE_MAX_IDS = 4096


def nmt_normalize(text: str) -> str:
    """NFKC, with control characters and Unicode spaces mapped to ASCII
    space (SentencePiece's ``nmt_nfkc``, approximately)."""
    text = unicodedata.normalize("NFKC", text)
    return "".join(" " if unicodedata.category(ch) in
                   ("Cc", "Cf", "Zs", "Zl", "Zp") else ch for ch in text)


def _tsv_for_native(model_path: str, py_model: UnigramModel) -> str:
    """The TSV the native encoder reads: the model file itself, or for a
    protobuf model a TSV written once beside it (in the temporary
    directory when that location is read-only) and rewritten when the
    model is newer."""
    if not looks_like_spm(model_path):
        return model_path
    cache = model_path + ".tsv"
    try:
        if (not os.path.exists(cache)
                or os.path.getmtime(cache) < os.path.getmtime(model_path)):
            py_model.save(cache)
        return cache
    except OSError:
        fd, tmp = tempfile.mkstemp(suffix=".tsv", prefix="m3ptok_")
        os.close(fd)
        py_model.save(tmp)
        return tmp


class XLMRTokenizer:
    def __init__(self, model_path: str, use_native: bool = True):
        self._model = UnigramModel.load(model_path)
        self._model_path = model_path
        self._use_native = use_native
        self._native = self._load_native() if use_native else None
        self.fairseq_offset = 1
        self.bos_token_id = self.cls_token_id = BOS_IDX
        self.pad_token_id = PAD_IDX
        self.eos_token_id = self.sep_token_id = EOS_IDX
        self.unk_token_id = UNK_IDX
        self.mask_token_id = len(self._model) + self.fairseq_offset

    def _load_native(self):
        from m3p_tpu_torch.tokenization.native import NativeUnigram

        return NativeUnigram(_tsv_for_native(self._model_path, self._model))

    # a worker that unpickles the tokenizer loads the native encoder anew
    # (a ctypes handle does not cross processes)
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_native"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self._use_native:
            self._native = self._load_native()

    @property
    def vocab_size(self) -> int:
        return len(self._model) + self.fairseq_offset + 1  # + <mask>

    def _shift(self, raw_ids: Sequence[int]) -> List[int]:
        # raw id -1 == unknown character -> <unk>
        return [UNK_IDX if i < 0 else i + self.fairseq_offset
                for i in raw_ids]

    def encode(self, text: str) -> List[int]:
        """Subword ids without specials, at most `ENCODE_MAX_IDS`."""
        text = nmt_normalize(text)
        if self._native is not None:
            return self._shift(self._native.encode(text, ENCODE_MAX_IDS))
        return self._shift(self._model.encode(text))[:ENCODE_MAX_IDS]

    def encode_batch(self, texts: Sequence[str], max_ids: int = 256
                     ) -> List[List[int]]:
        """`encode` for each text, cut to ``max_ids`` ids."""
        texts = [nmt_normalize(t) for t in texts]
        if self._native is not None:
            return [self._shift(ids)
                    for ids in self._native.encode_batch(texts, max_ids)]
        return [self._shift(self._model.encode(t))[:max_ids] for t in texts]

    def _convert_id_to_token(self, idx: int) -> str:
        for tok, i in FAIRSEQ_TOKENS.items():
            if idx == i:
                return tok
        if idx == self.mask_token_id:
            return "<mask>"
        return self._model.id_to_piece(idx - self.fairseq_offset)

    def decode(self, token_ids: Sequence[int]) -> str:
        out = "".join(self._convert_id_to_token(int(i)) for i in token_ids
                      if int(i) not in (BOS_IDX, EOS_IDX, PAD_IDX))
        return out.replace(SPIECE_UNDERLINE, " ").strip()


def batch_sentences(
    sentences: Sequence[Sequence[int]],
    max_len: Optional[int] = None,
    lang_ids: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Id lists -> (tokens (B, L), lengths (B,), langs (B, L) | None):
    ``<s> w1 ... wn </s>`` padded with <pad>; the length counts both
    specials; sentences longer than max_len - 2 are cut."""
    b = len(sentences)
    if max_len is None:
        max_len = max((len(s) for s in sentences), default=0) + 2
    toks = np.full((b, max_len), PAD_IDX, np.int32)
    lengths = np.zeros((b,), np.int32)
    langs = None if lang_ids is None else np.zeros((b, max_len), np.int32)
    for i, s in enumerate(sentences):
        s = list(s)[: max_len - 2]
        toks[i, 0] = BOS_IDX
        toks[i, 1:1 + len(s)] = s
        toks[i, 1 + len(s)] = EOS_IDX
        lengths[i] = len(s) + 2
        if langs is not None:
            langs[i, :] = lang_ids[i]
    return toks, lengths, langs
