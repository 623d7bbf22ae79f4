"""ctypes binding of the port's native C++ unigram encoder and trainer
(`m3p_tpu_torch/csrc/tokenizer.cpp`, `csrc/trainer.cpp`; counterpart of
`m3p_tpu/tokenization/native.py`).

The library is built from the checkout's own sources with the host
compiler at first use (`ops/_build.py::build_host`, into ``build/``).
Unlike the JAX module, a failed build does not fall back to the
pure-Python model: it raises RuntimeError with the compiler's stderr.  The
ids are the same whichever encoder runs; only the failure mode differs.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Sequence

import numpy as np

from m3p_tpu_torch.ops import _build

SOURCES = ("tokenizer.cpp", "trainer.cpp")
# encode_batch starts a native thread for each this many texts
TEXTS_PER_THREAD = 64

_c_ids = ctypes.POINTER(ctypes.c_int32)


def load_library() -> ctypes.CDLL:
    """The native library with its C ABI declared, built at first use;
    raises RuntimeError if it does not build."""
    lib = _build.load_host("m3ptok", SOURCES)
    if lib.m3ptok_load.argtypes is None:
        lib.m3ptok_load.argtypes = [ctypes.c_char_p]
        lib.m3ptok_load.restype = ctypes.c_int32
        lib.m3ptok_vocab_size.argtypes = [ctypes.c_int32]
        lib.m3ptok_vocab_size.restype = ctypes.c_int32
        lib.m3ptok_encode.argtypes = [
            ctypes.c_int32, ctypes.c_char_p, _c_ids, ctypes.c_int32]
        lib.m3ptok_encode.restype = ctypes.c_int32
        lib.m3ptok_encode_batch.argtypes = [
            ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            _c_ids, _c_ids, ctypes.c_int32, ctypes.c_int32]
        lib.m3ptok_encode_batch.restype = None
        lib.m3ptok_id_to_piece.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32]
        lib.m3ptok_id_to_piece.restype = ctypes.c_int32
        lib.m3ptok_piece_to_id.argtypes = [ctypes.c_int32, ctypes.c_char_p]
        lib.m3ptok_piece_to_id.restype = ctypes.c_int32
        lib.m3ptok_train.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.m3ptok_train.restype = ctypes.c_int64
    return lib


class NativeUnigram:
    """Native encoder over a TSV unigram model file.  ``encode_batch``
    runs in native threads with the GIL released (ctypes releases it
    around every foreign call)."""

    def __init__(self, model_path: str):
        self._lib = load_library()
        self._model_path = model_path
        self._handle = self._lib.m3ptok_load(model_path.encode())
        if self._handle < 0:
            raise FileNotFoundError(model_path)

    # a CDLL handle cannot cross a process boundary: ship the model path
    # and load it again on the other side
    def __getstate__(self):
        return {"_model_path": self._model_path}

    def __setstate__(self, state):
        self.__init__(state["_model_path"])

    def __len__(self) -> int:
        return int(self._lib.m3ptok_vocab_size(self._handle))

    def encode(self, text: str, max_ids: int = 4096) -> List[int]:
        """Raw model ids (-1 for an unknown character), cut at
        ``max_ids``."""
        buf = (ctypes.c_int32 * max_ids)()
        n = self._lib.m3ptok_encode(self._handle, text.encode(), buf, max_ids)
        return list(buf[:n])

    def encode_batch(self, texts: Sequence[str], max_ids: int = 256,
                     n_threads: int = 0) -> List[List[int]]:
        """`encode` of each text, cut at ``max_ids``, over ``n_threads``
        native threads (0: one per `TEXTS_PER_THREAD` texts, at most the
        cores and 16).  One thread encodes on the calling thread: a data
        loader's record of a few captions would otherwise pay a thread's
        start for each (the ids are the same either way)."""
        n = len(texts)
        if n == 0:
            return []
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, 16,
                            -(-n // TEXTS_PER_THREAD))
        if n_threads == 1:
            return [self.encode(t, max_ids) for t in texts]
        encoded = [t.encode() for t in texts]
        arr = (ctypes.c_char_p * n)(*encoded)
        out_ids = np.zeros((n, max_ids), np.int32)
        out_lens = np.zeros((n,), np.int32)
        self._lib.m3ptok_encode_batch(
            self._handle, arr, n, out_ids.ctypes.data_as(_c_ids),
            out_lens.ctypes.data_as(_c_ids), max_ids, n_threads)
        return [out_ids[i, :out_lens[i]].tolist() for i in range(n)]

    def id_to_piece(self, idx: int) -> str:
        buf = ctypes.create_string_buffer(64)
        n = self._lib.m3ptok_id_to_piece(self._handle, idx, buf, 64)
        return buf.raw[:n].decode("utf-8", errors="replace")

    def piece_to_id(self, piece: str) -> int:
        return int(self._lib.m3ptok_piece_to_id(self._handle, piece.encode()))


def native_train_unigram(
    corpus_paths: Sequence[str],
    out_path: str,
    vocab_size: int = 8000,
    max_piece_len: int = 12,
    seed_factor: int = 4,
    n_em_iters: int = 2,
) -> int:
    """Train a unigram vocabulary in the native trainer, model for model
    the Python `unigram.train_unigram`; writes the TSV model to
    ``out_path`` and returns the trained vocab size.  Raises RuntimeError
    if the library does not build, OSError if a file cannot be read or
    written."""
    lib = load_library()
    encoded = [p.encode() for p in corpus_paths]
    arr = (ctypes.c_char_p * len(encoded))(*encoded)
    n = lib.m3ptok_train(arr, len(encoded), out_path.encode(),
                         vocab_size, max_piece_len, seed_factor, n_em_iters)
    if n < 0:
        raise OSError(f"native trainer failed (paths={list(corpus_paths)})")
    return int(n)
