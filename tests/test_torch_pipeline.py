"""The port's input staging (m3p_tpu_torch.data.pipeline.prefetch_to_device):
batches of numpy arrays and ``(t2i, i2t)`` pairs of them become tensors
(integers as int64) on the device, in order, and the iterator's error comes
out in the consumer; `close` stops the thread.  The `gpu` test stages onto
the card from pinned memory on a side stream and reads the batch on the
default stream at once.

This file imports nothing of JAX, so it also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_pipeline.py
"""

import itertools

import numpy as np
import pytest
import torch

from m3p_tpu_torch.data.pipeline import prefetch_to_device


def _batches(n, rows=4):
    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        b = {"tokens": rng.randint(0, 100, (rows, 8)).astype(np.int32),
             "feats": rng.randn(rows, 3, 16).astype(np.float32),
             "flag": np.bool_(i % 2)}
        out.append(b if i % 2 else (b, dict(b, tokens=b["tokens"] + 1)))
    return out


def _assert_staged(got, want, device):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_staged(g, w, device)
        return
    assert set(got) == set(want)
    for k, w in want.items():
        t = got[k]
        assert t.device.type == device
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.cpu().numpy(), np.asarray(w))


def test_prefetch_stages_dicts_and_pairs_in_order():
    batches = _batches(5)
    it = prefetch_to_device(iter(batches), buffer_size=2, device="cpu")
    for want in batches:
        _assert_staged(next(it), want, "cpu")
    for _ in range(2):                 # exhausted, and stays so
        with pytest.raises(StopIteration):
            next(it)


def test_prefetch_raises_the_iterators_error_in_the_consumer():
    def failing():
        yield _batches(1)[0]
        raise ValueError("no more records")

    it = prefetch_to_device(failing(), device="cpu")
    next(it)
    with pytest.raises(ValueError, match="no more records"):
        next(it)


def test_close_stops_the_thread_of_an_endless_iterator():
    it = prefetch_to_device(itertools.repeat(_batches(2)[1]), device="cpu")
    next(it)
    it.close()
    assert not it._thread.is_alive()


@pytest.mark.gpu
def test_prefetch_copies_onto_the_card_on_a_side_stream():
    """64 MB a batch from pinned memory on the side stream; the default
    stream reads each batch at once, so a missing wait would read rows
    still in flight."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(1)
    batches = [{"feats": rng.randn(64, 256, 1024).astype(np.float32),
                "tokens": rng.randint(0, 9, (64, 8)).astype(np.int32)}
               for _ in range(4)]
    it = prefetch_to_device(iter(batches))       # "cuda": the current card
    assert it.device.index == torch.cuda.current_device()
    sums = []
    for _ in batches:
        got = next(it)
        assert got["feats"].is_cuda and got["tokens"].dtype == torch.int64
        sums.append(got["feats"].double().sum())    # on the default stream
    for s, b in zip(sums, batches):
        np.testing.assert_allclose(s.item(), b["feats"].astype(np.float64)
                                   .sum(), rtol=1e-9)
