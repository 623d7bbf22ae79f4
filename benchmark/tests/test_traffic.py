"""The traffic is a function of the seed alone."""

import numpy as np
import torch

from benchmark.runners import train
from benchmark.tests.tiny import context

SEED, OTHER = 2 ** 31 + 12345, 987654321


def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return np.array_equal(a, b)


def test_training_batches_repeat_for_a_seed():
    for cell, make in (("base.mct-pretrain", train.mct_batch),
                       ("long.xmlm-4k", train.stream_batch)):
        ctx = context(cell, SEED)
        a = make(ctx.cfg, ctx.traffic, SEED, "cpu")
        assert same(a, make(ctx.cfg, ctx.traffic, SEED, "cpu"))
        assert not same(a, make(ctx.cfg, ctx.traffic, OTHER, "cpu"))


def test_mct_batch_layout():
    ctx = context("base.mct-pretrain", SEED)
    b = train.mct_batch(ctx.cfg, ctx.traffic, SEED, "cpu")
    for row, n in zip(b["tokens"], b["text_len"]):
        assert row[0] == 0 and row[n - 1] == 2
        assert (row[1:n - 1] >= 4).all() and (row[n:] == 1).all()
