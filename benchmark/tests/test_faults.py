"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in a tiny rehearsal on the CPU and
read through the harness's result with the cell's own limits.  The
program's own path comes out correct there."""

import pytest

from benchmark.harness import build_result
from benchmark.tests.tiny import bench, context, runner

SEED = 2718281828

CASES = [("base.mct-pretrain", "frozen"), ("base.mct-pretrain", "half_batch"),
         ("long.xmlm-4k", "frozen"), ("long.xmlm-4k", "half_batch")]


def result(cell, variant):
    seconds = 0.3
    ctx = context(cell, SEED, seconds=seconds, variant=variant)
    return build_result(bench(), ctx.workload, runner(ctx).run(ctx), False)


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_is_not_correct(cell, fault):
    out = result(cell, fault)
    assert out["correct"] is False, out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted({c for c, _ in CASES}))
def test_the_program_is_correct(cell):
    out = result(cell, "")
    assert out["correct"] is True, out["checks"]
