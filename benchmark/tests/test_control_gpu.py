"""The controls on a card, at each cell's own size (a run with no
measured window: set-up, the checked steps, the reference): each cell's
control (the port's own int8 FFN path, ``ffn_quant="int8_bwd"``, in the
configuration's place) comes out not correct under the cell's limits, and
the program itself correct.  The readings the limits were set from are in
PERF.md; `benchmark/limits.py` makes them."""

import importlib
import time

import pytest

from benchmark.harness import Context, build_result, load_json, ROOT
from benchmark.tests.tiny import CELLS


def outcome(cell: str, seed: int, variant: str) -> dict:
    bench = load_json(ROOT / "BENCHMARK.json")
    config, traffic = CELLS[cell]
    workload = {"name": cell, "config": config, "traffic": traffic,
                "chips": 1}
    cfg = load_json(ROOT / "benchmark" / "configs" / f"{config}.json")
    tr = load_json(ROOT / "benchmark" / "traffic" / f"{traffic}.json")
    ctx = Context(workload, cfg, tr, seed, 0, False, time.perf_counter(),
                  variant=variant)
    runner = importlib.import_module(f"benchmark.runners.{tr['runner']}")
    rec = runner.run(ctx)
    return build_result(bench, workload, rec, False)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("seed", [3200000101, 3200000202, 3200000303])
def test_control_is_not_correct(cuda, cell, seed):
    assert outcome(cell, seed, "")["correct"] is True
    assert outcome(cell, seed, "control")["correct"] is False
