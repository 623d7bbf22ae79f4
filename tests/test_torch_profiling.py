"""The port's profiling helpers (m3p_tpu_torch.utils.profiling): `trace`
writes a Chrome trace that holds the block's spans, and `StepTimer` gives
seconds a step between syncs.  On the CPU the trace holds host events only.

This file imports nothing of JAX."""

import json
import types

import pytest
import torch

from m3p_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_with_the_blocks_spans(tmp_path):
    log_dir = tmp_path / "profile"
    with profiling.trace(str(log_dir)) as prof:
        with torch.profiler.record_function("m3p_step"):
            x = torch.ones(8, 8)
            (x @ x).sum()
    assert isinstance(prof, torch.profiler.profile)
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "m3p_step" in names
    assert any(name and "mm" in name for name in names)


def test_step_timer_gives_seconds_a_step_and_starts_again(monkeypatch):
    clock = iter([10.0, 16.0, 16.0, 17.5, 17.5])
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(
                            perf_counter=lambda: next(clock)))
    timer = profiling.StepTimer()
    with pytest.raises(RuntimeError, match="before start"):
        timer.sync(torch.tensor(0.0))
    timer.start()                               # t = 10
    for _ in range(3):
        timer.tick()
    assert timer.sync(torch.tensor(1.0)) == pytest.approx(2.0)  # t = 16
    timer.tick()
    assert timer.sync(torch.tensor(1.0)) == pytest.approx(1.5)  # t = 17.5
