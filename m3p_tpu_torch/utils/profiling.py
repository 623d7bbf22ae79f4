"""Profiling (counterpart of `m3p_tpu/utils/profiling.py`): a
`torch.profiler` trace written as a Chrome trace, and a step timer whose
`sync` waits for the device by reading a scalar the last step produced."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

logger = logging.getLogger("m3p_tpu_torch")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (host and, where there is one, the CUDA device)
    and write ``<log_dir>/trace.json`` (open it in chrome://tracing or
    Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


class StepTimer:
    """Steady-state step time; call `sync` with a device scalar from the
    latest step to bound the timed region (launches return before the
    device finishes)."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self._steps = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self) -> None:
        self._steps += 1

    def sync(self, device_scalar: torch.Tensor) -> float:
        """Wait for the device by copying the scalar to the host; returns
        seconds per step since `start` and starts again."""
        float(device_scalar)
        if self._t0 is None or self._steps == 0:
            raise RuntimeError("StepTimer.sync before start() and tick()")
        dt = (time.perf_counter() - self._t0) / self._steps
        self.start()
        return dt
