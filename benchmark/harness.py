"""The benchmark's harness: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

It reads `BENCHMARK.json`, finds the cell, its configuration file and its
traffic file, and hands them to the traffic's runner
(``benchmark/runners/<runner>.py``, named in the traffic file).  The
runner sets the program up, measures for ``--seconds`` and checks what the
timed path produced against the plain reference; it returns a record.
Each metric is read from the record by its own reader
(``benchmark/metrics/<name>.py``): the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``.  The last line of
standard output is the result, the last lines of standard error the
numbers compared with their limits.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "m3p_tpu")


class Refused(Exception):
    """The run cannot measure: no result is printed."""


def loaded_forbidden() -> List[str]:
    """Top-level names in ``sys.modules`` that a run may not load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


# ---------------------------------------------------------------------------
# host spans and the device trace
# ---------------------------------------------------------------------------

@dataclass
class Window:
    """The measured window: host-clock bounds, host spans, and with a
    trace the device operations in it."""

    start: float = 0.0
    end: float = 0.0
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    ops: List[Tuple[str, int, int]] = field(default_factory=list)
    offset_ns: int = 0          # device clock - host clock
    traced: bool = False
    _groups: Optional[Dict[str, float]] = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))

    # -- what the trace says ---------------------------------------------
    def host_bounds_ns(self) -> Tuple[int, int]:
        return int(self.start * 1e9), int(self.end * 1e9)

    def busy_intervals(self, lo_ns: int, hi_ns: int) -> List[Tuple[int, int]]:
        """The union of device operations within host-clock [lo, hi)."""
        out: List[Tuple[int, int]] = []
        for a, b in sorted((a - self.offset_ns, b - self.offset_ns)
                           for _, a, b in self.ops):
            a, b = max(a, lo_ns), min(b, hi_ns)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        """Seconds of the window in which an operation ran on the device."""
        return sum(b - a for a, b in
                   self.busy_intervals(*self.host_bounds_ns())) / 1e9

    def group_s(self) -> Dict[str, float]:
        """Device seconds in the window by kernel group."""
        if self._groups is not None:
            return self._groups
        from benchmark.yardstick import kernel_group
        w0, w1 = self.host_bounds_ns()
        out: Dict[str, float] = {}
        for name, a, b in self.ops:
            a, b = a - self.offset_ns, b - self.offset_ns
            if a >= w0 and b <= w1:
                g = kernel_group(name)
                out[g] = out.get(g, 0.0) + (b - a) / 1e9
        self._groups = out
        return out

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest idle stretches of the device in the window, each
        named by the host span it began in."""
        w0, w1 = self.host_bounds_ns()
        busy = self.busy_intervals(w0, w1)
        gaps, at = [], w0
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if w1 > at:
            gaps.append((at, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        starts = sorted((a, b, n) for n, a, b in self.spans)
        keys = [a for a, _, _ in starts]
        out = []
        for a, b in gaps[:top]:
            i = bisect.bisect_right(keys, a) - 1
            label = "outside any span"
            while i >= 0:
                s0, s1, n = starts[i]
                if s0 <= a < s1:
                    label = n
                    break
                i -= 1
            out.append((f"host in {label}", (b - a) / 1e9))
        return out


class Tracer:
    """torch.profiler over the window, the device's activity alone (the
    host's own ops are not traced, which keeps its cost on the host small),
    and the offset between the device's clock and the host's, read from a
    marker operation launched on an idle device."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if not self.on:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter_ns()
        torch.empty(7, dtype=torch.float64, device="cuda").fill_(3.0)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def read(self, window: Window) -> None:
        """Fill ``window.ops`` and its clock offset from the trace."""
        if self.prof is None:
            return
        from torch.autograd import DeviceType
        ops, marker = [], None
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            a, b = e.start_ns(), e.end_ns()
            if "FillFunctor<double>" in name:
                marker = a if marker is None else min(marker, a)
            ops.append((name, a, b))
        if marker is None:
            raise Refused("the trace holds no marker operation: the device's "
                          "activity was not recorded")
        window.ops = ops
        window.offset_ns = marker - self.marker_host
        window.traced = True


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Context:
    """What a runner gets: the cell, its configuration and traffic, the
    run's arguments and the harness's clock."""

    workload: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    t0: float
    window: Window = field(default_factory=Window)
    # the tests' rehearsal runs on the CPU at a tiny size, with a planted
    # variant (a control or a fault); a benchmark run is "cuda" and ""
    device: str = "cuda"
    variant: str = ""

    def sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def measure(self):
        """The measured window: set-up ends where it begins; with a trace
        the profiler records it."""
        self.sync()
        with Tracer(self.trace and self.device == "cuda") as tracer:
            self.window.start = time.perf_counter()
            yield self.window
            self.sync()
            self.window.end = time.perf_counter()
        tracer.read(self.window)


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_reader(name: str):
    """The reader of metric ``name``: ``benchmark/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_for(bench: dict, workload: str, kind: str) -> List[dict]:
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def card() -> str:
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        "nvidia-smi failed"


def build_result(bench: dict, workload: dict, rec: dict, trace: bool
                 ) -> dict:
    """The result line of a run from the runner's record: ``correct``,
    the cell's metrics of the run's kind, the device, with a trace the
    breakdown, and last the numbers compared with their limits."""
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, workload["name"], kind):
        value = load_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks: List[Check] = rec["checks"]
    out = {"correct": all(c.ok for c in checks) and rec["failed"] == 0,
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu", "kind": rec.get("kind", ""),
                      "count": workload["chips"],
                      "memory_peak_bytes": int(rec["peak_bytes"])}}
    if trace:
        w: Window = rec["window"]
        out["device"]["busy_s"] = w.busy_s()
        out["device"]["window_s"] = w.seconds
        groups = sorted(w.group_s().items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": [[g, s] for g, s in groups[:10]],
                            "idle_gaps": [list(g) for g in w.idle_gaps()]}
    out["card"] = rec.get("card", "")
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out


def main(t0: float, argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; known: {sorted(cells)}",
              file=sys.stderr)
        return 2
    workload = cells[args.workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(ROOT / configs[workload["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{workload['traffic']}.json")

    import torch
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < workload["chips"]:
        print(f"no result: the cell needs {workload['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(workload, cfg, traffic, args.seed, args.seconds,
                  bool(args.trace), t0)
    runner = importlib.import_module(f"benchmark.runners.{traffic['runner']}")
    try:
        rec = runner.run(ctx)
    except Refused as e:
        print(f"no result: {e}", file=sys.stderr)
        return 4
    found = loaded_forbidden()
    if found:
        print(f"no result: the run loaded {found}", file=sys.stderr)
        return 5
    rec["kind"] = torch.cuda.get_device_name(0)
    rec["card"] = card()
    out = build_result(bench, workload, rec, bool(args.trace))
    for name, c in out["checks"].items():
        ok = c["value"] == c["value"] and c["value"] <= c["limit"]
        print(f"check {name}: {c['value']!r} against limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0
