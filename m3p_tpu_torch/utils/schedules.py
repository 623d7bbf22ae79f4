"""Piecewise-linear loss-coefficient schedules (a copy of
`m3p_tpu/utils/schedules.py`).

Parity with the reference lambda DSL (`utils.py:249-293`): a coefficient is either
a constant (``"1"``/``"0.5"``) or a comma-separated list of ``step:value`` knots
(``"0:1,1000:0"``) interpolated linearly between knots and clamped outside.
Coefficients are plain host-side floats updated once per step and passed
into the step function as scalar arguments, so a schedule costs no device
work.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class LambdaSchedule:
    """knots: sorted [(step, value)]; a single knot means a constant."""

    knots: Tuple[Tuple[int, float], ...]

    @classmethod
    def parse(cls, spec: str) -> "LambdaSchedule":
        spec = str(spec).strip()
        if ":" not in spec:
            return cls(knots=((0, float(spec)),))
        parts = [s for s in spec.split(",") if s]
        knots: List[Tuple[int, float]] = []
        for p in parts:
            k, v = p.split(":")
            knots.append((int(k), float(v)))
        knots.sort(key=lambda kv: kv[0])
        if not knots:
            raise ValueError(f"empty lambda spec: {spec!r}")
        return cls(knots=tuple(knots))

    def __call__(self, step: int) -> float:
        ks = self.knots
        if len(ks) == 1:
            return ks[0][1]
        steps = [k for k, _ in ks]
        if step <= steps[0]:
            return ks[0][1]
        if step >= steps[-1]:
            return ks[-1][1]
        i = bisect.bisect_right(steps, step) - 1
        (s0, v0), (s1, v1) = ks[i], ks[i + 1]
        t = (step - s0) / float(s1 - s0)
        return v0 + t * (v1 - v0)

    @property
    def is_constant(self) -> bool:
        return len(self.knots) == 1


def parse_lambda_config(specs: Dict[str, str]) -> Dict[str, LambdaSchedule]:
    return {name: LambdaSchedule.parse(spec) for name, spec in specs.items()}


def update_lambdas(schedules: Dict[str, LambdaSchedule], step: int) -> Dict[str, float]:
    return {name: sched(step) for name, sched in schedules.items()}
