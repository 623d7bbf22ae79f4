"""Nothing a run or the reference loads is JAX or the JAX package, and the
reference loads nothing of the port.  Top-level module names are compared
whole: the port's name begins with the JAX package's."""

import json
import subprocess
import sys

from benchmark.harness import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "m3p_tpu"}


def loaded_after(code: str) -> set:
    probe = code + """
import json, sys
print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))
"""
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_the_port():
    tops = loaded_after("import benchmark.reference.m3p, "
                        "benchmark.reference.philox, benchmark.weights, "
                        "benchmark.yardstick")
    assert not tops & FORBIDDEN
    assert "m3p_tpu_torch" not in tops


def test_a_run_loads_no_jax():
    tops = loaded_after("""
from benchmark.tests.tiny import context, runner
from benchmark import harness
for cell in ("base.mct-pretrain", "long.xmlm-4k"):
    ctx = context(cell, 11, seconds=0)
    runner(ctx).run(ctx)
assert not harness.loaded_forbidden(), harness.loaded_forbidden()
""")
    assert not tops & FORBIDDEN
    assert "m3p_tpu_torch" in tops
