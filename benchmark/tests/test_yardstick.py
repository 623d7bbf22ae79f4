"""The frozen counts against the figures the repository measured with
and against the port's own copies."""

import pytest

from benchmark import yardstick as Y
from benchmark.harness import load_json, ROOT

BASE = load_json(ROOT / "benchmark/configs/m3p-base.json")


def test_mct_step_flops_is_bench_py_at_bn_80():
    # PERF.md: 8.678 TFLOP a step at BN 80 (`bench.mct_step_flops`)
    flops = Y.mct_step_flops(BASE, 80, 64, 100, 16, 0.25)
    assert round(flops / 1e12, 3) == 8.678


def test_xmlm_step_flops_at_b8_s2048():
    # PERF.md: 14.42 TFLOP a step at B 8 x S 2048, 256 slots a stream
    flops = Y.mlm_step_flops(BASE, 8, 2048, 8 * 256)
    assert round(flops / 1e12, 2) == 14.42


def test_joint_forward_flops_is_a_grid_pair():
    # PERF.md: 34.57 GFLOP a grid pair at S = 164 over 100 regions
    assert round(Y.joint_forward_flops(BASE, 164, 100) / 1e9, 2) == 34.57


@pytest.mark.parametrize("b,sq,backward,bound_ms", [
    (80, 164, False, 0.0241), (80, 164, True, 0.0421),
    (64, 164, False, 0.0193), (8, 2048, False, 0.1042),
    (8, 2048, True, 0.2606)])
def test_attention_bounds_are_perf_md_table(b, sq, backward, bound_ms):
    got = Y.attention_least_s(b, 12, sq, sq, 64, backward) * 1e3
    assert round(got, 4) == bound_ms


def test_counts_equal_the_ports_copies():
    from m3p_tpu_torch import bench
    cfg = bench.bench_config(ffn_quant="none")
    assert Y.mct_step_flops(BASE, 80, 64, 100, 16, 0.25) == \
        bench.mct_step_flops(cfg, 80)
    assert Y.joint_forward_flops(BASE, 150, 100) == \
        bench.joint_forward_flops(cfg, 150)


@pytest.mark.parametrize("name,group", [
    ("void packed_attention_fwd_mma_kernel<64>(Args)", "packed_attention"),
    ("void packed_attention_bwd_dq_mma_kernel<64>(Params<bf16>)",
     "packed_attention_bwd"),
    ("void flash_attention_fwd_mma_kernel<64>(Params<bf16>)",
     "flash_attention"),
    ("void flash_attention_bwd_dkdv_mma_kernel<64>(Params<bf16>)",
     "flash_attention_bwd"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel",
     "optimizer (foreach)"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NTN", "gemm"),
    ("Memcpy HtoD (Pageable -> Device)", "copies"),
])
def test_kernel_groups(name, group):
    assert Y.kernel_group(name) == group


@pytest.mark.parametrize("cell", ["base.mct-pretrain", "long.xmlm-4k"])
def test_attention_calls_are_the_ports(cell, monkeypatch):
    """The rooflines' count of a step's attention calls is the port's: on
    the CPU each call goes through the plain forward and backward, counted
    here; under remat (m3p-long) a block's forward runs twice."""
    import collections

    from m3p_tpu_torch.ops import attention as A
    from benchmark.runners import train
    from benchmark.tests.tiny import context, runner

    seen = collections.Counter()

    def counting(name):
        fn = getattr(A, name)

        def wrap(*args, **kw):
            seen[name] += 1
            return fn(*args, **kw)
        return wrap

    for fam in ("packed", "flash"):
        for name in (f"attention_{fam}_reference",
                     f"attention_{fam}_bwd_reference"):
            monkeypatch.setattr(A, name, counting(name))
    ctx = context(cell, 1618033988, seconds=0)
    rec = runner(ctx).run(ctx)
    steps = ctx.traffic["warmup_steps"] + rec["steps"]
    _, forwards = train.attention_least(ctx.cfg, ctx.traffic)
    cfg = ctx.cfg
    if cell == "long.xmlm-4k":
        assert cfg["remat"] and forwards == {"packed": 0,
                                             "flash": 2 * cfg["n_layers"]}
        backwards = {"packed": 0, "flash": cfg["n_layers"]}
    else:
        assert forwards == {"packed": cfg["refine_layers"] + cfg["n_layers"],
                            "flash": 0}
        backwards = {"packed": forwards["packed"], "flash": 0}
    for fam in ("packed", "flash"):
        assert seen[f"attention_{fam}_reference"] == steps * forwards[fam]
        assert seen[f"attention_{fam}_bwd_reference"] == \
            steps * backwards[fam]
