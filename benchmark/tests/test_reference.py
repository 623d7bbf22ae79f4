"""The plain reference against the port's plain path at a tiny width on
the CPU: the same parameters by name and shape, the same draws, the same
losses, gradients and scores to float32's rounding."""

import pytest
import torch

from benchmark.harness import load_json, ROOT
from benchmark.reference.m3p import param_spec
from benchmark.tests.tiny import TINY_MODEL, context, runner

SEED = 3141592653


@pytest.mark.parametrize("config", ["m3p-base", "m3p-long"])
@pytest.mark.parametrize("tiny", [False, True])
def test_parameters_are_the_ports(config, tiny):
    from benchmark.runners.train import model_config
    from m3p_tpu_torch.model import M3PModel
    cfg = load_json(ROOT / f"benchmark/configs/{config}.json")
    if tiny:
        cfg.update(TINY_MODEL)
    with torch.device("meta"):
        model = M3PModel(model_config(cfg))
    port = sorted((k, tuple(v.shape)) for k, v in model.state_dict().items())
    assert port == [(n, s) for n, s, _ in param_spec(cfg)]


@pytest.mark.parametrize("cell", ["base.mct-pretrain", "long.xmlm-4k"])
def test_training_steps_follow_the_port(cell):
    ctx = context(cell, SEED, seconds=0)
    rec = runner(ctx).run(ctx)
    gaps = rec["readings"]
    # float32 compute on both sides; the port's live parameters, their
    # gradients and the first moments are bf16 (FusedAdam's master=1)
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 0.05, gaps
    assert gaps["change_gap"] < 0.01, gaps
