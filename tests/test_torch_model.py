"""The port's serving slice (encode_joint + itm_score) against the JAX
M3PModel, and the weights bridge (params_from_jax, params_to_jax,
load_reference_state_dict, load_weights)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from m3p_tpu.checkpoint import export_reference_state_dict
from m3p_tpu.config import small_test_config
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu_torch.checkpoint import (
    load_reference_state_dict, load_weights, params_from_jax, params_to_jax)
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model import build_model

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_model():
    cfg = small_test_config().model
    model, params = jax_build_model(cfg, jax.random.PRNGKey(0))
    return cfg, model, jax.tree.map(np.asarray, params)


def _port(jcfg, params):
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


@pytest.mark.parametrize("refine_image", [True, False])
def test_encode_joint_and_itm_score_match_jax(jax_model, refine_image):
    jcfg, jm, params = jax_model
    model = _port(jcfg, params)
    rng = np.random.RandomState(0)
    b, s, r = 4, 10, jcfg.max_region_num
    tokens = rng.randint(4, jcfg.n_words, (b, s)).astype(np.int32)
    text_mask = np.arange(s)[None] < np.array([10, 6, 3, 2])[:, None]
    img_mask = np.arange(r)[None] < np.array([r, 5, 1, 0])[:, None]
    feats = rng.randn(b, r, jcfg.img_feat_dim).astype(np.float32)
    locs = rng.rand(b, r, jcfg.img_loc_dim).astype(np.float32)
    hidden = jm.apply({"params": params}, tokens, text_mask, feats, locs,
                      img_mask, refine_image, method=jm.encode_joint)
    score = jm.apply({"params": params}, hidden, method=jm.itm_score)
    with torch.inference_mode():
        th = model.encode_joint(
            torch.from_numpy(tokens).long(), torch.from_numpy(text_mask),
            torch.from_numpy(feats), torch.from_numpy(locs),
            torch.from_numpy(img_mask), refine_image)
        ts = model.itm_score(th)
    np.testing.assert_allclose(th.numpy(), np.asarray(hidden),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(score),
                               rtol=1e-4, atol=1e-4)


def test_params_from_jax_is_strict(jax_model):
    jcfg, _, params = jax_model
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0, "cpu")
    missing = {k: v for k, v in params.items() if k != "itm_pooler"}
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(params_from_jax(missing), strict=True)
    extra = dict(params, extra_head={"dense": {"kernel": np.zeros((2, 2))}})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        model.load_state_dict(params_from_jax(extra), strict=True)
    with pytest.raises(KeyError):
        params_from_jax({"block_0": {"attn": {"gamma": np.zeros(2)}}})


def test_weights_round_trip_is_exact(jax_model):
    jcfg, _, params = jax_model
    back = params_to_jax(_port(jcfg, params))
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert set(got) == {path for path, _ in want}
    for path, leaf in want:
        assert got[path].shape == leaf.shape, path
        assert np.array_equal(got[path], leaf), path


def test_reference_state_dict_gives_the_same_tensors(jax_model):
    jcfg, _, params = jax_model
    ref = export_reference_state_dict(params, jcfg.n_layers,
                                      jcfg.refine_layers)
    got = load_reference_state_dict(ref, jcfg.n_layers, jcfg.refine_layers)
    want = params_from_jax(params)
    assert set(got) == set(want)
    for key, tensor in want.items():
        assert torch.equal(got[key], tensor), key


def test_load_weights_reads_pth_and_pt(jax_model, tmp_path):
    jcfg, _, params = jax_model
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    ref = export_reference_state_dict(params, jcfg.n_layers,
                                      jcfg.refine_layers)
    pth = str(tmp_path / "model.pth")
    torch.save({"model": {"module." + k: torch.from_numpy(v)
                          for k, v in ref.items()}, "params": {}}, pth)
    model = build_model(cfg, 1, "cpu")
    load_weights(model, pth)
    want = params_from_jax(params)
    for key, tensor in model.state_dict().items():
        assert torch.equal(tensor, want[key]), key
    pt = str(tmp_path / "model.pt")
    torch.save(model.state_dict(), pt)
    again = build_model(cfg, 2, "cpu")
    load_weights(again, pt)
    for key, tensor in again.state_dict().items():
        assert torch.equal(tensor, want[key]), key
    with pytest.raises(NotImplementedError):
        load_weights(again, str(tmp_path / "orbax_dir"))


def test_build_model_is_seeded_and_refuses_unported_features():
    cfg = ModelConfig(**dataclasses.asdict(small_test_config().model))
    a = build_model(cfg, 5, "cpu").state_dict()
    b = build_model(cfg, 5, "cpu").state_dict()
    c = build_model(cfg, 6, "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["block_0.attn.q_lin.weight"],
                           c["block_0.attn.q_lin.weight"])
    # non-fp32 parameters are refused; sequence parallelism builds (the
    # ring runs only where parallel.sp binds the axis: alone, the model runs
    # the whole sequence, causal decoding included), as do the int8
    # training modes, MoE, asm and image fusion
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, param_dtype="bfloat16"), 0,
                    "cpu")
    sp = build_model(dataclasses.replace(cfg, seq_axis="seq"), 5, "cpu")
    plain = build_model(cfg, 5, "cpu")
    tokens = torch.randint(4, 100, (1, 6))
    text_mask = torch.ones(1, 6, dtype=torch.bool)
    with torch.no_grad():
        for causal in (False, True):
            assert torch.equal(
                sp.encode_text(tokens, text_mask, causal=causal),
                plain.encode_text(tokens, text_mask, causal=causal))
    for change in (dict(asm=True, asm_cutoffs=(64, 256)),
                   dict(image_fusion=True), dict(moe_experts=4),
                   dict(ffn_quant="int8"), dict(ffn_quant="int8_bwd"),
                   dict(ffn_quant="int8_all"), dict(head_quant="int8_bwd")):
        build_model(dataclasses.replace(cfg, **change), 0, "cpu")
    with pytest.raises(ValueError, match="ffn_quant"):
        build_model(dataclasses.replace(cfg, ffn_quant="int4"), 0, "cpu")
    # the fused residual dropout is ported: every block takes the flag
    fused = build_model(dataclasses.replace(cfg, use_fused_dropout=True), 5,
                        "cpu")
    assert all(block.use_fused_dropout for block in fused.blocks)
