"""Checkpoints of the port (m3p_tpu_torch.checkpoint) against the JAX
package (`m3p_tpu/checkpoint.py`): a reference ``.pth`` of another
``--lgs`` merged as JAX merges it, train-state save and restore bit for bit
(Adam, FusedAdam with bf16 moments and an fp32 master, accumulation in
mid-window), ``extra.json`` as JAX writes it, the atomic replace, the
reference export and the 0.6 / 0.4 blend."""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu import checkpoint as jax_ckpt
from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.train import optim as jax_optim
from m3p_tpu.train.state import create_train_state as jax_train_state
from m3p_tpu_torch import checkpoint as ckpt
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.data import synthetic
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.train import optim
from m3p_tpu_torch.train.state import create_train_state
from m3p_tpu_torch.train.steps import itm_finetune_loss, make_train_step

torch.set_num_threads(1)

REGIONS, SAMPLE_N = 8, 2


def _jax_cfg(n_langs=4):
    return JaxModelConfig(
        n_words=256, n_langs=n_langs, emb_dim=32, n_layers=2, n_heads=2,
        dropout=0.1, attention_dropout=0.1, max_region_num=REGIONS,
        refine_layers=1, mask_index=255, dtype="float32",
        use_pallas_attention=False)


@functools.lru_cache(maxsize=None)
def _jax_params(n_langs, seed):
    _, params = jax_build_model(_jax_cfg(n_langs), jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _port_model(seed=0, n_langs=4):
    cfg = ModelConfig(**dataclasses.asdict(_jax_cfg(n_langs)))
    return build_model(cfg, seed, "cpu")


def _batch(seed):
    b = synthetic.make_retrieval_batch(np.random.RandomState(seed), 2,
                                       SAMPLE_N, 10, REGIONS, 256)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _trained_state(spec, steps, accumulate=1, seed=0):
    """A small model after ``steps`` micro-steps of the ITM step (dropout
    0.1, so the generators matter) under ``spec``."""
    model = _port_model(seed)
    tx, _ = optim.build_optimizer(spec, clip_grad_norm=1.0,
                                  accumulate_gradients=accumulate)
    state = create_train_state(model, tx)
    step = make_train_step(functools.partial(itm_finetune_loss,
                                             sample_n=SAMPLE_N))
    for i in range(steps):
        state, _ = step(state, _batch(i), Generators.from_seed(i, "cpu"))
    return state


def _tensors(tree, prefix=""):
    """(path, tensor) of every tensor in a nested dict / list; other
    leaves as (path, value)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tensors(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _assert_bitwise(a, b):
    left, right = list(_tensors(a)), list(_tensors(b))
    assert [p for p, _ in left] == [p for p, _ in right]
    for (path, x), (_, y) in zip(left, right):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


SPECS = {
    "adam": ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.01,"
             "warmup_updates=2,weight_decay=0.01", 1, 3),
    "fused_master": ("adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.01,"
                     "warmup_updates=2,fused=1,mu_dtype=bfloat16,"
                     "nu_dtype=bfloat16,master=1", 1, 3),
    # 5 micro-steps at k = 3: one update made, the window 2 deep
    "accumulation_mid_window": ("adam,lr=0.01,mu_dtype=bfloat16", 3, 5),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_save_and_restore_are_bitwise(name, tmp_path):
    spec, k, steps = SPECS[name]
    state = _trained_state(spec, steps, accumulate=k)
    if name == "fused_master":
        assert state.opt_state["mu"][0].dtype == torch.bfloat16
        assert next(state.model.parameters()).dtype == torch.bfloat16
    if name == "accumulation_mid_window":
        assert state.step == 1 and state.opt_state["mini_step"] == 2
        assert max(float(a.abs().max()) for a in state.opt_state["acc"]) > 0
    path = str(tmp_path / "checkpoint")
    ckpt.save_checkpoint(path, state, {"epoch": 3})
    fresh = create_train_state(
        _port_model(seed=9),
        optim.build_optimizer(spec, clip_grad_norm=1.0,
                              accumulate_gradients=k)[0])
    restored, extra = ckpt.restore_checkpoint(path, fresh)
    assert extra == {"epoch": 3}
    assert restored.step == state.step
    _assert_bitwise(restored.model.state_dict(), state.model.state_dict())
    _assert_bitwise(restored.opt_state, state.opt_state)
    # the restored state trains on as the original does
    step = make_train_step(functools.partial(itm_finetune_loss,
                                             sample_n=SAMPLE_N))
    for st in (state, restored):
        step(st, _batch(7), Generators.from_seed(7, "cpu"))
    _assert_bitwise(restored.model.state_dict(), state.model.state_dict())
    assert sorted(os.listdir(tmp_path)) == ["checkpoint"]
    assert ckpt.load_params_checkpoint(path).keys() == \
        state.model.state_dict().keys()


def test_extra_json_is_what_jax_writes(tmp_path):
    extra = {"epoch": 2, "n_total_iter": 17,
             "best_metrics": {"I2T_acc": 62.5, "stop-I2T_acc": 62.5},
             "n_sentences": 48, "loader_state": {}}
    tx, _ = jax_optim.build_optimizer("adam,lr=0.01")
    jstate = jax_train_state(jax.tree.map(jnp.asarray, _jax_params(4, 0)),
                             tx)
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, dict(extra))
    ckpt.save_checkpoint(str(tmp_path / "port"),
                         _trained_state("adam,lr=0.01", 1), dict(extra))
    files = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "extra.json") as f:
            files[side] = json.load(f)
        assert not any(n.startswith("loader_state")
                       for n in os.listdir(tmp_path / side))
    assert files["port"] == files["jax"]
    # a loader state goes to the rank's own file on both sides
    extra["loader_state"] = {"rel|coco": {"pos": 3}}
    jax_ckpt.save_checkpoint(str(tmp_path / "jax"), jstate, dict(extra))
    ckpt.save_checkpoint(str(tmp_path / "port"),
                         _trained_state("adam,lr=0.01", 1), dict(extra))
    for side in ("jax", "port"):
        with open(tmp_path / side / "loader_state.0.json") as f:
            assert json.load(f) == extra["loader_state"]


def test_a_failing_save_leaves_the_old_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "checkpoint")
    old = _trained_state("adam,lr=0.01", 1)
    ckpt.save_checkpoint(path, old, {"epoch": 0})
    want = {k: v.clone() for k, v in old.model.state_dict().items()}
    newer = _trained_state("adam,lr=0.01", 2)
    real_save = torch.save

    def dying_save(obj, f, *a, **kw):
        with open(f, "wb") as out:   # a partial file, then the kill
            out.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_checkpoint(path, newer, {"epoch": 1})
    monkeypatch.setattr(torch, "save", real_save)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint"]
    fresh = create_train_state(_port_model(5),
                               optim.build_optimizer("adam,lr=0.01")[0])
    _, extra = ckpt.restore_checkpoint(path, fresh)
    assert extra == {"epoch": 0}
    _assert_bitwise(fresh.model.state_dict(), want)
    # a kill between moving the old directory aside and moving the new one
    # in: the old one, whole beside the path, is the checkpoint
    os.replace(path, path + ".previous")
    assert ckpt.committed_checkpoint(path) == path + ".previous"
    _, extra = ckpt.restore_checkpoint(path, fresh)
    assert extra == {"epoch": 0}
    ckpt.save_checkpoint(path, newer, {"epoch": 1})
    assert sorted(os.listdir(tmp_path)) == ["checkpoint"]
    assert ckpt.committed_checkpoint(path) == path


def test_reference_pth_of_another_lgs_merges_as_jax_merges(tmp_path):
    """A reference ``.pth`` pre-trained at n_langs 5 (``--lgs`` of four
    languages) into a model at n_langs 4: JAX keeps the initial language
    table and loads the rest; `load_weights` did raise ``size mismatch``
    (``load_state_dict(strict=False)`` checks shapes)."""
    cfg4 = _jax_cfg(4)
    pth = str(tmp_path / "other_lgs.pth")
    jax_ckpt.save_reference_checkpoint(pth, _jax_params(5, 1), cfg4.n_layers,
                                       cfg4.refine_layers)
    init = _jax_params(4, 0)
    merged = jax_ckpt.merge_params(
        jax.tree.map(jnp.asarray, init),
        jax_ckpt.load_reference_checkpoint(pth, cfg4.n_layers,
                                           cfg4.refine_layers))
    want = ckpt.params_from_jax(jax.tree.map(np.asarray, merged))
    model = _port_model(3)
    model.load_state_dict(ckpt.params_from_jax(init), strict=True)
    ckpt.load_weights(model, pth)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    lang = ckpt.params_from_jax(init)["text_emb.lang.weight"]
    assert torch.equal(got["text_emb.lang.weight"], lang)
    other = ckpt.params_from_jax(_jax_params(5, 1))
    assert torch.equal(got["block_0.attn.q_lin.weight"],
                       other["block_0.attn.q_lin.weight"])


def test_merge_params_backfills_and_casts():
    model = _port_model(0)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = {"block_1.ln1.weight": torch.full_like(
                  sd["block_1.ln1.weight"], 2.0, dtype=torch.float64),
              "text_emb.lang.weight": torch.zeros(7, 32),
              "not.in.the.model": torch.zeros(3)}
    merged = ckpt.merge_params(sd, loaded)
    assert merged["block_1.ln1.weight"].dtype == torch.float32
    assert torch.equal(merged["block_1.ln1.weight"],
                       torch.full_like(sd["block_1.ln1.weight"], 2.0))
    assert torch.equal(merged["text_emb.lang.weight"],
                       sd["text_emb.lang.weight"])
    assert set(merged) == set(sd)


def test_reference_export_is_the_jax_export(tmp_path):
    params = _jax_params(4, 2)
    cfg = _jax_cfg(4)
    want = jax_ckpt.export_reference_state_dict(params, cfg.n_layers,
                                                cfg.refine_layers)
    model = _port_model(0)
    model.load_state_dict(ckpt.params_from_jax(params), strict=True)
    got = ckpt.export_reference_state_dict(model, cfg.n_layers,
                                           cfg.refine_layers)
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], torch.from_numpy(value)), name
    pth = str(tmp_path / "model.pth")
    ckpt.save_reference_checkpoint(pth, model, cfg.n_layers,
                                   cfg.refine_layers, {"lgs": "en-de"})
    back = jax_ckpt.load_reference_checkpoint(pth, cfg.n_layers,
                                              cfg.refine_layers)
    for name, value in ckpt.params_from_jax(back).items():
        assert torch.equal(value, model.state_dict()[name]), name
    assert torch.load(pth, weights_only=False)["params"] == {"lgs": "en-de"}


def test_average_checkpoints_blends_as_jax():
    trees = [_jax_params(4, s) for s in (0, 1, 2)]
    want = jax_ckpt.average_checkpoints(
        [jax.tree.map(jnp.asarray, trees[0]),
         jax_ckpt.average_checkpoints([jax.tree.map(jnp.asarray, t)
                                       for t in trees[1:]])],
        weights=[0.6, 0.4])
    sds = [ckpt.params_from_jax(t) for t in trees]
    got = ckpt.average_checkpoints(
        [sds[0], ckpt.average_checkpoints(sds[1:])], weights=[0.6, 0.4])
    for name, value in ckpt.params_from_jax(
            jax.tree.map(np.asarray, want)).items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    with pytest.raises(ValueError):
        ckpt.average_checkpoints(sds, weights=[0.5, 0.5])
