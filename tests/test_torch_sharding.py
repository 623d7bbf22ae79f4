"""The port's parameter sharding (m3p_tpu_torch.parallel.sharding and
tensor_parallel: FSDP, tensor and expert parallelism) against the JAX
package on the CPU.

The port's ranks are gloo processes (`test_torch_ranks.RankPool`, pools of
2, 4 and 8 for the module); the JAX side runs the one-process step on the
global batch in this process.  fp32 throughout: the frameworks, and the
ranks against one process, sum in other orders, so losses agree to 1e-5
relative and parameters after a step to 1e-4 (`TOL`), as in
`test_torch_parallel.py`; the sharded port against the port in one
process to 1e-5 (`TOL_ONE`).

* the logical-axes table against `get_param_pspecs` of the JAX model, leaf
  by leaf, for the small tree, the scale-up tree and a tree with MoE, the
  adaptive softmax and the image fusion;
* the thin 24-layer scale-up MCT step (remat) on 8 ranks, data 2 x fsdp 2
  x tensor 2, against JAX's one-process step (`tests/test_scale_up.py:
  93-140`); ITM on fsdp 2 x tensor 2;
* MoE on tensor 2 x expert 2 (`tests/test_moe.py:140-170`); seq 2 x tensor
  2 xMLM (`tests/test_composed_parallelism.py:106-140`);
* fault 12: MoE's ITM and MCT steps on 2 data ranks equal JAX's
  global-batch step (the parent chose experts' tokens rank by rank);
* fault 13: remat recomputes every block, and the gradients and the
  generators' next draws at dropout 0.1 are bitwise those without it;
* the attention kernels' Philox head offset in the plain versions;
* tensor 2 at dropout 0.1 is the one-process step; planted faults are seen;
* checkpoints: 4 sharded ranks to one process and back, bitwise;
* `train_x.main` under --mesh_fsdp 2 --mesh_tensor 2 against one process;
* the evaluator's retrieval grid on data 2 x tensor 2, greedy and beam
  decoding on fsdp 2 x tensor 2, against one process;
* the mesh's groups over tuples of axes.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.config import scale_up_config as jax_scale_up_config
from m3p_tpu.data import masking as jax_masking
from m3p_tpu.data import synthetic as jax_synthetic
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.model.transformer import M3PModel as JaxM3PModel
from m3p_tpu.model.transformer import lengths_to_mask as jax_lengths_to_mask
from m3p_tpu.parallel import sharding as jax_sharding
from m3p_tpu.train import optim as jax_optim
from m3p_tpu.train import steps as jax_steps
from m3p_tpu.train.state import create_train_state as jax_train_state
from m3p_tpu_torch.checkpoint import params_from_jax, params_to_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.transformer import M3PModel
from m3p_tpu_torch.parallel import sharding as SH
from m3p_tpu_torch.train import optim
from m3p_tpu_torch.train import steps as S
from m3p_tpu_torch.train.state import create_train_state
from test_torch_ranks import RankPool

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)
# the sharded port against the port in one process: the same kernels and
# the same arithmetic, summed in other orders over the ranks
TOL_ONE = dict(rtol=1e-5, atol=1e-7)
LOSS_RTOL = 1e-5
SAMPLE_N = 2
REGIONS = 8
SPEC = "adam,lr=0.001,eps=0.001"


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module compiles its JAX
    references (most of its time): fp32 values at the tolerances here do
    not move."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(n):
        if n not in made:
            made[n] = RankPool(n, str(tmp_path_factory.mktemp(f"ranks{n}")))
        return made[n]

    yield get
    for pool in made.values():
        pool.close()


def _jax_cfg(**kw):
    base = dict(n_words=512, n_langs=3, emb_dim=64, n_layers=2, n_heads=4,
                dropout=0.0, attention_dropout=0.0, max_region_num=REGIONS,
                refine_layers=1, mask_index=511, dtype="float32",
                use_pallas_attention=False, max_positions=80)
    return JaxModelConfig(**{**base, **kw})


def _built(jcfg, from_port=False):
    """The JAX model and parameters and the port's state of ``jcfg``;
    ``from_port`` draws the parameters with the port (seed 0) and hands
    them to JAX, which then runs no init (24 layers' init compiles for
    tens of seconds)."""
    if from_port:
        model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0,
                            "cpu")
        jm, params = JaxM3PModel(jcfg), params_to_jax(model)
    else:
        jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, params)
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    return {"jcfg": jcfg, "jm": jm, "params": params,
            "cfg": dataclasses.asdict(jcfg), "state": state}


@pytest.fixture(scope="module")
def small():
    return _built(_jax_cfg())


@pytest.fixture(scope="module")
def moe():
    return _built(_jax_cfg(moe_experts=4, moe_interval=2))


def _jax_step(built, loss_fn, batch, spec=SPEC, clip=0.0, key=3):
    """JAX's one-process step on the global batch."""
    tx, _ = jax_optim.build_optimizer(spec, clip_grad_norm=clip)
    state = jax_train_state(jax.tree.map(jnp.asarray, built["params"]), tx)
    step = jax_steps.make_train_step(loss_fn, donate=False,
                                     with_grad_norm=True)
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, jax.random.PRNGKey(key))
    return params_from_jax(jax.tree.map(np.asarray, state.params)), metrics


def _compare(ranks, want, loss, grad_norm=None, where="", tol=TOL):
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=LOSS_RTOL,
                                   err_msg=where)
        if grad_norm is not None:
            np.testing.assert_allclose(r["grad_norm"], grad_norm, rtol=1e-4,
                                       err_msg=where)
        assert set(r["params"]) == set(want), where
        for name, w in want.items():
            np.testing.assert_allclose(r["params"][name], np.asarray(w),
                                       **tol, err_msg=f"{where} {name}")


def _compare_gradients(ranks, want, before, loss, grad_norm, where=""):
    """An SGD step at lr 1 moves each parameter by minus its gradient: each
    leaf's move within 1e-4 of its largest entry (and 1e-6 absolute), as
    `test_torch_parallel.py::_assert_grads` holds gradients (24 layers sum
    a bias's gradient over every token with cancellation, and the orders
    differ)."""
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=LOSS_RTOL,
                                   err_msg=where)
        np.testing.assert_allclose(r["grad_norm"], grad_norm, rtol=1e-4,
                                   err_msg=where)
        for name, w in want.items():
            move = np.asarray(w) - before[name]
            err = np.abs((r["params"][name] - before[name]) - move).max()
            tol = 1e-6 + 1e-4 * float(np.abs(move).max())
            assert err <= tol, f"{where} {name}: {err} > {tol}"


def _retrieval_batch(seed=0, groups=4, n_words=512):
    return jax_synthetic.make_retrieval_batch(
        np.random.RandomState(seed), groups, SAMPLE_N, 9, REGIONS, n_words)


def _itm_loss(jm):
    return lambda p, b, k: jax_steps.itm_finetune_loss(
        jm, p, b, k, SAMPLE_N, deterministic=True)


# ---------------------------------------------------------------------------
# the logical axes
# ---------------------------------------------------------------------------


def _jax_axes_by_port_name(pspecs):
    """JAX's logical PartitionSpecs under the port's names and layouts (a
    kernel's axes reversed, as its weight is transposed)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        pspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for path, spec in flat[0]:
        keys = [p.key for p in path]
        *mods, leaf = keys
        axes = tuple(spec) if spec is not None else ()
        if mods and mods[-1] == "ln" and leaf in ("scale", "bias"):
            mods, leaf = mods[:-1], "weight" if leaf == "scale" else "bias"
        elif leaf == "kernel":
            axes, leaf = axes[::-1], "weight"
        elif leaf == "embedding":
            leaf = "weight"
        out[".".join(mods + [leaf])] = axes
    return out


@pytest.mark.parametrize("which", ["small", "scale_up", "moe_asm_fusion"])
def test_logical_axes_match_the_jax_pspecs_leaf_by_leaf(which):
    if which == "small":
        jcfg = _jax_cfg()
    elif which == "scale_up":
        jcfg = jax_scale_up_config().model
    else:
        jcfg = _jax_cfg(moe_experts=4, moe_interval=2, asm=True,
                        asm_cutoffs=(100, 300), image_fusion=True,
                        share_inout_emb=False)
    want = _jax_axes_by_port_name(jax_sharding.model_param_pspecs(jcfg))
    with torch.device("meta"):
        model = M3PModel(ModelConfig(**dataclasses.asdict(jcfg)))
    got = SH.model_param_specs(model)
    # the JAX tree always holds the fusion's parameters; the port's only
    # under image_fusion
    missing = set(want) - set(got)
    assert all(n.startswith("cross_align.") for n in missing), missing
    assert not set(got) - set(want), set(got) - set(want)
    for name, axes in got.items():
        w = want[name]
        pad = (None,) * (len(axes) - len(w))
        assert tuple(axes) == tuple(w) + pad, (name, axes, w)
    if which == "scale_up":
        mesh_axes = SH.logical_to_mesh_axes(got["text_emb.word.weight"])
        assert mesh_axes == ("tensor", "fsdp")
        assert "block_23.attn.q_lin.weight" in got


def test_check_mesh_supported_raises_only_for_pp():
    """Every axis is taken alone, and ``pp`` with the parameter axes;
    ``pp`` with ``seq`` raises, as the JAX trainer asserts."""
    for axis in ("data", "fsdp", "seq", "tensor", "expert", "pp"):
        SH.check_mesh_supported({axis: 2})
    SH.check_mesh_supported({"pp": 2, "fsdp": 2, "tensor": 2})
    with pytest.raises(ValueError, match="seq and pp"):
        SH.check_mesh_supported({"pp": 2, "seq": 2})


@pytest.mark.parametrize("change", [
    {"ffn_quant": "int8_bwd"}, {"head_quant": "int8_bwd"}, {"asm": True}])
def test_tensor_parallelism_refuses_only_what_the_jax_stage_refuses(change):
    """The int8 modes and the adaptive softmax split over ``tensor`` (as
    GSPMD splits them), and so do heads that do not divide by ``tensor``
    (resharded around the kernels); what stays refused is what JAX
    refuses: the int8 FFN under ``pp`` (the JAX stage's block has
    none)."""
    cfg = dataclasses.replace(ModelConfig(**dataclasses.asdict(_jax_cfg())),
                              **change)
    SH.check_model_supported(cfg, {"tensor": 2})
    SH.check_model_supported(cfg, {"fsdp": 2, "tensor": 2})
    if "ffn_quant" in change:
        with pytest.raises(NotImplementedError, match="pp > 1"):
            SH.check_model_supported(cfg, {"pp": 2, "tensor": 2})
    else:
        SH.check_model_supported(cfg, {"pp": 2, "tensor": 2})
    SH.check_model_supported(cfg, {"tensor": 3})


# ---------------------------------------------------------------------------
# the steps against JAX
# ---------------------------------------------------------------------------


def test_fsdp_by_tensor_itm_step_matches_jax(pools, small):
    batch = _retrieval_batch()
    wait = pools(4).submit("sharded_step", cfg_dict=small["cfg"],
                           state=small["state"], kind="itm", batch=batch,
                           mesh_axes={"fsdp": 2, "tensor": 2}, spec=SPEC,
                           clip=0.05)
    want, jm = _jax_step(small, _itm_loss(small["jm"]), batch, clip=0.05)
    ranks = wait()
    _compare(ranks, want, float(jm["loss"]), float(jm["grad_norm"]))
    # each rank holds under half the bytes (a quarter of what is split over
    # both axes, half of what fsdp alone splits)
    whole = sum(v.nbytes for v in small["state"].values())
    assert all(r["local_bytes"] < 0.45 * whole for r in ranks)


def _jax_draws(batch, key, mask_kw, regions):
    """The coin and both maskings of the JAX MCT loss under its own key
    split (`m3p_tpu/train/steps.py:200-219`), as numpy."""
    r_coin, r_text, r_img, _ = jax.random.split(key, 4)
    tokens = jnp.asarray(batch["tokens"])
    bn, s = tokens.shape
    cfg = jax_masking.MaskingConfig(**mask_kw)
    coin = jax.random.bernoulli(r_coin, 0.5, (bn,)).astype(jnp.float32)
    text = jax_masking.mask_tokens(
        r_text, tokens, jax_lengths_to_mask(jnp.asarray(batch["text_len"]),
                                            s), cfg)
    region = jax_masking.mask_regions(
        r_img, jnp.asarray(batch["feats"]), jnp.asarray(batch["obj_labels"]),
        jax_lengths_to_mask(jnp.asarray(batch["img_len"]), regions), cfg)
    return {"coin": np.asarray(coin),
            "text_masking": [np.asarray(x) for x in text],
            "region_masking": [np.asarray(x) for x in region]}


def _mct(built, batch, mask_kw, regions, pools, n, mesh_axes, key=7,
         spec=SPEC):
    jcfg = built["jcfg"]
    loss_fn = functools.partial(
        jax_steps.mct_pretrain_loss, built["jm"],
        mask_cfg=jax_masking.MaskingConfig(**mask_kw), sample_n=SAMPLE_N,
        deterministic=True, pack_ratio=0.5, lambda_rel=1.0, lambda_mlm=1.0,
        lambda_mrm=1.0, lambda_mrfr=1.0, lambda_clcm=1.0)
    draws = _jax_draws(batch, jax.random.PRNGKey(key), mask_kw, regions)
    wait = pools(n).submit("sharded_step", cfg_dict=built["cfg"],
                           state=built["state"], kind="mct", batch=batch,
                           mesh_axes=mesh_axes, spec=spec, draws=draws,
                           mask_cfg=mask_kw)
    want, jm = _jax_step(built, lambda p, b, k: loss_fn(p, b, k), batch,
                         spec=spec, key=key)
    assert jcfg.n_words == mask_kw["n_words"]
    return wait(), want, jm


def test_scale_up_thin_24l_mct_step_on_eight_ranks_matches_jax(pools):
    """The counterpart of `tests/test_scale_up.py:93-140`: the preset at
    d = 64 (24 layers, 101 languages, remat), data 2 x fsdp 2 x tensor 2,
    the MCT step on the global batch against JAX's one process."""
    cfg = jax_scale_up_config().model
    thin = dataclasses.replace(cfg, emb_dim=64, n_heads=4, n_words=512,
                               mask_index=511, dtype="float32",
                               use_pallas_attention=False)
    assert thin.n_layers == 24 and thin.n_langs == 101 and thin.remat
    built = _built(thin, from_port=True)
    # the JAX step without remat (the same values; its compile is the
    # test's longest part)
    built["jm"] = JaxM3PModel(dataclasses.replace(thin, remat=False))
    batch = jax_synthetic.make_pretrain_batch(np.random.RandomState(0), 4,
                                              SAMPLE_N, 12, 4, 512)
    mask_kw = dict(max_pred=4, n_words=512, mask_index=511)
    ranks, want, jm = _mct(built, batch, mask_kw, 4, pools, 8,
                           {"data": 2, "fsdp": 2, "tensor": 2},
                           spec="sgd,lr=1.0")
    _compare_gradients(ranks, want, built["state"], float(jm["loss"]),
                       float(jm["grad_norm"]), "scale-up thin")


def test_moe_tensor_by_expert_itm_step_matches_jax(pools, moe):
    """The counterpart of `tests/test_moe.py:140-170`: MoE on tensor 2 x
    expert 2 (each rank two experts, half of each expert's hidden)."""
    batch = _retrieval_batch(1)
    wait = pools(4).submit("sharded_step", cfg_dict=moe["cfg"],
                           state=moe["state"], kind="itm", batch=batch,
                           mesh_axes={"tensor": 2, "expert": 2}, spec=SPEC)
    want, jm = _jax_step(moe, _itm_loss(moe["jm"]), batch)
    ranks = wait()
    _compare(ranks, want, float(jm["loss"]), float(jm["grad_norm"]), "moe")


def test_seq_by_tensor_mlm_step_matches_jax(pools, small):
    """The counterpart of `tests/test_composed_parallelism.py:106-140`: the
    xMLM step with the stack sequence-parallel over seq 2 and the heads
    over tensor 2 (the ring takes the local heads)."""
    batch = jax_synthetic.make_stream_batch(np.random.RandomState(2), 4, 15,
                                            512)
    mask_kw = dict(max_pred=4, n_words=512, mask_index=511)
    key = jax.random.PRNGKey(5)
    r_mask, _ = jax.random.split(key)
    tokens = jnp.asarray(batch["tokens"])
    masking = [np.asarray(x) for x in jax_masking.mask_tokens(
        r_mask, tokens, jax_lengths_to_mask(jnp.asarray(batch["lengths"]),
                                            tokens.shape[1]),
        jax_masking.MaskingConfig(**mask_kw))]
    jmask = jax_masking.MaskingConfig(**mask_kw)
    wait = pools(4).submit("sharded_step", cfg_dict=small["cfg"],
                           state=small["state"], kind="mlm", batch=batch,
                           mesh_axes={"seq": 2, "tensor": 2}, spec=SPEC,
                           draws={"masking": masking}, mask_cfg=mask_kw)
    want, jm = _jax_step(small, lambda p, b, k: jax_steps.mlm_loss(
        small["jm"], p, b, k, jmask, deterministic=True), batch, key=5)
    ranks = wait()
    _compare(ranks, want, float(jm["mlm"]), float(jm["grad_norm"]), "sp tp")


@pytest.mark.parametrize("kind", ["itm", "mct"])
def test_moe_on_two_data_ranks_chooses_over_the_global_batch(pools, moe,
                                                             kind):
    """Fault 12: each expert takes its top C of the global batch's tokens
    with C from the global count, as JAX's step does over the global
    batch; the parent took them rank by rank."""
    if kind == "itm":
        batch = _retrieval_batch(3)
        wait = pools(2).submit("sharded_step", cfg_dict=moe["cfg"],
                               state=moe["state"], kind="itm", batch=batch,
                               mesh_axes={"data": 2}, spec=SPEC)
        want, jm = _jax_step(moe, _itm_loss(moe["jm"]), batch)
        ranks = wait()
    else:
        batch = jax_synthetic.make_pretrain_batch(
            np.random.RandomState(4), 4, SAMPLE_N, 10, REGIONS, 512)
        mask_kw = dict(max_pred=4, n_words=512, mask_index=511)
        ranks, want, jm = _mct(moe, batch, mask_kw, REGIONS, pools, 2,
                               {"data": 2})
    _compare(ranks, want, float(jm["loss"]), float(jm["grad_norm"]), kind)


def test_tensor_two_at_dropout_is_the_one_process_step(pools, small):
    """Residual and attention dropout 0.1 under tensor 2: the tensor ranks
    draw the one process's elementwise masks (the batch shard alone is
    folded into the generators) and each head its own attention mask by
    its index among all the heads, so the step is the one process's."""
    cfg = dict(small["cfg"], dropout=0.1, attention_dropout=0.1)
    batch = _retrieval_batch(5)
    ranks = pools(2).run("sharded_step", cfg_dict=cfg, state=small["state"],
                         kind="itm", batch=batch, mesh_axes={"tensor": 2},
                         spec=SPEC, seed=11)
    model = build_model(ModelConfig(**cfg), 0, "cpu")
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in small["state"].items()})
    from m3p_tpu_torch.model.layers import Generators

    tx, _ = optim.build_optimizer(SPEC)
    state = create_train_state(model, tx)
    step = S.make_train_step(lambda m, b, g: S.itm_finetune_loss(
        m, b, g, SAMPLE_N, deterministic=False), with_grad_norm=True)
    _, metrics = step(state, {k: torch.tensor(v) for k, v in batch.items()},
                      Generators.from_seed(11, "cpu"))
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    _compare(ranks, want, metrics["loss"].item(),
             metrics["grad_norm"].item(), "dropout", TOL_ONE)


@pytest.mark.parametrize("fault", ["row_no_reduce", "local_ce"])
def test_planted_faults_break_the_equality(pools, small, fault):
    batch = jax_synthetic.make_pretrain_batch(np.random.RandomState(6), 4,
                                              SAMPLE_N, 10, REGIONS, 512)
    mask_kw = dict(max_pred=4, n_words=512, mask_index=511)
    draws = _jax_draws(batch, jax.random.PRNGKey(2), mask_kw, REGIONS)
    args = dict(cfg_dict=small["cfg"], state=small["state"], kind="mct",
                batch=batch, mesh_axes={"fsdp": 2, "tensor": 2}, spec=SPEC,
                draws=draws, mask_cfg=mask_kw)
    good = pools(4).run("sharded_step", **args)[0]
    bad = pools(4).run("sharded_step", fault=fault, **args)[0]
    off = max(abs(bad["loss"] - good["loss"]) / abs(good["loss"]),
              max(float(np.abs(bad["params"][n] - good["params"][n]).max())
                  for n in good["params"]))
    assert off > 1e-3, (fault, off)


# ---------------------------------------------------------------------------
# the guard and the clip over shards (faults 14 and 15)
# ---------------------------------------------------------------------------

FUSED_MASTER = "adam,fused=1,master=1,lr=0.001,eps=0.001"


def test_fused_master_clip_on_fsdp_by_tensor_is_the_one_process_clip(
        pools, small):
    """Fault 14: under ``fused=1,master=1`` the gradients are bf16, and the
    clip's norm over shards is `optax_global_norm`'s value in bf16, the
    one process's (the parent summed every square in fp32).  The first
    moment, proportional to the clip's scale, is one process's: that of
    `FusedAdam` in one process on the gradients the ranks reduced, and the
    one-process step's wherever those gradients are bitwise its own (the
    ranks sum in other orders, so a few bf16 roundings fall the other
    way)."""
    batch = _retrieval_batch(7)
    clip = 0.05
    wait = pools(4).submit("sharded_step", cfg_dict=small["cfg"],
                           state=small["state"], kind="itm", batch=batch,
                           mesh_axes={"fsdp": 2, "tensor": 2},
                           spec=FUSED_MASTER, clip=clip)
    model = build_model(ModelConfig(**small["cfg"]), 0, "cpu")
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in small["state"].items()})
    tx, _ = optim.build_optimizer(FUSED_MASTER, clip_grad_norm=clip)
    state = create_train_state(model, tx)
    step = S.make_train_step(lambda m, b, g: S.itm_finetune_loss(
        m, b, g, SAMPLE_N, deterministic=True))
    _, metrics = step(state, {k: torch.tensor(v) for k, v in batch.items()},
                      None)
    params = list(model.parameters())
    assert params[0].grad.dtype == torch.bfloat16
    norm = optim.optax_global_norm([p.grad if p.grad is not None
                                    else torch.zeros_like(p)
                                    for p in params])
    assert float(norm) > 2 * clip                     # the clip bites
    names = [n for n, _ in model.named_parameters()]
    mu = {n: t.float().numpy() for n, t in zip(names, state.opt_state["mu"])}
    grads = {n: p.grad.float().numpy() for n, p in zip(names, params)
             if p.grad is not None}
    ranks = wait()
    # one process's FusedAdam on the ranks' reduced gradients
    same = build_model(ModelConfig(**small["cfg"]), 0, "cpu")
    same.load_state_dict({k: torch.tensor(v)
                          for k, v in small["state"].items()})
    one = create_train_state(same, tx)
    got = ranks[0]["grads"]
    for n, p in same.named_parameters():
        p.grad = (torch.tensor(got[n]).to(p.dtype) if n in got else None)
    one.apply_gradients()
    mu_same = {n: t.float().numpy() for n, t in zip(names,
                                                    one.opt_state["mu"])}
    flipped = total = 0
    for r in ranks:
        np.testing.assert_allclose(r["loss"], metrics["loss"].item(),
                                   rtol=LOSS_RTOL)
        assert r["grad_norm_dtype"] == "torch.bfloat16"
        assert r["grad_norm"] == float(norm)
        for n, want in mu.items():
            np.testing.assert_allclose(r["mu"][n], mu_same[n], **TOL_ONE,
                                       err_msg=n)
            if n not in grads:
                continue
            bitwise = r["grads"][n] == grads[n]
            flipped += int((~bitwise).sum())
            total += bitwise.size
            np.testing.assert_allclose(r["mu"][n][bitwise], want[bitwise],
                                       **TOL_ONE, err_msg=n)
    # 0.41 % of the elements on the CPU: the sharded backward reduces its
    # bf16 partial gradients (fsdp's reduce-scatter) before the rounding
    assert flipped <= 1e-2 * total, (flipped, total)


def test_nonfinite_shard_on_one_rank_makes_every_rank_skip(pools, small):
    """Fault 15: an inf in rank 0's shard of one fsdp-split gradient makes
    the guard skip the step on every rank (the parent decided per rank:
    rank 0 skipped, the others updated, and the replicated leaves
    parted)."""
    batch = _retrieval_batch(8)
    ranks = pools(4).run("sharded_step", cfg_dict=small["cfg"],
                         state=small["state"], kind="itm", batch=batch,
                         mesh_axes={"fsdp": 2, "tensor": 2}, spec=SPEC,
                         guard=True, fault="inf_grad", whole=False)
    assert np.isinf(ranks[0]["grad_norm"])
    spec = SH.model_param_specs(build_model(ModelConfig(**small["cfg"]), 0,
                                            "cpu"))
    assert spec["block_0.attn.q_lin.weight"] == ("qkv", "embed")
    replicated = [n for n, axes in spec.items() if not any(axes)]
    assert "block_0.ln1.weight" in replicated
    for r in ranks:
        for n in replicated:
            np.testing.assert_array_equal(r["params"][n], small["state"][n],
                                          err_msg=n)
            np.testing.assert_array_equal(r["params"][n],
                                          ranks[0]["params"][n], err_msg=n)
    whole = pools(4).run("sharded_step", cfg_dict=small["cfg"],
                         state=small["state"], kind="itm", batch=batch,
                         mesh_axes={"fsdp": 2, "tensor": 2}, spec=SPEC,
                         guard=True, fault="inf_grad")
    for r in whole:
        for n, want in small["state"].items():
            np.testing.assert_array_equal(r["params"][n], want, err_msg=n)


# ---------------------------------------------------------------------------
# remat (fault 13)
# ---------------------------------------------------------------------------


def test_remat_recomputes_each_block_and_keeps_the_draws_bitwise(small,
                                                                 monkeypatch):
    """Fault 13: under remat every block runs again in the backward (the
    parent ignored remat), and at dropout and attention dropout 0.1 the
    gradients are bitwise those of the plain stack, and both generators
    end where they would (the next step's draws are equal)."""
    from m3p_tpu_torch.model.layers import EncoderBlock, Generators

    cfg = dict(small["cfg"], dropout=0.1, attention_dropout=0.1)
    batch = {k: torch.tensor(v) for k, v in _retrieval_batch(7).items()}
    runs = {}
    for remat in (False, True):
        model = build_model(ModelConfig(**dict(cfg, remat=remat)), 0, "cpu")
        model.load_state_dict({k: torch.tensor(v)
                               for k, v in small["state"].items()})
        calls = [0]
        forward = EncoderBlock.forward

        def counted(*a, **kw):
            calls[0] += 1
            return forward(*a, **kw)

        monkeypatch.setattr(EncoderBlock, "forward", counted)
        gen = Generators.from_seed(13, "cpu")
        loss, _ = S.itm_finetune_loss(model, batch, gen, SAMPLE_N)
        loss.backward()
        monkeypatch.setattr(EncoderBlock, "forward", forward)
        runs[remat] = {
            "calls": calls[0], "loss": loss.item(),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "next": (torch.rand(8, generator=gen.device),
                     gen.attention_seed())}
    n_blocks = small["jcfg"].n_layers
    assert runs[False]["calls"] == n_blocks
    assert runs[True]["calls"] == 2 * n_blocks
    assert runs[True]["loss"] == runs[False]["loss"]
    assert set(runs[True]["grads"]) == set(runs[False]["grads"])
    for name, g in runs[False]["grads"].items():
        assert torch.equal(runs[True]["grads"][name], g), name
    assert torch.equal(runs[True]["next"][0], runs[False]["next"][0])
    assert runs[True]["next"][1] == runs[False]["next"][1]


# ---------------------------------------------------------------------------
# the Philox head offset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["packed", "flash", "small"])
def test_a_call_over_some_heads_draws_their_slice_of_the_mask(entry):
    """Heads 6-11 of 12 called alone (head_base 6, heads_total 12) draw
    exactly those heads' masks of the call over all 12: V = identity makes
    the output the kept, scaled weights (`tests/test_flash_dropout.py`'s
    pattern), so the two outputs' head slices are equal."""
    from m3p_tpu_torch.ops import attention as A

    b, s, h, dh = 2, 16, 12, 16
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, h * dh, generator=g)
    k = torch.randn(b, s, h * dh, generator=g)
    eye = torch.eye(s)[None, :, None, :].expand(b, s, h, dh)
    v = eye.reshape(b, s, h * dh).contiguous()   # dh == s: V = identity
    seed, rate = 12345, 0.3
    if entry == "small":
        def call(qq, kk, vv, heads, **kw):
            split = [t.view(b, s, heads, dh).transpose(1, 2)
                     for t in (qq, kk, vv)]
            out = A.small_attention_reference(*split, None, False, None,
                                              rate, seed, **kw)
            return out.transpose(1, 2).reshape(b, s, heads * dh)
    else:
        fn = (A.attention_packed_reference if entry == "packed"
              else A.attention_flash_reference)

        def call(qq, kk, vv, heads, **kw):
            return fn(qq, kk, vv, None, heads, False, None, rate, seed,
                      **kw)
    whole = call(q, k, v, h)
    cols = slice(6 * dh, 12 * dh)
    part = call(q[..., cols], k[..., cols], v[..., cols], 6, head_base=6,
                heads_total=12)
    assert torch.equal(part, whole[..., cols])
    plain = call(q[..., cols], k[..., cols], v[..., cols], 6)
    assert not torch.equal(plain, whole[..., cols])
    # the default arguments draw what the call drew before: tile b * H + h
    from m3p_tpu_torch.ops.philox import head_tiles, keep_mask_tiles

    assert torch.equal(head_tiles(b, h), torch.arange(b * h))
    assert torch.equal(A._keep(seed, rate, b, h, s, s, "cpu"),
                       keep_mask_tiles(seed, b * h, s, s, rate).view(
                           b, h, s, s))


# ---------------------------------------------------------------------------
# checkpoints and train_x
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_between_four_sharded_ranks_and_one(
        pools, small, tmp_path):
    """A state saved by 4 ranks (fsdp 2 x tensor 2) is the one-process
    format: one process restores it bitwise, and 4 ranks restore a
    one-process save bitwise."""
    from m3p_tpu_torch import checkpoint as ckpt

    path = str(tmp_path / "sharded")
    saved = pools(4).run("checkpoint_trip", cfg_dict=small["cfg"],
                         state=small["state"],
                         mesh_axes={"fsdp": 2, "tensor": 2}, path=path)
    model = build_model(ModelConfig(**small["cfg"]), 0, "cpu")
    tx, _ = optim.build_optimizer(SPEC)
    one = create_train_state(model, tx)
    one, extra = ckpt.restore_checkpoint(path, one)
    assert extra["epoch"] == 3 and one.step == saved[0]["step"] == 1
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), saved[0]["model"][name])
    for key in ("mu", "nu"):
        for a, b in zip(one.opt_state[key], saved[0][key]):
            np.testing.assert_array_equal(a.numpy(), b)
    # one process's save back into 4 sharded ranks
    path1 = str(tmp_path / "one")
    ckpt.save_checkpoint(path1, one, {"epoch": 4})
    back = pools(4).run("checkpoint_trip", cfg_dict=small["cfg"],
                        state=small["state"],
                        mesh_axes={"fsdp": 2, "tensor": 2}, path=path1,
                        save=False)
    for r in back:
        assert r["step"] == 1
        for name, t in model.state_dict().items():
            np.testing.assert_array_equal(r["model"][name], t.numpy())
        for a, b in zip(one.opt_state["mu"], r["mu"]):
            np.testing.assert_array_equal(a.numpy(), b)


def test_train_x_on_fsdp_by_tensor_trains_what_one_process_trains(
        pools, tmp_path):
    """`train_x.main` on each of 4 ranks with --mesh_fsdp 2 --mesh_tensor 2
    against one process on the same global batches: the parameters after
    the epoch (ITM and captioning tasks, the clip on), gathered."""
    from m3p_tpu_torch.cli import train_x
    from m3p_tpu_torch.tokenization.unigram import train_unigram
    from test_torch_ranks import record_data

    vocab = str(tmp_path / "vocab.tsv")
    train_unigram(["red cat dog runs blue tree house"] * 30,
                  vocab_size=80).save(vocab)
    argv = ["--lgs", "en", "--cross_rel_steps", "coco-img",
            "--max_region_num", "5", "--sample_n", "2", "--batch_size", "4",
            "--max_len", "9", "--emb_dim", "32", "--n_layers", "1",
            "--n_heads", "2", "--n_dec_layers", "1", "--refine_layers", "1",
            "--dropout", "0.0", "--attention_dropout", "0.0", "--fp16",
            "False", "--epoch_size", "12", "--max_epoch", "1",
            "--use_grain", "False", "--optimizer", "adam,lr=0.001,eps=0.001",
            "--clip_grad_norm", "0.5", "--exp_name", "fsdp_tp"]
    ranks = pools(4).run(
        "train_main", argv=argv + ["--dump_path", str(tmp_path / "sh"),
                                   "--exp_id", "r", "--mesh_fsdp", "2",
                                   "--mesh_tensor", "2"],
        vocab=vocab, n_groups=16, caption=True)
    one = train_x.main(argv + ["--dump_path", str(tmp_path / "one"),
                               "--exp_id", "o", "--device", "cpu"],
                       data=record_data(vocab, 16, caption=True))
    assert [tuple(r["shards"]) for r in ranks] == [(0, 2), (0, 2), (1, 2),
                                                   (1, 2)]
    assert ranks[0]["mesh"]["fsdp"] == ranks[0]["mesh"]["tensor"] == 2
    assert ranks[0]["n_total_iter"] == one.n_total_iter > 0
    for name, p in one.model.named_parameters():
        for r in ranks:
            np.testing.assert_allclose(r["params"][name],
                                       p.detach().numpy(), **TOL_ONE,
                                       err_msg=name)
    # the checkpoint rank 0 wrote is the one-process format
    saved = torch.load(tmp_path / "sh" / "fsdp_tp" / "r" / "checkpoint" /
                       "state.pt", weights_only=True)
    for name, p in one.model.named_parameters():
        assert saved["model"][name].shape == p.shape, name


def test_retrieval_grid_on_a_sharded_model_is_the_one_process_grid(
        pools, small):
    """The evaluator's grid on data 2 x tensor 2: the chunks split over
    ``data`` (the two ranks of a data coordinate score theirs together),
    the partial matrices summed over it; the scores and R@k are one
    process's."""
    from m3p_tpu_torch.config import TrainConfig
    from m3p_tpu_torch.eval.evaluator import Evaluator
    from m3p_tpu_torch.eval.retrieval import retrieval_grid_scores

    rng = np.random.RandomState(9)
    n_img, n_cap, s = 3, 7, 9
    cap_len = rng.randint(3, s + 1, (n_cap,)).astype(np.int32)
    cap_tokens = rng.randint(4, 500, (n_cap, s)).astype(np.int32)
    pool = (cap_tokens, cap_len,
            rng.randn(n_img, REGIONS, 2048).astype(np.float32),
            rng.rand(n_img, REGIONS, 5).astype(np.float32),
            rng.randint(3, REGIONS + 1, (n_img,)).astype(np.int32))
    cap_to_img = np.arange(n_cap) % n_img
    ranks = pools(4).run("sharded_grid", cfg_dict=small["cfg"],
                         state=small["state"],
                         mesh_axes={"data": 2, "tensor": 2}, pool=pool,
                         cap_to_img=cap_to_img)
    model = build_model(ModelConfig(**small["cfg"]), 0, "cpu")
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in small["state"].items()})
    want = retrieval_grid_scores(model, *pool, chunk_size=4)
    recall = Evaluator(model, TrainConfig(model=ModelConfig(
        **small["cfg"]))).evaluate_retrieval_test(
        cap_tokens, cap_len, cap_to_img, *pool[2:], chunk_size=4)
    for r in ranks:
        np.testing.assert_allclose(r["scores"], want, rtol=0, atol=2e-5)
        assert r["recall"] == recall


def test_decoding_on_a_sharded_model_is_the_one_process_decoding(
        pools, small):
    """Greedy and beam-2 captions on fsdp 2 x tensor 2: the decode cache
    holds each rank's heads, cross-attention projects the source once, a
    step's logits are gathered over ``tensor``; the image encoding within
    fp32 summation noise and the tokens and lengths those of one
    process."""
    from m3p_tpu_torch.model import lengths_to_mask
    from m3p_tpu_torch.model.generation import beam_search, greedy_generate

    rng = np.random.RandomState(10)
    feats = rng.randn(2, REGIONS, 2048).astype(np.float32)
    locs = rng.rand(2, REGIONS, 5).astype(np.float32)
    img_len = np.array([REGIONS, 5], np.int64)
    ranks = pools(4).run("sharded_decode", cfg_dict=small["cfg"],
                         state=small["state"],
                         mesh_axes={"fsdp": 2, "tensor": 2}, feats=feats,
                         locs=locs, img_len=img_len, max_len=6, beam=2)
    model = build_model(ModelConfig(**small["cfg"]), 0, "cpu")
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in small["state"].items()})
    mask = lengths_to_mask(torch.tensor(img_len), REGIONS)
    with torch.no_grad():
        enc = model.encode_image(torch.tensor(feats), torch.tensor(locs),
                                 mask)
        greedy = greedy_generate(model, enc, mask, 6)
        beams = beam_search(model, enc, mask, 2, 6)
    for r in ranks:
        np.testing.assert_allclose(r["enc"], enc.numpy(), rtol=0,
                                   atol=2e-5)
        for got, want in ((r["greedy"], greedy), (r["beam"], beams)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w.numpy())


def test_mesh_groups_span_tuples_of_axes(monkeypatch):
    """A group over a tuple of axes is the line of ranks that differ only
    in those axes, in row-major order of their coordinates; axes of size 1
    drop out of it."""
    import torch.distributed as dist

    from m3p_tpu_torch.parallel import mesh as M

    monkeypatch.setattr(dist, "new_group",
                        lambda ranks, backend=None: tuple(ranks))
    mesh = M.Mesh((2, 2, 1, 2, 1, 1), 5, torch.device("cpu"), "gloo")
    assert mesh.group(("data", "fsdp")) == (1, 3, 5, 7)
    assert mesh.index(("data", "fsdp")) == 2 == mesh.batch_shards[0]
    assert mesh.count(("data", "fsdp", "seq")) == 4
    assert mesh.group(("fsdp", "tensor", "expert")) == (4, 5, 6, 7)
    assert mesh.group(("tensor", "expert")) == mesh.group("tensor") == (4, 5)
    assert mesh.group(("seq", "expert")) is None
