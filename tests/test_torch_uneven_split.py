"""Heads that do not divide by ``tensor`` and experts that do not divide by
``expert`` on the port's mesh, against the JAX package's one-process
functions on the CPU.

A rank holds ceil(H / t) whole heads (the last ranks maybe none) and its
ceil(D / t) padded columns of the Q/K/V and output projections, as GSPMD
holds them; the attention reshards the columns to the heads and back
(`parallel.tensor_parallel.columns_to_heads` / `heads_to_columns`).  A
rank of ``expert`` holds ceil(E / n) padded experts.  The ranks are gloo
processes (`test_torch_ranks.RankPool`, pools of 3 and 4); the JAX side
runs in this process with XLA's optimizations off, as in
`test_torch_sharding.py`, whose models, reference steps and tolerances
this file reuses: losses within 1e-5 relative and parameters after one
Adam step within rtol 1e-4, atol 1e-6 of JAX; gradients (SGD at lr 1)
within 1e-4 of a leaf's largest entry; the port on ranks against the port
in one process within 1e-5 (`TOL_ONE`).

* (a) the MCT step, 4 heads of 16 over tensor 3: columns 22 / 22 / 20 and
  2 of padding, heads 2 / 2 / 0;
* (b) 6 heads of 8 over tensor 4: columns even, heads 2 / 2 / 2 / 0 (the
  shape of 12 heads over tensor 8), the ITM step against JAX, and at
  dropout and attention dropout 0.1 against one process;
* (c) seq 2 x tensor 2 over 3 heads, the xMLM step through the ring;
* (d) pp 2 x tensor 2 over 3 heads, the pipelined ITM step's gradients;
* (e) the fused int8 Q/K/V (``int8_all``) and the ``int8_infer`` tables
  over tensor 3 at module level against JAX's int8 functions on the whole
  operands at 1e-6;
* (f) greedy and beam-2 captions on tensor 3, token for token;
* (g) MoE with 3 experts on data 2 x expert 2 and 6 experts on expert 4
  (one rank without an expert);
* (h) the checkpoint round trip sharded -> one process -> sharded on
  tensor 3, bitwise;
* (i) planted faults each break the equality: every rank calling the
  kernels with head_base 0 at dropout 0.1, and either half of the
  reshard's backward without its collective.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu.data import masking as jax_masking
from m3p_tpu.data import synthetic as jax_synthetic
from m3p_tpu.model import capture_q8 as jax_capture_q8
from m3p_tpu.model import generation as jgen
from m3p_tpu.model import quantized_inference_model as jax_quantized
from m3p_tpu.model.transformer import lengths_to_mask as jax_lengths_to_mask
from m3p_tpu.ops import quant as jquant
from m3p_tpu.train import steps as jax_steps
from m3p_tpu_torch.checkpoint import params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.parallel import sharding as SH
from m3p_tpu_torch.parallel.tensor_parallel import head_layout
from m3p_tpu_torch.train import optim
from m3p_tpu_torch.train import steps as S
from m3p_tpu_torch.train.state import create_train_state
from test_torch_sharding import (  # noqa: F401  (fixtures)
    REGIONS, SAMPLE_N, SPEC, TOL_ONE, _built, _compare, _compare_gradients,
    _itm_loss, _jax_cfg, _jax_draws, _jax_step, _mct, _retrieval_batch,
    pools, quick_jax_compiles)

torch.set_num_threads(1)

MASK_KW = dict(max_pred=4, n_words=512, mask_index=511)


def _model(**kw):
    """A small model of ``kw``, its parameters drawn by the port (JAX's
    init would compile for seconds)."""
    return _built(_jax_cfg(**kw), from_port=True)


@pytest.fixture(scope="module")
def four_heads():
    return _model()


@pytest.fixture(scope="module")
def six_heads():
    return _model(emb_dim=48, n_heads=6)


@pytest.fixture(scope="module")
def three_heads():
    return _model(emb_dim=48, n_heads=3)


def _port(built, **change):
    model = build_model(ModelConfig(**dict(built["cfg"], **change)), 0,
                        "cpu")
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in built["state"].items()})
    return model


def test_head_layout_is_the_padded_layout_of_heads():
    """ceil(H / t) heads a rank from the first rank on, the last ranks
    maybe none; a rank's padded columns ceil(H * Dh / t); no reshard where
    t divides H."""
    from m3p_tpu_torch.parallel.mesh import Mesh

    def layouts(h, t, dh=64):
        out = []
        for r in range(t):
            mesh = Mesh.__new__(Mesh)
            mesh.shape = {"tensor": t}
            mesh.coords = {"tensor": r}
            out.append(head_layout(mesh, h, dh))
        return out

    got = layouts(12, 8)
    assert [(l.base, l.n) for l in got] == [(0, 2), (2, 2), (4, 2), (6, 2),
                                            (8, 2), (10, 2), (12, 0),
                                            (12, 0)]
    assert {l.width for l in got} == {96} and got[0].resharded
    assert got[5].columns == slice(640, 768) and got[7].columns == slice(
        768, 768)
    assert [l.n for l in layouts(4, 3, 16)] == [2, 2, 0]
    assert {l.width for l in layouts(4, 3, 16)} == {22}
    assert [l.n for l in layouts(12, 5)] == [3, 3, 3, 3, 0]
    assert not any(l.resharded for l in layouts(12, 4))
    assert [(l.base, l.n) for l in layouts(12, 4)] == [(0, 3), (3, 3),
                                                       (6, 3), (9, 3)]


# ---------------------------------------------------------------------------
# (a)-(d) the steps
# ---------------------------------------------------------------------------


def test_mct_step_with_four_heads_over_tensor_three_matches_jax(
        pools, four_heads):
    """(a) Columns 22 / 22 / 20 + 2 padding, heads 2 / 2 / 0: the MCT step
    on the global batch is JAX's one-process step, and the padding of the
    parameters, gradients and moments stays 0."""
    batch = jax_synthetic.make_pretrain_batch(np.random.RandomState(31), 4,
                                              SAMPLE_N, 10, REGIONS, 512)
    ranks, want, jm = _mct(four_heads, batch, MASK_KW, REGIONS, pools, 3,
                           {"tensor": 3})
    _compare(ranks, want, float(jm["loss"]), float(jm["grad_norm"]),
             "tensor 3")
    assert all(r["pad_max"] == 0.0 for r in ranks)


def test_itm_step_with_six_heads_over_tensor_four_matches_jax(pools,
                                                              six_heads):
    """(b) The shape of 12 heads over tensor 8: even columns (12 a rank),
    heads 2 / 2 / 2 / 0, so even the ranks that hold whole heads' columns
    reshard."""
    batch = _retrieval_batch(32)
    wait = pools(4).submit("sharded_step", cfg_dict=six_heads["cfg"],
                           state=six_heads["state"], kind="itm", batch=batch,
                           mesh_axes={"tensor": 4}, spec=SPEC, clip=0.05)
    want, jm = _jax_step(six_heads, _itm_loss(six_heads["jm"]), batch,
                         clip=0.05)
    _compare(wait(), want, float(jm["loss"]), float(jm["grad_norm"]),
             "tensor 4")


def _one_process_dropout_step(built, batch, seed):
    """The port's ITM step in one process at dropout and attention dropout
    0.1 from generators of ``seed``."""
    model = _port(built, dropout=0.1, attention_dropout=0.1)
    tx, _ = optim.build_optimizer(SPEC)
    state = create_train_state(model, tx)
    step = S.make_train_step(lambda m, b, g: S.itm_finetune_loss(
        m, b, g, SAMPLE_N, deterministic=False), with_grad_norm=True)
    _, metrics = step(state, {k: torch.tensor(v) for k, v in batch.items()},
                      Generators.from_seed(seed, "cpu"))
    return metrics, {n: p.detach().numpy()
                     for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def six_heads_dropout(six_heads):
    batch = _retrieval_batch(33)
    metrics, want = _one_process_dropout_step(six_heads, batch, 17)
    args = dict(cfg_dict=dict(six_heads["cfg"], dropout=0.1,
                              attention_dropout=0.1),
                state=six_heads["state"], kind="itm", batch=batch,
                mesh_axes={"tensor": 4}, spec=SPEC, seed=17)
    return args, metrics, want


def test_six_heads_over_tensor_four_at_dropout_is_the_one_process_step(
        pools, six_heads_dropout):
    """(b) at dropout and attention dropout 0.1: each rank's heads draw
    their masks by their index among all 6 (head_base 0, 2, 4), the rank
    without heads draws none, and the step is the one process's."""
    args, metrics, want = six_heads_dropout
    ranks = pools(4).run("sharded_step", **args)
    _compare(ranks, want, metrics["loss"].item(),
             metrics["grad_norm"].item(), "tensor 4 dropout", TOL_ONE)


def test_seq_by_tensor_with_three_heads_through_the_ring_matches_jax(
        pools, three_heads):
    """(c) The xMLM step sequence-parallel over seq 2 with 3 heads over
    tensor 2 (heads 2 / 1): the ring takes each rank's resharded heads."""
    batch = jax_synthetic.make_stream_batch(np.random.RandomState(34), 4, 15,
                                            512)
    key = jax.random.PRNGKey(5)
    tokens = jnp.asarray(batch["tokens"])
    jmask = jax_masking.MaskingConfig(**MASK_KW)
    masking = [np.asarray(x) for x in jax_masking.mask_tokens(
        jax.random.split(key)[0], tokens,
        jax_lengths_to_mask(jnp.asarray(batch["lengths"]), tokens.shape[1]),
        jmask)]
    wait = pools(4).submit("sharded_step", cfg_dict=three_heads["cfg"],
                           state=three_heads["state"], kind="mlm",
                           batch=batch, mesh_axes={"seq": 2, "tensor": 2},
                           spec=SPEC, draws={"masking": masking},
                           mask_cfg=MASK_KW)
    want, jm = _jax_step(three_heads, lambda p, b, k: jax_steps.mlm_loss(
        three_heads["jm"], p, b, k, jmask, deterministic=True), batch, key=5)
    _compare(wait(), want, float(jm["mlm"]), float(jm["grad_norm"]),
             "seq 2 x tensor 2")


def test_pp_by_tensor_with_three_heads_matches_jax(pools, three_heads):
    """(d) The pipelined ITM step on pp 2 x tensor 2, 3 heads (2 / 1), 2
    microbatches: its loss and every gradient leaf (gathered whole) are
    JAX's one-process step's (SGD at lr 1: the move is the gradient)."""
    batch = _retrieval_batch(35)
    wait = pools(4).submit("pp_itm_step", cfg_dict=three_heads["cfg"],
                           state=three_heads["state"], batch=batch,
                           mesh_axes={"pp": 2, "tensor": 2}, n_micro=2)
    want, jm = _jax_step(three_heads, lambda p, b, k: jax_steps.
                         itm_finetune_loss(three_heads["jm"], p, b, k,
                                           SAMPLE_N, refine_image=True,
                                           deterministic=True),
                         batch, spec="sgd,lr=1.0")
    before = three_heads["state"]
    for r in wait():
        np.testing.assert_allclose(r["loss"], float(jm["loss"]), rtol=1e-5)
        for name, w in want.items():
            move = before[name] - np.asarray(w)
            got = r["grads"].get(name, np.zeros_like(move))
            tol = 1e-6 + 1e-4 * float(np.abs(move).max())
            err = float(np.abs(got - move).max())
            assert err <= tol, f"pp x tensor {name}: {err} > {tol}"


# ---------------------------------------------------------------------------
# (e) the int8 modules over tensor 3
# ---------------------------------------------------------------------------


def _padded_part(a, axis, i, k, blocks=1):
    """Rank ``i`` of ``k``'s part of each of ``blocks`` blocks of ``a``
    along ``axis`` in the padded layout, the padding zeros."""
    out = []
    for b in np.split(a, blocks, axis=axis):
        n = b.shape[axis]
        w = -(-n // k)
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, w * k - n)
        out.append(np.take(np.pad(b, pad), range(i * w, (i + 1) * w),
                           axis=axis))
    return np.concatenate(out, axis=axis)


@functools.lru_cache(maxsize=None)
def _int8_model(quant):
    jcfg = _jax_cfg(ffn_quant=quant)
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0, "cpu")
    return {"cfg": dataclasses.asdict(jcfg),
            "state": {k: v.numpy() for k, v in model.state_dict().items()}}


def _qkv_kernel(st):
    return np.concatenate([st[f"block_0.attn.{n}.weight"].T
                           for n in ("q_lin", "k_lin", "v_lin")], axis=1)


def _int8_want(case, st, x, g):
    """JAX's function on the whole operands: for each output, (the whole
    array, how a rank holds it: ("cols" / "rows", blocks) or "whole")."""
    if case == "q8_lin2":
        y = jquant.int8_matmul_pre(x, *jquant.prequantize_nn(
            st["block_0.ffn.lin2.weight"].T))
        return {"y": (np.asarray(y), "whole")}
    if case == "q8_qkv":
        y = jquant.int8_matmul_pre(x, *jquant.prequantize_nn(
            _qkv_kernel(st)))
        return {"y": (np.asarray(y), ("cols", 3))}
    bias = np.concatenate([st[f"block_0.attn.{n}.bias"]
                           for n in ("q_lin", "k_lin", "v_lin")])

    def run(x, w, g):
        y, vjp = jax.vjp(lambda x, w: jquant.int8_matmul_qbwd(x, w) + bias,
                         x, w)
        return (y,) + vjp(g)

    y, dx, dw = (np.asarray(a) for a in jax.jit(run)(x, _qkv_kernel(st), g))
    return {"y": (y, ("cols", 3)), "dx": (dx, "sum"),
            "dw": (dw.T, ("rows", 3))}


def _int8_gap(ranks, want, k=3):
    worst = 0.0
    for key, (whole, how) in want.items():
        scale = float(np.abs(whole).max())
        if how == "sum":
            got = sum(r[key] for r in ranks)
            worst = max(worst, float(np.abs(got - whole).max()) / scale)
            continue
        for i, r in enumerate(ranks):
            ref = whole if how == "whole" else _padded_part(
                whole, 1 if how[0] == "cols" else 0, i, k, how[1])
            worst = max(worst, float(np.abs(r[key] - ref).max()) / scale)
    return worst


@pytest.mark.parametrize("case", [("qkv", "int8_all", ("amax_local",)),
                                  ("q8_qkv", "none", ()),
                                  ("q8_lin2", "none", ("amax_local",))],
                         ids=lambda c: c[0])
def test_int8_module_over_tensor_three_is_jax_on_the_whole(pools, case):
    """(e) The fused int8 Q/K/V under ``int8_all`` and the frozen-weight
    int8 tables (the fused Q/K/V table, column-parallel; lin2's,
    row-parallel) over tensor 3, each of Q, K and V in 22 / 22 / 20 + 2
    padded columns: every scale is the whole tensor's, so each rank's part
    is JAX's function on the whole operands up to the fp32 sums of the
    ranks' parts (1e-6 of the largest entry), its padding zeros; an amax
    that ``tensor`` splits taken rank-local moves some output by more
    than 1e-3."""
    name, quant, faults = case
    built = _int8_model(quant)
    rng = np.random.RandomState(36)
    k, n = (256, 64) if name == "q8_lin2" else (64, 192)
    x = (rng.randn(16, k) * rng.uniform(0.1, 3.0, (16, 1))).astype(
        np.float32)
    g = (rng.randn(16, n) * rng.uniform(0.1, 3.0, (16, 1))).astype(
        np.float32)
    wait = pools(3).submit("int8_modules", cfg_dict=built["cfg"],
                           state=built["state"], case=name, x=x,
                           g=g if name == "qkv" else None,
                           faults=(None,) + faults,
                           mesh_axes={"tensor": 3})
    want = _int8_want(name, built["state"], x, g)
    runs = wait()
    assert [r[0]["coords"]["tensor"] for r in runs] == [0, 1, 2]
    gap = _int8_gap([r[0] for r in runs], want)
    assert gap <= 1e-6, gap
    for i, fault in enumerate(faults, 1):
        bad = _int8_gap([r[i] for r in runs], want)
        assert bad > 1e-3, (fault, bad)


# ---------------------------------------------------------------------------
# (f) decoding, (g) MoE, (h) checkpoints
# ---------------------------------------------------------------------------


def test_decoding_on_tensor_three_is_jax_s_token_for_token(pools,
                                                           four_heads):
    """(f) Greedy and beam-2 captions on tensor 3: the decode caches hold
    2 / 2 / 0 heads, cross-attention projects the source once and
    reshards it; the tokens and lengths are JAX's."""
    rng = np.random.RandomState(37)
    feats = rng.randn(2, REGIONS, 2048).astype(np.float32)
    locs = rng.rand(2, REGIONS, 5).astype(np.float32)
    img_len = np.array([REGIONS, 5], np.int64)
    wait = pools(3).submit("sharded_decode", cfg_dict=four_heads["cfg"],
                           state=four_heads["state"],
                           mesh_axes={"tensor": 3}, feats=feats, locs=locs,
                           img_len=img_len, max_len=6, beam=2)
    jm, params = four_heads["jm"], four_heads["params"]
    mask = jax_lengths_to_mask(jnp.asarray(img_len), REGIONS)
    enc = jax.jit(lambda p, f, lo, m: jm.apply(
        {"params": p}, f, lo, m, method=jm.encode_image))(
        params, jnp.asarray(feats), jnp.asarray(locs), mask)
    greedy = jgen.greedy_generate(jm, params, enc, mask, 6)
    beams = jgen.beam_search(jm, params, enc, mask, 2, 6)
    for r in wait():
        np.testing.assert_allclose(r["enc"], np.asarray(enc), rtol=0,
                                   atol=2e-5)
        for got, want in ((r["greedy"], greedy), (r["beam"], beams)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("experts,mesh_axes", [
    (3, {"data": 2, "expert": 2}), (6, {"expert": 4})],
    ids=["3_over_data2_expert2", "6_over_expert4"])
def test_moe_with_experts_that_do_not_divide_matches_jax(pools, experts,
                                                         mesh_axes):
    """(g) 3 experts over expert 2 (2 / 1) and 6 over expert 4 (2 / 2 / 2
    / 0: a rank that holds padding alone adds zeros): the ITM step on the
    global batch is JAX's, the padded experts' parameters, gradients and
    moments stay 0."""
    built = _model(moe_experts=experts, moe_interval=2)
    batch = _retrieval_batch(38)
    wait = pools(4).submit("sharded_step", cfg_dict=built["cfg"],
                           state=built["state"], kind="itm", batch=batch,
                           mesh_axes=mesh_axes, spec=SPEC)
    want, jm = _jax_step(built, _itm_loss(built["jm"]), batch)
    ranks = wait()
    _compare(ranks, want, float(jm["loss"]), float(jm["grad_norm"]),
             f"moe {experts}")
    assert all(r["pad_max"] == 0.0 for r in ranks)


def test_checkpoint_round_trip_on_tensor_three_is_bitwise(pools, four_heads,
                                                          tmp_path):
    """(h) A state saved on tensor 3 (4 heads: uneven columns and heads) is
    one process's format: one process restores it bitwise, and tensor 3
    restores one process's save bitwise."""
    from m3p_tpu_torch import checkpoint as ckpt

    path = str(tmp_path / "tensor3")
    saved = pools(3).run("checkpoint_trip", cfg_dict=four_heads["cfg"],
                         state=four_heads["state"], mesh_axes={"tensor": 3},
                         path=path)
    model = _port(four_heads)
    one = create_train_state(model, optim.build_optimizer(SPEC)[0])
    one, _ = ckpt.restore_checkpoint(path, one)
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), saved[0]["model"][name])
    for key in ("mu", "nu"):
        for a, b in zip(one.opt_state[key], saved[0][key]):
            np.testing.assert_array_equal(a.numpy(), b)
    path1 = str(tmp_path / "one")
    ckpt.save_checkpoint(path1, one, {"epoch": 4})
    back = pools(3).run("checkpoint_trip", cfg_dict=four_heads["cfg"],
                        state=four_heads["state"], mesh_axes={"tensor": 3},
                        path=path1, save=False)
    for r in back:
        for name, t in model.state_dict().items():
            np.testing.assert_array_equal(r["model"][name], t.numpy())
        for key in ("mu", "nu"):
            for a, b in zip(one.opt_state[key], r[key]):
                np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# (i) planted faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["head_base_0", "heads_to_columns_local",
                                   "columns_to_heads_local"])
def test_planted_faults_break_the_equality(pools, six_heads_dropout, fault):
    """(i) Each fault on (b)'s tensor-4 step at dropout 0.1: every rank
    calling the kernels with head_base 0 draws other heads' masks, and
    the reshard's backward without its all-gather (`heads_to_columns`) or
    its reduce-scatter (`columns_to_heads`) loses the other ranks' parts
    of a gradient; each moves the loss or a parameter by more than 1e-3
    of the one-process step, 100 times the tolerance the good step
    meets."""
    args, metrics, want = six_heads_dropout
    bad = pools(4).run("sharded_step", fault=fault, **args)[0]
    loss = metrics["loss"].item()
    off = max(abs(bad["loss"] - loss) / abs(loss),
              max(float(np.abs(bad["params"][n] - w).max())
                  / max(float(np.abs(w).max()), 1e-2)
                  for n, w in want.items()))
    assert off > 1e-3, (fault, off)


def test_the_checks_refuse_only_what_the_jax_stage_refuses():
    """`check_model_supported` takes heads and experts that do not divide
    on every mesh; the modules take them too."""
    from m3p_tpu_torch.model.layers import MoEFFN, MultiHeadAttention
    from m3p_tpu_torch.parallel.mesh import Mesh

    cfg = ModelConfig(**dataclasses.asdict(_jax_cfg(n_heads=4)))
    SH.check_model_supported(cfg, {"tensor": 3})
    SH.check_model_supported(cfg, {"pp": 2, "tensor": 3})
    SH.check_model_supported(dataclasses.replace(cfg, moe_experts=6),
                             {"expert": 4})
    mesh = Mesh.__new__(Mesh)
    mesh.shape = {"tensor": 8, "expert": 4}
    mesh.coords = {"tensor": 7, "expert": 3}
    attn = MultiHeadAttention(12, 768)
    attn.tensor_parallel(mesh)
    assert (attn.n_heads, attn.head_base, attn.heads_total) == (0, 12, 12)
    moe = MoEFFN(16, 32, 6)
    moe.parallel(mesh)
    assert (moe.expert_lo, moe.n_local) == (6, 0)
