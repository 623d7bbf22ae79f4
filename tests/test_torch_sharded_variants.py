"""The configurations that sharding refused before (the int8 modes and the
adaptive softmax under ``tensor``, int8 tables over sharded parameters,
uneven splits) against the JAX package's one-process step on the CPU.

The port's ranks are gloo processes (`test_torch_ranks.RankPool`); the
JAX side runs in this process, compiled with XLA's optimizations off, as
`test_torch_sharding.py` runs it (its pools, models and reference steps
are reused).  fp32, small width, depth 2.  The float steps (the adaptive
softmax, the uneven vocabulary) are held as `test_torch_sharding.py`
holds them: the loss within 1e-5 relative and the parameters after one
Adam step within rtol 1e-4, atol 1e-6; the int8 steps to one int8 step's
effect (`INT8_STEP_TOL`).

* fault 16: on data 2 the int8 wgrads quantize along the global batch's
  tokens (the parent took each rank's rows, which a planted fault
  replays); on data 2 x seq 2 the rows of each sequence shard, over both
  data ranks, as JAX's sequence-parallel blocks (`shard_map` manual over
  ``seq``) take them.  The seq rule is held at the GEMM, against JAX's
  function on each sequence shard's rows: JAX's own sequence-parallel
  step does not run under ``int8_bwd`` (its custom VJP inside the
  `shard_map` returns a wgrad that varies over ``seq`` and raises);
* each int8 training GEMM on its mesh, and each int8 module as the
  sharded model wires it (the FFN's column- and row-parallel GEMMs, the
  fused Q/K/V, the word head on vocabulary shards, a row-parallel
  frozen-weight table) on data 2 x tensor 2, takes the whole tensors'
  scales: its outputs are JAX's on the whole operands up to the fp32 sums
  of the ranks' parts, and the amaxes taken rank-local (planted faults)
  break the equality;
* ``int8_bwd`` FFN + head and ``int8_all`` on fsdp 2 x tensor 2, "int8" on
  tensor 2, the adaptive softmax on tensor 2 (the int8 steps are held to
  one int8 step's effect, which a wrong scale stays within: the scales are
  held at the GEMMs and modules above);
* a 514-word vocabulary over tensor 4 (shards of 129, the last padded):
  the step, the padding's zero parameters, gradients and moments, and a
  checkpoint from tensor 4 read back on fsdp 2 x tensor 2 and in one
  process;
* `capture_q8` on fsdp 2 x tensor 2: each rank's tables are its slice of
  JAX's collection bit for bit, at most half its bytes, and the greedy
  captions JAX's token for token.
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
from m3p_tpu.model import quantized_inference_model as jax_quantized
from m3p_tpu.model import generation as jgen
from m3p_tpu.model.transformer import lengths_to_mask as jax_lengths_to_mask
from m3p_tpu.ops import quant as jquant
from m3p_tpu.train import steps as jax_steps
from m3p_tpu_torch.checkpoint import params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.parallel import sharding as SH
from test_torch_sharding import (  # noqa: F401  (fixtures)
    REGIONS, SAMPLE_N, SPEC, _built, _compare, _itm_loss, _jax_cfg,
    _jax_draws, _jax_step, _retrieval_batch, pools, quick_jax_compiles)

torch.set_num_threads(1)

MASK_KW = dict(max_pred=4, n_words=512, mask_index=511)


def _int8(**kw):
    """A small model of ``kw``, its parameters drawn by the port (JAX's
    init would compile for seconds)."""
    return _built(_jax_cfg(**kw), from_port=True)


@pytest.fixture(scope="module")
def int8_bwd():
    return _int8(ffn_quant="int8_bwd", head_quant="int8_bwd")


def _pretrain_batch(seed):
    return jax_synthetic.make_pretrain_batch(np.random.RandomState(seed), 4,
                                             SAMPLE_N, 10, REGIONS, 512)


# ---------------------------------------------------------------------------
# the int8 GEMMs on ranks: exact scales (fault 16 and the tensor splits)
# ---------------------------------------------------------------------------


def _operands(case):
    """x, w and g of one GEMM, fp32, each row of x and g at its own scale
    so that a rank's rows hold other column maxima than the whole."""
    rng = np.random.RandomState(21)
    m, k, n = 16, 24, 36
    if case == "seq":
        x = rng.randn(4, 6, k) * rng.uniform(0.1, 3.0, (4, 6, 1))
        g = rng.randn(4, 6, n) * rng.uniform(0.1, 3.0, (4, 6, 1))
    else:
        x = rng.randn(m, k) * rng.uniform(0.1, 3.0, (m, 1))
        g = rng.randn(m, n) * rng.uniform(0.1, 3.0, (m, 1))
    w = rng.randn(k, n) * rng.uniform(0.1, 3.0, (1, n))
    if case in ("nt_rows", "nt_vocab"):
        n = 37 if case == "nt_vocab" else n    # 19 + 18 rows over tensor 2
        w = rng.randn(n, k) * rng.uniform(0.1, 3.0, (n, 1))
        g = rng.randn(m, n) * rng.uniform(0.1, 3.0, (m, 1))
    return [a.astype(np.float32) for a in (x, w, g)]


def _jax_vjp(fn, x, w, g):
    """y, dx, dw of the jitted JAX function (XLA multiplies by 1 / 127, as
    the port does)."""
    def run(x, w, g):
        y, vjp = jax.vjp(fn, x, w)
        return (y,) + vjp(g)

    return [np.asarray(a) for a in jax.jit(run)(x, w, g)]


def _want(case, x, w, g):
    """What each rank must hold, from JAX's functions on the whole
    operands: (y, dx, dw) as ("rank" part, "sum" over ranks)."""
    fn = {"nt_rows": jquant.int8_matmul_nt, "nt_vocab": jquant.int8_matmul_nt,
          "st_row": jquant.int8_matmul}.get(case, jquant.int8_matmul_qbwd)
    if case == "seq":
        # per sequence shard, over every row of the batch (JAX's blocks
        # in a shard_map manual over seq alone)
        dw = sum(_jax_vjp(fn, x[:, q * 3:(q + 1) * 3].reshape(-1, 24), w,
                          g[:, q * 3:(q + 1) * 3].reshape(-1, 36))[2]
                 for q in range(2))
        return {"dw": ("sum", dw)}
    y, dx, dw = _jax_vjp(fn, x, w, g)
    if case in ("rows", "nt_rows"):
        return {"y": ("rows", y), "dx": ("rows", dx), "dw": ("sum", dw)}
    if case == "col":
        return {"y": ("cols", y), "dx": ("sum", dx), "dw": ("cols", dw)}
    if case in ("row", "st_row"):
        return {"y": ("sum", y), "dx": ("cols", dx), "dw": ("rows", dw)}
    return {"y": ("cols", y), "dx": ("sum", dx), "dw": ("rows", dw)}


def _rank_part(how, a, i, k=2):
    if how == "rows":
        return np.array_split(a, k, axis=0)[i]
    return np.array_split(a, k, axis=1)[i]


def _gap(ranks, want):
    """The largest difference to JAX of any output, relative to its
    largest entry."""
    worst = 0.0
    for key, (how, w) in want.items():
        scale = float(np.abs(w).max())
        if how == "sum":
            got = sum(r[key] for r in ranks)
            worst = max(worst, float(np.abs(got - w).max()) / scale)
            continue
        for i, r in enumerate(ranks):
            part = _rank_part(how, w, i)
            worst = max(worst, float(np.abs(r[key] - part).max()) / scale)
    return worst


@pytest.mark.parametrize("case", ["rows", "nt_rows", "seq", "col", "row",
                                  "st_row", "nt_vocab"])
def test_int8_gemm_on_ranks_takes_the_whole_tensors_scales(pools, case):
    """Each int8 training GEMM on its mesh against JAX's function on the
    whole operands: the quantized values are JAX's (every amax is the
    whole tensor's, or under ``seq`` the sequence shard's over every
    data rank), so the outputs differ only by the fp32 sums of the ranks'
    dequantized parts (1e-6 of the largest entry).  Fault 16 is "rows"
    and "nt_rows": the wgrads quantize along the tokens of both data
    ranks (the parent took each rank's own, planted here as ``fault``).
    Under ``seq`` a max over the sequence shards too (JAX's one-process
    rows) would read 100 times the tolerance.  Every amax taken
    rank-local moves some output by more than 1e-3."""
    x, w, g = _operands(case)
    n = 4 if case == "seq" else 2
    wait = pools(n).submit("int8_ops", case=case, x=x, w=w, g=g)
    want = _want(case, x, w, g)
    ranks = wait()
    assert _gap(ranks, want) <= 1e-6, case
    bad = pools(n).run("int8_ops", case=case, x=x, w=w, g=g, fault=True)
    assert _gap(bad, want) > 1e-3, case
    if case == "seq":
        whole = _jax_vjp(jquant.int8_matmul_qbwd, x.reshape(-1, 24), w,
                         g.reshape(-1, 36))[2]
        assert _gap(ranks, {"dw": ("sum", whole)}) > 1e-4


# ---------------------------------------------------------------------------
# the int8 modules as the sharded model wires them
# ---------------------------------------------------------------------------

# (module, the model's modes, the planted faults it must show): each module
# of the first block (and the word head) of a small model sharded over
# data 2 x tensor 2; the straight-through "int8" lin1 quantizes along K =
# embed alone, which no rank splits, so no fault can show there
MODULE_CASES = (
    ("lin1", {"ffn_quant": "int8_bwd"}, ("amax_local", "rows_local")),
    ("lin2", {"ffn_quant": "int8_bwd"}, ("amax_local", "rows_local")),
    ("lin1", {"ffn_quant": "int8"}, ()),
    ("lin2", {"ffn_quant": "int8"}, ("amax_local",)),
    ("qkv", {"ffn_quant": "int8_all"}, ("amax_local", "rows_local")),
    ("head", {"head_quant": "int8_bwd"}, ("amax_local", "rows_local")),
    ("q8_lin2", {}, ("amax_local",)))
_ROWS, _COLS = ("data", 1), ("tensor", 1)


@functools.lru_cache(maxsize=None)
def _module_model(kw):
    """The port's small model of ``kw`` (seed 0): its config and state."""
    jcfg = _jax_cfg(**dict(kw))
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0, "cpu")
    return {"cfg": dataclasses.asdict(jcfg),
            "state": {k: v.numpy() for k, v in model.state_dict().items()}}


def _module_want(case, built, x, g):
    """JAX's function on the whole operands of the module ``case``: for
    each output, (the whole array, the mesh axis and block count that
    split each of its dimensions, the axes over which the ranks' parts
    are summed)."""
    st = built["state"]

    def kernel(name):
        return st[f"block_0.{name}.weight"].T

    if case == "q8_lin2":
        y = jquant.int8_matmul_pre(x, *jquant.prequantize_nn(
            kernel("ffn.lin2")))
        return {"y": (np.asarray(y), (_ROWS, None), ())}
    fn = jquant.int8_matmul_qbwd
    if case in ("lin1", "lin2"):
        if built["cfg"]["ffn_quant"] == "int8":
            fn = jquant.int8_matmul
        w, bias = kernel(f"ffn.{case}"), st[f"block_0.ffn.{case}.bias"]
    elif case == "qkv":
        names = ("attn.q_lin", "attn.k_lin", "attn.v_lin")
        w = np.concatenate([kernel(n) for n in names], axis=1)
        bias = np.concatenate([st[f"block_0.{n}.bias"] for n in names])
    else:
        fn = jquant.int8_matmul_nt
        w, bias = st["text_emb.word.weight"], st["pred_layer.bias"]
    y, dx, dw = _jax_vjp(lambda x, w: fn(x, w) + bias, x, w, g)
    if case != "head":
        dw = dw.T                            # the Dense's (N, K) layout
    split = ("tensor", 3) if case == "qkv" else _COLS
    if case == "lin2":
        return {"y": (y, (_ROWS, None), ()), "dx": (dx, (_ROWS, _COLS), ()),
                "dw": (dw, (None, _COLS), ("data",))}
    return {"y": (y, (_ROWS, split), ()), "dx": (dx, (_ROWS, None),
                                               ("tensor",)),
            "dw": (dw, (split, None), ("data",))}


def _module_gap(ranks, want):
    """The largest difference to JAX of any output, relative to its
    largest entry: the ranks' parts summed over the axes ``want`` names,
    each sum against its block of the whole."""
    worst = 0.0
    for key, (whole, dims, summed) in want.items():
        groups = {}
        for r in ranks:
            at = tuple((a, i) for a, i in sorted(r["coords"].items())
                       if a not in summed)
            groups.setdefault(at, []).append(r[key])
        for at, parts in groups.items():
            ref, coords = whole, dict(at)
            for axis, cut in enumerate(dims):
                if cut is not None:
                    ref = np.concatenate([
                        np.array_split(b, 2, axis=axis)[coords[cut[0]]]
                        for b in np.split(ref, cut[1], axis=axis)], axis=axis)
            worst = max(worst, float(np.abs(sum(parts) - ref).max()
                                     / np.abs(whole).max()))
    return worst


@pytest.mark.parametrize(
    "case", MODULE_CASES,
    ids=lambda c: "_".join([c[0]] + list(c[1].values()) or ["int8_infer"]))
def test_int8_module_on_data_by_tensor_is_jax_on_the_whole(pools, case):
    """Each int8 module as the sharded model wires it (the FFN's column-
    and row-parallel `QuantDense`s in "int8_bwd" and "int8", the fused
    Q/K/V under "int8_all", the word head under ``head_quant="int8_bwd"``
    on vocabulary shards, lin2's row-parallel frozen-weight table) on
    data 2 x tensor 2 against JAX's function on the whole operands: every
    scale is the whole tensor's, so the outputs differ by the fp32 sums of
    the ranks' parts alone (1e-6 of the largest entry).  Each amax that
    ``tensor`` splits taken rank-local, and each wgrad's amax over one
    data rank's rows (fault 16's parent), moves some output by more than
    1e-3."""
    name, kw, faults = case
    built = _module_model(tuple(sorted(kw.items())))
    rng = np.random.RandomState(22)
    k = {"lin2": 256, "q8_lin2": 256}.get(name, 64)
    n = {"lin1": 256, "qkv": 192, "head": 512}.get(name, 64)
    x = (rng.randn(16, k) * rng.uniform(0.1, 3.0, (16, 1))).astype(
        np.float32)
    g = (rng.randn(16, n) * rng.uniform(0.1, 3.0, (16, 1))).astype(
        np.float32)
    wait = pools(4).submit("int8_modules", cfg_dict=built["cfg"],
                           state=built["state"], case=name, x=x,
                           g=None if name == "q8_lin2" else g,
                           faults=(None,) + faults)
    want = _module_want(name, built, x, g)
    runs = wait()
    gap = _module_gap([r[0] for r in runs], want)
    assert gap <= 1e-6, gap
    for i, fault in enumerate(faults, 1):
        bad = _module_gap([r[i] for r in runs], want)
        assert bad > 1e-3, (fault, bad)


# ---------------------------------------------------------------------------
# fault 16 and the seq rule in the steps
# ---------------------------------------------------------------------------

# An upstream activation an ulp off (the frameworks, and the ranks against
# one process, sum in other orders) may land on the other side of a
# rounding boundary of an int8 step: one step of the int8 value moves a
# product's output by about s_a * s_b, and Adam at eps 1e-3 carries the
# move of a small gradient entry into its parameter.  So the int8 steps
# are held to one int8 step's effect: the loss within 2e-3 relative and
# each parameter leaf within 3e-2 of its largest entry (or of 1e-2); the
# port in one process reads up to 5.0e-4 (the ITM step under "int8") and
# 1.46e-2 (MCT under int8_bwd) from JAX at these inputs, and the sharded
# port reads what it reads.  The GEMMs' scales themselves are held
# exactly above.
INT8_LOSS_RTOL = 2e-3
INT8_STEP_TOL = 3e-2


def _step_gap(r, want):
    return max(float(np.abs(r["params"][n] - np.asarray(w)).max())
               / max(float(np.abs(np.asarray(w)).max()), 1e-2)
               for n, w in want.items())


def _compare_int8(ranks, want, loss, where):
    for r in ranks:
        assert abs(r["loss"] - loss) <= INT8_LOSS_RTOL * abs(loss), where
        assert set(r["params"]) == set(want), where
        gap = _step_gap(r, want)
        assert gap <= INT8_STEP_TOL, (where, gap)


@pytest.fixture(scope="module")
def int8_bwd_mct(int8_bwd):
    """JAX's one-process MCT step under ``int8_bwd`` (FFN and head) with
    the JAX coin and maskings, computed once for the meshes below."""
    batch = _pretrain_batch(13)
    loss_fn = functools.partial(
        jax_steps.mct_pretrain_loss, int8_bwd["jm"],
        mask_cfg=jax_masking.MaskingConfig(**MASK_KW), sample_n=SAMPLE_N,
        deterministic=True, pack_ratio=0.5, lambda_rel=1.0, lambda_mlm=1.0,
        lambda_mrm=1.0, lambda_mrfr=1.0, lambda_clcm=1.0)
    want, jm = _jax_step(int8_bwd, loss_fn, batch, key=7)
    draws = _jax_draws(batch, jax.random.PRNGKey(7), MASK_KW, REGIONS)
    return batch, draws, want, float(jm["loss"])


@pytest.mark.parametrize("mesh_axes", [{"data": 2},
                                       {"fsdp": 2, "tensor": 2}],
                         ids=["data2", "fsdp2_tensor2"])
def test_int8_bwd_mct_step_matches_jax(pools, int8_bwd, int8_bwd_mct,
                                       mesh_axes):
    """``int8_bwd`` (FFN and head) in the MCT step against JAX's
    one-process step on the global batch: on data 2 the wgrads' rows are
    both ranks' (fault 16); on fsdp 2 x tensor 2 the FFN's and the vocab
    head's amaxes span the tensor ranks."""
    batch, draws, want, loss = int8_bwd_mct
    ranks = pools(int(np.prod(list(mesh_axes.values())))).run(
        "sharded_step", cfg_dict=int8_bwd["cfg"], state=int8_bwd["state"],
        kind="mct", batch=batch, mesh_axes=mesh_axes, spec=SPEC,
        draws=draws, mask_cfg=MASK_KW)
    _compare_int8(ranks, want, loss, str(mesh_axes))


# ---------------------------------------------------------------------------
# the int8 modes and the adaptive softmax under tensor
# ---------------------------------------------------------------------------


def _mlm(built, pools, mesh_axes, seed):
    """The xMLM step of a stream batch on the mesh and JAX's one-process
    step, the JAX masking fed to both: (ranks, JAX params, JAX
    metrics)."""
    n_words = built["jcfg"].n_words
    kw = dict(max_pred=4, n_words=n_words, mask_index=n_words - 1)
    batch = jax_synthetic.make_stream_batch(np.random.RandomState(seed), 4,
                                            15, n_words)
    key = jax.random.PRNGKey(5)
    tokens = jnp.asarray(batch["tokens"])
    jmask = jax_masking.MaskingConfig(**kw)
    masking = [np.asarray(x) for x in jax_masking.mask_tokens(
        jax.random.split(key)[0], tokens,
        jax_lengths_to_mask(jnp.asarray(batch["lengths"]), tokens.shape[1]),
        jmask)]
    wait = pools(int(np.prod(list(mesh_axes.values())))).submit(
        "sharded_step", cfg_dict=built["cfg"], state=built["state"],
        kind="mlm", batch=batch, mesh_axes=mesh_axes, spec=SPEC,
        draws={"masking": masking}, mask_cfg=kw)
    want, jm = _jax_step(built, lambda p, b, k: jax_steps.mlm_loss(
        built["jm"], p, b, k, jmask, deterministic=True), batch, key=5)
    return wait(), want, jm


@pytest.mark.parametrize("case", [
    ("int8_all", "itm", {"ffn_quant": "int8_all"}, {"fsdp": 2, "tensor": 2}),
    ("int8", "itm", {"ffn_quant": "int8"}, {"tensor": 2}),
    ("asm", "mlm", {"asm": True, "asm_cutoffs": (100, 300),
                    "share_inout_emb": False}, {"tensor": 2})],
    ids=lambda c: c[0])
def test_sharded_variant_step_matches_jax(pools, case):
    """A step on the mesh against JAX's one-process step: the int8 FFN
    modes' amaxes over ``tensor`` where it splits their axis and a
    row-parallel int8 product summed before its bias (ITM), the adaptive
    softmax's log-softmaxes over split vocabularies (xMLM)."""
    name, kind, kw, mesh_axes = case
    built = _int8(**kw)
    n = int(np.prod(list(mesh_axes.values())))
    if kind == "itm":
        batch = _retrieval_batch(13)
        wait = pools(n).submit("sharded_step", cfg_dict=built["cfg"],
                               state=built["state"], kind="itm",
                               batch=batch, mesh_axes=mesh_axes, spec=SPEC)
        want, jm = _jax_step(built, _itm_loss(built["jm"]), batch)
        ranks = wait()
    else:
        ranks, want, jm = _mlm(built, pools, mesh_axes, 13)
    loss = float(jm["loss" if "loss" in jm else "mlm"])
    if name == "asm":
        _compare(ranks, want, loss, float(jm["grad_norm"]), name)
    else:
        _compare_int8(ranks, want, loss, name)


# ---------------------------------------------------------------------------
# uneven splits
# ---------------------------------------------------------------------------


def test_vocab_that_does_not_divide_over_tensor_four(pools, tmp_path):
    """514 words over tensor 4: shards of 129, the last holding 127 words
    and 2 padding rows.  The xMLM step is JAX's one-process step, the
    padding stays zero in the parameters, gradients and Adam moments, and
    a checkpoint saved on tensor 4 has one process's shapes, restores
    bitwise in one process and on fsdp 2 x tensor 2."""
    from m3p_tpu_torch import checkpoint as ckpt
    from m3p_tpu_torch.train import optim
    from m3p_tpu_torch.train.state import create_train_state

    built = _int8(n_words=514, mask_index=513)
    ranks, want, jm = _mlm(built, pools, {"tensor": 4}, 14)
    _compare(ranks, want, float(jm["mlm"]), float(jm["grad_norm"]),
             "tensor 4 uneven")
    assert all(r["pad_max"] == 0.0 for r in ranks)
    path = str(tmp_path / "uneven")
    saved = pools(4).run("checkpoint_trip", cfg_dict=built["cfg"],
                         state=built["state"], mesh_axes={"tensor": 4},
                         path=path)
    model = build_model(ModelConfig(**built["cfg"]), 0, "cpu")
    one = create_train_state(model, optim.build_optimizer(SPEC)[0])
    one, _ = ckpt.restore_checkpoint(path, one)
    for name, t in model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), saved[0]["model"][name])
    back = pools(4).run("checkpoint_trip", cfg_dict=built["cfg"],
                        state=built["state"],
                        mesh_axes={"fsdp": 2, "tensor": 2}, path=path,
                        save=False)
    for r in back:
        for name, t in saved[0]["model"].items():
            np.testing.assert_array_equal(r["model"][name], t)
        for a, b in zip(saved[0]["mu"], r["mu"]):
            np.testing.assert_array_equal(a, b)


def test_check_model_supported_takes_every_uneven_split():
    """Every split off ``pp`` runs: the variants, a vocabulary, heads over
    ``tensor`` and experts over ``expert`` that do not divide."""
    cfg = ModelConfig(**dataclasses.asdict(_jax_cfg()))
    for change in ({"ffn_quant": "int8_all"}, {"head_quant": "int8_infer"},
                   {"asm": True}, {"n_words": 514}):
        SH.check_model_supported(dataclasses.replace(cfg, **change),
                                 {"fsdp": 2, "tensor": 4})
    SH.check_model_supported(cfg, {"tensor": 3})
    SH.check_model_supported(
        dataclasses.replace(cfg, moe_experts=3), {"expert": 2})


# ---------------------------------------------------------------------------
# int8 tables over sharded parameters
# ---------------------------------------------------------------------------


def _rank_slice(key, whole, t, k):
    """Rank ``t`` of ``k``'s part of a JAX q8 table: the column-parallel
    tables' output columns (the fused QKV's of each of Q, K and V), the
    row-parallel tables' K rows (their scales whole), the vocab table's
    rows."""
    def cut(a, axis, parts=1):
        pieces = np.split(a, parts, axis=axis)
        return np.concatenate([np.array_split(p, k, axis=axis)[t]
                               for p in pieces], axis=axis)

    leaf = key.rsplit("/", 1)[1]
    if leaf.startswith("qkv"):
        return cut(whole, 1, 3)
    if "/ffn/lin1/" in key:
        return cut(whole, 1)
    if leaf == "out_wq" or key.endswith("lin2/wq"):
        return cut(whole, 0)
    if leaf.startswith("emb"):
        return cut(whole, 0)
    return whole          # a row-parallel table's scales: whole


def test_capture_q8_over_fsdp_by_tensor_is_jax_s_tables_and_captions(
        pools, small):
    """`capture_q8` over sharded parameters: each rank's tables are its
    ``tensor`` slice of JAX's collection (gathered over ``fsdp``) with the
    whole weight's scales, bit for bit, at most half its bytes; the greedy
    captions through the sharded int8 copy are JAX's int8 model's."""
    rng = np.random.RandomState(15)
    feats = rng.randn(2, REGIONS, 2048).astype(np.float32)
    locs = rng.rand(2, REGIONS, 5).astype(np.float32)
    img_len = np.array([REGIONS, 5], np.int64)
    wait = pools(4).submit("sharded_q8", cfg_dict=small["cfg"],
                           state=small["state"],
                           mesh_axes={"fsdp": 2, "tensor": 2}, feats=feats,
                           locs=locs, img_len=img_len, max_len=6)
    jq = jax_quantized(small["jcfg"])
    q8 = jax_capture_q8(jq, small["params"])
    flat = {"/".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(q8)[0]}
    variables = {"params": small["params"], "q8": q8}
    mask = jax_lengths_to_mask(jnp.asarray(img_len), REGIONS)
    enc = jax.jit(lambda v, f, lo, m: jq.apply(
        v, f, lo, m, method=jq.encode_image))(
        variables, jnp.asarray(feats), jnp.asarray(locs), mask)
    want = jgen.greedy_generate(jq, variables, enc, mask, 6)
    ranks = wait()
    whole_bytes = sum(v.nbytes for v in flat.values())
    for r in ranks:
        assert sorted(r["tables"]) == sorted(flat)
        mine = {key: _rank_slice(key, w, r["tensor_index"], 2)
                for key, w in flat.items()}
        for key, w in mine.items():
            np.testing.assert_array_equal(r["tables"][key], w, err_msg=key)
        # half of every table, and the row-parallel tables' scales whole
        assert r["bytes"] == sum(w.nbytes for w in mine.values())
        assert r["bytes"] <= 0.51 * whole_bytes, (r["bytes"], whole_bytes)
        assert r["int8_gemms"] > 0
        for g, w in zip(r["greedy"], want):
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.fixture(scope="module")
def small():
    return _int8()
