"""The port's dynamic int8 training modes (`ops/quant.py`'s training GEMMs,
`QuantDense`, the fused int8 QKV, the AoA gate, the int8 word head) against
the JAX package's.

The three GEMMs' forward passes and int8 backward passes equal the JAX
functions as XLA compiles them (``jax.jit`` of ``jax.vjp``) bit for bit
on the CPU, in fp32 and bf16, at shapes that take every zero padding of
the operands (rows below 17, a contraction or a width that is not a
multiple of 8); the straight-through backward of `int8_matmul` (float
GEMMs summed in another order) agrees within ``TOL_ST``.  The modules
(`TransformerFFN` in each mode, the fused QKV, the AoA gate and the
refiner layer with ``quant``, `PredLayer` tied and untied) agree with the
JAX modules, outputs and every gradient, within ``TOL`` (fp32: the float
parts around the int8 GEMMs, GELU and the attention, sum in another
order; the integer parts are exact).  ``mct_pretrain_loss`` and every
gradient leaf under ``ffn_quant="int8_bwd"`` and ``head_quant="int8_bwd"``
agree with the jitted JAX loss within ``TOL_MODEL`` (see there)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.data import masking as jax_masking
from m3p_tpu.data import synthetic as jax_synthetic
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.model import embeddings as jemb
from m3p_tpu.model import heads as jheads
from m3p_tpu.model import layers as jlayers
from m3p_tpu.model.transformer import lengths_to_mask as jax_lengths_to_mask
from m3p_tpu.ops import quant as jquant
from m3p_tpu.train import steps as jax_steps
from m3p_tpu_torch.checkpoint import grads_from_jax, params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.data.masking import MaskingConfig
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.embeddings import AoAAttention, AoARefinerLayer
from m3p_tpu_torch.model.heads import PredLayer
from m3p_tpu_torch.model.layers import (
    MultiHeadAttention, QuantDense, TransformerFFN)
from m3p_tpu_torch.ops import quant
from m3p_tpu_torch.train.steps import mct_pretrain_loss

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# straight-through gradients: fp32 GEMMs over K <= 48 summed in another
# order
TOL_ST = dict(rtol=1e-5, atol=1e-5)
# fp32 modules around the int8 GEMMs: their float parts sum in another
# order, the integer parts are exact
TOL = dict(rtol=1e-4, atol=1e-5)
# (M, K, N): rows below 17; K and N off the multiple of 8; K and N on it
SHAPES = [(5, 24, 40), (37, 20, 30), (13, 16, 8), (64, 48, 24)]
GEMMS = {"int8_matmul": ((lambda k, n: (k, n)), quant.int8_matmul,
                         jquant.int8_matmul),
         "int8_matmul_qbwd": ((lambda k, n: (k, n)), quant.int8_matmul_qbwd,
                              jquant.int8_matmul_qbwd),
         "int8_matmul_nt": ((lambda k, n: (n, k)), quant.int8_matmul_nt,
                            jquant.int8_matmul_nt)}


def _np(x):
    if isinstance(x, jax.Array):
        return np.asarray(jnp.asarray(x, jnp.float32))
    return x.detach().float().numpy()


def _inputs(shape, dtype, seed, scale=2.5):
    a = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _jax_vjp(fn, *args):
    """(outputs, grads, cotangent) of ``fn`` at ``args``, jitted, against
    a fixed random cotangent."""
    out = jax.jit(fn)(*args)
    g = jnp.asarray(np.random.RandomState(99).randn(*out.shape),
                    out.dtype)
    grads = jax.jit(lambda *a: jax.vjp(fn, *a)[1](g))(*args)
    return out, grads, g


# ---------------------------------------------------------------------------
# the three GEMMs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(GEMMS))
def test_training_gemms_equal_the_jitted_jax_vjp(name, shape, dtype):
    """Forward and the int8 dgrad / wgrad bit for bit; the
    straight-through dgrad / wgrad of `int8_matmul` within TOL_ST (bf16:
    rounded alike)."""
    m, k, n = shape
    w_shape, mine, want = GEMMS[name]
    x, jx = _inputs((m, k), dtype, 1)
    w, jw = _inputs(w_shape(k, n), dtype, 2, 0.3)
    jout, (jdx, jdw), jg = _jax_vjp(want, jx, jw)
    x.requires_grad_()
    w.requires_grad_()
    out = mine(x, w)
    out.backward(torch.from_numpy(_np(jg)).to(out.dtype))
    assert out.dtype == x.dtype and out.shape == (m, n)
    np.testing.assert_array_equal(_np(out), _np(jout))
    assert x.grad.dtype == x.dtype and w.grad.shape == w.shape
    if name == "int8_matmul" and dtype == "float32":
        np.testing.assert_allclose(_np(x.grad), _np(jdx), **TOL_ST)
        np.testing.assert_allclose(_np(w.grad), _np(jdw), **TOL_ST)
    else:
        np.testing.assert_array_equal(_np(x.grad), _np(jdx))
        np.testing.assert_array_equal(_np(w.grad), _np(jdw))


def test_int8_matmul_takes_leading_dimensions():
    x, jx = _inputs((2, 7, 24), "float32", 3)
    w, jw = _inputs((24, 16), "float32", 4, 0.3)
    got = quant.int8_matmul(x, w)
    assert got.shape == (2, 7, 16)
    np.testing.assert_array_equal(_np(got),
                                  _np(jax.jit(jquant.int8_matmul)(jx, jw)))
    with pytest.raises(ValueError, match="2-D"):
        quant.int8_matmul_qbwd(x, w)


def test_training_gemms_count_calls_by_pass_and_route():
    """One integer GEMM a forward, two a backward of the int8 backward
    modes, none in the straight-through backward; on the CPU every GEMM
    takes the "cpu" route."""
    x = torch.randn(5, 20, requires_grad=True)
    w = torch.randn(20, 12, requires_grad=True)
    quant.zero_counts()
    quant.int8_matmul(x, w).sum().backward()
    quant.int8_matmul_qbwd(x, w).sum().backward()
    quant.int8_matmul_nt(x, w.t()).sum().backward()
    for entry, bwd in ((quant.int8_matmul, 0), (quant.int8_matmul_qbwd, 2),
                       (quant.int8_matmul_nt, 2)):
        assert entry.calls_by_pass == {"fwd": 1, "bwd": bwd}
        assert entry.calls == 1 + bwd
        assert entry.calls_by_route == {"int8": 0, "int8_pad": 0,
                                        "cpu": 1 + bwd}
    quant.zero_counts()
    assert quant.int8_matmul_nt.calls == 0
    assert quant.int8_matmul_qbwd.calls_by_pass == {"fwd": 0, "bwd": 0}


@pytest.mark.parametrize("contract", [0, 1])
def test_operands_are_laid_out_and_padded_for_the_cuda_gemm(contract):
    """The contraction last and contiguous, zero columns up to a multiple
    of 8 and zero rows up to the rows asked for; the values and the scale
    are the quantizer's."""
    x = torch.randn(13, 21)
    buf, scale = quant._operand(x, 0, contract, 17)
    r, k = x.shape[1 - contract], x.shape[contract]
    assert buf.is_contiguous() and buf.dtype == torch.int8
    assert buf.shape == (max(17, r), -(-k // 8) * 8)
    q, want_scale = quant._quantize_axis(x, 0)
    body = buf[:r, :k] if contract == 1 else buf[:r, :k].t()
    assert torch.equal(body, q) and torch.equal(scale, want_scale)
    assert not buf[r:].any() and not buf[:, k:].any()


def test_a_refused_gemm_raises_before_any_float_product():
    """Off CPU and CUDA there is no integer GEMM: the call raises and
    counts nothing (the CUDA rule is held on the card by the gpu
    tests)."""
    qa = torch.zeros(17, 8, dtype=torch.int8, device="meta")
    quant.zero_counts()
    with pytest.raises(ValueError, match="no int8 GEMM"):
        quant._gemm_nt(qa, qa, quant.int8_matmul_qbwd, False, "fwd")
    assert quant.int8_matmul_qbwd.calls == 0


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


def _check_module(jmod, tmod, x_np, extra_j=(), extra_t=(), jkw=None,
                  tkw=None):
    """Init the JAX module on ``x_np``, load its parameters into ``tmod``,
    and compare outputs, the input gradient and every parameter
    gradient within TOL."""
    jkw, tkw = jkw or {}, tkw or {}
    jx = jnp.asarray(x_np)
    params = jax.tree.map(np.asarray, fnn.meta.unbox(jmod.init(
        jax.random.PRNGKey(0), jx, *extra_j, **jkw)["params"]))
    tmod.load_state_dict(params_from_jax(params), strict=True)

    def f(p, x):
        out = jmod.apply({"params": p}, x, *extra_j, **jkw)
        return out[0] if isinstance(out, tuple) else out

    jout, (jdp, jdx), jg = _jax_vjp(f, params, jx)
    x = torch.from_numpy(x_np).requires_grad_()
    out = tmod(x, *extra_t, **tkw)
    out.backward(torch.from_numpy(_np(jg)))
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(x.grad), _np(jdx), **TOL)
    want = grads_from_jax(jax.tree.map(np.asarray, jdp))
    got = dict(tmod.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(_np(got[name].grad), w.numpy(), **TOL,
                                   err_msg=name)
    return tmod


def _x(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["int8", "int8_bwd", "int8_all"])
def test_transformer_ffn_in_each_mode_matches_jax(mode):
    """``lin1`` / ``lin2`` stay the parameter names; "int8" is
    straight-through, "int8_bwd" and "int8_all" int8 in the backward."""
    ffn = _check_module(
        jlayers.TransformerFFN(dim=24, hidden_dim=40, quant=mode),
        TransformerFFN(24, 40, quant=mode), _x((2, 9, 24)))
    assert isinstance(ffn.lin1, QuantDense) and isinstance(ffn.lin2,
                                                           QuantDense)
    assert ffn.lin1.quant_bwd == (mode != "int8")
    quant.zero_counts()
    ffn(torch.randn(2, 9, 24, requires_grad=True)).sum().backward()
    entry = quant.int8_matmul if mode == "int8" else quant.int8_matmul_qbwd
    assert entry.calls_by_pass == {"fwd": 2,
                                   "bwd": 0 if mode == "int8" else 4}


def test_fused_int8_qkv_self_attention_matches_jax():
    """Self-attention under quant="int8_bwd": one int8 GEMM for Q, K and
    V over the concatenated weights, int8 in the backward too."""
    mask = np.ones((2, 11), bool)
    mask[1, 7:] = False
    mha = _check_module(
        jlayers.MultiHeadAttention(n_heads=4, dim=32, quant="int8_bwd",
                                   use_pallas=False),
        MultiHeadAttention(4, 32, quant="int8_bwd"), _x((2, 11, 32)),
        (jnp.asarray(mask),), (torch.from_numpy(mask),))
    quant.zero_counts()
    x = torch.randn(2, 11, 32, requires_grad=True)
    mha(x, torch.from_numpy(mask)).sum().backward()
    assert quant.int8_matmul_qbwd.calls_by_pass == {"fwd": 1, "bwd": 2}
    # cross-attention keeps the float projections
    quant.zero_counts()
    mha(x[:, :3], torch.from_numpy(mask), kv=x)
    assert quant.int8_matmul_qbwd.calls == 0


@pytest.mark.parametrize("mode", ["int8", "int8_bwd"])
def test_aoa_gate_with_quant_matches_jax(mode):
    mask = np.ones((2, 6), bool)
    mask[0, 4:] = False
    aoa = _check_module(
        jemb.AoAAttention(n_heads=2, dim=16, quant=mode, use_pallas=False),
        AoAAttention(2, 16, quant=mode), _x((2, 6, 16)),
        (jnp.asarray(mask),), (torch.from_numpy(mask),))
    assert isinstance(aoa.aoa, QuantDense)


def test_aoa_refiner_layer_with_quant_matches_jax():
    """The refiner layer passes ``quant`` to its FFN only, as the JAX
    layer does; the gate stays float."""
    mask = np.ones((2, 6), bool)
    mask[1, 5:] = False
    layer = _check_module(
        jemb.AoARefinerLayer(n_heads=2, dim=16, ffn_dim=24, dropout=0.0,
                             quant="int8_bwd", use_pallas=False),
        AoARefinerLayer(2, 16, 24, quant="int8_bwd"), _x((2, 6, 16)),
        (jnp.asarray(mask),), (torch.from_numpy(mask),))
    assert isinstance(layer.ffn.lin1, QuantDense)
    assert not isinstance(layer.aoa_attn.aoa, QuantDense)


@pytest.mark.parametrize("tied", [True, False])
def test_pred_layer_int8_bwd_matches_jax(tied):
    """Tied through `int8_matmul_nt` over the (V, D) table (V = 37, not a
    multiple of 8), untied through `int8_matmul` over its kernel."""
    v, d = 37, 16
    x_np = _x((3, 5, d))
    emb_np = _x((v, d), 8)
    jmod = jheads.PredLayer(n_words=v, dim=d, quant="int8_bwd")
    jx, jemb_ = jnp.asarray(x_np), jnp.asarray(emb_np)
    extra = (jemb_,) if tied else ()
    params = jax.tree.map(np.asarray, fnn.meta.unbox(jmod.init(
        jax.random.PRNGKey(0), jx, *extra)["params"]))
    params["bias"] = _x((v,), 9)
    tmod = PredLayer(v, d, tied=tied, quant="int8_bwd")
    tmod.load_state_dict(params_from_jax(params), strict=True)

    def f(p, x, *e):
        return jmod.apply({"params": p}, x, *e)

    jout, jgrads, jg = _jax_vjp(f, params, jx, *extra)
    x = torch.from_numpy(x_np).requires_grad_()
    emb = torch.from_numpy(emb_np).requires_grad_()
    quant.zero_counts()
    out = tmod(x, emb if tied else None)
    out.backward(torch.from_numpy(_np(jg)))
    entry = quant.int8_matmul_nt if tied else quant.int8_matmul
    assert entry.calls_by_pass == {"fwd": 1, "bwd": 2 if tied else 0}
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(x.grad), _np(jgrads[1]), **TOL)
    want = grads_from_jax(jax.tree.map(np.asarray, jgrads[0]))
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(_np(p.grad), want[name].numpy(), **TOL,
                                   err_msg=name)
    if tied:
        np.testing.assert_allclose(_np(emb.grad), _np(jgrads[2]), **TOL)


# ---------------------------------------------------------------------------
# the MCT loss under int8_bwd
# ---------------------------------------------------------------------------

N_WORDS = 300
GROUPS, SAMPLE_N, TEXT_LEN, REGIONS = 2, 3, 12, 8
MAX_PRED = 6
PACK_RATIO = 0.25
LAMBDAS = dict(lambda_rel=1.0, lambda_mlm=1.0, lambda_mrm=0.5,
               lambda_mrfr=0.25, lambda_clcm=1.0)
# the whole model in fp32 around 2 x 2 int8 FFN GEMMs and the int8 head.
# An upstream activation one ulp off XLA's could land on the other side of
# a rounding boundary of its int8 step and move an output by about sx * sw;
# at these inputs none does (every leaf agrees within 2e-6), so the loss
# and every gradient leaf are held, relative to the leaf's largest entry,
# at the float model's 1e-4 (tests/test_torch_mct.py)
TOL_MODEL = 1e-4
# a key bias's gradient is zero up to rounding (see test_torch_train.py):
# held against the largest gradient entry of the model
ZERO_GRAD_LEAF = "k_lin.bias"
ZERO_GRAD_RTOL = 1e-6


def _mask_cfg(cls=MaskingConfig):
    return cls(max_pred=MAX_PRED, n_words=N_WORDS, mask_index=N_WORDS - 1)


def _jax_draws(batch, key):
    r_coin, r_text, r_img, _ = jax.random.split(key, 4)
    tokens = jnp.asarray(batch["tokens"])
    bn, s = tokens.shape
    cfg = _mask_cfg(jax_masking.MaskingConfig)
    text_mask = jax_lengths_to_mask(jnp.asarray(batch["text_len"]), s)
    img_mask = jax_lengths_to_mask(jnp.asarray(batch["img_len"]), REGIONS)
    coin = jax.random.bernoulli(r_coin, 0.5, (bn,)).astype(jnp.float32)
    text = jax_masking.mask_tokens(r_text, tokens, text_mask, cfg)
    regions = jax_masking.mask_regions(r_img, jnp.asarray(batch["feats"]),
                                       jnp.asarray(batch["obj_labels"]),
                                       img_mask, cfg)

    def t(xs):
        return [torch.from_numpy(np.array(x)) for x in xs]

    return dict(coin=t([coin])[0], text_masking=t(text),
                region_masking=t(regions))


def mct_parity(jcfg, tol, jit):
    """``mct_pretrain_loss`` and every gradient leaf of the port against
    the JAX loss (jitted when ``jit``) with the JAX coin and maskings fed
    in; each leaf within ``tol`` of its largest entry.  Returns the port
    model."""
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    batch = jax_synthetic.make_pretrain_batch(
        np.random.RandomState(0), GROUPS, SAMPLE_N, TEXT_LEN, REGIONS,
        N_WORDS)
    batch["img_len"][1] = 5
    key = jax.random.PRNGKey(1)
    jloss = functools.partial(
        jax_steps.mct_pretrain_loss, jm,
        mask_cfg=_mask_cfg(jax_masking.MaskingConfig), sample_n=SAMPLE_N,
        deterministic=True, pack_ratio=PACK_RATIO, **LAMBDAS)
    vg = jax.value_and_grad(
        lambda p, b: jloss(p, b, key), has_aux=True)
    (want_loss, want_metrics), want_grads = (jax.jit(vg) if jit else vg)(
        params, jax.tree.map(jnp.asarray, batch))
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    loss, metrics = mct_pretrain_loss(
        model, {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        None, _mask_cfg(), SAMPLE_N, deterministic=True,
        pack_ratio=PACK_RATIO, **LAMBDAS, **_jax_draws(batch, key))
    loss.backward()
    for name in metrics:
        np.testing.assert_allclose(metrics[name].item(),
                                   float(want_metrics[name]), rtol=tol,
                                   atol=tol, err_msg=name)
    want = grads_from_jax(jax.tree.map(np.asarray, want_grads))
    largest = max(w.abs().max().item() for w in want.values())
    reached = 0
    for name, p in model.named_parameters():
        w = want[name]
        if p.grad is None:
            assert not w.any(), name
            continue
        reached += 1
        if name.endswith(ZERO_GRAD_LEAF):
            for leaf in (p.grad, w):
                assert leaf.abs().max().item() < ZERO_GRAD_RTOL * largest
            continue
        scale = max(w.abs().max().item(), 1e-6)
        err = (p.grad - w).abs().max().item() / scale
        assert err < tol, (name, err)
    assert reached >= 50
    return model


def test_mct_loss_and_every_gradient_leaf_under_int8_bwd_match_jax():
    jcfg = JaxModelConfig(
        n_words=N_WORDS, n_langs=3, emb_dim=32, n_layers=2, n_heads=4,
        dropout=0.0, attention_dropout=0.0, max_region_num=REGIONS,
        refine_layers=1, mask_index=N_WORDS - 1, dtype="float32",
        use_pallas_attention=False, ffn_quant="int8_bwd",
        head_quant="int8_bwd")
    quant.zero_counts()
    model = mct_parity(jcfg, TOL_MODEL, jit=True)
    assert isinstance(model.blocks[0].ffn.lin1, QuantDense)
    # one encode: 2 blocks x 2 GEMMs forward, twice that backward
    assert quant.int8_matmul_qbwd.calls_by_pass == {"fwd": 4, "bwd": 8}
    assert quant.int8_matmul_nt.calls_by_pass == {"fwd": 1, "bwd": 2}
