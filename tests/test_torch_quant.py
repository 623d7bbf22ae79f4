"""The port's frozen-weight int8 inference (`ops/quant.py`, the
``int8_infer`` modules, `model.capture_q8`) against the JAX package's.

The quantizers, `int8_matmul_pre` and `int8_matmul_nt_pre` equal the JAX
functions as XLA compiles them (``jax.jit``) bit for bit on the CPU, in
fp32 and bf16; the captured tables equal the JAX `capture_q8` collection
bit for bit; the 2048-row gate routes as `tests/test_quant.py:230` checks
in JAX; the int8 model's ``encode_joint``, ``word_logits`` and
``beam_search`` agree with the JAX int8 model on `small_test_config()` in
fp32 within ``TOL`` (its int8 GEMMs take the same quantized operands; the
float parts sum in another order, which can move an activation across a
rounding boundary of its quantization: one step of one element's scale),
token for token in the search; without tables the int8 model computes
the plain model's GEMMs exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu.config import small_test_config
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.model import capture_q8 as jax_capture_q8
from m3p_tpu.model import generation as jgen
from m3p_tpu.model import quantized_inference_model as jax_quantized
from m3p_tpu.ops import quant as jquant
from m3p_tpu_torch.checkpoint import params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model import (
    build_model, capture_q8, q8_collection, quantized_inference_model)
from m3p_tpu_torch.model import generation as tgen
from m3p_tpu_torch.model.layers import MultiHeadAttention, TransformerFFN
from m3p_tpu_torch.ops import quant

torch.set_num_threads(1)

# fp32 int8 model against the JAX int8 model: the hidden states and logits
# are O(1); an activation that rounds to the other int8 step moves an
# output by about sx * sw * K-th of the row, far below this
TOL = dict(rtol=1e-3, atol=1e-3)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(
        x, jax.Array) else x.float().numpy()


def _inputs(shape, dtype, seed):
    a = (np.random.RandomState(seed).randn(*shape) * 2.5).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return _t(a).to(tdt), jnp.asarray(a, jdt)


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the functions, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("which", ["rows", "cols", "axis0", "axis1"])
def test_quantizers_equal_jax_bit_for_bit(dtype, which):
    x, jx = _inputs((37, 24), dtype, 0)
    x[3] = 0          # an all-zero row takes the 1e-6 floor
    jx = jx.at[3].set(0)
    mine, want = {
        "rows": (quant._quantize_rows, jquant._quantize_rows),
        "cols": (quant._quantize_cols, jquant._quantize_cols),
        "axis0": (lambda a: quant._quantize_axis(a, 0),
                  lambda a: jquant._quantize_axis(a, 0)),
        "axis1": (lambda a: quant._quantize_axis(a, 1),
                  lambda a: jquant._quantize_axis(a, 1)),
    }[which]
    q, s = mine(x)
    jq, js = jax.jit(want)(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert int(q.abs().max()) == 127


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("lead", [(5,), (2, 7), (2049,)])
def test_int8_matmul_pre_equals_jax_bit_for_bit(dtype, lead):
    x, jx = _inputs((*lead, 40), dtype, 1)
    w, jw = _inputs((40, 24), dtype, 2)
    wq, sw = quant.prequantize_nn(w)
    jwq, jsw = jax.jit(jquant.prequantize_nn)(jw)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    before = quant.int8_matmul_pre.calls_by_route["cpu"]
    got = quant.int8_matmul_pre(x, wq, sw)
    want = jax.jit(jquant.int8_matmul_pre)(jx, jwq, jsw)
    assert got.dtype == x.dtype and got.shape == (*lead, 24)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert quant.int8_matmul_pre.calls_by_route["cpu"] == before + 1
    # a transposed view of a (N, K) table, as the modules pass it
    got_t = quant.int8_matmul_pre(x, wq.t().contiguous().t(), sw)
    assert torch.equal(got_t, got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m", [1, 5, 70])
def test_int8_matmul_nt_pre_equals_jax_bit_for_bit(dtype, m):
    x, jx = _inputs((m, 32), dtype, 3)
    w, jw = _inputs((50, 32), dtype, 4)
    wq, sw = quant.prequantize_nt(w)
    jwq, jsw = jax.jit(jquant.prequantize_nt)(jw)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    got = quant.int8_matmul_nt_pre(x, wq, sw)
    want = jax.jit(jquant.int8_matmul_nt_pre)(jx, jwq, jsw)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_counts_and_zero_counts():
    x = torch.randn(3, 8)
    table = quant.Q8Table(torch.randn(16, 8), torch.float32)
    quant.zero_counts()
    table(x)
    quant.int8_matmul_nt_pre(x, table.wq, table.sw.t())
    assert quant.int8_matmul_pre.calls == 1
    assert quant.int8_matmul_nt_pre.calls_by_route == {
        "int8": 0, "int8_row_pad": 0, "cpu": 1}
    quant.zero_counts()
    assert quant.int8_matmul_pre.calls == quant.int8_matmul_nt_pre.calls == 0
    assert quant.GATE_COUNTS == {"int8": 0, "plain": 0}


def test_q8_table_pads_rows_and_keeps_the_jax_layout():
    w = torch.randn(13, 8)
    table = quant.Q8Table(w, torch.float32, 16)
    assert table.wq.shape == (16, 8) and table.sw.shape == (1, 16)
    assert not table.wq[13:].any()
    wq, sw = table.jax_layout()
    want_q, want_s = quant.prequantize_nn(w.t())
    assert torch.equal(wq, want_q) and torch.equal(sw, want_s)
    assert "wq" not in table.state_dict() and dict(table.named_buffers())


# ---------------------------------------------------------------------------
# the 2048-row gate (tests/test_quant.py:230)
# ---------------------------------------------------------------------------


def test_q8_gate_large_m_falls_back_to_the_plain_gemm():
    torch.manual_seed(5)
    ffn = TransformerFFN(8, 16, gelu_activation=False)
    ffn.capture_q8(torch.float32)
    lin1 = ffn.lin1
    x_big = torch.randn(quant.PREQUANT_MAX_M + 1, 8)
    x_small = torch.randn(4, 8)
    quant.zero_counts()
    with torch.no_grad():
        torch.testing.assert_close(
            quant.gated_linear(x_big, ffn.q8_lin1, lin1),
            lin1(x_big), rtol=0, atol=0)
        assert quant.GATE_COUNTS == {"int8": 0, "plain": 1}
        small = quant.gated_linear(x_small, ffn.q8_lin1, lin1)
        assert quant.GATE_COUNTS == {"int8": 1, "plain": 1}
        assert float((small - lin1(x_small)).abs().max()) > 1e-6
        # exactly the gate: int8
        at = torch.randn(quant.PREQUANT_MAX_M, 8)
        quant.gated_linear(at, ffn.q8_lin1, lin1)
        assert quant.GATE_COUNTS["int8"] == 2
        # the FFN takes both GEMMs through the gate
        quant.zero_counts()
        ffn(x_big.view(1, -1, 8))
        ffn(x_small.view(2, 2, 8))
    assert quant.GATE_COUNTS == {"int8": 2, "plain": 2}


def test_q8_gate_of_the_fused_qkv_and_the_out_projection():
    """Self-attention without a cache takes the fused QKV table at
    B * S <= 2048 (and the out table), the plain projections above;
    cross-attention projects Q/K/V plainly and takes the out table."""
    torch.manual_seed(6)
    mha = MultiHeadAttention(2, 16)
    mha.capture_q8(torch.float32, self_attention=True)
    with torch.no_grad():
        for (b, s), want in (((2, 1024), {"int8": 2, "plain": 0}),
                             ((1, 2049), {"int8": 0, "plain": 2})):
            x = torch.randn(b, s, 16)
            quant.zero_counts()
            mha(x, torch.ones(b, s, dtype=torch.bool))
            assert quant.GATE_COUNTS == want and \
                quant.int8_matmul_pre.calls == want["int8"]
        quant.zero_counts()
        mha(torch.randn(2, 3, 16), torch.ones(2, 5, dtype=torch.bool),
            kv=torch.randn(2, 5, 16))
        assert quant.GATE_COUNTS == {"int8": 1, "plain": 0}


# ---------------------------------------------------------------------------
# the int8 model against the JAX int8 model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def models(request):
    jcfg = dataclasses.replace(small_test_config().model,
                               dtype=request.param)
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    jq = jax_quantized(jcfg)
    q8 = jax_capture_q8(jq, params)
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    qmodel = quantized_inference_model(model)
    return {"jcfg": jcfg, "jm": jm, "jq": jq, "params": params, "q8": q8,
            "model": model, "qmodel": qmodel,
            "q8_bytes": capture_q8(qmodel)}


def test_capture_equals_the_jax_q8_collection(models):
    want = _flat(models["q8"])
    got = {k: v.numpy() for k, v in q8_collection(models["qmodel"]).items()}
    assert sorted(got) == sorted(want)
    n_layers = models["jcfg"].n_layers
    assert len(got) == 10 * n_layers + 2
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the vocab table padded to a multiple of 8 rows on the module
    table = models["qmodel"].pred_layer.q8_emb
    assert table.wq.shape[0] % 8 == 0 and table.n == models["jcfg"].n_words
    assert models["q8_bytes"] == sum(
        t.wq.nbytes + t.sw.nbytes for t in models["qmodel"].modules()
        if isinstance(t, quant.Q8Table))


def test_quantized_copy_shares_the_parameters_and_no_tables_in_the_state(
        models):
    model, qmodel = models["model"], models["qmodel"]
    for (n1, p1), (n2, p2) in zip(model.named_parameters(),
                                  qmodel.named_parameters()):
        assert n1 == n2 and p1 is p2
    assert model.state_dict().keys() == qmodel.state_dict().keys()
    assert qmodel.cfg.ffn_quant == qmodel.cfg.head_quant == "int8_infer"
    assert model.blocks[0].attn.q8_qkv is None
    # the refiner stays unquantized, as in JAX
    assert not any(isinstance(m, quant.Q8Table)
                   for m in qmodel.refiner.modules())


def _joint_inputs():
    rng = np.random.RandomState(3)
    b, s, r = 2, 5, 3
    tokens = rng.randint(4, 500, (b, s))
    tmask = np.ones((b, s), bool)
    tmask[1, 3:] = False
    feats = rng.randn(b, r, 2048).astype(np.float32)
    locs = rng.rand(b, r, 5).astype(np.float32)
    imask = np.ones((b, r), bool)
    return tokens, tmask, feats, locs, imask


def test_int8_encode_joint_and_word_logits_match_jax(models):
    jq, variables = models["jq"], {"params": models["params"],
                                   "q8": models["q8"]}
    args = _joint_inputs()
    enc = jax.jit(lambda v, *a: jq.apply(v, *a, True,
                                         method=jq.encode_joint))
    want = enc(variables, *map(jnp.asarray, args))
    with torch.no_grad():
        got = models["qmodel"].encode_joint(
            *(_t(a) for a in args), refine_image=True)
        plain = models["model"].encode_joint(
            *(_t(a) for a in args), refine_image=True)
    if models["jcfg"].dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    else:   # bf16 GEMMs round in another order: held to the plain gap
        gap = np.abs(_np(plain) - _np(want)).max()
        assert np.abs(_np(got) - _np(want)).max() <= max(gap, 0.1)
    # int8 engaged: the int8 model is not the plain one
    assert float((got.float() - plain.float()).abs().max()) > 1e-4
    hidden = _np(want)[:, 0]
    logits = jax.jit(lambda v, h: jq.apply(v, h, method=jq.word_logits))(
        variables, jnp.asarray(hidden, jnp.dtype(models["jcfg"].dtype)))
    with torch.no_grad():
        got_l = models["qmodel"].word_logits(
            _t(hidden).to(DTYPES[models["jcfg"].dtype][0]))
    assert got_l.shape == (2, models["jcfg"].n_words)
    np.testing.assert_array_equal(_np(got_l), _np(logits))


def test_a_model_without_tables_computes_the_plain_gemms(models):
    fresh = quantized_inference_model(models["model"])
    args = [_t(a) for a in _joint_inputs()]
    quant.zero_counts()
    with torch.no_grad():
        a = fresh.encode_joint(*args, refine_image=True)
        b = models["model"].encode_joint(*args, refine_image=True)
        la = fresh.word_logits(a[:, 0])
        lb = models["model"].word_logits(b[:, 0])
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert quant.int8_matmul_pre.calls == quant.int8_matmul_nt_pre.calls == 0


@pytest.mark.parametrize("models", ["float32"], indirect=True)
@pytest.mark.parametrize("beams", [1, 3])
def test_int8_beam_search_matches_jax(models, beams):
    """Token for token in fp32 (in bf16 the JAX and the port's float GEMMs
    round in another order)."""
    jq = models["jq"]
    variables = {"params": models["params"], "q8": models["q8"]}
    rng = np.random.RandomState(4)
    enc = rng.randn(3, 6, models["jcfg"].emb_dim).astype(np.float32)
    mask = np.ones((3, 6), bool)
    mask[1, 4:] = False
    want = jgen.beam_search(jq, variables, jnp.asarray(enc),
                            jnp.asarray(mask), beams, 10, tgt_lang_id=0)
    quant.zero_counts()
    got = tgen.beam_search(models["qmodel"], _t(enc), _t(mask), beams, 10,
                           tgt_lang_id=0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # every decode step: the head through its table, the out projections
    # and the FFNs of both blocks through theirs
    steps = quant.int8_matmul_nt_pre.calls
    assert steps >= 1
    assert quant.int8_matmul_pre.calls == steps * models["jcfg"].n_layers * 4
