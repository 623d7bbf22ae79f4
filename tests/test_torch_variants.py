"""The port's single-card model variants against the JAX package's: the
expert-choice `MoEFFN` (``moe_experts``), the `AdaptiveSoftmax` head
(``asm``), the BiDAF image fusion (``image_fusion``, `CrossAlignMatrix`)
and the latent modules (`VaeEncoder`, `LatentDecoder`).

Each module's outputs and every gradient agree with the JAX module's
within ``TOL`` (fp32, sums in another order); the MoE's routing is exact
(the stable `top_k` orders ties as `lax.top_k`), so its outputs take the
same tokens.  ``mct_pretrain_loss`` and every gradient leaf of a model
with MoE blocks agree with the JAX loss (the coin and maskings fed in)
within 1e-4 of each leaf's largest entry, as the float model's test holds
them (tests/test_torch_mct.py).  `VaeEncoder`'s stochastic branch draws
from a torch generator, which cannot replay the JAX key stream: it is held
by its properties.  Each configuration loads the JAX parameters strictly
and exports them back unchanged."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.config import small_test_config
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.model import heads as jheads
from m3p_tpu.model import layers as jlayers
from m3p_tpu.model import misc as jmisc
from m3p_tpu.ops.activations import gelu_erf as jax_gelu
from m3p_tpu_torch.checkpoint import (
    grads_from_jax, params_from_jax, params_to_jax)
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model import (
    build_model, capture_q8, quantized_inference_model)
from m3p_tpu_torch.model.heads import AdaptiveSoftmax
from m3p_tpu_torch.model.layers import MoEFFN
from m3p_tpu_torch.model.misc import (
    CrossAlignMatrix, LatentDecoder, VaeEncoder)
from test_torch_quant_train import mct_parity

torch.set_num_threads(1)

# fp32 on both sides; the two frameworks sum in other orders
TOL = dict(rtol=1e-4, atol=1e-5)
# the float model's leaf tolerance (tests/test_torch_mct.py)
TOL_MODEL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_model(**change):
    """The JAX model and parameters of `small_test_config` with
    ``change``, built once per configuration."""
    jcfg = dataclasses.replace(small_test_config().model, **change)
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, jm, jax.tree.map(np.asarray, params)


def _x(shape, seed=7, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _np(x):
    if isinstance(x, jax.Array):
        return np.asarray(jnp.asarray(x, jnp.float32))
    return x.detach().float().numpy()


def _init(jmod, *args, **kw):
    return jax.tree.map(np.asarray, fnn.meta.unbox(
        jmod.init(jax.random.PRNGKey(0), *args, **kw)["params"]))


def _check(jmod, params, tmod, args_np, tkw=None, jkw=None, grad_args=1):
    """Outputs, the gradients of the first ``grad_args`` arguments and
    every parameter gradient of ``tmod`` against ``jmod`` (jitted vjp
    against a fixed random cotangent) within TOL."""
    tkw, jkw = tkw or {}, jkw or {}
    tmod.load_state_dict(params_from_jax(params), strict=True)
    jargs = [jnp.asarray(a) for a in args_np]

    def f(p, *a):
        return jmod.apply({"params": p}, *a, *jargs[grad_args:], **jkw)

    jout = jax.jit(f)(params, *jargs[:grad_args])
    g = np.random.RandomState(99).randn(*jout.shape).astype(np.float32)
    jgrads = jax.jit(lambda *a: jax.vjp(f, *a)[1](jnp.asarray(g)))(
        params, *jargs[:grad_args])
    targs = [torch.from_numpy(a) for a in args_np]
    for a in targs[:grad_args]:
        a.requires_grad_()
    out = tmod(*targs, **tkw)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    for a, ja in zip(targs[:grad_args], jgrads[1:]):
        np.testing.assert_allclose(_np(a.grad), _np(ja), **TOL)
    want = grads_from_jax(jax.tree.map(np.asarray, jgrads[0]))
    for name, p in tmod.named_parameters():
        np.testing.assert_allclose(_np(p.grad), want[name].numpy(), **TOL,
                                   err_msg=name)
    return out


# ---------------------------------------------------------------------------
# MoEFFN (tests/test_moe.py:37-127)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("experts,cf", [(4, 2.0), (3, 1.0), (2, 8.0)])
def test_moe_ffn_matches_jax(experts, cf):
    """Router, top-C choice, expert MLPs, gating and the scatter-add: the
    output, the input gradient and every parameter gradient (the router's
    through the chosen affinities) within TOL.  cf 8 takes every token."""
    d, h = 8, 16
    jmod = jlayers.MoEFFN(dim=d, hidden_dim=h, n_experts=experts,
                          capacity_factor=cf)
    x = _x((2, 5, d), 1)
    params = _init(jmod, jnp.asarray(x))
    params["b1"] = _x(params["b1"].shape, 2, 0.1)
    params["b2"] = _x(params["b2"].shape, 3, 0.1)
    mod = MoEFFN(d, h, experts, cf)
    _check(jmod, params, mod, [x])
    assert mod.capacity(10) == min(10, max(1, int(cf * 10 / experts)))


def test_single_expert_full_capacity_equals_dense():
    """E = 1 with C >= T routes every token to the one expert at gate
    softmax(one logit) = 1: the dense expert MLP."""
    d, h = 8, 16
    mod = MoEFFN(d, h, 1, capacity_factor=4.0)
    x = torch.from_numpy(_x((2, 5, d), 0))
    with torch.no_grad():
        for p in (mod.router, mod.w1, mod.b1, mod.w2, mod.b2):
            p.copy_(torch.randn(p.shape))
        y = mod(x)
    w1, b1, w2, b2 = (p.detach().numpy()[0]
                      for p in (mod.w1, mod.b1, mod.w2, mod.b2))
    ref = np.asarray(jax_gelu(jnp.asarray(x.numpy() @ w1 + b1))) @ w2 + b2
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_expert_choice_capacity_and_mixing():
    """Each expert takes exactly C = cf * T / E tokens; tokens no expert
    took output exactly zero; a token taken twice mixes both outputs."""
    d, h, e, b, s = 8, 16, 4, 2, 8
    t = b * s
    torch.manual_seed(1)
    mod = MoEFFN(d, h, e, capacity_factor=1.0)
    with torch.no_grad():
        for p in (mod.router, mod.w1, mod.w2):
            p.copy_(torch.randn(p.shape))
    x = torch.randn(b, s, d)
    with torch.no_grad():
        y = mod(x).reshape(t, d)
    aff = torch.softmax(x.reshape(t, d) @ mod.router.detach(),
                        dim=-1).numpy()
    cap = int(1.0 * t / e)
    assert mod.capacity(t) == cap
    chosen = [np.argsort(-aff[:, i], kind="stable")[:cap] for i in range(e)]
    selected = set(int(i) for c in chosen for i in c)
    unselected = [i for i in range(t) if i not in selected]
    assert unselected and float(y[unselected].abs().max()) == 0.0
    assert float(y[sorted(selected)].abs().sum()) > 0.0


def _moe_jcfg(**kw):
    return JaxModelConfig(
        n_words=300, n_langs=3, emb_dim=32, n_layers=2, n_heads=4,
        dropout=0.0, attention_dropout=0.0, max_region_num=8,
        refine_layers=1, mask_index=299, dtype="float32",
        use_pallas_attention=False, **kw)


def test_mct_loss_and_every_gradient_leaf_with_moe_blocks_match_jax():
    """4 experts on every 2nd block (the CLI's interval), capacity factor
    2 (its default): block_1 carries ``moe_ffn``, block_0 the dense FFN."""
    model = mct_parity(_moe_jcfg(moe_experts=4, moe_interval=2), TOL_MODEL,
                       jit=True)
    assert model.blocks[0].moe_ffn is None and model.blocks[0].ffn
    assert model.blocks[1].ffn is None
    assert model.blocks[1].moe_ffn.w1.shape[0] == 4


def test_moe_blocks_refuse_a_causal_call():
    cfg = dataclasses.replace(
        ModelConfig(**dataclasses.asdict(small_test_config().model)),
        moe_experts=2, moe_interval=1)
    model = build_model(cfg, 0, "cpu")
    toks = torch.zeros(2, 4, dtype=torch.long)
    mask = torch.ones(2, 4, dtype=torch.bool)
    with pytest.raises(ValueError, match="causal"):
        model.encode_text(toks, mask, causal=True)
    assert model.encode_text(toks, mask).shape == (2, 4, cfg.emb_dim)


def test_int8_inference_leaves_the_moe_experts_float():
    """As in JAX, an MoE block's experts take no int8 tables; its
    attention does."""
    cfg = dataclasses.replace(
        ModelConfig(**dataclasses.asdict(small_test_config().model)),
        moe_experts=2, moe_interval=2)
    quant = quantized_inference_model(build_model(cfg, 0, "cpu"))
    capture_q8(quant)
    assert quant.blocks[0].ffn.q8_lin1 is not None
    assert quant.blocks[1].ffn is None
    assert quant.blocks[1].attn.q8_qkv is not None


# ---------------------------------------------------------------------------
# AdaptiveSoftmax (tests/test_model.py:187-213)
# ---------------------------------------------------------------------------


def test_adaptive_softmax_matches_jax_and_is_normalized():
    n, d, cutoffs = 50, 16, (10, 30)
    jmod = jheads.AdaptiveSoftmax(n_words=n, dim=d, cutoffs=cutoffs)
    x = _x((2, 3, d), 4, 2.0)
    params = _init(jmod, jnp.asarray(x))
    params["head"]["bias"] = _x((cutoffs[0] + 2,), 5)
    mod = AdaptiveSoftmax(n, d, cutoffs)
    lp = _check(jmod, params, mod, [x])
    assert lp.shape == (2, 3, n)
    np.testing.assert_allclose(
        torch.logsumexp(lp.detach(), dim=-1).numpy(), 0.0, atol=1e-5)
    assert [tuple(p.shape) for p in (mod.tail_0_proj.weight,
                                     mod.tail_1_out.weight)] == [(4, 16),
                                                                  (20, 1)]


def test_asm_model_word_logits_are_log_probs_and_keep_head_quant():
    """``word_logits`` of an ``asm`` model equals the JAX model's, its
    logsumexp 0, so cross-entropy is -log p[y]; the int8 inference
    variant keeps ``head_quant`` and builds no word table."""
    jcfg, jm, params = _jax_model(asm=True, asm_cutoffs=(64, 256))
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    assert not hasattr(model, "pred_layer")
    x = _x((2, 3, jcfg.emb_dim), 6)
    want = jm.apply({"params": params}, jnp.asarray(x),
                    method=jm.word_logits)
    with torch.no_grad():
        got = model.word_logits(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(torch.logsumexp(got, -1).numpy(), 0.0,
                               atol=1e-4)
    y = torch.tensor([[1, 2, 3], [4, 500, 6]])
    ce = torch.nn.functional.cross_entropy(got.reshape(-1, 512),
                                           y.reshape(-1), reduction="none")
    np.testing.assert_allclose(
        ce.numpy(), -got.gather(-1, y[..., None])[..., 0].reshape(-1),
        atol=1e-5)
    quant = quantized_inference_model(model)
    assert quant.cfg.head_quant == "none" and quant.cfg.ffn_quant == \
        "int8_infer"
    capture_q8(quant)
    np.testing.assert_allclose(
        quant.word_logits(torch.from_numpy(x)).detach().numpy(),
        got.numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# image fusion and the latent modules (tests/test_model.py:216-240,
# tests/test_noise_and_misc.py:105-133)
# ---------------------------------------------------------------------------


def test_cross_align_matrix_matches_jax_and_ignores_masked_images():
    d = 16
    c, q = _x((2, 6, d), 1), _x((2, 4, d), 2)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    jmod = jmisc.CrossAlignMatrix(dim=d)
    params = _init(jmod, jnp.asarray(c), jnp.asarray(q), jnp.asarray(mask))
    params["att_weight_c"]["bias"] = _x((1,), 3)
    mod = CrossAlignMatrix(d)
    out = _check(jmod, params, mod, [c, q, mask], grad_args=2)
    assert out.shape == (2, 6, d)
    q2 = torch.from_numpy(q.copy())
    q2[0, 3] = 99.0
    with torch.no_grad():
        again = mod(torch.from_numpy(c), q2, torch.from_numpy(mask))
    torch.testing.assert_close(again[0], out[0].detach(), rtol=0, atol=1e-6)


def test_vae_encoder_deterministic_matches_jax_and_stochastic_properties():
    d = 16
    c, x = _x((2, 6, d), 4), _x((2, 6, d), 5)
    jmod = jmisc.VaeEncoder(dim=d)
    # the non-deterministic init creates the logvar branch's parameters
    params = jax.tree.map(np.asarray, fnn.meta.unbox(jmod.init(
        jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(c),
        jax.random.PRNGKey(9), False)["params"]))
    mod = VaeEncoder(d)
    mod.load_state_dict(params_from_jax(params), strict=True)
    want, kld = jmod.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(c), None, True)
    assert kld is None
    got, tkld = mod(torch.from_numpy(x), torch.from_numpy(c))
    assert tkld is None
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **TOL)

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return mod(torch.from_numpy(x), torch.from_numpy(c), gen, False)

    (z1, k1), (z2, k2), (z3, _) = draw(0), draw(0), draw(1)
    assert torch.equal(z1, z2) and torch.equal(k1, k2)
    assert not torch.equal(z1, z3) and z1.shape == got.shape
    assert k1.shape == (2, 6) and k1.dtype == torch.float32
    # the KL term is the JAX formula's over the same mu and logvar
    jk = jax.random.PRNGKey(2)
    _, jkld = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(c),
                         jk, False)
    np.testing.assert_allclose(k1.detach().numpy(), _np(jkld), **TOL)
    # a logvar of -inf leaves z = mu: the deterministic output
    with torch.no_grad():
        mod.x_to_logvar.bias.fill_(-1e4)
        z0, _ = draw(3)
    torch.testing.assert_close(z0, got.detach(), rtol=1e-6, atol=1e-6)


def test_latent_decoder_matches_jax():
    d = 16
    x = _x((2, 6, d), 6)
    jmod = jmisc.LatentDecoder(dim=d)
    params = _init(jmod, jnp.asarray(x))
    r = _check(jmod, params, LatentDecoder(d), [x])
    assert r.shape == x.shape and float(r.abs().max()) <= 1.0


def test_encode_text_with_image_fusion_matches_jax():
    """``image_enc`` / ``image_mask`` engage ``cross_align`` before the
    blocks; without them the stream is the plain one; a model built
    without ``image_fusion`` refuses them."""
    jcfg, jm, params = _jax_model(image_fusion=True)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = build_model(cfg, 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    rng = np.random.RandomState(0)
    tokens = rng.randint(4, 500, (2, 8)).astype(np.int32)
    mask = np.ones((2, 8), bool)
    img = rng.randn(2, 4, cfg.emb_dim).astype(np.float32)
    img_mask = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], bool)

    def jf(im):
        out, _ = jm.apply({"params": params}, jnp.asarray(tokens),
                          jnp.asarray(mask), image_enc=im,
                          image_mask=jnp.asarray(img_mask),
                          method=jm.encode_text)
        return out

    want = jax.jit(jf)(jnp.asarray(img))
    g = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    (want_dimg,) = jax.jit(lambda im: jax.vjp(jf, im)[1](jnp.asarray(g)))(
        jnp.asarray(img))
    t_img = torch.from_numpy(img).requires_grad_()
    got = model.encode_text(torch.from_numpy(tokens).long(),
                            torch.from_numpy(mask), image_enc=t_img,
                            image_mask=torch.from_numpy(img_mask))
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(t_img.grad), _np(want_dimg), **TOL)
    assert model.cross_align.align_output.weight.grad is not None
    with torch.no_grad():
        plain = model.encode_text(torch.from_numpy(tokens).long(),
                                  torch.from_numpy(mask))
    assert float((plain - got.detach()).abs().max()) > 1e-4
    other = build_model(dataclasses.replace(cfg, image_fusion=False), 0,
                        "cpu")
    assert not hasattr(other, "cross_align")
    with pytest.raises(ValueError, match="image_fusion"):
        other.encode_text(torch.from_numpy(tokens).long(),
                          torch.from_numpy(mask), image_enc=t_img,
                          image_mask=torch.from_numpy(img_mask))


# ---------------------------------------------------------------------------
# every configuration loads strictly and exports back
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change", [
    dict(moe_experts=4, moe_interval=2),
    dict(asm=True, asm_cutoffs=(64, 256)),
    dict(image_fusion=True),
], ids=["moe", "asm", "image_fusion"])
def test_params_from_jax_round_trips_strictly(change):
    jcfg, _, params = _jax_model(**change)
    model = build_model(ModelConfig(**dataclasses.asdict(jcfg)), 0, "cpu")
    model.load_state_dict(params_from_jax(params), strict=True)

    def flat(tree):
        return {"/".join(k.key for k in path): np.asarray(v) for path, v in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    want, got = flat(params), flat(params_to_jax(model))
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
