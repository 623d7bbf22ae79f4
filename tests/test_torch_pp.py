"""The port's pipeline parallelism (m3p_tpu_torch.parallel.pipeline: the
GPipe schedule over the mesh's ``pp`` axis) against the JAX package and
the port in one process on the CPU; the counterparts of
`tests/test_pipeline_parallel.py`.

The port's stages are gloo processes (`test_torch_ranks.RankPool`, a pool
of 2 and one of 4 for the module); the JAX side runs on the conftest's
virtual CPU devices in this process.  fp32 throughout: against JAX losses
agree to 1e-5 relative and gradients to 1e-4 of each leaf's largest entry
(`test_torch_sharding.py`'s tolerances); against the port in one process
(which sums the microbatches in another order) to 1e-5 (`TOL_ONE`).

* the schedule against the sequential stack, with its gradients, on 2 and
  4 stages;
* `pipelined_encode_joint` against JAX's, and `PPModel`'s ``encode_text``
  and ``encode_image`` against one process;
* the PP ITM step's loss and every gradient leaf against JAX's
  `make_pp_itm_train_step` on a 2-device mesh, and against the port in one
  process; a planted fault (``pp`` left out of the gradient reduction)
  breaks the equality;
* at dropout 0.1 the masks are reproducible, differ per microbatch and per
  stage, and equal a one-process run fed the same per-(microbatch, layer)
  seeds; a training forward without generators raises;
* ``train_x.main`` on pp 2 x data 2 against one process;
* the meshes and blocks the pipeline refuses.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.data import synthetic as jax_synthetic
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.model.transformer import lengths_to_mask as jax_lengths_to_mask
from m3p_tpu.parallel import pipeline as jax_pipeline
from m3p_tpu.train import optim as jax_optim
from m3p_tpu.train.state import create_train_state as jax_train_state
from m3p_tpu_torch.checkpoint import params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.parallel import pipeline as PP
from m3p_tpu_torch.parallel import sharding as SH
from m3p_tpu_torch.parallel.mesh import Mesh
from m3p_tpu_torch.train import steps as S
from m3p_tpu_torch.train.optim import build_optimizer
from m3p_tpu_torch.train.state import create_train_state
from test_torch_ranks import RankPool

torch.set_num_threads(1)

TOL_ONE = dict(rtol=1e-5, atol=1e-7)
LOSS_RTOL = 1e-5
SAMPLE_N = 2
REGIONS = 8


@pytest.fixture(scope="module", autouse=True)
def quick_jax_compiles():
    """XLA's optimizations off while this module compiles its JAX
    references: fp32 values at the tolerances here do not move."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(n):
        if n not in made:
            made[n] = RankPool(n, str(tmp_path_factory.mktemp(f"pp{n}")),
                               timeout_s=120.0)
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


@pytest.fixture(scope="module")
def small():
    jcfg = _jax_cfg()
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return {"jcfg": jcfg, "jm": jm, "params": params,
            "cfg": dataclasses.asdict(jcfg),
            "state": {k: v.numpy()
                      for k, v in params_from_jax(params).items()}}


def _port_model(cfg_dict, state):
    model = build_model(ModelConfig(**cfg_dict), 0, "cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return model


def _retrieval_batch(seed, groups=4):
    return jax_synthetic.make_retrieval_batch(
        np.random.RandomState(seed), groups, SAMPLE_N, 9, REGIONS, 512)


def _masks(batch):
    out = dict(batch)
    out["text_mask"] = np.asarray(jax_lengths_to_mask(
        jnp.asarray(batch["text_len"]), batch["tokens"].shape[1]))
    out["img_mask"] = np.asarray(jax_lengths_to_mask(
        jnp.asarray(batch["img_len"]), REGIONS))
    return out


def _one_stage():
    """The mesh of one process: every axis of size 1."""
    return Mesh((1,) * 6, 0, torch.device("cpu"), None)


def _jax_pp_mesh(eight_devices, n=2):
    return JaxMesh(np.array(eight_devices[:n]), ("pp",))


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stages", [2, 4])
def test_schedule_matches_the_sequential_stack_with_its_gradients(
        pools, stages):
    """`spmd_pipeline` of an MLP stage per rank over 3 microbatches against
    the stages applied in turn (`tests/test_pipeline_parallel.py:43-62`),
    outputs on every rank; the gradients averaged over the line (as the
    step reduces them) are the sequential stack's."""
    rng = np.random.RandomState(stages)
    d, hidden, n_micro = 8, 16, 3
    x = rng.randn(n_micro, 2, d).astype(np.float32)
    w1 = (rng.randn(stages, d, hidden) * 0.3).astype(np.float32)
    w2 = (rng.randn(stages, hidden, d) * 0.3).astype(np.float32)
    up = np.cos(np.arange(x.size, dtype=np.float32)).reshape(x.shape)
    ranks = pools(stages).run("pp_schedule", x=x, w1=w1, w2=w2, upstream=up)
    xs, t1, t2 = (torch.tensor(a).requires_grad_() for a in (x, w1, w2))
    h = xs
    for s in range(stages):
        h = h + torch.nn.functional.gelu(h @ t1[s]) @ t2[s]
    h.backward(torch.tensor(up))
    for r in ranks:
        np.testing.assert_allclose(r["out"], h.detach().numpy(), **TOL_ONE)
    for key, want in (("dx", xs.grad), ("dw1", t1.grad), ("dw2", t2.grad)):
        mean = np.mean([r[key] for r in ranks], axis=0)
        np.testing.assert_allclose(mean, want.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    # a stage's weights take their gradient on that stage alone
    for s, r in enumerate(ranks):
        others = [i for i in range(stages) if i != s]
        assert not r["dw1"][others].any() and r["dw1"][s].any()
    assert not any(r["dx"].any() for r in ranks[1:])


# ---------------------------------------------------------------------------
# the encoders and the ITM step against JAX and one process
# ---------------------------------------------------------------------------


def test_pipelined_encoders_match_jax_and_one_process(pools, small,
                                                      eight_devices):
    batch = _masks(_retrieval_batch(0))
    wait = pools(2).submit("pp_encode", cfg_dict=small["cfg"],
                           state=small["state"], batch=batch, n_micro=2)
    jm = small["jm"]
    want = jax.jit(lambda p, b: jax_pipeline.pipelined_encode_joint(
        jm, p, b["tokens"], b["text_mask"], b["feats"], b["locs"],
        b["img_mask"], _jax_pp_mesh(eight_devices), n_microbatches=2,
        refine_image=True))(small["params"],
                            {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(small["cfg"], small["state"])
    t = {k: torch.tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        text = model.encode_text(t["tokens"], t["text_mask"])
        image = model.encode_image(t["feats"], t["locs"], t["img_mask"],
                                   refine_image=True, refine_encoder=True)
    for r in wait():
        np.testing.assert_allclose(r["joint"], np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["text"], text.numpy(), **TOL_ONE)
        np.testing.assert_allclose(r["image"], image.numpy(), **TOL_ONE)


def _assert_leaves(got, want, where, rel=1e-4, floor=1e-6):
    """Each leaf within ``rel`` of its largest entry (and ``floor``
    absolute), as `test_torch_sharding.py::_compare_gradients` holds
    gradients."""
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for name, w in want.items():
        w = np.asarray(w)
        err = float(np.abs(got[name] - w).max())
        tol = floor + rel * float(np.abs(w).max())
        assert err <= tol, f"{where} {name}: {err} > {tol}"


def _one_process_grads(cfg_dict, state, batch, seed=None):
    model = _port_model(cfg_dict, state)
    tx, _ = build_optimizer("sgd,lr=1.0")
    st = create_train_state(model, tx)
    det = seed is None
    step = S.make_train_step(lambda m, b, g: S.itm_finetune_loss(
        m, b, g, SAMPLE_N, deterministic=det))
    _, metrics = step(st, {k: torch.tensor(v) for k, v in batch.items()},
                      None if det else Generators.from_seed(seed, "cpu"))
    return metrics["loss"].item(), {n: p.grad.numpy()
                                    for n, p in model.named_parameters()
                                    if p.grad is not None}


def test_pp_itm_step_matches_jax_and_one_process(pools, small,
                                                 eight_devices):
    """The counterpart of `make_pp_itm_train_step`: pp 2, 2 microbatches,
    the refiner on, at rate 0.  The loss and every gradient leaf against
    JAX's pipelined step on a 2-device mesh (SGD at lr 1: the move is the
    gradient), and against the port's step in one process at 1e-5."""
    batch = _retrieval_batch(1)
    wait = pools(2).submit("pp_itm_step", cfg_dict=small["cfg"],
                           state=small["state"], batch=batch,
                           mesh_axes={"pp": 2}, n_micro=2)
    tx, _ = jax_optim.build_optimizer("sgd,lr=1.0")
    state = jax_train_state(jax.tree.map(jnp.asarray, small["params"]), tx)
    step = jax_pipeline.make_pp_itm_train_step(
        small["jm"], _jax_pp_mesh(eight_devices), SAMPLE_N,
        n_microbatches=2)
    state, jm = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                     jax.random.PRNGKey(0))
    after = params_from_jax(jax.tree.map(np.asarray, state.params))
    jax_grads = {n: small["state"][n] - v.numpy() for n, v in after.items()}
    loss, grads = _one_process_grads(small["cfg"], small["state"], batch)
    for r in wait():
        np.testing.assert_allclose(r["loss"], float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        got = {n: r["grads"].get(n, np.zeros_like(w))
               for n, w in jax_grads.items()}
        _assert_leaves(got, jax_grads, "vs JAX")
        np.testing.assert_allclose(r["loss"], loss, rtol=LOSS_RTOL)
        for n, g in r["grads"].items():
            # a leaf the loss does not reach: zeros after the reduction
            np.testing.assert_allclose(g, grads.get(n, np.zeros_like(g)),
                                       **TOL_ONE, err_msg=n)


@pytest.mark.parametrize("axes", [{"pp": 2, "fsdp": 2},
                                  {"pp": 2, "tensor": 2}])
def test_pp_over_sharded_parameters_is_the_one_process_step(pools, small,
                                                            axes):
    """The pipeline composed with parameter sharding on 4 ranks: a
    stage's blocks gather their fsdp shards (or split their heads over
    tensor) among the ranks of that stage, and the step's gradients
    (gathered whole) are the one process's, each leaf within 1e-5 of its
    largest entry (the row-parallel products' all-reduce sums an entry
    with cancellation in another order)."""
    batch = _retrieval_batch(4)
    ranks = pools(4).run("pp_itm_step", cfg_dict=small["cfg"],
                         state=small["state"], batch=batch, mesh_axes=axes,
                         n_micro=2)
    loss, grads = _one_process_grads(small["cfg"], small["state"], batch)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss, rtol=LOSS_RTOL)
        want = {n: grads.get(n, np.zeros_like(g))
                for n, g in r["grads"].items()}
        _assert_leaves(r["grads"], want, str(axes), rel=1e-5, floor=1e-7)


def test_planted_fault_breaks_the_equality(pools, small):
    """``pp`` left out of the gradient reduction: each stage keeps its own
    blocks' gradient S times over and none of the others'."""
    batch = _retrieval_batch(2)
    args = dict(cfg_dict=small["cfg"], state=small["state"], batch=batch,
                mesh_axes={"pp": 2}, n_micro=2)
    good = pools(2).run("pp_itm_step", **args)
    bad = pools(2).run("pp_itm_step", fault="pp_no_reduce", **args)
    for g, b in zip(good, bad):
        off = max(float(np.abs(b["grads"].get(n, 0 * w) - w).max())
                  / max(float(np.abs(w).max()), 1e-6)
                  for n, w in g["grads"].items())
        assert off > 1e-3, off


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def _sequential_with_seeds(model, x, mask, n_micro, seed):
    """The stack in one process, microbatch by microbatch, each layer from
    the pipeline's per-(microbatch, layer) generators."""
    gen = Generators.from_seed(seed, "cpu")
    base = PP.stack_seed(gen)
    n = model.cfg.n_layers
    b = x.shape[0] // n_micro
    outs = []
    with torch.no_grad():
        for m in range(n_micro):
            h, mk = x[m * b:(m + 1) * b], mask[m * b:(m + 1) * b]
            for layer, block in enumerate(model.blocks):
                h = block(h, mk, False, False,
                          PP.layer_generators(base, m, layer, n, "cpu"))
            outs.append(h)
    return torch.cat(outs).numpy()


def test_dropout_masks_per_microbatch_and_layer(pools):
    """`TestPPDropout` (`tests/test_pipeline_parallel.py:186`) at dropout
    and attention dropout 0.1 on 4 layers over pp 2: one seed draws the
    same output twice and another seed another; two microbatches of the
    same rows draw different masks; the output is the one-process stack's
    fed the same per-(microbatch, global layer) generators, and not the
    one a stage-local layer index would draw."""
    cfg = dataclasses.asdict(_jax_cfg(n_layers=4, dropout=0.1,
                                      attention_dropout=0.1))
    model = build_model(ModelConfig(**cfg), 3, "cpu")
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(0)
    half = rng.randn(2, 6, 64).astype(np.float32)
    x = np.concatenate([half, half])
    mask = np.ones((4, 6), bool)
    a, b, c = pools(2).run("pp_dropout", cfg_dict=cfg, state=state, x=x,
                           mask=mask, n_micro=2, seeds=[3, 3, 4])[0]
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3
    assert np.abs(a[:2] - a[2:]).max() > 1e-3
    tx, tm = torch.tensor(x), torch.tensor(mask)
    with torch.no_grad():
        det = model.run_blocks_only(tx, tm)
    np.testing.assert_allclose(det[:2], det[2:], atol=1e-5)
    assert np.abs(a - det.numpy()).max() > 1e-3
    np.testing.assert_allclose(a, _sequential_with_seeds(model, tx, tm, 2, 3),
                               **TOL_ONE)
    # stage 1 keyed by its local layer index would draw stage 0's masks
    local = PP.layer_generators
    try:
        PP.layer_generators = lambda s, m, layer, n, d: local(s, m,
                                                              layer % 2, n, d)
        same_keys = _sequential_with_seeds(model, tx, tm, 2, 3)
    finally:
        PP.layer_generators = local
    assert np.abs(a - same_keys).max() > 1e-3


def test_dropout_step_is_the_one_process_step_fed_the_same_seeds(pools,
                                                                  small):
    """A training ITM step at dropout and attention dropout 0.1 on pp 2:
    the generators outside the stack are the line's (every stage draws the
    same embedding and head masks), inside it the per-(microbatch, layer)
    ones; one process runs `PPModel` over a one-stage mesh, which draws
    the same."""
    cfg = dict(small["cfg"], dropout=0.1, attention_dropout=0.1)
    batch = _retrieval_batch(3)
    ranks = pools(2).run("pp_itm_step", cfg_dict=cfg, state=small["state"],
                         batch=batch, mesh_axes={"pp": 2}, n_micro=2,
                         seed=5)
    model = _port_model(cfg, small["state"])
    handle = PP.PPModel(model, _one_stage(), n_microbatches=2)
    loss, _ = S.itm_finetune_loss(
        handle, {k: torch.tensor(v) for k, v in batch.items()},
        Generators.from_seed(5, "cpu"), SAMPLE_N, deterministic=False)
    loss.backward()
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=LOSS_RTOL)
        for n, p in model.named_parameters():
            want = (p.grad.numpy() if p.grad is not None
                    else np.zeros_like(r["grads"][n]))
            np.testing.assert_allclose(r["grads"][n], want, **TOL_ONE,
                                       err_msg=n)


def test_training_forward_without_generators_raises(small):
    cfg = dict(small["cfg"], dropout=0.1)
    model = _port_model(cfg, small["state"])
    mesh = _one_stage()
    x = torch.zeros(4, 5, 64)
    mask = torch.ones(4, 5, dtype=torch.bool)
    with pytest.raises(ValueError, match="needs generators"):
        PP.pp_run_blocks(model, x, mask, mesh, n_microbatches=2,
                         deterministic=False, generator=None)
    with pytest.raises(ValueError, match="microbatches"):
        PP.pp_run_blocks(model, x, mask, mesh, n_microbatches=3)
    # deterministic, or no rate: no generators needed
    out = PP.pp_run_blocks(model, x, mask, mesh, n_microbatches=2)
    assert out.shape == x.shape


# ---------------------------------------------------------------------------
# train_x and the refusals
# ---------------------------------------------------------------------------


def test_train_x_on_pp_by_data_trains_what_one_process_trains(pools,
                                                              tmp_path):
    """`train_x.main` on each of 4 ranks with --pp_stages 2 --mesh_data 2
    --pp_microbatches 2 against one process on the same global batches:
    ITM and captioning tasks (the image encoder pipelined, the causal
    decoder on every rank), the clip on; the parameters after the epoch."""
    from m3p_tpu_torch.cli import train_x
    from m3p_tpu_torch.tokenization.unigram import train_unigram
    from test_torch_ranks import record_data

    vocab = str(tmp_path / "vocab.tsv")
    train_unigram(["red cat dog runs blue tree house"] * 30,
                  vocab_size=80).save(vocab)
    argv = ["--lgs", "en", "--cross_rel_steps", "coco-img",
            "--max_region_num", "5", "--sample_n", "2", "--batch_size", "4",
            "--max_len", "9", "--emb_dim", "32", "--n_layers", "2",
            "--n_heads", "2", "--n_dec_layers", "1", "--refine_layers", "1",
            "--dropout", "0.0", "--attention_dropout", "0.0", "--fp16",
            "False", "--epoch_size", "12", "--max_epoch", "1",
            "--use_grain", "False", "--optimizer", "adam,lr=0.001,eps=0.001",
            "--clip_grad_norm", "0.5", "--exp_name", "pp"]
    ranks = pools(4).run(
        "train_main", argv=argv + ["--dump_path", str(tmp_path / "pp"),
                                   "--exp_id", "r", "--pp_stages", "2",
                                   "--mesh_data", "2",
                                   "--pp_microbatches", "2"],
        vocab=vocab, n_groups=16, caption=True)
    one = train_x.main(argv + ["--dump_path", str(tmp_path / "one"),
                               "--exp_id", "o", "--device", "cpu"],
                       data=record_data(vocab, 16, caption=True))
    assert [tuple(r["shards"]) for r in ranks] == [(0, 2), (0, 2), (1, 2),
                                                   (1, 2)]
    assert ranks[0]["mesh"]["pp"] == ranks[0]["mesh"]["data"] == 2
    assert {r["sp"] for r in ranks} == {"PPModel"}
    assert ranks[0]["n_total_iter"] == one.n_total_iter > 0
    for name, p in one.model.named_parameters():
        for r in ranks:
            np.testing.assert_allclose(r["params"][name],
                                       p.detach().numpy(), **TOL_ONE,
                                       err_msg=name)


@pytest.mark.parametrize("change", [{"moe_experts": 2},
                                    {"ffn_quant": "int8_bwd"}])
def test_the_stage_refuses_blocks_the_jax_stage_does_not_build(change):
    """The JAX stage builds its block without MoE or the int8 FFN
    (`m3p_tpu/parallel/pipeline.py:174-179`); the port raises for both
    under pp > 1 and takes them without it."""
    cfg = dataclasses.replace(ModelConfig(**dataclasses.asdict(_jax_cfg())),
                              **change)
    with pytest.raises(NotImplementedError, match="pp > 1"):
        SH.check_model_supported(cfg, {"pp": 2})
    SH.check_model_supported(cfg, {"data": 2})


def test_pp_composes_with_every_axis_but_seq():
    for axis in ("data", "fsdp", "tensor", "expert"):
        SH.check_mesh_supported({"pp": 2, axis: 2})
    with pytest.raises(ValueError, match="seq and pp"):
        SH.check_mesh_supported({"pp": 2, "seq": 2})

