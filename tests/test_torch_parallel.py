"""The port's several-process paths (m3p_tpu_torch.parallel, the trainer's
mesh) against the JAX package on the CPU.

The port's ranks are gloo processes (`test_torch_ranks.RankPool`, one
process group of 2 and one of 4 for the whole module); the JAX side runs
in this process over the 8 virtual devices of `tests/conftest.py`.  fp32
throughout; the two frameworks sum in other orders.

* ring attention at 2 and 4 ranks, causal and not, with a row that has no
  valid key: forward and the q/k/v gradients against the JAX ring under
  `shard_map` and against the port's `mha_reference`;
* `SPModel.encode_joint` over 4 ranks at a length that does not divide,
  and the SP ITM step's loss and every gradient leaf, against the JAX
  sequence-parallel functions; attention dropout ignored under SP
  (divergence 11); no two ranks drawing one dropout mask;
* data parallelism: a 2-rank `mlm_loss` step with unequal masked counts
  and a 2-rank `itm_finetune_loss` step with the clip active against the
  JAX step on the global batch under a ``data=2`` mesh; data x seq over 4
  ranks against one process;
* the row loader's per-rank records, ``--split_data`` and ``--ft_all``
  per rank, `merge_process_scores` over 2 ranks, the save-decision
  cadence.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from m3p_tpu.config import MeshConfig as JaxMeshConfig
from m3p_tpu.config import ModelConfig as JaxModelConfig
from m3p_tpu.data import masking as jax_masking
from m3p_tpu.data import synthetic as jax_synthetic
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.model.transformer import lengths_to_mask as jax_lengths_to_mask
from m3p_tpu.ops.ring_attention import ring_attention as jax_ring
from m3p_tpu.parallel import mesh as jax_mesh
from m3p_tpu.parallel import sharding as jax_sharding
from m3p_tpu.parallel.sp import seq_parallel_encode_joint as jax_sp_joint
from m3p_tpu.train import optim as jax_optim
from m3p_tpu.train import steps as jax_steps
from m3p_tpu.train.state import create_train_state as jax_train_state
from m3p_tpu_torch.checkpoint import grads_from_jax, params_from_jax
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.ops.attention import mha_reference
from m3p_tpu_torch.train import optim
from m3p_tpu_torch.train import steps as S
from m3p_tpu_torch.train.state import create_train_state
from test_torch_loader import data_dir  # noqa: F401 (a fixture)
from test_torch_ranks import RankPool

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-6)
RING_ATOL = 1e-5
SAMPLE_N = 2
REGIONS = 8


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    out = {n: RankPool(n, str(tmp_path_factory.mktemp(f"ranks{n}")))
           for n in (2, 4)}
    yield out
    for pool in out.values():
        pool.close()


@pytest.fixture(scope="module")
def small():
    """The small config (2 layers, 64d, 4 heads, 1 refiner layer), its JAX
    model and parameters, the port's config dict and state dict."""
    jcfg = JaxModelConfig(
        n_words=512, n_langs=3, emb_dim=64, n_layers=2, n_heads=4,
        dropout=0.0, attention_dropout=0.0, max_region_num=REGIONS,
        refine_layers=1, mask_index=511, dtype="float32",
        use_pallas_attention=False, max_positions=80)
    jm, params = jax_build_model(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    cfg = dataclasses.asdict(jcfg)
    state = {k: v.numpy() for k, v in params_from_jax(params).items()}
    return {"jcfg": jcfg, "jm": jm, "params": params, "cfg": cfg,
            "state": state}


def _port_model(small):
    model = build_model(ModelConfig(**small["cfg"]), 0, "cpu")
    model.load_state_dict(params_from_jax(small["params"]), strict=True)
    return model


def _assert_grads(got, want, where=""):
    """Each leaf within 1e-4 of its largest entry (and 1e-6 absolute)."""
    assert set(got) == set(want), where
    for name, w in want.items():
        w = np.asarray(w)
        tol = 1e-6 + 1e-4 * float(np.max(np.abs(w)))
        err = float(np.max(np.abs(np.asarray(got[name]) - w)))
        assert err <= tol, f"{where} {name}: {err} > {tol}"


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------


def _ring_inputs(n):
    rng = np.random.RandomState(n)
    b, h, s, d = 2, 2, 8 * n, 8
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    mask = np.arange(s)[None, :] < np.array([s - 3, 0])[:, None]
    return q, k, v, mask          # row 1 has no valid key


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_the_jax_ring_and_the_reference(
        pools, eight_devices, n, causal):
    q, k, v, mask = _ring_inputs(n)
    ranks = pools[n].run("ring", q=q, k=k, v=v, mask=mask, causal=causal)
    ranks.sort(key=lambda r: r["index"])
    got = {key: np.concatenate([r[key] for r in ranks], axis=2)
           for key in ("out", "dq", "dk", "dv")}
    # each rank's upstream gradient is the same cos pattern over its block
    g = np.concatenate([np.cos(np.arange(r["out"].size, dtype=np.float32))
                        .reshape(r["out"].shape) for r in ranks], axis=2)

    mesh = JaxMesh(np.array(eight_devices[:n]), ("seq",))
    spec = P(None, None, "seq", None)
    fn = shard_map(
        lambda q_, k_, v_, m_: jax_ring(q_, k_, v_, m_, "seq",
                                        causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec, P(None, "seq")),
        out_specs=spec)
    jm = jnp.asarray(mask)

    @jax.jit
    def fwd_bwd(a, b, c, g_):
        out, vjp = jax.vjp(lambda a_, b_, c_: fn(a_, b_, c_, jm), a, b, c)
        return out, vjp(g_)

    out, grads = fwd_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(g))
    want = dict(zip(("dq", "dk", "dv"), grads), out=out)
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=0,
                                   atol=RING_ATOL, err_msg=key)

    # the port's reference attention in one process
    tq, tk, tv = (torch.tensor(a).requires_grad_() for a in (q, k, v))
    ref = mha_reference(tq, tk, tv, torch.tensor(mask), causal=causal)
    ref.backward(torch.tensor(g))
    for key, t in (("out", ref), ("dq", tq.grad), ("dk", tk.grad),
                   ("dv", tv.grad)):
        np.testing.assert_allclose(got[key], t.detach().numpy(), rtol=0,
                                   atol=RING_ATOL, err_msg=key)
    assert np.isfinite(got["out"]).all()


# ---------------------------------------------------------------------------
# sequence parallelism through the model
# ---------------------------------------------------------------------------


def _joint_batch(seed=0, b=2, s=11):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(4, 500, (b, s)).astype(np.int64),
            "text_mask": np.arange(s)[None, :] < np.array([s, 7])[:, None],
            "feats": rng.randn(b, REGIONS, 2048).astype(np.float32),
            "locs": rng.rand(b, REGIONS, 5).astype(np.float32),
            "img_mask": np.arange(REGIONS)[None, :]
            < np.array([REGIONS, 5])[:, None]}


def test_sp_encode_joint_matches_jax_at_a_length_that_does_not_divide(
        pools, small, eight_devices):
    batch = _joint_batch()           # 8 regions + 11 tokens = 19 positions
    got = pools[4].run("sp_encode_joint", cfg_dict=small["cfg"],
                       state=small["state"], batch=batch, seq=4)
    mesh = JaxMesh(np.array(eight_devices[:4]), ("seq",))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jax.jit(
        lambda p, *a: jax_sp_joint(small["jm"], p, *a, mesh))(
            small["params"], jb["tokens"].astype(jnp.int32),
            jb["text_mask"], jb["feats"], jb["locs"], jb["img_mask"]))
    for rank_out in got:
        np.testing.assert_allclose(rank_out, want, rtol=0, atol=2e-5)


def test_sp_itm_step_loss_and_every_gradient_leaf_match_jax(
        pools, small, eight_devices):
    batch = jax_synthetic.make_retrieval_batch(
        np.random.RandomState(0), 2, SAMPLE_N, 9, REGIONS, 512)
    ranks = pools[2].run("sp_itm_step", cfg_dict=small["cfg"],
                         state=small["state"], batch=batch,
                         sample_n=SAMPLE_N)
    jm, params = small["jm"], jax.tree.map(jnp.asarray, small["params"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mesh = JaxMesh(np.array(eight_devices[:2]), ("seq",))

    def sp_loss(p):
        tm = jax_lengths_to_mask(jb["text_len"], jb["tokens"].shape[1])
        im = jax_lengths_to_mask(jb["img_len"], jb["feats"].shape[1])
        hidden = jax_sp_joint(jm, p, jb["tokens"], tm, jb["feats"],
                              jb["locs"], im, mesh, refine_image=True)
        scores = jm.apply({"params": p}, hidden, method=jm.itm_score)
        ce, bce = jax_steps.itm_grid_losses(scores, jb["pos_label"],
                                            SAMPLE_N)
        return ce + bce

    loss, grads = jax.jit(jax.value_and_grad(sp_loss))(params)
    want = {k: v.numpy() for k, v in grads_from_jax(
        jax.tree.map(np.asarray, grads)).items()}
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-5)
        # a parameter without a gradient in JAX's tree has zeros there
        got = {k: r["grads"].get(k, np.zeros_like(w))
               for k, w in want.items()}
        _assert_grads(got, want, "sp itm")


def test_sp_attention_drops_nothing_as_in_jax(pools, small):
    """Divergence 11: the JAX ring takes no dropout rate, so a
    sequence-parallel forward at attention_dropout 0.1 equals rate 0."""
    outs = pools[2].run("sp_attention_dropout", cfg_dict=small["cfg"],
                        state=small["state"], batch=_joint_batch(1),
                        rates=[0.0, 0.1])
    for at0, at1 in outs:
        np.testing.assert_array_equal(at0, at1)


def test_no_two_ranks_draw_the_same_dropout_mask(pools):
    from m3p_tpu_torch.model.layers import Generators, dropout

    ranks = pools[4].run("dropout_masks", seed=123, shape=(64, 64))
    for kind in ("dp", "sp"):
        for a, b in itertools.combinations(range(4), 2):
            assert not np.array_equal(ranks[a][kind], ranks[b][kind]), kind
    assert len({r["seeds"] for r in ranks}) == 4
    # rank 0 (fold 0) keeps the one-process generators
    one = dropout(torch.ones(64, 64), 0.5, False,
                  Generators.from_seed(123, "cpu")).numpy()
    np.testing.assert_array_equal(ranks[0]["dp"], one)


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------


def _jax_data_step(small, loss_fn, batch, spec, clip):
    """The JAX step on the global batch with the state and the batch
    sharded over a data=2 mesh."""
    tx, _ = jax_optim.build_optimizer(spec, clip_grad_norm=clip)
    state = jax_train_state(jax.tree.map(jnp.asarray, small["params"]), tx)
    mesh = jax_mesh.make_mesh(JaxMeshConfig(data=2),
                              devices=jax.devices()[:2])
    pspecs = jax_sharding.model_param_pspecs(small["jcfg"])
    state, shardings = jax_sharding.shard_train_state(state, mesh, pspecs)
    jb = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                        jax_sharding.batch_sharding(mesh))
    step = jax_steps.make_train_step(loss_fn, donate=False,
                                     state_shardings=shardings,
                                     with_grad_norm=True)
    state, metrics = step(state, jb, jax.random.PRNGKey(3))
    return state, metrics


def _mask_cfg(cls, n_words=512):
    return cls(n_words=n_words, mask_index=n_words - 1, max_pred=6)


def _compare_step(ranks, jstate, jmetrics, loss_key):
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(jmetrics[loss_key]),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"],
                                   float(jmetrics["grad_norm"]), rtol=1e-4)
        for name, w in want.items():
            np.testing.assert_allclose(r["params"][name], w.numpy(), **TOL,
                                       err_msg=name)


def test_dp_mlm_step_with_unequal_masked_counts_matches_jax(pools, small):
    batch = jax_synthetic.make_stream_batch(np.random.RandomState(2), 4, 40,
                                            512)
    # rank 0's rows are long, rank 1's short: unequal masked counts
    batch["lengths"][:] = [40, 38, 9, 6]
    key = jax.random.PRNGKey(3)
    r_mask, _ = jax.random.split(key)
    tokens = jnp.asarray(batch["tokens"])
    masking = [np.asarray(x) for x in jax_masking.mask_tokens(
        r_mask, tokens, jax_lengths_to_mask(jnp.asarray(batch["lengths"]),
                                            40),
        _mask_cfg(jax_masking.MaskingConfig))]
    counts = masking[3].reshape(2, -1).sum(axis=1)
    assert counts[0] != counts[1], counts
    spec = "adam,lr=0.01,eps=0.001"
    jcfg_mask = _mask_cfg(jax_masking.MaskingConfig)
    jstate, jmetrics = _jax_data_step(
        small, lambda p, b, k: jax_steps.mlm_loss(
            small["jm"], p, b, k, jcfg_mask, deterministic=True),
        batch, spec, 5.0)
    ranks = pools[2].run("dp_step", cfg_dict=small["cfg"],
                         state=small["state"], kind="mlm", batch=batch,
                         spec=spec, clip=5.0, masking=masking)
    _compare_step(ranks, jstate, jmetrics, "mlm")


def _retrieval_batch(seed=0, groups=4):
    return jax_synthetic.make_retrieval_batch(
        np.random.RandomState(seed), groups, SAMPLE_N, 9, REGIONS, 512)


def test_dp_itm_step_with_the_clip_active_matches_jax(pools, small):
    batch = _retrieval_batch()
    spec = "adam,lr=0.01,eps=0.001"
    clip = 0.05
    jstate, jmetrics = _jax_data_step(
        small, lambda p, b, k: jax_steps.itm_finetune_loss(
            small["jm"], p, b, k, SAMPLE_N, deterministic=True),
        batch, spec, clip)
    assert float(jmetrics["grad_norm"]) > 2 * clip     # the clip bites
    ranks = pools[2].run("dp_step", cfg_dict=small["cfg"],
                         state=small["state"], kind="itm", batch=batch,
                         spec=spec, clip=clip, sample_n=SAMPLE_N)
    _compare_step(ranks, jstate, jmetrics, "loss")


def test_data_by_seq_on_four_ranks_equals_one_process(pools, small):
    batch = _retrieval_batch(1)
    spec = "adam,lr=0.01,eps=0.001"
    ranks = pools[4].run("dp_step", cfg_dict=small["cfg"],
                         state=small["state"], kind="itm", batch=batch,
                         spec=spec, clip=0.05, sample_n=SAMPLE_N,
                         mesh_axes={"data": 2, "seq": 2})
    model = _port_model(small)
    tx, _ = optim.build_optimizer(spec, clip_grad_norm=0.05)
    state = create_train_state(model, tx)
    step = S.make_train_step(
        lambda m, b, g: S.itm_finetune_loss(m, b, None, SAMPLE_N,
                                            deterministic=True),
        with_grad_norm=True)
    _, metrics = step(state, {k: torch.tensor(v) for k, v in batch.items()},
                      None)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], metrics["loss"].item(),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"],
                                   metrics["grad_norm"].item(), rtol=1e-4)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(r["params"][name],
                                       p.detach().numpy(), **TOL,
                                       err_msg=name)


# ---------------------------------------------------------------------------
# data and evaluation
# ---------------------------------------------------------------------------


def test_merge_process_scores_over_two_ranks(pools):
    merged = pools[2].run("merge_scores", n_img=3, n_cap=5)
    whole = np.arange(15, dtype=np.float32).reshape(3, 5)
    for m in merged:
        np.testing.assert_array_equal(m, whole)


def test_save_decision_cadence(monkeypatch):
    """The port of `tests/test_multiprocess.py:276`: over several ranks the
    decision is collective every ``save_check_every`` boundaries only, the
    local flag is never read in between, and one rank decides alone."""
    from types import SimpleNamespace

    import m3p_tpu_torch.parallel.mesh as M
    from m3p_tpu_torch.train.trainer import Trainer

    calls = []

    def fake_all_reduce(t, mesh, group=None):
        calls.append(float(t.sum()))
        return t + 0.0           # the other rank has nothing pending

    monkeypatch.setattr(M, "all_reduce_sum", fake_all_reduce)
    stub = SimpleNamespace(cfg=SimpleNamespace(save_check_every=10),
                           _pending_save=False, n_total_iter=0,
                           mesh=SimpleNamespace(size=2,
                                                device=torch.device("cpu")))
    should = Trainer._should_save_now
    stub._pending_save = True
    for it in range(1, 10):
        stub.n_total_iter = it
        assert should(stub) is False
    assert calls == []
    stub.n_total_iter = 10
    assert should(stub) is True and len(calls) == 1
    stub._pending_save = False
    stub.n_total_iter = 20
    assert should(stub) is False and len(calls) == 2
    # one rank: the local flag at every step, no collective
    stub.mesh = None
    stub._pending_save = True
    stub.n_total_iter = 3
    assert should(stub) is True and len(calls) == 2


class _Stop(Exception):
    pass


@pytest.mark.parametrize("case", ["broadcast_parameters", "save_decision",
                                  "all_reduce_sum", "all_gather_cat",
                                  "broadcast_"])
def test_tensors_reach_nccl_on_the_mesh_card(case, monkeypatch):
    """NCCL takes no host tensor: over a nccl mesh every tensor the
    trainer's parameter broadcast and check, its save decision and the
    collectives hand `torch.distributed` lies on the mesh's card, a host
    tensor given to a collective included.  The card is stood in for by
    the meta device (this machine has no other); the fake collectives
    record each tensor's device, and the one named ``stop`` ends the call
    there (a meta tensor holds no data to go on with)."""
    from types import SimpleNamespace

    import torch.distributed as dist

    import m3p_tpu_torch.parallel.mesh as M
    from m3p_tpu_torch.train.trainer import Trainer, broadcast_parameters

    seen = []

    def fake(name, stop):
        def op(*args, **kw):
            t = args[1] if name == "all_gather" else args[0]
            seen.append((name, t.device))
            if name == stop:
                raise _Stop
        return op

    stop = {"broadcast_": "broadcast"}.get(case, "all_reduce")
    monkeypatch.setattr(dist, "new_group", lambda *a, **kw: object())
    for name in ("all_reduce", "all_gather", "broadcast"):
        monkeypatch.setattr(dist, name, fake(name, stop if stop == name
                                             else "all_gather"))
    card = torch.device("meta")
    mesh = M.Mesh((2, 1, 1, 1, 1, 1), 0, card, "nccl")
    with pytest.raises(_Stop):
        if case == "broadcast_parameters":
            model = torch.nn.Sequential(torch.nn.Linear(3, 2),
                                        torch.nn.BatchNorm1d(2)).to(card)
            broadcast_parameters(model, mesh)
        elif case == "save_decision":
            stub = SimpleNamespace(cfg=SimpleNamespace(save_check_every=2),
                                   _pending_save=True, n_total_iter=4,
                                   mesh=mesh)
            Trainer._should_save_now(stub)
        elif case == "all_reduce_sum":
            M.all_reduce_sum(torch.ones(3), mesh)
        elif case == "all_gather_cat":
            M.all_gather_cat(torch.ones(3), mesh, "data")
        else:
            M.broadcast_(torch.ones(3), mesh)
    assert seen and all(device == card for _, device in seen), seen
    if case == "broadcast_parameters":       # float and int64 buffers
        assert [n for n, _ in seen] == ["broadcast"] * 2 + ["all_reduce"]
    with pytest.raises(ValueError, match="nccl"):
        M.Mesh((2, 1, 1, 1, 1, 1), 0, torch.device("cpu"), "nccl")


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    from test_torch_datasets import make_world
    from test_torch_row_pipeline import _families

    return _families(make_world(tmp_path_factory.mktemp("rows")))


@pytest.mark.parametrize("family", ["retrieval", "caption", "stream"])
def test_row_loader_rank_records_are_the_jax_grain_slice(
        families, family, monkeypatch):
    """Rank 1 of 2: the strided slice of the records before the shuffle,
    as `make_grain_loader` slices them by JAX process."""
    from m3p_tpu.data import grain_pipeline as JG
    from m3p_tpu_torch.data import row_pipeline as RP
    from test_torch_datasets import assert_same

    port, jax_ = families[0][family], families[1][family]
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    got = list(RP.make_row_loader(port, 3, seed=3, epoch=1, num_epochs=2,
                                  shard=(1, 2)))
    want = list(JG.make_grain_loader(jax_, 3, seed=3, epoch=1,
                                     num_epochs=2))
    assert len(got) == len(want) > 0
    assert_same(got, want, family)
    whole = list(RP.make_row_loader(port, 3, seed=3, epoch=1, num_epochs=2))
    assert len(whole) > len(got)


@pytest.mark.parametrize("recipe,flags", [
    ("generation_ntg", ["--split_data", "True", "--use_grain", "False"]),
    ("coco_two_languages", ["--ft_all", "True"])])
def test_split_data_and_ft_all_per_rank_match_the_jax_loader(
        data_dir, recipe, flags, monkeypatch):
    """Rank 1 of 2 loads what JAX process 1 of 2 loads: ``--split_data``
    streams split by feeder, ``--ft_all`` one language per rank."""
    from m3p_tpu.data.loader import load_data as jax_load_data
    from m3p_tpu_torch.data import loader as port_loader
    from test_torch_datasets import assert_same
    from test_torch_loader import RECIPES, _configs

    pcfg, jcfg, paths = _configs(data_dir, RECIPES[recipe] + flags)
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(port_loader, "_process", lambda: (1, 2))
    got = port_loader.load_data(pcfg, dataset_paths=paths)
    want = jax_load_data(jcfg, dataset_paths=paths)
    assert sorted(got.train_datasets) == sorted(want.train_datasets)
    for key, jds in want.train_datasets.items():
        pds = got.train_datasets[key]
        assert getattr(pds, "n_feeders", 1) == getattr(jds, "n_feeders", 1)
        assert_same(list(itertools.islice(pds.epoch_iterator(2, 0), 3)),
                    list(itertools.islice(jds.epoch_iterator(2, 0), 3)),
                    f"{recipe} {key}")



def test_train_x_over_two_ranks_trains_what_one_process_trains(
        pools, tmp_path):
    """`train_x.main` on each of 2 ranks with ``--mesh_data 2`` (the
    launcher's process group) against one process on the same global
    batches: the parameters after the epoch, an ITM recipe with the clip
    on."""
    from m3p_tpu_torch.cli import train_x
    from m3p_tpu_torch.tokenization.unigram import train_unigram
    from test_torch_ranks import record_data

    vocab = str(tmp_path / "vocab.tsv")
    train_unigram(["red cat dog runs blue tree house"] * 30,
                  vocab_size=80).save(vocab)
    argv = ["--lgs", "en", "--cross_rel_steps", "coco-img",
            "--max_region_num", "4", "--sample_n", "2", "--batch_size", "4",
            "--max_len", "9", "--emb_dim", "32", "--n_layers", "1",
            "--n_heads", "2", "--refine_layers", "1", "--dropout", "0.0",
            "--attention_dropout", "0.0", "--fp16", "False",
            "--epoch_size", "12",
            "--max_epoch", "1", "--use_grain", "False",
            "--optimizer", "adam,lr=0.001,eps=0.001",
            "--clip_grad_norm", "0.5", "--exp_name", "dp"]
    ranks = pools[2].run(
        "train_main", argv=argv + ["--dump_path", str(tmp_path / "two"),
                                   "--exp_id", "r", "--mesh_data", "2"],
        vocab=vocab, n_groups=16)
    one = train_x.main(argv + ["--dump_path", str(tmp_path / "one"),
                               "--exp_id", "o", "--device", "cpu"],
                       data=record_data(vocab, 16))
    assert [r["shards"] for r in ranks] == [(0, 2), (1, 2)]
    assert ranks[0]["mesh"]["data"] == 2
    assert ranks[0]["n_total_iter"] == one.n_total_iter == 3
    for name, p in one.model.named_parameters():
        for r in ranks:
            np.testing.assert_allclose(r["params"][name],
                                       p.detach().numpy(), **TOL,
                                       err_msg=name)
    # rank 0 wrote the state, each rank its own files beside it
    ckpt = tmp_path / "two" / "dp" / "r" / "checkpoint"
    assert (ckpt / "state.pt").exists() and (ckpt / "extra.json").exists()


@pytest.mark.parametrize("world,mesh_args,shards", [
    (2, ["--mesh_seq", "2"], [(0, 1)] * 2),
    (4, ["--mesh_data", "2", "--mesh_seq", "2"],
     [(0, 2), (0, 2), (1, 2), (1, 2)])], ids=["seq2", "data2_seq2"])
def test_train_x_sequence_parallel_trains_what_one_process_trains(
        pools, tmp_path, world, mesh_args, shards):
    """`train_x.main` on each rank with ``--mesh_seq 2`` (and ``--mesh_data
    2`` beside it) against one process on the same global batches: the
    trainer's SP route (`SPModel`) through an ITM task and a captioning
    task, whose causal decoding goes to the plain model; the parameters
    after the epoch."""
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
            "--clip_grad_norm", "0.5", "--exp_name", "sp"]
    ranks = pools[world].run(
        "train_main", argv=argv + ["--dump_path", str(tmp_path / "sp"),
                                   "--exp_id", "r"] + mesh_args,
        vocab=vocab, n_groups=16, caption=True)
    one = train_x.main(argv + ["--dump_path", str(tmp_path / "one"),
                               "--exp_id", "o", "--device", "cpu"],
                       data=record_data(vocab, 16, caption=True))
    assert [tuple(r["shards"]) for r in ranks] == shards
    assert {r["sp"] for r in ranks} == {"SPModel"}
    assert ranks[0]["mesh"]["seq"] == 2
    assert ranks[0]["n_total_iter"] == one.n_total_iter > 0
    for name, p in one.model.named_parameters():
        for r in ranks:
            np.testing.assert_allclose(r["params"][name],
                                       p.detach().numpy(), **TOL,
                                       err_msg=name)


def test_train_x_runs_under_torchrun(tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    m3p_tpu_torch.cli.train_x --device cpu --mesh_data 2`` over a COCO
    data directory, through the row loader: both ranks train and
    checkpoint, rank 0 the state, each rank its loader position."""
    import os
    import pickle
    import subprocess
    import sys

    from m3p_tpu_torch.data.features import write_feature_shard
    from m3p_tpu_torch.tokenization.unigram import train_unigram

    vocab = str(tmp_path / "vocab.tsv")
    train_unigram(["red cat dog runs blue tree house"] * 30,
                  vocab_size=80).save(vocab)
    rng = np.random.RandomState(0)
    root = tmp_path / "coco"
    root.mkdir()
    n, r = 12, 4
    write_feature_shard(
        str(root / "train.h5"),
        features=rng.randn(n, r, 2048).astype(np.float32),
        boxes=np.abs(rng.rand(n, r, 4)).astype(np.float32) * 50,
        num_boxes=np.full(n, r, np.int64), wh=np.full((n, 2), 100, np.float32),
        image_ids=[f"i{k}" for k in range(n)],
        objects=rng.randint(0, 1600, (n, r)))
    with open(root / "train.en.pkl", "wb") as f:
        pickle.dump({f"i{k}": ["red cat runs", "blue dog tree"]
                     for k in range(n)}, f)
    argv = ["--data_path", str(tmp_path), "--vocab_path", vocab,
            "--lgs", "en", "--cross_rel_steps", "coco-img",
            "--max_region_num", str(r), "--sample_n", "2", "--batch_size",
            "4", "--max_len", "12", "--emb_dim", "32", "--n_layers", "1",
            "--n_heads", "2", "--refine_layers", "1", "--fp16", "False",
            "--epoch_size", "8", "--max_epoch", "1", "--dump_path",
            str(tmp_path / "dump"), "--exp_name", "tr", "--exp_id", "a",
            "--device", "cpu", "--mesh_data", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "m3p_tpu_torch.cli.train_x"] + argv,
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    run = tmp_path / "dump" / "tr" / "a"
    log = (run / "train.log").read_text()
    assert "device mesh: {'data': 2} over 2 ranks, backend gloo" in log
    assert "parameters broadcast from rank 0 to 2 ranks and checked" in log
    assert (run / "train.log-1").exists()
    ckpt = run / "checkpoint"
    assert {p.name for p in ckpt.iterdir()} >= {
        "state.pt", "extra.json", "loader_state.0.json",
        "loader_state.1.json"}


def test_image_embeddings_take_the_distribution_as_in_jax():
    """`ImageEmbeddings`' optional class distribution (the SP image
    stream's ``dist`` input): the JAX module's output with its weights
    moved over; the reference table maps the projection, and a forward
    given ``dist`` without the weights raises."""
    from m3p_tpu.model.embeddings import ImageEmbeddings as JaxImageEmbeddings
    from m3p_tpu_torch.checkpoint import load_reference_state_dict
    from m3p_tpu_torch.model.embeddings import ImageEmbeddings

    rng = np.random.RandomState(4)
    feats = rng.randn(2, 5, 2048).astype(np.float32)
    locs = rng.rand(2, 5, 5).astype(np.float32)
    dist = rng.rand(2, 5, 1600).astype(np.float32)
    jm = JaxImageEmbeddings(dim=32)
    from flax.core import meta

    params = meta.unbox(jm.init(jax.random.PRNGKey(1), feats, locs,
                                dist)["params"])
    want = np.asarray(jm.apply({"params": params}, feats, locs, dist))
    port = ImageEmbeddings(32)
    with pytest.raises(ValueError, match="dist_proj"):
        port(torch.tensor(feats), torch.tensor(locs), torch.tensor(dist))
    port.add_dist_proj(1600)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)),
                         strict=True)
    got = port(torch.tensor(feats), torch.tensor(locs), torch.tensor(dist))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    w = rng.randn(32, 1600).astype(np.float32)
    sd = load_reference_state_dict(
        {"image_embeddings.image_distbution_embeddings.weight": w}, 1, 1)
    np.testing.assert_array_equal(sd["image_emb.dist_proj.weight"].numpy(), w)
