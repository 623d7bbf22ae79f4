"""The port's trainer (m3p_tpu_torch.train.trainer and utils/) against the
JAX package's: the lambda schedules, the task order and sampling, one
epoch of the multitask loop on the same JAX datasets (task sequence,
counters, stat means, parameters and the checkpoint's extras), the
end-of-epoch checkpoints and early stopping on the same scores, the SIGTERM
checkpoint and handler round trip, and the sample_alpha mask scores; every
step kind's loss and lambda, the is_freelb pair and the CLCM switch."""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from m3p_tpu.config import TrainConfig as JaxTrainConfig
from m3p_tpu.config import small_test_config as jax_small_config
from m3p_tpu.data.datasets import CaptionDataset, RetrievalDataset
from m3p_tpu.data.features import RegionFeatureStore, write_feature_shard
from m3p_tpu.model import build_model as jax_build_model
from m3p_tpu.tokenization.tokenizer import XLMRTokenizer as JaxTokenizer
from m3p_tpu.tokenization.unigram import train_unigram
from m3p_tpu.train import trainer as jax_trainer_mod
from m3p_tpu.utils import sampling as jax_sampling
from m3p_tpu.utils import schedules as jax_schedules
from m3p_tpu_torch import config as C
from m3p_tpu_torch.checkpoint import params_from_jax, save_checkpoint
from m3p_tpu_torch.data import synthetic
from m3p_tpu_torch.model import build_model
from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer
from m3p_tpu_torch.train import steps as S
from m3p_tpu_torch.train import trainer as trainer_mod
from m3p_tpu_torch.train.trainer import Trainer
from m3p_tpu_torch.utils import sampling, schedules

torch.set_num_threads(1)

# the fp32 parameter tolerance of the step tests (tests/test_torch_train.py)
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
# a task's stat mean: the mean of fp32 losses of the same batches
STAT_RTOL = 1e-5
WORDS = ["red", "cat", "dog", "tree", "house", "runs", "blue", "small",
         "green", "bird"]


def port_config(jcfg: JaxTrainConfig) -> C.TrainConfig:
    """The port's TrainConfig with every field of a JAX one."""
    d = dataclasses.asdict(jcfg)
    return C.TrainConfig(**{
        **d, "model": C.ModelConfig(**d["model"]),
        "optim": C.OptimConfig(**d["optim"]),
        "mesh": C.MeshConfig(**d["mesh"]), "data": C.DataConfig(**d["data"]),
        "eval": C.EvalConfig(**d["eval"])})


@pytest.mark.parametrize("spec", ["1", "0.25", "0:1,1000:0",
                                  "0:0,10:1,20:0.5", "5:2,3:1"])
def test_lambda_schedules_match_jax(spec):
    got = schedules.LambdaSchedule.parse(spec)
    want = jax_schedules.LambdaSchedule.parse(spec)
    assert got.knots == want.knots and got.is_constant == want.is_constant
    for step in (0, 1, 3, 4, 5, 9, 10, 15, 20, 21, 999, 1000, 5000):
        assert got(step) == want(step)
    cfg = {"mlm": spec, "ic": "0.5"}
    assert schedules.update_lambdas(schedules.parse_lambda_config(cfg), 7) \
        == jax_schedules.update_lambdas(
            jax_schedules.parse_lambda_config(cfg), 7)


def test_task_order_and_sampling_probs_match_jax():
    items = [0, 1, 2, 3, 4]
    sizes = {0: 10, 1: 1000, 2: 1, 3: 50, 4: 0}
    for coeff in (0.3, 0.7, 1.0):
        assert sampling.set_sampling_probs(sizes, coeff) == \
            jax_sampling.set_sampling_probs(sizes, coeff)
    probs = sampling.set_sampling_probs(sizes, 0.5)
    for n, p in ((5, None), (12, None), (3, probs), (40, probs)):
        a, b = np.random.RandomState(7), np.random.RandomState(7)
        for _ in range(4):
            assert sampling.shuf_order(items, p, n, a) == \
                jax_sampling.shuf_order(items, p, n, b)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX end-to-end test's world (`tests/test_end_to_end.py:29-69`):
    a unigram vocab, 16 images of 8 regions in an h5 store, 3 captions
    each, the small config with ``rel`` and ``ic`` on coco, no grain; an
    optimizer whose steps move the weights visibly, with accumulation."""
    tmp = tmp_path_factory.mktemp("trainer")
    rng = np.random.RandomState(0)
    corpus = [" ".join(rng.choice(WORDS, 6)) for _ in range(80)]
    vocab = str(tmp / "model.tsv")
    train_unigram(corpus, vocab_size=150).save(vocab)
    tokenizer = JaxTokenizer(vocab)
    n, r = 16, 8
    h5 = str(tmp / "feats.h5")
    write_feature_shard(
        h5, features=rng.randn(n, r, 2048).astype(np.float32),
        boxes=np.abs(rng.rand(n, r, 4)).astype(np.float32) * 100,
        num_boxes=np.full(n, r, np.int64), wh=np.full((n, 2), 224, np.float32),
        image_ids=[f"img{i}" for i in range(n)],
        objects=rng.randint(0, 1600, (n, r)))
    store = RegionFeatureStore(h5, max_region_num=r)
    captions = {i: [" ".join(rng.choice(WORDS, 5)) for _ in range(3)]
                for i in store.image_ids}
    cfg = jax_small_config()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, n_words=tokenizer.vocab_size,
                                  mask_index=tokenizer.mask_token_id,
                                  max_region_num=r),
        data=dataclasses.replace(cfg.data, batch_size=2, sample_n=2,
                                 max_len=16, use_grain=False),
        optim=dataclasses.replace(
            cfg.optim, accumulate_gradients=2,
            spec="adam_inverse_sqrt,beta1=0.9,beta2=0.98,lr=0.001,"
                 "warmup_updates=2,eps=0.001"),
        cross_rel_steps="coco-img", cross_ic_steps="coco-img",
        epoch_size=8)
    datasets = {
        ("rel", "coco"): RetrievalDataset(captions, store, tokenizer,
                                          sample_n=2, max_len=16),
        ("ic", "coco"): CaptionDataset(captions, store, tokenizer,
                                       max_len=16)}
    _, params = jax_build_model(cfg.model, jax.random.PRNGKey(0))
    return {"cfg": cfg, "datasets": datasets, "tmp": tmp, "vocab": vocab,
            "params": jax.tree.map(np.asarray, params)}


def _trainers(world, name, **changes):
    """A JAX trainer and a port trainer from the same weights and config,
    each with its own dump directory."""
    jcfg = world["cfg"].replace(**changes)
    dumps = {}
    for side in ("jax", "port"):
        dumps[side] = str(world["tmp"] / name / side)
        os.makedirs(dumps[side], exist_ok=True)
    jm, _ = jax_build_model(jcfg.model, jax.random.PRNGKey(0))
    jt = jax_trainer_mod.Trainer(
        jcfg.replace(dump_path=dumps["jax"]), jm,
        jax.tree.map(jnp.asarray, world["params"]), world["datasets"])
    pcfg = port_config(jcfg.replace(dump_path=dumps["port"]))
    model = build_model(pcfg.model, 0, "cpu")
    model.load_state_dict(params_from_jax(world["params"]), strict=True)
    pt = Trainer(pcfg, model, world["datasets"])
    return jt, pt


def _record_steps(trainer):
    seq = []
    step_once = trainer.step_once

    def recorded(kind, task):
        seq.append((kind, task))
        step_once(kind, task)

    trainer.step_once = recorded
    return seq


def test_one_epoch_matches_the_jax_trainer(world):
    """One `train_epoch` and `end_epoch` on the same JAX datasets: the same
    (kind, task) sequence, counters and stat means, the parameters within
    the step tests' fp32 tolerance, and ``extra.json`` alike."""
    jt, pt = _trainers(world, "epoch")
    assert pt.active_tasks() == jt.active_tasks()
    seq_j, seq_p = _record_steps(jt), _record_steps(pt)
    jt.train_epoch()
    pt.train_epoch()
    assert seq_p == seq_j and {k for k, _ in seq_p} == {"rel", "ic"}
    assert (pt.n_total_iter, pt.n_sentences) == \
        (jt.n_total_iter, jt.n_sentences)
    # one update per 2 micro-steps: optax's MultiSteps counts them
    assert pt.state.step == int(jt.state.opt_state.gradient_step)
    assert pt.state.opt_state["mini_step"] == int(jt.state.opt_state.mini_step)
    got, want = pt.stats.flush(), jt.stats.flush()
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=STAT_RTOL,
                                   err_msg=key)
    jt.end_epoch({})
    pt.end_epoch({})
    assert pt.epoch == jt.epoch == 1
    extras = {}
    for side, t in (("jax", jt), ("port", pt)):
        with open(os.path.join(t.cfg.dump_path, "checkpoint",
                               "extra.json")) as f:
            extras[side] = json.load(f)
    assert extras["port"] == extras["jax"]
    want_p = params_from_jax(jax.tree.map(np.asarray, jt.state.params))
    start = params_from_jax(world["params"])
    moved = 0.0
    for name, p in pt.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want_p[name].numpy(),
                                   err_msg=name, **PARAM_TOL)
        moved = max(moved, float((p - start[name]).abs().max()))
    assert moved > 1e-4


def test_reload_resumes_the_next_epoch(world):
    _, pt = _trainers(world, "reload")
    pt.n_total_iter, pt.n_sentences = 5, 10
    pt.best_metrics = {"I2T_acc": 50.0}
    pt.end_epoch({})
    cfg = pt.cfg
    fresh = Trainer(cfg, build_model(cfg.model, 1, "cpu"), world["datasets"])
    assert fresh.reload_checkpoint()
    assert (fresh.epoch, fresh.n_total_iter, fresh.best_metrics) == \
        (1, 5, {"I2T_acc": 50.0})
    for name, p in fresh.model.state_dict().items():
        assert torch.equal(p, pt.model.state_dict()[name]), name
    # a checkpoint with a loader state keeps the epoch and its sentence
    # budget (a task without a row loader restarts at the epoch's head)
    save_checkpoint(pt.checkpoint_path("mid"), pt.state,
                    {"epoch": 3, "n_total_iter": 9, "best_metrics": {},
                     "n_sentences": 4, "loader_state": {"rel|coco": {}}})
    assert fresh.reload_checkpoint("mid")
    assert (fresh.epoch, fresh._resume_sentences) == (3, 4)
    assert not fresh.reload_checkpoint("absent")


def test_end_epoch_checkpoints_and_early_stopping_match_jax(world):
    jt, pt = _trainers(
        world, "stopping", validation_metrics="valid_I2T_acc,_valid_loss",
        stopping_criterion="valid_I2T_acc,1", save_periodic=2,
        is_pretrain=True, save_every_epoch=3)
    # epochs 0-3: best-I2T_acc at 0, best-loss at 0 and 1, periodic-0 and
    # -2, model_pretrain_0, then no gain in two epochs stops the run
    runs = [{"I2T_acc": 50.0, "loss": 2.0}, {"I2T_acc": 40.0, "loss": 1.5},
            {"I2T_acc": 50.0, "loss": 1.7}, {"I2T_acc": 70.0, "loss": 1.0}]
    for scores in runs:
        for t in (jt, pt):
            if t.should_stop:
                continue
            t.save_best_model(scores)
            t.end_epoch(scores)
        assert (pt.best_metrics, pt.decrease_counts, pt.should_stop,
                pt.epoch) == (jt.best_metrics, jt.decrease_counts,
                              jt.should_stop, jt.epoch)
    assert pt.should_stop
    assert sorted(os.listdir(pt.cfg.dump_path)) == \
        sorted(os.listdir(jt.cfg.dump_path))
    assert "best-loss" in os.listdir(pt.cfg.dump_path)


class _Cycle:
    def __init__(self, batches):
        self.batches = batches

    def epoch_iterator(self, batch_size, epoch=0):
        yield from self.batches


def _small_port_trainer(tmp_path, **changes):
    cfg = C.small_test_config(cross_rel_steps="coco-img", epoch_size=12,
                              dump_path=str(tmp_path), **changes)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=2))
    rng = np.random.RandomState(0)
    pairs = [tuple(synthetic.make_retrieval_batch(
        rng, 2, cfg.data.sample_n, 12, 8, cfg.model.n_words)
        for _ in range(2)) for _ in range(2)]
    return Trainer(cfg, build_model(cfg.model, 0, "cpu"),
                   {("rel", "coco"): _Cycle(pairs)})


def test_sigterm_checkpoints_at_the_next_step_boundary(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    pt = _small_port_trainer(tmp_path)
    pt.install_preemption_handler()
    try:
        step_once = pt.step_once

        def kill_in_the_third(kind, task):
            step_once(kind, task)
            if pt.n_total_iter == 3:
                os.kill(os.getpid(), signal.SIGTERM)
                assert pt._pending_save

        pt.step_once = kill_in_the_third
        pt.train_epoch()
    finally:
        pt.uninstall_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) == before
    assert not pt._pending_save
    with open(tmp_path / "checkpoint" / "extra.json") as f:
        assert json.load(f)["n_total_iter"] == 3
    assert pt.n_total_iter == 6
    pt.uninstall_preemption_handler()          # a second uninstall: no-op
    assert signal.getsignal(signal.SIGTERM) == before


def test_handler_restores_a_handler_installed_outside_python(tmp_path):
    pt = _small_port_trainer(tmp_path)
    previous = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    try:
        pt.install_preemption_handler()
        pt._prev_sigterm = None        # as signal.signal reports a C handler
        pt.uninstall_preemption_handler()
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    finally:
        signal.signal(signal.SIGTERM, previous)


def test_mask_scores_from_the_tokenizer_match_jax(world):
    got = trainer_mod._mask_scores_from_tokenizer(
        XLMRTokenizer(world["vocab"]), 160, 0.3, 1)
    want = jax_trainer_mod._mask_scores_from_tokenizer(
        JaxTokenizer(world["vocab"]), 160, 0.3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert trainer_mod._mask_scores_from_tokenizer(object(), 16, 0.3, 1) \
        is None


def test_active_tasks_from_the_step_flags_match_jax():
    for flags in (
            dict(mlm_steps="en,de", is_generation=True, clm_steps="en",
                 cross_rel_steps="coco-img", cross_ic_steps="coco-img",
                 cross_mt_steps="en-de", is_mt=True, slide_steps="ppt",
                 tifg_steps="coco-img", cross_ae_steps="coco-img",
                 pc_steps="en-de", ae_steps="en", mass_steps="de"),
            dict(cross_rel_steps="coco-img,flicker-img", is_pretrain=True,
                 text_steps="en-de", is_ntg=True)):
        jcfg = jax_small_config().replace(**flags)
        jt = jax_trainer_mod.Trainer(jcfg, None, {"w": jnp.zeros(2)})
        pt = Trainer(port_config(jcfg), torch.nn.Linear(2, 2))
        assert pt.active_tasks() == jt.active_tasks()


def test_trainer_refuses_what_item_16_brings(tmp_path):
    """A mesh is taken (one rank here: the trainer runs as without one;
    `tests/test_torch_parallel.py`, `tests/test_torch_sharding.py` and
    `tests/test_torch_pp.py` run several); ``seq``, ``fsdp``, ``tensor``,
    ``expert`` and ``pp`` in the config without a mesh run unsharded, as
    in JAX; ``pp`` with ``seq`` raises, as the JAX trainer asserts."""
    from m3p_tpu_torch.parallel.mesh import make_mesh

    cfg = C.small_test_config(dump_path=str(tmp_path))
    model = torch.nn.Linear(2, 2)
    trainer = Trainer(cfg, model, mesh=make_mesh(cfg.mesh))
    assert trainer.mesh is None and trainer.state.mesh is None
    assert (trainer.shard_index, trainer.shard_count) == (0, 1)
    seq = cfg.replace(mesh=dataclasses.replace(cfg.mesh, seq=2))
    assert Trainer(seq, model).loss_model is model
    for axes in ({"fsdp": 2}, {"tensor": 2}, {"expert": 2}, {"pp": 2},
                 {"pp": 2, "tensor": 2}):
        one = cfg.replace(mesh=dataclasses.replace(cfg.mesh, **axes))
        trainer = Trainer(one, model)
        assert trainer.mesh is None and trainer.loss_model is model
    both = cfg.replace(mesh=dataclasses.replace(cfg.mesh, pp=2, seq=2))
    with pytest.raises(ValueError, match="seq and pp"):
        Trainer(both, model)


def _small_batches(cfg, rng):
    """One batch of each layout at the small config's sizes."""
    from m3p_tpu_torch.data import loader, noise

    n_words, regions = cfg.model.n_words, cfg.model.max_region_num
    s, g, n = cfg.data.max_len, 2, cfg.data.sample_n
    stream = synthetic.make_stream_batch(rng, 2, s, n_words)
    mt = synthetic.make_mt_batch(rng, 2, s, n_words)
    caption = synthetic.make_caption_batch(rng, 2, s, regions, n_words)
    mt_ic = dict(mt, **{k: caption[k] for k in ("feats", "locs", "img_len")})
    a, b = (synthetic.make_stream_batch(rng, 2, s // 2, n_words)
            for _ in range(2))
    toks, lens, pos, langs = noise.concat_batches(
        a["tokens"], a["lengths"], 0, b["tokens"], b["lengths"], 1)
    return {
        "stream": stream, "mt": mt, "caption": caption, "mt_ic": mt_ic,
        "retrieval": synthetic.make_retrieval_batch(rng, g, n, s, regions,
                                                    n_words),
        "pretrain": synthetic.make_pretrain_batch(rng, g, n, s, regions,
                                                  n_words),
        "slide": synthetic.make_slide_batch(rng, 2, s, regions, n_words),
        "mass": loader.make_mass_transform(0.5, cfg.model.mask_index,
                                           n_words)(rng, stream, 0),
        "pc": {"tokens": toks, "lengths": lens, "positions": pos,
               "langs": langs,
               "labels": rng.randint(0, 2, (2,)).astype(np.int32)},
    }


# step kind -> (its batch, its lambda or None, the loss it must run)
STEP_KINDS = {
    "mlm": ("stream", "lambda_mlm",
            lambda t, m, b, g: S.mlm_loss(m, b, g, t.mask_cfg)),
    "clm": ("stream", "lambda_clm", lambda t, m, b, g: S.clm_loss(m, b, g)),
    "rel": ("retrieval", None, lambda t, m, b, g: S.itm_finetune_loss(
        m, b, g, t.cfg.data.sample_n)),
    "pretrain_rel": ("pretrain", "lambda_mlm",
                     lambda t, m, b, g: S.mct_pretrain_loss(
                         m, b, g, t.mask_cfg, t.cfg.data.sample_n,
                         lambda_mlm=0.5)),
    "ic": ("caption", "lambda_ic",
           lambda t, m, b, g: S.caption_loss(m, b, g)),
    "mt": ("mt", "lambda_mt", lambda t, m, b, g: S.mt_loss(m, b, g)),
    "ntg": ("mt", "lambda_mt", lambda t, m, b, g: S.mt_loss(m, b, g)),
    "mt_ic": ("mt_ic", "lambda_mt",
              lambda t, m, b, g: S.mt_caption_loss(m, b, g)),
    "slide": ("slide", None, lambda t, m, b, g: S.slide_loss(m, b, g)),
    "mass": ("mass", "lambda_mass", lambda t, m, b, g: S.mass_loss(m, b, g)),
    "bart": ("mt", "lambda_imlm", lambda t, m, b, g: S.mt_loss(m, b, g)),
    "ae": ("mt", "lambda_ae", lambda t, m, b, g: S.mt_loss(m, b, g)),
    "bart_img": ("caption", "lambda_ida",
                 lambda t, m, b, g: S.caption_loss(m, b, g)),
    "tifg": ("caption", "lambda_tifg",
             lambda t, m, b, g: S.tifg_loss(m, b, g)),
    "pc": ("pc", "lambda_pc", lambda t, m, b, g: S.pc_loss(m, b, g)),
}


@pytest.mark.parametrize("kind", sorted(STEP_KINDS))
def test_every_step_kind_runs_its_loss_scaled_by_its_lambda(kind, tmp_path):
    """Each kind of `m3p_tpu/train/trainer.py:151-244` runs the loss the
    JAX trainer runs for it, times its lambda (the MCT loss takes the
    lambdas as arguments), on the generators of the step's seed; its step
    makes one update."""
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train.steps import expand_compact_batch

    cfg = C.small_test_config(dump_path=str(tmp_path), is_mt=True)
    pt = Trainer(cfg, build_model(cfg.model, 0, "cpu"))
    name, lam, reference = STEP_KINDS[kind]
    raw = _small_batches(cfg, np.random.RandomState(3))[name]
    batch = expand_compact_batch({
        k: torch.from_numpy(np.asarray(v).astype(np.int64)
                            if np.issubdtype(np.asarray(v).dtype, np.integer)
                            else np.asarray(v)) for k, v in raw.items()})
    lambdas = {"lambda_mlm": 0.5, lam: 0.5} if lam else {}
    with torch.no_grad():
        got, _ = pt._loss_fn(kind)(pt.model, batch,
                                   Generators.from_seed(7, "cpu"), **lambdas)
        want, _ = reference(pt, pt.model, batch,
                            Generators.from_seed(7, "cpu"))
    scale = 0.5 if lam and kind != "pretrain_rel" else 1.0
    assert torch.isfinite(got)
    torch.testing.assert_close(got, scale * want, rtol=0, atol=0)
    pt.state, metrics = pt._get_step(kind)(pt.state, batch, 11, **lambdas)
    assert pt.state.step == 1 and metrics


@pytest.mark.parametrize("kind", ["rel", "pretrain_rel", "ic"])
def test_is_freelb_runs_the_plain_step_then_the_freelb_one(kind, tmp_path):
    cfg = C.small_test_config(dump_path=str(tmp_path), is_freelb=True,
                              adv_steps=2)
    pt = Trainer(cfg, build_model(cfg.model, 0, "cpu"))
    name = {"rel": "retrieval", "pretrain_rel": "pretrain",
            "ic": "caption"}[kind]
    raw = _small_batches(cfg, np.random.RandomState(4))[name]
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in raw.items()}
    pt.state, metrics = pt._get_step(kind)(pt.state, batch, 5,
                                           lambda_ic=0.5, lambda_mlm=0.5)
    assert pt.state.step == 2           # the plain update, then FreeLB's
    assert torch.isfinite(metrics["adv_loss"])


def test_clcm_rides_the_pretrain_batches_where_the_dataset_takes_it(
        tmp_path):
    calls = []

    class WithClcm:
        def epoch_iterator(self, batch_size, epoch=0, with_clcm=False):
            calls.append(("with", with_clcm))
            yield {}

    class Plain:
        def epoch_iterator(self, batch_size, epoch=0):
            calls.append(("plain", None))
            yield {}

    cfg = C.small_test_config(dump_path=str(tmp_path), is_pretrain=True,
                              cross_clcm_steps="coco-img")
    pt = Trainer(cfg, build_model(cfg.model, 0, "cpu"),
                 {("rel", "coco"): WithClcm(), ("rel", "sbu"): Plain()})
    for task in pt.datasets:
        next(pt._make_iterator(task))
    pt._close_iterators()
    assert sorted(calls) == [("plain", None), ("with", True)]


def test_row_loader_resumes_mid_epoch_with_bitwise_batches_and_losses(
        tmp_path):
    """The counterpart of `tests/test_checkpoint.py::
    test_grain_mid_epoch_resume`: a port `Trainer` over a port
    `RetrievalDataset` through the row loader (2 read threads, the staging
    thread ahead of the steps) at depth 2 with dropout 0.1, a checkpoint
    after 2 steps, a fresh `Trainer` and model reloading it: the next
    steps' batches and losses are bitwise the uninterrupted run's, and the
    run does not rewind to the epoch's head."""
    from m3p_tpu_torch.data.datasets import RetrievalDataset as PortRetrieval
    from test_torch_datasets import make_world

    w = make_world(tmp_path)
    tok, store = w["port"]["tok"], w["port"]["stores"][0]
    cfg = C.small_test_config(
        cross_rel_steps="coco-img", epoch_size=1000,
        dump_path=str(tmp_path / "dump"), n_words=tok.vocab_size,
        mask_index=tok.mask_token_id, dropout=0.1, attention_dropout=0.1,
        batch_size=2, max_len=12, num_workers=2)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, max_region_num=4,
                                  img_feat_dim=store.feat_dim),
        data=dataclasses.replace(cfg.data, max_region_num=4))
    assert cfg.data.use_grain
    os.makedirs(cfg.dump_path)
    task = ("rel", "coco")

    def trainer(seed):
        ds = PortRetrieval(w["captions"][0], store, tok, sample_n=2,
                           max_len=12, seed=cfg.seed)
        t = Trainer(cfg, build_model(cfg.model, seed, "cpu"), {task: ds})
        seen = []
        get_batch = t._get_batch

        def recorded(key):
            seen.append(get_batch(key))
            return seen[-1]

        t._get_batch = recorded
        return t, seen

    def steps(t, n):
        losses = []
        for _ in range(n):
            t.step_once("rel", task)
            losses.append(t.stats.flush()["rel-coco"])
        return losses

    ta, seen_a = trainer(0)
    steps(ta, 2)
    ta.save_checkpoint()
    assert ta._taken[task] == 2
    losses_a = steps(ta, 3)
    tb, seen_b = trainer(7)
    assert tb.reload_checkpoint()
    assert (tb.epoch, tb._resume_sentences) == (ta.epoch, 4)
    losses_b = steps(tb, 3)
    assert losses_b == losses_a
    for a, b in zip(seen_a[2:], seen_b):
        for half_a, half_b in zip(a, b):
            assert half_a.keys() == half_b.keys()
            for k in half_a:
                assert torch.equal(half_a[k], half_b[k]), k
    assert not torch.equal(seen_b[0][0]["tokens"], seen_a[0][0]["tokens"])
    ta._close_iterators()
    tb._close_iterators()
