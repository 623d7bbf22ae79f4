"""Training orchestration of the port (counterpart of
`m3p_tpu/train/trainer.py`, the reference `Trainer`/`XTrainer` control
plane and its epoch loop).

One `Trainer` owns: the per-objective steps over the losses of
`train/steps.py` (and `train/freelb.py` under ``is_freelb``), the train
state, the lambda schedules read at every step, per-task stats that stay on
the device until they are logged, the shuffled task dispatch
(`shuf_order`), the datasets' iterators staged through
`data/pipeline.py::prefetch_to_device`, checkpoint save and reload with
best-metric tracking and early stopping, and the SIGTERM checkpoint.

Under ``--use_grain`` (the default), a dataset of a family that
`data/row_pipeline.py` takes goes through its checkpointable row loader,
and a checkpoint holds each loader's position: a run preempted mid-epoch
resumes with the batches it had not taken, none repeated or skipped.  The
staging thread runs ahead of the steps, so the position saved is that of
the batches the steps took, not of those the thread staged.  Other
datasets go through their ``epoch_iterator``, and a resume starts them at
the epoch's head.

Several processes (`parallel.mesh.Mesh`, `m3p_tpu/train/trainer.py:
55-104,323-361,559-583`): rank 0's parameters are broadcast once (and
checked) before the optimizer state is made; each rank takes its shard of
every global batch (``batch_size / (data x fsdp)`` rows: the row loader's
strided slice of the records, or every count-th batch of an iterator seeded
alike on every rank); its generators fold in the shard index; the gradients
are averaged over the ranks before the clip (`TrainState.sync_gradients`).
With ``seq > 1`` the steps run through `parallel.sp.SPModel`, with
``pp > 1`` through `parallel.pipeline.PPModel` (the GPipe schedule over
``cfg.mesh.pp_microbatches`` microbatches).  With
``fsdp``, ``tensor`` or ``expert`` above 1 the model's parameters are
sharded after the broadcast (`parallel.sharding.shard_model`, the
counterpart of `m3p_tpu/train/trainer.py:86-99`), and the optimizer state
made from them holds shards too.  The save decision is collective every
``save_check_every`` steps; the state is gathered whole, rank 0 writes
it, every rank its own loader state.
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
import logging
import os
import signal
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from m3p_tpu_torch import checkpoint as ckpt
from m3p_tpu_torch.data.masking import MaskingConfig
from m3p_tpu_torch.data.pipeline import prefetch_to_device
from m3p_tpu_torch.data.row_pipeline import (
    make_row_loader, restore_loader_state, save_loader_state, supports_grain)
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.model.transformer import M3PModel
from m3p_tpu_torch.parallel.sharding import (
    check_mesh_supported, is_sharded, shard_bytes, shard_model)
from m3p_tpu_torch.train import steps as S
from m3p_tpu_torch.train.optim import build_optimizer
from m3p_tpu_torch.train.state import create_train_state
from m3p_tpu_torch.utils.metrics import SpeedMeter, StatsAccumulator
from m3p_tpu_torch.utils.sampling import set_sampling_probs, shuf_order
from m3p_tpu_torch.utils.schedules import parse_lambda_config, update_lambdas

logger = logging.getLogger("m3p_tpu_torch")

class Trainer:
    def __init__(self, cfg, model: M3PModel,
                 datasets: Optional[Dict[Tuple[str, str], Any]] = None,
                 tokenizer=None, mesh=None):
        check_mesh_supported(dataclasses.asdict(cfg.mesh))
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.datasets = datasets or {}
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        # the model the losses see: sequence parallelism swaps the handle so
        # every objective's non-causal stack runs sharded
        self.loss_model = model
        if self.mesh is not None:
            check_mesh_supported(self.mesh.shape)
            broadcast_parameters(model, self.mesh)
            if is_sharded(self.mesh.shape):
                shard_model(model, self.mesh)
                held = shard_bytes(model)
                logger.info("parameters sharded over %s: %d of %d bytes on "
                            "this rank", {a: self.mesh.shape[a] for a in (
                                "fsdp", "tensor", "expert")},
                            held["local"], held["whole"])
            if self.mesh.shape["seq"] > 1:
                from m3p_tpu_torch.parallel.sp import SPModel

                self.loss_model = SPModel(model, self.mesh)
                logger.info("sequence parallelism ON: seq=%d (ring "
                            "attention)", self.mesh.shape["seq"])
            elif self.mesh.shape["pp"] > 1:
                from m3p_tpu_torch.parallel.pipeline import PPModel

                self.loss_model = PPModel(
                    model, self.mesh,
                    n_microbatches=cfg.mesh.pp_microbatches)
                logger.info("pipeline parallelism ON: pp=%d stages, %d "
                            "microbatches", self.mesh.shape["pp"],
                            cfg.mesh.pp_microbatches)
        self.shard_index, self.shard_count = (
            self.mesh.batch_shards if self.mesh is not None else (0, 1))

        tx, self.lr_schedule = build_optimizer(
            cfg.optim.spec, clip_grad_norm=cfg.optim.clip_grad_norm,
            accumulate_gradients=cfg.optim.accumulate_gradients,
            weight_decay=cfg.optim.weight_decay)
        self.state = create_train_state(model, tx, self.mesh)

        self.mask_cfg = MaskingConfig(
            word_pred=cfg.data.word_pred,
            mask_keep_rand=tuple(
                float(x) for x in cfg.data.word_mask_keep_rand.split(",")),
            obj_mask_ratio=cfg.data.obj_mask_ratio,
            max_pred=cfg.data.max_pred_per_seq,
            n_words=cfg.model.n_words,
            mask_index=cfg.model.mask_index,
            pad_index=cfg.model.pad_index)
        # sample_alpha > 0: skew MLM selection toward rare words
        self.mask_scores = None
        if cfg.data.sample_alpha > 0 and tokenizer is not None:
            self.mask_scores = _mask_scores_from_tokenizer(
                tokenizer, cfg.model.n_words, cfg.data.sample_alpha,
                cfg.model.pad_index, self.device)

        self.schedules = parse_lambda_config({
            "mlm": cfg.lambda_mlm, "rel": cfg.lambda_rel,
            "mrm": cfg.lambda_mrm, "mrfr": cfg.lambda_mrfr,
            "clcm": cfg.lambda_clcm, "ic": cfg.lambda_ic,
            "mt": cfg.lambda_mt, "t2i": cfg.lambda_t2i,
            "i2t": cfg.lambda_i2t, "clm": cfg.lambda_clm,
            "mass": cfg.lambda_mass, "imlm": cfg.lambda_imlm,
            "ida": cfg.lambda_ida, "tifg": cfg.lambda_tifg,
            "pc": cfg.lambda_pc, "ae": cfg.lambda_ae,
        })

        self.stats = StatsAccumulator()
        self.speed = SpeedMeter()
        self.rng = np.random.RandomState(cfg.seed)
        self.epoch = 0
        self.n_total_iter = 0
        self.n_sentences = 0
        self.best_metrics: Dict[str, float] = {}
        self.decrease_counts = 0
        self.should_stop = False
        self._steps: Dict[str, Callable] = {}
        self._iterators: Dict[Tuple[str, str], Iterator] = {}
        # the row loaders of the tasks that have one, and the batches the
        # steps took from each since it was made or restored
        self._loaders: Dict[Tuple[str, str], Any] = {}
        self._taken: Dict[Tuple[str, str], int] = {}
        self._resume_sentences = 0
        self._pending_save = False

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _loss_fn(self, kind: str) -> Callable:
        """``loss_fn(model, batch, generators, **lambdas)`` of a step kind
        (`m3p_tpu/train/trainer.py:151-244`); each picks the lambda
        scalars it uses, and scales the loss, not its metrics."""
        cfg = self.cfg

        def scaled(loss_fn, lam_name, **kw):
            def fn(model, b, gen, **lam):
                loss, m = loss_fn(model, b, gen, **kw)
                return lam.get(lam_name, 1.0) * loss, m
            return fn

        if kind == "mlm":
            return scaled(S.mlm_loss, "lambda_mlm", mask_cfg=self.mask_cfg,
                          mask_scores=self.mask_scores)
        if kind == "clm":
            return scaled(S.clm_loss, "lambda_clm",
                          context_size=cfg.context_size)
        if kind == "rel":
            def rel(model, b, gen, **lam):
                return S.itm_finetune_loss(
                    model, b, gen, cfg.data.sample_n,
                    refine_image=cfg.refine_image,
                    multi_cls_weight=cfg.multi_cls_loss_weight,
                    bin_cls_weight=cfg.bin_cls_loss_weight)
            return rel
        if kind == "pretrain_rel":
            def pretrain(model, b, gen, **lam):
                return S.mct_pretrain_loss(
                    model, b, gen, self.mask_cfg, cfg.data.sample_n,
                    mask_scores=self.mask_scores,
                    pack_ratio=cfg.data.mlm_pack_ratio,
                    refine_image=cfg.refine_image,
                    multi_cls_weight=cfg.multi_cls_loss_weight,
                    bin_cls_weight=cfg.bin_cls_loss_weight,
                    **_mct_lambdas(lam))
            return pretrain
        if kind == "ic":
            return scaled(S.caption_loss, "lambda_ic",
                          refine_image=cfg.refine_image,
                          refine_encoder=cfg.refine_encoder)
        if kind in ("mt", "ntg") or (kind == "mt_ic" and cfg.mt_only_text):
            # `--mt_only_text`: multimodal MT without the image stream
            return scaled(S.mt_loss, "lambda_mt")
        if kind == "mt_ic":
            return scaled(S.mt_caption_loss, "lambda_mt",
                          refine_image=cfg.refine_image)
        if kind == "slide":
            return S.slide_loss
        # batches of the denoising objectives come pre-noised from the
        # loader's host transforms
        if kind == "mass":
            return scaled(S.mass_loss, "lambda_mass")
        if kind == "bart":
            return scaled(S.mt_loss, "lambda_imlm")
        if kind == "ae":
            return scaled(S.mt_loss, "lambda_ae")
        if kind == "bart_img":
            # IDA region-denoising captioning (`refine_image` only)
            return scaled(S.caption_loss, "lambda_ida",
                          refine_image=cfg.refine_image)
        if kind == "tifg":
            return scaled(S.tifg_loss, "lambda_tifg")
        if kind == "pc":
            return scaled(S.pc_loss, "lambda_pc")
        raise ValueError(f"unknown step kind: {kind}")

    def _get_step(self, kind: str) -> Callable:
        """(state, batch, seed, **lambdas) -> (state, metrics): one
        micro-step of the kind, its randomness from fresh `Generators` of
        ``seed`` on the model's device.  Under ``is_freelb`` the ``rel``,
        ``pretrain_rel`` and ``ic`` kinds run the plain step and then the
        FreeLB one, each from generators of the same seed, as the JAX pair
        shares one key (`m3p_tpu/train/trainer.py:249-288`)."""
        if kind in self._steps:
            return self._steps[kind]
        cfg, model, device = self.cfg, self.loss_model, self.device
        fold = self.shard_index
        loss_fn = self._loss_fn(kind)
        plain = S.make_train_step(
            lambda _model, b, gen, **lam: loss_fn(model, b, gen, **lam))

        def step(state, b, seed, **lam):
            return plain(state, b, Generators.from_seed(seed, device, fold),
                         **lam)

        if cfg.is_freelb and kind in ("rel", "pretrain_rel", "ic"):
            from m3p_tpu_torch.train.freelb import (
                FreeLBConfig, make_freelb_ic_step, make_freelb_itm_step,
                make_freelb_pretrain_step)

            fl = FreeLBConfig(adv_steps=cfg.adv_steps, adv_lr=cfg.adv_lr,
                              adv_max_norm=cfg.adv_max_norm,
                              norm_type=cfg.norm_type,
                              free_text=cfg.free_text,
                              free_img=cfg.free_img)
            if kind == "rel":
                adv = make_freelb_itm_step(model, cfg.data.sample_n, fl,
                                           refine_image=cfg.refine_image)
            elif kind == "pretrain_rel":
                adv0 = make_freelb_pretrain_step(
                    model, cfg.data.sample_n, self.mask_cfg, fl,
                    refine_image=cfg.refine_image)

                def adv(st, b, gen, **lam):
                    return adv0(st, b, gen, **_mct_lambdas(lam))
            else:
                adv = make_freelb_ic_step(model, fl,
                                          refine_image=cfg.refine_image,
                                          refine_encoder=cfg.refine_encoder)

            def combined(state, b, seed, **lam):
                state, m = step(state, b, seed, **lam)
                state, m_adv = adv(state, b,
                                   Generators.from_seed(seed, device, fold),
                                   **lam)
                m = dict(m)
                m["adv_loss"] = m_adv["loss"]
                return state, m

            self._steps[kind] = combined
            return combined

        self._steps[kind] = step
        return step

    # ------------------------------------------------------------------
    # data plumbing
    # ------------------------------------------------------------------

    def _get_batch(self, task: Tuple[str, str]):
        it = self._iterators.get(task)
        if it is None:
            it = self._make_iterator(task)
        try:
            batch = next(it)
        except StopIteration:
            self._close_iterator(task)
            try:
                batch = next(self._make_iterator(task))
            except StopIteration:
                raise ValueError(
                    f"dataset for {task} yields no batches (fewer records "
                    "than one batch?)") from None
        if task in self._taken:
            self._taken[task] += 1
        return batch

    def _with_clcm(self) -> bool:
        """CLCM rides pretrain i2t batches only when --cross_clcm_steps is
        non-empty (`xtrainer.py:2380`)."""
        return self.cfg.is_pretrain and bool(self.cfg.cross_clcm_steps)

    def _uses_row_loader(self, task: Tuple[str, str]) -> bool:
        return self.cfg.data.use_grain and supports_grain(self.datasets[task])

    def _make_iterator(self, task: Tuple[str, str],
                       loader_state: Optional[str] = None):
        """The task's dataset iterator for this epoch, staged on the
        device: the row loader's (`m3p_tpu/train/trainer.py:332-341`),
        sought to ``loader_state`` when one is given and readable, or the
        dataset's ``epoch_iterator``.  CLCM pairs are asked for where the
        dataset's ``epoch_iterator`` takes ``with_clcm`` (the pre-training
        datasets; the JAX trainer tests for its ``PretrainDataset``).

        Over several batch shards each rank builds its shard of the global
        batch (``batch_size / count`` rows): the row loader from its
        strided slice of the records; a dataset iterator, seeded alike on
        every rank, gives every count-th batch from the shard's index,
        unless its records are split by feeder already (``n_feeders``)."""
        dataset = self.datasets[task]
        bs = self.cfg.data.batch_size
        count = self.shard_count
        if bs % count:
            raise ValueError(f"batch_size {bs} does not split over {count} "
                             "batch shards (data x fsdp)")
        bs //= count
        if self._uses_row_loader(task):
            raw = iter(make_row_loader(
                dataset, bs, seed=self.cfg.seed, epoch=self.epoch,
                with_clcm=self._with_clcm(),
                worker_count=self.cfg.data.num_workers,
                shard=(self.shard_index, count)))
            if loader_state is not None:
                try:
                    restore_loader_state(raw, loader_state)
                except ValueError as e:
                    # a position this loader cannot read (another format,
                    # dataset or batch size): only the position is lost
                    logger.warning(
                        "loader state for %s not restorable (%s) - "
                        "restarting that iterator from the epoch head",
                        task, e)
            self._loaders[task] = raw
            self._taken[task] = 0
        else:
            if self._with_clcm() and "with_clcm" in inspect.signature(
                    dataset.epoch_iterator).parameters:
                raw = dataset.epoch_iterator(bs, self.epoch, with_clcm=True)
            else:
                raw = dataset.epoch_iterator(bs, self.epoch)
            if count > 1 and getattr(dataset, "n_feeders", 1) <= 1:
                raw = itertools.islice(raw, self.shard_index, None, count)
        it = prefetch_to_device(raw, device=self.device)
        self._iterators[task] = it
        return it

    def _close_iterator(self, task: Tuple[str, str]) -> None:
        """Stop the task's staging thread, then its loader's read threads."""
        it = self._iterators.pop(task, None)
        if it is not None:
            it.close()
        loader = self._loaders.pop(task, None)
        if loader is not None:
            loader.close()
        self._taken.pop(task, None)

    def _close_iterators(self) -> None:
        for task in list(self._iterators):
            self._close_iterator(task)

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    def step_once(self, kind: str, task: Tuple[str, str]) -> None:
        """Run one step of the given objective: one micro-step, or two for
        a ``(t2i, i2t)`` pair (`m3p_tpu/train/trainer.py:381-416`)."""
        batch = self._get_batch(task)
        lambdas = update_lambdas(self.schedules, self.n_total_iter)
        lam_kwargs = {f"lambda_{k}": v for k, v in lambdas.items()}
        step = self._get_step(kind)
        # the integer the JAX trainer makes its step's PRNGKey from: stable
        # across processes and restarts (Python's hash() is salted)
        task_h = zlib.crc32("-".join(map(str, task)).encode()) % 10007
        seed = self.cfg.seed + self.n_total_iter * 977 + task_h

        def stat_value(metrics):
            for name in ("loss", "ce", kind):
                if name in metrics:
                    return metrics[name]
            return next((v for k, v in metrics.items() if k != "acc"), 0.0)

        if isinstance(batch, tuple):  # (t2i, i2t) paired batches
            # --t2i_flag/--i2t_flag train a single direction
            gates = (self.cfg.t2i_flag, self.cfg.i2t_flag)
            for b, on in zip(batch, gates):
                if not on:
                    continue
                self.state, metrics = step(self.state, b, seed, **lam_kwargs)
                self.stats.add(f"{kind}-{task[1]}", stat_value(metrics))
        else:
            self.state, metrics = step(self.state, batch, seed, **lam_kwargs)
            self.stats.add(f"{kind}-{task[1]}", stat_value(metrics))
        bs = self.cfg.data.batch_size
        self.n_sentences += bs
        self.speed.update(bs, bs * self.cfg.data.max_len)
        self.iter()

    def iter(self) -> None:
        self.n_total_iter += 1
        if self.n_total_iter % 20 == 0:
            self.print_stats()

    def print_stats(self) -> None:
        rates = self.speed.rates()
        # the schedule counts optimizer updates, one per k micro-steps under
        # accumulate_gradients = k, so the lr logged is the one applied
        k = max(1, self.cfg.optim.accumulate_gradients)
        lr = float(self.lr_schedule(self.n_total_iter // k))
        logger.info("iter %d - %s - %.1f sent/s - %.0f words/s - lr %.3e",
                    self.n_total_iter, self.stats.format(),
                    rates["sentences_per_s"], rates["words_per_s"], lr)
        self.speed.reset()

    # dataset-key prefix -> step kind; "rel"/"mt" resolve per config below
    _TASK_KINDS = ("mlm", "clm", "rel", "ic", "mt", "ntg", "slide", "mass",
                   "bart", "pc", "tifg", "bart_img", "ae")

    def active_tasks(self) -> List[Tuple[str, Tuple[str, str]]]:
        """(step_kind, dataset_key) pairs: from the dataset keys when there
        are datasets, else from the config's step DSLs
        (`m3p_tpu/train/trainer.py:442-496`)."""

        def kind_of(prefix: str) -> str:
            if prefix == "rel":
                return "pretrain_rel" if self.cfg.is_pretrain else "rel"
            if prefix == "mt":
                return "mt_ic" if self.cfg.is_mt else "mt"
            return prefix

        if self.datasets:
            return [(kind_of(key[0]), key)
                    for key in sorted(self.datasets.keys())
                    if key[0] in self._TASK_KINDS]

        from m3p_tpu_torch.config import parse_steps

        out: List[Tuple[str, Tuple[str, str]]] = []
        cfg = self.cfg
        for lang, _ in parse_steps(cfg.mlm_steps):
            out.append(("mlm", ("mlm", lang)))
            if cfg.is_generation:
                out.append(("bart", ("bart", lang)))
                out.append(("mass", ("mass", lang)))
        for lang, _ in parse_steps(cfg.clm_steps):
            out.append(("clm", ("clm", lang)))
        for lang, _ in parse_steps(cfg.mass_steps):
            out.append(("mass", ("mass", lang)))
        for lang, _ in parse_steps(cfg.ae_steps):
            out.append(("ae", ("ae", lang)))
        for a, _ in parse_steps(cfg.pc_steps):
            out.append(("pc", ("pc", a)))
        for ds, _ in parse_steps(cfg.cross_rel_steps):
            out.append((kind_of("rel"), ("rel", ds)))
        for ds, _ in parse_steps(cfg.cross_ic_steps):
            out.append(("ic", ("ic", ds)))
        for ds, _ in parse_steps(cfg.tifg_steps):
            out.append(("tifg", ("tifg", ds)))
        for ds, _ in parse_steps(cfg.cross_ae_steps):
            out.append(("bart_img", ("bart_img", ds)))
        for a, _ in parse_steps(cfg.cross_mt_steps):
            out.append((kind_of("mt"), ("mt", a)))
        ntg_steps = cfg.ntg_steps or (cfg.text_steps if cfg.is_ntg else "")
        for a, _ in parse_steps(ntg_steps):
            out.append(("ntg", ("ntg", a)))
        for a, _ in parse_steps(cfg.slide_steps):
            out.append(("slide", ("slide", a)))
        return out

    def task_sampling_probs(self, tasks) -> Optional[Dict[int, float]]:
        """Corpus-size-proportional task sampling smoothed by
        lg_sampling_factor; None -> uniform shuffling."""
        coeff = getattr(self.cfg, "lg_sampling_factor", -1.0)
        if coeff is None or coeff <= 0:
            return None
        sizes = {}
        for i, (_, key) in enumerate(tasks):
            ds = self.datasets.get(key)
            sizes[i] = len(ds) if ds is not None and hasattr(ds, "__len__") \
                else 1
        return set_sampling_probs(sizes, coeff)

    def _round_order(self, tasks, probs) -> List[int]:
        """One round's task order: every task once in uniform mode; 3 draws
        per step group with the corpus-size probs normalized within the
        group in weighted mode (`m3p_tpu/train/trainer.py:514-532`)."""
        idx = list(range(len(tasks)))
        if probs is None:
            return shuf_order(idx, n=len(idx), rng=self.rng)
        groups: Dict[str, List[int]] = {}
        for i, (kind, _) in enumerate(tasks):
            groups.setdefault(kind, []).append(i)
        order: List[int] = []
        for kind in sorted(groups):
            g = groups[kind]
            order.extend(shuf_order(g, probs={i: probs[i] for i in g},
                                    n=3, rng=self.rng))
        return order

    def train_epoch(self) -> None:
        tasks = self.active_tasks()
        if not tasks:
            raise ValueError("no active training tasks configured")
        probs = self.task_sampling_probs(tasks)
        # continue the epoch's sentence budget after a mid-epoch resume
        self.n_sentences = self._resume_sentences
        self._resume_sentences = 0
        while self.n_sentences < self.cfg.epoch_size and not self.should_stop:
            order = self._round_order(tasks, probs)
            for ti in order:
                kind, task = tasks[ti]
                self.step_once(kind, task)
                if self._should_save_now():
                    self.save_checkpoint()
                    self._pending_save = False
                if self.n_sentences >= self.cfg.epoch_size:
                    break

    # ------------------------------------------------------------------
    # checkpoint / end-of-epoch control
    # ------------------------------------------------------------------

    def checkpoint_path(self, name: str = "checkpoint") -> str:
        return os.path.join(self.cfg.dump_path, name)

    def _should_save_now(self) -> bool:
        """Whether to checkpoint at this step boundary
        (`m3p_tpu/train/trainer.py:559-583`).  One process: the SIGTERM
        flag.  Several: the save is collective, so every rank must decide
        alike at the same boundary; a one-float all-reduce of the flags
        every ``save_check_every`` boundaries (``n_total_iter`` advances
        alike on every rank), and no save in between, whatever the local
        flag says (a rank saving alone would wait for the others forever)."""
        mesh = getattr(self, "mesh", None)
        if mesh is None or mesh.size == 1:
            return self._pending_save
        every = max(int(getattr(self.cfg, "save_check_every", 1)), 1)
        if self.n_total_iter % every != 0:
            return False
        from m3p_tpu_torch.parallel.mesh import all_reduce_sum

        flag = torch.tensor([float(self._pending_save)], device=mesh.device)
        return bool(all_reduce_sum(flag, mesh).item() > 0)

    def save_checkpoint(self, name: str = "checkpoint") -> None:
        logger.info("checkpointing at iter %d (%d sentences)",
                    self.n_total_iter, self.n_sentences)
        # each row loader's position after the batches the steps took
        loader_state = {"|".join(map(str, task)): save_loader_state(
            loader, consumed=self._taken[task])
            for task, loader in self._loaders.items()}
        extra = {"epoch": self.epoch, "n_total_iter": self.n_total_iter,
                 "best_metrics": self.best_metrics,
                 "n_sentences": self.n_sentences,
                 "loader_state": loader_state}
        ckpt.save_checkpoint(self.checkpoint_path(name), self.state, extra)
        logger.info("saved checkpoint %s (epoch %d)", name, self.epoch)

    def reload_checkpoint(self, name: str = "checkpoint") -> bool:
        """Restore ``dump_path/<name>`` if it exists.  A checkpoint taken
        mid-epoch with loader states keeps the epoch and its sentence
        budget, and seeks each task's row loader to its saved position
        (`m3p_tpu/train/trainer.py:613-638`); a state that cannot be
        restored starts that iterator at the epoch's head.  Otherwise the
        run goes on at the next epoch."""
        path = self.checkpoint_path(name)
        if ckpt.committed_checkpoint(path) is None:
            return False
        self.state, extra = ckpt.restore_checkpoint(path, self.state)
        self.n_total_iter = int(extra.get("n_total_iter", 0))
        self.best_metrics = dict(extra.get("best_metrics", {}))
        n_sent = int(extra.get("n_sentences", 0) or 0)
        loader_state = extra.get("loader_state") or {}
        if 0 < n_sent < self.cfg.epoch_size and loader_state:
            self.epoch = int(extra.get("epoch", 0))
            self._resume_sentences = n_sent
            self._close_iterators()
            for key_str, st in loader_state.items():
                task = tuple(key_str.split("|"))
                if task not in self.datasets:
                    continue
                if self._uses_row_loader(task):
                    self._make_iterator(task, st)
                else:
                    logger.warning(
                        "loader state for %s not restorable (the task has "
                        "no row loader) - restarting that iterator from "
                        "the epoch head", task)
            logger.info("resumed MID-EPOCH from %s (epoch %d, %d sentences, "
                        "%d loader states)", path, self.epoch, n_sent,
                        len(loader_state))
        else:
            self.epoch = int(extra.get("epoch", 0)) + 1
            logger.info("resumed from %s at epoch %d", path, self.epoch)
        return True

    def install_preemption_handler(self) -> None:
        """SIGTERM -> checkpoint at the next step boundary.  Pair with
        `uninstall_preemption_handler`: the handler is process-global."""

        def handler(signum, frame):
            logger.warning("received signal %d - scheduling checkpoint",
                           signum)
            self._pending_save = True

        self._prev_sigterm = signal.signal(signal.SIGTERM, handler)

    # distinct 'never installed' sentinel: signal.signal() returns None
    # when the previous handler was installed outside Python
    _SIGTERM_UNSET = object()

    def uninstall_preemption_handler(self) -> None:
        """Restore the SIGTERM disposition that preceded install (no-op if
        install never ran); a saved None (a handler installed outside
        Python) restores SIG_DFL."""
        prev = getattr(self, "_prev_sigterm", Trainer._SIGTERM_UNSET)
        if prev is not Trainer._SIGTERM_UNSET:
            signal.signal(signal.SIGTERM,
                          signal.SIG_DFL if prev is None else prev)
            self._prev_sigterm = Trainer._SIGTERM_UNSET

    @staticmethod
    def _resolve_metric(name: str, scores: Dict[str, float]) -> Optional[str]:
        """A reference metric name (``valid_I2T_acc``) to the score key:
        exact first, then without its ``valid_``/``test_`` prefix."""
        if name in scores:
            return name
        for pre in ("valid_", "test_"):
            if name.startswith(pre) and name[len(pre):] in scores:
                return name[len(pre):]
        return None

    def save_best_model(self, scores: Dict[str, float]) -> None:
        for metric in [m for m in self.cfg.validation_metrics.split(",") if m]:
            sign = -1.0 if metric.startswith("_") else 1.0
            name = self._resolve_metric(metric.lstrip("_"), scores)
            if name is None:
                continue
            value = sign * scores[name]
            if value > self.best_metrics.get(name, -1e18):
                self.best_metrics[name] = value
                self.save_checkpoint(f"best-{name}")
                logger.info("new best %s: %.4f", name, scores[name])

    def end_epoch(self, scores: Dict[str, float]) -> None:
        crit = self.cfg.stopping_criterion
        if crit:
            metric, patience = crit.split(",")
            sign = -1.0 if metric.startswith("_") else 1.0
            name = self._resolve_metric(metric.lstrip("_"), scores)
            if name is not None:
                value = sign * scores[name]
                key = f"stop-{name}"
                if value > self.best_metrics.get(key, -1e18):
                    self.best_metrics[key] = value
                    self.decrease_counts = 0
                else:
                    self.decrease_counts += 1
                if self.decrease_counts > int(patience):
                    logger.info("early stopping after %d non-improving "
                                "epochs", self.decrease_counts)
                    self.should_stop = True
        if self.cfg.save_periodic > 0 and \
                self.epoch % self.cfg.save_periodic == 0:
            self.save_checkpoint(f"periodic-{self.epoch}")
        if self.cfg.is_pretrain and self.cfg.save_every_epoch > 0 and \
                self.epoch % self.cfg.save_every_epoch == 0:
            # per-epoch pretrain snapshots (`model_pretrain_%i`)
            self.save_checkpoint(f"model_pretrain_{self.epoch}")
        self.save_checkpoint()
        self.epoch += 1
        # the datasets open their next epoch
        self._close_iterators()


@torch.no_grad()
def broadcast_parameters(model: torch.nn.Module, mesh) -> None:
    """Rank 0's parameters and buffers on every rank (one broadcast of a
    flat buffer per dtype), then a check that they arrived: each rank's
    fp64 sum of every tensor's sum, gathered, must equal rank 0's."""
    from m3p_tpu_torch.parallel.mesh import all_reduce_sum, broadcast_

    tensors = list(model.parameters()) + list(model.buffers())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = broadcast_(torch.cat([t.detach().reshape(-1) for t in group]),
                          mesh, src=0)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    sums = torch.stack([t.detach().double().sum() for t in tensors])
    mine = torch.zeros(mesh.size, len(tensors), dtype=torch.float64,
                       device=sums.device)
    mine[mesh.rank] = sums
    every = all_reduce_sum(mine, mesh)
    if not torch.equal(every, every[:1].expand_as(every)):
        bad = (every != every[0]).any(dim=1).nonzero().flatten().tolist()
        raise RuntimeError(f"parameters differ from rank 0's after the "
                           f"broadcast on rank(s) {bad}")
    logger.info("parameters broadcast from rank 0 to %d ranks and checked",
                mesh.size)


def _mct_lambdas(lam: Dict[str, float]) -> Dict[str, float]:
    """The five lambdas of `mct_pretrain_loss`, 1.0 where not given."""
    return {k: lam.get(k, 1.0) for k in ("lambda_rel", "lambda_mlm",
                                         "lambda_mrm", "lambda_mrfr",
                                         "lambda_clcm")}


def _mask_scores_from_tokenizer(tokenizer, n_words: int, alpha: float,
                                pad_index: int,
                                device: torch.device = torch.device("cpu")
                                ) -> Optional[torch.Tensor]:
    """``counts ** -alpha`` per token id for sample_alpha masking
    (`m3p_tpu/train/trainer.py:735-759`), with pad and special ids zeroed.
    Counts come from the unigram pieces' log-probabilities (counts ∝
    exp(score)); ids beyond the piece table (``<mask>``) get 0."""
    scores = np.zeros((n_words,), np.float32)
    model = (getattr(tokenizer, "_py_model", None)
             or getattr(tokenizer, "_model", None)
             or getattr(tokenizer, "model", None))
    piece_scores = getattr(model, "scores", None)
    if piece_scores is None:
        return None
    logp = np.asarray(piece_scores, np.float32)
    counts = np.exp(logp - logp.max())
    # fairseq offset: piece i -> id i + 1
    ids = np.arange(len(counts)) + 1
    ok = ids < n_words
    scores[ids[ok]] = np.maximum(counts[ok], 1e-12) ** -alpha
    scores[:4] = 0.0          # <s>/<pad>/</s>/<unk>
    scores[pad_index] = 0.0
    return torch.from_numpy(scores).to(device)
