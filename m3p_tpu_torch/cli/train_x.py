"""Training entry point of the port, with the reference CLI surface
(counterpart of `m3p_tpu/cli/train_x.py`).

The parser and `args_to_config` are the JAX package's, flag for flag, so a
recipe's command line builds the same `TrainConfig`; ``--device`` (default
``cuda``) picks the card.  `main` runs a recipe: the experiment directory,
the model on the device, ``--reload_model`` / ``--multi_reload_model``,
the `Trainer` with its SIGTERM checkpoint, ``--reload_checkpoint`` or the
automatic resume, the `Evaluator`, ``--eval_only`` and the epoch loop.

Loading a data directory is item 13 of ROADMAP.md: until then `main`
takes the data as ``data=LoadedData(...)`` (`data/loader.py`):

    from m3p_tpu_torch.cli.train_x import main
    main(["--lgs", "en", "--cross_rel_steps", "coco-img", ...],
         data=LoadedData(train_datasets={("rel", "coco"): ds}, ...))

Several cards (a mesh, DP/FSDP/TP, sequence or pipeline parallelism) are
item 16: with more than one visible card and a batch that would shard,
`main` raises instead of training on one card; with a batch that would
not shard, it trains on one card and logs a warning, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from m3p_tpu_torch.config import (DataConfig, EvalConfig, MeshConfig,
                                  ModelConfig, OptimConfig, TrainConfig)


def bool_flag(s: str) -> bool:
    if s.lower() in ("off", "false", "0"):
        return False
    if s.lower() in ("on", "true", "1"):
        return True
    raise argparse.ArgumentTypeError("invalid value for a boolean flag")


def get_parser() -> argparse.ArgumentParser:
    """Reference-parity flag surface (`train_x.py:29-391`), the JAX
    package's parser flag for flag, plus ``--device``.

    Accepted-but-inert flags (drop-in compatibility): GPU/launcher plumbing
    that has no TPU analog (--amp, --local_rank, --master_port,
    --debug_slurm — JAX is single-controller; bf16 needs no loss scaling),
    reference dead code (--is_latent /--kld_alpha /--rec_alpha,
    --use_memory, --use_enc_att: the latent/GAN/memory paths are commented
    out or crash upstream; --english_only /--attention_setting: read
    upstream but only select among branches that all call the SAME plain
    cross-attention — the per-language MHA constructions they would pick
    between are commented out (`transformer.py:698-705`), so the flags are
    runtime-inert; --min_len, --retrieval_workers,
    --max_vocab /--min_count: parser-only upstream too —
    the runtime vocab comes from the SentencePiece model, and the legacy
    Dictionary.read_vocab here does honor max_vocab/min_count),
    cosmetics (--retrieval_batch: only sizes a tqdm update upstream,
    `xevaluator.py:1612`), and legacy knobs subsumed by this framework's
    config (--encoder_only /--is_cross_modal: one unified model class;
    --use_new_fea /--google_valid_path: per-dataset path
    overrides cover these; --eval_bleu: BLEU is computed in-process by
    `eval/bleu.py` whenever generation eval data exists — there is no perl
    subprocess to gate; --tokens_per_batch /--max_batch_size: resolved to a
    static batch size in args_to_config, TPU shapes are fixed;
    --bt_steps: no bt_step exists upstream (stats key only,
    `xtrainer.py:112`); --cross_mass_steps: stats key only upstream
    (`xtrainer.py:116` — the IMLM objective is actually driven from
    mlm_steps under --is_generation, `train_x.py:459-460`)).
    """
    p = argparse.ArgumentParser(
        description="m3p_tpu_torch — M3P training on PyTorch and CUDA")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model trains; cuda unless the CPU is "
                        "asked for")

    # experiment
    p.add_argument("--dump_path", type=str, default="./dumped/")
    p.add_argument("--exp_name", type=str, default="m3p_tpu")
    p.add_argument("--exp_id", type=str, default="")
    p.add_argument("--save_periodic", type=int, default=0)
    p.add_argument("--fp16", type=bool_flag, default=True,
                   help="mixed precision (bf16 on TPU; no loss scaling)")
    p.add_argument("--encoder_only", type=bool_flag, default=True)
    p.add_argument("--english_only", type=bool_flag, default=False)

    # model
    p.add_argument("--emb_dim", type=int, default=768)
    p.add_argument("--n_layers", type=int, default=12)
    p.add_argument("--n_dec_layers", type=int, default=12)
    p.add_argument("--n_heads", type=int, default=12)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--attention_dropout", type=float, default=0.1)
    p.add_argument("--gelu_activation", type=bool_flag, default=True)
    p.add_argument("--share_inout_emb", type=bool_flag, default=True)
    p.add_argument("--sinusoidal_embeddings", type=bool_flag, default=False)
    p.add_argument("--attention_setting", type=str, default="v1")
    p.add_argument("--asm", type=bool_flag, default=False)
    p.add_argument("--asm_cutoffs", type=str, default="8000,20000")
    p.add_argument("--asm_div_value", type=float, default=4)
    p.add_argument("--refine_image", type=bool_flag, default=True)
    p.add_argument("--refine_layers", type=int, default=3)
    p.add_argument("--refine_encoder", type=bool_flag, default=False)
    p.add_argument("--use_externel_att", type=bool_flag, default=False)
    p.add_argument("--image_fusion", type=bool_flag, default=False)

    # masking / noise
    p.add_argument("--word_pred", type=float, default=0.15)
    p.add_argument("--mlm_pack_ratio", type=float, default=0.5,
                   help="MCT vocab-head slot-pack budget (see DataConfig)")
    p.add_argument("--sample_alpha", type=float, default=0)
    p.add_argument("--word_mask_keep_rand", type=str, default="0.8,0.1,0.1")
    p.add_argument("--word_shuffle", type=float, default=0)
    p.add_argument("--word_dropout", type=float, default=0)
    p.add_argument("--word_blank", type=float, default=0)
    p.add_argument("--word_mass", type=float, default=0.5)

    # data
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--lgs", type=str, default="en")
    p.add_argument("--src_lgs", type=str, default="")
    p.add_argument("--ag_lgs", type=str, default="")
    p.add_argument("--context_size", type=int, default=0)
    p.add_argument("--ft_lgs", type=str, default="")
    p.add_argument("--lg_sampling_factor", type=float, default=-1)
    p.add_argument("--vocab_path", type=str, default="")
    p.add_argument("--input_fea_dir", type=str, default="")
    p.add_argument("--google_path", type=str, default="")
    p.add_argument("--sbu_path", type=str, default="")
    p.add_argument("--coco_path", type=str, default="")
    p.add_argument("--flicker_path", type=str, default="")
    p.add_argument("--mild_path", type=str, default="")
    p.add_argument("--slide_path", type=str, default="")
    p.add_argument("--train_order_path", type=str, default="")
    p.add_argument("--cross_lingual_path", type=str, default="")
    p.add_argument("--eval_path", type=str, default="")
    p.add_argument("--google_valid_path", type=str, default="")
    p.add_argument("--max_vocab", type=int, default=-1)
    p.add_argument("--min_count", type=int, default=0)

    # batching
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--seq_per_img", type=int, default=5)
    p.add_argument("--max_region_num", type=int, default=100)
    p.add_argument("--bptt", type=int, default=128)
    p.add_argument("--min_len", type=int, default=0)
    p.add_argument("--max_len", type=int, default=64)
    p.add_argument("--group_by_size", type=bool_flag, default=True)
    p.add_argument("--max_batch_size", type=int, default=0)
    p.add_argument("--tokens_per_batch", type=int, default=-1)
    p.add_argument("--split_data", type=bool_flag, default=False)
    p.add_argument("--num_workers", type=int, default=1,
                   help="grain read threads (in-process; reference semantics"
                        " of DataLoader worker processes measured 7-20x"
                        " slower at region-feature shapes)")

    # optimization
    p.add_argument("--optimizer", type=str,
                   default="adam_inverse_sqrt,beta1=0.9,beta2=0.98,"
                           "lr=0.00005")
    p.add_argument("--clip_grad_norm", type=float, default=5)
    p.add_argument("--accumulate_gradients", type=int, default=1)
    p.add_argument("--amp", type=int, default=-1,
                   help="accepted for parity; TPU path always uses bf16")
    p.add_argument("--epoch_size", type=int, default=100000)
    p.add_argument("--max_epoch", type=int, default=100000)
    p.add_argument("--stopping_criterion", type=str, default="")
    p.add_argument("--validation_metrics", type=str, default="")

    # lambdas
    for name in ("mlm", "clm", "pc", "mass", "ic", "imlm", "ida", "tifg",
                 "rel", "mrm", "mrfr", "t2i", "i2t"):
        p.add_argument(f"--lambda_{name}", type=str, default="1")

    # task steps
    for name in ("clm_steps", "mlm_steps", "mass_steps", "mt_steps",
                 "ae_steps", "bt_steps", "pc_steps", "cross_modal_steps",
                 "cross_mass_steps", "cross_ae_steps", "cross_gan_steps",
                 "cross_rel_steps", "cross_mlm_steps", "cross_mrm_steps",
                 "cross_mrfr_steps", "cross_clcm_steps", "text_steps"):
        p.add_argument(f"--{name}", type=str, default="")

    # reload / eval
    p.add_argument("--reload_model", type=str, default="")
    p.add_argument("--multi_reload_model", type=str, default="")
    p.add_argument("--reload_checkpoint", type=str, default="")
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--length_penalty", type=float, default=1)
    p.add_argument("--early_stopping", type=bool_flag, default=False)
    p.add_argument("--eval_bleu", type=bool_flag, default=False)
    p.add_argument("--eval_only", type=bool_flag, default=False)
    p.add_argument("--eval_n", type=int, default=150)
    p.add_argument("--eval_images", type=int, default=-1)
    p.add_argument("--retrieval_batch", type=int, default=26)
    p.add_argument("--retrieval_workers", type=int, default=4)
    p.add_argument("--test_splits", type=int, default=8)
    p.add_argument("--coco_method", type=str, default="Bleu,CIDEr")
    p.add_argument("--fast_beam", type=bool_flag, default=False,
                   help="approx top-k (lax.approx_max_k) for the per-step "
                        "beam top-2K over the vocab: +33-43%% decode "
                        "throughput, quality delta <=0.2%% CIDEr "
                        "(tools/bench_fast_beam_quality.py; TPU-native, "
                        "no reference flag)")
    p.add_argument("--eval_quant", type=str, default="none",
                   help="'int8' = frozen-weight int8 generation evals "
                        "(weights quantize once per eval; beam decode rides "
                        "the int8 MXU — TPU-native, no reference flag)")
    p.add_argument("--use_new_fea", type=bool_flag, default=False)

    # debug fixtures (`loader.py:374-375`, `dataset_pretrain.py:213-214`)
    p.add_argument("--debug_train", type=bool_flag, default=False)
    p.add_argument("--debug_pretrain", type=bool_flag, default=False)
    p.add_argument("--debug_slurm", type=bool_flag, default=False)
    p.add_argument("--local_rank", type=int, default=-1)
    p.add_argument("--master_port", type=int, default=-1)

    # task-family switches
    p.add_argument("--is_cross_modal", type=bool_flag, default=True)
    p.add_argument("--is_understanding", type=bool_flag, default=False)
    p.add_argument("--is_generation", type=bool_flag, default=False)
    p.add_argument("--is_pretrain", type=bool_flag, default=False)
    p.add_argument("--is_mild", type=bool_flag, default=False)
    p.add_argument("--is_mt", type=bool_flag, default=False)
    p.add_argument("--mt_only_text", type=bool_flag, default=False)
    p.add_argument("--is_ntg", type=bool_flag, default=False)
    p.add_argument("--is_slide", type=bool_flag, default=False)
    p.add_argument("--is_latent", type=bool_flag, default=False)
    p.add_argument("--qp_type", type=str, default="q")
    p.add_argument("--ft_all", type=bool_flag, default=False)
    p.add_argument("--use_memory", type=bool_flag, default=False)
    p.add_argument("--use_enc_att", type=bool_flag, default=False)
    p.add_argument("--use_noise", type=float, default=0.0)
    p.add_argument("--save_every_epoch", type=int, default=1)
    p.add_argument("--save_check_every", type=int, default=10,
                   help="preemption-save decision cadence: SIGTERM-to-"
                        "checkpoint latency is bounded by this many steps "
                        "(the collective any-rank-pending check runs every "
                        "N step boundaries; measured 16.1 ms/step at N=1 vs "
                        "2.0 ms at N=10 over 4 processes). Tighten toward 1 "
                        "for short preemption grace windows")
    p.add_argument("--kld_alpha", type=float, default=0.1)
    p.add_argument("--rec_alpha", type=float, default=0.1)

    # ITM / MCT
    p.add_argument("--bin_cls_loss_weight", type=float, default=1)
    p.add_argument("--multi_cls_loss_weight", type=float, default=1)
    p.add_argument("--sent_ratio", type=float, default=0.5)
    p.add_argument("--word_ratio", type=float, default=0.3)
    p.add_argument("--sample_n", type=int, default=4)
    p.add_argument("--t2i_flag", type=bool_flag, default=True)
    p.add_argument("--i2t_flag", type=bool_flag, default=True)

    # freeLB
    p.add_argument("--is_freelb", type=bool_flag, default=False)
    p.add_argument("--free_text", type=bool_flag, default=True)
    p.add_argument("--free_img", type=bool_flag, default=True)
    p.add_argument("--adv_lr", type=float, default=0.001)
    p.add_argument("--adv_steps", type=int, default=3)
    p.add_argument("--adv_max_norm", type=float, default=0.01)
    p.add_argument("--norm_type", type=str, default="l2")

    # TPU-native extensions (no reference equivalent)
    p.add_argument("--use_grain", type=bool_flag, default=True,
                   help="Grain input pipeline (checkpointable iterators)")
    p.add_argument("--allow_missing_data", type=bool_flag, default=False,
                   help="warn-and-skip tasks whose data files are absent "
                        "instead of erroring (reference check_data_params "
                        "asserts; this is the escape hatch)")
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_tensor", type=int, default=1)
    p.add_argument("--mesh_seq", type=int, default=1,
                   help="sequence-parallel shards (ring attention); >1 "
                        "routes every objective's encoder through SP")
    p.add_argument("--mesh_expert", type=int, default=1)
    p.add_argument("--pp_stages", "--mesh_pp", type=int, default=1,
                   dest="pp_stages",
                   help="pipeline stages (GPipe over stage-sliced blocks)")
    p.add_argument("--pp_microbatches", type=int, default=2)
    p.add_argument("--moe_experts", type=int, default=0,
                   help="expert-choice MoE FFN every --moe_interval blocks")
    p.add_argument("--moe_interval", type=int, default=2)
    p.add_argument("--moe_capacity_factor", type=float, default=2.0)
    p.add_argument("--remat", type=bool_flag, default=False)
    p.add_argument("--use_pallas_attention", type=bool_flag, default=True)
    p.add_argument("--seed", type=int, default=12345)
    return p


def args_to_config(args: argparse.Namespace) -> TrainConfig:
    # --tokens_per_batch/--max_batch_size: static TPU shapes resolve the
    # reference's per-batch token packing (`dataset_pretrain.py:863-890`)
    # to a fixed batch size at config time
    batch_size = args.batch_size
    if args.tokens_per_batch and args.tokens_per_batch > 0:
        batch_size = max(1, args.tokens_per_batch // max(args.max_len, 1))
        if args.max_batch_size and args.max_batch_size > 0:
            batch_size = min(batch_size, args.max_batch_size)
    model = ModelConfig(
        emb_dim=args.emb_dim, n_layers=args.n_layers,
        n_dec_layers=args.n_dec_layers, n_heads=args.n_heads,
        dropout=args.dropout, attention_dropout=args.attention_dropout,
        gelu_activation=args.gelu_activation,
        share_inout_emb=args.share_inout_emb,
        sinusoidal_embeddings=args.sinusoidal_embeddings,
        max_region_num=args.max_region_num,
        refine_layers=args.refine_layers, asm=args.asm,
        asm_cutoffs=tuple(int(c) for c in args.asm_cutoffs.split(",") if c),
        asm_div_value=args.asm_div_value,
        attention_setting=args.attention_setting,
        use_externel_att=args.use_externel_att,
        image_fusion=args.image_fusion,
        dtype="bfloat16" if args.fp16 else "float32",
        use_pallas_attention=args.use_pallas_attention,
        remat=args.remat,
        moe_experts=args.moe_experts, moe_interval=args.moe_interval,
        moe_capacity_factor=args.moe_capacity_factor,
        n_langs=max(len([l for l in args.lgs.split("-") if l]), 1) + 1,
    )
    data = DataConfig(
        data_path=args.data_path, input_fea_dir=args.input_fea_dir,
        seq_per_img=args.seq_per_img,
        vocab_path=args.vocab_path, lgs=args.lgs,
        max_len=args.max_len, max_region_num=args.max_region_num,
        batch_size=batch_size, sample_n=args.sample_n,
        group_by_size=args.group_by_size,
        tokens_per_batch=args.tokens_per_batch,
        max_batch_size=args.max_batch_size,
        word_pred=args.word_pred, sample_alpha=args.sample_alpha,
        word_mask_keep_rand=args.word_mask_keep_rand,
        word_shuffle=args.word_shuffle, word_dropout=args.word_dropout,
        word_blank=args.word_blank, use_mct=bool(args.cross_lingual_path),
        cross_lingual_path=args.cross_lingual_path,
        mct_sent_ratio=args.sent_ratio, mct_word_ratio=args.word_ratio,
        seed=args.seed, num_workers=args.num_workers, bptt=args.bptt,
        use_grain=args.use_grain, mlm_pack_ratio=args.mlm_pack_ratio,
        allow_missing_data=args.allow_missing_data,
    )
    optim = OptimConfig(spec=args.optimizer,
                        clip_grad_norm=args.clip_grad_norm,
                        accumulate_gradients=args.accumulate_gradients)
    mesh = MeshConfig(data=args.mesh_data, fsdp=args.mesh_fsdp,
                      tensor=args.mesh_tensor, seq=args.mesh_seq,
                      expert=args.mesh_expert, pp=args.pp_stages,
                      pp_microbatches=args.pp_microbatches)
    ev = EvalConfig(eval_only=args.eval_only, beam_size=args.beam_size,
                    length_penalty=args.length_penalty,
                    early_stopping=args.early_stopping,
                    test_splits=args.test_splits,
                    eval_n=args.eval_n, eval_images=args.eval_images,
                    coco_method=args.coco_method, eval_path=args.eval_path,
                    quant=args.eval_quant, fast_beam=args.fast_beam)
    return TrainConfig(
        exp_name=args.exp_name, exp_id=args.exp_id, dump_path=args.dump_path,
        model=model, optim=optim, mesh=mesh, data=data, eval=ev,
        mlm_steps=args.mlm_steps, clm_steps=args.clm_steps,
        cross_mlm_steps=args.cross_mlm_steps,
        cross_mrm_steps=args.cross_mrm_steps,
        cross_mrfr_steps=args.cross_mrfr_steps,
        cross_clcm_steps=args.cross_clcm_steps,
        cross_ic_steps=args.cross_modal_steps,
        # NTG reuses the MT step DSL under --is_ntg; slide reuses
        # cross_rel_steps under --is_slide (reference loader routing,
        # `loader.py:686-703`)
        cross_mt_steps="" if args.is_ntg else args.mt_steps,
        ntg_steps=args.mt_steps if args.is_ntg else "",
        text_steps=args.text_steps,
        cross_rel_steps="" if args.is_slide else args.cross_rel_steps,
        slide_steps=args.cross_rel_steps if args.is_slide else "",
        mass_steps=args.mass_steps, pc_steps=args.pc_steps,
        ae_steps=args.ae_steps,
        # cross_gan_steps is the reference's tifg DSL (`train_x.py:232`),
        # cross_ae_steps the IDA/bart_img DSL (`train_x.py:229`)
        tifg_steps=args.cross_gan_steps,
        cross_ae_steps=args.cross_ae_steps,
        ft_lgs=args.ft_lgs, train_order_path=args.train_order_path,
        word_mass=args.word_mass,
        lambda_mlm=args.lambda_mlm, lambda_rel=args.lambda_rel,
        lambda_mrm=args.lambda_mrm, lambda_mrfr=args.lambda_mrfr,
        lambda_ic=args.lambda_ic, lambda_t2i=args.lambda_t2i,
        lambda_i2t=args.lambda_i2t, lambda_clm=args.lambda_clm,
        lambda_mass=args.lambda_mass, lambda_imlm=args.lambda_imlm,
        lambda_ida=args.lambda_ida, lambda_tifg=args.lambda_tifg,
        lambda_pc=args.lambda_pc,
        epoch_size=args.epoch_size, max_epoch=args.max_epoch,
        stopping_criterion=args.stopping_criterion,
        validation_metrics=args.validation_metrics,
        save_periodic=args.save_periodic, reload_model=args.reload_model,
        reload_checkpoint=args.reload_checkpoint,
        is_pretrain=args.is_pretrain,
        is_understanding=args.is_understanding,
        is_generation=args.is_generation, is_mt=args.is_mt,
        is_ntg=args.is_ntg, is_mild=args.is_mild, is_slide=args.is_slide,
        is_freelb=args.is_freelb, ft_all=args.ft_all,
        lg_sampling_factor=args.lg_sampling_factor,
        qp_type=args.qp_type, seed=args.seed,
        adv_lr=args.adv_lr, adv_steps=args.adv_steps,
        adv_max_norm=args.adv_max_norm, norm_type=args.norm_type,
        free_text=args.free_text, free_img=args.free_img,
        refine_image=args.refine_image,
        refine_encoder=args.refine_encoder,
        t2i_flag=args.t2i_flag, i2t_flag=args.i2t_flag,
        multi_cls_loss_weight=args.multi_cls_loss_weight,
        bin_cls_loss_weight=args.bin_cls_loss_weight,
        mt_only_text=args.mt_only_text,
        debug_train=args.debug_train, debug_pretrain=args.debug_pretrain,
        split_data=args.split_data, use_noise=args.use_noise,
        src_lgs=args.src_lgs, save_every_epoch=args.save_every_epoch,
        save_check_every=args.save_check_every,
        ag_lgs=args.ag_lgs, context_size=args.context_size,
    )


def _data_parallel_width(mesh_cfg: MeshConfig, n_devices: int) -> int:
    """data x fsdp of the mesh the JAX package would build over
    ``n_devices`` (``data = -1``: the devices the other axes leave)."""
    others = mesh_cfg.fsdp * mesh_cfg.tensor * mesh_cfg.seq * \
        mesh_cfg.expert * mesh_cfg.pp
    data = mesh_cfg.data if mesh_cfg.data > 0 else max(n_devices // others, 1)
    return data * mesh_cfg.fsdp


def _reload_weights(args, cfg, model, logger) -> None:
    """``--reload_model`` (a reference ``.pth`` or a train-state directory)
    and ``--multi_reload_model`` (0.6 x it + 0.4 x the mean of the listed
    ``.pth`` files), merged over the initial weights by name
    (`m3p_tpu/cli/train_x.py:442-465`)."""
    from m3p_tpu_torch import checkpoint as ckpt

    n_layers, refine = cfg.model.n_layers, cfg.model.refine_layers
    if os.path.isdir(args.reload_model):
        loaded = ckpt.load_params_checkpoint(args.reload_model)
    else:
        loaded = ckpt.load_reference_file(args.reload_model, n_layers, refine)
    if args.multi_reload_model:
        paths = [p for p in args.multi_reload_model.split(",") if p]
        secondary = ckpt.average_checkpoints(
            [ckpt.load_reference_file(p, n_layers, refine) for p in paths])
        loaded = ckpt.average_checkpoints([loaded, secondary],
                                          weights=[0.6, 0.4])
        logger.info("blended %d secondary checkpoints (0.6/0.4)", len(paths))
    ckpt.merge_params(model, loaded)
    logger.info("reloaded model weights from %s", args.reload_model)


def main(argv=None, data=None):
    """Run a recipe (`m3p_tpu/cli/train_x.py:401-531`); returns the
    `Trainer`.  ``data``: a `LoadedData`; None loads ``--data_path``
    (item 13, not ported yet)."""
    import torch

    from m3p_tpu_torch import checkpoint as ckpt
    from m3p_tpu_torch.data.loader import load_data
    from m3p_tpu_torch.eval.evaluator import Evaluator
    from m3p_tpu_torch.model import build_model, resolve_device
    from m3p_tpu_torch.train.trainer import Trainer
    from m3p_tpu_torch.utils.logging import initialize_exp

    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = args_to_config(args)
    logger = initialize_exp(cfg)

    if data is None:
        data = load_data(cfg, dataset_paths={
            "coco": args.coco_path, "flicker": args.flicker_path,
            "google": args.google_path, "sbu": args.sbu_path,
            "mild": args.mild_path, "slide": args.slide_path,
        })
    if data.tokenizer is not None:
        # vocab size and mask id come from the tokenizer (reference
        # `check_data_params`, `loader.py:147-153`)
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, n_words=data.tokenizer.vocab_size,
            mask_index=data.tokenizer.mask_token_id))

    if device.type == "cuda" and torch.cuda.device_count() > 1:
        dp = _data_parallel_width(cfg.mesh, torch.cuda.device_count())
        if cfg.data.batch_size % dp == 0:
            raise NotImplementedError(
                f"{torch.cuda.device_count()} visible cards and a batch of "
                f"{cfg.data.batch_size} that shards over data x fsdp = {dp}: "
                f"training over several cards is item 16 of ROADMAP.md; "
                f"show the run one card (CUDA_VISIBLE_DEVICES)")
        logger.warning(
            "batch_size %d not divisible by data*fsdp=%d — running on one "
            "card of %d; adjust --batch_size or --mesh_*",
            cfg.data.batch_size, dp, torch.cuda.device_count())

    model = build_model(cfg.model, cfg.seed, device)
    if args.reload_model:
        _reload_weights(args, cfg, model, logger)
    trainer = Trainer(cfg, model, data.train_datasets,
                      tokenizer=data.tokenizer)
    trainer.install_preemption_handler()
    try:
        # resume from dump_path/checkpoint when it exists; an explicit
        # --reload_checkpoint restores the train state only
        if args.reload_checkpoint:
            ckpt.restore_checkpoint(args.reload_checkpoint, trainer.state)
        else:
            trainer.reload_checkpoint()
        evaluator = Evaluator(model, cfg)

        if cfg.eval.eval_only:
            scores = evaluator.run_all_evals(data.eval_data)
            logger.info("eval-only scores: %s", scores)
            return trainer

        for _ in range(cfg.max_epoch):
            if trainer.should_stop:
                break
            logger.info("==== starting epoch %d ====", trainer.epoch)
            trainer.train_epoch()
            scores = evaluator.run_all_evals(data.eval_data)
            trainer.save_best_model(scores)
            trainer.end_epoch(scores)
        return trainer
    finally:
        # the handler is process-global: restore it for in-process callers
        trainer.uninstall_preemption_handler()
        trainer._close_iterators()


if __name__ == "__main__":
    main()
