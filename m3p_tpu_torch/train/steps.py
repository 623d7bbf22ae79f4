"""Loss functions and the train step of the port (counterpart of
`m3p_tpu/train/steps.py`).

Ported objectives:
* ``itm``, the ITM retrieval fine-tune (the reference `t2i_step`/
  `i2t_step`): CE over each ``sample_n`` candidate grid plus a binary CE on
  every pair's score, over `M3PModel.encode_joint` in training mode, on
  batches shaped as `m3p_tpu_torch.data.synthetic.make_retrieval_batch`
  makes them;
* ``mlm``, xMLM on a text stream (the reference `mlm_step`): on-device
  80/10/10 masking into fixed slots, `M3PModel.encode_text`, the tied word
  head at the gathered slots and `masked_ce`, on batches shaped as
  `make_stream_batch` makes them;
* ``mct``, the multitask pre-training step (the reference
  `pretrain_under_step`): a word-or-object coin per row, MC-MLM over
  packed slots, MC-MRM and MRFR over packed region slots, ITM over the
  candidate grid and, with CLCM pairs in the batch, CLCM, on batches shaped
  as `make_pretrain_batch` makes them;
* the decoder objectives, teacher-forced next-token CE through the causal
  text stream with cross-attention over a source encoding
  (`seq2seq_ce`): ``caption`` (the reference `ic_step`; image stream
  encoder, `make_caption_batch`), ``mt`` / ``ntg`` (`mt_step`,
  `ntg_step`; text encoder, `make_mt_batch`) and ``mt_caption``
  (`mt_ic_step`; the joint [img; src] encoder);
* ``clm``, causal LM on a text stream (`make_stream_batch`); ``tifg``,
  text-to-image-feature generation (`tifg_step`; the causal image stream
  regressing the refined region embeddings); ``slide``, binary
  slide-text matching over `encode_joint` (`make_slide_batch`);
* ``pc``, parallel classification (`pc_step`) over sentence pairs joined
  by `data.noise.concat_batches`; ``mass``, MASS segment-masked seq2seq
  (`bart_mass_step`) over `data.span_masking.mass_mask`'s batches.  BART
  and the denoising auto-encoder are ``mt`` over the batches of
  `data.loader.make_bart_transform` / `make_ae_transform`, IDA
  (``bart_img``) is ``caption`` over `poisson_region_noise`'s regions.
The freeLB adversarial steps around ``mct``, ``itm`` and ``caption`` are
in `train/freelb.py`.  Batches are dicts of tensors on the model's
device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from m3p_tpu_torch.data.masking import (
    MaskingConfig, mask_regions, mask_tokens)
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.model.transformer import M3PModel, lengths_to_mask
from m3p_tpu_torch.ops.topk import top_k
from m3p_tpu_torch.parallel.data_parallel import (
    batch_reduction, gather_batch, shard_denominator, shard_position,
    shard_scale)
from m3p_tpu_torch.parallel.tensor_parallel import (
    VocabShard, vocab_parallel_argmax, vocab_parallel_ce)
from m3p_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def expand_compact_batch(batch: Batch) -> Batch:
    """Materialize grid rows from a compact image batch on the device.

    Compact batches ship each group's unique images once — ``raw_feats``
    (G, U, R, D), ``locs`` (G, U, R, 5), ``obj_labels`` (G, U, R),
    ``img_len`` (G, U) — and a local gather map ``img_index`` (G, n).  Rows
    are gathered per group and features L2-normalized here
    (`m3p_tpu/train/steps.py:46-75`).  Batches without ``img_index`` pass
    through unchanged."""
    if "img_index" not in batch:
        return batch
    batch = dict(batch)
    idx = batch.pop("img_index").long()               # (G, n) local slots
    g, n = idx.shape
    groups = torch.arange(g, device=idx.device)[:, None]

    def rows(pool):
        gathered = pool[groups, idx]                   # (G, n, ...)
        return gathered.reshape((g * n,) + tuple(gathered.shape[2:]))

    raw = rows(batch["raw_feats"])
    batch["raw_feats"] = raw
    norm = torch.linalg.vector_norm(raw.float(), dim=-1, keepdim=True)
    batch["feats"] = (raw / norm.clamp_min(1e-12)).to(raw.dtype)
    for k in ("locs", "obj_labels", "img_len"):
        if k in batch:
            batch[k] = rows(batch[k])
    return batch


def itm_grid_losses(scores: torch.Tensor, pos_labels: torch.Tensor,
                    sample_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B*N, 1) ITM scores -> (CE over the N-way grid, BCE vs one-hot), as
    `t2i_step` (`m3p_tpu/train/steps.py:87-98`)."""
    grid = scores.reshape(-1, sample_n).float()
    labels = pos_labels.long()
    ce = F.cross_entropy(grid, labels)
    one_hot = F.one_hot(labels, sample_n).float()
    bce = F.binary_cross_entropy_with_logits(grid, one_hot)
    return ce, bce


def itm_finetune_loss(model: M3PModel, batch: Batch,
                      generator: Optional[Generators], sample_n: int,
                      refine_image: bool = True, deterministic: bool = False,
                      multi_cls_weight: float = 1.0,
                      bin_cls_weight: float = 1.0
                      ) -> Tuple[torch.Tensor, Metrics]:
    """Fine-tune retrieval loss (`m3p_tpu/train/steps.py:321-342`): CE + BCE
    over the sample_n candidate grid.  Metrics stay on the device."""
    tokens = batch["tokens"].long()
    text_mask = lengths_to_mask(batch["text_len"], tokens.shape[1])
    img_mask = lengths_to_mask(batch["img_len"], batch["feats"].shape[1])
    hidden = model.encode_joint(tokens, text_mask, batch["feats"],
                                batch["locs"], img_mask, refine_image,
                                deterministic=deterministic,
                                generator=generator)
    scores = model.itm_score(hidden)
    ce, bce = itm_grid_losses(scores, batch["pos_label"], sample_n)
    loss = multi_cls_weight * ce + bin_cls_weight * bce
    grid = scores.detach().reshape(-1, sample_n)
    acc = (grid.argmax(dim=1) == batch["pos_label"].long()).float().mean()
    return loss, {"loss": loss.detach(), "ce": ce.detach(),
                  "bce": bce.detach(), "acc": acc}


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              weights: torch.Tensor, vocab: Optional[VocabShard] = None
              ) -> torch.Tensor:
    """Mean CE over the weighted slots, in fp32 (the reference's mean over
    masked positions; `m3p_tpu/train/steps.py:78-84`).  Under data
    parallelism the count is the global batch's
    (`parallel.data_parallel.shard_denominator`); with ``vocab`` the logits
    are this rank's vocabulary columns (`M3PModel.shard_word_logits`) and
    the CE is taken over the ranks' columns."""
    ce = vocab_parallel_ce(logits.reshape(-1, logits.shape[-1]),
                           labels.long().clamp_min(0).reshape(-1),
                           vocab).view(labels.shape)
    return (ce * weights).sum() / shard_denominator(weights.sum())


def mlm_loss(model: M3PModel, batch: Batch, generator: Optional[Generators],
             mask_cfg: MaskingConfig, deterministic: bool = False,
             mask_scores: Optional[torch.Tensor] = None,
             masking: Optional[Sequence[torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Metrics]:
    """xMLM on a text stream (`m3p_tpu/train/steps.py:158-176`): mask the
    tokens, encode them, score the vocabulary at the masked slots only.

    ``masking`` = (masked tokens, positions, labels, weights) as
    `mask_tokens` returns them; when None they are drawn on the device from
    ``generator.device``.  Passing them in lets a caller hold the loss
    against another implementation's masks."""
    tokens = batch["tokens"].long()
    text_mask = lengths_to_mask(batch["lengths"], tokens.shape[1])
    if masking is None:
        if generator is None:
            raise ValueError("mlm_loss needs generators to draw its masking "
                             "(or the masking passed in)")
        masking = mask_tokens(generator.device, tokens, text_mask, mask_cfg,
                              mask_scores)
    masked, positions, labels, weights = masking
    hidden = model.encode_text(masked.long(), text_mask, batch.get("langs"),
                               deterministic=deterministic,
                               generator=generator)
    logits = model.shard_word_logits(_gather_rows(hidden, positions))
    loss = masked_ce(logits, labels, weights, model.vocab_shard)
    return loss, {"mlm": loss.detach()}


def _next_token_ce(logits: torch.Tensor, y: torch.Tensor,
                   y_mask: torch.Tensor, vocab: Optional[VocabShard] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean CE over the weighted positions in fp32, accuracy of the argmax,
    number of weighted positions) of logits (B, T, V) against labels y
    (B, T).  Under data parallelism the means are over the global batch's
    positions and the number is scaled so that its mean over the batch
    shards is the global count; ``vocab`` as in `masked_ce`."""
    y = y.long()
    ce = vocab_parallel_ce(logits.reshape(-1, logits.shape[-1]),
                           y.reshape(-1), vocab).view(y.shape)
    n_words = y_mask.sum()
    denom = shard_denominator(n_words)
    loss = (ce * y_mask).sum() / denom
    hits = (vocab_parallel_argmax(logits.detach(), vocab) == y).float()
    return loss, (hits * y_mask).sum() / denom, n_words * shard_scale()


def seq2seq_ce(model: M3PModel, src_enc: torch.Tensor,
               src_mask: torch.Tensor, tgt_tokens: torch.Tensor,
               tgt_mask: torch.Tensor, langs: Optional[torch.Tensor] = None,
               generator: Optional[Generators] = None,
               deterministic: bool = True) -> Tuple[torch.Tensor, Metrics]:
    """Teacher-forced next-token CE through the causal text stream with
    cross-attention over ``src_enc`` (`m3p_tpu/train/steps.py:101-121`):
    ``tgt_tokens[:, :-1]`` predict ``tgt_tokens[:, 1:]``."""
    tgt_tokens = tgt_tokens.long()
    x, y = tgt_tokens[:, :-1], tgt_tokens[:, 1:]
    dec = model.encode_text(x, tgt_mask[:, :-1],
                            None if langs is None else langs[:, :-1].long(),
                            None, deterministic, generator, causal=True,
                            src_enc=src_enc, src_mask=src_mask)
    loss, acc, n_words = _next_token_ce(model.shard_word_logits(dec), y,
                                        tgt_mask[:, 1:].float(),
                                        model.vocab_shard)
    return loss, {"ce": loss.detach(), "acc": acc, "n_words": n_words}


def caption_loss(model: M3PModel, batch: Batch,
                 generator: Optional[Generators], refine_image: bool = True,
                 deterministic: bool = False, refine_encoder: bool = False
                 ) -> Tuple[torch.Tensor, Metrics]:
    """Image captioning (`m3p_tpu/train/steps.py:345-362`): the regions
    through the image stream (``refine_encoder`` refines again after the
    stack), the caption decoded over them."""
    img_mask = lengths_to_mask(batch["img_len"], batch["feats"].shape[1])
    src_enc = model.encode_image(batch["feats"], batch["locs"], img_mask,
                                 refine_image, deterministic, generator,
                                 refine_encoder)
    tokens = batch["tokens"]
    tgt_mask = lengths_to_mask(batch["tgt_len"], tokens.shape[1])
    return seq2seq_ce(model, src_enc, img_mask, tokens, tgt_mask,
                      batch.get("langs"), generator, deterministic)


def mt_loss(model: M3PModel, batch: Batch, generator: Optional[Generators],
            deterministic: bool = False) -> Tuple[torch.Tensor, Metrics]:
    """Text seq2seq (`m3p_tpu/train/steps.py:365-377`, the reference
    `mt_step` / `ntg_step`)."""
    src = batch["src_tokens"].long()
    src_mask = lengths_to_mask(batch["src_len"], src.shape[1])
    src_langs = batch.get("src_langs")
    src_enc = model.encode_text(
        src, src_mask, None if src_langs is None else src_langs.long(),
        None, deterministic, generator)
    tgt = batch["tgt_tokens"]
    tgt_mask = lengths_to_mask(batch["tgt_len"], tgt.shape[1])
    return seq2seq_ce(model, src_enc, src_mask, tgt, tgt_mask,
                      batch.get("tgt_langs"), generator, deterministic)


def mt_caption_loss(model: M3PModel, batch: Batch,
                    generator: Optional[Generators],
                    refine_image: bool = True, deterministic: bool = False
                    ) -> Tuple[torch.Tensor, Metrics]:
    """Multimodal MT (`m3p_tpu/train/steps.py:380-397`): the joint [img;
    src] encoder, the target decoded over the whole joint encoding."""
    src = batch["src_tokens"].long()
    src_mask = lengths_to_mask(batch["src_len"], src.shape[1])
    img_mask = lengths_to_mask(batch["img_len"], batch["feats"].shape[1])
    joint = model.encode_joint(src, src_mask, batch["feats"], batch["locs"],
                               img_mask, refine_image, deterministic,
                               generator)
    joint_mask = torch.cat([img_mask, src_mask], dim=1)
    tgt = batch["tgt_tokens"]
    tgt_mask = lengths_to_mask(batch["tgt_len"], tgt.shape[1])
    return seq2seq_ce(model, joint, joint_mask, tgt, tgt_mask,
                      batch.get("tgt_langs"), generator, deterministic)


def clm_loss(model: M3PModel, batch: Batch, generator: Optional[Generators],
             deterministic: bool = False, context_size: int = 0
             ) -> Tuple[torch.Tensor, Metrics]:
    """Causal LM on a text stream (`m3p_tpu/train/steps.py:129-155`):
    causal self-attention, next-token CE at every position, the first
    ``context_size`` predictions left out."""
    tokens = batch["tokens"].long()
    text_mask = lengths_to_mask(batch["lengths"], tokens.shape[1])
    x, y = tokens[:, :-1], tokens[:, 1:]
    y_mask = text_mask[:, 1:].float()
    if context_size > 0:
        keep = torch.arange(y.shape[1], device=y.device) >= context_size
        y_mask = y_mask * keep.float()
    langs = batch.get("langs")
    hidden = model.encode_text(
        x, text_mask[:, :-1], None if langs is None else langs[:, :-1].long(),
        None, deterministic, generator, causal=True)
    loss, acc, _ = _next_token_ce(model.shard_word_logits(hidden), y,
                                  y_mask, model.vocab_shard)
    return loss, {"clm": loss.detach(), "acc": acc}


def tifg_loss(model: M3PModel, batch: Batch, generator: Optional[Generators],
              refine_image: bool = True, deterministic: bool = False
              ) -> Tuple[torch.Tensor, Metrics]:
    """Text-to-image-feature generation (`m3p_tpu/train/steps.py:400-426`):
    encode the caption, decode the image stream causally over it, and
    regress the (refined) region embeddings, held fixed, with the MSE."""
    tokens = batch["tokens"].long()
    text_len = batch["text_len"] if "text_len" in batch else batch["tgt_len"]
    text_mask = lengths_to_mask(text_len, tokens.shape[1])
    feats, locs = batch["feats"], batch["locs"]
    img_mask = lengths_to_mask(batch["img_len"], feats.shape[1])
    target = model.embed_image_regions(feats, locs, img_mask, refine_image,
                                       deterministic, generator).detach()
    enc = model.encode_text(tokens, text_mask, None, None, deterministic,
                            generator)
    dec = model.decode_image(feats, locs, img_mask, enc, text_mask,
                             deterministic, generator)
    w = img_mask[..., None].float()
    se = (dec.float() - target.float()) ** 2
    loss = (se * w).sum() / shard_denominator(w.sum() * dec.shape[-1])
    return loss, {"tifg": loss.detach()}


def slide_loss(model: M3PModel, batch: Batch,
               generator: Optional[Generators], refine_image: bool = True,
               deterministic: bool = False) -> Tuple[torch.Tensor, Metrics]:
    """Slide-text matching (`m3p_tpu/train/steps.py:479-501`): the joint
    forward and a binary CE on the ITM score."""
    tokens = batch["tokens"].long()
    text_mask = lengths_to_mask(batch["text_len"], tokens.shape[1])
    img_mask = lengths_to_mask(batch["img_len"], batch["feats"].shape[1])
    hidden = model.encode_joint(tokens, text_mask, batch["feats"],
                                batch["locs"], img_mask, refine_image,
                                deterministic, generator)
    scores = model.itm_score(hidden).float()[:, 0]
    labels = batch["labels"].float()
    loss = F.binary_cross_entropy_with_logits(scores, labels)
    acc = ((scores.detach() > 0) == (labels > 0)).float().mean()
    return loss, {"loss": loss.detach(), "acc": acc}


def pc_loss(model: M3PModel, batch: Batch, generator: Optional[Generators],
            clf_ids: Tuple[int, int] = (8, 9), deterministic: bool = False
            ) -> Tuple[torch.Tensor, Metrics]:
    """Parallel classification (`m3p_tpu/train/steps.py:429-450`): is a
    concatenated sentence pair a translation pair?  The binary classifier
    reuses two rows of the word table, row ``clf_ids[0]`` as its weight and
    the first entry of row ``clf_ids[1]`` as its bias, read in fp32.

    Batch from `data.noise.concat_batches`: tokens (B, L), lengths, langs,
    positions, labels (B,)."""
    tokens = batch["tokens"].long()
    text_mask = lengths_to_mask(batch["lengths"], tokens.shape[1])
    langs, positions = batch.get("langs"), batch.get("positions")
    hidden = model.encode_text(
        tokens, text_mask, None if langs is None else langs.long(),
        None if positions is None else positions.long(), deterministic,
        generator)
    h0 = hidden[:, 0].float()
    rows = model.text_emb.word.rows(
        torch.tensor(clf_ids, device=h0.device), torch.float32)
    logits = h0 @ rows[0] + rows[1, 0]
    labels = batch["labels"].float()
    loss = F.binary_cross_entropy_with_logits(logits, labels)
    acc = ((logits.detach() > 0) == (labels > 0)).float().mean()
    return loss, {"pc": loss.detach(), "acc": acc}


def mass_loss(model: M3PModel, batch: Batch, generator: Optional[Generators],
              deterministic: bool = False) -> Tuple[torch.Tensor, Metrics]:
    """MASS segment-masked seq2seq (`m3p_tpu/train/steps.py:453-476`):
    encode the span-masked sentence, decode the masked span causally from
    its previous tokens at the span's source positions, with
    cross-attention over the encoding.

    Batch from `data.span_masking.mass_mask`: enc_tokens (B, S), enc_len,
    dec_tokens / dec_pos / targets / target_mask (B, M), langs (B, S)."""
    enc = batch["enc_tokens"].long()
    enc_mask = lengths_to_mask(batch["enc_len"], enc.shape[1])
    langs = batch.get("langs")
    src_enc = model.encode_text(
        enc, enc_mask, None if langs is None else langs.long(), None,
        deterministic, generator)
    tgt_mask = batch["target_mask"].float()
    dec = model.encode_text(batch["dec_tokens"].long(), tgt_mask > 0, None,
                            batch["dec_pos"].long(), deterministic,
                            generator, causal=True, src_enc=src_enc,
                            src_mask=enc_mask)
    loss, _, _ = _next_token_ce(model.shard_word_logits(dec),
                                batch["targets"], tgt_mask,
                                model.vocab_shard)
    return loss, {"mass": loss.detach()}


def _pack(rows: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """rows (B, P, ...) -> (B * P, ...)[index]."""
    return rows.reshape((-1,) + tuple(rows.shape[2:]))[index]


def _global_top_k(w: torch.Tensor, budget: Callable[[int], int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``top_k(w, budget(w.numel()))``, over the global batch under data
    parallelism: the flat weights of every batch shard are gathered, the
    global top k taken (the JAX packing over the global batch), and this
    shard keeps the selected entries that are its own, as (values, local
    indices) in the global order."""
    index, count = shard_position()
    if count == 1:
        return top_k(w, budget(w.numel()))
    every = gather_batch(w)
    values, idx = top_k(every, budget(every.numel()))
    lo = index * w.numel()
    mine = (idx >= lo) & (idx < lo + w.numel())
    return values[mine], idx[mine] - lo


def _gather_rows(hidden: torch.Tensor, positions: torch.Tensor
                 ) -> torch.Tensor:
    """hidden (B, S, D) at positions (B, P) -> (B, P, D)."""
    index = positions.long()[..., None].expand(-1, -1, hidden.shape[-1])
    return hidden.gather(1, index)


def mct_draws(generator: torch.Generator, batch: Batch,
              mask_cfg: MaskingConfig,
              mask_scores: Optional[torch.Tensor] = None
              ) -> Dict[str, object]:
    """The randomness of `mct_pretrain_loss` before its forward, drawn from
    ``generator`` on the batch's device: ``coin`` (BN,) float, 1 = mask
    the row's words, 0 = its objects (the reference's 50/50 choice), and
    ``text_masking`` / ``region_masking`` as `mask_tokens` / `mask_regions`
    return them."""
    tokens = batch["tokens"].long()
    bn, s = tokens.shape
    img_mask = lengths_to_mask(batch["img_len"], batch["feats"].shape[1])
    coin = (torch.rand((bn,), generator=generator, device=tokens.device)
            < 0.5).float()
    text = mask_tokens(generator, tokens,
                       lengths_to_mask(batch["text_len"], s), mask_cfg,
                       mask_scores)
    regions = mask_regions(generator, batch["feats"], batch["obj_labels"],
                           img_mask, mask_cfg)
    return {"coin": coin, "text_masking": text, "region_masking": regions}


def mct_pretrain_loss(model: M3PModel, batch: Batch,
                      generator: Optional[Generators],
                      mask_cfg: MaskingConfig, sample_n: int,
                      lambda_rel=1.0, lambda_mlm=1.0, lambda_mrm=1.0,
                      lambda_mrfr=1.0, lambda_clcm=1.0,
                      refine_image: bool = True, deterministic: bool = False,
                      text_delta: Optional[torch.Tensor] = None,
                      img_delta: Optional[torch.Tensor] = None,
                      mask_scores: Optional[torch.Tensor] = None,
                      pack_ratio: float = 0.5,
                      multi_cls_weight: float = 1.0,
                      bin_cls_weight: float = 1.0,
                      coin: Optional[torch.Tensor] = None,
                      text_masking: Optional[Sequence[torch.Tensor]] = None,
                      region_masking: Optional[Sequence[torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, Metrics]:
    """The multitask pre-training loss (`m3p_tpu/train/steps.py:179-318`).

    Batch (grid-flattened, BN = B * sample_n): tokens (BN, S), text_len,
    feats (BN, R, 2048), locs (BN, R, 5), obj_labels (BN, R), img_len,
    pos_label (B,), optionally raw_feats (the MRFR targets) and clcm_tokens
    (BN, S2), clcm_len, clcm_labels (BN,).

    ``coin``, ``text_masking`` and ``region_masking`` are as `mct_draws`
    returns them; when any is None, `mct_draws` draws them on the device
    from ``generator.device``.  Passing them in lets a caller hold the
    loss against another implementation's draws.

    ``text_delta`` (BN, S, D) and ``img_delta`` (BN, R, 2048) are freeLB's
    adversarial perturbations (`train/freelb.py`): the first is added to
    the masked tokens' word embeddings, the second to the masked region
    features in their dtype (the CLCM encode sees them too)."""
    tokens = batch["tokens"].long()
    feats = batch["feats"]
    bn, s = tokens.shape
    r = feats.shape[1]
    text_mask = lengths_to_mask(batch["text_len"], s)
    img_mask = lengths_to_mask(batch["img_len"], r)
    if coin is None or text_masking is None or region_masking is None:
        if generator is None:
            raise ValueError("mct_pretrain_loss needs generators to draw "
                             "its coin and maskings (or all three passed "
                             "in)")
        drawn = mct_draws(generator.device, batch, mask_cfg, mask_scores)
        coin = drawn["coin"] if coin is None else coin
        if text_masking is None:
            text_masking = drawn["text_masking"]
        if region_masking is None:
            region_masking = drawn["region_masking"]
    coin = coin.float()
    masked_tokens, pos_t, lab_t, w_t = text_masking
    w_t = w_t * coin[:, None]
    masked_tokens = torch.where(coin[:, None] > 0, masked_tokens.long(),
                                tokens)
    masked_feats, pos_r, lab_r, w_r, tgt_r = region_masking
    if "raw_feats" in batch:
        # MRFR regresses the original, un-normalized region features
        tgt_r = _gather_rows(batch["raw_feats"], pos_r)
    w_r = w_r * (1.0 - coin)[:, None]
    masked_feats = torch.where((coin < 1)[:, None, None], masked_feats,
                               feats)
    token_embeds = None
    if text_delta is not None:
        token_embeds = model.embed_tokens(masked_tokens) + text_delta
    if img_delta is not None:
        masked_feats = masked_feats + img_delta.to(masked_feats.dtype)

    hidden = model.encode_joint(masked_tokens, text_mask, masked_feats,
                                batch["locs"], img_mask, refine_image,
                                deterministic=deterministic,
                                generator=generator,
                                token_embeds=token_embeds)
    img_out, text_out = hidden[:, :r], hidden[:, r:]

    # MC-MLM: the active slots packed across the batch before the
    # 250k-vocab head (zero-weight slots add nothing; on overflow the
    # surplus drops, as in the JAX loss)
    pack_w, pack_idx = _global_top_k(
        w_t.reshape(-1), lambda n: max(int(n * pack_ratio), 1))
    g_pack = _pack(_gather_rows(text_out, pos_t), pack_idx)
    mlm = masked_ce(model.shard_word_logits(g_pack),
                    _pack(lab_t, pack_idx), pack_w, model.vocab_shard)

    # MC-MRM and MRFR: the same packing with a fixed 0.5 budget
    packr_w, packr_idx = _global_top_k(w_r.reshape(-1),
                                       lambda n: max(n // 2, 1))
    g_r_pack = _pack(_gather_rows(img_out, pos_r), packr_idx)
    lab_r_pack = _pack(lab_r, packr_idx)
    w_obj = packr_w * (lab_r_pack >= 0).float()
    mrm = masked_ce(model.obj_logits(g_r_pack), lab_r_pack, w_obj)
    tgt_r_pack = _pack(tgt_r, packr_idx)
    pred_feats = model.mrfr_predict(g_r_pack).float()
    se = ((pred_feats - tgt_r_pack.float()) ** 2).mean(dim=-1)
    mrfr = (se * packr_w).sum() / shard_denominator(packr_w.sum())

    # ITM over the candidate grid
    ce, bce = itm_grid_losses(model.itm_score(hidden), batch["pos_label"],
                              sample_n)
    rel = multi_cls_weight * ce + bin_cls_weight * bce

    total = (lambda_rel * rel + lambda_mlm * mlm + lambda_mrm * mrm
             + lambda_mrfr * mrfr)
    metrics = {"rel": rel, "mlm": mlm, "mrm": mrm, "mrfr": mrfr}

    # CLCM: concatenated-caption pairs with binary labels
    if "clcm_tokens" in batch:
        clcm_tokens = batch["clcm_tokens"].long()
        clcm_mask = lengths_to_mask(batch["clcm_len"], clcm_tokens.shape[1])
        hidden2 = model.encode_joint(clcm_tokens, clcm_mask, masked_feats,
                                     batch["locs"], img_mask, refine_image,
                                     deterministic=deterministic,
                                     generator=generator)
        s2 = model.clcm_score(hidden2).float()
        clcm = F.binary_cross_entropy_with_logits(
            s2[:, 0], batch["clcm_labels"].float())
        total = total + lambda_clcm * clcm
        metrics["clcm"] = clcm

    metrics["loss"] = total
    return total, {k: v.detach() for k, v in metrics.items()}


def make_train_step(loss_fn: Callable[..., Tuple[torch.Tensor, Metrics]],
                    with_grad_norm: bool = False) -> Callable:
    """Wrap ``loss_fn(model, batch, generator, **kw)`` into a
    (state, batch, generator, **kw) -> (state, metrics) step: loss,
    backward, one optimizer update (`m3p_tpu/train/steps.py:504-538`).
    ``with_grad_norm`` adds the global gradient norm to the metrics.  The
    state is updated in place and returned; nothing waits for the device
    on one rank.  With a ``state.mesh`` of several ranks the batch is this
    rank's shard: the losses' counts reduce over the shards, and the
    gradients and metrics are averaged over the ranks before the norm and
    the update (`TrainState.sync_gradients`)."""

    def step(state: TrainState, batch: Batch,
             generator: Optional[Generators], **kw
             ) -> Tuple[TrainState, Metrics]:
        batch = expand_compact_batch(batch)
        state.model.zero_grad(set_to_none=True)
        with batch_reduction(state.mesh):
            loss, metrics = loss_fn(state.model, batch, generator, **kw)
        loss.backward()
        metrics = dict(state.sync_gradients(dict(metrics)))
        if with_grad_norm:
            metrics["grad_norm"] = state.grad_norm()
        return state.apply_gradients(), metrics

    return step
