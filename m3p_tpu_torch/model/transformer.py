"""The M3P model of the port (counterpart of `m3p_tpu/model/transformer.py`).

The forward topologies, each over the one shared stack of post-LN blocks
(`_run_blocks`):

* ``encode_joint`` -- single-stream fusion over the [img; text] concat:
  serving's pair scoring and retrieval, the ITM fine-tune, MCT
  pre-training, slide matching, the multimodal-MT encoder;
* ``encode_text`` -- the text stream (``embed_text`` + the stack): xMLM
  non-causal; causal for CLM; causal with cross-attention over a source
  encoding (``src_enc``) for the teacher-forced decoders of captioning and
  translation;
* ``encode_image`` -- the image stream (region embeddings, the optional AoA
  refiner before and after the stack): the captioning encoder;
* ``embed_image_regions`` -- region embeddings and the refiner without the
  stack: the TIFG target;
* ``decode_image`` -- a causal image stream with cross-attention over a
  text encoding: the TIFG generator.

Heads: the tied word head (`word_logits`; the adaptive softmax
``pred_layer_asm`` under ``asm``), the object, ITM, CLCM and MRFR heads.
The variants of the configuration: the dynamic int8 modes (``ffn_quant``
"int8", "int8_bwd", "int8_all"; ``head_quant="int8_bwd"``), an
expert-choice MoE FFN on every ``moe_interval``-th block, and the BiDAF
image fusion ``cross_align`` under ``image_fusion``.  Incremental
decoding (`model/generation.py`) runs ``encode_text`` with a
`DecodeCache` (`init_cache`, `init_decode_cache`): per-block
self-attention keys and values written in place and the source's
cross-attention keys and values projected once.

``remat`` recomputes each block of the stack in the backward
(`torch.utils.checkpoint`), with the block's own draws replayed from both
generators (`_remat_block`), as the JAX model wraps its blocks in
``nn.remat`` (`m3p_tpu/model/transformer.py:77-80`).  The module tree mirrors
the JAX parameter tree
(``text_emb``, ``image_emb``, ``refiner``, ``block_<i>``, the heads), so a
JAX checkpoint loads strictly.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model.embeddings import (
    AoARefiner, ImageEmbeddings, TextEmbeddings)
from m3p_tpu_torch.model.heads import (
    AdaptiveSoftmax, MRFRHead, ObjPredLayer, Pooler, PredLayer)
from m3p_tpu_torch.model.layers import (
    EncoderBlock, Generators, KVCache, LayerCache, dropout)
from m3p_tpu_torch.model.misc import CrossAlignMatrix
from m3p_tpu_torch.parallel import data_parallel
from m3p_tpu_torch.parallel import mesh as M
from m3p_tpu_torch.parallel.tensor_parallel import (
    VocabShard, copy_to, gather_vocab, shard_of)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


FFN_QUANT_MODES = ("none", "int8", "int8_bwd", "int8_all", "int8_infer")
HEAD_QUANT_MODES = ("none", "int8_bwd", "int8_infer")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for config features the port lacks: a ``param_dtype`` other
    than fp32 (NotImplementedError); an unknown quantization mode
    (ValueError).  ``seq_axis`` builds: it names the mesh axis the
    sequence-parallel path (`parallel.sp.SPModel`) shards the stack over;
    the model alone runs the whole sequence."""
    for name, modes in (("ffn_quant", FFN_QUANT_MODES),
                        ("head_quant", HEAD_QUANT_MODES)):
        if getattr(cfg, name) not in modes:
            raise ValueError(f"unknown {name} {getattr(cfg, name)!r}; "
                             f"known: {modes}")
    if cfg.param_dtype != "float32":
        raise NotImplementedError("the PyTorch port stores parameters in "
                                  "float32 only")


def _check_generators(what: str, deterministic: bool,
                      generator: Optional[Generators]) -> None:
    if not deterministic and generator is None:
        raise ValueError(f"{what}(deterministic=False) needs generators")


def _remat_block(block, x, pad_mask, causal, deterministic, generator,
                 src_enc, src_mask):
    """``block`` under `torch.utils.checkpoint`: its activations are not
    kept, and the backward runs its forward again.  Its randomness lives in
    the explicit generators (`Generators`), which checkpoint does not
    replay: their states at the block's entry are kept, put back for the
    recompute, which then draws the forward's masks and seeds, and the
    states the forward left are restored after it.  The recompute runs in
    the backward, after the step's contexts have closed, so it enters again
    the batch reduction (MoE's global tokens) and the bound sequence axis
    (the ring) that the forward ran in."""
    gens = ([] if generator is None or deterministic
            else [generator.device, generator.host])
    entry = [g.get_state() for g in gens]
    batch, bound = data_parallel.batch_mesh(), M.bound_seq_axis()
    runs = []

    def run(x_, pad_mask_, src_enc_, src_mask_):
        if runs:                                # the recompute
            left = [g.get_state() for g in gens]
            for g, state in zip(gens, entry):
                g.set_state(state)
            try:
                with contextlib.ExitStack() as stack:
                    stack.enter_context(data_parallel.batch_reduction(batch))
                    if bound is not None:
                        stack.enter_context(M.bind_axes(*bound))
                    return block(x_, pad_mask_, causal, deterministic,
                                 generator, src_enc=src_enc_,
                                 src_mask=src_mask_)
            finally:
                for g, state in zip(gens, left):
                    g.set_state(state)
        runs.append(1)
        return block(x_, pad_mask_, causal, deterministic, generator,
                     src_enc=src_enc_, src_mask=src_mask_)

    return checkpoint(run, x, pad_mask, src_enc, src_mask,
                      use_reentrant=False)


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool validity mask."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


@dataclass
class DecodeCache:
    """The decode cache of the block stack
    (`m3p_tpu/model/transformer.py:376-411`): one `LayerCache` per block
    and the one position ``pos`` of the next step, a Python int so that
    reading it never waits for the device.  `M3PModel.encode_text` writes
    the step's keys and values at ``pos`` in every block, then advances
    ``pos`` once by the step's length (every JAX layer carries its own
    ``pos``; all of them move together)."""

    layers: List[LayerCache]
    pos: int = 0

    def select(self, rows: torch.Tensor) -> None:
        """Keep the self-attention rows ``rows`` (B') of every block: a
        beam search's gather of its surviving beams
        (`m3p_tpu/model/generation.py:117-144`, `index_select` for the
        one-hot einsum, bitwise the same values).  The cross caches are
        shared by a row's beams and stay as they are."""
        for layer in self.layers:
            kv = layer.self_kv
            layer.self_kv = KVCache(kv.k.index_select(0, rows),
                                    kv.v.index_select(0, rows))


class M3PModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        d = cfg.emb_dim
        self.text_emb = TextEmbeddings(cfg.n_words, cfg.n_langs, d,
                                       cfg.max_positions,
                                       cfg.sinusoidal_embeddings, dt,
                                       cfg.dropout)
        self.image_emb = ImageEmbeddings(d, cfg.img_feat_dim, cfg.img_loc_dim,
                                         dt, cfg.dropout)
        self.refiner = AoARefiner(cfg.n_heads, d, cfg.ffn_dim,
                                  cfg.refine_layers, dt, cfg.dropout,
                                  cfg.attention_dropout)
        self.blocks = []
        for i in range(cfg.n_layers):
            block = EncoderBlock(cfg.n_heads, d, cfg.ffn_dim,
                                 cfg.gelu_activation,
                                 has_cross_attention=True, dtype=dt,
                                 dropout=cfg.dropout,
                                 attention_dropout=cfg.attention_dropout,
                                 use_fused_dropout=cfg.use_fused_dropout,
                                 ffn_quant=cfg.ffn_quant,
                                 moe_experts=self._moe(i),
                                 moe_capacity_factor=cfg.moe_capacity_factor)
            self.add_module(f"block_{i}", block)
            self.blocks.append(block)
        if cfg.asm:
            self.pred_layer_asm = AdaptiveSoftmax(
                cfg.n_words, d, tuple(cfg.asm_cutoffs), cfg.asm_div_value,
                dt)
        else:
            self.pred_layer = PredLayer(cfg.n_words, d, cfg.share_inout_emb,
                                        dt, cfg.head_quant)
        if cfg.image_fusion:
            self.cross_align = CrossAlignMatrix(d, dt)
        self.obj_pred = ObjPredLayer(cfg.n_obj_classes, d, dt)
        self.itm_pooler = Pooler(d, dt)
        self.clcm_pooler = Pooler(d, dt)
        self.mrfr_head = MRFRHead(d, cfg.img_feat_dim, dt)

    def _moe(self, i: int) -> int:
        """The experts of block ``i``: every ``moe_interval``-th block
        carries the MoE FFN (`m3p_tpu/model/transformer.py:81-85`)."""
        cfg = self.cfg
        if cfg.moe_experts > 0 and (i + 1) % cfg.moe_interval == 0:
            return cfg.moe_experts
        return 0

    def encode_joint(self, tokens: torch.Tensor, text_mask: torch.Tensor,
                     feats: torch.Tensor, locs: torch.Tensor,
                     img_mask: torch.Tensor, refine_image: bool = False,
                     deterministic: bool = True,
                     generator: Optional[Generators] = None,
                     token_embeds: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Single-stream fusion over the [img; text] concat: (B, R+S, D),
        image part first.  Positions run over the whole concat.

        ``deterministic=False`` turns dropout on (the training forward);
        ``generator`` then draws every mask and attention seed.
        ``token_embeds`` (B, S, D) replaces the word lookup of ``tokens``
        (freeLB)."""
        _check_generators("encode_joint", deterministic, generator)
        x, joint_mask = self.embed_joint(tokens, text_mask, feats, locs,
                                         img_mask, refine_image,
                                         deterministic, generator,
                                         token_embeds)
        return self._run_blocks(x, joint_mask, False, None, None,
                                deterministic, generator)

    def embed_joint(self, tokens: torch.Tensor, text_mask: torch.Tensor,
                    feats: torch.Tensor, locs: torch.Tensor,
                    img_mask: torch.Tensor, refine_image: bool = False,
                    deterministic: bool = True,
                    generator: Optional[Generators] = None,
                    token_embeds: Optional[torch.Tensor] = None):
        """The half of `encode_joint` before the stack: ((B, R+S, D)
        embeddings, (B, R+S) joint mask)
        (`m3p_tpu/model/transformer.py:284-315`).  The sequence-parallel
        path shards them over the ``seq`` axis and runs `run_blocks_only`."""
        rng = (deterministic, generator)
        img = self.image_emb(feats, locs, None, *rng)
        img = img * img_mask[..., None].to(img.dtype)
        if refine_image:
            img = self.refiner(img, img_mask, *rng)
        txt = (self.text_emb.embed_tokens(tokens) if token_embeds is None
               else token_embeds)
        x = torch.cat([img, txt.to(img.dtype)], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = x + self.text_emb.position(positions)
        joint_mask = torch.cat([img_mask, text_mask], dim=1)
        x = x * joint_mask[..., None].to(x.dtype)
        x = dropout(self.text_emb.ln_emb(x), self.cfg.dropout, *rng)
        return x, joint_mask

    def run_blocks_only(self, x: torch.Tensor, pad_mask: torch.Tensor,
                        deterministic: bool = True,
                        generator: Optional[Generators] = None
                        ) -> torch.Tensor:
        """The stack without a cache, non-causal: the body the
        sequence-parallel path runs on each shard inside
        `parallel.mesh.bind_axes` (`m3p_tpu/model/transformer.py:317-322`)."""
        return self._run_blocks(x, pad_mask, False, None, None,
                                deterministic, generator)

    def _run_blocks(self, x: torch.Tensor, pad_mask: torch.Tensor,
                    causal: bool, src_enc: Optional[torch.Tensor],
                    src_mask: Optional[torch.Tensor], deterministic: bool,
                    generator: Optional[Generators],
                    cache: Optional[DecodeCache] = None) -> torch.Tensor:
        """The stack of blocks (`m3p_tpu/model/transformer.py:136-145`).
        With ``cache``, one decode step at ``cache.pos``, which then
        advances by the step's length."""
        layers = cache.layers if cache is not None else [None] * len(
            self.blocks)
        pos = cache.pos if cache is not None else 0
        remat = (self.cfg.remat and cache is None
                 and torch.is_grad_enabled())
        for block, layer in zip(self.blocks, layers, strict=True):
            if remat:
                x = _remat_block(block, x, pad_mask, causal, deterministic,
                                 generator, src_enc, src_mask)
                continue
            x = block(x, pad_mask, causal, deterministic, generator,
                      src_enc=src_enc, src_mask=src_mask, cache=layer,
                      pos=pos)
        if cache is not None:
            cache.pos += x.shape[1]
        return x

    def embed_text(self, tokens: torch.Tensor, text_mask: torch.Tensor,
                   langs: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   deterministic: bool = True,
                   generator: Optional[Generators] = None,
                   token_embeds: Optional[torch.Tensor] = None,
                   image_enc: Optional[torch.Tensor] = None,
                   image_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
        """Word + position (+ language) embeddings, LN and dropout, then
        the padding zeroed: the pre-block half of `encode_text`
        (`m3p_tpu/model/transformer.py:147-167`).  ``token_embeds``
        replaces the word lookup (freeLB).  ``image_enc`` (B, R, D) with
        ``image_mask`` (B, R) fuses an image encoding into the text
        through ``cross_align`` (``image_fusion`` models only)."""
        x = self.text_emb(tokens, positions, langs, deterministic, generator,
                          token_embeds)
        x = x * text_mask[..., None].to(x.dtype)
        if image_enc is not None and image_mask is not None:
            if not self.cfg.image_fusion:
                raise ValueError("image_enc needs a model built with "
                                 "image_fusion=True")
            x = self.cross_align(x, image_enc, image_mask)
        return x

    def encode_text(self, tokens: torch.Tensor, text_mask: torch.Tensor,
                    langs: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None,
                    deterministic: bool = True,
                    generator: Optional[Generators] = None,
                    causal: bool = False,
                    src_enc: Optional[torch.Tensor] = None,
                    src_mask: Optional[torch.Tensor] = None,
                    cache: Optional[DecodeCache] = None,
                    token_embeds: Optional[torch.Tensor] = None,
                    image_enc: Optional[torch.Tensor] = None,
                    image_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """The text stream (`m3p_tpu/model/transformer.py:169-191`): (B, S)
        tokens -> (B, S, D).  ``causal`` masks the future; ``src_enc``
        (B, Ss, D) with ``src_mask`` adds cross-attention in every block
        (the teacher-forced decoder).  Attention takes the packed kernels
        up to 512 tokens and the flash kernels above.

        ``cache`` makes it one incremental decode step at ``cache.pos``
        (deterministic; ``causal`` then has no effect, the cache mask ends
        at the step), updating the cache in place; attention goes
        head-major through `ops.attention.attention_bhsd`.
        ``token_embeds`` (B, S, D) replaces the word lookup (freeLB);
        ``image_enc`` / ``image_mask`` the BiDAF image fusion (see
        `embed_text`)."""
        _check_generators("encode_text", deterministic, generator)
        x = self.embed_text(tokens, text_mask, langs, positions,
                            deterministic, generator, token_embeds,
                            image_enc, image_mask)
        return self._run_blocks(x, text_mask, causal, src_enc, src_mask,
                                deterministic, generator, cache)

    def encode_image(self, feats: torch.Tensor, locs: torch.Tensor,
                     img_mask: torch.Tensor, refine_image: bool = False,
                     deterministic: bool = True,
                     generator: Optional[Generators] = None,
                     refine_encoder: bool = False) -> torch.Tensor:
        """The image stream (`m3p_tpu/model/transformer.py:193-218`):
        region embeddings (no positions, no embedding LN), the AoA refiner
        if ``refine_image``, the stack, and with ``refine_encoder`` the same
        refiner again after it.  (B, R, 2048) -> (B, R, D)."""
        _check_generators("encode_image", deterministic, generator)
        rng = (deterministic, generator)
        x = self.embed_image_regions(feats, locs, img_mask, refine_image,
                                     *rng)
        x = self._run_blocks(x, img_mask, False, None, None, *rng)
        if refine_encoder:
            x = self.refiner(x, img_mask, *rng)
        return x

    def embed_image_regions(self, feats: torch.Tensor, locs: torch.Tensor,
                            img_mask: torch.Tensor, refine_image: bool = True,
                            deterministic: bool = True,
                            generator: Optional[Generators] = None,
                            dist: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """Region embeddings, the padding zeroed, and the AoA refiner if
        ``refine_image``, without the stack
        (`m3p_tpu/model/transformer.py:220-235`).  ``dist`` (B, R, 1600) adds
        the class-distribution projection (`ImageEmbeddings`)."""
        _check_generators("embed_image_regions", deterministic, generator)
        x = self.image_emb(feats, locs, dist, deterministic, generator)
        x = x * img_mask[..., None].to(x.dtype)
        if refine_image:
            x = self.refiner(x, img_mask, deterministic, generator)
        return x

    def decode_image(self, feats: torch.Tensor, locs: torch.Tensor,
                     img_mask: torch.Tensor, src_enc: torch.Tensor,
                     src_mask: torch.Tensor, deterministic: bool = True,
                     generator: Optional[Generators] = None) -> torch.Tensor:
        """A causal image stream with cross-attention over a text encoding
        ``src_enc`` (`m3p_tpu/model/transformer.py:324-345`): the TIFG
        generator."""
        _check_generators("decode_image", deterministic, generator)
        x = self.embed_image_regions(feats, locs, img_mask, False,
                                     deterministic, generator)
        return self._run_blocks(x, img_mask, True, src_enc, src_mask,
                                deterministic, generator)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.text_emb.embed_tokens(tokens)

    def init_cache(self, batch_size: int, max_len: int) -> DecodeCache:
        """A decode cache of ``batch_size`` rows and ``max_len`` positions:
        self-attention keys and values of zeros in the compute dtype, no
        cross cache (cross-attention then projects the source at every
        step), ``pos`` 0 (`m3p_tpu/model/transformer.py:376-390`)."""
        cfg = self.cfg
        # this rank's heads under tensor parallelism
        shape = (batch_size, self.blocks[0].attn.n_heads, max_len,
                 cfg.head_dim)
        dev = self.text_emb.word.weight.device
        dt = torch_dtype(cfg.dtype)
        return DecodeCache([
            LayerCache(KVCache(torch.zeros(shape, dtype=dt, device=dev),
                               torch.zeros(shape, dtype=dt, device=dev)))
            for _ in self.blocks])

    @torch.no_grad()
    def init_decode_cache(self, src_enc: torch.Tensor, max_len: int,
                          batch_size: Optional[int] = None) -> DecodeCache:
        """`init_cache` plus each block's cross-attention keys and values
        over ``src_enc`` (B, Ss, D), projected once here rather than at
        every step (`m3p_tpu/model/transformer.py:392-411`).
        ``batch_size`` (default B) sizes the self cache: beam search passes
        B * K and keeps ``src_enc`` unreplicated, and cross-attention folds
        the beams of a row into its query length.  Decoding takes no
        gradient: the cache holds none."""
        b = batch_size if batch_size is not None else src_enc.shape[0]
        cache = self.init_cache(b, max_len)
        for block, layer in zip(self.blocks, cache.layers, strict=True):
            layer.cross_kv = block.encoder_attn.project_kv(src_enc)
        return cache

    def word_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., n_words) through the tied word table and the
        per-word bias, or under ``asm`` the adaptive softmax's normalized
        log-probabilities (`m3p_tpu/model/transformer.py:346-353`).  Under
        tensor parallelism the ranks' columns are gathered (decoding and
        evaluation); the training losses take `shard_word_logits`."""
        return gather_vocab(self.shard_word_logits(hidden), self.vocab_shard)

    @property
    def vocab_shard(self) -> Optional[VocabShard]:
        """This rank's words when the word head is split over ``tensor``."""
        return None if self.cfg.asm else self.pred_layer.vocab

    def shard_word_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """`word_logits` of this rank's words (all of them unless the word
        head is split over ``tensor``: `vocab_shard`)."""
        if self.cfg.asm:
            return self.pred_layer_asm(hidden)
        vocab = self.vocab_shard
        table = None
        if self.cfg.share_inout_emb:
            # a whole table goes as it is (an int8 head reads its own)
            word = self.text_emb.word
            table = (word.weight if shard_of(word.weight) is None
                     else word.table(torch_dtype(self.cfg.dtype)))
        if vocab is not None:
            hidden = copy_to(hidden, vocab.mesh, "tensor")
        return self.pred_layer(hidden, embedding=table)

    def obj_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., n_obj_classes): the MC-MRM object head."""
        return self.obj_pred(hidden)

    def itm_score(self, hidden: torch.Tensor) -> torch.Tensor:
        """(B, S, D) -> (B, 1) image-text matching score (token 0 pooled)."""
        return self.itm_pooler(hidden)

    def clcm_score(self, hidden: torch.Tensor) -> torch.Tensor:
        """(B, S, D) -> (B, 1) cross-lingual contrastive-match score (token
        0 pooled)."""
        return self.clcm_pooler(hidden)

    def mrfr_predict(self, hidden: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., img_feat_dim): the MRFR feature regression."""
        return self.mrfr_head(hidden)
