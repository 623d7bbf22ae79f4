"""FreeLB adversarial training of the port (counterpart of
`m3p_tpu/train/freelb.py`): embedding-space PGD with "free" gradient
accumulation.

* text delta init  ~ U(-1,1) * adv_init_mag / sqrt(len * d)   (l2 norm)
* image delta init ~ U(-1,1) * adv_init_mag / sqrt(feat_dim)
* K adversarial passes, each a forward and a backward of the whole loss:
  the parameter gradients accumulate as sum_k g_k / K (zeroed once before
  the first pass), and each delta ascends by adv_lr * g / ||g|| (rowwise)
  of its own gradient, projected onto the adv_max_norm ball (a
  `torch.profiler` range, ``ASCENT_SPAN``, marks it in a trace)
* the deltas perturb the word embeddings (before positions and LN) and the
  raw 2048-d region features; one optimizer update follows the K passes

The JAX package scans the K passes inside one compiled step; here they are
K autograd passes.  As in the JAX steps, the ITM and caption steps run
deterministic (no dropout), and the pre-training step replays one draw of
its coin, maskings and dropout masks in every pass: both generators of its
`Generators` are rewound to their state before the first pass.

Each `make_freelb_*` returns a ``step(state, batch, generator, deltas=None,
**lam) -> (state, metrics)`` in the idiom of
`train.steps.make_train_step`.  ``generator`` draws the initial deltas
from ``generator.device``; ``deltas`` = (text delta, image delta) passes
them in instead, so that a caller can hold a step against another
implementation's draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.model.transformer import M3PModel, lengths_to_mask
from m3p_tpu_torch.parallel.data_parallel import batch_reduction
from m3p_tpu_torch.train.state import TrainState
from m3p_tpu_torch.train.steps import (
    Batch, Metrics, _next_token_ce, expand_compact_batch, itm_grid_losses,
    mct_pretrain_loss)

Deltas = Tuple[torch.Tensor, torch.Tensor]
# the profiler range around the deltas' ascent in every pass
ASCENT_SPAN = "freelb_ascent"


@dataclass(frozen=True)
class FreeLBConfig:
    adv_steps: int = 3
    adv_lr: float = 1e-3
    adv_init_mag: float = 1e-4
    adv_max_norm: float = 1e-2     # 0 disables projection
    norm_type: str = "l2"
    free_text: bool = True
    free_img: bool = True


def _init_delta(generator: torch.Generator, shape: Sequence[int],
                lengths: torch.Tensor, dim: int, mag: float,
                norm_type: str) -> torch.Tensor:
    """An fp32 delta of ``shape`` on the generator's device: U(-mag, mag)
    under linf; under l2, U(-1, 1) * mag / sqrt(length * dim) per row."""
    u = torch.empty(tuple(shape), device=generator.device)
    if norm_type == "linf":
        return u.uniform_(-mag, mag, generator=generator)
    u.uniform_(-1.0, 1.0, generator=generator)
    dims = (lengths.to(u.device).float() * dim).reshape(-1, 1, 1)
    return u * (mag / torch.sqrt(dims))


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    """The l2 norm of each row of x (B, N), summed in float64, in x's
    dtype."""
    return torch.linalg.vector_norm(x.double(), dim=1).to(x.dtype)


def _ascend(delta: torch.Tensor, grad: torch.Tensor, adv_lr: float,
            adv_max_norm: float, norm_type: str) -> torch.Tensor:
    """delta + adv_lr * grad / ||grad|| per row (the norm floored at 1e-8),
    then projected onto the ``adv_max_norm`` ball (0: no projection).  The
    l2 norms are summed in float64 and rounded once, so that they are the
    correctly rounded fp32 norms, as XLA's are on the CPU: one unit of
    rounding in a norm shows as a large relative error wherever the
    ascent nearly cancels an entry of the delta."""
    b = delta.shape[0]
    g = grad.reshape(b, -1)
    if norm_type == "linf":
        denorm = g.abs().amax(dim=1).reshape(-1, 1, 1)
    else:
        denorm = _row_norms(g).reshape(-1, 1, 1)
    denorm = denorm.clamp_min(1e-8)
    delta = delta + adv_lr * grad / denorm
    if adv_max_norm > 0:
        if norm_type == "linf":
            delta = delta.clamp(-adv_max_norm, adv_max_norm)
        else:
            norms = _row_norms(delta.reshape(b, -1))
            scale = torch.where(norms > adv_max_norm,
                                adv_max_norm / norms.clamp_min(1e-8),
                                torch.ones_like(norms))
            delta = delta * scale.reshape(-1, 1, 1)
    return delta


def _initial_deltas(generator: Optional[Generators],
                    deltas: Optional[Deltas], adv: FreeLBConfig,
                    text_shape: Sequence[int], text_len: torch.Tensor,
                    dim: int, feats: torch.Tensor) -> Deltas:
    """(text delta, image delta), both fp32: passed in, or drawn from
    ``generator.device`` (text first)."""
    if deltas is not None:
        return deltas
    if generator is None:
        raise ValueError("a freeLB step needs generators to draw its "
                         "initial deltas (or the deltas passed in)")
    gen = generator.device
    d_text = _init_delta(gen, text_shape, text_len, dim, adv.adv_init_mag,
                         adv.norm_type)
    d_img = _init_delta(gen, feats.shape,
                        torch.ones(feats.shape[0], device=feats.device),
                        feats.shape[-1], adv.adv_init_mag, adv.norm_type)
    return d_text.to(feats.device), d_img.to(feats.device)


def _free_passes(state: TrainState, adv: FreeLBConfig,
                 loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor],
                 d_text: torch.Tensor, d_img: torch.Tensor,
                 replay: Optional[Callable[[], None]] = None
                 ) -> torch.Tensor:
    """The K passes: each differentiates ``loss_fn(d_text, d_img)`` with
    respect to the parameters (accumulated in ``.grad``, divided by K at
    the end) and to each delta in use (its own gradient, by which it
    ascends).  ``replay`` runs before every pass.  Returns the mean loss."""
    model = state.model
    model.zero_grad(set_to_none=True)
    k_steps = adv.adv_steps
    mean = torch.zeros((), device=d_text.device)
    for _ in range(k_steps):
        if replay is not None:
            replay()
        d_t = d_text.detach().requires_grad_(adv.free_text)
        d_i = d_img.detach().requires_grad_(adv.free_img)
        with batch_reduction(state.mesh):
            loss = loss_fn(d_t, d_i)
        loss.backward()
        mean = mean + loss.detach().float() / k_steps
        with torch.no_grad(), torch.profiler.record_function(ASCENT_SPAN):
            if adv.free_text:
                d_text = _ascend(d_t, d_t.grad, adv.adv_lr,
                                 adv.adv_max_norm, adv.norm_type)
            if adv.free_img:
                d_img = _ascend(d_i, d_i.grad.float(), adv.adv_lr,
                                adv.adv_max_norm,
                                adv.norm_type).to(d_i.dtype)
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(k_steps)
    return mean


def _rewinder(generator: Optional[Generators]) -> Optional[Callable]:
    """A function that puts both generators back to their present state
    (None without generators)."""
    if generator is None:
        return None
    states = (generator.device.get_state(), generator.host.get_state())

    def rewind():
        generator.device.set_state(states[0])
        generator.host.set_state(states[1])

    return rewind


def make_freelb_itm_step(model: M3PModel, sample_n: int, adv: FreeLBConfig,
                         refine_image: bool = True) -> Callable:
    """FreeLB around the retrieval fine-tune loss (the reference
    `free_lb_t2i/i2t_step`; `m3p_tpu/train/freelb.py:71-139`):
    deterministic, the deltas on the word embeddings (taken once, outside
    the differentiated passes, so the word table gets no gradient through
    the text) and on the region features in their dtype.  Metrics: the mean
    loss and the global norm of the accumulated gradients.  ``**lam`` is
    accepted and unused, as the JAX trainer drops it."""

    def step(state: TrainState, batch: Batch,
             generator: Optional[Generators],
             deltas: Optional[Deltas] = None, **lam
             ) -> Tuple[TrainState, Metrics]:
        batch = expand_compact_batch(batch)
        tokens = batch["tokens"].long()
        feats = batch["feats"]
        text_mask = lengths_to_mask(batch["text_len"], tokens.shape[1])
        img_mask = lengths_to_mask(batch["img_len"], feats.shape[1])
        embeds0 = model.embed_tokens(tokens).detach()

        def loss_fn(d_t, d_i):
            token_embeds = embeds0 + d_t if adv.free_text else embeds0
            f = feats + d_i if adv.free_img else feats
            hidden = model.encode_joint(tokens, text_mask, f, batch["locs"],
                                        img_mask, refine_image, True, None,
                                        token_embeds)
            ce, bce = itm_grid_losses(model.itm_score(hidden),
                                      batch["pos_label"], sample_n)
            return ce + bce

        d_text, d_img = _initial_deltas(generator, deltas, adv,
                                        embeds0.shape, batch["text_len"],
                                        model.cfg.emb_dim, feats)
        mean = _free_passes(state, adv, loss_fn, d_text,
                            d_img.to(feats.dtype))
        metrics = state.sync_gradients({"loss": mean})
        metrics["grad_norm"] = state.grad_norm()
        return state.apply_gradients(), metrics

    return step


def make_freelb_pretrain_step(model: M3PModel, sample_n: int, mask_cfg,
                              adv: FreeLBConfig,
                              refine_image: bool = True) -> Callable:
    """FreeLB around the MCT pre-training loss (the reference
    `freelb_pretrain_under_step`; `m3p_tpu/train/freelb.py:142-208`): the
    deltas on the masked tokens' embeddings and the masked region
    features, dropout as the model is built.  Every pass rewinds
    ``generator`` to one state, so the coin, the maskings and every
    dropout mask repeat across the K passes.  ``**lam`` goes to
    `mct_pretrain_loss` (the lambdas, default 1.0, and any other of its
    arguments).  Metrics: the mean loss."""

    def step(state: TrainState, batch: Batch,
             generator: Optional[Generators],
             deltas: Optional[Deltas] = None, **lam
             ) -> Tuple[TrainState, Metrics]:
        batch = expand_compact_batch(batch)
        tokens = batch["tokens"]
        feats = batch["feats"]
        dim = model.cfg.emb_dim
        loss_kw = dict(lambda_rel=1.0, lambda_mlm=1.0, lambda_mrm=1.0,
                       lambda_mrfr=1.0, lambda_clcm=1.0)
        loss_kw.update(lam)

        def loss_fn(d_t, d_i):
            loss, _ = mct_pretrain_loss(
                model, batch, generator, mask_cfg, sample_n,
                refine_image=refine_image,
                text_delta=d_t if adv.free_text else None,
                img_delta=d_i if adv.free_img else None, **loss_kw)
            return loss

        d_text, d_img = _initial_deltas(generator, deltas, adv,
                                        (*tokens.shape, dim),
                                        batch["text_len"], dim, feats)
        mean = _free_passes(state, adv, loss_fn, d_text, d_img,
                            _rewinder(generator))
        metrics = state.sync_gradients({"loss": mean})
        return state.apply_gradients(), metrics

    return step


def make_freelb_ic_step(model: M3PModel, adv: FreeLBConfig,
                        refine_image: bool = True,
                        refine_encoder: bool = False) -> Callable:
    """FreeLB around the captioning loss (the reference `free_lb_ic_step`;
    `m3p_tpu/train/freelb.py:211-290`): deterministic; the image delta on
    the raw region features (encoder side), the text delta on the decoder
    input's word embeddings (sized by max(tgt_len - 1, 1)), the decoder
    without language ids.  Metrics: the mean loss.  ``**lam`` is accepted
    and unused, as in the JAX step."""

    def step(state: TrainState, batch: Batch,
             generator: Optional[Generators],
             deltas: Optional[Deltas] = None, **lam
             ) -> Tuple[TrainState, Metrics]:
        batch = expand_compact_batch(batch)
        tokens = batch["tokens"].long()
        feats = batch["feats"]
        x_toks, y = tokens[:, :-1], tokens[:, 1:]
        tgt_mask = lengths_to_mask(batch["tgt_len"], tokens.shape[1])
        y_mask = tgt_mask[:, 1:].float()
        x_mask = tgt_mask[:, :-1]
        img_mask = lengths_to_mask(batch["img_len"], feats.shape[1])

        def loss_fn(d_t, d_i):
            f = feats + d_i.to(feats.dtype) if adv.free_img else feats
            src_enc = model.encode_image(f, batch["locs"], img_mask,
                                         refine_image, True, None,
                                         refine_encoder)
            token_embeds = (model.embed_tokens(x_toks) + d_t
                            if adv.free_text else None)
            dec = model.encode_text(x_toks, x_mask, None, None, True, None,
                                    causal=True, src_enc=src_enc,
                                    src_mask=img_mask,
                                    token_embeds=token_embeds)
            loss, _, _ = _next_token_ce(model.shard_word_logits(dec), y,
                                        y_mask, model.vocab_shard)
            return loss

        d_text, d_img = _initial_deltas(
            generator, deltas, adv, (*x_toks.shape, model.cfg.emb_dim),
            (batch["tgt_len"] - 1).clamp_min(1), model.cfg.emb_dim, feats)
        mean = _free_passes(state, adv, loss_fn, d_text, d_img)
        metrics = state.sync_gradients({"loss": mean})
        return state.apply_gradients(), metrics

    return step
