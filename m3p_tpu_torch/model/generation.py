"""Autoregressive generation of the port: greedy (or sampled) decoding and
beam search (counterpart of `m3p_tpu/model/generation.py`).

The JAX `lax.scan` over a functional KV cache becomes a Python loop over a
`DecodeCache` that every step updates in place; the loop runs exactly
``max_len - 1`` steps, as the scan does (an early exit once every row is
finished would read a flag from the device every step).  Beam search is
the JAX package's exact two-stage top-2K with length-penalised finished
pools and early stopping, step for step and in the same fp32 order.

Conventions of the JAX package, kept:
  * decoding starts from ``start_index``, BOS by default (the training
    targets' first token; EOS_IDX gives the reference's start);
  * a sequence ends at its first generated EOS; finished rows go on
    decoding and emit PAD; its length is the EOS position + 2, capped at
    ``max_len``;
  * a finished hypothesis scores sum-logp / len^alpha, len counting the
    generated tokens with the final EOS.

Every top-k is `ops.topk.top_k`, which orders ties as `jax.lax.top_k`
does.  The self caches of surviving beams are gathered with
`index_select`; the source encoding and the cross caches stay
unreplicated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from m3p_tpu_torch.config import BOS_IDX, EOS_IDX, PAD_IDX
from m3p_tpu_torch.model.transformer import DecodeCache, M3PModel
from m3p_tpu_torch.ops.topk import top_k

NEG_INF = -1.0e7


def _decode_step(model: M3PModel, tokens: torch.Tensor,
                 positions: torch.Tensor, langs: Optional[torch.Tensor],
                 src_enc: torch.Tensor, src_mask: torch.Tensor,
                 cache: DecodeCache) -> torch.Tensor:
    """One incremental decoder step: tokens (B, 1) at ``positions`` (B, 1)
    -> fp32 logits (B, n_words); ``cache`` advances by one position."""
    step_mask = torch.ones(tokens.shape, dtype=torch.bool,
                           device=tokens.device)
    hidden = model.encode_text(tokens, step_mask, langs, positions,
                               causal=True, src_enc=src_enc,
                               src_mask=src_mask, cache=cache)
    return model.word_logits(hidden[:, 0]).float()


def _step_inputs(rows: int, t: int, tgt_lang_id: Optional[int], device
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    positions = torch.full((rows, 1), t, dtype=torch.long, device=device)
    langs = (None if tgt_lang_id is None
             else torch.full((rows, 1), tgt_lang_id, dtype=torch.long,
                             device=device))
    return positions, langs


@torch.inference_mode()
def greedy_generate(model: M3PModel, src_enc: torch.Tensor,
                    src_mask: torch.Tensor, max_len: int,
                    tgt_lang_id: Optional[int] = None,
                    temperature: Optional[float] = None,
                    generator: Optional[torch.Generator] = None,
                    eos_index: int = EOS_IDX, pad_index: int = PAD_IDX,
                    start_index: int = BOS_IDX
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decoding over ``src_enc`` (B, Ss, D) with its mask
    (`m3p_tpu/model/generation.py:56-109`) -> (tokens (B, max_len), lengths
    (B,)), tokens[:, 0] == ``start_index``.

    With ``temperature`` each token is drawn from softmax(logits /
    temperature) by the Gumbel-max rule (`jax.random.categorical`'s), the
    noise from ``generator`` (on the model's device; a fresh seed-0
    generator if None).  The draws cannot match JAX's bit for bit."""
    b, dev = src_enc.shape[0], src_enc.device
    cache = model.init_decode_cache(src_enc, max_len)
    if temperature is not None and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.full((b, 1), start_index, dtype=torch.long, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    out = [tokens]
    for t in range(max_len - 1):
        positions, langs = _step_inputs(b, t, tgt_lang_id, dev)
        logits = _decode_step(model, tokens, positions, langs, src_enc,
                              src_mask, cache)
        if temperature is not None:
            u = torch.rand(logits.shape, generator=generator, device=dev)
            u = u.clamp_min(torch.finfo(torch.float32).tiny)
            nxt = torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                               dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, pad_index, nxt)
        finished = finished | (nxt == eos_index)
        tokens = nxt[:, None]
        out.append(tokens)
    out = torch.cat(out, dim=1)
    # the first generated EOS + 2 (the start token and the EOS itself),
    # max_len for a row without one
    is_eos = out[:, 1:] == eos_index
    first_eos = torch.argmax(is_eos.to(torch.uint8), dim=1)
    lengths = torch.where(is_eos.any(dim=1), first_eos + 2, max_len)
    return out, lengths


def _beam_rows(beam_idx: torch.Tensor, old_beams: int) -> torch.Tensor:
    """beam_idx (B, N) of beams within a row -> (B * N,) flat rows."""
    base = torch.arange(beam_idx.shape[0], device=beam_idx.device)[:, None]
    return (base * old_beams + beam_idx).reshape(-1)


@torch.inference_mode()
def beam_search(model: M3PModel, src_enc: torch.Tensor,
                src_mask: torch.Tensor, beam_size: int, max_len: int,
                tgt_lang_id: Optional[int] = None,
                length_penalty: float = 1.0, early_stopping: bool = False,
                fast_topk: bool = False, eos_index: int = EOS_IDX,
                pad_index: int = PAD_IDX, start_index: int = BOS_IDX
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over ``src_enc`` (B, Ss, D)
    (`m3p_tpu/model/generation.py:147-312`) -> the best hypothesis of each
    row, (tokens (B, max_len), lengths (B,)).

    Each step: the per-beam top-2K of the raw logits, the fp32 logsumexp,
    the candidates' log-probabilities ``logp + logit - lse``, the merged
    top-2K of a row's K * 2K; EOS candidates enter the row's pool of K
    finished hypotheses scored logp / len^``length_penalty`` (with
    ``early_stopping`` a full pool freezes); the best K others stay alive.
    At ``max_len`` alive beams are finished by force.

    ``fast_topk`` is accepted for the JAX signature and changes nothing:
    `lax.approx_max_k` is a TPU approximation that XLA computes exactly off
    the TPU (the same values and indices as `lax.top_k` on a (40, 250002)
    fp32 input on the CPU), so the port's top-k is exact either way."""
    del fast_topk
    b, dev = src_enc.shape[0], src_enc.device
    k = beam_size
    bk = b * k
    cache = model.init_decode_cache(src_enc, max_len, bk)
    # beam 0 alive, the others at -inf, so that step 1 picks distinct
    # continuations
    logp = torch.tensor([0.0] + [NEG_INF] * (k - 1), device=dev).repeat(b)
    seqs = torch.full((bk, max_len), pad_index, dtype=torch.long, device=dev)
    seqs[:, 0] = start_index
    fin_seqs = torch.full((bk, max_len), pad_index, dtype=torch.long,
                          device=dev)
    fin_scores = torch.full((bk,), NEG_INF, device=dev)
    fin_lens = torch.zeros((bk,), dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    for t in range(max_len - 1):
        positions, langs = _step_inputs(bk, t, tgt_lang_id, dev)
        logits = _decode_step(model, seqs[:, t:t + 1], positions, langs,
                              src_enc, src_mask, cache)
        # within a beam the ranking of log-probabilities is the ranking of
        # the logits; the global top-2K lies in the union of the beams'
        pb_logit, pb_idx = top_k(logits, 2 * k)                 # (BK, 2K)
        lse = torch.logsumexp(logits, dim=-1)                   # (BK,)
        pb_logp = logp[:, None] + pb_logit - lse[:, None]
        top_logp, m_idx = top_k(pb_logp.reshape(b, 2 * k * k), 2 * k)
        beam_idx = torch.div(m_idx, 2 * k, rounding_mode="floor")
        tok_idx = pb_idx.reshape(b, 2 * k * k).gather(1, m_idx)  # (B, 2K)
        is_eos = tok_idx == eos_index

        # ---- the finished pools ----
        gen_len = float(np.float32(t + 1) ** np.float32(length_penalty))
        eos_scores = torch.where(is_eos, top_logp / gen_len, NEG_INF)
        eos_scores = torch.where(done[:, None], NEG_INF, eos_scores)
        eos_seqs = seqs.index_select(0, _beam_rows(beam_idx, k)).reshape(
            b, 2 * k, max_len)
        eos_seqs[:, :, t + 1] = torch.where(is_eos, eos_index, pad_index)
        merged_scores = torch.cat([fin_scores.reshape(b, k), eos_scores], 1)
        merged_seqs = torch.cat([fin_seqs.reshape(b, k, max_len), eos_seqs],
                                1)
        merged_lens = torch.cat(
            [fin_lens.reshape(b, k),
             torch.full((b, 2 * k), t + 2, dtype=torch.long, device=dev)], 1)
        best_scores, best_i = top_k(merged_scores, k)           # (B, K)
        fin_seqs = merged_seqs.gather(
            1, best_i[:, :, None].expand(-1, -1, max_len)).reshape(
            bk, max_len)
        fin_scores = best_scores.reshape(bk)
        fin_lens = merged_lens.gather(1, best_i).reshape(bk)
        if early_stopping:
            done = done | (best_scores > NEG_INF / 2).all(dim=1)

        # ---- the alive beams: the best K non-EOS of the 2K ----
        alive_scores, alive_i = top_k(
            torch.where(is_eos, NEG_INF, top_logp), k)          # (B, K)
        rows = _beam_rows(beam_idx.gather(1, alive_i), k)
        seqs = seqs.index_select(0, rows)
        seqs[:, t + 1] = tok_idx.gather(1, alive_i).reshape(bk)
        cache.select(rows)
        logp = alive_scores.reshape(bk)

    # force-finish the alive beams at max_len; a row finished early keeps
    # its pool only
    alive = logp / float(max_len) ** length_penalty
    alive = torch.where(done.repeat_interleave(k), NEG_INF, alive)
    all_scores = torch.cat([fin_scores.reshape(b, k), alive.reshape(b, k)],
                           1)
    all_seqs = torch.cat([fin_seqs.reshape(b, k, max_len),
                          seqs.reshape(b, k, max_len)], 1)
    all_lens = torch.cat([fin_lens.reshape(b, k),
                          torch.full((b, k), max_len, dtype=torch.long,
                                     device=dev)], 1)
    best = torch.argmax(all_scores, dim=1)
    row = torch.arange(b, device=dev)
    return all_seqs[row, best], all_lens[row, best]
