"""Evaluation orchestration of the port (counterpart of
`m3p_tpu/eval/evaluator.py`, the reference `XEvaluator.run_all_evals`,
`xevaluator.py:120-281`).

Per task family:
  * text/caption/MT ppl + next-token accuracy on validation batches (the
    training losses of `train/steps.py` with ``deterministic=True``, their
    masks drawn from generators seeded with the fixed ``EVAL_SEED``, fresh
    for each family call, so two calls mask alike);
  * retrieval: sample-grid accuracy on valid, full-grid R@1/5/10 + mean
    recall on test (`eval/retrieval.py`);
  * captioning / MT / NTG: beam or greedy decoding (`model/generation.py`)
    -> detokenize -> BLEU / CIDEr / METEOR / ROUGE-L;
  * slide: binary accuracy.

The model holds its weights, so no method takes parameters.  Batches
arrive as dicts of numpy arrays and move to the model's device; every
method runs under ``torch.inference_mode()``, and a family's numbers come
to the host once, after its last batch.

With ``cfg.eval.quant == "int8"`` the generation families encode and
decode through a frozen-weight int8 copy of the model that shares its
parameters (`model.quantized_inference_model`); its tables are captured
again whenever a parameter changed since the last capture (each
parameter's in-place version counter), so evals between training epochs
see the current weights.  The loss and grid families stay exact
(`m3p_tpu/eval/evaluator.py:44-65`).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from m3p_tpu_torch.data.masking import MaskingConfig
from m3p_tpu_torch.eval.bleu import corpus_bleu
from m3p_tpu_torch.eval.caption_metrics import meteor_score, rouge_l_score
from m3p_tpu_torch.eval.cider import cider_score
from m3p_tpu_torch.eval.retrieval import (
    merge_process_scores, recall_at_k, retrieval_grid_scores)
from m3p_tpu_torch.model import capture_q8, quantized_inference_model
from m3p_tpu_torch.model.generation import beam_search, greedy_generate
from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.model.transformer import M3PModel, lengths_to_mask
from m3p_tpu_torch.train import steps as S

logger = logging.getLogger("m3p_tpu_torch")

EVAL_SEED = 0  # fixed eval RNG (reference `np.random.RandomState(0)`)


def _rank_world() -> Tuple[int, int]:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _grid_split(model) -> Tuple[int, int, object]:
    """(index, count, group) of the retrieval grid's chunks: every rank its
    own share; over a sharded model (`parallel.sharding`) the ranks of one
    ``data`` coordinate score the same chunks together (their forwards
    gather from one another), so the chunks split over ``data`` and the
    partial matrices sum over it."""
    from m3p_tpu_torch.parallel.mesh import current_mesh
    from m3p_tpu_torch.parallel.sharding import model_is_sharded

    mesh = current_mesh()
    if mesh is not None and model_is_sharded(model):
        return mesh.index("data"), mesh.shape["data"], mesh.group("data")
    rank, world = _rank_world()
    return rank, world, None


def _host(values: List[torch.Tensor]) -> List[float]:
    """Scalars of a family, brought to the host in one copy."""
    if not values:
        return []
    return torch.stack([v.float() for v in values]).cpu().tolist()


def _ppl(mean: float) -> float:
    return float(np.exp(min(mean, 30.0)))


def _mean(values: List[float]) -> float:
    return float(np.mean(values)) if values else float("nan")


def _pct(values: List[float]) -> float:
    return 100.0 * float(np.mean(values)) if values else 0.0


class Evaluator:
    def __init__(self, model: M3PModel, cfg,
                 mask_cfg: Optional[MaskingConfig] = None):
        quant = getattr(getattr(cfg, "eval", None), "quant", "none")
        if quant not in ("none", "int8"):
            raise ValueError(f"unknown eval quant mode {quant!r}; known: "
                             f"'none', 'int8'")
        self.model = model
        self.gen_model = (quantized_inference_model(model) if quant == "int8"
                          else model)
        self._q8_versions: Optional[tuple] = None
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.mask_cfg = mask_cfg or MaskingConfig(
            n_words=cfg.model.n_words, mask_index=cfg.model.mask_index,
            max_pred=cfg.data.max_pred_per_seq)

    def _generators(self) -> Generators:
        """Fresh generators of the fixed eval seed on the model's device."""
        return Generators.from_seed(EVAL_SEED, self.device)

    def _batch(self, b: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A numpy batch on the model's device, integer arrays as int64."""
        out = {}
        for k, v in b.items():
            a = np.asarray(v)
            if np.issubdtype(a.dtype, np.integer):
                a = a.astype(np.int64)
            out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(
                self.device)
        return out

    def _refine_image(self) -> bool:
        return getattr(self.cfg, "refine_image", True)

    def _generation_model(self) -> M3PModel:
        """The model the generation families run: the int8 copy under
        ``eval.quant="int8"``, its tables captured again if a parameter
        changed since the last capture."""
        if self.gen_model is self.model:
            return self.model
        versions = tuple(p._version for p in self.model.parameters())
        if versions != self._q8_versions:
            capture_q8(self.gen_model)
            self._q8_versions = versions
        return self.gen_model

    def _decode(self, model: M3PModel, src_enc: torch.Tensor,
                src_mask: torch.Tensor, beam_size: int, max_len: int,
                tgt_lang_id: Optional[int]):
        """(tokens, lengths) on the host: beam search above beam 1, greedy
        at 1, with the `EvalConfig` settings."""
        ev = self.cfg.eval
        if beam_size > 1:
            toks, lens = beam_search(
                model, src_enc, src_mask, beam_size, max_len,
                tgt_lang_id=tgt_lang_id, length_penalty=ev.length_penalty,
                early_stopping=ev.early_stopping,
                fast_topk=bool(getattr(ev, "fast_beam", False)))
        else:
            toks, lens = greedy_generate(model, src_enc, src_mask,
                                         max_len, tgt_lang_id=tgt_lang_id)
        return toks.cpu().numpy(), lens.cpu().numpy()

    # -- validation perplexities / accuracies ---------------------------

    @torch.inference_mode()
    def evaluate_mlm(self, batches: Iterable[Dict]) -> Dict[str, float]:
        gens = self._generators()
        losses = [S.mlm_loss(self.model, self._batch(b), gens, self.mask_cfg,
                             deterministic=True)[0] for b in batches]
        mean = _mean(_host(losses))
        return {"mlm_ppl": _ppl(mean), "mlm_loss": mean}

    @torch.inference_mode()
    def evaluate_clm(self, batches: Iterable[Dict]) -> Dict[str, float]:
        gens = self._generators()
        losses = [S.clm_loss(self.model, self._batch(b), gens,
                             deterministic=True)[0] for b in batches]
        mean = _mean(_host(losses))
        return {"clm_ppl": _ppl(mean), "clm_loss": mean}

    @torch.inference_mode()
    def evaluate_mass(self, batches: Iterable[Dict]) -> Dict[str, float]:
        gens = self._generators()
        losses = [S.mass_loss(self.model, self._batch(b), gens,
                              deterministic=True)[0] for b in batches]
        return {"mass_ppl": _ppl(_mean(_host(losses)))}

    @torch.inference_mode()
    def evaluate_seq2seq(self, batches: Iterable[Dict],
                         multimodal: bool = False, name: str = "mt"
                         ) -> Dict[str, float]:
        gens = self._generators()
        losses, accs = [], []
        for b in batches:
            b = self._batch(b)
            if multimodal:
                loss, m = S.mt_caption_loss(self.model, b, gens,
                                            refine_image=self._refine_image(),
                                            deterministic=True)
            else:
                loss, m = S.mt_loss(self.model, b, gens, deterministic=True)
            losses.append(loss)
            accs.append(m["acc"])
        return {f"{name}_ppl": _ppl(_mean(_host(losses))),
                f"{name}_acc": _pct(_host(accs))}

    @torch.inference_mode()
    def evaluate_caption_loss(self, batches: Iterable[Dict]
                              ) -> Dict[str, float]:
        gens = self._generators()
        losses, accs = [], []
        for b in batches:
            loss, m = S.caption_loss(self.model, self._batch(b), gens,
                                     deterministic=True)
            losses.append(loss)
            accs.append(m["acc"])
        return {"ic_ppl": _ppl(_mean(_host(losses))),
                "ic_acc": _pct(_host(accs))}

    # -- retrieval ------------------------------------------------------

    @torch.inference_mode()
    def evaluate_retrieval_valid(self, batches: Iterable
                                 ) -> Dict[str, float]:
        """Sample-grid accuracy (valid split, `evaluate_t2i/i2t`).

        ``batches``: (t2i, i2t) tuples — per-direction accs are reported as
        ``T2I_acc``/``I2T_acc`` (the reference recipes track
        ``valid_T2I_acc``/``valid_I2T_acc``) — or plain batch dicts, which
        only feed the combined ``retrieval_acc``."""
        gens = self._generators()
        directions: List[Optional[str]] = []
        accs: List[torch.Tensor] = []

        def one(b):
            b = S.expand_compact_batch(self._batch(b))
            return S.itm_finetune_loss(self.model, b, gens,
                                       self.cfg.data.sample_n,
                                       deterministic=True)[1]["acc"]

        for item in batches:
            if isinstance(item, (tuple, list)) and len(item) == 2:
                for direction, b in zip(("T2I", "I2T"), item):
                    accs.append(one(b))
                    directions.append(direction)
            else:
                accs.append(one(item))
                directions.append(None)
        values = _host(accs)
        out = {"retrieval_acc": _pct(values)}
        for d in ("T2I", "I2T"):
            vals = [v for v, dd in zip(values, directions) if dd == d]
            if vals:
                out[f"{d}_acc"] = _pct(vals)
        return out

    def evaluate_retrieval_test(self, cap_tokens, cap_len, cap_to_img,
                                img_feats, img_locs, img_len,
                                chunk_size: int = 512,
                                prefix: str = "") -> Dict[str, float]:
        rank, _ = _rank_world()
        index, count, group = _grid_split(self.model)
        # each rank scores every count-th chunk; the partials sum to the
        # whole matrix, from which alone the metrics come
        part = retrieval_grid_scores(
            self.model, cap_tokens, cap_len, img_feats, img_locs, img_len,
            chunk_size=chunk_size, refine_image=self._refine_image(),
            process_index=index, process_count=count)
        scores = (merge_process_scores(part, group) if count > 1
                  else part)
        r = recall_at_k(scores, cap_to_img)
        eval_path = getattr(self.cfg.eval, "eval_path", "")
        if eval_path:
            # reference eval artifacts (`xevaluator.py:258-259,1616-1619`):
            # each rank's image x caption score matrix (its partial one over
            # several ranks) and, from rank 0, an R@k append log
            os.makedirs(eval_path, exist_ok=True)
            np.save(os.path.join(
                eval_path, f"score_{prefix or 'test'}_rank{rank}.npy"),
                np.asarray(part))
        if eval_path and rank == 0:
            with open(os.path.join(eval_path, "inference.log"), "a") as f:
                f.write(" ".join(str(r[k]) for k in
                                 ("i2t_r1", "i2t_r5", "i2t_r10")) + "\n")
        return {f"{prefix}{k}": v for k, v in r.items()}

    # -- generation -----------------------------------------------------

    @torch.inference_mode()
    def generate_captions(self, batches: Iterable[Dict], tokenizer,
                          tgt_lang_id: Optional[int] = None,
                          beam_size: Optional[int] = None,
                          max_len: Optional[int] = None) -> List[str]:
        beam_size = beam_size or self.cfg.eval.beam_size
        max_len = max_len or self.cfg.eval.max_gen_len
        hyps: List[str] = []
        model = self._generation_model()
        for b in batches:
            b = self._batch(b)
            feats = b["feats"]
            img_mask = lengths_to_mask(b["img_len"], feats.shape[1])
            # the reference eval honors params.refine_image but never
            # applies refine_encoder (`xevaluator.py:845-1044` — a
            # train/eval asymmetry mirrored deliberately)
            src_enc = model.encode_image(feats, b["locs"], img_mask,
                                         self._refine_image())
            toks, lens = self._decode(model, src_enc, img_mask, beam_size,
                                      max_len, tgt_lang_id)
            for i in range(toks.shape[0]):
                hyps.append(tokenizer.decode(toks[i, 1:lens[i]]))
        return hyps

    @torch.inference_mode()
    def generate_translations(self, batches: Iterable[Dict], tokenizer,
                              tgt_lang_id: Optional[int] = None,
                              beam_size: Optional[int] = None,
                              max_len: Optional[int] = None) -> List[str]:
        """Seq2seq generation for MT / NTG eval (`evaluate_mt` /
        `evaluate_ntg_generate`, `xevaluator.py:1178-1260`)."""
        beam_size = beam_size or self.cfg.eval.beam_size
        max_len = max_len or self.cfg.eval.max_gen_len
        hyps: List[str] = []
        model = self._generation_model()
        for b in batches:
            b = self._batch(b)
            src = b["src_tokens"]
            src_mask = lengths_to_mask(b["src_len"], src.shape[1])
            if "feats" in b:
                # multimodal MT: decode against the joint [img; text]
                # encoding (`mt_ic` eval, `xevaluator.py:903-1117`)
                feats = b["feats"]
                img_mask = lengths_to_mask(b["img_len"], feats.shape[1])
                src_enc = model.encode_joint(
                    src, src_mask, feats, b["locs"], img_mask,
                    self._refine_image())
                src_mask = torch.cat([img_mask, src_mask], dim=1)
            else:
                src_enc = model.encode_text(src, src_mask,
                                            b.get("src_langs"))
            toks, lens = self._decode(model, src_enc, src_mask, beam_size,
                                      max_len, tgt_lang_id)
            for i in range(toks.shape[0]):
                hyps.append(tokenizer.decode(toks[i, 1:lens[i]]))
        return hyps

    def evaluate_translation(self, batches: List[Dict],
                             references: List[List[str]], tokenizer,
                             tgt_lang_id: Optional[int] = None,
                             name: str = "mt") -> Dict[str, float]:
        hyps = self.generate_translations(batches, tokenizer, tgt_lang_id)
        n = min(len(hyps), len(references))
        return {f"{name}_bleu": corpus_bleu(hyps[:n], references[:n])}

    def evaluate_captioning(self, batches: List[Dict],
                            references: List[List[str]], tokenizer,
                            tgt_lang_id: Optional[int] = None,
                            image_ids: Optional[List] = None,
                            lang: str = "") -> Dict[str, float]:
        hyps = self.generate_captions(batches, tokenizer, tgt_lang_id)
        n = min(len(hyps), len(references))
        eval_path = getattr(self.cfg.eval, "eval_path", "")
        if eval_path and image_ids is not None:
            # decoded hypotheses as an artifact, mirroring the reference's
            # caption export (`xevaluator.py:986-993`: {image_id, caption}
            # dicts; eval_path is per run, so no epoch prefix), so an
            # all-zero metric can be diagnosed without decoding again
            os.makedirs(eval_path, exist_ok=True)
            out_path = os.path.join(
                eval_path, f"caption_translate.{lang or 'xx'}.json")
            with open(out_path, "w") as f:
                json.dump([{"image_id": str(i), "caption": h}
                           for i, h in zip(image_ids, hyps[:n])], f)
        # --coco_method selects which caption metrics to report
        # (`xevaluator.py:1010-1016`); names match the COCOEvalCap keys:
        # Bleu, METEOR, ROUGE_L, CIDEr (METEOR is the exact+stem variant of
        # eval/caption_metrics.py).  An unrecognized-only list falls back
        # to the reference default (CIDEr, `train_x.py:337`) rather than
        # silently evaluating nothing.
        supported = {"bleu", "cider", "meteor", "rouge_l"}
        coco_method = getattr(self.cfg.eval, "coco_method", "Bleu,CIDEr")
        methods = {m.strip().lower() for m in coco_method.split(",")
                   if m.strip()}
        if not methods & supported:
            logger.warning(
                "coco_method %r has no in-process metric (supported: "
                "Bleu, METEOR, ROUGE_L, CIDEr) — computing CIDEr",
                coco_method)
            methods = {"cider"}
        scores: Dict[str, float] = {}
        if "bleu" in methods:
            scores["caption_bleu"] = corpus_bleu(hyps[:n], references[:n])
        if "cider" in methods:
            scores["caption_cider"] = cider_score(hyps[:n], references[:n])
        if "meteor" in methods:
            scores["caption_meteor"] = meteor_score(hyps[:n], references[:n])
        if "rouge_l" in methods:
            scores["caption_rouge_l"] = rouge_l_score(hyps[:n],
                                                      references[:n])
        return scores

    # -- slide ----------------------------------------------------------

    @torch.inference_mode()
    def evaluate_slide(self, batches: Iterable[Dict]) -> Dict[str, float]:
        gens = self._generators()
        accs = [S.slide_loss(self.model, self._batch(b), gens,
                             deterministic=True)[1]["acc"] for b in batches]
        return {"slide_acc": _pct(_host(accs))}

    # -- top level ------------------------------------------------------

    def run_all_evals(self, eval_data: Dict[str, Any]) -> Dict[str, float]:
        """Dispatch over whatever eval data is provided.

        eval_data keys (all optional; a ``.<lang>`` suffix prefixes the
        resulting score names with ``<lang>_`` — the per-language loop the
        reference runs over `ft_lgs` in `run_all_evals`,
        `xevaluator.py:120-281`):
          mlm_batches, clm_batches, mass_batches, mt_batches, mmt_batches,
          ntg_batches, caption_batches, retrieval_valid_batches,
          retrieval_test (tuple of grid arrays),
          caption_gen / mt_gen / ntg_gen / mmt_gen (dict with batches/
          references/tokenizer/lang_id; mmt batches carry feats and decode
          against the joint encoding), slide_batches
        """
        scores: Dict[str, float] = {}
        for key in sorted(eval_data.keys()):
            base, _, suffix = key.partition(".")
            prefix = f"{suffix}_" if suffix else ""
            data = eval_data[key]
            got: Dict[str, float] = {}
            if base == "mlm_batches":
                got = self.evaluate_mlm(data)
            elif base == "clm_batches":
                got = self.evaluate_clm(data)
            elif base == "mass_batches":
                got = self.evaluate_mass(data)
            elif base == "mt_batches":
                got = self.evaluate_seq2seq(data)
            elif base == "ntg_batches":
                got = self.evaluate_seq2seq(data, name="ntg")
            elif base == "mmt_batches":
                got = self.evaluate_seq2seq(data, multimodal=True,
                                            name="mmt")
            elif base == "caption_batches":
                got = self.evaluate_caption_loss(data)
            elif base == "retrieval_valid_batches":
                got = self.evaluate_retrieval_valid(data)
            elif base == "retrieval_test":
                got = self.evaluate_retrieval_test(*data)
            elif base == "caption_gen":
                got = self.evaluate_captioning(
                    data["batches"], data["references"], data["tokenizer"],
                    data.get("lang_id"), image_ids=data.get("image_ids"),
                    lang=suffix)
            elif base in ("mt_gen", "ntg_gen", "mmt_gen"):
                got = self.evaluate_translation(
                    data["batches"], data["references"], data["tokenizer"],
                    data.get("lang_id"), data.get("name", "mt"))
            elif base == "slide_batches":
                got = self.evaluate_slide(data)
            else:
                logger.warning("unknown eval family: %s", key)
            scores.update({f"{prefix}{k}": v for k, v in got.items()})
        logger.info("__log__:%s", scores)
        return scores
