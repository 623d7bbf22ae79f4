"""Evaluation of the port (counterpart of `m3p_tpu/eval/`)."""

from m3p_tpu_torch.eval.retrieval import retrieval_grid_scores, recall_at_k
from m3p_tpu_torch.eval.bleu import corpus_bleu
from m3p_tpu_torch.eval.cider import cider_score
