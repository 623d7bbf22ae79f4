"""Inference serving of the PyTorch port: `engine.InferenceEngine` (ITM
scoring, retrieval, captioning and translation on the device),
`batcher.MicroBatcher` (request coalescing) and `server` (JSON over
HTTP)."""

from m3p_tpu_torch.serve.batcher import MicroBatcher
from m3p_tpu_torch.serve.engine import InferenceEngine

__all__ = ["InferenceEngine", "MicroBatcher"]
