"""Model construction (counterpart of `m3p_tpu/model/__init__.py`), and the
frozen-weight int8 tables of inference (`capture_q8`,
`quantized_inference_model`).  `shared_variant` builds a model of another
configuration over the same parameters."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Union

import torch
from torch import nn

from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model.embeddings import (
    Embedding, SinusoidalPositions, sinusoidal_table)
from m3p_tpu_torch.model.heads import PredLayer
from m3p_tpu_torch.model.layers import Dense, LayerNorm, MoEFFN
from m3p_tpu_torch.model.misc import CrossAlignMatrix
from m3p_tpu_torch.model.transformer import (
    M3PModel, lengths_to_mask, torch_dtype)
from m3p_tpu_torch.ops.quant import Q8Table
from m3p_tpu_torch.parallel.sharding import parallelize
from m3p_tpu_torch.parallel.tensor_parallel import materialize, shard_of

__all__ = ["M3PModel", "build_model", "capture_q8", "lengths_to_mask",
           "q8_collection", "quantized_inference_model", "resolve_device",
           "shared_variant"]

# flax lecun_normal: a normal truncated at +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    another device; asking for CUDA on a machine without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; pass "
            "device='cpu' to run on the CPU")
    return dev


def _lecun_normal_(weight: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initializers, drawn from ``generator`` in module
    order: lecun-normal Dense kernels and raw kernels (fan-in: every
    dimension but the last, as flax counts it), zero biases, N(0,
    dim^-0.5) embeddings, unit LayerNorm scales; the fixed sinusoidal
    table is filled in again."""
    for module in model.modules():
        if isinstance(module, Dense):
            _lecun_normal_(module.weight, module.in_features, generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, MoEFFN):
            for w in (module.router, module.w1, module.w2):
                _lecun_normal_(w, w.numel() // w.shape[-1], generator)
            module.b1.zero_()
            module.b2.zero_()
        elif isinstance(module, CrossAlignMatrix):
            _lecun_normal_(module.cq_weight, module.cq_weight.shape[0],
                           generator)
        elif isinstance(module, Embedding):
            module.weight.normal_(0.0, module.embedding_dim ** -0.5,
                                  generator=generator)
        elif isinstance(module, SinusoidalPositions):
            module.table.copy_(sinusoidal_table(*module.table.shape))
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, PredLayer):
            module.bias.zero_()
            if hasattr(module, "weight"):
                _lecun_normal_(module.weight, module.weight.shape[1],
                               generator)


def build_model(cfg: ModelConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> M3PModel:
    """Create the model on ``device`` with random weights drawn from
    ``seed``.  Raises NotImplementedError for features the port lacks
    (`model.transformer.check_supported`)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = M3PModel(cfg)
    model = model.to_empty(device=dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    init_parameters(model, generator)
    return model.eval()


@torch.no_grad()
def capture_q8(model: M3PModel) -> int:
    """Quantize the weights of every GEMM the ``int8_infer`` modes route
    through int8 into the modules' tables, from the weights as they are
    now; returns the tables' bytes.  Under ``ffn_quant="int8_infer"`` every
    block's fused self-attention Q/K/V, its self- and cross-attention
    output projections and both FFN GEMMs (an MoE block's experts stay
    float, as in JAX); under ``head_quant="int8_infer"`` the tied vocab
    table (none under ``asm``, whose head is the adaptive softmax).  The
    refiner stays unquantized.
    These are the tables the JAX `capture_q8` pass writes into its "q8"
    collection (`q8_collection` names them so); the port quantizes the
    weights directly instead of running a dummy pass.  Call it again after
    the weights change.  Over sharded parameters (`parallel.sharding`)
    every rank takes part: each table holds this rank's ``tensor`` slice of
    its weight, gathered over ``fsdp``, with the whole weight's scales
    (`ops.quant.Q8Table`), as GSPMD quantizes the JAX tables."""
    cfg = model.cfg
    dt = torch_dtype(cfg.dtype)
    if cfg.ffn_quant == "int8_infer":
        for block in model.blocks:
            block.attn.capture_q8(dt, self_attention=True)
            block.encoder_attn.capture_q8(dt, self_attention=False)
            if block.ffn is not None:
                block.ffn.capture_q8(dt)
    if cfg.head_quant == "int8_infer" and not cfg.asm:
        head = model.pred_layer
        keep = ("tensor",) if head.vocab is not None else ()
        head.capture_q8(model.text_emb.word.table(dt) if cfg.share_inout_emb
                        else materialize(head.weight, dt, keep))
    return sum(t.wq.nbytes + t.sw.nbytes for t in model.modules()
               if isinstance(t, Q8Table))


def shared_variant(model: M3PModel, **changes) -> M3PModel:
    """A model of ``model``'s configuration with ``changes`` (fields of
    `ModelConfig` that keep the parameter tree, such as ``ffn_quant``)
    that shares ``model``'s parameters and buffers, so it follows every
    update of them; the parameters come in the same order.  Over sharded
    parameters its modules compute in the same parallel modes
    (`parallel.sharding.parallelize`)."""
    with torch.device("meta"):
        variant = M3PModel(dataclasses.replace(model.cfg, **changes))
    source = dict(model.named_modules())
    for name, module in variant.named_modules():
        module._parameters.update(source[name]._parameters)
        module._buffers.update(source[name]._buffers)
    spec = next((shard_of(p) for p in model.parameters()
                 if shard_of(p) is not None), None)
    if spec is not None:
        parallelize(variant, spec.mesh)
    return variant.train(model.training)


def quantized_inference_model(model: M3PModel) -> M3PModel:
    """The ``int8_infer`` variant of ``model`` (`m3p_tpu/model/__init__.py:
    89-100`): the same configuration with ``ffn_quant`` at "int8_infer"
    and ``head_quant`` too unless ``asm`` (which keeps its own), sharing
    ``model``'s parameters and buffers (`shared_variant`) and holding its
    own int8 tables, none until `capture_q8`."""
    head = model.cfg.head_quant if model.cfg.asm else "int8_infer"
    return shared_variant(model, ffn_quant="int8_infer", head_quant=head)


def q8_collection(model: M3PModel) -> Dict[str, torch.Tensor]:
    """The model's int8 tables under the names and in the layouts of the
    JAX "q8" collection, flattened with "/": ``block_<i>/attn/qkv_wq``
    (D, 3D) and ``qkv_sw`` (1, 3D), ``block_<i>/attn/out_wq``,
    ``block_<i>/encoder_attn/out_wq``, ``block_<i>/ffn/lin1/wq`` and ``sw``,
    ``pred_layer/emb_wq`` (V, D) and ``emb_sw`` (V, 1)."""
    out: Dict[str, torch.Tensor] = {}
    for i, block in enumerate(model.blocks):
        for attn_name in ("attn", "encoder_attn"):
            attn = getattr(block, attn_name)
            for kind in ("qkv", "out"):
                table = getattr(attn, f"q8_{kind}")
                if table is not None:
                    wq, sw = table.jax_layout()
                    out[f"block_{i}/{attn_name}/{kind}_wq"] = wq
                    out[f"block_{i}/{attn_name}/{kind}_sw"] = sw
        for lin in ("lin1", "lin2") if block.ffn is not None else ():
            table = getattr(block.ffn, f"q8_{lin}")
            if table is not None:
                wq, sw = table.jax_layout()
                out[f"block_{i}/ffn/{lin}/wq"] = wq
                out[f"block_{i}/ffn/{lin}/sw"] = sw
    table = None if model.cfg.asm else model.pred_layer.q8_emb
    if table is not None:
        out["pred_layer/emb_wq"] = table.wq[:table.n]
        out["pred_layer/emb_sw"] = table.sw[:, :table.n].t()
    return out
