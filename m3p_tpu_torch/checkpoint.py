"""The weights bridge of the port (counterpart of `m3p_tpu/checkpoint.py`).

* `params_from_jax` — a JAX parameter tree (nested dicts of numpy arrays)
  to the port's ``state_dict``: ``kernel`` -> ``weight`` transposed,
  ``ln/scale`` / ``ln/bias`` -> ``weight`` / ``bias``, ``embedding`` ->
  ``weight``, ``bias`` -> ``bias``; module paths keep their names.
* `params_to_jax` — the inverse, from a port model.
* `grads_from_jax` — a JAX gradient tree (same structure as the parameter
  tree) to the port's names and layouts, to hold gradients leaf by leaf.
* `load_reference_state_dict` — a reference ``TransformerModel`` state dict
  (the names of `m3p_tpu/checkpoint.py:124-330`) to the port's names.  Both
  sides use torch's layouts, so only the names change.
* `load_weights` — a reference ``.pth`` or a ``.pt`` saved by the port into
  a model.

Orbax checkpoint directories need JAX to read and wait for a later slice.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

logger = logging.getLogger("m3p_tpu_torch")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> the port's state dict (fp32 CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree):
        arr = np.asarray(value, dtype=np.float32)
        *mods, leaf = path
        if len(mods) >= 1 and mods[-1] == "ln" and leaf in ("scale", "bias"):
            mods = mods[:-1]
            leaf = "weight" if leaf == "scale" else "bias"
        elif leaf == "kernel":
            arr = arr.T
            leaf = "weight"
        elif leaf == "embedding":
            leaf = "weight"
        elif leaf != "bias":
            raise KeyError(f"unknown JAX parameter {'/'.join(path)}")
        sd[".".join(mods + [leaf])] = torch.tensor(arr)
    return sd


def grads_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX gradient tree -> ``{port parameter name: gradient}``, with the
    name and transpose rules of `params_from_jax` (a gradient has its
    parameter's layout)."""
    return params_from_jax(tree)


def params_to_jax(model: nn.Module) -> Dict[str, Any]:
    """The port's parameters -> a JAX parameter tree of numpy arrays."""
    from m3p_tpu_torch.model.embeddings import Embedding
    from m3p_tpu_torch.model.layers import Dense, LayerNorm

    tree: Dict[str, Any] = {}

    def put(path: List[str], t: torch.Tensor) -> None:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.detach().float().cpu().numpy()

    for name, module in model.named_modules():
        path = name.split(".") if name else []
        if isinstance(module, LayerNorm):
            put(path + ["ln", "scale"], module.weight)
            put(path + ["ln", "bias"], module.bias)
        elif isinstance(module, Dense):
            put(path + ["kernel"], module.weight.T)
            if module.bias is not None:
                put(path + ["bias"], module.bias)
        elif isinstance(module, Embedding):
            put(path + ["embedding"], module.weight)
        else:
            for pname, p in module.named_parameters(recurse=False):
                put(path + (["kernel"] if pname == "weight" else [pname]),
                    p.T if pname == "weight" else p)
    return tree


def _reference_names(n_layers: int, refine_layers: int
                     ) -> List[Tuple[str, str]]:
    """(reference module, port module) pairs; each carries ``.weight`` and
    ``.bias`` under both names."""
    pairs = [
        ("embeddings", "text_emb.word"),
        ("position_embeddings", "text_emb.position"),
        ("cross_lang_embeddings", "text_emb.lang"),
        ("layer_norm_emb", "text_emb.ln_emb"),
    ]
    for i in range(n_layers):
        blk = f"block_{i}"
        for lin in ("q_lin", "k_lin", "v_lin", "out_lin"):
            pairs.append((f"attentions.{i}.{lin}", f"{blk}.attn.{lin}"))
            pairs.append((f"encoder_attn.{i}.{lin}",
                          f"{blk}.encoder_attn.{lin}"))
        pairs += [
            (f"layer_norm1.{i}", f"{blk}.ln1"),
            (f"layer_norm15.{i}", f"{blk}.ln15"),
            (f"layer_norm2.{i}", f"{blk}.ln2"),
            (f"ffns.{i}.lin1", f"{blk}.ffn.lin1"),
            (f"ffns.{i}.lin2", f"{blk}.ffn.lin2"),
        ]
    pairs += [
        ("image_embeddings.image_embeddings", "image_emb.img_proj"),
        ("image_embeddings.image_location_embeddings", "image_emb.loc_proj"),
        ("image_embeddings.LayerNorm", "image_emb.ln"),
    ]
    for i in range(refine_layers):
        src, dst = f"refine_embeddings.layers.{i}", f"refiner.layer_{i}"
        pairs += [
            (f"{src}.self_attn.linears.0", f"{dst}.aoa_attn.q_lin"),
            (f"{src}.self_attn.linears.1", f"{dst}.aoa_attn.k_lin"),
            (f"{src}.self_attn.linears.2", f"{dst}.aoa_attn.v_lin"),
            (f"{src}.self_attn.aoa_layer.0", f"{dst}.aoa_attn.aoa"),
            (f"{src}.sublayer.0.norm", f"{dst}.ln_attn"),
            (f"{src}.sublayer.1.norm", f"{dst}.ln_ffn"),
            (f"{src}.feed_forward.lin1", f"{dst}.ffn.lin1"),
            (f"{src}.feed_forward.lin2", f"{dst}.ffn.lin2"),
        ]
    pairs += [
        ("refine_embeddings.norm", "refiner.ln_out"),
        ("pooled_layer.dense", "itm_pooler.dense"),
        ("seq_relationship", "itm_pooler.score"),
        ("pooled_layer2.dense", "clcm_pooler.dense"),
        ("seq_relationship2", "clcm_pooler.score"),
        ("mrfr_dense", "mrfr_head.dense"),
        ("transformer_obj.dense", "obj_pred.transform_dense"),
        ("transformer_obj.LayerNorm", "obj_pred.transform_ln"),
        ("pred_obj_layer.proj", "obj_pred.proj"),
    ]
    return pairs


def load_reference_state_dict(state_dict: Mapping[str, Any], n_layers: int,
                              refine_layers: int = 3
                              ) -> Dict[str, torch.Tensor]:
    """Reference ``TransformerModel`` state dict -> the port's names.

    Keys the table does not name (the tied ``pred_layer.proj.weight``, the
    unused distribution projection) are skipped, as the JAX converter
    skips them."""
    sd = {re.sub(r"^module\.", "", k): v for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    for src, dst in _reference_names(n_layers, refine_layers):
        for leaf in ("weight", "bias"):
            if f"{src}.{leaf}" in sd:
                out[f"{dst}.{leaf}"] = torch.as_tensor(
                    np.asarray(sd[f"{src}.{leaf}"], np.float32))
    if "pred_layer.proj.bias" in sd:
        out["pred_layer.bias"] = torch.as_tensor(
            np.asarray(sd["pred_layer.proj.bias"], np.float32))
    return out


def load_weights(model: nn.Module, path: str) -> None:
    """Load ``path`` into ``model``.

    ``.pt``: a state dict saved by the port (``torch.save(model.
    state_dict())``), loaded strictly.  ``.pth``: a reference checkpoint
    (``{"model": state_dict, ...}``); keys it lacks keep their initial value,
    as in the JAX package's reload, and are logged."""
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
        return
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"cannot load {path!r}: the port reads a reference .pth or its "
            f"own .pt; Orbax checkpoint directories wait for a later slice")
    # reference blobs carry a pickled params namespace beside the weights
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob["model"] if isinstance(blob, dict) and "model" in blob else blob
    cfg = model.cfg
    converted = load_reference_state_dict(
        {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in sd.items()}, cfg.n_layers, cfg.refine_layers)
    result = model.load_state_dict(converted, strict=False)
    if result.unexpected_keys:
        raise KeyError(f"unexpected keys: {result.unexpected_keys}")
    if result.missing_keys:
        logger.warning("reload: %d keys not in %s keep their initial value",
                       len(result.missing_keys), path)
