"""Checkpoints of the port (counterpart of `m3p_tpu/checkpoint.py`).

Train-state checkpoints, in torch format:
* `save_checkpoint` / `restore_checkpoint` — the whole train state (model
  weights, optimizer state with its moments, fp32 master and accumulation
  buffer, the update count) plus host-side extras, in a directory laid out
  as the JAX package's Orbax one is: ``state.pt`` (one ``torch.save``),
  ``extra.json`` and, with a loader state, ``loader_state.<rank>.json``.
  A save writes a temporary sibling and renames it into place, so a kill
  during a save leaves the previous checkpoint whole.
* `load_params_checkpoint` — the weights of such a directory only, for
  ``--reload_model <dir>``.
* `merge_params` — loaded weights over a model's initial ones by name,
  keeping the initial value where the shape differs (the JAX reload).
* `average_checkpoints` — the ``--multi_reload_model`` weighted blend.

The weights bridge:
* `params_from_jax` — a JAX parameter tree (nested dicts of numpy arrays)
  to the port's ``state_dict``: ``kernel`` -> ``weight`` transposed,
  ``ln/scale`` / ``ln/bias`` -> ``weight`` / ``bias``, ``embedding`` ->
  ``weight``, ``bias`` -> ``bias``; the raw arrays of ``moe_ffn``
  (``router``, ``w1``, ``b1``, ``w2``, ``b2``) and ``cross_align``'s
  ``cq_weight`` keep their names and layouts, none transposed; module
  paths keep their names.
* `params_to_jax` — the inverse, from a port model.
* `grads_from_jax` — a JAX gradient tree (same structure as the parameter
  tree) to the port's names and layouts, to hold gradients leaf by leaf.
* `load_reference_state_dict` — a reference ``TransformerModel`` state dict
  (the names of `m3p_tpu/checkpoint.py:124-330`) to the port's names.  Both
  sides use torch's layouts, so only the names change.
  `export_reference_state_dict` / `save_reference_checkpoint` go the other
  way.
* `load_weights` — a reference ``.pth`` or a ``.pt`` saved by the port into
  a model.

Orbax checkpoint directories of the JAX package need JAX to read; the port
does not read them.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

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


# parameters that are raw arrays in JAX (not a Dense, LayerNorm or
# Embedding): the port stores them under their JAX names in the JAX layout
_RAW_PARAMS = {"moe_ffn": ("router", "w1", "b1", "w2", "b2"),
               "cross_align": ("cq_weight",)}


def _raw(mods: List[str], leaf: str) -> bool:
    """A raw array of a module that holds them (or of such a module's own
    tree, with no module path)."""
    if mods:
        return leaf in _RAW_PARAMS.get(mods[-1], ())
    return any(leaf in names for names in _RAW_PARAMS.values())


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
        elif leaf != "bias" and not _raw(mods, leaf):
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
        ("image_embeddings.image_distbution_embeddings",
         "image_emb.dist_proj"),
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

    Keys the table does not name (the tied ``pred_layer.proj.weight``) are
    skipped, as the JAX converter skips them; the class-distribution
    projection maps to ``image_emb.dist_proj``
    (`m3p_tpu/checkpoint.py:187-189`)."""
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


def export_reference_state_dict(model_or_state_dict, n_layers: int,
                                refine_layers: int = 3
                                ) -> Dict[str, torch.Tensor]:
    """The inverse of `load_reference_state_dict`: the port's weights under
    the reference ``TransformerModel`` names (`m3p_tpu/checkpoint.py:
    233-330`), fp32 CPU tensors; the tied ``pred_layer.proj.weight`` is a
    copy of the word table, as torch state dicts list a tied tensor under
    both names."""
    sd = _state_dict(model_or_state_dict)
    out: Dict[str, torch.Tensor] = {}
    for src, dst in _reference_names(n_layers, refine_layers):
        for leaf in ("weight", "bias"):
            if f"{dst}.{leaf}" in sd:
                out[f"{src}.{leaf}"] = _fp32_cpu(sd[f"{dst}.{leaf}"])
    if "pred_layer.bias" in sd:
        out["pred_layer.proj.bias"] = _fp32_cpu(sd["pred_layer.bias"])
    if "embeddings.weight" in out:
        out["pred_layer.proj.weight"] = out["embeddings.weight"].clone()
    return out


def save_reference_checkpoint(pth_path: str, model_or_state_dict,
                              n_layers: int, refine_layers: int = 3,
                              extra_params: Optional[Dict[str, Any]] = None
                              ) -> None:
    """A checkpoint the reference codebase can ``--reload_model``:
    ``{"model": state_dict, "params": {...}}``, the reference ``save_model``
    layout (`m3p_tpu/checkpoint.py:333-351`)."""
    torch.save({"model": export_reference_state_dict(
                    model_or_state_dict, n_layers, refine_layers),
                "params": dict(extra_params or {})}, pth_path)


def _state_dict(model_or_state_dict) -> Dict[str, torch.Tensor]:
    if isinstance(model_or_state_dict, nn.Module):
        return model_or_state_dict.state_dict()
    return dict(model_or_state_dict)


def _fp32_cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).clone()


def merge_params(model_or_state_dict, loaded: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Overlay ``loaded`` on a model's (or a state dict's) values by name,
    as the JAX package's `merge_params` overlays a parameter tree
    (`m3p_tpu/checkpoint.py:354-373`): a loaded tensor of the same shape
    replaces the value (in the value's dtype and on its device); one of
    another shape is skipped with a warning and the initial value kept;
    names ``loaded`` lacks keep their value.  Returns the merged state
    dict; a model given is loaded with it."""
    base = _state_dict(model_or_state_dict)
    merged: Dict[str, torch.Tensor] = {}
    for name, value in base.items():
        new = loaded.get(name)
        if new is None:
            merged[name] = value
        elif tuple(new.shape) == tuple(value.shape):
            merged[name] = torch.as_tensor(new).to(value.device, value.dtype)
        else:
            logger.warning("shape mismatch during reload of %s (%s loaded, "
                           "%s here); keeping initialized value", name,
                           tuple(new.shape), tuple(value.shape))
            merged[name] = value
    if isinstance(model_or_state_dict, nn.Module):
        model_or_state_dict.load_state_dict(merged, strict=True)
    return merged


def average_checkpoints(state_dicts: Sequence[Mapping[str, torch.Tensor]],
                        weights: Optional[Sequence[float]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Weighted average of state dicts by name (``--multi_reload_model``,
    `m3p_tpu/checkpoint.py:376-389`; the reference blends two averaged
    groups 0.6 / 0.4)."""
    if weights is None:
        weights = [1.0 / len(state_dicts)] * len(state_dicts)
    if len(weights) != len(state_dicts):
        raise ValueError(f"{len(weights)} weights for {len(state_dicts)} "
                         f"checkpoints")
    return {name: sum(w * sd[name] for w, sd in zip(weights, state_dicts))
            for name in state_dicts[0]}


def load_weights(model: nn.Module, path: str) -> None:
    """Load ``path`` into ``model``.

    ``.pt``: a state dict saved by the port (``torch.save(model.
    state_dict())``), loaded strictly.  ``.pth``: a reference checkpoint
    (``{"model": state_dict, ...}``) through `merge_params`: names it lacks,
    and names whose shape differs (another ``--lgs``), keep their initial
    value, as in the JAX package's reload."""
    if path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        dist_w = sd.get("image_emb.dist_proj.weight")
        if dist_w is not None and model.image_emb.dist_proj is None:
            model.image_emb.add_dist_proj(dist_w.shape[1])
        model.load_state_dict(sd, strict=True)
        return
    if not path.endswith(".pth"):
        raise NotImplementedError(
            f"cannot load {path!r}: the port reads a reference .pth or its "
            f"own .pt; Orbax checkpoint directories need JAX")
    cfg = model.cfg
    converted = load_reference_file(path, cfg.n_layers, cfg.refine_layers)
    dist_w = converted.get("image_emb.dist_proj.weight")
    if dist_w is not None and model.image_emb.dist_proj is None:
        # the checkpoint's class-distribution projection, for encode_image's
        # ``dist`` input
        model.image_emb.add_dist_proj(dist_w.shape[1])
    missing = [k for k in model.state_dict() if k not in converted]
    merge_params(model, converted)
    if missing:
        logger.warning("reload: %d keys not in %s keep their initial value",
                       len(missing), path)


def load_reference_file(path: str, n_layers: int, refine_layers: int = 3
                        ) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` file -> the port's names (fp32 CPU tensors)."""
    # reference blobs carry a pickled params namespace beside the weights
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob["model"] if isinstance(blob, dict) and "model" in blob else blob
    return load_reference_state_dict(
        {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in sd.items()}, n_layers, refine_layers)


# ---------------------------------------------------------------------------
# train-state checkpoints
# ---------------------------------------------------------------------------

STATE_FILE = "state.pt"


def _rank() -> int:
    dist = torch.distributed
    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


def _previous(path: str) -> str:
    return path + ".previous"


def committed_checkpoint(path: str) -> Optional[str]:
    """The directory holding the checkpoint saved under ``path``, or None.
    A save killed between moving the old directory aside and moving the
    new one in leaves the old one whole beside ``path``; it is the
    checkpoint then."""
    path = os.path.abspath(path)
    for candidate in (path, _previous(path)):
        if os.path.isfile(os.path.join(candidate, STATE_FILE)):
            return candidate
    return None


def save_checkpoint(path: str, state, extra: Optional[Dict[str, Any]] = None
                    ) -> None:
    """Persist the train state (model weights, optimizer state, update
    count) and host-side ``extra`` to the directory ``path``
    (`m3p_tpu/checkpoint.py:35-63`).

    The files go to a temporary sibling first, which then replaces
    ``path``: the old directory moves aside to ``<path>.previous``, the new
    one moves in, the old one is deleted.  A kill at any point leaves one
    whole checkpoint for `committed_checkpoint` to find.

    In a process group of several ranks the save is collective (every rank
    calls it): rank 0 writes the state (the same on every rank) and
    ``extra.json``, every rank its own ``loader_state.<rank>.json`` into
    the temporary directory, and rank 0 moves it into place; barriers keep
    the ranks in step.  A state over sharded parameters
    (`parallel.sharding`) is gathered whole first (every rank takes part),
    so the file is the one-process format, the counterpart of orbax writing
    the global arrays."""
    path = os.path.abspath(path)
    dist = torch.distributed
    ranks = (dist.is_available() and dist.is_initialized()
             and dist.get_world_size() > 1)
    rank = _rank()
    tmp = f"{path}.tmp-save" if ranks else f"{path}.tmp-{os.getpid()}"
    write_extra = bool(extra)
    extra = dict(extra or {})
    loader_state = extra.pop("loader_state", None)
    from m3p_tpu_torch.parallel.sharding import (
        gather_train_state, model_is_sharded)

    whole = (gather_train_state(state) if model_is_sharded(state.model)
             else {"model": state.model.state_dict(),
                   "opt_state": state.opt_state})
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    if ranks:
        dist.barrier()
    try:
        if rank == 0:
            torch.save(dict(whole, step=state.step),
                       os.path.join(tmp, STATE_FILE))
            if write_extra:
                with open(os.path.join(tmp, "extra.json"), "w") as f:
                    json.dump(extra, f, default=str)
        if loader_state:
            with open(os.path.join(tmp, f"loader_state.{rank}.json"),
                      "w") as f:
                json.dump(loader_state, f, default=str)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if ranks:
        dist.barrier()
    if rank == 0:
        _commit(tmp, path)
    if ranks:
        dist.barrier()


def _commit(tmp: str, path: str) -> None:
    """Move the whole checkpoint ``tmp`` into ``path``."""
    previous = _previous(path)
    if os.path.isdir(path):
        shutil.rmtree(previous, ignore_errors=True)
        os.replace(path, previous)
    os.replace(tmp, path)
    shutil.rmtree(previous, ignore_errors=True)


def _restore_into(live, saved, where: str):
    """``saved`` copied into the tensors of ``live`` (same structure);
    non-tensor leaves (counters) are taken from ``saved``."""
    if isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != live.shape \
                or saved.dtype != live.dtype:
            raise ValueError(f"checkpoint {where}: {_describe(saved)} does "
                             f"not fit {_describe(live)}")
        live.copy_(saved)
        return live
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(f"checkpoint {where}: keys differ")
        return {k: _restore_into(live[k], saved[k], f"{where}.{k}")
                for k in live}
    if isinstance(live, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(live):
            raise ValueError(f"checkpoint {where}: lengths differ")
        return type(live)(_restore_into(a, b, f"{where}[{i}]")
                          for i, (a, b) in enumerate(zip(live, saved)))
    return saved


def _describe(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"{tuple(x.shape)} {x.dtype}"
    return type(x).__name__


@torch.no_grad()
def restore_checkpoint(path: str, state):
    """Restore ``path`` into ``state`` in place: the weights into its
    model, the optimizer state into its tensors, on their device and in
    their dtype; returns (state, extra) (`m3p_tpu/checkpoint.py:66-93`).
    Over sharded parameters each rank takes its shards of the whole state,
    as orbax restores into the state's shardings."""
    where = committed_checkpoint(path)
    if where is None:
        raise FileNotFoundError(f"no checkpoint at {path}")
    device = next(state.model.parameters()).device
    blob = torch.load(os.path.join(where, STATE_FILE), map_location=device,
                      weights_only=True)
    from m3p_tpu_torch.parallel.sharding import (
        model_is_sharded, slice_like_state)

    if model_is_sharded(state.model):
        blob.update(slice_like_state(state, blob))
    state.model.load_state_dict(blob["model"], strict=True)
    state.opt_state = _restore_into(state.opt_state, blob["opt_state"],
                                    "opt_state")
    state.step = int(blob["step"])
    extra: Dict[str, Any] = {}
    extra_path = os.path.join(where, "extra.json")
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    rank_file = os.path.join(where, f"loader_state.{_rank()}.json")
    if os.path.exists(rank_file):
        with open(rank_file) as f:
            extra["loader_state"] = json.load(f)
    return state, extra


def load_params_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of a train-state checkpoint directory (CPU
    tensors), without the optimizer state: a pre-trained model for a fresh
    fine-tune (``--reload_model <dir>``, `m3p_tpu/checkpoint.py:96-110`)."""
    where = committed_checkpoint(path)
    if where is None:
        raise FileNotFoundError(f"no checkpoint at {path}")
    blob = torch.load(os.path.join(where, STATE_FILE), map_location="cpu",
                      weights_only=True)
    return blob["model"]
