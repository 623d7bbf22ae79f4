"""Sharding rules: logical parameter axes -> mesh axes (counterpart of
`m3p_tpu/parallel/sharding.py`).

One mechanism expresses every strategy, as in the JAX package:

* DP   -- the batch over ("data", "fsdp") (`batch_sharding`);
* FSDP -- each parameter's ``embed`` dimension over ``fsdp``: a rank holds
  a slice and gathers the whole where it computes, and its gradient is
  reduce-scattered (`parallel.tensor_parallel.materialize`);
* TP   -- Megatron's layout: ``qkv`` / ``mlp`` columns and the ``vocab``
  rows over ``tensor``, the following product's rows with them;
* EP   -- MoE's ``expert`` dimension over ``expert``;
* SP   -- the sequence over ``seq`` (`parallel.sp`).

flax carries each parameter's logical axes as ``nn.Partitioned`` metadata
(`m3p_tpu/model/layers.py:28-39,77-80,355-366,470-496`,
`m3p_tpu/model/embeddings.py:31,120-123,156-158`,
`m3p_tpu/model/heads.py:92,109,134,144`); the port's parameters are plain
tensors, so `logical_axes` names them from the table `PARAM_AXES`, by
parameter name, in the port's layout (a Dense's weight is the transposed
kernel, so its axes are the kernel's reversed).  LayerNorms and every
leaf the JAX package leaves unannotated are replicated.

`shard_model` slices each parameter of a whole model (the same on every
rank) to this rank's shard, records its `ShardSpec` on it (``p.shard``)
and puts the blocks' attention and FFN, the MoE FFNs, the word embedding
and the word head or the adaptive softmax into their tensor- and
expert-parallel modes (`parallelize`); a dimension that does not divide
by its axis is held padded, as GSPMD holds it
(`parallel.tensor_parallel`'s docstring); an
optimizer state made afterwards holds shards too (`train_state_shardings`
mirrors the parameters' specs onto it, as `_shard_like` does).
Checkpoints gather the whole state (`gather_train_state`) and a restore
slices it again (`slice_like_state`).  The ``pp`` axis splits the stack
(`parallel.pipeline`), not the parameters: every rank keeps every block.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from m3p_tpu_torch.parallel import mesh as M
from m3p_tpu_torch.parallel.mesh import Mesh
from m3p_tpu_torch.parallel.tensor_parallel import (
    ShardSpec, gather_whole, local_slice, shard_of, shard_padding,
    vocab_shard)

# logical axis -> mesh axis (None = replicate), as the JAX package maps them
LOGICAL_RULES = (
    ("batch", ("data", "fsdp")),
    ("vocab", "tensor"),
    ("embed", "fsdp"),
    ("qkv", "tensor"),
    ("mlp", "tensor"),
    ("heads", "tensor"),
    ("expert", "expert"),
)

# the mesh axes a parameter is split over
PARAM_AXES_OF_MESH = ("fsdp", "tensor", "expert")

_QKV, _MLP, _EMB, _VOC = "qkv", "mlp", "embed", "vocab"

# (pattern of the parameter's name, its logical axes in the port's layout);
# the first pattern that matches names the axes; no match: replicated
PARAM_AXES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # attention (blocks, cross-attention, the AoA refiner): kernel
    # (embed, qkv) -> weight (qkv, embed); out_lin kernel (qkv, embed)
    (r"(q_lin|k_lin|v_lin)\.weight$", (_QKV, _EMB)),
    (r"(q_lin|k_lin|v_lin)\.bias$", (_QKV,)),
    (r"out_lin\.weight$", (_EMB, _QKV)),
    (r"out_lin\.bias$", (_EMB,)),
    # FFNs (blocks and refiner): lin1 (embed, mlp), lin2 (mlp, embed)
    (r"lin1\.weight$", (_MLP, _EMB)),
    (r"lin1\.bias$", (_MLP,)),
    (r"lin2\.weight$", (_EMB, _MLP)),
    (r"lin2\.bias$", (_EMB,)),
    # MoE: the raw arrays in the JAX layouts
    (r"moe_ffn\.router$", (_EMB, "expert")),
    (r"moe_ffn\.w1$", ("expert", _EMB, _MLP)),
    (r"moe_ffn\.b1$", ("expert", _MLP)),
    (r"moe_ffn\.w2$", ("expert", _MLP, _EMB)),
    (r"moe_ffn\.b2$", ("expert", _EMB)),
    # embeddings: word (vocab, embed), position and language (None, embed)
    (r"^text_emb\.word\.weight$", (_VOC, _EMB)),
    (r"^text_emb\.(position|lang)\.weight$", (None, _EMB)),
    # region projections and the AoA gate: kernel (None, embed)
    (r"^image_emb\.\w+_proj\.weight$", (_EMB, None)),
    (r"^image_emb\.\w+_proj\.bias$", (_EMB,)),
    (r"aoa\.weight$", (_EMB, None)),
    (r"aoa\.bias$", (_EMB,)),
    # the word head: bias (vocab,), an untied kernel (embed, vocab)
    (r"^pred_layer\.bias$", (_VOC,)),
    (r"^pred_layer\.weight$", (_VOC, _EMB)),
    (r"^pred_layer_asm\.head\.weight$", (_VOC, _EMB)),
    (r"^pred_layer_asm\.head\.bias$", (_VOC,)),
    (r"^pred_layer_asm\.tail_\d+_proj\.weight$", (None, _EMB)),
    (r"^pred_layer_asm\.tail_\d+_out\.weight$", (_VOC, None)),
    # kernels (embed, None): the heads, the poolers, the fusion's scores
    # and output; their biases (None,) are replicated
    (r"^(obj_pred\.(transform_dense|proj)|(itm|clcm)_pooler\.(dense|score)"
     r"|mrfr_head\.dense|cross_align\.(att_weight_c|att_weight_q"
     r"|align_output))\.weight$", (None, _EMB)),
)


def logical_axes(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """The logical axes of the port's parameter ``name`` (`PARAM_AXES`),
    in its layout; all None (replicated) where no pattern names it."""
    for pattern, axes in PARAM_AXES:
        if re.search(pattern, name):
            if len(axes) != ndim:
                raise ValueError(f"{name}: {ndim} dimensions against the "
                                 f"logical axes {axes}")
            return axes
    return (None,) * ndim


def model_param_specs(model: torch.nn.Module
                      ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each parameter's logical axes by name: the counterpart of
    `get_param_pspecs` / `model_param_pspecs`."""
    return {name: logical_axes(name, p.dim())
            for name, p in model.named_parameters()}


def logical_to_mesh_axes(axes: Sequence[Optional[str]],
                         rules=LOGICAL_RULES) -> Tuple[Any, ...]:
    """Each logical axis's mesh axis (None: replicated), a mesh axis taken
    by at most one dimension (the first), as flax's
    ``logical_to_mesh_axes`` maps them."""
    table = dict(rules)
    used, out = set(), []
    for axis in axes:
        mesh_axis = table.get(axis) if axis is not None else None
        names = ((mesh_axis,) if isinstance(mesh_axis, str)
                 else tuple(mesh_axis or ()))
        if mesh_axis is None or used & set(names):
            out.append(None)
            continue
        used |= set(names)
        out.append(mesh_axis)
    return tuple(out)


def logical_to_shardings(specs: Dict[str, Tuple[Optional[str], ...]],
                         mesh: Mesh, shapes: Dict[str, Tuple[int, ...]],
                         rules=LOGICAL_RULES
                         ) -> Dict[str, Optional[ShardSpec]]:
    """Each parameter's `ShardSpec` on ``mesh`` (None: whole on every
    rank): its logical axes' mesh axes, less those of size 1."""
    out = {}
    for name, axes in specs.items():
        mesh_axes = tuple(
            a if isinstance(a, str) and mesh.shape[a] > 1 else None
            for a in logical_to_mesh_axes(axes, rules))
        out[name] = (ShardSpec(mesh, mesh_axes, tuple(shapes[name]))
                     if any(mesh_axes) else None)
    return out


# ---------------------------------------------------------------------------
# the mesh the port takes
# ---------------------------------------------------------------------------

def check_mesh_supported(shape: Dict[str, int]) -> None:
    """Raise ValueError for ``seq`` and ``pp`` both above 1, as the JAX
    trainer asserts: the encoder stack is sharded once."""
    if shape.get("pp", 1) > 1 and shape.get("seq", 1) > 1:
        raise ValueError("seq and pp cannot both be above 1: the encoder "
                         "stack is sharded once")


def check_model_supported(cfg, shape: Dict[str, int]) -> None:
    """Raise NotImplementedError for the blocks the pipeline's stage does
    not run under ``pp`` above 1, MoE and the int8 FFN, as the JAX stage
    builds its block with neither (`m3p_tpu/parallel/pipeline.py:174-179`).
    Those are the JAX stage's limits and the only ones: every dimension
    that does not divide by its axis is held padded, as GSPMD holds it,
    heads over ``tensor`` (resharded around the attention kernels,
    `model.layers.MultiHeadAttention`) and experts over ``expert``
    (`model.layers.MoEFFN`) too."""
    if shape.get("pp", 1) > 1:
        if cfg.moe_experts > 0:
            raise NotImplementedError("MoE blocks under pp > 1: the "
                                      "pipeline's stage runs dense blocks, "
                                      "as the JAX stage does")
        if cfg.ffn_quant != "none":
            raise NotImplementedError(
                f"ffn_quant={cfg.ffn_quant!r} under pp > 1: the pipeline's "
                "stage runs the float FFN, as the JAX stage does")


def is_sharded(shape: Dict[str, int]) -> bool:
    """Whether a mesh splits parameters (fsdp, tensor or expert above 1)."""
    return any(shape.get(a, 1) > 1 for a in PARAM_AXES_OF_MESH)


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh: Mesh
                ) -> Dict[str, Optional[ShardSpec]]:
    """Make ``model`` (whole, the same on every rank) hold this rank's
    shards on ``mesh``: each parameter sliced in place (padded where its
    dimension does not divide), its `ShardSpec` recorded as ``p.shard``;
    then `parallelize`.  Returns the specs by name."""
    check_mesh_supported(mesh.shape)
    check_model_supported(model.cfg, mesh.shape)
    params = dict(model.named_parameters())
    specs = logical_to_shardings(
        model_param_specs(model), mesh,
        {n: tuple(p.shape) for n, p in params.items()})
    for name, spec in specs.items():
        if spec is None:
            continue
        p = params[name]
        p.data = local_slice(p.data, spec)
        p.shard = spec
    parallelize(model, mesh)
    return specs


def parallelize(model: torch.nn.Module, mesh: Mesh) -> None:
    """Put the modules of ``model``, whose parameters hold their shards on
    ``mesh``, into their parallel modes: the blocks' attention and FFN
    over ``tensor``, the MoE FFNs over ``expert``, the word table and the
    word head (or the adaptive softmax's head and tails) split by
    vocabulary (`shard_model`; `model.shared_variant` over a sharded
    model)."""
    from m3p_tpu_torch.model.layers import EncoderBlock

    tp = mesh.shape["tensor"] > 1
    for module in model.modules():
        if isinstance(module, EncoderBlock):
            if tp:
                module.attn.tensor_parallel(mesh)
                if module.has_cross_attention:
                    module.encoder_attn.tensor_parallel(mesh)
                if module.ffn is not None:
                    module.ffn.tensor_parallel(mesh)
            if module.moe_ffn is not None:
                module.moe_ffn.parallel(mesh)
    if tp:
        vocab = vocab_shard(mesh, model.cfg.n_words)
        model.text_emb.word.vocab = vocab
        if model.cfg.asm:
            model.pred_layer_asm.tensor_parallel(mesh)
        else:
            model.pred_layer.vocab = vocab


def shard_bytes(model: torch.nn.Module) -> Dict[str, int]:
    """This rank's bytes of parameters and those of the whole model."""
    local = sum(p.numel() * p.element_size() for p in model.parameters())
    whole = sum(int(np.prod(shard_of(p).shape if shard_of(p) else p.shape))
                * p.element_size() for p in model.parameters())
    return {"local": local, "whole": whole}


# ---------------------------------------------------------------------------
# the global norm over shards
# ---------------------------------------------------------------------------


def replica_sum(params: Sequence[torch.Tensor]) -> Optional[Callable]:
    """None when no parameter of ``params`` is sharded; else the
    ``leaf_sum`` of `train.optim`: a function from the (n_leaves,) fp32
    vector of this rank's per-leaf partial sums to each leaf's sum over
    the whole tensor.  Each entry is weighted by one over the leaf's
    replicas (the ranks of fsdp x tensor x expert that hold the same
    slice) and the vector summed over those axes (one all-reduce), so each
    element counts once."""
    specs = [shard_of(p) for p in params]
    mesh = next((s.mesh for s in specs if s is not None), None)
    if mesh is None:
        return None
    weights = []
    for s in specs:
        split = set() if s is None else {a for a in s.axes if a}
        weights.append(1.0 / float(np.prod([
            mesh.shape[a] for a in PARAM_AXES_OF_MESH if a not in split])))
    group = mesh.group(PARAM_AXES_OF_MESH)

    def leaf_sum(partial: torch.Tensor) -> torch.Tensor:
        w = torch.tensor(weights, dtype=torch.float32, device=partial.device)
        return M.all_reduce_sum(partial.float() * w, mesh, group)

    return leaf_sum


# ---------------------------------------------------------------------------
# train state
# ---------------------------------------------------------------------------


def _map_like(tree, n: int, fn: Callable):
    """``tree`` with each list of ``n`` tensors (a tree that mirrors the
    parameters, as optax states do) replaced by ``fn(list)``; containers
    walked, other leaves (counts, scalars) kept."""
    if isinstance(tree, list) and len(tree) == n and all(
            isinstance(t, torch.Tensor) for t in tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_like(v, n, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_like(v, n, fn) for v in tree)
    return tree


def train_state_shardings(state) -> Dict[str, Any]:
    """A TrainState-shaped tree of `ShardSpec`s: ``params`` in the model's
    order, ``opt_state`` mirroring them where a subtree mirrors the
    parameters (its moments, master and accumulation buffer), None
    (replicated) for counts and scalars; ``step`` None."""
    specs = [shard_of(p) for p in state.model.parameters()]
    return {"step": None, "params": specs,
            "opt_state": _map_like(state.opt_state, len(specs),
                                   lambda _: list(specs))}


def shard_train_state(state, mesh: Mesh):
    """Place a whole TrainState on ``mesh`` (`shard_model` on its model,
    then its optimizer state sliced alike).  Returns (state, shardings)."""
    whole = list(state.model.parameters())
    specs = shard_model(state.model, mesh)
    by_param = [specs[n] for n, _ in state.model.named_parameters()]
    state.opt_state = _map_like(
        state.opt_state, len(whole),
        lambda ts: [local_slice(t, s) for t, s in zip(ts, by_param)])
    state.mesh = mesh
    return state, train_state_shardings(state)


@torch.no_grad()
def gather_train_state(state) -> Dict[str, Any]:
    """The whole state's model state dict and optimizer state (every rank
    takes part in the gathers; the same tensors on every rank)."""
    model = state.model
    named = dict(model.named_parameters())
    sd = {k: gather_whole(v, shard_of(named[k])) if k in named else v
          for k, v in model.state_dict().items()}
    specs = [shard_of(p) for p in model.parameters()]
    opt = _map_like(state.opt_state, len(specs), lambda ts: [
        gather_whole(t, s) for t, s in zip(ts, specs)])
    return {"model": sd, "opt_state": opt}


def slice_like_state(state, blob: Dict[str, Any]) -> Dict[str, Any]:
    """A whole state's ``model`` and ``opt_state`` (`gather_train_state`'s
    form, or a checkpoint of one process) sliced to this rank's shards of
    ``state``."""
    named = dict(state.model.named_parameters())
    sd = {k: local_slice(v, shard_of(named[k])) if k in named else v
          for k, v in blob["model"].items()}
    specs = [shard_of(p) for p in state.model.parameters()]
    opt = _map_like(blob["opt_state"], len(specs), lambda ts: [
        local_slice(t, s) for t, s in zip(ts, specs)])
    return {"model": sd, "opt_state": opt}


@torch.no_grad()
def padding_max(state) -> float:
    """The largest |entry| in the padding of this rank's shards
    (`tensor_parallel.shard_padding`) of the parameters, their gradients
    and the optimizer state that mirrors them: an uneven split's padding
    stays 0.0."""
    params = list(state.model.parameters())
    specs = [shard_of(p) for p in params]
    trees = [[p.detach() for p in params], [p.grad for p in params]]
    _map_like(state.opt_state, len(specs), trees.append)
    worst = 0.0
    for tree in trees:
        for t, spec in zip(tree, specs):
            if t is None or spec is None:
                continue
            for pad in shard_padding(t, spec):
                if pad.numel():
                    worst = max(worst, float(pad.abs().max()))
    return worst


def model_is_sharded(model: torch.nn.Module) -> bool:
    return any(shard_of(p) is not None for p in model.parameters())


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchSharding:
    """This rank's shard of a global batch: rows ``index * n / count`` to
    ``(index + 1) * n / count`` of an ``n``-row batch."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        if n % self.count:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{self.count} batch shards")
        per = n // self.count
        return slice(self.index * per, (self.index + 1) * per)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """The leading batch dimension over ("data", "fsdp"); everything else
    replicated (`m3p_tpu/parallel/sharding.py:50-52`)."""
    check_mesh_supported(mesh.shape)
    return BatchSharding(*mesh.batch_shards)


def shard_batch(batch: Any, sharding: BatchSharding) -> Any:
    """This rank's rows of a global batch: a dict (or tuple of dicts) of
    arrays whose leading dimension is the batch."""
    if isinstance(batch, tuple):
        return tuple(shard_batch(b, sharding) for b in batch)
    if isinstance(batch, dict):
        return {k: shard_batch(v, sharding) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor) or hasattr(batch, "shape"):
        return batch[sharding.rows(batch.shape[0])]
    return batch


__all__ = ["LOGICAL_RULES", "PARAM_AXES", "BatchSharding", "ShardSpec",
           "batch_sharding", "check_mesh_supported", "check_model_supported",
           "gather_train_state", "is_sharded", "logical_axes", "parallelize",
           "logical_to_mesh_axes", "logical_to_shardings",
           "model_param_specs", "shard_batch", "shard_model",
           "shard_train_state", "replica_sum", "slice_like_state",
           "train_state_shardings"]
