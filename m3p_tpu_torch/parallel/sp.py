"""Sequence parallelism integrated with the model (counterpart of
`m3p_tpu/parallel/sp.py`).

Long sequences shard the (B, S, D) activations of the encoder stack over
the mesh's ``seq`` axis: projections, LayerNorms and FFNs are position-wise,
and self-attention runs the ring (`ops.ring_attention`).  The embeddings
(the [img; text] concat and its positions included) are computed on every
rank of the axis, then sliced; the stack's output is gathered back, and the
losses run on the whole sequence on every rank.

The gather's backward hands each rank its slice of the gradient times the
axis length: the loss is the same on every rank of the axis, so the sum of
the slices' contributions over the axis, which the all-reduce of
`parallel.data_parallel.average_over_ranks` averages, is the gradient of the
whole stack.  Dropout inside the stack draws from generators with the
shard index folded in (`Generators.fold_in`), as the JAX body folds it into
its key; outside the stack every rank of the axis draws the same masks.

`SPModel` stands in for an `M3PModel` wherever the losses take one: its
``encode_joint``, non-causal ``encode_text`` and ``encode_image`` run the
sharded stack; everything else (causal decoding, the heads, the
parameters) goes to the wrapped model.  Composition with ``data``: the
ranks of a ``seq`` line hold the same batch shard.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.model.transformer import M3PModel
from m3p_tpu_torch.parallel import mesh as M
from m3p_tpu_torch.parallel.mesh import Mesh


class _GatherSeq(torch.autograd.Function):
    """All-gather of the sequence shards along dim 1; the backward is the
    local slice of the gradient times the axis length."""

    @staticmethod
    def forward(ctx, x_local, mesh, axis):
        ctx.n, ctx.index, ctx.width = (mesh.shape[axis], mesh.index(axis),
                                       x_local.shape[1])
        return M.all_gather_cat(x_local, mesh, axis, dim=1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.width
        return grad[:, lo:lo + ctx.width] * ctx.n, None, None


def seq_parallel_run_blocks(model: M3PModel, x: torch.Tensor,
                            mask: torch.Tensor, mesh: Mesh,
                            axis: str = "seq", deterministic: bool = True,
                            generator: Optional[Generators] = None
                            ) -> torch.Tensor:
    """Run the encoder stack with the activations sharded over ``axis``
    (`m3p_tpu/parallel/sp.py:40-96`): S is padded to a multiple of the axis
    length (the padding masked out of attention, sliced off after), each
    rank runs its slice through `M3PModel.run_blocks_only` with the ring,
    and the slices are gathered.  Without generators (or deterministic)
    the stack runs without dropout, as the JAX body does."""
    n = mesh.shape[axis]
    s = x.shape[1]
    pad = (-s) % n
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
    width = x.shape[1] // n
    i = mesh.index(axis)
    x_local = x[:, i * width:(i + 1) * width]
    mask_local = mask[:, i * width:(i + 1) * width]
    det = deterministic or generator is None
    gen = None if det else generator.fold_in(i)
    with M.bind_axes(mesh, axis):
        out = model.run_blocks_only(x_local, mask_local, det, gen)
    out = _GatherSeq.apply(out, mesh, axis)
    return out[:, :s] if pad else out


class ShardedStackModel:
    """Stands in for an `M3PModel` in the losses: every non-causal encoder
    stack (`encode_joint`, the non-causal `encode_text`, `encode_image`)
    runs through a sharded block runner, `_blocks`, which a subclass gives
    (`SPModel` here, `parallel.pipeline.PPModel`); causal, cross-attention
    and cached calls, the embeddings and the heads go to the wrapped
    model, and attribute access falls through to it
    (`m3p_tpu/parallel/sp.py:99-181`)."""

    def __init__(self, model: M3PModel):
        self.model = model
        self.cfg = model.cfg

    def __getattr__(self, name):
        if name == "model":          # guard __init__-time recursion
            raise AttributeError(name)
        return getattr(self.model, name)

    def _blocks(self, x, mask, deterministic, generator):
        raise NotImplementedError

    def encode_joint(self, tokens, text_mask, feats, locs, img_mask,
                     refine_image=False, deterministic=True, generator=None,
                     token_embeds=None):
        if not deterministic and generator is None:
            raise ValueError("encode_joint(deterministic=False) needs "
                             "generators")
        x, joint_mask = self.model.embed_joint(
            tokens, text_mask, feats, locs, img_mask, refine_image,
            deterministic, generator, token_embeds)
        return self._blocks(x, joint_mask, deterministic, generator)

    def encode_text(self, tokens, text_mask, langs=None, positions=None,
                    deterministic=True, generator=None, causal=False,
                    src_enc=None, src_mask=None, cache=None,
                    token_embeds=None, image_enc=None, image_mask=None):
        if causal or src_enc is not None or cache is not None:
            return self.model.encode_text(
                tokens, text_mask, langs, positions, deterministic,
                generator, causal, src_enc, src_mask, cache, token_embeds,
                image_enc, image_mask)
        if not deterministic and generator is None:
            raise ValueError("encode_text(deterministic=False) needs "
                             "generators")
        x = self.model.embed_text(tokens, text_mask, langs, positions,
                                  deterministic, generator, token_embeds,
                                  image_enc, image_mask)
        return self._blocks(x, text_mask, deterministic, generator)

    def encode_image(self, feats, locs, img_mask, refine_image=False,
                     deterministic=True, generator=None,
                     refine_encoder=False, dist=None):
        x = self.model.embed_image_regions(feats, locs, img_mask,
                                           refine_image, deterministic,
                                           generator, dist=dist)
        out = self._blocks(x, img_mask, deterministic, generator)
        if refine_encoder:
            out = self.model.refiner(out, img_mask, deterministic, generator)
        return out


class SPModel(ShardedStackModel):
    """Sequence-parallel model handle: every non-causal encoder stack runs
    sharded over the mesh's ``axis`` with ring attention."""

    def __init__(self, model: M3PModel, mesh: Mesh, axis: str = "seq"):
        super().__init__(model)
        self.mesh = mesh
        self.axis = axis

    def _blocks(self, x, mask, deterministic, generator):
        return seq_parallel_run_blocks(self.model, x, mask, self.mesh,
                                       self.axis, deterministic, generator)


def seq_parallel_encode_joint(model: M3PModel, tokens, text_mask, feats,
                              locs, img_mask, mesh: Mesh, axis: str = "seq",
                              refine_image: bool = False,
                              deterministic: bool = True,
                              generator: Optional[Generators] = None
                              ) -> torch.Tensor:
    """`M3PModel.encode_joint` with the stack sharded over ``axis``
    (`m3p_tpu/parallel/sp.py:199-216`)."""
    return SPModel(model, mesh, axis).encode_joint(
        tokens, text_mask, feats, locs, img_mask, refine_image,
        deterministic, generator)


def make_sp_itm_train_step(model: M3PModel, mesh: Mesh, sample_n: int,
                           axis: str = "seq"):
    """The ITM retrieval step with the stack sequence-parallel, a
    deterministic forward (`m3p_tpu/parallel/sp.py:219-238`):
    (state, batch, generator) -> (state, metrics).  The gradients are
    averaged over the mesh (`TrainState.mesh` is set to ``mesh``)."""
    from m3p_tpu_torch.train import steps as S

    sp_model = SPModel(model, mesh, axis)

    def loss_fn(_model, batch, generator, **kw):
        return S.itm_finetune_loss(sp_model, batch, generator, sample_n,
                                   deterministic=True)

    plain = S.make_train_step(loss_fn)

    def step(state, batch, generator=None, **kw):
        state.mesh = mesh
        return plain(state, batch, generator, **kw)

    return step
