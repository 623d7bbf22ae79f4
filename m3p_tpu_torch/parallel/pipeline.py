"""Pipeline parallelism: the GPipe schedule over the mesh's ``pp`` axis
(counterpart of `m3p_tpu/parallel/pipeline.py`).

The encoder stack's n_layers blocks are cut into S stages of n_layers / S
consecutive blocks, one per rank of a ``pp`` line, and the batch into M
microbatches.  At step t of the M + S - 1 steps, stage s runs microbatch
t - s through its blocks and sends the result to stage s + 1
(`parallel.mesh.exchange`), so every stage works at once after S - 1
steps of fill.  Stage s skips its compute on the bubble steps, where t - s
is no microbatch; JAX computes there and throws the result away, so the
outputs are the same.  The last stage's outputs are then broadcast to
every rank of the line, where the losses run.

The activations go along a line, not JAX's ring (its wrap from the last
stage to the first carries nothing used).  Only the activations travel:
the masks and the microbatch index are on every rank already.

The whole schedule is one `torch.autograd.Function` (`_Pipeline`): its
forward keeps each microbatch's graph through the stage's blocks, and its
backward runs the reverse schedule explicitly (the last stage first, the
microbatches in reverse order, each stage's input gradient sent to the
stage before it), so every rank posts its sends and receives in the order
its neighbours do.  The broadcast's backward hands the last stage S times
its gradient and the other stages none: every rank of the line computes
the same loss, so the sum over the line of what the stages hold is the
gradient of the whole stack, and `parallel.data_parallel.
average_over_ranks` averages over ``pp`` with the batch axes.  A block's
gradient arises on its own stage only, the embeddings' through stage 0's
input only, and the heads' alike on every rank; the average makes each
whole on every rank.

Each rank keeps every block, as every JAX device keeps the whole parameter
tree: checkpoints and `checkpoint.params_from_jax` are unchanged, and a
stage computes with its own blocks only.  ``cfg.remat`` is not applied
inside a stage, as the JAX stage's scan over a plain block has no remat;
the values are the same either way.

Dropout inside the stack is keyed per (microbatch, global layer index): one
seed is drawn from the line's generators on every rank alike
(`stack_seed`), and layer l of microbatch m draws from
``Generators.from_seed(seed, device, m * n_layers + l + 1)``
(`layer_generators`), as the JAX stage folds (key, microbatch, layer) into
its dropout key.  A one-process run fed the same seeds draws the same
masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import torch

from m3p_tpu_torch.model.layers import Generators
from m3p_tpu_torch.model.transformer import M3PModel
from m3p_tpu_torch.parallel import mesh as M
from m3p_tpu_torch.parallel.mesh import Mesh
from m3p_tpu_torch.parallel.sp import ShardedStackModel

StageFn = Callable[[torch.Tensor, int], torch.Tensor]

_STAGING = M.PinnedBuffers()


@dataclass
class _Line:
    """This rank's place on the ``axis`` line of ``mesh``."""

    mesh: Mesh
    axis: str

    @property
    def n(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def stage(self) -> int:
        return self.mesh.index(self.axis)

    def rank_of(self, stage: int) -> Optional[int]:
        """The global rank of ``stage`` on this line; None off its ends."""
        return (self.mesh.ranks(self.axis)[stage] if 0 <= stage < self.n
                else None)


def _schedule(line: _Line, n_micro: int, pos: int, first: Callable,
              work: Callable, prev: Optional[int], nxt: Optional[int],
              key: str) -> Dict[int, torch.Tensor]:
    """The GPipe schedule at position ``pos`` of a line of ``line.n``: at
    step t item m = t - pos (if 0 <= m < n_micro) is ``work(m, x)``, with
    x ``first(m)`` at position 0 and else what position pos - 1 (global
    rank ``prev``) sent at step t - 1 (``first(m)`` gives its shape); the
    result goes to ``nxt`` (None at the end of the line).  Returns {m:
    result}."""
    outs: Dict[int, torch.Tensor] = {}
    got = None
    for t in range(n_micro + line.n - 1):
        m = t - pos
        out = None
        if 0 <= m < n_micro:
            out = work(m, first(m) if pos == 0 else got)
            outs[m] = out
        send = out is not None and nxt is not None
        recv = prev is not None and 0 <= m + 1 < n_micro
        got = None
        if send or recv:
            ex = M.exchange([out.detach() if send else first(m + 1)],
                            nxt if send else None, prev if recv else None,
                            line.mesh.group(line.axis), line.mesh.backend,
                            _STAGING, (key,))
            received = ex.wait()
            got = received[0] if recv else None
    return outs


def _to_line(outs: Dict[int, torch.Tensor], xs: Sequence[torch.Tensor],
             line: _Line) -> torch.Tensor:
    """The last stage's (n_micro, ...) outputs on every rank of the line
    (one broadcast); ``xs`` give their shapes."""
    if line.stage == line.n - 1:
        buf = torch.stack([outs[m].detach() for m in range(len(xs))])
    else:
        buf = xs[0].new_empty((len(xs),) + tuple(xs[0].shape))
    if line.n > 1:
        M.broadcast_(buf, line.mesh, line.rank_of(line.n - 1),
                     line.mesh.group(line.axis))
    return buf


@dataclass
class _Plan:
    stage_fn: StageFn
    line: _Line
    n_micro: int
    params: List[torch.Tensor]


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: inputs (plan, *microbatches,
    *stage parameters), output the (n_micro, ...) stack of the last
    stage's outputs on every rank of the line."""

    @staticmethod
    def forward(ctx, plan: _Plan, *tensors):
        xs = tensors[:plan.n_micro]
        line = plan.line
        ins: Dict[int, torch.Tensor] = {}

        def work(m, h):
            h = h.detach().requires_grad_()
            ins[m] = h
            with torch.enable_grad():
                return plan.stage_fn(h, m)

        outs = _schedule(line, plan.n_micro, line.stage, lambda m: xs[m],
                         work, line.rank_of(line.stage - 1),
                         line.rank_of(line.stage + 1), "fwd")
        ctx.plan, ctx.ins, ctx.outs = plan, ins, outs
        ctx.x_meta = [(x.shape, x.dtype, x.device) for x in xs]
        return _to_line(outs, xs, line)

    @staticmethod
    def backward(ctx, grad):
        plan, line = ctx.plan, ctx.plan.line
        n = plan.n_micro
        params = plan.params
        last = line.n - 1
        param_grads: List[Optional[torch.Tensor]] = [None] * len(params)
        x_grads: Dict[int, torch.Tensor] = {}
        live = [i for i, p in enumerate(params) if p.requires_grad]

        def work(r, g_out):
            m = n - 1 - r
            inputs = [ctx.ins[m]] + [params[i] for i in live]
            gs = torch.autograd.grad(ctx.outs[m], inputs, g_out,
                                     allow_unused=True)
            del ctx.outs[m], ctx.ins[m]
            for i, g in zip(live, gs[1:]):
                if g is not None:
                    param_grads[i] = (g if param_grads[i] is None
                                      else param_grads[i] + g)
            x_grads[m] = gs[0]
            return gs[0]

        # the reverse schedule: the last stage is the line's head, the
        # microbatches in reverse order, gradients sent toward stage 0
        _schedule(line, n, last - line.stage,
                  lambda r: grad[n - 1 - r] * line.n, work,
                  line.rank_of(line.stage + 1), line.rank_of(line.stage - 1),
                  "bwd")
        if line.stage == 0:
            dxs = [x_grads[m] for m in range(n)]
        else:
            dxs = [torch.zeros(s, dtype=d, device=v)
                   for s, d, v in ctx.x_meta]
        return (None, *dxs, *param_grads)


def spmd_pipeline(stage_fn: StageFn, microbatches: Sequence[torch.Tensor],
                  mesh: Mesh, axis: str = "pp",
                  params: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Run ``stage_fn(h, m) -> h`` (this rank's stage on microbatch m) as a
    GPipe pipeline over the ``axis`` line of ``mesh``
    (`m3p_tpu/parallel/pipeline.py:38-98`).  ``microbatches``: the M
    stage-0 inputs, on every rank of the line (the other stages read only
    their shapes); ``params``: the stage's parameters, whose gradients the
    backward returns.  Returns the (M, ...) stack of the last stage's
    outputs on every rank of the line."""
    xs = list(microbatches)
    line = _Line(mesh, axis)
    params = list(params)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in xs + params):
        plan = _Plan(stage_fn, line, len(xs), params)
        return _Pipeline.apply(plan, *xs, *params)
    outs = _schedule(line, len(xs), line.stage, lambda m: xs[m],
                     lambda m, h: stage_fn(h, m),
                     line.rank_of(line.stage - 1),
                     line.rank_of(line.stage + 1), "fwd")
    return _to_line(outs, xs, line)


def stack_block_params(model: M3PModel, stage: int, n_stages: int
                       ) -> List[torch.nn.Module]:
    """Stage ``stage``'s view of the stack: its n_layers / n_stages
    consecutive ``block_i`` (`m3p_tpu/parallel/pipeline.py:101-116`, where
    `stack_stage_params` stacks them along a leading dimension that
    shard_map splits over ``pp``; here every rank keeps every block and
    the stage reads its own)."""
    n_layers = model.cfg.n_layers
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} "
                         "pipeline stages")
    per = n_layers // n_stages
    return model.blocks[stage * per:(stage + 1) * per]


def stack_seed(generator: Generators) -> int:
    """The seed of a pipelined stack's dropout: one draw from the host
    generator, which every rank of a ``pp`` line holds alike."""
    return int(torch.randint(0, 2 ** 62, (), generator=generator.host))


def layer_generators(seed: int, microbatch: int, layer: int, n_layers: int,
                     device) -> Generators:
    """The generators of global layer ``layer`` on ``microbatch``: the
    stack's seed with (microbatch, layer) folded in."""
    return Generators.from_seed(seed, device,
                                microbatch * n_layers + layer + 1)


def pp_run_blocks(model: M3PModel, x: torch.Tensor, mask: torch.Tensor,
                  mesh: Mesh, axis: str = "pp", n_microbatches: int = 2,
                  deterministic: bool = True,
                  generator: Optional[Generators] = None) -> torch.Tensor:
    """Run the encoder stack pipelined over ``axis``
    (`m3p_tpu/parallel/pipeline.py:118-235`): x (B, S, D) with its (B, S)
    mask, B % n_microbatches == 0 and n_layers % stages == 0.  A training
    forward with dropout needs ``generator`` (ValueError without: the
    stack does not train quietly without its regularization); each layer
    of each microbatch then draws from `layer_generators`."""
    cfg = model.cfg
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"a batch of {b} rows does not split into "
                         f"{n_microbatches} microbatches")
    n_stages = mesh.shape[axis]
    stage = mesh.index(axis)
    blocks = stack_block_params(model, stage, n_stages)
    per = len(blocks)
    use_dropout = not deterministic and (cfg.dropout > 0
                                         or cfg.attention_dropout > 0)
    if use_dropout and generator is None:
        raise ValueError(
            f"pp_run_blocks: a training forward (deterministic=False) with "
            f"dropout={cfg.dropout}/attention_dropout="
            f"{cfg.attention_dropout} needs generators; refusing to drop "
            "the regularization quietly")
    seed = stack_seed(generator) if use_dropout else None
    dev = generator.device.device if use_dropout else None
    mb = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
    mb_mask = mask.reshape(n_microbatches, b // n_microbatches,
                           *mask.shape[1:])

    def stage_fn(h, m):
        for j, block in enumerate(blocks):
            gen = (layer_generators(seed, m, stage * per + j, cfg.n_layers,
                                    dev) if use_dropout else None)
            h = block(h, mb_mask[m], False, not use_dropout, gen)
        return h

    params = [p for block in blocks for p in block.parameters()]
    out = spmd_pipeline(stage_fn, mb.unbind(0), mesh, axis, params)
    return out.reshape(b, *x.shape[1:])


class PPModel(ShardedStackModel):
    """Pipeline-parallel model handle (`m3p_tpu/parallel/pipeline.py:
    241-266`): the trainer swaps it in when the mesh has ``pp > 1``, so
    every objective's non-causal encoder stack runs the GPipe schedule;
    embeddings, heads and causal decoding stay on every rank."""

    def __init__(self, model: M3PModel, mesh: Mesh, axis: str = "pp",
                 n_microbatches: int = 2):
        from m3p_tpu_torch.parallel.sharding import check_model_supported

        check_model_supported(model.cfg, mesh.shape)
        super().__init__(model)
        self.mesh = mesh
        self.axis = axis
        self.n_microbatches = n_microbatches

    def _blocks(self, x, mask, deterministic, generator):
        return pp_run_blocks(self.model, x, mask, self.mesh, self.axis,
                             self.n_microbatches, deterministic, generator)


def pipelined_encode_joint(model: M3PModel, tokens, text_mask, feats, locs,
                           img_mask, mesh: Mesh, axis: str = "pp",
                           n_microbatches: int = 4,
                           refine_image: bool = False,
                           deterministic: bool = True,
                           generator: Optional[Generators] = None
                           ) -> torch.Tensor:
    """`M3PModel.encode_joint` with the stack pipelined over ``axis``
    (`m3p_tpu/parallel/pipeline.py:269-296`): the embeddings (the refiner
    included) on every rank, the blocks by stage."""
    return PPModel(model, mesh, axis, n_microbatches).encode_joint(
        tokens, text_mask, feats, locs, img_mask, refine_image,
        deterministic, generator)


def make_pp_itm_train_step(model: M3PModel, mesh: Mesh, sample_n: int,
                           axis: str = "pp", n_microbatches: int = 2):
    """The ITM retrieval step with the stack pipelined over ``axis``, a
    deterministic forward with the refiner on
    (`m3p_tpu/parallel/pipeline.py:304-334`): (state, batch, generator) ->
    (state, metrics).  The gradients are averaged over the mesh
    (`TrainState.mesh` is set to ``mesh``)."""
    from m3p_tpu_torch.train import steps as S

    pp_model = PPModel(model, mesh, axis, n_microbatches)

    def loss_fn(_model, batch, generator, **kw):
        return S.itm_finetune_loss(pp_model, batch, generator, sample_n,
                                   refine_image=True, deterministic=True)

    plain = S.make_train_step(loss_fn)

    def step(state, batch, generator=None, **kw):
        state.mesh = mesh
        return plain(state, batch, generator, **kw)

    return step
