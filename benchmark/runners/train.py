"""Runner of the training cells: the port's train step, driven from the
seed through its first steps, then measured, then checked.

Set-up builds one train state (the model with the benchmark's weights,
`FusedAdam` as the traffic file's spec states it) and one step
(`make_train_step` over the objective's loss), warms it up on the input
pool's batches, sets the same state back to step 0 in place and hands it
to the window, which cycles through the pool.  The window's first
``check_steps`` steps (distinct batches) are read as they run.  Once the
window has closed and the peak memory is read, the program is freed and
the plain reference follows those steps from the same weights, batches
and seeds.  Compared, each against its limit (`checks` of the traffic
file):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first gradient as the optimizer got it (its first
  moment after one step over 1 - beta1), by the worst leaf: the gap of the
  two norms over the reference's norm of the leaf or of the median leaf,
  whichever is larger;
* ``change_gap``: the parameters' change after the first steps (the fp32
  master), by the worst leaf in the same way, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's.

Objectives: ``mct`` (`mct_pretrain_loss` over grid-flattened joint
batches) and ``mlm`` (`mlm_loss` over text streams).
"""

from __future__ import annotations

import dataclasses
import functools
import statistics
import time
from typing import Callable, Dict, List, Tuple

import torch

from benchmark.harness import Check, Context
from benchmark.reference import m3p as ref
from benchmark.weights import make_weights, sub_seed
from benchmark import yardstick

PAD, BOS, EOS = 1, 0, 2


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def mct_batch(cfg: dict, tr: dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    """A grid-flattened MCT batch made on the device from ``seed``: BN =
    groups x sample_n captions of 5 .. max_len tokens (BOS, words, EOS,
    pads) over all ``regions`` regions (N(0, 1) features, boxes in [0,
    1)), object labels, and each group's positive."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bn = tr["groups"] * tr["sample_n"]
    s, r = tr["max_len"], tr["regions"]
    lengths = torch.randint(5, s + 1, (bn,), generator=g, device=dev)
    words = torch.randint(4, cfg["n_words"] - 1, (bn, s), generator=g,
                          device=dev)
    at = torch.arange(s, device=dev)[None]
    tokens = torch.where(at < lengths[:, None] - 1, words, PAD)
    tokens = torch.where(at == lengths[:, None] - 1, EOS, tokens)
    tokens[:, 0] = BOS
    return {
        "tokens": tokens,
        "text_len": lengths,
        "feats": torch.randn((bn, r, cfg["img_feat_dim"]), generator=g,
                             device=dev),
        "locs": torch.rand((bn, r, cfg["img_loc_dim"]), generator=g,
                           device=dev),
        "obj_labels": torch.randint(0, cfg["n_obj_classes"], (bn, r),
                                    generator=g, device=dev),
        "img_len": torch.full((bn,), r, dtype=torch.int64, device=dev),
        "pos_label": torch.randint(0, tr["sample_n"], (tr["groups"],),
                                   generator=g, device=dev),
    }


def stream_batch(cfg: dict, tr: dict, seed: int, dev
                 ) -> Dict[str, torch.Tensor]:
    """``batch`` full-length text streams of ``seq_len`` random words."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    b, s = tr["batch"], tr["seq_len"]
    return {"tokens": torch.randint(4, cfg["n_words"] - 1, (b, s),
                                    generator=g, device=dev),
            "lengths": torch.full((b,), s, dtype=torch.int64, device=dev)}


def halve(batch: Dict[str, torch.Tensor], tr: dict) -> Dict[str, torch.Tensor]:
    """The first half of the batch's rows (whole candidate groups): the
    fault of a step that leaves half the batch out."""
    rows = batch["tokens"].shape[0] // 2
    out = {k: v[:rows] for k, v in batch.items() if k != "pos_label"}
    if "pos_label" in batch:
        out["pos_label"] = batch["pos_label"][:rows // tr["sample_n"]]
    return out


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def model_config(cfg: dict, **changes):
    from m3p_tpu_torch.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v)
          for k, v in cfg.items() if k in names}
    kw.update(changes)
    return ModelConfig(**kw)


def port_model(mcfg, weights: Dict[str, torch.Tensor], dev):
    """The port's model with the benchmark's weights."""
    from m3p_tpu_torch.model import M3PModel
    with torch.device("meta"):
        model = M3PModel(mcfg)
    model = model.to_empty(device=dev)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def masking_config(cfg: dict, tr: dict):
    from m3p_tpu_torch.data.masking import MaskingConfig
    mk = tr["masking"]
    return MaskingConfig(word_pred=mk["word_pred"],
                         mask_keep_rand=(mk["mask_rate"], mk["keep_rate"],
                                         mk["rand_rate"]),
                         obj_mask_ratio=mk["obj_pred"],
                         max_pred=mk["max_pred"], n_words=cfg["n_words"],
                         mask_index=cfg["mask_index"])


def port_step(cfg: dict, tr: dict):
    from m3p_tpu_torch.train.steps import (
        make_train_step, mct_pretrain_loss, mlm_loss)
    mask_cfg = masking_config(cfg, tr)
    if tr["objective"] == "mct":
        loss = functools.partial(
            mct_pretrain_loss, mask_cfg=mask_cfg, sample_n=tr["sample_n"],
            lambda_rel=1.0, lambda_mlm=1.0, lambda_mrm=1.0, lambda_mrfr=1.0,
            refine_image=True, deterministic=False,
            pack_ratio=tr["pack_ratio"])
    else:
        loss = functools.partial(mlm_loss, mask_cfg=mask_cfg,
                                 deterministic=False)
    return make_train_step(loss)


def frozen_step(step: Callable) -> Callable:
    """The fault of a step that returns its state unchanged: the loss is
    computed and nothing is updated."""
    def run(state, batch, gens):
        params = [p.detach().clone() for p in state.model.parameters()]
        moments = {k: [t.clone() for t in v]
                   for k, v in state.opt_state.items()}
        count = state.step
        state, metrics = step(state, batch, gens)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), params):
                p.copy_(q)
            for k, v in moments.items():
                for t, q in zip(state.opt_state[k], v):
                    t.copy_(q)
        state.step = count
        return state, metrics
    return run


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def leaf_gaps(prog: Dict[str, float], refs: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, over the reference's norm of the leaf or
    of the median of ``leaves``, whichever is larger."""
    med = statistics.median(refs[k] for k in leaves)
    return {k: abs(prog[k] - refs[k]) / max(refs[k], med) for k in leaves}


def halved(step: Callable, tr: dict) -> Callable:
    """The fault of a step that leaves half of each batch out (the mean is
    taken over the rest)."""
    def run(state, batch, gens):
        return step(state, halve(batch, tr), gens)
    return run


@torch.no_grad()
def restart(state, w0: Dict[str, torch.Tensor], names: List[str]) -> None:
    """Set the train state back to step 0 in place: the weights (and the
    fp32 master) to ``w0``, the moments to zero."""
    params = list(state.model.parameters())
    for n, p in zip(names, params):
        p.copy_(w0[n])
    for key, leaves in state.opt_state.items():
        if key == "master":
            torch._foreach_copy_(leaves, [w0[n] for n in names])
        else:
            torch._foreach_zero_(leaves)
    state.step = 0


def launch_counts() -> Dict[str, int]:
    """The program's counters of attention forward launches by family."""
    from m3p_tpu_torch.ops import attention
    return {"packed": attention.attention_packed.launches,
            "flash": attention.attention_flash.launches}


def run(ctx: Context) -> dict:
    """One run of a training cell.  ``variant`` plants what the limits are
    read against: "control" (the program's int8 path, as the traffic
    file's ``control`` switches it on), "half_batch", "frozen"."""
    dev, variant = ctx.device, ctx.variant
    cfg, tr = ctx.cfg, ctx.traffic
    mcfg = model_config(cfg, **(tr["control"] if variant == "control"
                                else {}))
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    make_batch = mct_batch if tr["objective"] == "mct" else stream_batch
    n_check = tr["check_steps"]
    pool = [make_batch(cfg, tr, sub_seed(ctx.seed, f"batch{i}"), dev)
            for i in range(tr["pool"])]
    w0 = make_weights(cfg, ctx.seed, dev)
    model = port_model(mcfg, w0, dev)
    tx, _ = build_optimizer(tr["optimizer"]["spec"],
                            clip_grad_norm=tr["optimizer"]["clip"])
    state = create_train_state(model, tx)
    step = port_step(cfg, tr)
    if variant == "frozen":
        step = frozen_step(step)
    elif variant == "half_batch":
        step = halved(step, tr)
    names = [n for n, _ in model.named_parameters()]
    b1 = tr["optimizer"]["beta1"]

    # warm-up on the window's shapes, then the same state set back to step
    # 0, so that the window's first steps are the ones checked
    warm = Generators.from_seed(sub_seed(ctx.seed, "warm-up"), dev)
    for i in range(tr["warmup_steps"]):
        state, _ = step(state, pool[i % len(pool)], warm)
    restart(state, w0, names)
    gens = Generators.from_seed(sub_seed(ctx.seed, "generators"), dev)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t0
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
        launched = launch_counts()

    # the window: its first steps are what the reference follows (the
    # loss, the first moment after one step, the master after the last)
    steps, losses = 0, []
    with ctx.measure() as win:
        pending = []
        while True:
            with win.span("step"):
                state, m = step(state, pool[steps % len(pool)], gens)
            steps += 1
            if steps <= n_check:
                losses.append(m["loss"] if "loss" in m else m["mlm"])
            if steps == 1:
                first_mu = {n: t.clone() for n, t in
                            zip(names, state.opt_state["mu"])}
            if steps == n_check:
                with torch.no_grad():
                    targets = state.opt_state.get("master") or list(
                        state.model.parameters())
                    change_norms = torch._foreach_norm(
                        torch._foreach_sub([t.float() for t in targets],
                                           [w0[n] for n in names]))
            if dev == "cuda":
                done = torch.cuda.Event()
                done.record()
                pending.append(done)
                if len(pending) > 2:
                    with win.span("wait"):
                        pending.pop(0).synchronize()
            if (steps >= n_check
                    and time.perf_counter() - win.start >= ctx.seconds):
                break
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    prog_losses = [float(x) for x in torch.stack(losses).float().cpu()]
    prog_change = dict(zip(names, torch.stack(change_norms).cpu().tolist()))
    least, calls = attention_least(cfg, tr)
    if dev == "cuda":
        # the kernels' least time stands only where the program launched
        # the forwards the count has (a later change may take them off)
        now = launch_counts()
        least = {k: v if now[k] - launched[k] == steps * calls[k] else None
                 for k, v in least.items()}

    # the reference, once the program is freed
    del state, model, tx, pool, step, gens, warm, w0
    if dev == "cuda":
        torch.cuda.empty_cache()
    ref_losses, ref_first, ref_change = reference(cfg, tr, ctx.seed, dev)
    prog_grad = {k: float(first_mu.pop(k).float().norm()) / (1 - b1)
                 for k in names}
    ref_grad = {k: float(ref_first.pop(k).norm()) for k in names}
    # the leaves the step trains (a nonzero reference gradient), and of
    # those the ones that move by more than round-off
    trained = [k for k in names if ref_grad[k] > 0]
    med_grad = statistics.median(ref_grad[k] for k in trained)
    moved = [k for k in trained if ref_grad[k] >= 1e-3 * med_grad]
    grad_gaps = leaf_gaps(prog_grad, ref_grad, trained)
    change_gaps = leaf_gaps(prog_change, ref_change, moved)
    readings = {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog_losses, ref_losses)),
        "grad_gap": max(max(grad_gaps.values()),
                        max((prog_grad[k] for k in names if k not in trained),
                            default=0.0) / med_grad),
        "change_gap": max(change_gaps.values())}
    # the numbers the cell compares, each against its limit; the others
    # are read for the record (limits.py)
    checks = [Check(k, readings[k], limit)
              for k, limit in tr["checks"].items()]
    bn = pool_rows(tr)
    per_step_tokens = bn * (tr["regions"] + tr["max_len"]
                            if tr["objective"] == "mct" else tr["seq_len"])
    return {"checks": checks, "attempted": steps, "failed": 0,
            "peak_bytes": peak, "window": ctx.window, "steps": steps,
            "tokens": steps * per_step_tokens, "setup_s": setup_s,
            "flops": steps * step_flops(cfg, tr),
            "attn_least_s": {k: None if v is None else steps * v
                             for k, v in least.items()},
            "losses": prog_losses, "ref_losses": ref_losses,
            "readings": readings,
            "worst": {"grad": max(grad_gaps, key=grad_gaps.get),
                      "change": max(change_gaps, key=change_gaps.get)}}


def pool_rows(tr: dict) -> int:
    if tr["objective"] == "mct":
        return tr["groups"] * tr["sample_n"]
    return tr["batch"]


def step_flops(cfg: dict, tr: dict) -> int:
    mk = tr["masking"]
    if tr["objective"] == "mct":
        return yardstick.mct_step_flops(cfg, pool_rows(tr), tr["max_len"],
                                        tr["regions"], mk["max_pred"],
                                        tr["pack_ratio"])
    slots = tr["batch"] * min(mk["max_pred"], tr["seq_len"])
    return yardstick.mlm_step_flops(cfg, tr["batch"], tr["seq_len"], slots)


def attention_least(cfg: dict, tr: dict
                    ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """The least time of a step's attention calls by kernel family, "packed"
    (#1 forward, #2 backward: up to 512 keys) and "flash" (#5, #6: above),
    and the forward launches of a step by family.  Calls are counted as
    they are launched: under ``remat`` the stack's blocks run their
    forward twice, once in the forward and once in the backward (the
    refiner is not rematerialised)."""
    h = cfg["n_heads"]
    dh = cfg["emb_dim"] // h
    b = pool_rows(tr)
    forwards = 2 if cfg.get("remat") else 1
    calls = []                                # (Sq = Sk, forward launches)
    if tr["objective"] == "mct":
        calls += [(tr["regions"], 1)] * cfg["refine_layers"]
        calls += [(tr["regions"] + tr["max_len"], forwards)] * cfg["n_layers"]
    else:
        calls += [(tr["seq_len"], forwards)] * cfg["n_layers"]
    least = {"packed": 0.0, "flash": 0.0}
    count = {"packed": 0, "flash": 0}
    for s, n_fwd in calls:
        fam = "packed" if s <= 512 else "flash"
        least[fam] += (n_fwd * yardstick.attention_least_s(b, h, s, s, dh,
                                                           False)
                       + yardstick.attention_least_s(b, h, s, s, dh, True))
        count[fam] += n_fwd
    return least, count


def reference(cfg: dict, tr: dict, seed: int, dev
              ) -> Tuple[List[float], Dict[str, float], Dict[str, float]]:
    """The plain reference over the first steps: (losses, the first
    gradient as the optimizer takes it (clipped) by leaf, the change's
    norms by leaf)."""
    make_batch = mct_batch if tr["objective"] == "mct" else stream_batch
    params = make_weights(cfg, seed, dev, requires_grad=True)
    w0 = {k: v.detach().clone() for k, v in params.items()}
    opt = ref.Adam(params, tr["optimizer"])
    draws = ref.StepDraws(sub_seed(seed, "generators"), torch.device(dev))
    mk = dict(tr["masking"], n_words=cfg["n_words"],
              mask_index=cfg["mask_index"])
    losses, first = [], {}
    for i in range(tr["check_steps"]):
        batch = make_batch(cfg, tr, sub_seed(seed, f"batch{i % tr['pool']}"),
                           dev)
        if tr["objective"] == "mct":
            loss, grads = ref.mct_step(cfg, params, batch, draws, mk,
                                       tr["sample_n"], tr["pack_ratio"],
                                       tr["reference_rows"])
        else:
            loss, grads = ref.mlm_step(cfg, params, batch, draws, mk,
                                       tr["reference_rows"])
        losses.append(loss)
        clipped = opt.step({k: v.data for k, v in params.items()}, grads)
        if i == 0:
            first = clipped
        del grads, clipped, batch
    change = {k: float((params[k].detach() - w0[k]).norm()) for k in params}
    return losses, first, change
