"""Rank workers for the port's multi-process CPU tests (no tests here).

`RankPool` starts ``world`` processes, each a gloo rank of one process
group on the CPU, running this file as a script.  They serve tasks until
stopped: the test process writes ``task_<i>.pt`` (a function name of this
module and its keyword arguments) into the pool's directory; every rank
runs ``fn(**kwargs)`` and writes ``result_<i>_<rank>.pt``.  One
process group serves every task of a test module, so a task costs no
torch import.  Nothing here imports JAX or the JAX package: the tests hold
the results against JAX in the test process.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, List

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankPool:
    """``world`` gloo ranks serving tasks (module docstring)."""

    def __init__(self, world: int, workdir: str, timeout_s: float = 300.0):
        self.world = world
        self.dir = workdir
        self.timeout_s = timeout_s
        self.n = 0
        os.makedirs(workdir, exist_ok=True)
        port = _free_port()
        self.procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join(
                           [REPO, os.environ.get("PYTHONPATH", "")]))
            log = open(os.path.join(workdir, f"rank{rank}.log"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), workdir],
                env=env, stdout=log, stderr=subprocess.STDOUT))

    def run(self, fn: str, **kwargs) -> List[Any]:
        """Every rank's result of ``fn(**kwargs)``; raises with the
        ranks' tracebacks if one failed."""
        return self.submit(fn, **kwargs)()

    def submit(self, fn: str, **kwargs):
        """Hand the ranks ``fn(**kwargs)`` and return at once a function
        that waits for their results (as `run` returns them), so the test
        process can work meanwhile."""
        i = self.n
        self.n += 1
        tmp = os.path.join(self.dir, f".task_{i}.pt")
        torch.save({"fn": fn, "kwargs": kwargs}, tmp)
        os.replace(tmp, os.path.join(self.dir, f"task_{i}.pt"))
        return lambda: self._results(i, fn)

    def _results(self, i: int, fn: str) -> List[Any]:
        paths = [os.path.join(self.dir, f"result_{i}_{r}.pt")
                 for r in range(self.world)]
        deadline = time.time() + self.timeout_s
        while not all(os.path.exists(p) for p in paths):
            dead = [r for r, p in enumerate(self.procs)
                    if p.poll() is not None]
            if dead or time.time() > deadline:
                self.close()
                raise RuntimeError(
                    f"task {fn}: rank(s) {dead or 'all'} "
                    f"{'exited' if dead else 'timed out'}:\n" + self.logs())
            time.sleep(0.02)
        results = [torch.load(p, weights_only=False) for p in paths]
        errors = [r["error"] for r in results if "error" in r]
        if errors:
            raise RuntimeError(f"task {fn} failed:\n" + "\n".join(errors))
        return [r["value"] for r in results]

    def logs(self) -> str:
        out = []
        for r in range(self.world):
            with open(os.path.join(self.dir, f"rank{r}.log")) as f:
                out.append(f"--- rank {r} ---\n{f.read()[-4000:]}")
        return "\n".join(out)

    def close(self) -> None:
        stop = os.path.join(self.dir, f"task_{self.n}.pt")
        torch.save({"fn": None}, stop + ".tmp")
        os.replace(stop + ".tmp", stop)
        for p in self.procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _serve(workdir: str) -> None:
    import torch.distributed as dist

    from m3p_tpu_torch.parallel.mesh import auto_init_distributed

    torch.set_num_threads(1)
    auto_init_distributed("cpu", timeout_s=240)
    rank = dist.get_rank()
    i = 0
    while True:
        task_path = os.path.join(workdir, f"task_{i}.pt")
        while not os.path.exists(task_path):
            time.sleep(0.01)
        task = torch.load(task_path, weights_only=False)
        if task["fn"] is None:
            break
        try:
            out = {"value": globals()[task["fn"]](**task["kwargs"])}
        except Exception:
            out = {"error": f"rank {rank}: {traceback.format_exc()}"}
        tmp = os.path.join(workdir, f".result_{i}_{rank}.pt")
        torch.save(out, tmp)
        os.replace(tmp, os.path.join(workdir, f"result_{i}_{rank}.pt"))
        if "error" in out:
            break
        i += 1
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# tasks: fn(**kwargs) on every rank
# ---------------------------------------------------------------------------


def _mesh(**axes):
    from m3p_tpu_torch.config import MeshConfig
    from m3p_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(**{"data": 1, **axes}))


def ring(q, k, v, mask, causal: bool) -> Dict[str, np.ndarray]:
    """Ring attention over the world as one ``seq`` axis: each rank's output
    block and its q/k/v gradient blocks under a fixed upstream gradient."""
    from m3p_tpu_torch.ops.ring_attention import ring_attention

    import torch.distributed as dist

    mesh = _mesh(seq=dist.get_world_size())
    n, i = mesh.shape["seq"], mesh.index("seq")
    w = q.shape[2] // n
    sl = slice(i * w, (i + 1) * w)
    qb, kb, vb = (torch.tensor(a[:, :, sl]).requires_grad_()
                  for a in (q, k, v))
    out = ring_attention(qb, kb, vb, torch.tensor(mask[:, sl]), mesh, "seq",
                         causal=causal)
    g = torch.tensor(np.cos(np.arange(out.numel(), dtype=np.float32)
                            ).reshape(out.shape))
    out.backward(g)
    return {"out": out.detach().numpy(), "dq": qb.grad.numpy(),
            "dk": kb.grad.numpy(), "dv": vb.grad.numpy(), "index": i}


def _model(cfg_dict, state):
    from m3p_tpu_torch.config import ModelConfig
    from m3p_tpu_torch.model import build_model

    model = build_model(ModelConfig(**cfg_dict), 0, "cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in state.items()},
                          strict=True)
    return model


def sp_encode_joint(cfg_dict, state, batch, seq: int) -> np.ndarray:
    """`parallel.sp.seq_parallel_encode_joint` over a ``seq`` mesh."""
    from m3p_tpu_torch.parallel.sp import seq_parallel_encode_joint

    model = _model(cfg_dict, state)
    mesh = _mesh(seq=seq)
    t = {k: torch.tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        out = seq_parallel_encode_joint(model, t["tokens"], t["text_mask"],
                                        t["feats"], t["locs"], t["img_mask"],
                                        mesh)
    return out.numpy()


def sp_itm_step(cfg_dict, state, batch, sample_n: int) -> Dict[str, Any]:
    """One `make_sp_itm_train_step` step over a ``seq`` mesh of the world
    (plain SGD at lr 1, so the update is the averaged gradient): the loss
    and every parameter's gradient."""
    import torch.distributed as dist

    from m3p_tpu_torch.parallel.sp import make_sp_itm_train_step
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    model = _model(cfg_dict, state)
    mesh = _mesh(seq=dist.get_world_size())
    tx, _ = build_optimizer("sgd,lr=1.0", clip_grad_norm=0.0)
    st = create_train_state(model, tx)
    step = make_sp_itm_train_step(model, mesh, sample_n)
    _, metrics = step(st, {k: torch.tensor(v) for k, v in batch.items()})
    return {"loss": float(metrics["loss"]),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()
                      if p.grad is not None}}


def sp_attention_dropout(cfg_dict, state, batch, rates) -> List[np.ndarray]:
    """`SPModel.encode_joint` in a training forward at each attention
    dropout rate (residual dropout 0) from the same generators."""
    import torch.distributed as dist

    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.parallel.sp import SPModel

    outs = []
    mesh = _mesh(seq=dist.get_world_size())
    t = {k: torch.tensor(v) for k, v in batch.items()}
    for rate in rates:
        cfg = dict(cfg_dict, attention_dropout=rate)
        model = SPModel(_model(cfg, state), mesh)
        gen = Generators.from_seed(7, "cpu")
        with torch.no_grad():
            outs.append(model.encode_joint(
                t["tokens"], t["text_mask"], t["feats"], t["locs"],
                t["img_mask"], False, False, gen).numpy())
    return outs


def dropout_masks(seed: int, shape) -> Dict[str, np.ndarray]:
    """This rank's masks: the data-parallel generators (rank folded in)
    and, inside a sharded stack, the shard's (`Generators.fold_in`)."""
    import torch.distributed as dist

    from m3p_tpu_torch.model.layers import Generators, dropout

    rank = dist.get_rank()
    x = torch.ones(shape)
    gen = Generators.from_seed(seed, "cpu", rank)
    dp = dropout(x, 0.5, False, gen).numpy()
    shared = Generators.from_seed(seed, "cpu")
    sp = dropout(x, 0.5, False, shared.fold_in(rank)).numpy()
    return {"dp": dp, "sp": sp,
            "seeds": (gen.attention_seed(), shared.fold_in(rank)
                      .dropout_seed())}


def dp_step(cfg_dict, state, kind: str, batch, spec: str, clip: float,
            masking=None, mesh_axes=None, sample_n: int = 2
            ) -> Dict[str, Any]:
    """One data-parallel step: this rank's shard of the global ``batch``
    through `make_train_step` with ``state.mesh`` set.  ``kind`` "mlm"
    (with the global ``masking`` sharded alike) or "itm".  Returns the loss,
    the grad norm and the updated parameters."""
    import torch.distributed as dist

    from m3p_tpu_torch.data.masking import MaskingConfig
    from m3p_tpu_torch.parallel.sharding import batch_sharding, shard_batch
    from m3p_tpu_torch.train import steps as S
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    model = _model(cfg_dict, state)
    mesh = _mesh(**(mesh_axes or {"data": dist.get_world_size()}))
    sh = batch_sharding(mesh)
    local = shard_batch({k: torch.tensor(v) for k, v in batch.items()}, sh)
    tx, _ = build_optimizer(spec, clip_grad_norm=clip)
    st = create_train_state(model, tx, mesh)
    if kind == "mlm":
        m = tuple(shard_batch(torch.tensor(a), sh) for a in masking)
        mask_cfg = MaskingConfig(n_words=cfg_dict["n_words"],
                                 mask_index=cfg_dict["mask_index"])

        def loss_fn(model_, b, gen):
            return S.mlm_loss(model_, b, None, mask_cfg, deterministic=True,
                              masking=m)
    else:
        def loss_fn(model_, b, gen):
            return S.itm_finetune_loss(model_, b, None, sample_n,
                                       deterministic=True)
    if mesh.shape["seq"] > 1:
        from m3p_tpu_torch.parallel.sp import SPModel

        handle = SPModel(model, mesh)
        inner = loss_fn

        def loss_fn(model_, b, gen):  # noqa: F811
            return inner(handle, b, gen)
    step = S.make_train_step(loss_fn, with_grad_norm=True)
    _, metrics = step(st, local, None)
    return {"loss": float(metrics["loss" if "loss" in metrics else "mlm"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()}}


class RecordRetrieval:
    """Retrieval groups (or, with ``caption``, captioned images) that are
    each a pure function of (seed, key): a batch of n groups is the
    concatenation of its groups, so the halves a 2-rank run takes (every
    other half batch of a seeded order) make up the batches one process
    takes at twice the size."""

    def __init__(self, n: int, sample_n: int, text_len: int, regions: int,
                 n_words: int, seed: int = 0, caption: bool = False):
        self.n, self.seed, self.caption = n, seed, caption
        self.shape = (sample_n, text_len, regions, n_words)

    def __len__(self) -> int:
        return self.n

    def _group(self, key: int) -> Dict[str, np.ndarray]:
        from m3p_tpu_torch.data.synthetic import (make_caption_batch,
                                                  make_retrieval_batch)

        sample_n, text_len, regions, n_words = self.shape
        rng = np.random.RandomState(self.seed * 7919 + key)
        if self.caption:
            return make_caption_batch(rng, 1, text_len, regions, n_words)
        return make_retrieval_batch(rng, 1, sample_n, text_len, regions,
                                    n_words)

    def epoch_iterator(self, batch_size: int, epoch: int = 0):
        order = np.random.RandomState(self.seed + epoch).permutation(self.n)
        for start in range(0, self.n - batch_size + 1, batch_size):
            groups = [self._group(int(k))
                      for k in order[start:start + batch_size]]
            yield {k: np.concatenate([g[k] for g in groups])
                   for k in groups[0]}


def record_data(vocab: str, n_groups: int, caption: bool = False):
    """`LoadedData` of one `RecordRetrieval` task (and, with ``caption``, a
    captioning task of 5-region images) and the vocab's tokenizer."""
    from m3p_tpu_torch.data.loader import LoadedData
    from m3p_tpu_torch.tokenization.tokenizer import XLMRTokenizer

    tok = XLMRTokenizer(vocab)
    datasets = {("rel", "coco"): RecordRetrieval(n_groups, 2, 9, 4,
                                                 tok.vocab_size - 1)}
    if caption:
        datasets[("ic", "coco")] = RecordRetrieval(
            n_groups, 1, 9, 5, tok.vocab_size - 1, seed=1, caption=True)
    return LoadedData(train_datasets=datasets, tokenizer=tok)


def train_main(argv, vocab: str, n_groups: int, caption: bool = False
               ) -> Dict[str, Any]:
    """`cli.train_x.main` on this rank (the process group is the pool's):
    the trained parameters (whole, gathered over a sharded mesh) and the
    trainer's counters."""
    from m3p_tpu_torch.cli import train_x

    from m3p_tpu_torch.parallel.sharding import (
        gather_train_state, model_is_sharded)

    trainer = train_x.main(argv + ["--device", "cpu"],
                           data=record_data(vocab, n_groups, caption))
    params = (gather_train_state(trainer.state)["model"]
              if model_is_sharded(trainer.model)
              else dict(trainer.model.named_parameters()))
    return {"params": {n: params[n].detach().numpy().copy()
                       for n, _ in trainer.model.named_parameters()},
            "n_total_iter": trainer.n_total_iter,
            "shards": (trainer.shard_index, trainer.shard_count),
            "mesh": dict(trainer.mesh.shape),
            "sp": type(trainer.loss_model).__name__}


def merge_scores(n_img: int, n_cap: int) -> np.ndarray:
    """`eval.retrieval.merge_process_scores` of this rank's partial matrix
    (its own entries of a known whole)."""
    import torch.distributed as dist

    from m3p_tpu_torch.eval.retrieval import merge_process_scores

    rank, world = dist.get_rank(), dist.get_world_size()
    whole = np.arange(n_img * n_cap, dtype=np.float32).reshape(n_img, n_cap)
    part = np.where(np.arange(n_img * n_cap).reshape(n_img, n_cap)
                    % world == rank, whole, 0).astype(np.float32)
    return merge_process_scores(part)



def _shard_draws(draws, sh):
    from m3p_tpu_torch.parallel.sharding import shard_batch

    out = {}
    for k, v in draws.items():
        if isinstance(v, (list, tuple)):
            out[k] = [shard_batch(torch.tensor(a), sh) for a in v]
        else:
            out[k] = shard_batch(torch.tensor(v), sh)
    return out


def sharded_step(cfg_dict, state, kind, batch, mesh_axes, spec="sgd,lr=1.0",
                 clip=0.0, draws=None, mask_cfg=None, sample_n: int = 2,
                 seed=None, fault=None, whole=True, guard=False
                 ) -> Dict[str, Any]:
    """One step of ``kind`` ("itm", "mlm" or "mct") on this rank's shard of
    the global ``batch`` over a mesh of ``mesh_axes``, the model sharded
    over its fsdp / tensor / expert axes (`shard_model`, as the trainer
    does).  ``draws``: the maskings (and MCT's coin) of the global batch,
    sharded alike; ``seed``: a training forward (dropout on) from
    generators of that seed with the batch shard folded in, else
    deterministic.  ``fault`` plants one: "row_no_reduce" skips the
    row-parallel all-reduce, "local_ce" takes the vocabulary CE rank-local,
    "inf_grad" puts an inf into rank 0's shard of
    ``block_0.attn.q_lin.weight``'s gradient after the reduction,
    "head_base_0" has every rank call the attention kernels as if its
    heads were the first ones, "heads_to_columns_local" and
    "columns_to_heads_local" take the heads reshard's backward from this
    rank's own part alone (no all-gather, no reduce-scatter).
    ``guard``: the optimizer's non-finite guard.  Returns the loss,
    the grad norm and its dtype, the whole updated parameters and first
    moment (gathered), or this rank's shards when not ``whole``, and
    ``pad_max``: the largest |entry| in the padding of this rank's shards
    of the parameters, gradients and optimizer moments."""
    import torch.distributed as dist

    import contextlib

    from m3p_tpu_torch.data.masking import MaskingConfig
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.parallel import tensor_parallel as TP
    from m3p_tpu_torch.parallel.sharding import (
        batch_sharding, gather_train_state, is_sharded, padding_max,
        shard_batch, shard_model)
    from m3p_tpu_torch.train import steps as S
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    model = _model(cfg_dict, state)
    mesh = _mesh(**mesh_axes)
    if is_sharded(mesh.shape):
        shard_model(model, mesh)
    if fault == "head_base_0":
        for m in model.modules():
            if hasattr(m, "head_base"):
                m.head_base = 0
    sh = batch_sharding(mesh)
    local = shard_batch({k: torch.tensor(v) for k, v in batch.items()}, sh)
    local_draws = _shard_draws(draws or {}, sh)
    tx, _ = build_optimizer(spec, clip_grad_norm=clip, guard_nonfinite=guard)
    st = create_train_state(model, tx, mesh)
    if fault == "inf_grad":
        sync, planted = st.sync_gradients, model.block_0.attn.q_lin.weight

        def sync_then_plant(metrics=None):
            out = sync(metrics)
            if dist.get_rank() == 0:
                planted.grad.view(-1)[0] = float("inf")
            return out

        st.sync_gradients = sync_then_plant
    det = seed is None
    mcfg = MaskingConfig(**(mask_cfg or {}))
    handle = model
    if mesh.shape["seq"] > 1:
        from m3p_tpu_torch.parallel.sp import SPModel

        handle = SPModel(model, mesh)

    def loss_fn(_m, b, gen):
        if kind == "mlm":
            return S.mlm_loss(handle, b, gen, mcfg, deterministic=det,
                              masking=local_draws.get("masking"))
        if kind == "itm":
            return S.itm_finetune_loss(handle, b, gen, sample_n,
                                       deterministic=det)
        return S.mct_pretrain_loss(handle, b, gen, mcfg, sample_n,
                                   deterministic=det, pack_ratio=0.5,
                                   **local_draws)

    gen = None if det else Generators.from_seed(seed, "cpu",
                                                 mesh.batch_shards[0])
    with contextlib.ExitStack() as stack:
        if fault == "row_no_reduce":
            stack.enter_context(_patched(
                "m3p_tpu_torch.model.layers", "reduce_from",
                lambda x, m, a: x if a == "tensor" else TP.reduce_from(
                    x, m, a)))
        elif fault in ("heads_to_columns_local", "columns_to_heads_local"):
            stack.enter_context(_local_reshard_backward(TP, fault))
        elif fault == "local_ce":
            stack.enter_context(_patched(
                S, "vocab_parallel_ce",
                lambda lg, lb, v: TP.vocab_parallel_ce(lg, lb, None)
                if v is None else torch.nn.functional.cross_entropy(
                    lg.float(), v.local(lb)[0], reduction="none")))
        step = S.make_train_step(loss_fn, with_grad_norm=True)
        _, metrics = step(st, local, gen)
    names = [n for n, _ in model.named_parameters()]
    grads = None
    if whole:
        gathered = gather_train_state(st)
        params = gathered["model"]
        mu = gathered["opt_state"].get("mu")
        grads = {n: TP.gather_whole(p.grad, TP.shard_of(p)).float().numpy()
                 for n, p in model.named_parameters() if p.grad is not None}
    else:
        params = {n: p.detach() for n, p in model.named_parameters()}
        mu = st.opt_state.get("mu")
    return {"loss": float(metrics["loss" if "loss" in metrics else "mlm"]),
            "grad_norm": float(metrics["grad_norm"]),
            "grad_norm_dtype": str(metrics["grad_norm"].dtype),
            "pad_max": padding_max(st),
            "params": {n: v.detach().float().numpy().copy()
                       for n, v in params.items()},
            "grads": grads,
            "mu": None if mu is None else {
                n: t.float().numpy().copy() for n, t in zip(names, mu)},
            "local_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters())}


def sharded_q8(cfg_dict, state, mesh_axes, feats, locs, img_len,
               max_len: int) -> Dict[str, Any]:
    """The frozen-weight int8 copy of a model sharded over a mesh of
    ``mesh_axes`` (`quantized_inference_model`, `capture_q8`, as the
    evaluator makes it): this rank's tables in the JAX layout, their
    bytes, this rank's ``tensor`` coordinate, and the greedy captions of an
    image batch through the int8 copy."""
    from m3p_tpu_torch.model import (
        capture_q8, lengths_to_mask, q8_collection,
        quantized_inference_model)
    from m3p_tpu_torch.model.generation import greedy_generate
    from m3p_tpu_torch.ops import quant
    from m3p_tpu_torch.parallel.sharding import shard_model

    model = _model(cfg_dict, state)
    mesh = _mesh(**mesh_axes)
    shard_model(model, mesh)
    q = quantized_inference_model(model)
    nbytes = capture_q8(q)
    mask = lengths_to_mask(torch.tensor(img_len), feats.shape[1])
    quant.zero_counts()
    with torch.no_grad():
        enc = q.encode_image(torch.tensor(feats), torch.tensor(locs), mask)
        greedy = greedy_generate(q, enc, mask, max_len)
    return {"tables": {k: v.numpy() for k, v in q8_collection(q).items()},
            "bytes": nbytes, "tensor_index": mesh.index("tensor"),
            "greedy": [t.numpy() for t in greedy],
            "int8_gemms": quant.int8_matmul_pre.calls
            + quant.int8_matmul_nt_pre.calls}


def int8_ops(case, x, w, g, fault=False) -> Dict[str, np.ndarray]:
    """This rank's part of one int8 training GEMM, forward and backward,
    on its part of the whole operands x, w and upstream gradient g (fp32
    numpy): ``case`` "rows" (`int8_matmul_qbwd` on data 2, each rank half
    of the rows of x (M, K) and g), "nt_rows" (`int8_matmul_nt`, w (N,
    K)), "seq" (`int8_matmul_qbwd` on data 2 x seq 2, x (B, S, K) cut by
    rows over ``data`` and positions over ``seq``), "col" / "row"
    (`int8_matmul_qbwd` on tensor 2 with N / K split), "st_row"
    (`int8_matmul` with K split), "nt_vocab" (`int8_matmul_nt` with the
    vocabulary N split over tensor 2 in the padded layout).  ``fault``
    takes every amax rank-local.  Returns y, dx and dw as this rank
    computed them."""
    import contextlib

    from m3p_tpu_torch.ops import quant
    from m3p_tpu_torch.parallel.data_parallel import batch_reduction

    axes = {"rows": {"data": 2}, "nt_rows": {"data": 2},
            "seq": {"data": 2, "seq": 2}}.get(case, {"tensor": 2})
    mesh = _mesh(**axes)
    x, w, g = (torch.tensor(a) for a in (x, w, g))
    line = (mesh, "tensor")
    if case in ("rows", "nt_rows"):
        half = x.shape[0] // 2
        rows = slice(mesh.index("data") * half, (mesh.index("data") + 1)
                     * half)
        x, g = x[rows], g[rows]
    elif case == "seq":
        b, s = x.shape[0] // 2, x.shape[1] // 2
        d, q = mesh.index("data"), mesh.index("seq")
        x = x[d * b:(d + 1) * b, q * s:(q + 1) * s].reshape(-1, x.shape[-1])
        g = g[d * b:(d + 1) * b, q * s:(q + 1) * s].reshape(-1, g.shape[-1])
    t = mesh.index("tensor")
    if case == "col":
        n = w.shape[1] // 2
        w, g = w[:, t * n:(t + 1) * n], g[:, t * n:(t + 1) * n]
    elif case in ("row", "st_row"):
        k = w.shape[0] // 2
        w, x = w[t * k:(t + 1) * k], x[:, t * k:(t + 1) * k]
    elif case == "nt_vocab":
        c = -(-w.shape[0] // 2)           # the padded layout's shards
        lo, hi = t * c, min((t + 1) * c, w.shape[0])
        w, g = w[lo:hi], g[:, lo:hi]
    x, w = x.contiguous().requires_grad_(), w.contiguous().requires_grad_()
    with contextlib.ExitStack() as stack:
        stack.enter_context(batch_reduction(mesh))
        if fault:
            amax = quant._amax
            stack.enter_context(_patched(
                quant, "_amax", lambda xf, axis, over: amax(xf, axis, None)))
        if case in ("rows", "seq"):
            y = quant.int8_matmul_qbwd(x, w)
        elif case == "nt_rows":
            y = quant.int8_matmul_nt(x, w)
        elif case == "nt_vocab":
            y = quant.int8_matmul_nt(x, w, line)
        elif case == "st_row":
            y = quant.int8_matmul(x, w, line)
        else:
            y = quant.int8_matmul_qbwd(x, w, line if case == "row" else None,
                                       line if case == "col" else None)
        y.backward(g.contiguous())
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dw": w.grad.numpy()}


def int8_modules(cfg_dict, state, case, x, g=None, faults=(None,),
                 mesh_axes=None) -> List[Dict[str, Any]]:
    """This rank's part of one int8 module of a model sharded over
    ``mesh_axes`` (data 2 x tensor 2 by default), as the model wires it,
    forward and backward on this rank's part of the whole input x (M, K)
    and upstream gradient g (fp32 numpy; the rows split over ``data``, the
    columns over ``tensor`` in the padded layout): ``case`` "lin1" / "lin2"
    (the first block's FFN GEMMs, column- / row-parallel `QuantDense`s in
    the model's ``ffn_quant``), "qkv" (its fused int8 Q/K/V, ``int8_all``;
    g (M, 3D) of q, k and v), "head" (the word head under
    ``head_quant="int8_bwd"`` over the vocabulary shards, tied to a table
    of x's width), "q8_lin2" (lin2's frozen-weight int8 table of the
    model's `capture_q8` copy, row- parallel; forward only), "q8_qkv" (the
    fused Q/K/V table of that copy, column-parallel; forward only).  Run
    once for each of ``faults``: None, or a planted one, "amax_local" (the
    amaxes that ``tensor`` splits taken rank-local) or "rows_local" (the
    wgrads' amaxes over this rank's rows alone).  Returns for each run this
    rank's output ``y``, input gradient ``dx`` and weight gradient ``dw``
    (the module's own layout: the Dense's (N, K) weights, the fused Q/K/V's
    three concatenated, the head's table) and its mesh coordinates."""
    import contextlib

    from m3p_tpu_torch.model import capture_q8, quantized_inference_model
    from m3p_tpu_torch.ops import quant
    from m3p_tpu_torch.parallel.data_parallel import batch_reduction
    from m3p_tpu_torch.parallel.sharding import shard_model

    mesh = _mesh(**(mesh_axes or {"data": 2, "tensor": 2}))
    model = _model(cfg_dict, state)
    shard_model(model, mesh)
    block = model.blocks[0]
    coords = {"data": mesh.index("data"), "tensor": mesh.index("tensor")}
    rows = np.array_split(np.arange(len(x)), mesh.shape["data"])[
        coords["data"]]
    x = torch.tensor(x[rows])
    g = None if g is None else torch.tensor(g[rows])

    def mine(a, parts=1):
        """This tensor rank's columns of each of ``parts`` blocks of a, in
        the padded layout (`tensor_parallel.local_slice`)."""
        k, i = mesh.shape["tensor"], coords["tensor"]
        out = []
        for c in a.chunk(parts, dim=-1):
            w = -(-c.shape[-1] // k)
            c = torch.nn.functional.pad(c, (0, w * k - c.shape[-1]))
            out.append(c[..., i * w:(i + 1) * w])
        return torch.cat(out, dim=-1)

    def run():
        if case in ("q8_lin2", "q8_qkv"):
            q = quantized_inference_model(model)
            capture_q8(q)
            with torch.no_grad():
                if case == "q8_lin2":
                    y = q.blocks[0].ffn.q8_lin2(mine(x))
                else:
                    y = q.blocks[0].attn.q8_qkv(x)
            return {"y": y.numpy(), "coords": coords}
        inp, grads = (mine(x) if case == "lin2" else x), [mine(g)]
        if case == "head":
            vocab = model.pred_layer.vocab
            table = torch.tensor(state["text_emb.word.weight"])
            weights = [table[vocab.lo:vocab.lo + vocab.n].requires_grad_()]
        else:
            lins = {"lin1": ["ffn.lin1"], "lin2": ["ffn.lin2"],
                    "qkv": ["attn.q_lin", "attn.k_lin", "attn.v_lin"]}[case]
            weights = [block.get_submodule(n).weight for n in lins]
            for w in weights:
                w.grad = None
        inp = inp.clone().requires_grad_()
        if case == "qkv":
            ys = [y[0] for y in block.attn._fused_int8_qkv(inp[None])]
            grads = [mine(c) for c in g.chunk(3, dim=-1)]
        elif case == "head":
            ys = [model.pred_layer(inp, embedding=weights[0])]
        else:
            ys = [block.get_submodule(lins[0])(inp)]
            grads = [g] if case == "lin2" else grads
        torch.autograd.backward(ys, grads)
        return {"y": torch.cat(ys, dim=-1).detach().numpy(),
                "dx": inp.grad.numpy(),
                "dw": torch.cat([w.grad for w in weights]).numpy(),
                "coords": coords}

    out = []
    for fault in faults:
        with contextlib.ExitStack() as stack:
            stack.enter_context(batch_reduction(mesh))
            if fault == "amax_local":
                amax = quant._amax
                stack.enter_context(_patched(
                    quant, "_amax", lambda xf, axis, over: amax(
                        xf, axis, None if over and over[1] == "tensor"
                        else over)))
            elif fault == "rows_local":
                stack.enter_context(_patched(quant, "batch_line",
                                             lambda: None))
            out.append(run())
    return out


def sharded_grid(cfg_dict, state, mesh_axes, pool, cap_to_img,
                 chunk_size: int = 4) -> Dict[str, Any]:
    """`Evaluator.evaluate_retrieval_test` on a model sharded over a mesh
    of ``mesh_axes``: its R@k and the merged score matrix it took them
    from."""
    from m3p_tpu_torch.config import ModelConfig, TrainConfig
    from m3p_tpu_torch.eval import evaluator as E
    from m3p_tpu_torch.parallel.sharding import shard_model

    model = _model(cfg_dict, state)
    shard_model(model, _mesh(**mesh_axes))
    seen = {}
    recall = E.recall_at_k

    def keep(scores, c2i):
        seen["scores"] = np.asarray(scores)
        return recall(scores, c2i)

    cap_tokens, cap_len, feats, locs, img_len = pool
    with _patched(E, "recall_at_k", keep):
        r = E.Evaluator(model, TrainConfig(model=ModelConfig(**cfg_dict))
                        ).evaluate_retrieval_test(
            cap_tokens, cap_len, cap_to_img, feats, locs, img_len,
            chunk_size=chunk_size)
    return {"recall": r, "scores": seen["scores"]}


def sharded_decode(cfg_dict, state, mesh_axes, feats, locs, img_len,
                   max_len: int, beam: int) -> Dict[str, Any]:
    """Greedy and beam captions of an image batch on a model sharded over a
    mesh of ``mesh_axes`` (the decode cache holds this rank's heads, a
    step's logits are gathered over ``tensor``), with the scores of each
    step's last greedy logits."""
    from m3p_tpu_torch.model import lengths_to_mask
    from m3p_tpu_torch.model.generation import beam_search, greedy_generate
    from m3p_tpu_torch.parallel.sharding import shard_model

    model = _model(cfg_dict, state)
    shard_model(model, _mesh(**mesh_axes))
    mask = lengths_to_mask(torch.tensor(img_len), feats.shape[1])
    with torch.no_grad():
        enc = model.encode_image(torch.tensor(feats), torch.tensor(locs),
                                 mask)
        greedy = greedy_generate(model, enc, mask, max_len)
        beams = beam_search(model, enc, mask, beam, max_len)
    return {"greedy": [t.numpy() for t in greedy],
            "beam": [t.numpy() for t in beams], "enc": enc.numpy()}


@contextlib.contextmanager
def _local_reshard_backward(TP, fault):
    """The heads reshard's backward (``fault``: of `heads_to_columns` or of
    `columns_to_heads`) without its collective: this rank's own columns
    or heads alone, the other ranks' parts taken as zeros."""
    def own_heads(block, layout):           # in place of _gather_heads
        k = layout.mesh.shape["tensor"]
        whole = block.new_zeros(block.shape[0], k * layout.width)
        i = layout.mesh.index("tensor")
        whole[:, i * layout.width:(i + 1) * layout.width] = block
        return whole[:, layout.columns]

    def own_columns(block, layout):         # in place of _scatter_heads
        k = layout.mesh.shape["tensor"]
        whole = block.new_zeros(block.shape[0], k * layout.width)
        whole[:, layout.columns] = block
        i = layout.mesh.index("tensor")
        return whole[:, i * layout.width:(i + 1) * layout.width]

    def heads_to_columns(ctx, grad):
        layout = ctx.layout
        block = own_heads(grad.reshape(-1, layout.width), layout)
        return None, block.reshape(ctx.shape)

    def columns_to_heads(ctx, *grads):
        layout = ctx.layout
        block = TP._rows(grads, layout.n * layout.head_dim)
        return (None,) + TP._unrows(own_columns(block, layout), ctx.shapes)

    cls, fn = ((TP._HeadsToColumns, heads_to_columns)
               if fault == "heads_to_columns_local"
               else (TP._ColumnsToHeads, columns_to_heads))
    old = vars(cls)["backward"]
    cls.backward = staticmethod(fn)
    try:
        yield
    finally:
        cls.backward = old


@contextlib.contextmanager
def _patched(owner, name, value):
    import importlib

    if isinstance(owner, str):
        owner = importlib.import_module(owner)
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def checkpoint_trip(cfg_dict, state, mesh_axes, path, spec="adam,lr=0.01",
                    save: bool = True) -> Dict[str, Any]:
    """A whole train state placed on the mesh (`shard_train_state`), after
    one Adam update of planted gradients saved to ``path`` (``save``), or
    restored from it: the whole parameters and optimizer moments this rank
    sees, gathered."""
    from m3p_tpu_torch import checkpoint as ckpt
    from m3p_tpu_torch.parallel.sharding import (
        gather_train_state, shard_train_state)
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    model = _model(cfg_dict, state)
    mesh = _mesh(**mesh_axes)
    tx, _ = build_optimizer(spec)
    st, specs = shard_train_state(create_train_state(model, tx), mesh)
    assert len(specs["opt_state"]["mu"]) == len(specs["params"])
    if save:
        for i, p in enumerate(model.parameters()):
            p.grad = torch.full_like(p, 0.01 * (i % 7 + 1))
        st.apply_gradients()
        ckpt.save_checkpoint(path, st, {"epoch": 3})
    else:
        st, _ = ckpt.restore_checkpoint(path, st)
    got = gather_train_state(st)
    return {"step": st.step,
            "model": {k: v.numpy() for k, v in got["model"].items()},
            "mu": [t.numpy() for t in got["opt_state"]["mu"]],
            "nu": [t.numpy() for t in got["opt_state"]["nu"]]}


def pp_schedule(x, w1, w2, upstream) -> Dict[str, Any]:
    """`parallel.pipeline.spmd_pipeline` over the world as one ``pp`` line,
    stage s an MLP block ``h + gelu(h w1[s]) w2[s]`` on x's microbatches,
    under the upstream gradient ``upstream``: the outputs and this rank's
    gradients of x and of every stage's weights."""
    import torch.distributed as dist

    from m3p_tpu_torch.parallel.pipeline import spmd_pipeline

    mesh = _mesh(pp=dist.get_world_size())
    s = mesh.index("pp")
    xs = torch.tensor(x).requires_grad_()
    ws = [torch.tensor(w).requires_grad_() for w in (w1, w2)]

    def stage_fn(h, m):
        return h + torch.nn.functional.gelu(h @ ws[0][s]) @ ws[1][s]

    out = spmd_pipeline(stage_fn, xs.unbind(0), mesh, "pp",
                        params=list(ws))
    out.backward(torch.tensor(upstream))
    return {"out": out.detach().numpy(), "dx": xs.grad.numpy(),
            "dw1": ws[0].grad.numpy(), "dw2": ws[1].grad.numpy()}


def pp_encode(cfg_dict, state, batch, n_micro: int) -> Dict[str, Any]:
    """Over the world as one ``pp`` line: `pipelined_encode_joint` (the
    refiner on), and `PPModel`'s non-causal ``encode_text`` and
    ``encode_image`` (with ``refine_encoder``)."""
    import torch.distributed as dist

    from m3p_tpu_torch.parallel.pipeline import (PPModel,
                                                 pipelined_encode_joint)

    model = _model(cfg_dict, state)
    mesh = _mesh(pp=dist.get_world_size())
    t = {k: torch.tensor(v) for k, v in batch.items()}
    handle = PPModel(model, mesh, n_microbatches=n_micro)
    with torch.no_grad():
        joint = pipelined_encode_joint(
            model, t["tokens"], t["text_mask"], t["feats"], t["locs"],
            t["img_mask"], mesh, n_microbatches=n_micro, refine_image=True)
        text = handle.encode_text(t["tokens"], t["text_mask"])
        image = handle.encode_image(t["feats"], t["locs"], t["img_mask"],
                                    refine_image=True, refine_encoder=True)
    return {"joint": joint.numpy(), "text": text.numpy(),
            "image": image.numpy()}


def pp_itm_step(cfg_dict, state, batch, mesh_axes, n_micro: int,
                sample_n: int = 2, spec="sgd,lr=1.0", seed=None,
                fault=None) -> Dict[str, Any]:
    """One ITM step on this rank's batch shard over a mesh of ``mesh_axes``
    with the stack pipelined over ``pp``: `make_pp_itm_train_step`, or
    with ``seed`` a training forward through `PPModel` (as the trainer
    swaps it in) from generators of that seed with the batch shard folded
    in.  ``fault``
    "pp_no_reduce" leaves ``pp`` out of the gradient reduction.  Returns
    the loss and every parameter's reduced gradient (gathered whole over
    a sharded mesh)."""
    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.parallel import data_parallel as DP
    from m3p_tpu_torch.parallel.pipeline import (PPModel,
                                                 make_pp_itm_train_step)
    from m3p_tpu_torch.parallel import tensor_parallel as TP
    from m3p_tpu_torch.parallel.sharding import (
        batch_sharding, is_sharded, shard_batch, shard_model)
    from m3p_tpu_torch.train import steps as S
    from m3p_tpu_torch.train.optim import build_optimizer
    from m3p_tpu_torch.train.state import create_train_state

    model = _model(cfg_dict, state)
    mesh = _mesh(**mesh_axes)
    if is_sharded(mesh.shape):
        shard_model(model, mesh)
    local = shard_batch({k: torch.tensor(v) for k, v in batch.items()},
                        batch_sharding(mesh))
    tx, _ = build_optimizer(spec)
    st = create_train_state(model, tx)
    gen = None
    if seed is None:
        step = make_pp_itm_train_step(model, mesh, sample_n,
                                      n_microbatches=n_micro)
    else:
        st.mesh = mesh
        gen = Generators.from_seed(seed, "cpu", mesh.batch_shards[0])
        handle = PPModel(model, mesh, n_microbatches=n_micro)
        step = S.make_train_step(lambda _m, b, g: S.itm_finetune_loss(
            handle, b, g, sample_n, deterministic=False))
    axes = (tuple(a for a in DP.GRAD_AXES if a != "pp")
            if fault == "pp_no_reduce" else DP.GRAD_AXES)
    with _patched(DP, "GRAD_AXES", axes):
        _, metrics = step(st, local, gen)
    return {"loss": float(metrics["loss"]),
            "grads": {n: TP.gather_whole(p.grad, TP.shard_of(p)).numpy()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "stage": mesh.index("pp")}


def pp_dropout(cfg_dict, state, x, mask, n_micro: int, seeds
               ) -> List[np.ndarray]:
    """`pp_run_blocks` in a training forward over the world as one ``pp``
    line, once from generators of each of ``seeds``."""
    import torch.distributed as dist

    from m3p_tpu_torch.model.layers import Generators
    from m3p_tpu_torch.parallel.pipeline import pp_run_blocks

    model = _model(cfg_dict, state)
    mesh = _mesh(pp=dist.get_world_size())
    outs = []
    with torch.no_grad():
        for seed in seeds:
            outs.append(pp_run_blocks(
                model, torch.tensor(x), torch.tensor(mask), mesh, "pp",
                n_micro, False, Generators.from_seed(seed, "cpu")).numpy())
    return outs


if __name__ == "__main__":
    _serve(sys.argv[1])
