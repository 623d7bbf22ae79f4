"""The process group and the device mesh of the port (counterpart of
`m3p_tpu/parallel/mesh.py`).

The JAX package runs one program over a `jax.sharding.Mesh` of devices.
The port runs one process per rank, each driving one card (or the CPU),
joined by `torch.distributed`, as the reference does
(its `src/slurm.py:46-170`):

* `auto_init_distributed` reads the launcher's environment -- torchrun's
  ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
  ``MASTER_PORT``, or SLURM's ``SLURM_PROCID`` / ``SLURM_NTASKS`` /
  ``SLURM_LOCALID`` -- and joins the process group; on one process it does
  nothing.  Rank ``r`` drives card ``LOCAL_RANK % torch.cuda.device_count()``.
* `choose_backend` is the one rule for the backend: ``nccl`` when every
  rank on a node has a card of its own, ``gloo`` when ranks share a card
  (NCCL refuses two ranks of one communicator on one card) and on the CPU.
  Asking for ``nccl`` with shared cards raises.  Nothing retries with
  another backend after a failure.
* `make_mesh` lays the ranks out over the six named axes `AXES` in row-major
  order (as the JAX package reshapes its device list) and makes one process
  group per axis and coordinate of the other axes.  `Mesh.group(axis)` is
  the group of this rank's ``axis``; `Mesh.index(axis)` its coordinate.
* A group may also span several axes (`GROUPED`): ``mesh.group(("data",
  "fsdp"))`` is the line of ranks that differ only in those axes, in
  row-major order of their coordinates (ascending global rank), as a JAX
  collective over a tuple of axis names spans them.
* The collectives (`all_reduce_sum`, `all_reduce_max`, `all_gather_cat`,
  `all_gather_stack`, `reduce_scatter_sum`, `broadcast_`) take a tensor on
  any device: NCCL takes only tensors on the card, so under ``nccl`` a
  host tensor goes to the mesh's card and its result comes back; gloo
  takes host and CUDA tensors alike (torch 2.11's gloo runs all_reduce,
  all_gather_into_tensor and reduce_scatter_tensor on CUDA tensors in fp32
  and bf16: `parallel.probe_gloo`).  A collective the backend refuses
  raises; nothing falls back.  `COLLECTIVE_BYTES` counts the bytes each
  kind handles.  Gloo's point-to-point takes no CUDA tensor, so
  `exchange` stages those through pinned host buffers;
  `HOST_STAGED_BYTES` counts the bytes so staged.

`bind_axes` binds the mesh axis a sharded stack runs over for a block of
code, as `shard_map` binds axis names in JAX: `bound_seq_axis` returns it
there, and the layers' self-attention then runs the ring
(`parallel/sp.py`).
"""

from __future__ import annotations

import contextlib
import logging
import os
from datetime import timedelta
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from m3p_tpu_torch.config import MeshConfig

logger = logging.getLogger("m3p_tpu_torch")

AXES = ("data", "fsdp", "seq", "tensor", "expert", "pp")

# the axis tuples a group spans (besides each axis alone): the batch shards,
# the axes a gradient is reduced over, and the axes a parameter is sharded
# over (`parallel.sharding`)
GROUPED = (("data", "fsdp"), ("data", "seq"), ("data", "fsdp", "seq"),
           ("data", "pp"), ("data", "fsdp", "pp"),
           ("fsdp", "tensor", "expert"), ("tensor", "expert"))

# bytes copied between a card and pinned host memory for gloo's
# point-to-point (`exchange`)
HOST_STAGED_BYTES = {"to_host": 0, "to_device": 0}

# bytes `exchange` sent and received on this rank
P2P_BYTES = {"sent": 0, "received": 0}

# bytes each kind of collective handled on this rank: the tensor an
# all-reduce sums, the whole tensor an all-gather assembles, the whole
# input a reduce-scatter sums
COLLECTIVE_BYTES = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
                    "broadcast": 0}


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def launch_env() -> Dict[str, int]:
    """(rank, world_size, local_rank, local_world_size) from torchrun's
    environment, else SLURM's, else a single process."""
    world = _env_int("WORLD_SIZE", "SLURM_NTASKS") or 1
    rank = _env_int("RANK", "SLURM_PROCID") or 0
    local_rank = _env_int("LOCAL_RANK", "SLURM_LOCALID")
    local_world = _env_int("LOCAL_WORLD_SIZE", "SLURM_NTASKS_PER_NODE")
    return {"rank": rank, "world_size": world,
            "local_rank": rank if local_rank is None else local_rank,
            "local_world_size": world if local_world is None else local_world}


def choose_backend(device_type: str, local_world_size: int,
                   n_cards: int, requested: Optional[str] = None) -> str:
    """The backend of the process group, by a fixed rule: ``gloo`` on the
    CPU; on CUDA ``nccl`` when every rank on the node has a card of its own
    (``local_world_size <= n_cards``), ``gloo`` when ranks share a card.
    ``requested`` ``nccl`` with shared cards raises, because NCCL refuses two
    ranks of one communicator on the same card."""
    if device_type != "cuda":
        rule = "gloo"
    else:
        rule = "nccl" if local_world_size <= n_cards else "gloo"
    if requested is None or requested == rule:
        return rule
    if requested == "nccl":
        raise ValueError(
            f"backend nccl asked for {local_world_size} ranks on a node "
            f"with {n_cards} card(s) on {device_type}: NCCL needs a card "
            "per rank; the rule picks gloo here")
    if requested == "gloo":
        return "gloo"
    raise ValueError(f"unknown backend {requested!r}; known: nccl, gloo")


def local_device(device_type: str, local_rank: int) -> torch.device:
    """This rank's device: card ``local_rank % device_count`` on CUDA."""
    if device_type != "cuda":
        return torch.device(device_type)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "CUDA requested but no card is visible; pass --device cpu to "
            "run the ranks on the CPU")
    dev = torch.device("cuda", local_rank % n)
    torch.cuda.set_device(dev)
    return dev


def auto_init_distributed(device_type: str = "cuda",
                          backend: Optional[str] = None,
                          timeout_s: float = 1800.0) -> bool:
    """Join the process group the launcher's environment describes
    (`launch_env`); the analog of the JAX package's `auto_init_distributed`
    and of the reference's SLURM / ``torch.distributed.launch`` init.
    Returns True when a group of more than one process was joined; on one
    process (or an already initialised group) it does nothing.  The card is
    chosen (`local_device`) and the backend logged."""
    env = launch_env()
    if env["world_size"] <= 1 or dist.is_initialized():
        return dist.is_initialized()
    local_device(device_type, env["local_rank"])
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    chosen = choose_backend(device_type, env["local_world_size"], n_cards,
                            backend)
    os.environ.setdefault("MASTER_ADDR", os.environ.get(
        "SLURM_LAUNCH_NODE_IPADDR", "127.0.0.1"))
    os.environ.setdefault("MASTER_PORT", "29500")
    dist.init_process_group(chosen, init_method="env://",
                            rank=env["rank"], world_size=env["world_size"],
                            timeout=timedelta(seconds=timeout_s))
    logger.info("process group: rank %d of %d (local %d of %d), backend %s, "
                "%s", env["rank"], env["world_size"], env["local_rank"],
                env["local_world_size"], chosen,
                f"{n_cards} card(s)" if device_type == "cuda" else "CPU")
    return True


def infer_mesh_shape(n_devices: int, cfg: Optional[MeshConfig] = None
                     ) -> Tuple[int, ...]:
    """Resolve (data, fsdp, seq, tensor, expert, pp) sizes; -1 absorbs the
    rest."""
    cfg = cfg or MeshConfig()
    sizes = [cfg.data, cfg.fsdp, cfg.seq, cfg.tensor, cfg.expert,
             getattr(cfg, "pp", 1)]
    fixed = 1
    free = None
    for i, s in enumerate(sizes):
        if s == -1:
            assert free is None, "only one mesh axis may be -1"
            free = i
        else:
            fixed *= s
    if free is not None:
        assert n_devices % fixed == 0, (n_devices, sizes)
        sizes[free] = n_devices // fixed
    else:
        assert fixed == n_devices, (n_devices, sizes)
    return tuple(sizes)


class Mesh:
    """The ranks of the process group laid out over `AXES`.  ``shape``
    maps each axis to its size, as `jax.sharding.Mesh.shape` does."""

    def __init__(self, sizes: Sequence[int], rank: int,
                 device: torch.device, backend: Optional[str]):
        if backend == "nccl" and device.type == "cpu":
            raise ValueError("a mesh over nccl needs its card as its device: "
                             "NCCL takes no host tensor")
        self.shape: Dict[str, int] = dict(zip(AXES, (int(s) for s in sizes)))
        self.size = int(np.prod(sizes))
        self.rank = rank
        self.device = device
        self.backend = backend
        self.coords = dict(zip(AXES, (int(c) for c in np.unravel_index(
            rank, tuple(sizes)))))
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._ranks: Dict[Tuple[str, ...], List[int]] = {}
        grid = np.arange(self.size).reshape(tuple(sizes))
        for axes in [(a,) for a in AXES] + list(GROUPED):
            # a tuple's group spans its axes of size > 1 (`_live`)
            live = tuple(a for a in axes if self.shape[a] > 1)
            if not live or live in self._ranks:
                continue
            axes = live
            # every line of the grid over these axes gets a group; each rank
            # makes all of them, in the same order, as new_group requires
            idx = [AXES.index(a) for a in axes]
            n = int(np.prod([self.shape[a] for a in axes]))
            lines = np.moveaxis(grid, idx, list(range(-len(idx), 0))
                                ).reshape(-1, n)
            for line in lines:
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    self._groups[axes] = group
                    self._ranks[axes] = ranks

    def _live(self, axes) -> Tuple[str, ...]:
        """``axes`` (one name or a tuple) less the axes of size 1."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"unknown mesh axis {a!r}; known: {AXES}")
        return tuple(a for a in axes if self.shape[a] > 1)

    def index(self, axes) -> int:
        """This rank's coordinate along ``axes`` (row-major over a tuple)."""
        out = 0
        for a in self._live(axes):
            out = out * self.shape[a] + self.coords[a]
        return out

    def count(self, axes) -> int:
        """The number of ranks of a line over ``axes``."""
        return int(np.prod([self.shape[a] for a in self._live(axes)]))

    def group(self, axes):
        """The process group of this rank's line over ``axes`` (one axis or
        a tuple of `GROUPED`); None when the line is this rank alone."""
        live = self._live(axes)
        if not live:
            return None
        if live not in self._groups:
            raise ValueError(f"no group over {live}: a group spans one axis "
                             f"or the live axes of one of {GROUPED}")
        return self._groups[live]

    def ranks(self, axes) -> List[int]:
        """The global ranks of this rank's line over ``axes``, by
        coordinate."""
        live = self._live(axes)
        return self._ranks[live] if live else [self.rank]

    def neighbor(self, axis: str, offset: int) -> int:
        """The global rank ``offset`` steps along ``axis`` (cyclic)."""
        line = self.ranks(axis)
        return line[(self.coords[axis] + offset) % len(line)]

    @property
    def batch_shards(self) -> Tuple[int, int]:
        """(index, count) of this rank's shard of a global batch over
        ("data", "fsdp"): ranks that differ only in other axes hold the same
        rows."""
        count = self.shape["data"] * self.shape["fsdp"]
        return (self.coords["data"] * self.shape["fsdp"]
                + self.coords["fsdp"], count)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")


_CURRENT: List[Mesh] = []


def make_mesh(cfg: Optional[MeshConfig] = None,
              device: Optional[torch.device] = None) -> Mesh:
    """The mesh over the ranks of the process group (one rank outside a
    group) whose tensors live on ``device`` (by default this rank's card
    under nccl, else the CPU), made the process's current mesh
    (`current_mesh`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    backend = dist.get_backend() if dist.is_initialized() else None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    mesh = Mesh(infer_mesh_shape(world, cfg), rank, torch.device(device),
                backend)
    _CURRENT[:] = [mesh]
    return mesh


def current_mesh() -> Optional[Mesh]:
    """The mesh `make_mesh` made last in this process, if any."""
    return _CURRENT[0] if _CURRENT else None


def batch_shards() -> Tuple[int, int]:
    """(index, count) of this process's shard of a global batch: from the
    current mesh, else the process group's (rank, world size), else (0, 1)."""
    mesh = current_mesh()
    if mesh is not None:
        return mesh.batch_shards
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


_BOUND: List[Tuple[Mesh, str]] = []


@contextlib.contextmanager
def bind_axes(mesh: Mesh, axis: str = "seq") -> Iterator[Mesh]:
    """Bind ``mesh``'s ``axis`` as the one a sharded stack runs over inside
    the block (`bound_seq_axis`), as `shard_map` binds axis names for the
    JAX layers."""
    if axis not in mesh.shape:
        raise ValueError(f"unknown mesh axis {axis!r}; known: {AXES}")
    _BOUND.append((mesh, axis))
    try:
        yield mesh
    finally:
        _BOUND.pop()


def bound_seq_axis() -> Optional[Tuple[Mesh, str]]:
    """(mesh, axis) that `bind_axes` bound, innermost first; None outside."""
    return _BOUND[-1] if _BOUND else None


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _for_backend(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` contiguous where the backend takes it: under nccl on the mesh's
    card (NCCL takes no host tensor); gloo takes it where it is."""
    t = t.contiguous()
    if mesh.backend == "nccl" and t.device != mesh.device:
        return t.to(mesh.device)
    return t


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (the whole mesh when None), a new
    tensor on ``t``'s device."""
    return _all_reduce(t, mesh, group, dist.ReduceOp.SUM)


def all_reduce_max(t: torch.Tensor, mesh: Mesh, group=None) -> torch.Tensor:
    """The elementwise max of ``t`` over ``group``, a new tensor."""
    return _all_reduce(t, mesh, group, dist.ReduceOp.MAX)


def _all_reduce(t, mesh, group, op):
    buf = _for_backend(t, mesh)
    if buf is t:
        buf = t.clone()
    COLLECTIVE_BYTES["all_reduce"] += buf.numel() * buf.element_size()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(t.device)


def all_gather_stack(t: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``t`` of every rank of this rank's line over ``axes``, stacked along
    a new leading dimension in coordinate order (one
    ``all_gather_into_tensor``; every rank's ``t`` has one shape)."""
    group = mesh.group(axes)
    if group is None:
        return t[None]
    buf = _for_backend(t, mesh)
    n = mesh.count(axes)
    # gloo takes the flat form: the ranks' tensors end to end
    out = torch.empty(n * buf.numel(), dtype=buf.dtype, device=buf.device)
    COLLECTIVE_BYTES["all_gather"] += out.numel() * out.element_size()
    dist.all_gather_into_tensor(out, buf.reshape(-1), group=group)
    return out.view((n,) + tuple(buf.shape)).to(t.device)


def all_gather_cat(t: torch.Tensor, mesh: Mesh, axes,
                   dim: int = 0) -> torch.Tensor:
    """``t`` of every rank of this rank's line over ``axes``, concatenated
    along ``dim`` in coordinate order (same shape on every rank)."""
    group = mesh.group(axes)
    if group is None:
        return t
    buf = _for_backend(t, mesh)
    parts = [torch.empty_like(buf) for _ in mesh.ranks(axes)]
    COLLECTIVE_BYTES["all_gather"] += (len(parts) * buf.numel()
                                       * buf.element_size())
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_scatter_sum(t: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """``t`` (n, ...) with n the line's length over ``axes``: the sum over
    the line's ranks of their ``t[i]``, on rank i (one
    ``reduce_scatter_tensor``)."""
    group = mesh.group(axes)
    if group is None:
        return t[0]
    buf = _for_backend(t, mesh)
    out = torch.empty(buf[0].numel(), dtype=buf.dtype, device=buf.device)
    COLLECTIVE_BYTES["reduce_scatter"] += buf.numel() * buf.element_size()
    dist.reduce_scatter_tensor(out, buf.reshape(-1), group=group)
    return out.view(tuple(buf.shape[1:])).to(t.device)


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0,
               group=None) -> torch.Tensor:
    """Overwrite ``t`` in place with global rank ``src``'s values (over
    ``group``, the whole mesh when None)."""
    buf = _for_backend(t, mesh)
    COLLECTIVE_BYTES["broadcast"] += buf.numel() * buf.element_size()
    dist.broadcast(buf, src=src, group=group)
    if buf is not t:
        t.copy_(buf)
    return t


# ---------------------------------------------------------------------------
# point-to-point
# ---------------------------------------------------------------------------


class PinnedBuffers:
    """Pinned host buffers by (key, shape, dtype), reused: pinning is slow
    to allocate."""

    def __init__(self):
        self._buffers: Dict[Tuple, torch.Tensor] = {}

    def get(self, key: Tuple, like: torch.Tensor) -> torch.Tensor:
        full = key + (tuple(like.shape), like.dtype)
        buf = self._buffers.get(full)
        if buf is None:
            buf = self._buffers[full] = torch.empty(
                like.shape, dtype=like.dtype, pin_memory=True)
        return buf


class Exchange:
    """Sends and receives of one `exchange`, in flight; `wait` returns the
    received tensors on the devices of the tensors sent."""

    def __init__(self, works, recvs):
        self.works = works
        self.recvs = recvs

    def wait(self) -> List[torch.Tensor]:
        for w in self.works:
            w.wait()
        out = []
        for recv, like in self.recvs:
            if recv.device != like.device:
                HOST_STAGED_BYTES["to_device"] += (recv.numel()
                                                   * recv.element_size())
                recv = recv.to(like.device)
            out.append(recv)
        return out


def exchange(tensors: Sequence[torch.Tensor], dst: Optional[int],
             src: Optional[int], group, backend: Optional[str],
             staging: Optional[PinnedBuffers] = None,
             key: Tuple = ()) -> Exchange:
    """Send ``tensors`` to global rank ``dst`` and receive as many of the
    same shapes from ``src``, asynchronously (one
    `torch.distributed.batch_isend_irecv`); ``dst`` None sends nothing,
    ``src`` None receives nothing (the ends of a line), and ``tensors``
    then only give the shapes.  Under gloo a CUDA tensor travels through
    ``staging``'s pinned buffers, one to send and one to receive per
    (``key``, position): read the received tensor (`wait` copies it to the
    card) before the next exchange of that key."""
    ops, recvs = [], []
    for i, t in enumerate(tensors):
        t = t.contiguous()
        nbytes = t.numel() * t.element_size()
        staged = backend == "gloo" and t.is_cuda
        if dst is not None:
            send = t
            if staged:
                send = staging.get(key + (i, "send"), t)
                send.copy_(t)
                HOST_STAGED_BYTES["to_host"] += nbytes
            P2P_BYTES["sent"] += nbytes
            ops.append(dist.P2POp(dist.isend, send, dst, group))
        if src is not None:
            recv = (staging.get(key + (i, "recv"), t) if staged
                    else torch.empty_like(t))
            P2P_BYTES["received"] += nbytes
            ops.append(dist.P2POp(dist.irecv, recv, src, group))
            recvs.append((recv, t))
    return Exchange(dist.batch_isend_irecv(ops), recvs)
