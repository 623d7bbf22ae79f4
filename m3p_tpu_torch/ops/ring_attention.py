"""Ring attention: self-attention over a sequence sharded along a mesh axis
(counterpart of `m3p_tpu/ops/ring_attention.py`).

Each rank of the axis holds a (B, H, S_local, Dh) block of queries, keys
and values.  The key/value blocks travel around the ring (rank i sends to
i + 1) while each rank folds every block into online-softmax statistics for
its own queries, in fp32, with the JAX function's mask value
`DEFAULT_MASK_VALUE` and its global causal positions (block ``src`` holds
keys ``src * S_local + arange(S_local)``).  A row with no valid key gets
``l == 0 -> 1`` and stays finite (`ring_attention.py:89-92`).  The JAX loop
rotates once more after its last block; that rotation changes nothing and is
skipped here.

The backward is a second trip around the ring (`RingAttention`): the
key/value blocks travel again, each with its partial dK/dV, which arrive
back at the block's home rank after n hops; dQ stays local.  Each rank
adds its share in fp32; the partials travel in the keys' dtype, as the
cotangents of the JAX ring's `ppermute` do.  The
forward saves q, k, v, the output and the row statistics m and l (kept
apart: at the mask value, m + log l rounds to m in fp32).  Torch's
point-to-point operations are not autograd-aware, so the backward is
written out, not left to autograd.

Transport: `parallel.mesh.exchange` (one
`torch.distributed.batch_isend_irecv`) of each rotation, started before the
block's products so that it overlaps them.  Under the gloo backend CUDA
tensors travel through pinned host buffers (one to send, one to receive per
kind of message: the double buffers), because gloo's point-to-point takes
no CUDA tensor.  `RING_BYTES` counts the bytes each rank sends.

The block products are `torch.matmul`, as the JAX ring's are
`jnp.einsum` (its sequence-parallel path turns the Pallas kernels off,
`m3p_tpu/parallel/sp.py:68-69`): scores in fp32, the probabilities cast to
the values' dtype for P @ V, as the JAX loop casts them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from m3p_tpu_torch.ops.attention import DEFAULT_MASK_VALUE
from m3p_tpu_torch.parallel.mesh import (
    Exchange, Mesh, PinnedBuffers, exchange)

# bytes this rank sent around rings: forward and backward separately
RING_BYTES = {"forward": 0, "backward": 0, "rotations": 0}


class _Ring:
    """The ring of this rank's ``axis`` line: its neighbors and the pinned
    buffers of a gloo ring on CUDA."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh = mesh
        self.group = mesh.group(axis)
        self.n = mesh.shape[axis]
        self.index = mesh.index(axis)
        self.next = mesh.neighbor(axis, 1)
        self.prev = mesh.neighbor(axis, -1)
        self.staging = PinnedBuffers()

    def start(self, tensors: List[torch.Tensor], tag: str, phase: str
              ) -> Exchange:
        """Send ``tensors`` to the next rank and receive the previous
        rank's, asynchronously; `Exchange.wait` returns them."""
        RING_BYTES[phase] += sum(t.numel() * t.element_size()
                                 for t in tensors)
        RING_BYTES["rotations"] += 1
        return exchange(tensors, self.next, self.prev, self.group,
                        self.mesh.backend, self.staging, (tag,))


def _scores(q: torch.Tensor, kb: torch.Tensor, maskb: torch.Tensor,
            q_pos: torch.Tensor, src: int, causal: bool, scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 scores of the local queries against block ``src``, masked,
    and the (B, 1, Sq, Sk) validity they were masked by."""
    sk = kb.shape[2]
    s = torch.matmul(q.float(), kb.float().transpose(-1, -2)) * scale
    valid = maskb.bool()[:, None, None, :]
    if causal:
        k_pos = src * sk + torch.arange(sk, device=q.device)
        valid = valid & (k_pos[None, :] <= q_pos[:, None])[None, None]
    return s.masked_fill(~valid, DEFAULT_MASK_VALUE), valid


def _forward(q, k, v, kv_mask, ring: _Ring, causal: bool, scale: float):
    b, h, sq, d = q.shape
    q_pos = ring.index * sq + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq, 1), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    o = torch.zeros((b, h, sq, d), device=q.device)
    kv, maskb = torch.stack([k, v]), kv_mask.to(torch.uint8)
    for step in range(ring.n):
        src = (ring.index - step) % ring.n
        rot = (ring.start([kv, maskb], "kv", "forward")
               if step < ring.n - 1 else None)
        s, _ = _scores(q, kv[0], maskb, q_pos, src, causal, scale)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        o = alpha * o + torch.matmul(p.to(v.dtype), kv[1]).float()
        m = m_new
        if rot is not None:
            kv, maskb = rot.wait()
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l).to(q.dtype), m, l


def _backward(dout, q, k, v, kv_mask, out, m, l, ring: _Ring, causal: bool,
              scale: float):
    b, h, sq, d = q.shape
    q_pos = ring.index * sq + torch.arange(sq, device=q.device)
    do = dout.float()
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    qf = q.float()
    dq = torch.zeros_like(qf)
    kv, maskb = torch.stack([k, v]), kv_mask.to(torch.uint8)
    # the block's partial dK/dV, carried in the keys' dtype
    dkv = torch.zeros(kv.shape, dtype=k.dtype, device=q.device)
    for step in range(ring.n):
        src = (ring.index - step) % ring.n
        rot = (ring.start([kv, maskb], "kv", "backward")
               if step < ring.n - 1 else None)
        s, valid = _scores(q, kv[0], maskb, q_pos, src, causal, scale)
        p = torch.exp(s - m) / l
        dp = torch.matmul(do, kv[1].float().transpose(-1, -2))
        ds = (p * (dp - delta)).masked_fill(~valid, 0.0)
        dq += torch.matmul(ds, kv[0].float()) * scale
        dkv = torch.stack([
            dkv[0].float() + torch.matmul(ds.transpose(-1, -2), qf) * scale,
            dkv[1].float() + torch.matmul(p.transpose(-1, -2), do)]).to(
                k.dtype)
        # the block's partial dK/dV go on with it; after n hops they are home
        drot = ring.start([dkv], "dkv", "backward") if ring.n > 1 else None
        if rot is not None:
            kv, maskb = rot.wait()
        if drot is not None:
            (dkv,) = drot.wait()
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class RingAttention(torch.autograd.Function):
    """Ring attention with its own backward (a second trip around the
    ring)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, ring, causal, scale):
        out, m, l = _forward(q, k, v, kv_mask, ring, causal, scale)
        ctx.save_for_backward(q, k, v, kv_mask, out, m, l)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, m, l = ctx.saved_tensors
        dq, dk, dv = _backward(dout, q, k, v, kv_mask, out, m, l, ctx.ring,
                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


_RINGS: Dict[Tuple[int, str], _Ring] = {}


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: Optional[torch.Tensor], mesh: Mesh,
                   axis: str = "seq", causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise attention with ring-rotated K/V over ``mesh``'s ``axis``:
    q (B, H, Sq_local, Dh), k/v (B, H, Sk_local, Dh), kv_mask (B, Sk_local)
    True = attend; equal to full attention over the gathered sequence.
    Every rank of the axis line must call it with blocks of one shape."""
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[0], k.shape[2], dtype=torch.bool,
                             device=k.device)
    key = (id(mesh), axis)
    ring = _RINGS.get(key)
    if ring is None or ring.mesh is not mesh:
        ring = _RINGS[key] = _Ring(mesh, axis)
    return RingAttention.apply(q, k, v, kv_mask, ring, causal, scale)
