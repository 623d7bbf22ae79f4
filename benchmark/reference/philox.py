"""Philox4x32-10 and the attention-dropout keep rule, frozen here.

The program's attention kernels drop attention weights with a keep mask
that is a function of (seed, tile, row, col) alone:

    key     = (seed mod 2^32, seed >> 32)
    counter = (col // 4, row, tile, 0); element (row, col) takes word col % 4
    keep    = bits >= uint32(min(rate * 2^32, 2^32 - 1))
    tile    = b * H + h

(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3").  The
reference draws the same bits in plain int64 torch arithmetic masked to 32
bits, so that it drops what the program drops.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    t1 = a * (b & 0xFFFF)
    t2 = a * (b >> 16)
    low = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (low >> 32), low & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counter words (int64 tensors or ints holding
    uint32, broadcast together) under the key (k0, k1)."""
    device = next((c.device for c in (c0, c1, c2, c3)
                   if isinstance(c, torch.Tensor)), torch.device("cpu"))
    c0, c1, c2, c3 = torch.broadcast_tensors(*[
        torch.as_tensor(c, dtype=torch.int64, device=device)
        for c in (c0, c1, c2, c3)])
    for _ in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + W0) & MASK32
        k1 = (k1 + W1) & MASK32
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def attention_keep(seed: int, rows: torch.Tensor, n_heads: int, q0: int,
                   q1: int, sk: int, rate: float) -> torch.Tensor:
    """Keep mask (len(rows), H, q1 - q0, Sk) of query rows q0 .. q1 - 1 for
    the batch rows ``rows`` (int64, their index in the whole call)."""
    seed = int(seed)
    k0, k1 = seed & MASK32, seed >> 32
    dev = rows.device
    sk4 = -(-sk // 4)
    tiles = (rows[:, None] * n_heads
             + torch.arange(n_heads, device=dev)[None, :]).reshape(-1)
    col4 = torch.arange(sk4, device=dev, dtype=torch.int64)[None, None, :]
    row = torch.arange(q0, q1, device=dev, dtype=torch.int64)[None, :, None]
    words = philox4x32(col4, row, tiles[:, None, None], 0, k0, k1)
    bits = torch.stack(words, dim=-1).reshape(tiles.numel(), q1 - q0,
                                              4 * sk4)[..., :sk]
    keep = bits >= keep_threshold(rate)
    return keep.view(rows.numel(), n_heads, q1 - q0, sk)
