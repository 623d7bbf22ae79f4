"""Philox4x32-10 and the attention-dropout keep mask of the port.

The port's counterpart of `_small_keep` (`m3p_tpu/ops/attention.py:143`),
which draws the keep mask of one (batch, head) tile from the TPU's hardware
PRNG.  Hopper has no such generator, so the packed-attention kernels and
their plain versions all draw from Philox4x32-10 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", the Random123 generator):

    key     = (seed mod 2^32, seed >> 32)
    counter = (col // 4, row, tile, 0);  element (row, col) takes word col % 4
    keep    = bits >= uint32(min(rate * 2^32, 2^32 - 1))   (the JAX rule)
    tile    = b * H + h, or b * heads_total + head_base + h for a call
              over the heads head_base .. head_base + H - 1 of a tensor
              of heads_total (`head_tiles`: a tensor-parallel rank's
              heads draw what the whole tensor's call draws for them)

The mask is a function of (seed, tile, row, col) alone and never of how
threads are laid out, so the forward kernel, the backward kernel and the
plain version below draw the same bits.

The residual dropout of `m3p_tpu_torch.ops.dropout` (the counterpart of
`_mask_kernel_body`, `m3p_tpu/ops/dropout.py:27-32`, which seeds the TPU's
PRNG per (seed, grid step of 512 x 128 elements) and cannot be reproduced)
keys one mask over the flat tensor the same way:

    counter = (i // 4 mod 2^32, i // 4 >> 32, 0, 0); element i takes word i % 4
    keep    = bits >= keep_threshold(rate)

so the mask is a function of (seed, i) alone: any block size, thread layout
or chunking draws the same one.  Here the generator runs in int64
torch arithmetic masked to 32 bits, on CPU and CUDA tensors alike; the
32 x 32 -> 64-bit products are split into 16-bit halves so that no
intermediate leaves int64.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10
MASK32 = 0xFFFFFFFF

Word = Union[int, torch.Tensor]


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product a * b, for a uint32
    constant ``a`` and an int64 tensor ``b`` holding uint32 values."""
    t1 = a * (b & 0xFFFF)                 # < 2^48
    t2 = a * (b >> 16)                    # < 2^48; product = t2 * 2^16 + t1
    low = t1 + ((t2 & 0xFFFF) << 16)      # < 2^49
    return (t2 >> 16) + (low >> 32), low & MASK32


def philox4x32(c0: Word, c1: Word, c2: Word, c3: Word, k0: int, k1: int
               ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 of the counter (c0, c1, c2, c3) under the key (k0, k1).

    Counter words broadcast against each other (int64 tensors or ints, each
    holding a uint32); returns the four output words as int64 tensors."""
    device = next((c.device for c in (c0, c1, c2, c3)
                   if isinstance(c, torch.Tensor)), torch.device("cpu"))
    words = [torch.as_tensor(c, dtype=torch.int64, device=device)
             for c in (c0, c1, c2, c3)]
    c0, c1, c2, c3 = torch.broadcast_tensors(*words)
    for _ in range(ROUNDS):
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & MASK32
        k1 = (k1 + PHILOX_W1) & MASK32
    return c0, c1, c2, c3


def seed_key(seed: int) -> Tuple[int, int]:
    """A 64-bit seed -> the Philox key (seed_lo, seed_hi)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"dropout seed {seed} is not a 64-bit unsigned int")
    return seed & MASK32, seed >> 32


def keep_threshold(rate: float) -> int:
    """uint32(min(rate * 2^32, 2^32 - 1)): a draw at or above it is kept
    (`m3p_tpu/ops/attention.py:156`)."""
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def head_tiles(b: int, n_heads: int, head_base: int = 0,
               heads_total: Optional[int] = None,
               device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """The Philox tiles of a call's (batch, head) pairs, batch-major: int64
    (B * H,), tile ``b * heads_total + head_base + h`` for the heads
    head_base .. head_base + H - 1 of a tensor of ``heads_total`` (default
    H, the whole tensor: b * H + h).  A tensor-parallel rank holding a slice
    of the heads draws the masks the whole tensor's call draws for them."""
    total = n_heads if heads_total is None else heads_total
    heads = torch.arange(head_base, head_base + n_heads, device=device,
                         dtype=torch.int64)
    return (torch.arange(b, device=device, dtype=torch.int64)[:, None] * total
            + heads[None, :]).reshape(-1)


def keep_mask_tiles(seed: int, n_tiles: int, sq: int, sk: int, rate: float,
                    device: Union[str, torch.device] = "cpu",
                    first_tile: int = 0, first_row: int = 0,
                    tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Keep masks of the tiles first_tile .. first_tile + n_tiles - 1 (or of
    the ``n_tiles`` tile numbers ``tiles``), rows first_row .. first_row +
    sq - 1: bool (n_tiles, sq, sk)."""
    k0, k1 = seed_key(seed)
    sk4 = -(-sk // 4)
    col4 = torch.arange(sk4, device=device, dtype=torch.int64)[None, None, :]
    row = torch.arange(first_row, first_row + sq, device=device,
                       dtype=torch.int64)[None, :, None]
    if tiles is None:
        tiles = torch.arange(first_tile, first_tile + n_tiles, device=device,
                             dtype=torch.int64)
    tile = tiles.to(device=device, dtype=torch.int64)[:, None, None]
    words = philox4x32(col4, row, tile, 0, k0, k1)
    bits = torch.stack(words, dim=-1).reshape(n_tiles, sq, 4 * sk4)[..., :sk]
    return bits >= keep_threshold(rate)


def keep_mask(seed: int, tile: int, sq: int, sk: int, rate: float,
              device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """The keep mask of one (batch, head) tile, ``tile = b * H + h``: bool
    (sq, sk)."""
    return keep_mask_tiles(seed, 1, sq, sk, rate, device, first_tile=tile)[0]


# elements per chunk of the plain flat mask: 2^22 elements keep each int64
# temporary of the generator at 8 MB
FLAT_CHUNK = 1 << 22


def keep_mask_flat(seed: int, n: int, rate: float, first: int = 0,
                   device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """The elementwise keep mask of the flat elements first .. first + n - 1:
    bool (n,).  Drawn in chunks of `FLAT_CHUNK` elements, so a full-size
    tensor never builds a large int64 temporary."""
    k0, k1 = seed_key(seed)
    threshold = keep_threshold(rate)
    out = torch.empty(n, dtype=torch.bool, device=device)
    for start in range(0, n, FLAT_CHUNK):
        stop = min(start + FLAT_CHUNK, n)
        lo, hi = first + start, first + stop        # element range
        group = torch.arange(lo // 4, -(-hi // 4), device=device,
                             dtype=torch.int64)
        words = philox4x32(group & MASK32, group >> 32, 0, 0, k0, k1)
        bits = torch.stack(words, dim=-1).reshape(-1)
        skip = lo - 4 * (lo // 4)
        out[start:stop] = bits[skip:skip + stop - start] >= threshold
    return out
