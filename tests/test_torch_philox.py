"""The port's Philox4x32-10 (m3p_tpu_torch.ops.philox): Random123's
known-answer vectors, the 32-bit arithmetic, the keep rate, and a keep mask
that depends on (seed, tile, row, col) alone.  Exact comparisons: the
generator is integer arithmetic."""

import numpy as np
import pytest
import torch

from m3p_tpu_torch.ops.philox import (
    _mulhilo, keep_mask, keep_mask_tiles, keep_threshold, philox4x32,
    seed_key)

torch.set_num_threads(1)


# Random123's kat_vectors for philox4x32_10: (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_known_answers(counter, key, want):
    got = philox4x32(*(torch.tensor([c]) for c in counter), *key)
    assert tuple(int(w[0]) for w in got) == want


def test_a_batch_of_counters_gives_each_counter_alone():
    rng = np.random.RandomState(1)
    counters = torch.from_numpy(rng.randint(0, 2 ** 32, (4, 5),
                                            dtype=np.int64))
    key = KAT[2][1]
    batch = philox4x32(*counters, *key)
    for i in range(5):
        alone = philox4x32(*counters[:, i:i + 1], *key)
        assert [int(w[i]) for w in batch] == [int(w[0]) for w in alone]


def test_mulhilo_matches_python_integers():
    rng = np.random.RandomState(0)
    b = np.concatenate([rng.randint(0, 2 ** 32, 1000, dtype=np.int64),
                        [0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF]])
    for a in (0xD2511F53, 0xCD9E8D57, 0xFFFFFFFF):
        hi, lo = _mulhilo(a, torch.from_numpy(b))
        want = [a * int(x) for x in b]
        assert hi.tolist() == [w >> 32 for w in want]
        assert lo.tolist() == [w & 0xFFFFFFFF for w in want]


def test_threshold_and_seed_rules():
    assert keep_threshold(0.0) == 0
    assert keep_threshold(0.1) == int(0.1 * 2 ** 32)
    assert keep_threshold(1.0) == 2 ** 32 - 1
    assert seed_key(0x0123456789ABCDEF) == (0x89ABCDEF, 0x01234567)
    with pytest.raises(ValueError):
        seed_key(-1)
    with pytest.raises(ValueError):
        seed_key(2 ** 64)


def test_mask_words_follow_the_counter_rule():
    seed, tile, row = 0x0123456789ABCDEF, 7, 5
    mask_bits = philox4x32(torch.arange(3), row, tile, 0, *seed_key(seed))
    bits = torch.stack(mask_bits, dim=-1).reshape(-1)    # columns 0..11
    thr = keep_threshold(0.3)
    assert torch.equal(keep_mask(seed, tile, 6, 11, 0.3)[row],
                       bits[:11] >= thr)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rate_within_binomial_bounds(rate):
    masks = keep_mask_tiles(1234, 24, 164, 164, rate)
    n = masks.numel()
    sd = (rate * (1 - rate) / n) ** 0.5
    assert abs(masks.float().mean().item() - (1 - rate)) < 5 * sd
    # every tile on its own, too (a per-tile bias would hide in the mean)
    per_tile = masks.float().mean(dim=(1, 2))
    sd_tile = (rate * (1 - rate) / (164 * 164)) ** 0.5
    assert (per_tile - (1 - rate)).abs().max().item() < 5 * sd_tile


def test_mask_depends_on_seed_tile_row_and_col_only():
    seed, rate = 987654321, 0.1
    a = keep_mask(seed, 3, 100, 164, rate)
    assert torch.equal(a, keep_mask(seed, 3, 100, 164, rate))
    # the element (row, col) does not depend on the tile's extent
    assert torch.equal(keep_mask(seed, 3, 37, 50, rate), a[:37, :50])
    # nor on how many tiles are drawn together
    tiles = keep_mask_tiles(seed, 6, 100, 164, rate)
    assert torch.equal(tiles[3], a)
    assert torch.equal(keep_mask_tiles(seed, 2, 100, 164, rate,
                                       first_tile=2)[1], a)
    # another tile or another seed is another mask
    assert not torch.equal(tiles[2], a)
    assert not torch.equal(keep_mask(seed + 1, 3, 100, 164, rate), a)
    assert not torch.equal(keep_mask(seed + (1 << 32), 3, 100, 164, rate), a)
