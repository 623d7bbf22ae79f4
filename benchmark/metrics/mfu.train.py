"""The window's model FLOPs (3 x the forward's matrix products of each
step, `yardstick`) over the window, as a share of the H100's dense bf16
peak."""

from benchmark.yardstick import PEAK_BF16_FLOPS


def read(rec):
    w = rec["window"]
    if w.seconds <= 0:
        return None
    return 100.0 * rec["flops"] / w.seconds / PEAK_BF16_FLOPS
