"""The benchmark's frozen arithmetic: the chip's peaks, the model FLOPs of
a step, the operations and bytes of the attention kernels, and the names
of the device's kernel groups.

The counts are copies of the port's `bench.py` (`joint_forward_flops`,
`mct_step_flops`) and of chip_smoke.py's xMLM count (`step_flops`), kept
here so that a change to the program cannot move the yardstick.  FLOPs
are 3 x the forward's matrix products (the backward is twice the
forward); recomputation is not counted; embedding gathers, LayerNorm,
softmax, GELU and the optimizer are left out.
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense bf16 and HBM3 (data sheet), at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def ffn_dim(cfg: dict) -> int:
    return cfg["hidden_dim"] or 4 * cfg["emb_dim"]


def joint_forward_flops(cfg: dict, s: int, regions: int) -> int:
    """Forward FLOPs of one joint sequence of ``s`` tokens over ``regions``
    regions with the ITM pooler: the region projection, the refiner, the
    blocks and the pooler."""
    d, f = cfg["emb_dim"], ffn_dim(cfg)
    image = 2 * regions * (cfg["img_feat_dim"] + cfg["img_loc_dim"]) * d
    refiner = cfg["refine_layers"] * (2 * (7 * d * d + 2 * d * f) * regions
                                      + 4 * regions * regions * d)
    blocks = cfg["n_layers"] * (2 * (4 * d * d + 2 * d * f) * s
                                + 4 * s * s * d)
    pooler = 2 * (d * d + d)
    return image + refiner + blocks + pooler


def mct_step_flops(cfg: dict, bn: int, text_len: int, regions: int,
                   max_pred: int, pack_ratio: float) -> int:
    """Model FLOPs of one MCT step: the joint encode of BN sequences of
    ``regions + text_len`` tokens, the tied word head over the packed
    word slots, the object and MRFR heads over the packed region slots."""
    d = cfg["emb_dim"]
    text_slots = max(int(bn * min(max_pred, text_len) * pack_ratio), 1)
    region_slots = max((bn * min(max_pred, regions)) // 2, 1)
    forward = bn * joint_forward_flops(cfg, regions + text_len, regions)
    forward += 2 * text_slots * d * cfg["n_words"]
    forward += 2 * region_slots * (d * d + d * cfg["n_obj_classes"]
                                   + d * cfg["img_feat_dim"])
    return 3 * forward


def mlm_step_flops(cfg: dict, b: int, s: int, n_slots: int) -> int:
    """Model FLOPs of one xMLM step: per block the Q/K/V/out and FFN GEMMs
    and the two attention products, the tied head at the masked slots."""
    d, f = cfg["emb_dim"], ffn_dim(cfg)
    per_block = 2 * (4 * d * d + 2 * d * f) * b * s + 4 * b * s * s * d
    head = 2 * n_slots * d * cfg["n_words"]
    return 3 * (cfg["n_layers"] * per_block + head)


def attention_least_s(b: int, h: int, sq: int, sk: int, dh: int,
                      backward: bool, itemsize: int = 2) -> float:
    """The least time one attention call can take on the chip: its
    operations at the bf16 peak or its bytes, each input read once and
    each output written once, at the HBM peak, whichever is larger.
    Forward: QK^T and PV (4 B H Sq Sk Dh), q, k, v and the key mask (a
    byte a key) in, o out.  Backward: QK^T again, dV, dP, dQ, dK (10 B H
    Sq Sk Dh), q, k, v, do and the key mask in, dq, dk, dv out."""
    ops = (10 if backward else 4) * b * h * sq * sk * dh
    q_bytes = b * sq * h * dh * itemsize
    kv_bytes = b * sk * h * dh * itemsize
    nbytes = (3 * q_bytes + 4 * kv_bytes if backward
              else 2 * q_bytes + 2 * kv_bytes) + b * sk
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def kernel_group(name: str) -> str:
    """The group of a device operation by its name (a frozen copy of
    chip_smoke.py's `kernel_group`)."""
    low = name.lower()
    if "fused_dropout" in low:
        return "fused dropout"
    if "flash_attention_bwd" in low:
        return "flash_attention_bwd"
    if "flash_attention" in low:
        return "flash_attention"
    if "packed_attention_bwd" in low:
        return "packed_attention_bwd"
    if "packed_attention" in low:
        return "packed_attention"
    if "bernoulli" in low:
        return "dropout masks"
    if "sort" in low:
        return "sort"
    if "indexselect" in low.replace("_", ""):
        return "index_select"
    if "foreach" in low or "multi_tensor" in low:
        return "optimizer (foreach)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90_",
                              "cublas")):
        if any(s in low for s in ("_s8", "i8", "imma", "int8")):
            return "gemm (int8)"
        return "gemm"
    if "layer_norm" in low:
        return "layer_norm"
    if "bfloat16_copy" in low:
        return "casts to bf16"
    return "other"
