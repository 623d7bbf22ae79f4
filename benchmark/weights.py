"""Weights and seeds of a run, made from ``--seed``.

The weights are made on the device by name and shape from the parameter
list of the plain reference (`reference.m3p.param_spec`), in one large
draw, and rounded to bfloat16, the type the configurations compute in: the
program and the reference start from the same values to the last bit.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch

from benchmark.reference.m3p import param_spec


def sub_seed(seed: int, tag: str) -> int:
    """A 62-bit seed for the part ``tag`` of the run of ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def make_weights(cfg: dict, seed: int, device, requires_grad: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor holding bfloat16 values}: dense kernels
    N(0, 1 / fan_in), biases N(0, 0.02^2), LayerNorm scales 1 + N(0,
    0.05^2) and shifts N(0, 0.02^2), embeddings N(0, 1 / dim)."""
    spec = param_spec(cfg)
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        w = flat[at:at + n].view(shape)
        at += n
        if kind == "dense":
            w = w * shape[1] ** -0.5
        elif kind == "embed":
            w = w * shape[1] ** -0.5
        elif kind == "ln_w":
            w = 1.0 + 0.05 * w
        else:
            w = 0.02 * w
        w = w.to(torch.bfloat16).float()
        out[name] = w.requires_grad_(requires_grad)
    return out
