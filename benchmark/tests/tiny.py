"""Tiny versions of the cells for the CPU rehearsals: the configurations
and traffic files of `BENCHMARK.json` with the widths, depths and sizes
cut down, the limits kept."""

from __future__ import annotations

import time

from benchmark.harness import Context, load_json, ROOT

TINY_MODEL = dict(n_words=512, mask_index=511, emb_dim=64, n_layers=2,
                  n_heads=4, hidden_dim=128, max_positions=1100,
                  refine_layers=1, img_feat_dim=32, n_obj_classes=20,
                  dtype="float32")
TINY_TRAFFIC = {
    "mct-pretrain": dict(groups=4, max_len=12, regions=6, reference_rows=8),
    "xmlm-4k": dict(batch=2, seq_len=600, reference_rows=1),
}


# every cell of BENCHMARK.json: (configuration, traffic)
CELLS = {"base.mct-pretrain": ("m3p-base", "mct-pretrain"),
         "long.xmlm-4k": ("m3p-long", "xmlm-4k")}


def bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def context(cell: str, seed: int, seconds: float = 0.5, variant: str = "",
            trace: bool = False) -> Context:
    config, traffic = CELLS[cell]
    workload = {"name": cell, "config": config, "traffic": traffic,
                "chips": 1}
    cfg = dict(load_json(ROOT / "benchmark" / "configs" / f"{config}.json"),
               **TINY_MODEL)
    tr = load_json(ROOT / "benchmark" / "traffic" /
                   f"{workload['traffic']}.json")
    tr.update(TINY_TRAFFIC[workload["traffic"]])
    if "masking" in tr and tr.get("seq_len"):
        tr["masking"] = dict(tr["masking"], max_pred=64)
    return Context(workload, cfg, tr, seed, seconds, trace,
                   time.perf_counter(), device="cpu", variant=variant)


def runner(ctx: Context):
    import importlib
    return importlib.import_module(
        f"benchmark.runners.{ctx.traffic['runner']}")
