"""The readings the limits of a cell are set from: the numbers a cell
compares, for the program on many seeds and for its control and faults on
a few, in one process on the chip.

    python3 benchmark/limits.py --workload <name> --seeds 1,2,3
        --variants program,control,half_batch [--seconds S]

Each run is a run of the cell's runner (set-up, a window of ``--seconds``,
0 for none, and the check against the reference) with the variant planted:
"control" the program's own lower-precision path (int8), "half_batch" and
"frozen" the training faults.  Prints one JSON line a run.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["USE_FLAX"] = "0"


def main() -> int:
    import argparse
    import gc
    import importlib
    import json

    import torch

    from benchmark.harness import HERE, Context, card, load_json
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="program")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--control", default="",
                   help="JSON of the configuration's changes that make the "
                        "control, in place of the traffic file's")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = load_json(HERE.parent / "BENCHMARK.json")
    workload = next(w for w in bench["workloads"]
                    if w["name"] == args.workload)
    files = {c["name"]: c["file"] for c in bench["configs"]}
    cfg = load_json(HERE.parent / files[workload["config"]])
    traffic = load_json(HERE / "traffic" / f"{workload['traffic']}.json")
    if args.control:
        traffic["control"] = json.loads(args.control)
    runner = importlib.import_module(f"benchmark.runners.{traffic['runner']}")
    print(json.dumps({"card": card()}), flush=True)
    for variant in args.variants.split(","):
        for seed in [int(s) for s in args.seeds.split(",")]:
            t0 = time.perf_counter()
            ctx = Context(workload, cfg, traffic, seed, args.seconds, False,
                          t0, variant="" if variant == "program" else variant)
            rec = runner.run(ctx)
            print(json.dumps({
                "variant": variant, "seed": seed,
                "readings": rec["readings"],
                "losses": rec["losses"], "ref_losses": rec["ref_losses"],
                "worst": rec["worst"],
                "steps": rec["steps"],
                "setup_s": rec["setup_s"],
                "failed": rec["failed"], "seconds": time.perf_counter() - t0,
                "peak_gb": rec["peak_bytes"] / 1e9}), flush=True)
            del rec, ctx
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
