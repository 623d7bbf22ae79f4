"""Which gloo collectives take tensors on the card.

Ranks that share one card join over gloo (`parallel.mesh.choose_backend`),
and gloo's support of CUDA tensors differs by collective and by torch
version.  This probe starts two gloo ranks on one device, calls each
collective the port's parameter sharding could use on a tensor of that
device in fp32 and bf16, checks the values it returns, and prints one JSON
object: ``{"torch": ..., "device": ..., "ops": {"<op>/<dtype>": "ok" or
the error's first line}}``.

    python -m m3p_tpu_torch.parallel.probe_gloo [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
from typing import Dict

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ops(device: torch.device, dtype: torch.dtype, rank: int):
    """(name, call returning (got, want)) of each collective."""
    n = 6
    mine = torch.arange(n, dtype=torch.float32, device=device) + 10 * rank
    every = [torch.arange(n, dtype=torch.float32, device=device) + 10 * r
             for r in range(WORLD)]
    total = sum(every)

    def t(x):
        return x.to(dtype)

    def all_reduce_sum():
        x = t(mine.clone())
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        return x, t(total)

    def all_reduce_max():
        x = t(mine.clone())
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return x, t(torch.maximum(*every))

    def all_gather():
        parts = [torch.empty_like(t(mine)) for _ in range(WORLD)]
        dist.all_gather(parts, t(mine))
        return torch.cat(parts), t(torch.cat(every))

    def all_gather_into_tensor():
        out = torch.empty(WORLD * n, dtype=dtype, device=device)
        dist.all_gather_into_tensor(out, t(mine))
        return out, t(torch.cat(every))

    def reduce_scatter():
        out = torch.empty(n // WORLD, dtype=dtype, device=device)
        dist.reduce_scatter(out, list(t(mine).chunk(WORLD)))
        return out, t(total.chunk(WORLD)[rank])

    def reduce_scatter_tensor():
        out = torch.empty(n // WORLD, dtype=dtype, device=device)
        dist.reduce_scatter_tensor(out, t(mine))
        return out, t(total.chunk(WORLD)[rank])

    def broadcast():
        x = t(mine.clone())
        dist.broadcast(x, src=0)
        return x, t(every[0])

    return [(f.__name__, f) for f in (
        all_reduce_sum, all_reduce_max, all_gather, all_gather_into_tensor,
        reduce_scatter, reduce_scatter_tensor, broadcast)]


def _rank(rank: int, port: int, device_type: str, out_path: str) -> None:
    device = (torch.device("cuda", 0) if device_type == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    result: Dict[str, str] = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, call in _ops(device, dtype, rank):
            key = f"{name}/{str(dtype).replace('torch.', '')}"
            try:
                got, want = call()
                if got.device != device:
                    result[key] = f"returned on {got.device}"
                elif not torch.equal(got.cpu(), want.cpu()):
                    result[key] = "wrong values"
                else:
                    result[key] = "ok"
            except Exception as e:             # the probe's answer
                result[key] = (f"{type(e).__name__}: "
                               f"{str(e).strip().splitlines()[0][:160]}")
            # keep the ranks in step after a collective one side refused
            dist.barrier()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(result, f)
    dist.destroy_process_group()


def probe(device_type: str = "cuda", out_dir: str = ".") -> Dict:
    """Run the probe on two ranks; the JSON object the module prints."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("probe_gloo --device cuda needs a card")
    out_path = os.path.join(out_dir, f".probe_gloo_{os.getpid()}.json")
    mp.spawn(_rank, args=(_free_port(), device_type, out_path),
             nprocs=WORLD, join=True)
    with open(out_path) as f:
        ops = json.load(f)
    os.remove(out_path)
    name = (torch.cuda.get_device_name(0) if device_type == "cuda"
            else "cpu")
    return {"torch": torch.__version__, "device": name, "ops": ops}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    print(json.dumps(probe(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
