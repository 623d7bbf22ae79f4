"""Rules of the PyTorch port: it imports nothing of JAX, flax, grain, lmdb
or the JAX package (nor does chip_smoke.py), importing it does not import
h5py (the chip machine has none of them), and its entry points run on CUDA
unless the caller asks for the CPU."""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import m3p_tpu_torch
from m3p_tpu.config import small_test_config
from m3p_tpu_torch.config import ModelConfig
from m3p_tpu_torch.model import build_model

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "m3p_tpu", "grain",
             "lmdb")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        m3p_tpu_torch.__path__, prefix="m3p_tpu_torch."))


def test_forbidden_prefix_does_not_catch_the_port():
    assert _forbidden("m3p_tpu.serve") and _forbidden("jax.numpy")
    assert not _forbidden("m3p_tpu_torch") and not _forbidden("jaxtyping_x")


def test_port_imports_no_jax_and_no_jax_package():
    modules = _port_modules()
    for name in ("serve.engine", "ops.philox", "train.steps", "train.optim",
                 "train.state", "data.synthetic", "data.masking",
                 "ops.fused_ffn", "bench_fused_ffn", "model.generation",
                 "ops.topk", "train.freelb", "data.noise",
                 "data.span_masking", "data.loader", "config", "eval",
                 "eval.retrieval", "eval.evaluator", "eval.bleu",
                 "eval.cider", "eval.caption_metrics", "bench_eval_grid",
                 "checkpoint", "data.pipeline", "train.trainer",
                 "cli.train_x", "utils.schedules", "utils.sampling",
                 "utils.metrics", "utils.logging", "utils.profiling",
                 "data.features", "data.clag", "data.datasets",
                 "data.row_pipeline", "ops.quant", "tokenization.native",
                 "tokenization.dictionary", "cli.preprocess", "model.misc",
                 "parallel", "parallel.mesh", "parallel.sharding",
                 "parallel.data_parallel", "parallel.sp",
                 "ops.ring_attention"):
        assert f"m3p_tpu_torch.{name}" in modules
    code = (
        "import importlib, json, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if _forbidden(m)] == []
    # h5py is imported where a shard is opened, never at import
    assert [m for m in loaded if m == "h5py" or m.startswith("h5py.")] == []


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_and_chip_smoke_name_no_forbidden_import():
    # the kernel tests run on the card's machine, which has no JAX
    # so do the ranks of the multi-process tests
    paths = [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_kernels.py",
             REPO / "tests" / "test_torch_pipeline.py",
             REPO / "tests" / "test_torch_ranks.py"]
    paths += sorted((REPO / "m3p_tpu_torch").rglob("*.py"))
    for path in paths:
        bad = [n for n in _imported_names(path) if _forbidden(n)]
        assert bad == [], (path, bad)


def test_entry_points_need_an_explicit_cpu_request_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    from m3p_tpu_torch.serve.engine import InferenceEngine

    cfg = ModelConfig(**dataclasses.asdict(small_test_config().model))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, 0, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(model)
    assert InferenceEngine(model, device="cpu").device.type == "cpu"


def test_serve_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    from m3p_tpu_torch.cli.serve import get_parser, main

    vocab = tmp_path / "vocab.tsv"
    vocab.write_text("▁a\t-1.0\n▁dog\t-2.0\n", encoding="utf-8")
    argv = ["--reload_model", str(tmp_path / "model.pt"),
            "--vocab_path", str(vocab), "--n_layers", "1", "--emb_dim", "8",
            "--n_heads", "2", "--warmup", "false"]
    args = get_parser().parse_args(argv)
    assert args.device == "cuda" and args.dtype == "bfloat16"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)


def test_the_launcher_path_needs_an_explicit_cpu_request_too(monkeypatch):
    """Under torchrun's environment `train_x.main` still defaults to CUDA
    and refuses without a card before it joins a process group; a rank
    asking for CUDA without a card is told to pass --device cpu; the
    backend rule: gloo on the CPU, nccl with a card per rank, gloo when
    ranks share a card, and nccl asked for on shared cards raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    import torch.distributed as dist

    from m3p_tpu_torch.cli import train_x
    from m3p_tpu_torch.parallel import mesh as M

    for key, value in (("RANK", "0"), ("WORLD_SIZE", "2"),
                       ("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "2"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_x.main(["--exp_name", "x", "--mesh_data", "2"])
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="--device cpu"):
        M.auto_init_distributed("cuda")
    assert M.launch_env() == {"rank": 0, "world_size": 2, "local_rank": 0,
                              "local_world_size": 2}
    assert M.choose_backend("cpu", 4, 0) == "gloo"
    assert M.choose_backend("cuda", 4, 4) == "nccl"
    assert M.choose_backend("cuda", 4, 1) == "gloo"
    with pytest.raises(ValueError, match="NCCL needs a card per rank"):
        M.choose_backend("cuda", 2, 1, requested="nccl")
