"""Build and load the port's CUDA kernels and its host library.

Each source under ``m3p_tpu_torch/csrc/`` has a plain C interface.  At first
use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library in the
checkout's ``build/`` directory, named by a hash of the source and the
shared headers (a changed source builds anew), and loaded with ``ctypes``.
``defines`` build another library from the same source with those
preprocessor macros set (a debug instantiation that no model path loads).
`build_host` does the same for C++ sources of the host (the native
tokenizer) with the host compiler.  Every library is written under a
temporary name and renamed into place, so concurrent builds (test
workers) never load a partial file.  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """The library's path, named by the macros and by a hash of its source
    and of the shared headers in ``csrc/``."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    tag = "".join(f"_{d}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}_{digest.hexdigest()[:16]}.so"


def _compile(out: Path, cmd_of, what: str) -> Path:
    """Run ``cmd_of(tmp)`` to write the library ``out`` under a temporary
    name in ``BUILD_DIR``, then rename it into place; raise RuntimeError
    with the compiler's stderr if it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(cmd_of(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{what} failed:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` each of ``defines``) unless
    the library for this source exists; returns its path."""
    out = library_path(name, defines)
    if out.exists():
        return out
    return _compile(out, lambda tmp: [
        nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", tmp,
        str(CSRC / f"{name}.cu")], f"nvcc for {name}.cu")


def cxx_path() -> str:
    """``$CXX``, else ``c++`` or ``g++`` on PATH (nvcc needs a host
    compiler too, so the card's machine has one)."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler found: set CXX or put c++/g++ on "
                       "PATH")


def host_library_path(name: str, sources: Sequence[str]) -> Path:
    """The host library's path, named by a hash of its sources."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.encode() + b"\0" + (CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_host(name: str, sources: Sequence[str]) -> Path:
    """Compile the C++ files ``sources`` of ``csrc/`` into one host library
    with `HOST_FLAGS` unless it exists; returns its path."""
    out = host_library_path(name, sources)
    if out.exists():
        return out
    return _compile(out, lambda tmp: [
        cxx_path(), *HOST_FLAGS, "-o", tmp,
        *(str(CSRC / s) for s in sources), "-lpthread"],
        f"the host compiler for {', '.join(sources)}")


def load_host(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The loaded host library of ``sources``, built at first use."""
    key = (name, tuple(sources))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_host(name, sources)))
            _libs[key] = lib
        return lib


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, defines)))
            _libs[key] = lib
        return lib


def bind(name: str, fn_name: str, argtypes,
         defines: Sequence[str] = ()) -> ctypes._CFuncPtr:
    """The C function ``fn_name`` of ``csrc/<name>.cu``, returning int (a
    cudaError_t), with its argument types set."""
    fn = getattr(load(name, defines), fn_name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn
