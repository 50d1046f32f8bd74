"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, under ``build/kernels/`` at the repo
root, the first time a kernel is needed; the file name carries a hash of
the source, so an edited source is rebuilt. Libraries are loaded with
``ctypes``. Nothing here runs at import time: the CPU-only test
environment imports every module and has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("flash_attn", "fused_mlp")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the GPU")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str) -> float:
    """Compile one source unless its library exists; returns seconds."""
    out = _lib_path(name)
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    (BUILD_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all() -> Dict[str, float]:
    """Compile every kernel source, one nvcc process each, all at once.
    Returns compile seconds per source (0.0 where already built)."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        secs = dict(zip(SOURCES, pool.map(_compile, SOURCES)))
    return secs


def build_log(name: str) -> str:
    """nvcc/ptxas output of the last compile of ``name`` (registers,
    shared memory, spills)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiled on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _compile(name)
            lib = ctypes.CDLL(str(_lib_path(name)))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{[str(x.device) for x in tensors]}")
