"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, under ``build/kernels/`` at the repo
root, the first time a kernel is needed; the file name carries a hash of
the source and of the shared headers (``csrc/*.cuh``), so an edited
source or header is rebuilt. No CUTLASS/CuTe header is used. Libraries
are loaded with ``ctypes``. Nothing here runs at import time: the CPU-only test
environment imports every module and has no ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
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
SOURCES = ("flash_attn", "flash_attn_bwd", "fused_mlp", "fused_mlp_bwd",
           "ssd_scan", "ssd_scan_bwd", "decode_attn", "ssm_chain")

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


def library(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built. Its
    name hashes the source, every shared header ``csrc/*.cuh`` (the
    sources include them) and the flags, so an edit to any of them
    builds a new library instead of loading a stale one."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _compile(name: str) -> float:
    """Compile one source unless its library exists; returns seconds."""
    out = library(name)
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
            lib = ctypes.CDLL(str(library(name)))
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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the persistent
    kernels' grid size), read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device (its raw handle),
    for a launch. Read through the call PyTorch's own generated code
    uses: building a ``torch.cuda.Stream`` object on every launch costs
    host time on a host-bound decode path."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def on_device(t: torch.Tensor):
    """A context that makes ``t``'s device current for a launch; a no-op
    when it already is (entering ``torch.cuda.device`` costs host time)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def refuse_grad(name: str, tensors, remedy: str) -> None:
    """Raise NotImplementedError when autograd would record a kernel
    launch: grad mode is on and an input requires grad. A launch writes
    into ``torch.empty`` through ctypes, so its output carries no
    ``grad_fn``; without this check a backward would run through and give
    the inputs' producers no gradient. ``remedy`` says what to call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward, and autograd would "
            f"drop the gradient of its inputs; {remedy}")


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{[str(x.device) for x in tensors]}")
