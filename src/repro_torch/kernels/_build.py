"""Build the CUDA kernels at first use and bind them with ``ctypes``.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/repro_torch/`` at the repository root. A library's
file name carries a hash of its sources and flags, so an edited source
rebuilds and an unchanged one loads the library already built.
:func:`build_all` starts every ``nvcc`` at once. Each build keeps ptxas's
report (registers, spills and stack of every kernel) beside its library,
read by :func:`ptxas_report`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("paged_attention", "chunk_prefill", "flash_attention",
           "flash_attention_bwd", "ssd_chunk", "ssd_chunk_bwd")

# dtype codes of the C interface, and the widest head the kernels stage
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 128   # the backward's tiles; the forward with lse too

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source at first use and need the CUDA "
                       "toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out = _target(name)
    out.with_suffix(".log").write_text(log)
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every kernel library not built yet, all ``nvcc`` processes
    running together, and load them."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = {n: _start(n) for n in todo if not _target(n).exists()}
        for n, p in procs.items():
            _finish(n, p)
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_target(n)))


def ptxas_report(name: str) -> Dict[str, dict]:
    """ptxas's report of each kernel of ``csrc/<name>.cu`` as built here
    (mangled name -> registers, spill stores and loads, stack bytes, and
    whether ptxas serialized its wgmma for want of registers), from the
    log its build kept; empty when the library was built elsewhere."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        return {}
    out: Dict[str, dict] = {}
    serialized = set()
    kernel = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
            out[kernel] = {"registers": 0, "spill_stores": 0,
                           "spill_loads": 0, "stack": 0,
                           "wgmma_serialized": False}
            continue
        m = re.search(r"wgmma.mma_async instructions are serialized.*'(\w+)'",
                      line)
        if m:
            serialized.add(m.group(1))
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[kernel].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[kernel]["registers"] = int(m.group(1))
    for k in serialized & set(out):
        out[k]["wgmma_serialized"] = True
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name]
    return lib


def require(cond: bool, kernel: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


def check_tensors(kernel: str, floats: Sequence[torch.Tensor],
                  ints: Sequence[torch.Tensor]) -> None:
    """Every tensor on one CUDA device and contiguous; the floating tensors
    of one dtype the kernels take, the index tensors int32."""
    dev = floats[0].device
    tensors = [*floats, *ints]
    require(all(t.is_cuda and t.device == dev for t in tensors), kernel,
            "every tensor must be on the same CUDA device")
    require(all(t.is_contiguous() for t in tensors), kernel,
            "every tensor must be contiguous")
    require(floats[0].dtype in DTYPE_CODES
            and all(t.dtype == floats[0].dtype for t in floats), kernel,
            f"floating tensors must share one dtype of {list(DTYPE_CODES)}")
    require(all(t.dtype == torch.int32 for t in ints), kernel,
            "index tensors must be int32")


def check_aligned(kernel: str, tensors: Sequence[torch.Tensor]) -> None:
    """Every tensor's first element on a 16-byte boundary, as TMA and the
    kernels' 16-byte vector loads need."""
    require(all(t.data_ptr() % 16 == 0 for t in tensors), kernel,
            "every tensor must start on a 16-byte boundary")


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
