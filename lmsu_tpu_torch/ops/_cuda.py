"""Build, load and launch the port's hand-written CUDA kernels.

Each source under `lmsu_tpu_torch/csrc/` is compiled at first use by
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`
into its own shared library with a plain C interface, and loaded with
ctypes. Libraries go to `build/lmsu_tpu_torch/` beside the package (listed
in .gitignore), named by a hash of the source and the shared headers
`csrc/*.cuh`, so an edited kernel is rebuilt and an unchanged one is
reused. `build_all()` starts one nvcc per source, all at once.

Every C entry point takes device pointers, sizes and the CUDA stream, and
returns the `cudaError_t` of `cudaGetLastError()` right after its launch;
`CudaKernel.launch` raises if that is not 0. Nothing here runs at import
time: the CPU-only test host has no nvcc and never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lmsu_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

_lock = threading.Lock()
_registry: Dict[str, "CudaKernel"] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def dtype_code(t: torch.Tensor) -> int:
    """The C side's element-type switch: 0 float32, 1 bfloat16."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_args(*tensors) -> torch.device:
    """All tensors on one CUDA device and contiguous; returns that device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return dev


class CudaKernel:
    """One csrc/*.cu source: its library, its C entry points and the count
    of its launches (a plain integer, reset by callers that need it)."""

    def __init__(self, source: str, symbols: Dict[str, Sequence]):
        self.source = source
        self.name = Path(source).stem
        self.symbols = dict(symbols)
        self.launches = 0
        self._lib = None
        self.build_log = ""
        _registry[self.name] = self

    def _so_path(self) -> Path:
        text = (CSRC / self.source).read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{self.name}-{digest[:16]}.so"

    def _command(self, out: Path) -> List[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / self.source)]

    def _load(self, so: Path) -> None:
        lib = ctypes.CDLL(str(so))
        for sym, argtypes in self.symbols.items():
            fn = getattr(lib, sym)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        self._lib = lib

    def lib(self):
        if self._lib is None:
            build_all([self])
        return self._lib

    def launch(self, symbol: str, *args) -> None:
        err = getattr(self.lib(), symbol)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}.{symbol}: CUDA error {err}")
        self.launches += 1


def kernels() -> Dict[str, CudaKernel]:
    """Every kernel registered by the port's op modules."""
    from lmsu_tpu_torch.ops import (fusion_gate, ir_fused, kd_loss,  # noqa: F401
                                    scatter_sorted, voxelize)
    return dict(_registry)


def reset_launch_counts() -> None:
    for k in kernels().values():
        k.launches = 0


def build_all(which: Sequence[CudaKernel] | None = None) -> float:
    """Compile (one nvcc per source, all started together) and load every
    kernel not loaded yet; returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        todo = [k for k in (which or kernels().values()) if k._lib is None]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for k in todo:
            so = k._so_path()
            if so.exists():
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            tmp = Path(tmp)
            procs.append((k, so, tmp, subprocess.Popen(
                k._command(tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        failed = []
        for k, so, tmp, proc in procs:
            k.build_log = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{k.source}:\n{k.build_log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for k in todo:
            k._load(k._so_path())
    return time.perf_counter() - t0

