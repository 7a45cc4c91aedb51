"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface — one nvcc process per
source, all started together.  Libraries land in
``<checkout>/build/kernels/<hash of csrc>/`` (listed in ``.gitignore``),
so an edited source rebuilds and an unchanged one loads at once.
Nothing is built or imported at module import: the CPU tests import this
module on hosts without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas's registers and spills) of each source that
# ``build_all(verbose=True)`` compiled
LOGS: Dict[str, str] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on the machine with the card")
    return found


def sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Compile every source not yet built for the current hash, in
    parallel; returns {name: seconds} of the compiles that ran (empty
    when everything was cached)."""
    out_dir = BUILD_ROOT / sources_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs: List[tuple] = []
    for src in sorted(CSRC.glob("*.cu")):
        lib = out_dir / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src.stem, proc, tmp, lib, time.perf_counter()))
    times: Dict[str, float] = {}
    errors = []
    for name, proc, tmp, lib, t0 in jobs:
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        if verbose and log:
            LOGS[name] = log
            print(f"[nvcc {name}]\n{log}", flush=True)
        os.replace(tmp, lib)                     # atomic: no half-built .so
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = BUILD_ROOT / sources_hash() / f"lib{name}.so"
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


# --------------------------------------------------------------------------
# Argument checks shared by the kernel wrappers
# --------------------------------------------------------------------------

def dtype_code(t) -> int:
    """The C interface's dtype code of an activation / pool tensor."""
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def require(t, name: str, *, dtype=None, ndim=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype,
    rank and device."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with "
                           f"cudaError {err}")
