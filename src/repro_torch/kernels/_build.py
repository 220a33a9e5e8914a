"""Build the port's CUDA kernels on first use and load them with ctypes.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, ``libkernels.so``, which links the
CUDA runtime statically and includes no PyTorch header, so it builds in
seconds.  It lands in ``build/repro_torch/<hash>/`` at the root of the
checkout, where ``<hash>`` covers the sources and the flags: an edited source
builds anew, an unchanged one is loaded as it is.  The compiler's
``-Xptxas -v`` report (registers, shared memory, spills of each kernel) is
kept beside it as ``nvcc.log``.

The first build is guarded by a lock: the threaded executor's workers can
reach their first ``mul`` at the same moment.  The library is compiled into
a temporary name and renamed, so a process that finds it finds it whole.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C function -> argtypes; each returns a cudaError_t as int
_SIGNATURES = {
    "repro_matmul_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_matmul_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                       "needs the CUDA toolkit (set CUDA_HOME)")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _compile(out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libkernels.so.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in _sources() if p.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out_dir / "libkernels.so")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = build_dir()
            if not (out_dir / "libkernels.so").exists():
                _compile(out_dir)
            lib = ctypes.CDLL(str(out_dir / "libkernels.so"))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def ptxas_report() -> str:
    """What ``-Xptxas -v`` said when the loaded library was built."""
    log = build_dir() / "nvcc.log"
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: cudaError {err} ({msg})")
