"""Build the port's CUDA kernels on first use and load them with ctypes.

Each source under ``csrc/`` is compiled by its own ``nvcc`` for ``sm_90a``,
all of them started together, and the objects are linked into one shared
library with a plain C interface, ``libkernels.so``, which links the CUDA
runtime statically and includes no PyTorch header, so it builds in seconds.
It lands in ``build/repro_torch/<hash>/`` at the root of the checkout, where
``<hash>`` covers the sources and the flags: an edited source builds anew,
an unchanged one is loaded as it is.  Each compiler's ``-Xptxas -v`` report
(registers, shared memory, spills of each kernel) is kept beside it in
``nvcc.log``, under a ``== <source>`` header line per source.

The first build is guarded twice.  A thread lock covers the threaded
executor's workers, which can reach their first kernel at the same moment;
an ``fcntl.flock`` on ``lock`` in the build directory covers processes (the
cluster runtime's spawned workers of a fresh checkout would otherwise each
run the full set of ``nvcc``).  The kernel releases a flock when its holder
dies, so a build cut off midway leaves no lock behind.  The library is
linked into a temporary name and renamed, so a process that finds it finds
it whole.
"""
from __future__ import annotations

import ctypes
import fcntl
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P, _I = ctypes.c_void_p, ctypes.c_int
# exported C function -> argtypes; each returns a cudaError_t as int
_SIGNATURES = {
    "repro_matmul_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_matmul_f32_scalar": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_matmul_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_matmul_bf16_wgmma": [_P, _P, _P] + [_I] * 7 + [_P],
    "repro_matmul_bf16_wgmma_resident": [_I, _P],
    "repro_ssm_scan_f32": [_P] * 9 + [_I] * 5 + [_P],
    "repro_ssm_scan_bf16": [_P] * 9 + [_I] * 5 + [_P],
    "repro_ssm_scan_bwd_f32": [_P] * 17 + [_I] * 5 + [_P],
    "repro_flash_attention_f32": [_P] * 5 + [_I] * 8 + [_P],
    "repro_flash_attention_bf16": [_P] * 5 + [_I] * 8 + [_P],
    "repro_flash_attention_bf16_wgmma": [_P] * 6 + [_I] * 9 + [_P],
    "repro_flash_attention_bwd_f32": [_P] * 11 + [_I] * 9 + [_P],
    "repro_flash_attention_bwd_bf16": [_P] * 11 + [_I] * 9 + [_P],
    "repro_flash_attention_bwd_bf16_wgmma": [_P] * 11 + [_I] * 9 + [_P],
    "repro_flash_attention_bwd_resources": [_I, _I, _I, _P],
    "repro_flash_attention_bwd_bf16_wgmma_resources": [_I, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run(cmd: list, log: Path) -> subprocess.Popen:
    with open(log, "w") as f:      # the child keeps its own copy of the fd
        return subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)


def _compile(out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{pid}.o"
        log = out_dir / f"{src.stem}.{pid}.log"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, log, cmd, _run(cmd, log)))
    objs = [job[1] for job in jobs]
    try:
        report, failed = [], []
        for src, _, log, cmd, proc in jobs:
            proc.wait()
            text = log.read_text()
            log.unlink()
            report.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed with exit code "
                              f"{proc.returncode}:\n{' '.join(cmd)}\n{text}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out_dir / f"libkernels.so.{pid}.tmp"
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"linking failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    (out_dir / "nvcc.log").write_text("".join(report))
    os.replace(tmp, out_dir / "libkernels.so")


def ensure_built() -> Path:
    """The checkout's ``libkernels.so``, built first if there is none; of
    processes that get here together, one builds and the others wait for
    it on the build directory's file lock."""
    out_dir = build_dir()
    path = out_dir / "libkernels.so"
    if path.exists():
        return path
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # released on close or death
        if not path.exists():
            _compile(out_dir)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(ensure_built()))
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
