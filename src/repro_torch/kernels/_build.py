"""Build the CUDA kernels at first use and load them with ``ctypes``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
started together, for ``sm_90a`` into a shared library with a plain C
interface under ``build/repro_torch/`` at the repository root.  No
source includes PyTorch's headers, so a build takes seconds.  A
library's file name carries a hash of its source, so an edited source
is rebuilt and an unchanged one is reused.

Each ``extern "C"`` launcher takes its pointers and the CUDA stream as
``void*`` and returns the ``cudaGetLastError()`` code of its launch;
``check`` raises when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from source at "
            "first use and need the CUDA toolkit")
    return path


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}.{digest}.so"


def build_all(verbose: bool = False) -> dict:
    """Compile (where needed) and load every kernel library; returns
    ``{source stem: ctypes.CDLL}``.  Idempotent within a process."""
    with _LOCK:
        if _LIBS:
            return _LIBS
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        srcs = sorted(CSRC.glob("*.cu"))
        jobs = []
        for src in srcs:
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
                   str(src)]
            jobs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                continue
            if verbose:
                print(f"[build] {src.name}\n{log}", flush=True)
            os.replace(tmp, out)       # atomic: readers never see a stub
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        for src in srcs:
            _LIBS[src.stem] = ctypes.CDLL(str(_target(src)))
        return _LIBS


def function(lib_name: str, fn_name: str, argtypes: list):
    """The launcher ``fn_name`` of library ``lib_name`` with its ctypes
    signature declared (pointers and the stream as ``c_void_p``, so
    none is cut to 32 bits) and an ``int`` result."""
    fn = getattr(build_all()[lib_name], fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
