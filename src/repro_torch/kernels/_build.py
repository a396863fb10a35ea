"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), which
is loaded with ``ctypes``.  Libraries are built at first use into
``kernels/build/`` (git-ignored) under a name that carries a hash of the
sources, so an edited kernel is rebuilt and a stale one never loads.
``build_all`` starts one ``nvcc`` per source at once and waits for all of
them; ``library(name)`` builds everything missing the first time any
kernel is needed.  The compiler's resource report (``-Xptxas -v``) is kept
beside each library as ``<name>.log``.

Nothing here runs at import time: this module is imported on machines that
have no CUDA toolkit, where only the plain PyTorch versions are used.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("decode_attention", "flash_attention", "relevance_score")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures (argument order of the extern "C" entry points)
SIGNATURES: Dict[str, List] = {
    "repro_decode_attention": [
        _P, _P, _P, _P, _P, _L, _I, _P,     # q k v o rows rows_stride tb kv_len
        _I, _I, _I, _I, _I,                 # B Hq Hkv S head_dim
        _L, _L, _L, _L, _L, _L,             # k strides, v strides
        _F, _I, _I, _P],                    # scale dtype_q dtype_kv stream
    "repro_flash_attention": [
        _P, _P, _P, _P, _P, _L, _I, _P,     # q k v o rows rows_stride tb kv_len
        _I, _I, _I, _I, _I, _I,             # B Sq Hq Hkv kv_valid head_dim
        _L, _L, _L,                         # q strides (batch, seq, head)
        _L, _L, _L, _L, _L, _L,             # k strides, v strides
        _I, _I, _I, _F, _I, _I, _P],        # causal window q_offset scale
                                            # dtype_q dtype_kv stream
    "repro_relevance_score": [
        _P, _P, _P, _P, _P,                 # x lengths w b out
        _I, _I, _I, _P],                    # C T D stream
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be "
            "built on this machine")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha1()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def lib_path(name: str) -> Path:
    return BUILD / f"{name}-{_digest(name)}.so"


def log_path(name: str) -> Path:
    return BUILD / f"{name}.log"


def build_all(names=SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, all at
    once.  Raises ``RuntimeError`` with the compiler output on failure."""
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not lib_path(n).exists()]
    procs = []
    nvcc = _nvcc() if todo else None
    for n in todo:
        tmp = BUILD / f"{n}-{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        log_path(n).write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: lib_path(n) for n in names}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    path = build_all()[name]
    lib = ctypes.CDLL(str(path))
    for sym, argtypes in SIGNATURES.items():
        fn = getattr(lib, sym, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
