"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use they are
compiled for ``sm_90a`` with ``nvcc``, one process per source started
together, linked into one shared library under ``build/recstudio_torch/``
of the checkout (listed in ``.gitignore``), and loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an
edit rebuilds it. Nothing here runs at import time: the CPU tests import
every module without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "recstudio_torch")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
CFLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U64, _U32 = ctypes.c_ulonglong, ctypes.c_uint
_DROP = [_U64, _U32, _F, _I]      # seed, 24-bit threshold, 1 / (1 - p), active
_SIGNATURES = {
    "rs_mha_fwd": [_P] * 6 + [_I] * 5 + [_F, _P],
    "rs_flash_fwd": [_P] * 7 + [_I] * 5 + [_F, _P],
    "rs_flash_bwd_dq": [_P] * 10 + [_I] * 5 + [_F, _P],
    "rs_flash_bwd_dkv": [_P] * 10 + [_I] * 5 + [_F, _P],
    "rs_transformer_layer_fwd": [_P] * 20 + [_I] * 6 + [_F, _F, _P],
    "rs_transformer_layer_fwd_train": [_P] * 26 + [_I] * 6 + [_F, _F] + _DROP + [_P],
    "rs_transformer_layer_bwd": [_P] * 34 + [ctypes.c_longlong] + [_I] * 6 + [_F] + _DROP
    + [_P],
    "rs_transformer_layer_fwd_tiles": [_I] * 4 + [_P],
    "rs_transformer_layer_bwd_workspace": [_I] * 5,
    "rs_transformer_layer_bwd_splits": [_I] * 3 + [_P],
    "rs_catalog_lse_splits": [_I] * 4,
    "rs_catalog_lse_resident": [_I] * 2,
    "rs_catalog_lse_fwd": [_P] * 4 + [_I] * 3 + [_P],
    "rs_catalog_lse_bwd_dq": [_P] * 6 + [_I] * 3 + [_P],
    "rs_catalog_lse_bwd_ditems": [_P] * 6 + [_I] * 3 + [_P],
}
_RESTYPES = {"rs_transformer_layer_bwd_workspace": ctypes.c_longlong,
             "rs_transformer_layer_fwd_tiles": None}


class KernelLibrary:
    """The loaded shared library, with how it was built."""

    def __init__(self, lib: ctypes.CDLL, path: str, build_seconds: float, ptxas_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when an up-to-date build was reused
        self.ptxas_log = ptxas_log
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)

    def call(self, name: str, *args) -> None:
        """Call a launcher; raise if it reports a CUDA error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed with cudaError_t {err}")


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    files = sorted(os.listdir(_CSRC))
    return ([os.path.join(_CSRC, f) for f in files if f.endswith(".cu")],
            [os.path.join(_CSRC, f) for f in files if f.endswith((".cu", ".cuh"))])


def _build(nvcc: str, sources, out_path: str) -> str:
    """Compile every source in its own nvcc process, all started together,
    then link. Returns the compilers' output (ptxas' register and shared
    memory report)."""
    tmp = f"{out_path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in sources]
    procs = [subprocess.Popen([nvcc, *ARCH_FLAGS, *CFLAGS, "-c", src, "-o", obj],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, out_path)
    return "".join(logs)


def load() -> KernelLibrary:
    """Build (at first use) and load the kernel library."""
    global _library
    with _lock:
        if _library is not None:
            return _library
        sources, inputs = _sources()
        digest = hashlib.sha256(" ".join(ARCH_FLAGS + CFLAGS).encode())
        for path in inputs:
            with open(path, "rb") as f:
                digest.update(f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so_path = os.path.join(BUILD_DIR, f"librecstudio_kernels_{digest.hexdigest()[:16]}.so")
        log_path = so_path + ".log"
        seconds, log = 0.0, ""
        if os.path.isfile(so_path):
            if os.path.isfile(log_path):
                with open(log_path) as f:
                    log = f.read()
        else:
            t0 = time.perf_counter()
            log = _build(_nvcc(), sources, so_path)
            seconds = time.perf_counter() - t0
            with open(log_path, "w") as f:
                f.write(log)
        _library = KernelLibrary(ctypes.CDLL(so_path), so_path, seconds, log)
        return _library
