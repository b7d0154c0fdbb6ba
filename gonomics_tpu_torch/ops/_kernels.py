"""Builds the CUDA kernels in ``csrc/`` with ``nvcc`` for ``sm_90a`` and
binds their plain C entry points with ctypes.

The library is compiled into the package's git-ignored ``_build/`` on
the first launch, never at import, so the package imports on machines
without ``nvcc``. Every pointer and the stream travel as ``c_void_p``;
each entry returns ``cudaGetLastError()`` and ``check`` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

from .._buildlib import build_shared

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
SOURCES = [os.path.join(_CSRC, "banded.cu")]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_vp = ctypes.c_void_p
_int = ctypes.c_int
_SIGNATURES = {
    "banded_dp_launch": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int,
                         _vp, _vp, _vp, _vp],
    "banded_walk_pack_launch": [_vp, _vp, _vp, _vp, _int, _int, _int, _int,
                                _vp, _vp, _vp, _vp],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = build_shared("libbanded.so", SOURCES, [_nvcc()] + NVCC_FLAGS)
            cdll = ctypes.CDLL(so)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.restype = _int
                fn.argtypes = argtypes
            cdll.banded_error_string.restype = ctypes.c_char_p
            cdll.banded_error_string.argtypes = [_int]
            _lib = cdll
        return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib().banded_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
