"""Builds the CUDA kernels in ``csrc/`` with ``nvcc`` for ``sm_90a`` and
binds their plain C entry points with ctypes.

Each source is its own shared library (``banded.cu`` -> ``libbanded.so``,
``wavefront.cu`` -> ``libwavefront.so``, ``gsw_dp.cu`` ->
``libgsw_dp.so``), compiled into the package's
git-ignored ``_build/`` on the first launch of one of its kernels, never
at import, so the package imports on machines without ``nvcc``.
``build_all`` compiles them side by side. Every pointer and the stream
travel as ``c_void_p``; each entry returns ``cudaGetLastError()`` and
``check`` raises on a non-zero code, naming the kernel. ``as_vec`` and
``expect`` are the argument checks the wrappers make before a launch.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import torch

from .._buildlib import build_shared

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
# the headers that sources in csrc/ include
_HEADERS = (os.path.join(_CSRC, "walk_ops.cuh"),)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_vp = ctypes.c_void_p
_int = ctypes.c_int
# library -> its entry points' argument types
_SIGNATURES = {
    "banded": {
        "banded_built": [_vp],
        "banded_shape": [_int, _int, _int, _int, _int, _int, _vp],
        "banded_dp_launch": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int,
                             _int, _int, _int, _vp, _vp, _vp, _vp],
        "banded_fused_launch": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int,
                                _int, _int, _int, _int, _int, _vp, _vp, _vp,
                                _vp, _vp, _vp, _vp],
        "banded_walk_pack_launch": [_vp, _vp, _vp, _vp, _int, _int, _int,
                                    _int, _vp, _vp, _vp, _vp],
    },
    "wavefront": {
        "affine_fwd_block_launch": [_vp, _vp, _vp, _int, _int, _int, _int,
                                    _int, _int, _int, _int, _int, _int, _vp,
                                    _vp, _vp, _vp, _vp],
        "affine_fwd_block_clusters": [_int, _int, _int, _int, _vp],
        "affine_fwd_strip_launch": [_vp, _vp, _vp, _int, _int, _int, _int,
                                    _int, _int, _int, _int, _int, _int, _int,
                                    _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp],
        "affine_bwd_window_built": [_vp],
        "affine_bwd_window_clusters": [_int, _int, _int, _vp],
        "affine_bwd_window_launch": [_vp, _vp, _vp, _int, _int, _int, _int,
                                     _int, _int, _int, _int, _int, _int,
                                     _vp, _vp, _vp, _vp, _vp, _vp],
        "lowmem_walk_block_launch": [_vp, _vp, _int, _int, _int, _int, _vp,
                                     _vp, _vp, _vp, _vp],
        "affine_stream_built": [_vp],
        "affine_stream_shape": [_int, _int, _int, _vp],
        "affine_stream_launch": [_vp, _vp, _vp, _int, _int, _int, _int, _int,
                                 _int, _vp, _vp, _vp],
        "affine_score_diag_built": [_vp],
        "affine_score_diag_shape": [_int, _int, _int, _int, _vp],
        "affine_score_diag_launch": [_vp, _vp, _vp, _vp, _int, _int, _int,
                                     _int, _int, _int, _int, _int, _int, _int,
                                     _vp, _vp, _vp],
        "trace_diag_built": [_int, _vp],
        "trace_diag_shape": [_int, _int, _int, _int, _int, _int, _vp],
        "trace_diag_launch": [_vp, _vp, _vp, _vp, _int, _int, _int, _int,
                              _int, _int, _int, _int, _vp, _vp, _vp, _vp,
                              _vp, _vp],
    },
    "gsw_dp": {
        "local_wavefront_launch": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int,
                                   _int, _int, _vp, _vp, _vp, _vp, _vp, _vp],
        "gsw_right_wavefront_launch": [_vp, _vp, _vp, _vp, _vp, _int, _int,
                                       _int, _int, _int, _vp, _vp, _vp, _vp,
                                       _vp],
        "gsw_dp_built": [_vp],
        "gsw_dp_launch_shape": [_int, _int, _int, _vp],
        "gsw_walk_pack_launch": [_vp, _vp, _vp, _vp, _vp, _int, _int, _int,
                                 _int, _vp, _vp],
    },
}
# kernel name (as check() is given it) -> its library
_LIBRARY_OF = {"banded_dp": "banded", "banded_align_fused": "banded",
               "banded_walk_pack": "banded",
               "trace_diag": "wavefront",
               "affine_fwd_block": "wavefront",
               "affine_fwd_strip": "wavefront",
               "affine_bwd_window": "wavefront",
               "lowmem_walk_block": "wavefront",
               "affine_stream": "wavefront", "affine_score_diag": "wavefront",
               "local_wavefront": "gsw_dp", "gsw_right_wavefront": "gsw_dp",
               "gsw_walk_pack": "gsw_dp"}

_locks = {name: threading.Lock() for name in _SIGNATURES}
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def lib(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` ("banded", "wavefront" or "gsw_dp"),
    built on first use."""
    with _locks[name]:
        if name not in _libs:
            so = build_shared(f"lib{name}.so",
                              [os.path.join(_CSRC, f"{name}.cu")],
                              [_nvcc()] + NVCC_FLAGS, headers=_HEADERS)
            cdll = ctypes.CDLL(so)
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(cdll, fn_name)
                fn.restype = _int
                fn.argtypes = argtypes
            err = getattr(cdll, f"{name}_error_string")
            err.restype = ctypes.c_char_p
            err.argtypes = [_int]
            _libs[name] = cdll
        return _libs[name]


def build_all() -> None:
    """Build every kernel library, one nvcc for each source, all started
    together; raises the first build error."""
    errors = []

    def build(name: str) -> None:
        try:
            lib(name)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=build, args=(n,)) for n in _SIGNATURES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def as_vec(x, B: int, device) -> torch.Tensor:
    """x as a (B,) int32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(B)


def expect(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str,
           device: torch.device) -> torch.Tensor:
    """t made contiguous, after raising unless it has this dtype, shape
    and device (the checks a wrapper makes before a launch)."""
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: want {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def check(rc: int, kernel: str) -> None:
    """Raise when the launch of ``kernel`` returned a CUDA error code."""
    if rc != 0:
        name = _LIBRARY_OF[kernel]
        msg = getattr(lib(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")
