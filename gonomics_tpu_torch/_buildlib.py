"""Builds the port's shared libraries into its git-ignored ``_build/``
directory on first use.

One function serves the host library (``g++``, ``native.py``) and the
CUDA kernels (``nvcc``, ``ops/_kernels.py``). A file lock serialises
concurrent builders (several test workers, or threads of one process),
and the library is compiled under a temporary name and renamed into
place, so a reader never loads a half-written file.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def build_shared(out_name: str, sources: list[str], cmd: list[str],
                 libs: tuple[str, ...] = (),
                 headers: tuple[str, ...] = ()) -> str:
    """Return the path of BUILD_DIR/out_name, compiling it first when it
    is missing or older than any source or any of the ``headers`` the
    sources include. ``cmd`` is the compiler argv up to the output: ``cmd
    + ["-o", tmp] + sources + libs`` is run. Raises CalledProcessError,
    with the compiler's output attached, on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, out_name)
    newest = max(os.path.getmtime(s) for s in (*sources, *headers))

    def fresh() -> bool:
        return os.path.exists(out) and os.path.getmtime(out) >= newest

    if fresh():
        return out
    with open(out + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not fresh():
            tmp = f"{out}.{os.getpid()}.tmp"
            try:
                subprocess.run(cmd + ["-o", tmp] + sources + list(libs),
                               check=True, capture_output=True, text=True)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return out
