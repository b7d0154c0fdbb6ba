"""File handles that read gzip transparently: the subset of
``gonomics_tpu/fileio.py`` that the readers and the ``gsw`` CLI use.

``easy_open`` sniffs the gzip magic rather than the extension;
``easy_create`` gzips when the name ends in ``.gz``; ``"-"`` means stdin
or stdout.
"""

from __future__ import annotations

import gzip
import io
import sys
from typing import IO, Iterator

GZIP_MAGIC = b"\x1f\x8b"


def easy_open(filename: str) -> IO[str]:
    if filename == "-" or filename == "/dev/stdin":
        return sys.stdin
    f = open(filename, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == GZIP_MAGIC:
        return io.TextIOWrapper(gzip.GzipFile(fileobj=f), encoding="utf-8")
    return io.TextIOWrapper(f, encoding="utf-8")


def easy_open_binary(filename: str) -> IO[bytes]:
    f = open(filename, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == GZIP_MAGIC:
        return gzip.GzipFile(fileobj=f)  # type: ignore[return-value]
    return f


def easy_create(filename: str) -> IO[str]:
    if filename == "-" or filename == "/dev/stdout":
        return sys.stdout
    if filename.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(filename, "wb"), encoding="utf-8")
    return open(filename, "w", encoding="utf-8")


def real_lines(f: IO[str]) -> Iterator[str]:
    """Lines without their newline, skipping '#' comment lines."""
    for ln in f:
        if not ln.startswith("#"):
            yield ln.rstrip("\n")
