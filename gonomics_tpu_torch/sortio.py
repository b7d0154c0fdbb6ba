"""External merge sort, as ``mergesort`` runs it: a copy of
``gonomics_tpu/sortio.py`` (``external_merge_sort`` :20-67).

Records are sorted a chunk at a time, each chunk spilled to a temporary
pickle file, and the sorted chunks merged through a heap. The sort is
stable within and across chunks: ``heapq.merge`` takes equal keys in
the order of the chunks.
"""

from __future__ import annotations

import heapq
import os
import pickle
import tempfile
from typing import Callable, Iterable, Iterator, TypeVar

E = TypeVar("E")

MAX_TMP_FILES = 1000  # gonomics' sort.go


def external_merge_sort(records: Iterable[E], records_per_chunk: int,
                        key: Callable[[E], tuple],
                        tmp_dir: str | None = None) -> Iterator[E]:
    """Yields records in sorted order; spills to disk every
    records_per_chunk items. The temporary directory is removed once the
    records are out, also where nothing was spilled (the JAX function
    leaves it behind empty there)."""
    chunk: list[E] = []
    files: list[str] = []
    tdir = tempfile.mkdtemp(dir=tmp_dir or None, prefix="gonomics_sort_")

    def spill() -> None:
        chunk.sort(key=key)
        if len(files) >= MAX_TMP_FILES:
            raise RuntimeError("too many temporary sort files")
        path = os.path.join(tdir, f"chunk_{len(files)}.pkl")
        with open(path, "wb") as f:
            pickle.dump(chunk, f)
        files.append(path)
        chunk.clear()

    def reader(path: str) -> Iterator[E]:
        with open(path, "rb") as f:
            yield from pickle.load(f)

    try:
        for rec in records:
            chunk.append(rec)
            if len(chunk) >= records_per_chunk:
                spill()
        if not files:
            chunk.sort(key=key)
            yield from chunk
            return
        if chunk:
            spill()
        yield from heapq.merge(*(reader(p) for p in files), key=key)
    finally:
        for p in files:
            try:
                os.remove(p)
            except OSError:
                pass
        try:
            os.rmdir(tdir)
        except OSError:
            pass
