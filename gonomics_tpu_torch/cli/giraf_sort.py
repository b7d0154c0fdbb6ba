"""girafSort: external sort of giraf records by graph topological
order; a copy of ``gonomics_tpu/cli/giraf_sort.py`` (78 lines, whole),
gonomics' ``cmdx/girafSort`` and ``sort/sort.go:94-226``. Chunks of
``-chunkSize`` records are sorted into files under a temporary directory
and merged through a heap; the node order goes to ``<output>.idx``."""

from __future__ import annotations

import argparse
import heapq
import os
import sys
import tempfile

from .. import fileio, graph as graphmod
from ..io import giraf as girafio


def _sort_key(g, order_map: dict[int, int]):
    """byTopologicalOrder.Less (sort.go:35): first node's rank, then
    TStart, then the remaining ranks lexicographically (shorter wins)."""
    sp = [order_map.get(n, 0) for n in g.path.nodes]
    return (sp[0], g.path.t_start, tuple(sp[1:]))


def giraf_external_merge_sort(giraf_file: str, sort_order: list[int],
                              lines_per_chunk: int, out_file: str) -> None:
    """sort.GirafExternalMergeSort (sort.go:94): chunk -> tmp files ->
    k-way heap merge; writes the node order to out_file.idx."""
    order_map = {n: i for i, n in enumerate(sort_order)}
    records = girafio.read(giraf_file)
    chunks: list[str] = []
    tmpdir = tempfile.mkdtemp(prefix="girafsort_")
    for ci, start in enumerate(range(0, len(records), lines_per_chunk)):
        chunk = records[start:start + lines_per_chunk]
        chunk.sort(key=lambda g: _sort_key(g, order_map))
        path = os.path.join(tmpdir, f"tmp_{ci}")
        girafio.write(path, chunk)
        chunks.append(path)

    readers = [iter(girafio.read(c)) for c in chunks]
    heap = []
    for i, r in enumerate(readers):
        first = next(r, None)
        if first is not None:
            heapq.heappush(heap, (_sort_key(first, order_map), i, first))
    with fileio.easy_create(out_file) as out:
        while heap:
            _, i, g = heapq.heappop(heap)
            out.write(girafio.to_string(g) + "\n")
            nxt = next(readers[i], None)
            if nxt is not None:
                heapq.heappush(heap, (_sort_key(nxt, order_map), i, nxt))
    for c in chunks:
        os.remove(c)
    os.rmdir(tmpdir)
    with fileio.easy_create(out_file + ".idx") as idx:
        for n in sort_order:
            idx.write(f"{n}\n")


def giraf_sort(giraf_file: str, graph_file: str, lines_per_chunk: int,
               out_file: str) -> list[int]:
    g = graphmod.read(graph_file)
    topo = graphmod.get_sort_order(g)
    giraf_external_merge_sort(giraf_file, topo, lines_per_chunk, out_file)
    return topo


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="girafSort")
    p.add_argument("input")
    p.add_argument("graph")
    p.add_argument("output")
    p.add_argument("-chunkSize", type=int, default=1000000)
    a = p.parse_args(argv if argv is not None else sys.argv[1:])
    giraf_sort(a.input, a.graph, a.chunkSize, a.output)


if __name__ == "__main__":
    main()
