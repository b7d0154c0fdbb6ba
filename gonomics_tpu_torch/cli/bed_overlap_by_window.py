"""bedOverlapByWindow: for a window starting at every base of every
chromosome, the bed bases that fall in it; a port of
``gonomics_tpu/cli/bed_overlap_by_window.py`` (46 lines), its flags,
defaults and output unchanged.

    gonomics-torch bedOverlapByWindow in.bed chrom.sizes out.bed
        [-windowSize 5000]

One line a base, chromosomes in the sizes file's order; windows run past
the chromosome's end. Counts are uint32; a chrom missing from the sizes
raises KeyError. Where the JAX adds one to a slice of window starts for
each covered base, the port takes the same counts from prefix sums of
the coverage: the window at j holds the coverage summed over [j, j + w).
Bases before 0 take the JAX's slice, whose negative stop wraps.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import fileio
from ..io import bed as bedio
from ..io import chrom_info


def bed_overlap_by_window(in_file: str, chrom_sizes: str, out_file: str,
                          window_size: int = 5000) -> None:
    c_info = chrom_info.read_to_slice(chrom_sizes)
    w = max(window_size, 0)
    sizes = {c.name: c.size for c in c_info}
    # coverage changes over bases [0, size + w), which are all that a
    # window start in [0, size) reads
    diff = {n: np.zeros(s + w + 1, np.int64) for n, s in sizes.items()}
    wrapped = {n: np.zeros(s, np.int64) for n, s in sizes.items()}
    for b in bedio.read(in_file):
        d, arr = diff[b.chrom], wrapped[b.chrom]
        for p in range(b.chrom_start, min(b.chrom_end, 0)):
            arr[max(0, p - (window_size - 1)):p + 1] += 1
        lo = min(max(b.chrom_start, 0), len(d) - 1)
        hi = min(b.chrom_end, len(d) - 1)
        if lo < hi:
            d[lo] += 1
            d[hi] -= 1
    counts = {}
    for name, s in sizes.items():
        cover = np.cumsum(diff[name][:-1])
        csum = np.concatenate([[0], np.cumsum(cover)])
        total = csum[w:w + s] - csum[:s] + wrapped[name]
        counts[name] = total.astype(np.uint32).tolist()
    with fileio.easy_create(out_file) as out:
        for c in c_info:
            out.write("".join(f"{c.name}\t{j}\t{j + window_size}\t.\t{v}\n"
                              for j, v in enumerate(counts[c.name])))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="bedOverlapByWindow")
    p.add_argument("input")
    p.add_argument("chromSizes")
    p.add_argument("output")
    p.add_argument("-windowSize", type=int, default=5000)
    a = p.parse_args(argv)
    bed_overlap_by_window(a.input, a.chromSizes, a.output, a.windowSize)


if __name__ == "__main__":
    main()
