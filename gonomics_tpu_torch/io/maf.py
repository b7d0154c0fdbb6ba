"""MAF alignment blocks of s, i and e lines, their reader and writer, and
their splice into a gapped alignment on a reference: a copy of
``gonomics_tpu/io/maf.py`` (256 lines, whole; gonomics'
``maf/{maf,compare,convert}.go``), which the maf tools use.

Kept as the reference has them: any line starting with ``a`` opens a
block; the last line that is not a comment must be blank; the ``i`` and
``e`` statuses are single characters of ``CINnMT`` and ``CIMnT``; the
writer writes only ``a`` and ``s`` lines, the score with ``.1f`` and each
block's field widths its own; ``to_fasta`` checks the FASTA's length
against the first block in file order, then sorts the blocks with
``sort_by_pos_rev``, and a reference species missing from a block raises
AttributeError.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

from .. import dna, fileio
from . import fasta as fastaio

_I_STATUSES = set("CINnMT")
_E_STATUSES = set("CIMnT")


@dataclass
class MafSLine:
    """maf.MafSLine (maf.go:19)."""

    src: str
    start: int
    size: int
    strand: bool
    src_size: int
    seq: np.ndarray


@dataclass
class MafILine:
    """maf.MafILine (maf.go:28)."""

    src: str
    left_status: str
    left_count: int
    right_status: str
    right_count: int


@dataclass
class MafELine:
    """maf.MafELine (maf.go:37)."""

    src: str
    start: int
    size: int
    strand: bool
    src_size: int
    status: str


@dataclass
class MafSpecies:
    """maf.MafSpecies (maf.go:47)."""

    src: str
    s_line: MafSLine | None = None
    i_line: MafILine | None = None
    e_line: MafELine | None = None


@dataclass
class Maf:
    """maf.Maf (maf.go:54)."""

    score: float = 0.0
    species: list[MafSpecies] = field(default_factory=list)


def src_to_assembly_and_chrom(src: str) -> tuple[str, str]:
    """maf.SrcToAssemblyAndChrom (maf.go:65)."""
    dots = src.count(".")
    if dots == 0:
        return src, ""
    if dots == 1:
        a, c = src.split(".")
        return a, c
    raise SystemExit(f"Error: too many dots within maf src: {src}")


def _parse_i_status(s: str) -> str:
    if s not in _I_STATUSES:
        raise SystemExit("Error: unexpected status for 'i' line in a Maf: "
                         f"{s}")
    return s


def _parse_e_status(s: str) -> str:
    if s not in _E_STATUSES:
        raise SystemExit("Error: unexpected status for 'e' line in a Maf: "
                         f"{s}")
    return s


def find_species_exact_match(m: Maf, src: str) -> MafSpecies | None:
    """maf.FindSpeciesExactMatch (maf.go:180)."""
    for sp in m.species:
        if sp.src == src:
            return sp
    return None


def find_species_before_dot(m: Maf, assembly: str) -> MafSpecies | None:
    """maf.FindSpeciesBeforeDot (maf.go:195)."""
    for sp in m.species:
        if src_to_assembly_and_chrom(sp.src)[0] == assembly:
            return sp
    return None


def read(filename: str) -> list[Maf]:
    """maf.Read (maf.go:209)."""
    answer: list[Maf] = []
    curr: Maf | None = None
    prev = ""
    with fileio.easy_open(filename) as f:
        lines = [ln.rstrip("\n") for ln in f
                 if not ln.startswith("#")]
    for line in lines:
        if line.startswith("a"):
            if curr is not None:
                raise SystemExit("Error: no blank line before another 'a' "
                                 f"line at line: {line}")
            curr = Maf()
            for word in line.split()[1:]:
                key, _, val = word.partition("=")
                if key == "score":
                    curr.score = float(val)
        elif line[:1] in ("s", "i", "e"):
            if curr is None:
                raise SystemExit("Error: did not find an 'a' line before "
                                 f"this, 'sie' line: {line}")
            w = line.split()
            sp = find_species_exact_match(curr, w[1])
            if sp is None:
                sp = MafSpecies(src=w[1])
                curr.species.append(sp)
            if line.startswith("s"):
                if sp.s_line is not None or len(w) != 7:
                    raise SystemExit(f"Error: bad 's' line: {line}")
                sp.s_line = MafSLine(w[1], int(w[2]), int(w[3]),
                                     w[4] == "+", int(w[5]),
                                     dna.from_string(w[6]))
            elif line.startswith("i"):
                if sp.i_line is not None or len(w) != 6:
                    raise SystemExit(f"Error: bad 'i' line: {line}")
                sp.i_line = MafILine(w[1], _parse_i_status(w[2]),
                                     int(w[3]), _parse_i_status(w[4]),
                                     int(w[5]))
            else:
                if sp.e_line is not None or len(w) != 7:
                    raise SystemExit(f"Error: bad 'e' line: {line}")
                sp.e_line = MafELine(w[1], int(w[2]), int(w[3]),
                                     w[4] == "+", int(w[5]),
                                     _parse_e_status(w[6]))
        elif line == "":
            answer.append(curr)
            curr = None
        else:
            raise SystemExit("Unexpected format in maf file on line: "
                             f"{line}")
        prev = line
    if prev != "":
        raise SystemExit("Error: maf should have a blank line as the last "
                         "non-comment line")
    return answer


def _field_sizes(m: Maf) -> tuple[int, int, int, int]:
    """calculateFieldSizes (maf.go:270)."""
    src_len = start_len = size_len = src_size_len = 1
    for sp in m.species:
        for ln in (sp.s_line, sp.e_line):
            if ln is not None:
                src_len = max(src_len, len(ln.src))
                start_len = max(start_len, len(str(ln.start)))
                size_len = max(size_len, len(str(ln.size)))
                src_size_len = max(src_size_len, len(str(ln.src_size)))
        if sp.i_line is not None:
            src_len = max(src_len, len(sp.i_line.src))
    return src_len, start_len, size_len, src_size_len


def write_to_handle(f, m: Maf) -> None:
    """maf.WriteToFileHandle (maf.go:318): only a + s lines are emitted."""
    f.write(f"a score={m.score:.1f}\n")
    src_w, start_w, size_w, src_size_w = _field_sizes(m)
    for sp in m.species:
        s = sp.s_line
        if s is not None:
            strand = "+" if s.strand else "-"
            f.write(f"s {s.src:<{src_w}} {s.start:>{start_w}} "
                    f"{s.size:>{size_w}} {strand} "
                    f"{s.src_size:>{src_size_w}} {dna.to_string(s.seq)}\n")
    f.write("\n")


def write(filename: str, blocks: list[Maf]) -> None:
    """maf.Write (maf.go:346)."""
    with fileio.easy_create(filename) as f:
        f.write("##maf version=1\n")
        for m in blocks:
            write_to_handle(f, m)


def _compare_pos(a: Maf, b: Maf) -> int:
    """comparePos (compare.go:117): by ref src, start, size."""
    x, y = a.species[0].s_line, b.species[0].s_line
    if x.src != y.src:
        return -1 if x.src < y.src else 1
    for u, v in ((x.start, y.start), (x.size, y.size)):
        if u != v:
            return -1 if u < v else 1
    return 0


def sort_by_pos_rev(blocks: list[Maf]) -> None:
    """maf.SortByPosRev (compare.go:157)."""
    blocks.sort(key=functools.cmp_to_key(_compare_pos), reverse=True)


def to_fasta(blocks: list[Maf], ref: fastaio.Fasta,
             species: list[str]) -> list[fastaio.Fasta]:
    """maf.ToFasta (convert.go:69): splice maf blocks into a gap-filled
    alignment anchored on the reference sequence."""
    if len(ref.seq) != blocks[0].species[0].s_line.src_size:
        raise SystemExit("Error: ref seq supplied as fasta should match "
                         "the length of the first seq in the first maf "
                         "block")
    aln = [fastaio.Fasta(species[0], np.array(ref.seq, copy=True))]
    aln += [fastaio.Fasta(sp, dna.all_gaps(len(ref.seq)))
            for sp in species[1:]]
    sort_by_pos_rev(blocks)
    for m in blocks:
        ref_s = m.species[0].s_line
        if ref_s is None:
            raise SystemExit("Error: did not find a SLine for reference "
                             "species in maf")
        start, end = ref_s.start, ref_s.start + ref_s.size
        for rec in aln:
            sp = find_species_before_dot(m, rec.name)
            if rec is aln[0]:
                got = dna.to_upper(sp.s_line.seq)
                want = dna.to_upper(rec.seq[start:end])
                if dna.to_string(got[got != dna.GAP]) != dna.to_string(
                        want[want != dna.GAP]):
                    raise SystemExit("Error: reference sequence in maf "
                                     "does not match that in the fasta")
            if sp is None or sp.s_line is None:
                ins = dna.all_gaps(len(ref_s.seq))
            else:
                ins = sp.s_line.seq
            rec.seq = np.concatenate([rec.seq[:start], ins,
                                      rec.seq[end:]])
    return aln
