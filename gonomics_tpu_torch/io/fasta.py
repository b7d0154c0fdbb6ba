"""FASTA records, reading and writing, multiFa coordinates and assembly
statistics: the subset of ``gonomics_tpu/io/fasta.py`` that the read
aligner, the ``gsw`` CLI, ``samConsensus``, the fasta tools and axTools
use (``_parse`` :34, ``read`` :57, ``read_forced`` :67, ``to_map`` :73,
``read_to_map`` :82, ``write_fasta`` :86, ``write`` :95,
``ref_pos_to_aln_pos`` and
``ref_pos_to_aln_pos_counter`` :105-126, ``aln_pos_to_ref_pos`` :127,
``aln_pos_to_ref_pos_counter`` :133, ``make_contig_list``,
``calculate_n50_l50``, ``assembly_stats`` and ``write_assembly_stats``
:157-219), the multiFa helpers of the multiFa tools (``copy``,
``extract``, ``remove_gaps``, ``find_sequence_index`` :221-255,
``_present``, ``scan_n``, ``scan_present_base``,
``scan_present_base_both``, ``scan_present_base_either`` :258-296,
``segregating_columns`` and ``segregating_sites_fasta`` :299-310),
``bin_genome_no_breaks`` (:312-350) and the Dunn index's helpers
``copy_subset``, ``remove_missing_mult``, ``dist_column`` and
``num_segregating_sites`` (:351-375)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import IO, Iterator

import numpy as np

from .. import dna, fileio


@dataclass
class Fasta:
    name: str
    seq: np.ndarray = field(default_factory=lambda: np.zeros(0, dtype=np.int8))


def _parse(f: IO[str], conv) -> Iterator[Fasta]:
    """The records of f, each sequence line converted by conv."""
    name: str | None = None
    chunks: list[np.ndarray] = []
    for line in fileio.real_lines(f):
        if line.startswith(">"):
            if name is not None:
                yield Fasta(name, _concat(chunks))
            name = line[1:]
            chunks = []
        elif line:
            if name is None:
                raise ValueError("fasta record missing a sequence name (e.g. >chr1)")
            chunks.append(conv(line))
    if name is not None:
        yield Fasta(name, _concat(chunks))


def _concat(chunks: list[np.ndarray]) -> np.ndarray:
    if not chunks:
        return np.zeros(0, dtype=np.int8)
    return np.concatenate(chunks)


def read(filename: str) -> list[Fasta]:
    """All records of a FASTA file; names must be unique."""
    with fileio.easy_open(filename) as f:
        records = list(_parse(f, dna.from_string))
    names = [r.name for r in records]
    if len(set(names)) != len(names):
        raise ValueError("fasta record names must be unique")
    return records


def read_forced(filename: str) -> list[Fasta]:
    """All records of a FASTA file, invalid characters masked to N (or
    to LOWER_N where lowercase); names may repeat (fasta.py:67-70)."""
    with fileio.easy_open(filename) as f:
        return list(_parse(f, dna.from_string_forced))


def to_map(records: list[Fasta]) -> dict[str, np.ndarray]:
    """{name: sequence}; a name used twice raises (fasta.py:73-79)."""
    m: dict[str, np.ndarray] = {}
    for r in records:
        if r.name in m:
            raise ValueError(f"{r.name} used for multiple fasta records")
        m[r.name] = r.seq
    return m


def read_to_map(filename: str) -> dict[str, np.ndarray]:
    """{name: sequence} of a FASTA file (fasta.py:82-83)."""
    return to_map(read(filename))


def write_fasta(f: IO[str], rec: Fasta, line_length: int = 50) -> None:
    """One record, its sequence in lines of line_length characters."""
    f.write(f">{rec.name}\n")
    s = np.asarray(rec.seq)
    for i in range(0, len(s), line_length):
        f.write(dna.to_string(s[i:i + line_length]))
        f.write("\n")


def write(filename: str, records: list[Fasta], line_length: int = 50) -> None:
    with fileio.easy_create(filename) as f:
        for rec in records:
            write_fasta(f, rec, line_length)


def ref_pos_to_aln_pos(record: Fasta, ref_pos: int) -> int:
    """The alignment column of reference position ref_pos in a multiFa
    record (multiFa.go:10)."""
    return ref_pos_to_aln_pos_counter(record, ref_pos, 0, 0)


def ref_pos_to_aln_pos_counter(record: Fasta, ref_pos: int,
                               ref_start: int, aln_start: int) -> int:
    """The column, after aln_start, where the count of non-gap columns
    from ref_start reaches ref_pos (multiFa.go:24); IndexError past the
    record's end."""
    if ref_start > ref_pos:
        raise ValueError("refStart > RefPos")
    if ref_start == ref_pos:
        return aln_start
    seq = np.asarray(record.seq)
    ng = np.cumsum(seq[aln_start + 1:] != dna.GAP)
    idx = int(np.searchsorted(ng, ref_pos - ref_start, side="left"))
    if idx >= len(ng):
        raise IndexError("Ran out of chromosome.")
    return aln_start + 1 + idx


def aln_pos_to_ref_pos(record: Fasta, aln_pos: int) -> int:
    """The reference position of the base at alignment column aln_pos:
    the non-gap columns before it (multiFa.go:84)."""
    return aln_pos_to_ref_pos_counter(record, aln_pos, 0, 0)


def aln_pos_to_ref_pos_counter(record: Fasta, aln_pos: int,
                               ref_start: int, aln_start: int) -> int:
    """The reference position of alignment column aln_pos: ref_start plus
    the non-gap columns in [aln_start, aln_pos), counted from column 0
    when aln_start lies past aln_pos (fasta.py:133-142)."""
    seq = np.asarray(record.seq)
    if aln_start > aln_pos:
        ref_start, aln_start = 0, 0
    if aln_pos > len(seq):
        raise IndexError("Ran out of chromosome.")
    return ref_start + int((seq[aln_start:aln_pos] != dna.GAP).sum())


def make_contig_list(records: list[Fasta], count_lower_as_gaps: bool):
    """The contig lengths of records, split on N (and on lower case with
    count_lower_as_gaps) (assemblyStats.go:62)."""
    out: list[int] = []
    for rec in records:
        seq = np.asarray(rec.seq)
        is_gap = seq == dna.N
        if count_lower_as_gaps:
            is_gap |= (seq >= dna.LOWER_A) & (seq <= dna.LOWER_N)
        run = 0
        for g in is_gap:
            if g:
                if run:
                    out.append(run)
                run = 0
            else:
                run += 1
        if run:
            out.append(run)
    return out


def calculate_n50_l50(sorted_contigs: list[int], half_genome: int):
    """(N50, L50) of ascending contig lengths (assemblyStats.go:44)."""
    total = 0
    l50 = 0
    for i in range(len(sorted_contigs) - 1, -1, -1):
        l50 += 1
        total += sorted_contigs[i]
        if total >= half_genome:
            return sorted_contigs[i], l50
    raise ValueError("unable to calculate N50/L50")


def assembly_stats(infile: str, count_lower_as_gaps: bool):
    """(N50, L50, halfGenome, genomeLength, largestContig, numContigs)
    of a FASTA file (assemblyStats.go:15)."""
    contigs = make_contig_list(read(infile), count_lower_as_gaps)
    if not contigs:
        raise ValueError("contig list is empty")
    genome_length = sum(contigs)
    contigs.sort()
    half = genome_length // 2
    n50, l50 = calculate_n50_l50(contigs, half)
    return n50, l50, half, genome_length, contigs[-1], len(contigs)


def write_assembly_stats(name: str, outfile: str, n50: int, l50: int,
                         half: int, genome_length: int, largest: int,
                         num_contigs: int) -> None:
    """WriteAssemblyStats (assemblyStats.go:110)."""
    with fileio.easy_create(outfile) as f:
        f.write(f"Assembly Name: {name}\n")
        f.write(f"halfGenome: {half}\n")
        f.write(f"genomeLength: {genome_length}\n")
        f.write(f"Number of contigs: {num_contigs}\n")
        f.write(f"Largest Contig: {largest}\n")
        f.write(f"N50: {n50}\n")
        f.write(f"L50: {l50}\n")


def copy(rec: Fasta) -> Fasta:
    """A record with its own copy of the sequence (modify.go:55)."""
    return Fasta(rec.name, np.array(rec.seq, dtype=np.int8, copy=True))


def extract(rec: Fasta, start: int, end: int, name: str) -> Fasta:
    """Columns [start, end) of rec under name (fasta.go:184)."""
    return Fasta(name, np.asarray(rec.seq)[start:end])


def remove_gaps(records: list[Fasta]) -> list[Fasta]:
    """records with their gaps taken out, in place (modify.go:15)."""
    for r in records:
        s = np.asarray(r.seq)
        r.seq = s[s != dna.GAP]
    return records


def find_sequence_index(records: list[Fasta], query_name: str) -> int:
    """The index of the record named query_name; ValueError on a name
    used twice, exit on one not found (multiFa.go:441)."""
    idx: dict[str, int] = {}
    for i, r in enumerate(records):
        if r.name in idx:
            raise ValueError(f"{r.name} used for multiple fasta records. "
                             "record names must be unique.")
        idx[r.name] = i
    if query_name not in idx:
        raise SystemExit(f"queryName {query_name} not found in fasta "
                         "records.")
    return idx[query_name]


def _present(seq: np.ndarray) -> np.ndarray:
    return np.asarray(seq) <= dna.T  # upper-case A, C, G, T are 0..3


def scan_n(records: list[Fasta], query_name: str) -> list[tuple[int, int]]:
    """The upper-case N of the query record, each as a one-base [start,
    end) span in reference (records[0]) coordinates (multiFa.go:353)."""
    query = np.asarray(records[find_sequence_index(records, query_name)].seq)
    out: list[tuple[int, int]] = []
    last_ref = last_aln = 0
    for i in np.flatnonzero(query == dna.N):
        start = aln_pos_to_ref_pos_counter(records[0], int(i),
                                           last_ref, last_aln)
        last_ref, last_aln = start, int(i)
        out.append((start, start + 1))
    return out


def scan_present_base(records: list[Fasta], query: str) -> int:
    """The query's upper-case A, C, G and T (multiFa.go:376)."""
    return int(_present(records[find_sequence_index(records, query)].seq)
               .sum())


def scan_present_base_both(records: list[Fasta], q1: str, q2: str) -> int:
    """The columns where both queries hold a present base
    (multiFa.go:394)."""
    a = _present(records[find_sequence_index(records, q1)].seq)
    b = _present(records[find_sequence_index(records, q2)].seq)
    return int((a & b).sum())


def scan_present_base_either(records: list[Fasta], q1: str, q2: str,
                             q3: str) -> int:
    """The columns where any of three queries holds a present base
    (multiFa.go:415)."""
    a = _present(records[find_sequence_index(records, q1)].seq)
    b = _present(records[find_sequence_index(records, q2)].seq)
    c = _present(records[find_sequence_index(records, q3)].seq)
    return int((a | b | c).sum())


def segregating_columns(records: list[Fasta]) -> np.ndarray:
    """The columns where any record differs from the first, gaps and N
    included (fasta.IsSegregating, multiFa.go:179)."""
    mat = np.stack([np.asarray(r.seq) for r in records])
    return np.nonzero((mat != mat[0]).any(axis=0))[0]


def segregating_sites_fasta(records: list[Fasta]) -> list[Fasta]:
    """records cut to their segregating columns (multiFa.go:211)."""
    cols = segregating_columns(records)
    return [Fasta(r.name, np.asarray(r.seq)[cols]) for r in records]


def bin_genome_no_breaks(genome: list[Fasta], bin_num: int,
                         min_size: int) -> dict[int, list[Fasta]]:
    """Whole records into bins (faBin.go:17): with min_size != -1 a
    record longer than min_size opens a bin and a shorter one joins the
    last bin still under min_size; else bin_num bins, each next record
    into the bin that the reference's smallest-bin search picks."""
    bins: dict[int, list[Fasta]] = {}
    if min_size != -1:
        for j, rec in enumerate(genome):
            if not bins:
                bins[0] = [rec]
            elif len(rec.seq) > min_size:
                bins[len(bins)] = [rec]
            else:
                k = -1  # findBinBelowMin: LAST bin below min (faBin.go:108)
                for i in range(len(bins)):
                    if sum(len(f.seq) for f in bins[i]) < min_size:
                        k = i
                if k < 0 and j + 1 == len(genome):
                    bins[len(bins) - 1].append(rec)  # faBin.go:90
                elif k < 0:
                    bins[len(bins)] = [rec]
                else:
                    bins[k].append(rec)
        return bins
    if len(genome) < bin_num:
        raise SystemExit("Number of bins is greater than the number of "
                         "contigs in the given genome. Reduce bin number.")
    for n in range(bin_num):
        bins[n] = [genome[n]]
    for rec in genome[bin_num:]:  # fillSmallestBin (faBin.go:40)
        sizes = {i: sum(len(f.seq) for f in bins[i]) for i in bins}
        smallest, size_smallest = 0, 0
        for i in range(len(bins)):
            if sizes[i] < size_smallest:
                smallest, size_smallest = i, sizes[i]
            elif size_smallest == 0:
                size_smallest = sizes[i]
        bins[smallest].append(rec)
    return bins


def copy_subset(records: list[Fasta], start: int, end: int) -> list[Fasta]:
    """fasta.CopySubset (multiFa.go:109)."""
    return [Fasta(r.name, np.array(np.asarray(r.seq)[start:end],
                                   copy=True)) for r in records]


def remove_missing_mult(records: list[Fasta]) -> list[Fasta]:
    """fasta.RemoveMissingMult (multiFa.go:121): drop all-gap entries."""
    return [r for r in records
            if len(r.seq) and bool((np.asarray(r.seq) != dna.GAP).any())]


def dist_column(records: list[Fasta]) -> list[Fasta]:
    """fasta.DistColumn (multiFa.go:140): columns with no gaps or
    lowercase bases in any sequence."""
    mat = np.stack([np.asarray(r.seq) for r in records])
    bad = (mat == dna.GAP) | ((mat >= dna.LOWER_A) & (mat <= dna.LOWER_N))
    keep = ~bad.any(axis=0)
    return [Fasta(r.name, mat[i][keep]) for i, r in enumerate(records)]


def num_segregating_sites(records: list[Fasta]) -> int:
    """fasta.NumSegregatingSites (multiFa.go:225)."""
    segregating = segregating_sites_fasta(records)
    return len(segregating[0].seq) if segregating else 0
