"""simulateSam's read simulator, a copy of ``gonomics_tpu/simulate.py``
:121-365 (``_go_change_base`` to ``simulate_sam``) and its ``GC`` (:371),
gonomics' ``simulate/sam.go`` with ``cmd/simulateSam``.

Every draw comes from one ``GoRand(set_seed)``, in gonomics' order: one
``Float64`` a read pair to pick its contig, all before the first pair;
then, for each pair, the fragment size, the midpoint, the ancient
damage, the forward and reverse quals, the forward and reverse MAPQs,
the forward and reverse errors and one ``Float64`` for the flags. So
the SAM and BAM bytes are the JAX's and gonomics' own.

The reference's quirks stay: the fragment buffer is reused without
clearing, so an odd fragment size or a contig end leaves the previous
fragment's bases (``A`` in a new buffer) in the fragment's tail; ``SEQ``
is never reverse-complemented; ``TLEN`` is the read length; an ancient
damage attempt that lands on A or T still uses up its slot; one
deamination count list serves every contig.

The numpy simulators (:26-120) and the evolution code (:371-797) are
not here yet: ROADMAP items 12b and 18 bring them.
"""

from __future__ import annotations

import bisect

import numpy as np

from . import dna, fileio
from .cli.rand_seq import choose_random_base
from .io import fasta as fastaio
from .io import sam as samio
from .io.chrom_info import ChromInfo
from .io.cigar import CigarOp
from .numbers.gorand import GoRand
from .numbers.gosamplers import (make_binomial_alias, rand_binomial,
                                 rand_geometric, rand_int_in_range,
                                 sample_inverse_normal)

GC = 0.42  # expected GC-content (simulate.go:27)


def _go_change_base(rng, base: int) -> int:
    """simulate.changeBase (simulate.go:131): ChooseRandomBase(GC=0.42)
    until the draw differs from the original."""
    new = choose_random_base(rng, GC)
    while new == base:
        new = choose_random_base(rng, GC)
    return new


def _sequencing_error_go(rng, seq: np.ndarray, alias) -> None:
    """simulate.sequencingError (sam.go:193): binomial error count, then
    sample positions without replacement (map-retry loop)."""
    n_err = rand_binomial(rng, alias)
    mutated: set[int] = set()
    curr = 0
    while curr < n_err:
        p = rand_int_in_range(rng, 0, len(seq))
        if p not in mutated:
            mutated.add(p)
            seq[p] = _go_change_base(rng, int(seq[p]))
            curr += 1


def _ancient_damage_go(rng, frag: np.ndarray, alias, geometric_param: float,
                       deamination_slice: list[int]) -> None:
    """simulate.ancientDamage (sam.go:216): geometric distance from either
    fragment end; C->T / G->A deamination; A/T draws still consume an
    attempt slot."""
    n_attempts = rand_binomial(rng, alias)
    damaged: set[int] = set()
    curr = 0
    while curr < n_attempts:
        d = rand_geometric(rng, geometric_param)
        while d >= len(frag):
            d = rand_geometric(rng, geometric_param)
        which = rng.float64()
        pos = len(frag) - d - 1 if which < 0.5 else d
        if pos not in damaged:
            damaged.add(pos)
            b = int(frag[pos])
            if b == dna.C:
                frag[pos] = dna.T
                if d < len(deamination_slice):
                    deamination_slice[d] += 1
            elif b == dna.G:
                frag[pos] = dna.A
                if d < len(deamination_slice):
                    deamination_slice[d] += 1
            elif b not in (dna.A, dna.T):
                raise ValueError(f"unrecognized base: {b}")
            curr += 1


def _generate_sam_read_no_flag(rng, read_name: str, ref_name: str,
                               fragment: np.ndarray, read_length: int,
                               fragment_start: int, flat_error_rate: float,
                               flat_alias) -> tuple[samio.Sam, samio.Sam]:
    """simulate.generateSamReadNoFlag (sam.go:104): qual draws (fwd then
    rev), MapQ draws (fwd then rev), then flat sequencing errors."""
    fwd = samio.Sam(qname=read_name, rname=ref_name)
    rev = samio.Sam(qname=read_name, rname=ref_name)
    fwd.qual = "".join(chr(rand_int_in_range(rng, 30, 40) + 33)
                       for _ in range(read_length))
    rev.qual = "".join(chr(rand_int_in_range(rng, 30, 40) + 33)
                       for _ in range(read_length))
    fwd.mapq = rand_int_in_range(rng, 30, 40)
    rev.mapq = rand_int_in_range(rng, 30, 40)
    fwd.seq = fragment[0:read_length].copy()
    rev.seq = fragment[len(fragment) - read_length:].copy()
    if flat_error_rate > 0:
        _sequencing_error_go(rng, fwd.seq, flat_alias)
        _sequencing_error_go(rng, rev.seq, flat_alias)
    fwd.pos = fragment_start + 1
    rev.pos = fragment_start + len(fragment) - read_length + 1
    fwd.tlen = read_length
    rev.tlen = read_length
    fwd.cigar = [CigarOp(read_length, "M")]
    rev.cigar = [CigarOp(read_length, "M")]
    return fwd, rev


def _add_paired_flags_go(rng, f: samio.Sam,
                         r: samio.Sam) -> tuple[samio.Sam, samio.Sam]:
    """simulate.addPairedFlags (sam.go:151). One Float64 draw decides
    orientation; records swap so reads point toward one another."""
    f_is_revcomp = rng.float64() > 0.5
    if f_is_revcomp:
        f, r = r, f
    f.flag += 1 + 64
    r.flag += 1 + 128
    if f.cigar and r.cigar:
        f.flag += 2
        r.flag += 2
        if f_is_revcomp:
            f.flag += 16
            r.flag += 32
        else:
            f.flag += 32
            r.flag += 16
    elif not f.cigar and not r.cigar:
        f.flag += 4 + 8
        r.flag += 4 + 8
    elif f.cigar and not r.cigar:
        f.flag += 8
        r.flag += 4
        if f_is_revcomp:
            f.flag += 16
            r.flag += 32
    else:
        f.flag += 4
        r.flag += 8
        if not f_is_revcomp:
            f.flag += 32
            r.flag += 16
    return f, r


def illumina_paired_sam_go(rng, ref_name: str, ref: np.ndarray,
                           num_pairs: int, read_len: int,
                           avg_fragment_size: int, fragment_std: float,
                           flat_error_rate: float, ancient_error_rate: float,
                           flat_alias, ancient_alias, geometric_param: float,
                           deamination_slice: list[int]) -> list[samio.Sam]:
    """simulate.IlluminaPairedSam (sam.go:22), bit-exact Go draw order.

    Replicates the reference's fragment-buffer reuse: when capacity
    suffices, the slice is re-lengthened WITHOUT clearing, so bases past
    the copied region carry over from the previous fragment (and a fresh
    allocation is zero-filled = dna.A). Reads near contig edges therefore
    contain those carry-over bases, exactly as in the goldens."""
    if avg_fragment_size < read_len:
        raise ValueError("average fragment size is less than read length")
    out: list[samio.Sam] = []
    n = len(ref)
    cap_ = avg_fragment_size + int(5 * fragment_std)
    buf = np.zeros(cap_, np.int8)
    length = 0
    for i in range(num_pairs):
        fragment_size = max(read_len, int(sample_inverse_normal(
            rng, float(avg_fragment_size), fragment_std)))
        midpoint = rand_int_in_range(rng, 0, n)
        start_for = max(midpoint - fragment_size // 2, 0)
        end_rev = min(midpoint + fragment_size // 2, n)
        if fragment_size < read_len:  # unreachable (kept for parity)
            read_len = fragment_size
        if length + fragment_size > cap_:
            cap_ = length + fragment_size
            buf = np.zeros(cap_, np.int8)
        length = fragment_size
        fragment = buf[:length]
        n_copy = min(length, end_rev - start_for)
        fragment[:n_copy] = ref[start_for:start_for + n_copy]
        if ancient_error_rate > 0:
            _ancient_damage_go(rng, fragment, ancient_alias,
                               geometric_param, deamination_slice)
        fwd, rev = _generate_sam_read_no_flag(
            rng, f"{ref_name}_Read:{i}", ref_name, fragment, read_len,
            start_for, flat_error_rate, flat_alias)
        fwd, rev = _add_paired_flags_go(rng, fwd, rev)
        if fwd.cigar and rev.cigar:
            fwd.rnext = "="
            rev.rnext = "="
        else:
            fwd.rnext = rev.rname
            rev.rnext = fwd.rname
        fwd.pnext = rev.pos
        rev.pnext = fwd.pos
        out.append(fwd)
        out.append(rev)
    return out


def _get_reads_per_contig_go(rng, records, num_reads: int, coverage: float,
                             read_len: int) -> list[int]:
    """cmd/simulateSam getReadsPerContig (simulateSam.go:92): length-
    weighted CDF, one Float64 draw per read, sort.Search upper bound."""
    total = 0
    for r in records:
        total += len(r.seq)
    cdf: list[float] = []
    acc = 0.0
    for r in records:
        acc = acc + len(r.seq) / float(total) if cdf else \
            len(r.seq) / float(total)
        cdf.append(acc)
    if coverage > 0:
        num_reads = int(coverage * float(total) / float(read_len * 2))
    counts = [0] * len(records)
    for _ in range(num_reads):
        val = rng.float64()
        counts[bisect.bisect_right(cdf, val)] += 1
    return counts


def simulate_sam(ref_file: str, out_file: str, *, num_reads: int = 0,
                 coverage: float = 0.0, read_len: int = 150,
                 flat_error_rate: float = 0.0, fragment_length: int = 400,
                 fragment_std: float = 50.0,
                 ancient_error_rate: float = 0.0,
                 geometric_param: float = 0.25, set_seed: int = 1,
                 deamination_distribution: str = "") -> None:
    """cmd/simulateSam (simulateSam.go:37): byte-identical to the
    reference goldens (SAM text or BAM when out_file ends in .bam)."""
    rng = GoRand(set_seed)
    records = fastaio.read(ref_file)
    header = samio.Header()
    header.text = ["@HD\tVN:1.6\tSO:unsorted"] + [
        f"@SQ\tSN:{r.name}\tLN:{len(r.seq)}" for r in records]
    header.chroms = [ChromInfo(r.name, len(r.seq)) for r in records]
    flat_alias = make_binomial_alias(read_len, flat_error_rate)
    ancient_alias = make_binomial_alias(read_len, ancient_error_rate)
    deamination_slice = [0] * read_len
    reads_per_contig = _get_reads_per_contig_go(rng, records, num_reads,
                                                coverage, read_len)
    sams: list[samio.Sam] = []
    for rec, n_pairs in zip(records, reads_per_contig):
        sams.extend(illumina_paired_sam_go(
            rng, rec.name, dna.to_upper(rec.seq).astype(np.int8), n_pairs,
            read_len, fragment_length, fragment_std, flat_error_rate,
            ancient_error_rate, flat_alias, ancient_alias, geometric_param,
            deamination_slice))
    samio.write_sam(out_file, header, sams)
    if deamination_distribution:
        with fileio.easy_create(deamination_distribution) as f:
            f.write("Position\tCount\n")
            for i, c in enumerate(deamination_slice):
                f.write(f"{i}\t{c}\n")
