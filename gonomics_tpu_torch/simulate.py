"""Data simulation, a copy of ``gonomics_tpu/simulate.py`` (797 lines,
whole), gonomics' ``simulate`` package (sam.go, simulate.go,
withIndels.go, nonCoding.go, tree.go) with ``cmd/simulateSam``.

- The numpy simulators (:26-111: ``rand_seq``, ``mutate_seq``,
  ``evolve_tree``, ``_sequencing_errors``, ``illumina_paired_sam``)
  draw from a numpy Generator: a seed fixes the output, which is not
  gonomics' stream.
- simulateSam's read simulator (:121-362, ``_go_change_base`` to
  ``simulate_sam``) draws every number from one ``GoRand(set_seed)`` in
  gonomics' order: one ``Float64`` a read pair to pick its contig, all
  before the first pair; then, for each pair, the fragment size, the
  midpoint, the ancient damage, the forward and reverse quals, the
  forward and reverse MAPQs, the forward and reverse errors and one
  ``Float64`` for the flags. So the SAM and BAM bytes are the JAX's and
  gonomics' own. The reference's quirks stay: the fragment buffer is
  reused without clearing, so an odd fragment size or a contig end
  leaves the previous fragment's bases (``A`` in a new buffer) in the
  fragment's tail; ``SEQ`` is never reverse-complemented; ``TLEN`` is
  the read length; an ancient damage attempt that lands on A or T still
  uses up its slot; one deamination count list serves every contig.
- The evolution code (:371-797: ``BLOSUM`` to ``sim_etree``), for
  simulateEvol and simRecon, takes a ``GoRand`` (gonomics' stream, bit
  for bit) or a numpy Generator. Its quirks stay too: ``rand_gene``'s
  ``1 // 3`` always picks TAA; ``non_coding`` draws before it skips a
  base above T, so an N uses up a draw; an indel that starts on the last
  base drops that base from both rows (``with_indels``' ``pop()``).
"""

from __future__ import annotations

import bisect
import math

import numpy as np

from . import dna, fileio
from . import codon as codonmod
from .io import fasta as fastaio
from .io import formats
from .io import sam as samio
from .io.chrom_info import ChromInfo
from .io.cigar import CigarOp
from .numbers.gorand import GoRand
from .numbers.gosamplers import (make_binomial_alias, rand_binomial, rand_exp,
                                 rand_gamma, rand_geometric,
                                 rand_int_in_range, sample_inverse_normal)
from .phylo.etree import ETree, populate_substitution_matrices

GC = 0.42  # expected GC-content (simulate.go:27)


def rand_seq(rng: np.random.Generator, length: int,
             gc_content: float = 0.5) -> np.ndarray:
    """simulate.RandGene base model: GC split evenly between G/C."""
    p = np.array([(1 - gc_content) / 2, gc_content / 2, gc_content / 2,
                  (1 - gc_content) / 2])
    return rng.choice(4, size=length, p=p).astype(np.int8)


def mutate_seq(rng: np.random.Generator, seq: np.ndarray,
               branch_length: float) -> np.ndarray:
    """Jukes-Cantor-style substitution: each base mutates with probability
    branch_length to one of the other three (simulate.mutateBase model)."""
    seq = np.asarray(seq, np.int8).copy()
    mask = rng.random(len(seq)) < branch_length
    shifts = rng.integers(1, 4, mask.sum())
    seq[mask] = ((seq[mask] + shifts) % 4).astype(np.int8)
    return seq


def evolve_tree(root: ETree, rng: np.random.Generator,
                root_seq: np.ndarray) -> None:
    """Evolve a sequence down a tree (simulate.Simulate substitution-only
    path): each node's sequence mutates from its parent by branch length."""
    root.fasta = fastaio.Fasta(root.name or "root", root_seq.astype(np.int8))
    for child in (root.left, root.right):
        if child is None:
            continue
        child_seq = mutate_seq(rng, root_seq, child.branch_length)
        evolve_tree(child, rng, child_seq)


def _sequencing_errors(rng: np.random.Generator, seq: np.ndarray,
                       rate: float) -> np.ndarray:
    if rate <= 0:
        return seq
    n_err = rng.binomial(len(seq), rate)
    out = seq.copy()
    for _ in range(n_err):
        p = int(rng.integers(0, len(seq)))
        out[p] = (out[p] + int(rng.integers(1, 4))) % 4
    return out


def illumina_paired_sam(ref_name: str, ref: np.ndarray, num_pairs: int,
                        read_len: int, avg_fragment_size: int,
                        fragment_std: float, flat_error_rate: float,
                        rng: np.random.Generator) -> list[samio.Sam]:
    """simulate.IlluminaPairedSam (sam.go:22), own-PRNG variant. Returns
    the flattened fwd/rev records with proper pair flags."""
    if avg_fragment_size < read_len:
        raise ValueError("average fragment size is less than read length")
    out: list[samio.Sam] = []
    n = len(ref)
    i = 0
    while i < num_pairs:
        frag = max(read_len, int(rng.normal(avg_fragment_size,
                                            fragment_std)))
        midpoint = int(rng.integers(0, n))
        start = max(midpoint - frag // 2, 0)
        end = min(midpoint + frag // 2, n)
        if end - start < read_len:
            continue
        fragment = ref[start:end]
        # SAM SEQ is always reported on the forward reference strand,
        # including for flag-16 reads
        fwd_seq = _sequencing_errors(rng, fragment[:read_len].copy(),
                                     flat_error_rate)
        rev_seq = _sequencing_errors(rng, fragment[-read_len:].copy(),
                                     flat_error_rate)
        qual = "J" * read_len
        name = f"{ref_name}_Read:{i}"
        fwd = samio.Sam(qname=name, rname=ref_name, pos=start + 1, mapq=60,
                        cigar=[CigarOp(read_len, "M")], seq=fwd_seq,
                        qual=qual, rnext="=", tlen=end - start)
        rev = samio.Sam(qname=name, rname=ref_name,
                        pos=end - read_len + 1, mapq=60,
                        cigar=[CigarOp(read_len, "M")], seq=rev_seq,
                        qual=qual, rnext="=", tlen=-(end - start))
        fwd.flag = 1 | 2 | 32 | 64
        rev.flag = 1 | 2 | 16 | 128
        fwd.pnext = rev.pos
        rev.pnext = fwd.pos
        out.append(fwd)
        out.append(rev)
        i += 1
    return out


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


# BLOSUM amino-acid switching probabilities, rows/cols in the reference's
# AminoAcid enum order (simulate.go:86-107)
BLOSUM = np.array([
    [0.288590604, 0.03087248322, 0.03087248322, 0.02953020134, 0.02147651007, 0.0255033557, 0.04026845638, 0.07785234899, 0.01476510067, 0.04295302013, 0.05906040268, 0.04429530201, 0.01744966443, 0.02147651007, 0.02953020134, 0.08456375839, 0.04966442953, 0.005369127517, 0.01744966443, 0.06845637584, 0.0],
    [0.04457364341, 0.3449612403, 0.03875968992, 0.03100775194, 0.007751937984, 0.0484496124, 0.0523255814, 0.03294573643, 0.02325581395, 0.02325581395, 0.04651162791, 0.1201550388, 0.01550387597, 0.01744186047, 0.01937984496, 0.04457364341, 0.03488372093, 0.005813953488, 0.01744186047, 0.03100775194, 0.0],
    [0.05122494432, 0.04454342984, 0.3140311804, 0.08240534521, 0.008908685969, 0.03340757238, 0.04899777283, 0.06458797327, 0.03118040089, 0.02227171492, 0.03118040089, 0.05345211581, 0.01113585746, 0.01781737194, 0.02004454343, 0.06904231626, 0.04899777283, 0.004454342984, 0.01559020045, 0.02672605791, 0.0],
    [0.04104477612, 0.02985074627, 0.06902985075, 0.3973880597, 0.007462686567, 0.02985074627, 0.09141791045, 0.04664179104, 0.01865671642, 0.0223880597, 0.02798507463, 0.0447761194, 0.009328358209, 0.01492537313, 0.0223880597, 0.05223880597, 0.03544776119, 0.003731343284, 0.01119402985, 0.02425373134, 0.0],
    [0.06504065041, 0.0162601626, 0.0162601626, 0.0162601626, 0.4837398374, 0.01219512195, 0.0162601626, 0.0325203252, 0.008130081301, 0.04471544715, 0.06504065041, 0.02032520325, 0.0162601626, 0.02032520325, 0.0162601626, 0.0406504065, 0.03658536585, 0.00406504065, 0.01219512195, 0.05691056911, 0.0],
    [0.05588235294, 0.07352941176, 0.04411764706, 0.04705882353, 0.008823529412, 0.2147058824, 0.1029411765, 0.04117647059, 0.02941176471, 0.02647058824, 0.04705882353, 0.09117647059, 0.02058823529, 0.01470588235, 0.02352941176, 0.05588235294, 0.04117647059, 0.005882352941, 0.02058823529, 0.03529411765, 0.0],
    [0.05524861878, 0.04972375691, 0.04051565378, 0.09023941068, 0.007366482505, 0.06445672192, 0.2965009208, 0.0349907919, 0.02578268877, 0.02209944751, 0.03683241252, 0.07550644567, 0.01289134438, 0.01657458564, 0.02578268877, 0.05524861878, 0.03683241252, 0.005524861878, 0.01657458564, 0.03130755064, 0.0],
    [0.07827260459, 0.02294197031, 0.03913630229, 0.03373819163, 0.01079622132, 0.01889338731, 0.02564102564, 0.5101214575, 0.01349527665, 0.01889338731, 0.02834008097, 0.03373819163, 0.009446693657, 0.01619433198, 0.01889338731, 0.05128205128, 0.02968960864, 0.005398110661, 0.01079622132, 0.02429149798, 0.0],
    [0.04198473282, 0.04580152672, 0.0534351145, 0.03816793893, 0.007633587786, 0.03816793893, 0.0534351145, 0.03816793893, 0.3549618321, 0.02290076336, 0.03816793893, 0.04580152672, 0.01526717557, 0.03053435115, 0.01908396947, 0.04198473282, 0.02671755725, 0.007633587786, 0.0572519084, 0.02290076336, 0.0],
    [0.0471281296, 0.0176730486, 0.0147275405, 0.0176730486, 0.01620029455, 0.01325478645, 0.0176730486, 0.0206185567, 0.0088365243, 0.2709867452, 0.1678939617, 0.0235640648, 0.03681885125, 0.0441826215, 0.0147275405, 0.02503681885, 0.03976435935, 0.0058910162, 0.0206185567, 0.176730486, 0.0],
    [0.04453441296, 0.02429149798, 0.01417004049, 0.01518218623, 0.01619433198, 0.01619433198, 0.02024291498, 0.02125506073, 0.01012145749, 0.1153846154, 0.3755060729, 0.02530364372, 0.0495951417, 0.05465587045, 0.01417004049, 0.02429149798, 0.03340080972, 0.007085020243, 0.02226720648, 0.09615384615, 0.0],
    [0.05699481865, 0.1070811744, 0.0414507772, 0.0414507772, 0.008635578584, 0.05354058722, 0.07081174439, 0.04317789292, 0.0207253886, 0.02763385147, 0.04317789292, 0.2780656304, 0.01554404145, 0.01554404145, 0.02763385147, 0.05354058722, 0.03972366149, 0.00518134715, 0.01727115717, 0.03281519862, 0.0],
    [0.05220883534, 0.03212851406, 0.02008032129, 0.02008032129, 0.01606425703, 0.0281124498, 0.0281124498, 0.0281124498, 0.01606425703, 0.1004016064, 0.1967871486, 0.03614457831, 0.1606425703, 0.04819277108, 0.01606425703, 0.03614457831, 0.04016064257, 0.008032128514, 0.02409638554, 0.09236947791, 0.0],
    [0.03382663848, 0.01902748414, 0.01691331924, 0.01691331924, 0.01057082452, 0.01057082452, 0.01902748414, 0.02536997886, 0.01691331924, 0.06342494715, 0.1141649049, 0.01902748414, 0.02536997886, 0.3868921776, 0.01057082452, 0.02536997886, 0.02536997886, 0.01691331924, 0.088794926, 0.05496828753, 0.0],
    [0.05684754522, 0.02583979328, 0.02325581395, 0.03100775194, 0.01033591731, 0.02067183463, 0.03617571059, 0.03617571059, 0.01291989664, 0.02583979328, 0.03617571059, 0.04134366925, 0.01033591731, 0.01291989664, 0.4935400517, 0.04392764858, 0.03617571059, 0.002583979328, 0.01291989664, 0.03100775194, 0.0],
    [0.109947644, 0.04013961606, 0.05410122164, 0.04886561955, 0.01745200698, 0.03315881326, 0.05235602094, 0.06631762653, 0.01919720768, 0.02966841187, 0.04188481675, 0.05410122164, 0.01570680628, 0.02094240838, 0.02966841187, 0.219895288, 0.08202443281, 0.005235602094, 0.01745200698, 0.04188481675, 0.0],
    [0.07297830375, 0.03550295858, 0.04339250493, 0.03747534517, 0.01775147929, 0.02761341223, 0.03944773176, 0.04339250493, 0.01380670611, 0.05325443787, 0.0650887574, 0.04536489152, 0.01972386588, 0.02366863905, 0.02761341223, 0.09270216963, 0.2465483235, 0.005917159763, 0.01775147929, 0.07100591716, 0.0],
    [0.0303030303, 0.02272727273, 0.01515151515, 0.01515151515, 0.007575757576, 0.01515151515, 0.02272727273, 0.0303030303, 0.01515151515, 0.0303030303, 0.05303030303, 0.02272727273, 0.01515151515, 0.06060606061, 0.007575757576, 0.02272727273, 0.02272727273, 0.4924242424, 0.06818181818, 0.0303030303, 0.0],
    [0.04049844237, 0.02803738318, 0.02180685358, 0.01869158879, 0.009345794393, 0.02180685358, 0.02803738318, 0.02492211838, 0.04672897196, 0.04361370717, 0.06853582555, 0.03115264798, 0.01869158879, 0.1308411215, 0.01557632399, 0.03115264798, 0.02803738318, 0.02803738318, 0.3177570093, 0.04672897196, 0.0],
    [0.06995884774, 0.0219478738, 0.01646090535, 0.01783264746, 0.01920438957, 0.01646090535, 0.02331961591, 0.02469135802, 0.008230452675, 0.1646090535, 0.1303155007, 0.02606310014, 0.03155006859, 0.03566529492, 0.01646090535, 0.0329218107, 0.04938271605, 0.00548696845, 0.02057613169, 0.268861454, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
])


def _rand01(rng) -> float:
    """One uniform draw from either a numpy Generator or a GoRand."""
    return rng.float64() if hasattr(rng, "float64") else rng.random()


def choose_random_base(rng, gc_content: float) -> int:
    """simulate.ChooseRandomBase (simulate.go:111)."""
    r = _rand01(rng)
    at = 1 - gc_content
    if r < gc_content / 2:
        return dna.G
    if r < gc_content:
        return dna.C
    if r < at / 2 + gc_content:
        return dna.T
    return dna.A


def change_base(rng, original: int) -> int:
    """simulate.changeBase (simulate.go:131): resample until different."""
    new = choose_random_base(rng, GC)
    while new == original:
        new = choose_random_base(rng, GC)
    return new


# simulateSam's name for change_base (the JAX's :121, the same draws)
_go_change_base = change_base


def change_base_transition_bias(rng, b: int, gamma: float) -> int:
    """simulate.changeBaseTransitionBias (withIndels.go:223): K80 model."""
    r = _rand01(rng)
    tv = 1.0 / (2.0 + gamma)
    b = int(dna.to_upper(np.array([b], np.int8))[0])
    if b == dna.A:
        return dna.C if r < tv else dna.T if r < 2 * tv else dna.G
    if b == dna.C:
        return dna.A if r < tv else dna.G if r < 2 * tv else dna.T
    if b == dna.G:
        return dna.C if r < tv else dna.T if r < 2 * tv else dna.A
    if b == dna.T:
        return dna.A if r < tv else dna.G if r < 2 * tv else dna.C
    raise ValueError(f"unrecognized base: {b}")


def rand_gene(rng: np.random.Generator, name: str, length: int,
              gc_content: float) -> list[fastaio.Fasta]:
    """simulate.RandGene (simulate.go:33): ATG + random body + stop."""
    if length % 3 != 0:
        raise SystemExit("length must be divisible by three")
    seq = [dna.A, dna.T, dna.G]
    for _ in range(length - 6):
        seq.append(choose_random_base(rng, gc_content))
    r = _rand01(rng)
    # reference quirk: 1/3 is integer division (0), so TAA always wins
    if r < 1 // 3:
        seq.extend([dna.T, dna.A, dna.G])
    elif r < (1 // 3) * 2:
        seq.extend([dna.T, dna.G, dna.A])
    else:
        seq.extend([dna.T, dna.A, dna.A])
    return [fastaio.Fasta(name, np.array(seq, np.int8))]


def _randint_range(rng, lo: int, hi: int) -> int:
    """numbers.RandIntInRange (random.go:9): int(Float64()*(y-x)) + x —
    bit-exact under a GoRand stream; numpy integers otherwise."""
    if hasattr(rng, "float64"):
        return int(rng.float64() * (hi - lo)) + lo
    return int(rng.integers(lo, hi))


def _mutate_base(rng, b: int, branch_length: float) -> int:
    """simulate.mutateBase (simulate.go:142)."""
    r = _rand01(rng)
    if branch_length == 0:
        return b
    if r < branch_length:
        return change_base(rng, b)
    return b


def check_exon(gene, position: int) -> tuple[bool, int]:
    """simulate.CheckExon (simulate.go:410)."""
    for i in range(len(gene.exon_starts)):
        if gene.exon_starts[i] <= position < gene.exon_ends[i]:
            return True, i
    return False, -1


def _create_codons(seq_ext, gene, exon: int):
    """simulate.CreateCodons (simulate.go:261): frame-compensated codon
    triplets for one exon, as (base, seq_pos) pairs."""
    start, end = gene.exon_starts[exon], gene.exon_ends[exon]
    start_frame = gene.exon_frames[exon]
    exon_seq = list(seq_ext[start + (start_frame or 0):end])
    if len(gene.exon_starts) > exon + 1 and gene.exon_frames[exon + 1] != 0:
        nxt = gene.exon_starts[exon + 1]
        exon_seq.extend(seq_ext[nxt:nxt + gene.exon_frames[exon + 1]])
    return [exon_seq[p:p + 3] for p in range(0, len(exon_seq) - 2, 3)]


def _pick_stop(rng, codon):
    """simulate.PickStop (simulate.go:434)."""
    r = _rand01(rng)
    codon = [(dna.T, codon[0][1]), codon[1], codon[2]]
    second = dna.A if r < 0.66 else dna.G
    codon[1] = (second, codon[1][1])
    if second == dna.G:
        third = dna.A
    else:
        third = dna.A if r < 0.5 else dna.G
    codon[2] = (third, codon[2][1])
    return codon


def mutate_gene(rng: np.random.Generator, input_seq: np.ndarray,
                branch_length: float, gene_file: str,
                deletions: bool) -> np.ndarray:
    """simulate.MutateGene (simulate.go:162): gene-structure-aware
    neutral+BLOSUM evolution of one sequence, optional single deletion."""
    gene_records = formats.read_gene_pred(gene_file)
    seq = np.asarray(input_seq, np.int8).tolist()
    seq_ext = [(b, i) for i, b in enumerate(seq)]
    new_sequence: list[tuple[int, int]] = []

    p = 0
    while p < len(seq_ext):
        for gene in gene_records:
            overlap, this_exon = check_exon(gene, p)
            if not overlap:
                new_sequence.append(
                    (_mutate_base(rng, seq[p], branch_length), p))
            else:
                for this_codon in _create_codons(seq_ext, gene, this_exon):
                    is_start = this_codon[0][1] == gene.cds_start
                    del_found = any(b == dna.GAP for b, _ in this_codon)
                    is_stop = this_codon[0][1] == gene.cds_end - 3
                    if is_start:
                        new_sequence.extend(this_codon)
                    if del_found:
                        new_sequence.extend(this_codon)
                    if is_stop:
                        new_sequence.extend(_pick_stop(rng, this_codon))
                    if not is_start and not is_stop and not del_found:
                        new_codon = [
                            (_mutate_base(rng, b, branch_length), pos)
                            for b, pos in this_codon]
                        orig_aa = int(codonmod.translate_seq(np.array(
                            [b for b, _ in this_codon], np.int8))[0])
                        new_aa = int(codonmod.translate_seq(np.array(
                            [b for b, _ in new_codon], np.int8))[0])
                        prob = BLOSUM[orig_aa][new_aa]
                        if _rand01(rng) < prob:
                            new_sequence.extend(new_codon)
                        else:
                            new_sequence.extend(this_codon)
                p += (gene.exon_ends[this_exon]
                      - gene.exon_starts[this_exon]) - 1
        p += 1

    ordered = np.zeros(len(new_sequence), np.int8)
    for b, pos in new_sequence:
        ordered[pos] = b
    if deletions and not (ordered == dna.GAP).any():
        if _rand01(rng) <= branch_length:
            del_pos = _randint_range(rng, 3, len(ordered) - 3)
            ordered[del_pos] = dna.GAP
    return ordered


def simulate_genic(rand_seq_filename: str, root: ETree, gene_file: str,
                   deletions: bool, rng: np.random.Generator) -> None:
    """simulate.Simulate (simulate.go:78) + printSeqForNodes: evolve the
    root fasta down the tree; every node gets a mutated copy."""
    records = fastaio.read(rand_seq_filename)
    root.fasta = records[0]

    def recurse(node: ETree, sequence: np.ndarray) -> None:
        seq = mutate_gene(rng, sequence, node.branch_length, gene_file,
                          deletions)
        node.fasta = fastaio.Fasta(node.name, seq)
        if node.left is not None and node.right is not None:
            recurse(node.right, seq)
            recurse(node.left, seq)

    recurse(root, records[0].seq)


def with_indels(rng, fasta_file: str,
                branch_length: float, prop_indel: float, lambda_: float,
                gc_content: float, transition_bias: float,
                vcf_out_file: str, q_name: str) -> list[fastaio.Fasta]:
    """simulate.WithIndels (withIndels.go:43): pairwise alignment of an
    input sequence and a simulated mutated copy (subs + indels)."""
    records = fastaio.read(fasta_file)
    if len(records) != 1:
        raise SystemExit("SimulateWithIndels expects a single fasta record "
                         "in the input file.")
    src = np.asarray(records[0].seq, np.int8).tolist()
    ref_out: list[int] = []
    alt_out: list[int] = []
    vcf_lines: list[str] = []

    def sub(b: int) -> int:
        if transition_bias != 1:
            return change_base_transition_bias(rng, b, transition_bias)
        return change_base(rng, b)

    def indel_length() -> int:
        if hasattr(rng, "float64"):
            return int(math.ceil(rand_exp(rng)[0] / lambda_))
        return int(math.ceil(rng.exponential() / lambda_))

    def report(pos: int, ref_b: list[int], alt_b: list[int]) -> None:
        ref_s = dna.to_string(np.array(ref_b, np.int8))
        alt_s = dna.to_string(np.array(alt_b, np.int8))
        vcf_lines.append(f"{records[0].name}\t{pos}\t.\t{ref_s}\t{alt_s}\t"
                         f"100\tPASS\t.\t.\t")

    i = 0
    n = len(src)
    while i < n:
        if _rand01(rng) < branch_length:
            r2 = _rand01(rng)
            if r2 < prop_indel / 2.0:  # deletion
                indel_start = i + 1
                cur_ref = [src[i]]
                if _rand01(rng) < branch_length:
                    ref_out.append(src[i])
                    alt_out.append(sub(src[i]))
                else:
                    ref_out.append(src[i])
                    alt_out.append(src[i])
                cur_alt = [alt_out[-1]]
                i += 1
                if i >= n:
                    # reference never increments outputPos here, so the
                    # buffer trim drops the written base (withIndels.go:91)
                    ref_out.pop()
                    alt_out.pop()
                    break
                out_of_chrom = False
                for _ in range(indel_length()):
                    ref_out.append(src[i])
                    cur_ref.append(src[i])
                    alt_out.append(dna.GAP)
                    i += 1
                    if i >= n:
                        out_of_chrom = True
                        break
                i -= 1
                if out_of_chrom:
                    break
                if vcf_out_file:
                    report(indel_start, cur_ref, cur_alt)
            elif r2 < prop_indel:  # insertion
                indel_start = i + 1
                cur_ref = [src[i]]
                if _rand01(rng) < branch_length:
                    ref_out.append(src[i])
                    alt_out.append(sub(src[i]))
                else:
                    ref_out.append(src[i])
                    alt_out.append(src[i])
                cur_alt = [alt_out[-1]]
                i += 1
                if i >= n:
                    ref_out.pop()  # see deletion-branch note
                    alt_out.pop()
                    break
                for _ in range(indel_length()):
                    ref_out.append(dna.GAP)
                    b = choose_random_base(rng, gc_content)
                    alt_out.append(b)
                    cur_alt.append(b)
                i -= 1
                if vcf_out_file:
                    report(indel_start, cur_ref, cur_alt)
            else:  # substitution
                ref_out.append(src[i])
                alt_out.append(sub(src[i]))
                if vcf_out_file:
                    report(i + 1, [src[i]], [alt_out[-1]])
        else:
            ref_out.append(src[i])
            alt_out.append(src[i])
        i += 1

    if vcf_out_file:
        with fileio.easy_create(vcf_out_file) as f:
            f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                    "FILTER\tINFO\tFORMAT\n")
            for line in vcf_lines:
                f.write(line + "\n")

    return [fastaio.Fasta(records[0].name, np.array(ref_out, np.int8)),
            fastaio.Fasta(f"{records[0].name}_{q_name}",
                          np.array(alt_out, np.int8))]


DEFAULT_SUBSTITUTION_MATRIX = [[0.91, 0.03, 0.03, 0.03],
                               [0.03, 0.91, 0.03, 0.03],
                               [0.03, 0.03, 0.91, 0.03],
                               [0.03, 0.03, 0.03, 0.91]]


def parse_substitution_matrix_file(filename: str) -> list[list[float]]:
    """simulate.ParseSubstitutionMatrix (nonCoding.go:71)."""
    if not filename:
        return [row[:] for row in DEFAULT_SUBSTITUTION_MATRIX]
    lines = fileio.read(filename)
    if len(lines) != 4:
        raise SystemExit(f"expected 4 lines in substitution matrix, "
                         f"found {len(lines)}")
    return [[float(x) for x in ln.split("\t")] for ln in lines]


def non_coding(root: ETree, substitution_matrix_file: str,
               unit_branch_length: float, rng) -> ETree:
    """simulate.NonCoding (nonCoding.go:22): evolve each node's sequence
    from its parent through a per-branch substitution matrix. rng may be
    a numpy Generator or a GoRand (byte parity with the reference)."""
    unit = parse_substitution_matrix_file(substitution_matrix_file)
    populate_substitution_matrices(root, unit, unit_branch_length)
    is_go = hasattr(rng, "float64")

    def substitute(seq: np.ndarray, matrix) -> np.ndarray:
        m = np.asarray(matrix, np.float64)
        out = np.asarray(seq, np.int8).copy()
        for idx in range(len(out)):
            b = int(out[idx])
            # the reference draws BEFORE the >3 check (nonCoding.go:57),
            # so N bases consume a draw
            r = rng.float64() if is_go else rng.random()
            if b > 3:
                continue
            cum = 0.0
            for new in range(3):
                cum += m[b][new]
                if r < cum:
                    out[idx] = new
                    break
            else:
                out[idx] = dna.T
        return out

    def recurse(node: ETree) -> None:
        for child in (node.left, node.right):
            if child is not None:
                child.fasta = fastaio.Fasta(
                    child.name,
                    substitute(node.fasta.seq, child.substitution_matrix))
                recurse(child)

    recurse(root)
    return root


def sim_etree(rng, num_nodes: int, gamma_alpha: float,
              gamma_beta: float) -> ETree:
    """simulate.ETree (tree.go:13): random topology with gamma-distributed
    branch lengths. rng may be a numpy Generator or a GoRand (byte parity
    with the reference: RandGamma x2 then Intn per level)."""
    if num_nodes % 2 != 1 or num_nodes < 0:
        raise SystemExit(f"Expecting a positive odd number of target "
                         f"nodes. Found: {num_nodes}.")
    root = ETree(name="root")
    leaves: list[ETree] = []
    is_go = hasattr(rng, "float64")

    def gamma() -> float:
        if is_go:
            return rand_gamma(rng, gamma_alpha, gamma_beta)[0]
        return float(rng.gamma(gamma_alpha, 1.0 / gamma_beta))

    def generate(up: ETree, to_add: int) -> None:
        if to_add < 2:
            return
        up.left = ETree(name=f"Child_{to_add}", up=up, branch_length=gamma())
        up.right = ETree(name=f"Child_{to_add - 1}", up=up,
                         branch_length=gamma())
        leaves.extend([up.left, up.right])
        idx = rng.intn(len(leaves)) if is_go else \
            int(rng.integers(0, len(leaves)))
        nxt = leaves.pop(idx)
        generate(nxt, to_add - 2)

    generate(root, num_nodes - 1)
    return root
