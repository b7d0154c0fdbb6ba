"""Probabilistic FASTA (``.pfa``): records of per-base A, C, G and T
probabilities; a copy of ``gonomics_tpu/io/pfasta.py`` (233 lines,
whole), gonomics' ``fasta/pFasta`` (pFasta.go, extract.go, tools.go).

A file is a text header (``pFasta_format_1.0``, a ``name\\tlength``
line a record, ``EndHeader``) and then each record's (length, 4)
probabilities as little-endian float16. In memory a sequence is a
(length, 4) float32 array.

``sample`` draws from a numpy Generator (PCG64 ``default_rng``), as the
JAX package does, not from Go's global seeded source.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dna, pdna
from . import fasta as fastaio
from . import vcf as vcfio

MAGIC = "pFasta_format_1.0"


@dataclass
class PFasta:
    name: str
    seq: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))


def write(filename: str, records: list[PFasta]) -> None:
    with open(filename, "wb") as f:
        f.write((MAGIC + "\n").encode())
        for r in records:
            f.write(f"{r.name}\t{len(r.seq)}\n".encode())
        f.write(b"EndHeader\n")
        for r in records:
            f.write(np.asarray(r.seq, np.float32).astype("<f2").tobytes())


def to_map(records: list[PFasta]) -> dict[str, np.ndarray]:
    """pFasta.ToMap analog: name -> (N, 4) probability array."""
    return {r.name: r.seq for r in records}


def all_are_equal(a: list[PFasta], b: list[PFasta],
                  precision: float) -> bool:
    """pFasta.AllAreEqual with pDna.EqualBase relative precision."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if x.name != y.name or x.seq.shape != y.seq.shape:
            return False
        p, q = x.seq, y.seq
        denom = np.where(p == 0, q, p)
        diff = np.abs(p - q)
        ok = np.where(denom == 0, diff == 0, diff < precision * denom)
        if not ok.all():
            return False
    return True


def _chrom_index(records: list[PFasta], chrom: str) -> int:
    """checkIfChromInPfasta (pFasta/tools.go:14): last matching index."""
    answer = -1
    for i, r in enumerate(records):
        if r.name == chrom:
            answer = i
    if answer < 0:
        raise ValueError(
            "Error: input sequence name does not match requested chrom.")
    return answer


def extract(records: list[PFasta], start: int, end: int, output_name: str,
            chrom: str, take_coords: bool) -> PFasta:
    """pFasta.Extract (extract.go:13): [start, end) subsequence copy."""
    idx = _chrom_index(records, chrom)
    if start >= end:
        raise ValueError("Error: start must be less than end")
    if start < 0 or end > len(records[idx].seq):
        raise ValueError("Error: positions out of range")
    if take_coords:
        name = f"{chrom}:{start}-{end}"
    elif output_name:
        name = output_name
    else:
        name = chrom
    return PFasta(name, records[idx].seq[start:end].copy())


def extract_bed(records: list[PFasta], regions,
                take_coords: bool) -> list[PFasta]:
    """pFasta.ExtractBed (extract.go:44)."""
    return [extract(records, r.chrom_start, r.chrom_end, "", r.chrom,
                    take_coords)
            for r in regions]


def sample(records: list[PFasta], chrom: str,
           rng: np.random.Generator) -> fastaio.Fasta:
    """pFasta.Sample (tools.go:32): CDF inversion per position in the
    reference's A,C,G,else-T order. Uses a numpy Generator instead of
    Go's global seeded rand (COVERAGE.md known parity limitation)."""
    idx = _chrom_index(records, chrom)
    seq = records[idx].seq
    r = rng.random(len(seq), np.float32)
    cdf_a = seq[:, 0]
    cdf_c = seq[:, 0] + seq[:, 1]
    cdf_g = cdf_c + seq[:, 2]
    out = np.full(len(seq), dna.T, np.int8)
    out[r < cdf_g] = dna.G
    out[r < cdf_c] = dna.C
    out[r < cdf_a] = dna.A
    return fastaio.Fasta(records[idx].name, out)


def fa_to_pfa(record, start: int, end: int) -> PFasta:
    """pFasta.FaToPfa (tools.go:80): one-hot pFasta of a fasta record,
    N -> 0.25s, gap -> zeros, case-folded first."""
    seq = np.asarray(record.seq)
    if end == -1:
        end = len(seq)
    elif end > len(seq):
        raise ValueError(f"Requested end argument ({end}) out of range.")
    upper = dna.to_upper(seq[start:end])
    out = np.zeros((len(upper), 4), np.float32)
    convertible = (upper <= dna.N) | (upper == dna.GAP)
    out[convertible] = pdna.dna_to_pdna(upper[convertible])
    return PFasta(record.name, out)


def multi_fa_to_pfa(in_fa_filename: str, start: int, end: int,
                    chrom: str) -> PFasta:
    """pFasta.MultiFaToPfa (tools.go:115)."""
    records = fastaio.read(in_fa_filename)
    if len(records) == 1:
        if chrom == "" or records[0].name == chrom:
            return fa_to_pfa(records[0], start, end)
    else:
        if chrom == "":
            raise ValueError(
                "Error: expecting a Chrom argument for multifasta input.")
        for rec in records:
            if rec.name == chrom:
                return fa_to_pfa(rec, start, end)
    raise ValueError(
        "Error: input sequence name does not match requested chrom.")


def vcf_to_pfa(in_vcf_filename: str, in_fa_filename: str, start: int,
               end: int) -> PFasta:
    """pFasta.VcfToPfa (tools.go:147): one-hot reference with VCF sample
    allele frequencies at biallelic substitution sites."""
    records = fastaio.read(in_fa_filename)
    if len(records) > 1:
        raise ValueError(
            "Error: expecting only one chromosome in the input fasta file.")
    answer = fa_to_pfa(records[0], start, end)
    variants, _ = vcfio.read(in_vcf_filename)
    prev_pos = None
    for v in variants:
        if prev_pos is not None and v.pos < prev_pos:
            raise ValueError("ERROR: input vcf is not sorted")
        if v.pos >= end:
            break
        if v.chrom != answer.name:
            raise ValueError(
                f"Error: variant chrom: ({v.chrom}) is not equal to "
                f"reference chrom: ({answer.name}).")
        if len(v.alt) != 1 or len(v.ref) != 1 or len(v.alt[0]) != 1:
            raise ValueError(
                "Error: currently we only handle bi-allelic substitutions")
        # the reference compares after FaToPfa's in-place ToUpper
        # (tools.go:90,176)
        ref_base = int(dna.to_upper(records[0].seq[v.pos - 1:v.pos])[0])
        if ref_base != int(dna.from_string(v.ref)[0]):
            raise ValueError(
                "Error: base in fasta didn't match ref base from VCF record")
        answer.seq[v.pos - 1] = _vcf_sample_to_pdna(v.samples, v.ref, v.alt)
        prev_pos = v.pos
    return answer


def _vcf_sample_to_pdna(samples, ref: str, alts: list[str]) -> np.ndarray:
    """vcfSampleToPdnaBase (cmd/pFaTools/vcfToPfa.go semantics, lives in
    pFasta/tools.go:195): allele frequencies over 2N chromosomes."""
    total = 2 * len(samples)
    allele_names = [ref] + list(alts) + ["", ""]
    counts = [0, 0, 0, 0]
    for s in samples:
        for a in (s.alleles or []):
            counts[a] += 1
    out = np.zeros(4, np.float32)
    for i, name in enumerate(allele_names[:4]):
        col = {"A": 0, "C": 1, "G": 2, "T": 3}.get(name)
        if col is not None:
            out[col] = np.float32(counts[i]) / np.float32(total)
    return out


def read(filename: str) -> list[PFasta]:
    with open(filename, "rb") as f:
        data = f.read()
    # header is newline-terminated text lines
    lines = []
    pos = 0
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl].decode()
        pos = nl + 1
        lines.append(line)
        if line == "EndHeader":
            break
    if lines[0] != MAGIC:
        raise ValueError(f"unrecognized pFasta format: {lines[0]}")
    records = []
    for line in lines[1:-1]:
        name, n = line.rsplit("\t", 1)
        records.append(PFasta(name, np.zeros((int(n), 4), np.float32)))
    body = np.frombuffer(data[pos:], dtype="<f2")
    off = 0
    for r in records:
        n = len(r.seq) * 4
        r.seq = body[off:off + n].astype(np.float32).reshape(-1, 4)
        off += n
    if off != len(body):
        raise ValueError("trailing bytes in pFasta file")
    return records
