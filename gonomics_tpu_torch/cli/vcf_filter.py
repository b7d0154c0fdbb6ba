"""vcfFilter: the records of a VCF that pass every test asked for, a
copy of ``gonomics_tpu/cli/vcf_filter.py`` (393 lines), its flags and
defaults unchanged.

    gonomics-torch vcfFilter in.vcf out.vcf [-chrom c] [-minPos n]
        [-maxPos n] [-minQual q] [-ref s] [-alt a,b] [-biAllelicOnly]
        [-substitutionsOnly] [-segregatingSitesOnly] [-removeNoAncestor]
        [-onlyPolarizableAncestors] [-weakToStrongOrStrongToWeakOnly]
        [-noWeakToStrongOrStrongToWeak] [-refWeakAltStrongOnly]
        [-refStrongAltWeakOnly] [-notRefStrongAltWeak]
        [-notRefWeakAltStrong] [-id s] [-format "TAG>v;..."]
        [-info "TAG=v;..."] [-includeMissingInfo] [-subSet p]
        [-setSeed n] [-minDaf f] [-maxDaf f] [-minDistance n]
        [-groupFile groups.txt]

The tests run in ``_get_tests``' order and stop at the first that
fails, so a record draws from ``-subSet``'s generator
(``np.random.default_rng(-setSeed)``) only when every earlier test
passed; records dropped as one of several at a site under
``-biAllelicOnly`` (counted before ``-minDistance`` removes records) or
by ``-minDistance`` draw nothing. ``-groupFile`` keeps the samples it
names and rewrites the #CHROM line. The counts go to stderr.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import fileio
from ..io import vcf as vcfio

MAX_INT = sys.maxsize


# --- vcf/filter.go + vcfAncestor.go predicates ---

def is_biallelic(v): return len(v.alt) == 1


def is_substitution(v):
    return len(v.ref) == 1 and all(len(a) == 1 for a in v.alt)


def is_segregating(v):
    """vcf.IsSegregating (filter.go:58)."""
    first = None
    for s in v.samples:
        if not s.alleles:
            continue
        if first is None:
            first = s.alleles[0]
        if any(a != first for a in s.alleles):
            return True
    return False


def query_ancestor(v) -> str | None:
    """vcf.QueryAncestor (vcfAncestor.go:32): AA= INFO value."""
    if v.info == ".":
        return None
    for fld in v.info.split(";"):
        f = fld.split("=")
        if f[0] == "AA":
            return f[1]
    return None


def has_ancestor(v): return query_ancestor(v) is not None


def is_ref_ancestor(v): return query_ancestor(v) == v.ref


def is_alt_ancestor(v): return query_ancestor(v) == v.alt[0]


def is_polarizable(v):
    """vcf.IsPolarizable (filter.go:85)."""
    aa = query_ancestor(v)
    if aa is None:
        return False
    if len(aa) > 1 or aa in ("-", "N"):
        return False
    return aa == v.ref or aa == v.alt[0]


def is_ref_weak_alt_strong(v):
    return is_biallelic(v) and is_substitution(v) \
        and v.ref in ("A", "T") and v.alt[0] in ("C", "G")


def is_ref_strong_alt_weak(v):
    return is_biallelic(v) and is_substitution(v) \
        and v.ref in ("C", "G") and v.alt[0] in ("A", "T")


def is_not_ref_strong_alt_weak(v):
    if not (is_biallelic(v) and is_substitution(v)):
        return False
    return not is_ref_strong_alt_weak(v)


def is_not_ref_weak_alt_strong(v):
    if not (is_biallelic(v) and is_substitution(v)):
        return False
    return not is_ref_weak_alt_strong(v)


def is_weak_to_strong_or_strong_to_weak(v):
    return is_ref_strong_alt_weak(v) or is_ref_weak_alt_strong(v)


def is_not_weak_to_strong_or_strong_to_weak(v):
    return is_not_ref_weak_alt_strong(v) and is_not_ref_strong_alt_weak(v)


def sample_derived_allele_frequency(v) -> float:
    """popgen.VcfSampleDerivedAlleleFrequency (stationarity.go:156)."""
    if not is_polarizable(v):
        raise SystemExit("DAF filters require polarizable input variants.")
    i = n = 0
    if not any(c in v.alt[0] for c in "<>"):
        for s in v.samples:
            al = s.alleles
            if al and len(al) == 2 and al[0] != -1 and al[1] != -1:
                n += 2
                i += (al[0] > 0) + (al[1] > 0)
    if n == 0:
        raise SystemExit("variant had no sample data")
    if i == 0 or i == n:
        raise SystemExit("variant is nonsegregating (frequency 0 or 1)")
    if has_ancestor(v) and is_alt_ancestor(v):
        i = n - i
    return i / n


# --- cmd/vcfFilter/expression.go ---

_OPS = {
    ">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b,
    "!=": lambda a, b: a != b, "=": lambda a, b: a == b,
    ">": lambda a, b: a > b, "<": lambda a, b: a < b,
}


def _search_op(exp: str) -> str:
    for op in (">=", "<=", "!=", "=", ">", "<"):
        if op in exp:
            return op
    return ""


def parse_expression(expr: str, meta: vcfio.HeaderMeta, is_format: bool,
                     include_missing: bool):
    """parseExpression (expression.go:25): ';'-delimited tag/op/value
    tests evaluated on parsed INFO (or the first sample's FORMAT)."""
    tests = []
    for exp in expr.strip('"').split(";"):
        op = _search_op(exp)
        if op:
            tag, value = (x.strip() for x in exp.split(op, 1))
        else:
            tag, value = exp.strip(), ""
        key = (meta.format if is_format else meta.info).get(tag)
        if key is None:
            raise SystemExit(f"tag '{tag}' not described in header")
        tests.append(_relationship_test(key, value, op, is_format,
                                        include_missing, meta))
    return tests


def _relationship_test(key: vcfio.Key, value: str, op: str, is_format: bool,
                       include_missing: bool, meta: vcfio.HeaderMeta):
    if key.data_type == vcfio.FLAG:
        if value != "":
            raise SystemExit(f"flag '{key.id}' cannot take a value")

        def flag_test(v):
            parsed = (vcfio.parse_format(v, meta) if is_format
                      else vcfio.parse_info(v, meta))
            return parsed.get(key.id, False) is True
        return flag_test
    test = _OPS[op]
    if key.data_type == vcfio.INTEGER:
        val = int(value)
    elif key.data_type == vcfio.FLOAT:
        val = float(value)
    else:
        val = value

    def rel_test(v):
        parsed = (vcfio.parse_format(v, meta) if is_format
                  else vcfio.parse_info(v, meta))
        data = parsed.get(key.id)
        if data is None:
            return include_missing
        return all(test(x, val) for x in data[0])
    return rel_test


# --- cmd/vcfFilter/vcfFilter.go ---

def _rm_clustered(records, min_dist: int):
    """rmClusteredRecords (vcfFilter.go:39)."""
    out, prev, can_send, removed = [], None, True, 0
    for v in records:
        if prev is None:
            prev = v
            can_send = True
            continue
        if v.pos < prev.pos and v.chrom == prev.chrom:
            raise SystemExit("input vcf is not sorted")
        if v.chrom != prev.chrom:
            if can_send:
                out.append(prev)
            else:
                removed += 1
            can_send = True
            prev = v
            continue
        if v.pos - prev.pos < min_dist:
            can_send = False
            prev = v
            removed += 1
            continue
        if can_send:
            out.append(prev)
        else:
            removed += 1
        prev = v
        can_send = True
    if prev is not None:
        if can_send:
            out.append(prev)
        else:
            removed += 1
    return out, removed


def read_groups(filename: str):
    """popgen.ReadGroups (group.go:19): '>'-prefixed group names."""
    members: list[str] = []
    with fileio.easy_open(filename) as f:
        for line in fileio.real_lines(f):
            if not line.startswith(">"):
                members.append(line)
    return set(members)


def _get_tests(c: dict, meta: vcfio.HeaderMeta, rng):
    tests = []
    if c.get("format_exp"):
        tests += parse_expression(c["format_exp"], meta, True,
                                  c.get("include_missing_info", False))
    if c.get("info_exp"):
        tests += parse_expression(c["info_exp"], meta, False,
                                  c.get("include_missing_info", False))
    if c.get("chrom"):
        tests.append(lambda v: v.chrom == c["chrom"])
    if c.get("min_pos", 0) != 0:
        tests.append(lambda v: v.pos >= c["min_pos"])
    if c.get("max_pos", MAX_INT) != MAX_INT:
        tests.append(lambda v: v.pos <= c["max_pos"])
    if c.get("min_daf", 0) != 0:
        tests.append(
            lambda v: sample_derived_allele_frequency(v) > c["min_daf"])
    if c.get("max_daf", 1) != 1:
        tests.append(
            lambda v: sample_derived_allele_frequency(v) < c["max_daf"])
    if c.get("min_qual", 0) != 0:
        tests.append(lambda v: v.qual >= c["min_qual"])
    if c.get("ref"):
        tests.append(lambda v: v.ref == c["ref"])
    if c.get("alt"):
        tests.append(lambda v: v.alt == c["alt"])
    if c.get("biallelic_only"):
        tests.append(is_biallelic)
    if c.get("substitutions_only"):
        tests.append(is_substitution)
    if c.get("segregating_sites_only"):
        tests.append(is_segregating)
    if c.get("remove_no_ancestor"):
        tests.append(has_ancestor)
    if c.get("only_polarizable"):
        tests.append(is_polarizable)
    if c.get("no_weak_to_strong_or_strong_to_weak"):
        tests.append(is_not_weak_to_strong_or_strong_to_weak)
    if c.get("weak_to_strong_or_strong_to_weak_only"):
        tests.append(is_weak_to_strong_or_strong_to_weak)
    if c.get("ref_weak_alt_strong_only"):
        tests.append(is_ref_weak_alt_strong)
    if c.get("ref_strong_alt_weak_only"):
        tests.append(is_ref_strong_alt_weak)
    if c.get("not_ref_weak_alt_strong"):
        tests.append(is_not_ref_weak_alt_strong)
    if c.get("not_ref_strong_alt_weak"):
        tests.append(is_not_ref_strong_alt_weak)
    if c.get("id"):
        tests.append(lambda v: v.id == c["id"])
    if c.get("sub_set", 1) < 1:
        tests.append(lambda v: rng.random() <= c["sub_set"])
    return tests


def vcf_filter(infile: str, outfile: str, *, group_file: str = "",
               seed: int = -1, **criteria) -> tuple[int, int]:
    """vcfFilter (vcfFilter.go:99): returns (total, removed). -subSet
    draws from numpy's PCG64 under the seed (-1: from the OS)."""
    rng = np.random.default_rng(seed if seed >= 0 else None)
    records, header = vcfio.read(infile)
    meta = vcfio.parse_header_meta(header)
    tests = _get_tests(criteria, meta, rng)

    sites_seen: dict = {}
    if criteria.get("biallelic_only"):
        for v in records:
            sites_seen[(v.chrom, v.pos)] = \
                sites_seen.get((v.chrom, v.pos), 0) + 1

    total = len(records)
    removed = 0
    if criteria.get("min_dist", 0) > 0:
        records, removed = _rm_clustered(records, criteria["min_dist"])

    samples_to_keep: list[int] = []
    if group_file:
        members = read_groups(group_file)
        samples = meta.samples
        samples_to_keep = [i for i, s in enumerate(samples)
                           if s in members]
        kept = [samples[i] for i in samples_to_keep]
        for i, line in enumerate(header.text):
            if line.startswith("#CHROM"):
                header.text[i] = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                                  "FILTER\tINFO\tFORMAT"
                                  + "".join("\t" + s for s in kept))
    out = fileio.easy_create(outfile)
    vcfio.new_write_header(out, header)
    for v in records:
        if group_file:
            v.samples = [v.samples[i] for i in samples_to_keep]
        if criteria.get("biallelic_only") \
                and sites_seen.get((v.chrom, v.pos), 0) > 1:
            removed += 1
            continue
        if not all(t(v) for t in tests):
            removed += 1
            continue
        vcfio.write_vcf(out, v)
    out.close()
    return total, removed


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="vcfFilter")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-setSeed", type=int, default=-1)
    p.add_argument("-chrom", default="")
    p.add_argument("-groupFile", default="")
    p.add_argument("-minPos", type=int, default=0)
    p.add_argument("-maxPos", type=int, default=MAX_INT)
    p.add_argument("-minQual", type=float, default=0)
    p.add_argument("-ref", default="")
    p.add_argument("-alt", default="")
    p.add_argument("-biAllelicOnly", action="store_true")
    p.add_argument("-substitutionsOnly", action="store_true")
    p.add_argument("-segregatingSitesOnly", action="store_true")
    p.add_argument("-removeNoAncestor", action="store_true")
    p.add_argument("-onlyPolarizableAncestors", action="store_true")
    p.add_argument("-weakToStrongOrStrongToWeakOnly", action="store_true")
    p.add_argument("-noWeakToStrongOrStrongToWeak", action="store_true")
    p.add_argument("-refWeakAltStrongOnly", action="store_true")
    p.add_argument("-refStrongAltWeakOnly", action="store_true")
    p.add_argument("-notRefStrongAltWeak", action="store_true")
    p.add_argument("-notRefWeakAltStrong", action="store_true")
    p.add_argument("-id", default="")
    p.add_argument("-format", default="")
    p.add_argument("-info", default="")
    p.add_argument("-includeMissingInfo", action="store_true")
    p.add_argument("-subSet", type=float, default=1.0)
    p.add_argument("-minDaf", type=float, default=0.0)
    p.add_argument("-maxDaf", type=float, default=1.0)
    p.add_argument("-minDistance", type=int, default=0)
    a = p.parse_args(argv)
    total, removed = vcf_filter(
        a.input, a.output, group_file=a.groupFile, seed=a.setSeed,
        chrom=a.chrom, min_pos=a.minPos, max_pos=a.maxPos,
        min_qual=a.minQual, ref=a.ref,
        alt=a.alt.split(",") if a.alt else [],
        biallelic_only=a.biAllelicOnly,
        substitutions_only=a.substitutionsOnly,
        segregating_sites_only=a.segregatingSitesOnly,
        remove_no_ancestor=a.removeNoAncestor,
        only_polarizable=a.onlyPolarizableAncestors,
        weak_to_strong_or_strong_to_weak_only=(
            a.weakToStrongOrStrongToWeakOnly),
        no_weak_to_strong_or_strong_to_weak=a.noWeakToStrongOrStrongToWeak,
        ref_weak_alt_strong_only=a.refWeakAltStrongOnly,
        ref_strong_alt_weak_only=a.refStrongAltWeakOnly,
        not_ref_strong_alt_weak=a.notRefStrongAltWeak,
        not_ref_weak_alt_strong=a.notRefWeakAltStrong,
        id=a.id, format_exp=a.format, info_exp=a.info,
        include_missing_info=a.includeMissingInfo, sub_set=a.subSet,
        min_daf=a.minDaf, max_daf=a.maxDaf, min_dist=a.minDistance)
    print(f"Processed  {total} variants", file=sys.stderr)
    print(f"Removed    {removed} variants", file=sys.stderr)


if __name__ == "__main__":
    main()
