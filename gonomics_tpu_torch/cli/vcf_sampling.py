"""sampleVcf, proximityBlockVcf, filterGenotypes, vcfAncestorAnnotation,
vcfAfs and haplotypeGenerator: a copy of
``gonomics_tpu/cli/vcf_sampling.py`` (257 lines, whole), gonomics'
``cmd/{sampleVcf,proximityBlockVcf,filterGenotypes,
vcfAncestorAnnotation,vcfAfs,haplotypeGenerator}``, their flags, defaults
and error texts unchanged. The umbrella reaches each through its
``module:function`` target (``main_sample``, ``main_proximity``,
``main_filter_genotypes``, ``main_ancestor``, ``main_afs``,
``main_haplotype``).

    gonomics-torch sampleVcf in.vcf out.vcf [-numVariants 1]
        [-numSamples -1] [-setSeed -1]
    gonomics-torch proximityBlockVcf in.vcf out.vcf distance [-setSeed -1]
    gonomics-torch filterGenotypes in.vcf out.vcf -f1 F -parentOne P1
        -parentTwo P2 | -byname names.txt
    gonomics-torch vcfAncestorAnnotation in.vcf aln.fa out.vcf
    gonomics-torch vcfAfs in.vcf out.txt [-unPolarized] [-includeRef]
        [-plotSelectionLikelihood lik.tsv -leftBound -10 -rightBound 10
         -numberOfPoints 99 -integralError 1e-7]
    gonomics-torch haplotypeGenerator ref.fa in.vcf regions.bed outDir
        [-includeRef] [-lineLength 50]

sampleVcf and proximityBlockVcf shuffle with numpy's PCG64
(``default_rng(seed)``, unseeded when -setSeed < 0), as the JAX tools
do; their outputs follow the JAX tools', not gonomics' Go stream.
vcfAncestorAnnotation reads rows 0 and 1 of the alignment for every
record, whatever its chrom, and adds no AA line to the header.
haplotypeGenerator takes only single-base REF and ALTs inside a region,
falls back to the FASTA's first record for a chrom it lacks, and scans
every record for each region.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna, fileio, popgen
from ..io import bed as bedio
from ..io import fasta as fastaio
from ..io import vcf as vcfio


def sample_vcf(in_file: str, out_file: str, num_variants: int = 1,
               num_samples: int = -1, set_seed: int = -1) -> None:
    """num_variants records of a permutation and, where num_samples > 0,
    the first num_samples columns of a second permutation of the same
    generator (vcf_sampling.py:23-50)."""
    rng = np.random.default_rng(None if set_seed < 0 else set_seed)
    records, header = vcfio.read(in_file)
    if num_variants > len(records):
        raise SystemExit("The Number of requested sampled variants is "
                         "greater than the Number of variants in the "
                         "input file.")
    sample_list = (vcfio.header_get_sample_list(header)
                   if header.text else [])
    order = rng.permutation(len(records))
    records = [records[i] for i in order][:num_variants]
    if num_samples > 0:
        if num_samples > len(records[0].samples):
            raise SystemExit("More samples were requested than were "
                             "present in the input VCF file.")
        keep = [int(i) for i in
                rng.permutation(len(records[0].samples))][:num_samples]
        if header.text:
            header = vcfio.header_update_sample_list(
                header, [sample_list[i] for i in keep])
        for rec in records:
            rec.samples = [rec.samples[i] for i in keep]
    with fileio.easy_create(out_file) as out:
        vcfio.new_write_header(out, header)
        for rec in records:
            vcfio.write_vcf(out, rec)


def proximity_block_vcf(in_file: str, out_file: str, distance: int,
                        set_seed: int = -1) -> None:
    """The records of a permutation, each kept where it lies at least
    distance from every record kept before it on its chrom
    (vcf_sampling.py:53-68); an empty VCF raises IndexError."""
    rng = np.random.default_rng(None if set_seed < 0 else set_seed)
    records, header = vcfio.read(in_file)
    order = rng.permutation(len(records))
    records = [records[i] for i in order]
    retained = [records[0]]
    for rec in records[1:]:
        if all(rec.chrom != r.chrom or abs(rec.pos - r.pos) >= distance
               for r in retained):
            retained.append(rec)
    with fileio.easy_create(out_file) as out:
        vcfio.new_write_header(out, header)
        for rec in retained:
            vcfio.write_vcf(out, rec)


def filter_genotypes(in_file: str, out_file: str, *, f1: str = "",
                     parent_one: str = "", parent_two: str = "",
                     by_name_file: str = "") -> None:
    """The named columns, in the file's order of names, or the records
    where both parents are homozygous, the F1 heterozygous and
    alleles[0] of parent one differs from alleles[1] of parent two
    (vcf_sampling.py:71-99)."""
    records, header = vcfio.read(in_file)
    names = vcfio.header_get_sample_list(header)
    index = {n: i for i, n in enumerate(names)}
    with fileio.easy_create(out_file) as out:
        if by_name_file:
            keep_names = list(fileio.read(by_name_file))
            keep = [index[n] for n in keep_names]
            header = vcfio.header_update_sample_list(header, keep_names)
            vcfio.new_write_header(out, header)
            for rec in records:
                rec.samples = [rec.samples[i] for i in keep]
                vcfio.write_vcf(out, rec)
            return
        if not (f1 and parent_one and parent_two):
            raise SystemExit("Error: Must provide exactly 2 parents and "
                             "1 F1 sample...")
        p1, p2, f = index[parent_one], index[parent_two], index[f1]
        vcfio.new_write_header(out, header)
        for rec in records:
            s1, s2, sf = rec.samples[p1], rec.samples[p2], rec.samples[f]
            if (vcfio.is_homozygous(s1) and vcfio.is_homozygous(s2)
                    and vcfio.is_heterozygous(sf)
                    and s1.alleles[0] != s2.alleles[1]):
                vcfio.write_vcf(out, rec)


def vcf_ancestor_annotation(in_file: str, fa_file: str,
                            out_file: str) -> None:
    """AA= of each record from rows 0 and 1 of the alignment
    (vcf_sampling.py:102-113)."""
    records, header = vcfio.read(in_file)
    aln = fastaio.read(fa_file)
    curr_ref = curr_aln = 0
    with fileio.easy_create(out_file) as out:
        vcfio.new_write_header(out, header)
        for v in records:
            v, curr_ref, curr_aln = vcfio.annotate_ancestor_from_multi_fa(
                v, aln, curr_ref, curr_aln)
            vcfio.write_vcf(out, v)


def vcf_afs(vcf_file: str, out_file: str, *, unpolarized: bool = False,
            include_ref: bool = False,
            plot_selection_likelihood: str = "",
            left_bound: float = -10.0, right_bound: float = 10.0,
            number_of_points: int = 99,
            integral_error: float = 1e-7) -> None:
    """Each site's i/n with ``:f``, and the likelihood at
    number_of_points + 1 alphas with ``:e`` (vcf_sampling.py:116-136)."""
    afs = popgen.vcf_to_afs(vcf_file, unpolarized=unpolarized,
                            include_ref=include_ref)
    with fileio.easy_create(out_file) as out:
        for site in afs.sites:
            out.write(f"{site.i / site.n:f}\n")
    if plot_selection_likelihood:
        with fileio.easy_create(plot_selection_likelihood) as out:
            out.write("Alpha\tLikelihood\n")
            for i in range(number_of_points + 1):
                alpha = left_bound + (i / number_of_points) * (
                    right_bound - left_bound)
                lik = popgen.afs_likelihood_fixed_alpha(
                    afs, alpha, integral_error)
                out.write(f"{alpha:e}\t{lik:e}\n")


def haplotype_generator(ref_file: str, vcf_file: str, bed_file: str,
                        out_dir: str, *, include_ref: bool = False,
                        line_length: int = 50) -> None:
    """<outDir>/<chrom>.<start>.<end>.fa a region: the reference (with
    -includeRef), then <sample>_A and <sample>_B with the sample's alts
    (vcf_sampling.py:139-175)."""
    regions = bedio.read(bed_file)
    genome = fastaio.read(ref_file)
    genome_map = {rec.name: i for i, rec in enumerate(genome)}
    records, header = vcfio.read(vcf_file)
    sample_names = vcfio.header_get_sample_list(header)
    for region in regions:
        overlapping = [v for v in records
                       if v.chrom == region.chrom
                       and region.chrom_start < v.pos
                       <= region.chrom_end
                       and len(v.ref) == 1
                       and all(len(a) == 1 for a in v.alt)]
        # Go's map miss returns 0, which the reference relies on when
        # fasta names keep a leading space (helperFastaIndex)
        ref_hap = fastaio.extract(genome[genome_map.get(region.chrom, 0)],
                                  region.chrom_start, region.chrom_end,
                                  region.chrom)
        out_name = (f"{out_dir}/{region.chrom}.{region.chrom_start}."
                    f"{region.chrom_end}.fa")
        with fileio.easy_create(out_name) as out:
            if include_ref:
                fastaio.write_fasta(out, ref_hap, line_length)
            for j, name in enumerate(sample_names):
                for hap_idx, suffix in ((0, "A"), (1, "B")):
                    hap = fastaio.Fasta(
                        f"{name}_{suffix}",
                        np.array(ref_hap.seq, copy=True))
                    for v in overlapping:
                        state = v.samples[j].alleles[hap_idx]
                        if state > 0:
                            hap.seq[v.pos - region.chrom_start - 1] = \
                                dna_base(v.alt[state - 1])
                    fastaio.write_fasta(out, hap, line_length)


def dna_base(ch: str) -> int:
    return int(dna.from_string(ch)[0])


def main_sample(argv=None) -> None:
    p = argparse.ArgumentParser(prog="sampleVcf")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-setSeed", type=int, default=-1)
    p.add_argument("-numVariants", type=int, default=1)
    p.add_argument("-numSamples", type=int, default=-1)
    a = p.parse_args(argv)
    sample_vcf(a.input, a.output, a.numVariants, a.numSamples, a.setSeed)


def main_proximity(argv=None) -> None:
    p = argparse.ArgumentParser(prog="proximityBlockVcf")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("distance", type=int)
    p.add_argument("-setSeed", type=int, default=-1)
    a = p.parse_args(argv)
    proximity_block_vcf(a.input, a.output, a.distance, a.setSeed)


def main_filter_genotypes(argv=None) -> None:
    p = argparse.ArgumentParser(prog="filterGenotypes")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-f1", default="")
    p.add_argument("-parentOne", default="")
    p.add_argument("-parentTwo", default="")
    p.add_argument("-byname", default="")
    a = p.parse_args(argv)
    filter_genotypes(a.input, a.output, f1=a.f1, parent_one=a.parentOne,
                     parent_two=a.parentTwo, by_name_file=a.byname)


def main_ancestor(argv=None) -> None:
    p = argparse.ArgumentParser(prog="vcfAncestorAnnotation")
    p.add_argument("input")
    p.add_argument("fasta")
    p.add_argument("output")
    a = p.parse_args(argv)
    vcf_ancestor_annotation(a.input, a.fasta, a.output)


def main_afs(argv=None) -> None:
    p = argparse.ArgumentParser(prog="vcfAfs")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-unPolarized", action="store_true")
    p.add_argument("-includeRef", action="store_true")
    p.add_argument("-plotSelectionLikelihood", default="")
    p.add_argument("-leftBound", type=float, default=-10.0)
    p.add_argument("-rightBound", type=float, default=10.0)
    p.add_argument("-numberOfPoints", type=int, default=99)
    p.add_argument("-integralError", type=float, default=1e-7)
    a = p.parse_args(argv)
    vcf_afs(a.input, a.output, unpolarized=a.unPolarized,
            include_ref=a.includeRef,
            plot_selection_likelihood=a.plotSelectionLikelihood,
            left_bound=a.leftBound, right_bound=a.rightBound,
            number_of_points=a.numberOfPoints,
            integral_error=a.integralError)


def main_haplotype(argv=None) -> None:
    p = argparse.ArgumentParser(prog="haplotypeGenerator")
    p.add_argument("genome")
    p.add_argument("vcf")
    p.add_argument("bed")
    p.add_argument("outDir")
    p.add_argument("-includeRef", action="store_true")
    p.add_argument("-lineLength", type=int, default=50)
    a = p.parse_args(argv)
    haplotype_generator(a.genome, a.vcf, a.bed, a.outDir,
                        include_ref=a.includeRef,
                        line_length=a.lineLength)
