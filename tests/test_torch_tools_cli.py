"""The port's ``pileup``, ``samConsensus`` and ``samToBed``
(gonomics_tpu_torch/cli/) and its umbrella ``gonomics-torch``
(gonomics_tpu_torch/cli/main.py) on the CPU against the JAX package:
output bytes on the same SAM and BAM files. Two inputs, each as SAM text
and as BAM written by the JAX package's bam_writer: tests/test_torch_card.py
``_variant_inputs`` (two chromosomes of 12 and 6 kb, coordinate-sorted
reads with M, I, D and S on both strands, planted SNVs and indels), and
a small hand-made file of the edge cases (an insertion near a
chromosome's start, a deletion running to a chromosome's end, an N
skip and an insertion at the uncovered base before the next reads, a
chromosome with no reads, an unmapped read). Also: the umbrella
lists and dispatches exactly the port's 130 tools, imports none of them
before dispatch, resolves a ``module:function`` target as the JAX
umbrella does, runs the popgen tools, the interval and lift tools, the
VCF, MAF and axt tools, the GTF and acceleration tools and the
simulation and tree tools, the evolution, accuracy and ILS tools and
the ontology tools with strawToBedpe, the giraf and pFa tools and the
tools of slices 14b and 15a to the JAX umbrella's bytes, lists its tools
and runs every tool but drawNewickTree and faDrawAlnChunks without PIL,
and its ``gsw align`` wants the card; ``pyproject.toml`` installs it as
``gonomics-torch``; no new module imports JAX.
"""

import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

from gonomics_tpu.cli import main as jmain
from gonomics_tpu.cli import pileup_cmd as jpileup
from gonomics_tpu.cli import sam_consensus as jcons
from gonomics_tpu.cli import sam_to_bed as jbed
from gonomics_tpu.io import bam_writer
from gonomics_tpu.io import sam as jsam
from gonomics_tpu_torch import dna
from gonomics_tpu_torch.cli import bed_merge as tbed_merge
from gonomics_tpu_torch.cli import bed_to_amino_acid as tbed_to_amino_acid
from gonomics_tpu_torch.cli import bed_to_fasta as tbed_to_fasta
from gonomics_tpu_torch.cli import digest_genome as tdigest_genome
from gonomics_tpu_torch.cli import fa_to_predict_set as tfa_to_predict_set
from gonomics_tpu_torch.cli import find_and_replace as tfind_and_replace
from gonomics_tpu_torch.cli import prcomp_format as tprcomp_format
from gonomics_tpu_torch.cli import reconstruct_seq as treconstruct_seq
from gonomics_tpu_torch.cli import assembly_stats as tassembly_stats
from gonomics_tpu_torch.cli import bed_to_wig as tbed_to_wig
from gonomics_tpu_torch.cli import fa_filter as tfa_filter
from gonomics_tpu_torch.cli import fa_find_fast as tfa_find_fast
from gonomics_tpu_torch.cli import fa_format as tfa_format
from gonomics_tpu_torch.cli import fa_uniq as tfa_uniq
from gonomics_tpu_torch.cli import gc_content as tgc_content
from gonomics_tpu_torch.cli import gsw_cmd as tgsw
from gonomics_tpu_torch.cli import interval_overlap as tinterval_overlap
from gonomics_tpu_torch.cli import locate_cg as tlocate_cg
from gonomics_tpu_torch.cli import main as umbrella
from gonomics_tpu_torch.cli import mergesort as tmergesort
from gonomics_tpu_torch.cli import pileup_cmd as tpileup
from gonomics_tpu_torch.cli import sam_consensus as tcons
from gonomics_tpu_torch.cli import sam_to_bed as tbed
from gonomics_tpu_torch.cli import bed_filter as tbed_filter
from gonomics_tpu_torch.cli import bed_format as tbed_format
from gonomics_tpu_torch.cli import multi_fa_to_chain as tmulti_fa_to_chain
from gonomics_tpu_torch.cli import multi_fa_to_vcf as tmulti_fa_to_vcf
from gonomics_tpu_torch.cli import vcf_filter as tvcf_filter
from gonomics_tpu_torch.cli import vcf_format as tvcf_format
from gonomics_tpu_torch.cli import vcf_info as tvcf_info
from gonomics_tpu_torch.cli import vcf_to_fa as tvcf_to_fa
from gonomics_tpu_torch.cli import fastq_filter as tfastq_filter
from gonomics_tpu_torch.cli import sam_info as tsam_info
from gonomics_tpu_torch.cli import wig_tools as twig_tools
from gonomics_tpu_torch.io import fasta as tfasta

from test_torch_card import _variant_inputs, _write_reference
from test_torch_interval_tools import (VCF_HEAD, _bed_rows, _bedpe_rows,
                                       _chain_text, _vcf_line)
from test_torch_ontology import (contact_lines, gaf_lines, gtf_lines,
                                  obo_lines, query_lines, tss_lines)
from test_torch_popgen import GROUPS, _aln, popgen_vcf
from test_torch_straw import straw_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = ["alleleSplit", "assemblyStats", "assignGenomeSpace", "axTools",
          "axtSam", "bamTagToReadGroup", "bedCountBam",
          "bedDistanceFromChrEnds", "bedFilter", "bedFormat", "bedGraphToWig",
          "bedMath", "bedMerge", "bedMinimumDistanceName",
          "bedOverlapByWindow", "bedShear", "bedSimilarity", "bedSplit",
          "bedToAminoAcid", "bedToFasta", "bedToWig", "bedTrim", "bedValueWig",
          "bedpeFilter", "bedpeOverlap", "branchLengthsMultiFaBed",
          "callVariants", "catMultiFa", "cigarToBed", "countPairOfBases",
          "digestGenome", "divergenceSpectrum", "dotToNewick",
          "drawNewickTree", "dunnIndex", "faBin", "faChunkAlign",
          "faDrawAlnChunks", "faFilter", "faFindFast", "faFormat", "faInfo",
          "faToPredictSet", "faUniq", "fastqFilter", "fastqFormat",
          "fastqReplaceSeq", "filterGenotypes", "findAndReplace",
          "formatIdeogram", "gafFilter", "gcContent", "geneAssignmentStats",
          "geneIdToName", "getPromoter", "girafCompress", "girafSimulate",
          "girafSort", "globalAlignment", "gsw", "gtfTools",
          "haplotypeGenerator", "ilsReconstructSeq", "intervalContacts",
          "intervalOverlap", "intervalSubsetMatrix", "lastZWriter",
          "liftCoordinates", "locateCG", "longReadLibStats", "mafFilter",
          "mafIndels", "mafToBed", "mafToMultiFa", "mcmcTraceStats",
          "mergeMultiFa", "mergesort", "mouseRecon", "multFaVisualizeBeds",
          "multFaVisualizer", "multiFaAcceleration", "multiFaCount",
          "multiFaExtract", "multiFaReduce", "multiFaScan",
          "multiFaSequenceSwap", "multiFaToChain", "multiFaToVcf", "oboToDot",
          "oboTools", "ontologyEnrichment", "ontologyHistogram",
          "overlapEnrichments", "pFaTools", "pfaFindFast", "pileup",
          "plotFunctions", "prcompFormat", "primateRecon", "proximityBlockVcf",
          "quickOrthologs", "randSeq", "reconstructSeq", "samConsensus",
          "samInfo", "samToBed", "samToWig", "sampleVcf", "scCount",
          "selectionMcmc", "selectionMle", "simRecon", "simulateBed",
          "simulateDivergentWindowsVcf", "simulateEvol", "simulatePcr",
          "simulateSam", "simulateVcf", "simulateWrightFisher", "slurmCheck",
          "sortGraph", "statCalc", "strawToBedpe", "vcfAfs",
          "vcfAncestorAnnotation", "vcfFilter", "vcfFormat", "vcfInfo",
          "vcfToFa", "wigTools"]


def _edge_sam(genome) -> str:
    """Coordinate-sorted SAM text over chrA (240 bp), chrB (180 bp) and
    chrC (90 bp, no reads)."""
    rng = np.random.default_rng(4)

    def seq(chrom, pos, cigar, alt=None):
        """Read bases for a cigar [(n, op)] at 1-based pos; alt {0-based
        ref pos: code}."""
        g, p, out = genome[chrom], pos - 1, []
        for n, op in cigar:
            if op == "M":
                part = g[p:p + n].copy()
                for k, a in (alt or {}).items():
                    if p <= k < p + n:
                        part[k - p] = a
                out.append(part)
                p += n
            elif op in "IS":
                out.append(rng.integers(0, 4, n).astype(np.int8))
            else:
                p += n
        return dna.to_string(np.concatenate(out))

    reads = []
    ins = [(2, "S"), (5, "M"), (3, "I"), (40, "M")]
    ins_seq = seq("chrA", 1, ins)
    for i in range(4):  # the same insertion in every read
        reads.append(("chrA", 1, f"ins{i}", 16 * (i % 2), ins, ins_seq))
    reads.append(("chrA", 30, "nskip", 0, [(10, "M"), (20, "N"), (2, "I"),
                                           (15, "M")], None))
    for i, pos in enumerate(range(60, 151, 10)):
        cig = [(50, "M")]
        alt = {99: (genome["chrA"][99] + 1) % 4} if i % 4 else None
        flag = (1 | (64 if i % 2 else 128)) | (16 * (i % 3 == 0))
        reads.append(("chrA", pos, f"mid{i}", flag, cig, seq("chrA", pos,
                                                            cig, alt)))
    for i in range(3):  # a deletion to the end of chrA
        cig = [(35, "M"), (6, "D")]
        reads.append(("chrA", 200, f"end{i}", 16 * i % 32, cig, None))
    reads.append(("chrB", 1, "b0", 0, [(20, "M")], None))
    for i in range(3):
        cig = [(3, "M"), (2, "D"), (30, "M"), (4, "S")]
        reads.append(("chrB", 100, f"b{i + 1}", 1 | 64 | 16 * i % 32, cig,
                      None))
    lines = ["@HD\tVN:1.6\tSO:coordinate"]
    lines += [f"@SQ\tSN:{c}\tLN:{len(g)}" for c, g in genome.items()]
    for chrom, pos, name, flag, cig, text in reads:
        text = text or seq(chrom, pos, cig)
        cigar = "".join(f"{n}{op}" for n, op in cig)
        lines.append(f"{name}\t{flag}\t{chrom}\t{pos}\t60\t{cigar}\t*\t0\t0\t"
                     f"{text}\t*")
    lines.append("u0\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGT\t*")
    return "".join(ln + "\n" for ln in lines)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tools"))
    ref, exp, _, _ = _variant_inputs(tmp, seed=11, n_reads=1500)
    rng = np.random.default_rng(2)
    genome = {c: rng.integers(0, 4, n).astype(np.int8)
              for c, n in (("chrA", 240), ("chrB", 180), ("chrC", 90))}
    edge_ref = os.path.join(tmp, "edge.fa")
    _write_reference(edge_ref, genome)
    edge = os.path.join(tmp, "edge.sam")
    with open(edge, "w") as f:
        f.write(_edge_sam(genome))
    files = {"tmp": tmp}
    for name, sam, fa in (("variants", exp, ref), ("edge", edge, edge_ref)):
        header, records = jsam.read(sam)
        bam = sam[:-4] + ".bam"
        bam_writer.write_bam(bam, header, records)
        files[name] = {"sam": sam, "bam": bam, "ref": fa}
    return files


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("data", ["variants", "edge"])
@pytest.mark.parametrize("fmt", ["sam", "bam"])
@pytest.mark.parametrize("min_dp", [0, 5])
def test_pileup_byte_identical(inputs, tmp_path, data, fmt, min_dp):
    """pileup's table, with and without -minDP (which counts insertions
    too), equals the JAX tool's."""
    src = inputs[data][fmt]
    jpileup.main([src, "-o", str(tmp_path / "jax.txt"),
                  "-minDP", str(min_dp)])
    tpileup.main([src, "-o", str(tmp_path / "port.txt"),
                  "-minDP", str(min_dp)])
    got, want = _read(tmp_path / "port.txt"), _read(tmp_path / "jax.txt")
    assert got == want
    assert got.count(b"\n") > 10


@pytest.mark.parametrize("data", ["variants", "edge"])
@pytest.mark.parametrize("fmt", ["sam", "bam"])
@pytest.mark.parametrize("subs", [False, True])
@pytest.mark.parametrize("multi_fa", [False, True])
def test_sam_consensus_byte_identical(inputs, tmp_path, data, fmt, subs,
                                      multi_fa):
    """samConsensus's FASTA, and with -multiFaDir each chromosome's
    two-record alignment, equal the JAX tool's, with
    -substitutionsOnly and without."""
    out = {}
    for name, mod in (("jax", jcons), ("port", tcons)):
        d = tmp_path / name
        d.mkdir()
        args = [inputs[data][fmt], inputs[data]["ref"], str(d / "out.fa")]
        if subs:
            args.append("-substitutionsOnly")
        if multi_fa:
            (d / "multi").mkdir()
            args += ["-multiFaDir", str(d / "multi")]
        mod.main(args)
        out[name] = {p: _read(os.path.join(root, p))
                     for root, _, files in os.walk(d) for p in files}
    assert out["port"] == out["jax"]
    # out.fa, and a file a chromosome with reads (chrC of "edge" has none)
    assert len(out["port"]) == 1 + 2 * multi_fa


@pytest.mark.parametrize("threshold", ["-0.1", "1.5"])
def test_sam_consensus_threshold_refused(inputs, tmp_path, threshold):
    args = [inputs["edge"]["sam"], inputs["edge"]["ref"],
            str(tmp_path / "out.fa"), "-insertionThreshold", threshold]
    with pytest.raises(SystemExit) as want:
        jcons.main(args)
    with pytest.raises(SystemExit) as got:
        tcons.main(args)
    assert str(got.value) == str(want.value)
    assert "between 0 and 1" in str(got.value)


@pytest.mark.parametrize("data", ["variants", "edge"])
@pytest.mark.parametrize("fmt", ["sam", "bam"])
@pytest.mark.parametrize("frag", [-1, 150])
def test_sam_to_bed_byte_identical(inputs, tmp_path, data, fmt, frag):
    """samToBed's records, one per mapped read, and with -fragLength the
    fragments clipped to the chromosome, equal the JAX tool's."""
    src = inputs[data][fmt]
    args = ["-fragLength", str(frag)]
    jbed.main([src, str(tmp_path / "jax.bed"), *args])
    tbed.main([src, str(tmp_path / "port.bed"), *args])
    got, want = _read(tmp_path / "port.bed"), _read(tmp_path / "jax.bed")
    assert got == want
    _, records = jsam.read(src)
    mapped = sum(bool(r.cigar) and r.cigar[0].op != "*" for r in records)
    assert got.count(b"\n") == mapped


def test_umbrella_lists_the_ported_tools(capsys):
    """help (and no argument) lists the 130 ported tools, each a key of
    the JAX umbrella's COMMANDS; 8 of the JAX's are left."""
    for argv in ([], ["help"], ["-h"]):
        umbrella.main(argv)
        lines = capsys.readouterr().out.splitlines()
        listed = [ln.split()[0] for ln in lines if ln.startswith("  ")]
        assert listed == PORTED
    assert sorted(umbrella.COMMANDS) == PORTED
    assert len(PORTED) == 130
    assert set(PORTED) <= set(jmain.COMMANDS)
    assert len(set(jmain.COMMANDS) - set(PORTED)) == 8
    assert all("TPU" not in desc for _, desc in umbrella.COMMANDS.values())


def test_umbrella_unknown_tool_exits():
    """An unknown tool exits as in the JAX umbrella; so does a JAX tool
    that the port does not have."""
    for mod in (umbrella, jmain):
        with pytest.raises(SystemExit, match="unknown command: noSuchTool"):
            mod.main(["noSuchTool"])
    with pytest.raises(SystemExit,
                       match="unknown command: vcfEffectPrediction"):
        umbrella.main(["vcfEffectPrediction", "x.vcf"])


@pytest.mark.parametrize("tool", ["pileup", "samToBed", "samConsensus",
                                  "gsw", "faFormat", "bedMerge", "bedToWig",
                                  "intervalOverlap", "mergesort",
                                  "faFindFast", "faFilter", "gcContent",
                                  "assemblyStats", "faUniq", "locateCG",
                                  "digestGenome", "faToPredictSet",
                                  "prcompFormat", "findAndReplace",
                                  "bedToFasta", "bedToAminoAcid",
                                  "reconstructSeq", "vcfFormat", "vcfToFa",
                                  "vcfFilter", "vcfInfo", "multiFaToVcf",
                                  "bedFormat", "bedFilter",
                                  "multiFaToChain", "fastqFilter",
                                  "samInfo", "wigTools"])
def test_umbrella_dispatch_equals_direct_call(inputs, axt_input, tmp_path,
                                              tool):
    """A tool run through the umbrella writes what its own main writes."""
    src, ref = inputs["edge"]["sam"], inputs["edge"]["ref"]
    beds = str(tmp_path / "reads.bed")
    tbed.main([src, beds])
    sizes = tmp_path / "edge.sizes"
    sizes.write_text("chrA\t240\nchrB\t180\nchrC\t90\n")
    multi = tmp_path / "multi"
    multi.mkdir()
    tcons.main([src, ref, str(tmp_path / "cons.fa"), "-multiFaDir",
                str(multi)])
    aln = str(multi / "chrA.fa")
    pairs = tmp_path / "pairs.tsv"
    pairs.write_text("chrA\tchrZ\n")
    tree = tmp_path / "tree.nh"
    with open(aln) as fh:
        names = [ln[1:].strip() for ln in fh if ln.startswith(">")]
    tree.write_text(f"({names[0]}:0.1,{names[1]}:0.2)anc;")
    chr_a = tfasta.to_map(tfasta.read(ref))["chrA"]
    snvs = [(p, "ACGT"[chr_a[p - 1]], "ACGT"[(chr_a[p - 1] + 1) % 4])
            for p in (10, 57, 200)]
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@r{i}\n{'ACGT' * i}\n+\n{'I' * 4 * i}\n"
                          for i in range(1, 20)))
    wig = tmp_path / "r.wig"
    wig.write_text("fixedStep chrom=chrA start=3 step=1\n"
                   + "".join(f"{i % 7}\n" for i in range(200)))
    vcf = tmp_path / "v.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n##INFO=<ID=DP,Number=1,Type=Integer,"
        'Description="Depth">\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\t'
        "INFO\n" + "".join(f"chrA\t{p}\t.\t{r}\t{a}\t30\tPASS\tDP={p}\n"
                           for p, r, a in snvs))
    direct = {"pileup": tpileup.main, "samToBed": tbed.main,
              "samConsensus": tcons.main, "gsw": tgsw.main,
              "faFormat": tfa_format.main, "bedMerge": tbed_merge.main,
              "bedToWig": tbed_to_wig.main,
              "intervalOverlap": tinterval_overlap.main,
              "mergesort": tmergesort.main,
              "faFindFast": tfa_find_fast.main, "faFilter": tfa_filter.main,
              "gcContent": tgc_content.main,
              "assemblyStats": tassembly_stats.main,
              "faUniq": tfa_uniq.main, "locateCG": tlocate_cg.main,
              "digestGenome": tdigest_genome.main,
              "faToPredictSet": tfa_to_predict_set.main,
              "prcompFormat": tprcomp_format.main,
              "findAndReplace": tfind_and_replace.main,
              "bedToFasta": tbed_to_fasta.main,
              "bedToAminoAcid": tbed_to_amino_acid.main,
              "reconstructSeq": treconstruct_seq.main,
              "vcfFormat": tvcf_format.main, "vcfToFa": tvcf_to_fa.main,
              "vcfFilter": tvcf_filter.main, "vcfInfo": tvcf_info.main,
              "multiFaToVcf": tmulti_fa_to_vcf.main,
              "bedFormat": tbed_format.main,
              "bedFilter": tbed_filter.main,
              "multiFaToChain": tmulti_fa_to_chain.main,
              "fastqFilter": tfastq_filter.main, "samInfo": tsam_info.main,
              "wigTools": twig_tools.main}[tool]
    out = {}
    for how in ("umbrella", "direct"):
        path = str(tmp_path / how)
        args = {"pileup": [src, "-o", path], "samToBed": [src, path],
                "samConsensus": [src, ref, path],
                "gsw": ["ggtools", axt_input, "-f", "vcf", "-o",
                        path],
                "faFormat": [ref, path, "-lineLength", "70", "-toLower",
                             beds],
                "bedMerge": [beds, path],
                "bedToWig": ["Reads", beds, str(sizes), path],
                "intervalOverlap": [beds, beds, path, "-relationship",
                                    "within"],
                "mergesort": [src, path, "-numRecordsPerChunk", "5"],
                "faFindFast": [aln, path, "-windowSize", "20", "-chrom",
                               "chrA"],
                "faFilter": [ref, path, "-minSize", "100"],
                "gcContent": [beds, ref, path],
                "assemblyStats": [ref, path],
                "faUniq": [ref, path],
                "locateCG": [aln, "chrA", path, "-compare", "-cgtype",
                             "cons"],
                "digestGenome": [ref, "MboI", path],
                "faToPredictSet": ["--windowSize", "30", "--stride", "5",
                                   "--withRevComp", ref, path],
                "prcompFormat": [aln, path],
                "findAndReplace": [beds, str(pairs), path, "-column", "0"],
                "bedToFasta": [ref, beds, path, "-revComp"],
                "bedToAminoAcid": [beds, ref, path],
                "reconstructSeq": [str(tree), aln, path],
                "vcfFormat": [str(vcf), path, "-csv"],
                "vcfToFa": [str(vcf), ref, path, "-useAlt"],
                "vcfFilter": [str(vcf), path, "-info", "DP>20"],
                "vcfInfo": ["-i", str(vcf), "-types", path],
                "multiFaToVcf": [aln, "chrA", path],
                "bedFormat": [beds, path, "-evenPadLength", "5",
                              "-chromSizeFile", str(sizes)],
                "bedFilter": [beds, path, "-minLength", "30", "-chrom",
                              "chrA"],
                "multiFaToChain": [aln, "chrA", "cons", path],
                "fastqFilter": [str(fq), path, "-minSize", "30",
                                "-setSeed", "4", "-subSet", "0.7"],
                "samInfo": ["mapq", src, path],
                "wigTools": ["math", str(wig), str(sizes), path,
                             "-movingAverageSmoothing", "3"]}[tool]
        if how == "umbrella":
            umbrella.main([tool, *args])
        else:
            direct(args)
        out[how] = _read(path)
    assert out["umbrella"] == out["direct"]
    assert out["umbrella"]


@pytest.fixture(scope="module")
def axt_input(tmp_path_factory):
    path = tmp_path_factory.mktemp("axt") / "a.axt"
    path.write_text("0 chr1 1 8 chrQ 1 8 + 100\nAAATAAAA\nAAACAAAA\n\n")
    return str(path)


def test_umbrella_imports_no_tool_before_dispatch():
    """Importing the umbrella, and listing the tools, loads no tool
    module; dispatching one loads that one."""
    code = ("import sys, gonomics_tpu_torch.cli.main as m\n"
            "m.main(['help'])\n"
            "tools = {t for t, _ in m.COMMANDS.values()}\n"
            "print(sorted(tools & set(sys.modules)))\n"
            "sys.exit(1 if tools & set(sys.modules) else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


def test_umbrella_gsw_align_wants_the_card(tmp_path, monkeypatch):
    """gsw align through the umbrella runs on the card unless told
    --device cpu: without a card it raises, for a graph and a FASTA
    reference, on both engines."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    ref = tmp_path / "ref.fa"
    ref.write_text(">chr1\n" + "ACGTTGCA" * 40 + "\n")
    fq = tmp_path / "r.fq"
    fq.write_text("@r\nACGTTGCAACGTTGCAACGTTGCAACGTTGCAACGT\n+\n"
                  + "I" * 36 + "\n")
    for engine in ("host", "tpu"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            umbrella.main(["gsw", "align", str(ref), str(fq), "--engine",
                           engine, "-o", str(tmp_path / "out")])


def test_pyproject_installs_the_umbrella():
    """gonomics-torch names the umbrella's main; the JAX package's 13
    entries stay as they were."""
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    mod, _, fn = scripts["gonomics-torch"].partition(":")
    assert getattr(__import__(mod, fromlist=[fn]), fn) is umbrella.main
    jax_entries = {k: v for k, v in scripts.items() if k != "gonomics-torch"}
    assert jax_entries == {
        "gonomics": "gonomics_tpu.cli.main:main",
        "globalAlignment": "gonomics_tpu.cli.global_alignment:main",
        "faFindFast": "gonomics_tpu.cli.fa_find_fast:main",
        "faFormat": "gonomics_tpu.cli.fa_format:main",
        "gsw": "gonomics_tpu.cli.gsw_cmd:main",
        "callVariants": "gonomics_tpu.cli.call_variants:main",
        "samConsensus": "gonomics_tpu.cli.sam_consensus:main",
        "pileup": "gonomics_tpu.cli.pileup_cmd:main",
        "reconstructSeq": "gonomics_tpu.cli.reconstruct_seq:main",
        "bedMerge": "gonomics_tpu.cli.bed_merge:main",
        "bedToWig": "gonomics_tpu.cli.bed_to_wig:main",
        "intervalOverlap": "gonomics_tpu.cli.interval_overlap:main",
        "mergesort": "gonomics_tpu.cli.mergesort:main"}


def test_new_modules_import_no_jax():
    """The slice's modules import neither JAX nor the JAX package."""
    code = ("import sys, gonomics_tpu_torch.consensus,"
            " gonomics_tpu_torch.io.formats, gonomics_tpu_torch.io.vcf,"
            " gonomics_tpu_torch.io.fasta, gonomics_tpu_torch.cli.main,"
            " gonomics_tpu_torch.cli.pileup_cmd,"
            " gonomics_tpu_torch.cli.sam_consensus,"
            " gonomics_tpu_torch.cli.sam_to_bed,"
            " gonomics_tpu_torch.cli.gsw_cmd,"
            " gonomics_tpu_torch.interval, gonomics_tpu_torch.sortio,"
            " gonomics_tpu_torch.io.wig, gonomics_tpu_torch.io.bam_writer,"
            " gonomics_tpu_torch.cli.fa_format,"
            " gonomics_tpu_torch.cli.bed_merge,"
            " gonomics_tpu_torch.cli.bed_to_wig,"
            " gonomics_tpu_torch.cli.interval_overlap,"
            " gonomics_tpu_torch.cli.mergesort,"
            " gonomics_tpu_torch.numbers, gonomics_tpu_torch.numbers.logspace,"
            " gonomics_tpu_torch.native,"
            " gonomics_tpu_torch.cli.fa_find_fast,"
            " gonomics_tpu_torch.cli.fa_filter,"
            " gonomics_tpu_torch.cli.gc_content,"
            " gonomics_tpu_torch.cli.fa_info, gonomics_tpu_torch.cli.fa_uniq,"
            " gonomics_tpu_torch.cli.fa_bin,"
            " gonomics_tpu_torch.cli.cat_multi_fa,"
            " gonomics_tpu_torch.cli.assembly_stats,"
            " gonomics_tpu_torch.cli.locate_cg,"
            " gonomics_tpu_torch.cli.count_pair_of_bases,"
            " gonomics_tpu_torch.codon, gonomics_tpu_torch.numbers.matrix,"
            " gonomics_tpu_torch.io.pfasta, gonomics_tpu_torch.phylo,"
            " gonomics_tpu_torch.phylo.etree,"
            " gonomics_tpu_torch.phylo.reconstruct,"
            " gonomics_tpu_torch.cli.digest_genome,"
            " gonomics_tpu_torch.cli.fa_to_predict_set,"
            " gonomics_tpu_torch.cli.prcomp_format,"
            " gonomics_tpu_torch.cli.find_and_replace,"
            " gonomics_tpu_torch.cli.bed_to_fasta,"
            " gonomics_tpu_torch.cli.bed_to_amino_acid,"
            " gonomics_tpu_torch.cli.reconstruct_seq,"
            " gonomics_tpu_torch.cli.primate_recon,"
            " gonomics_tpu_torch.cli.mouse_recon,"
            " gonomics_tpu_torch.cli.vcf_format,"
            " gonomics_tpu_torch.cli.vcf_to_fa,"
            " gonomics_tpu_torch.cli.vcf_filter,"
            " gonomics_tpu_torch.cli.vcf_info,"
            " gonomics_tpu_torch.cli.multi_fa_to_vcf,"
            " gonomics_tpu_torch.cli.bed_format,"
            " gonomics_tpu_torch.io.bed_graph, gonomics_tpu_torch.io.bed,"
            " gonomics_tpu_torch.cli.bed_filter,"
            " gonomics_tpu_torch.cli.bed_math,"
            " gonomics_tpu_torch.cli.bed_split,"
            " gonomics_tpu_torch.cli.bed_shear,"
            " gonomics_tpu_torch.cli.bed_trim,"
            " gonomics_tpu_torch.cli.bed_distance_from_chr_ends,"
            " gonomics_tpu_torch.cli.bed_minimum_distance_name,"
            " gonomics_tpu_torch.cli.bed_similarity,"
            " gonomics_tpu_torch.cli.bed_overlap_by_window,"
            " gonomics_tpu_torch.cli.bed_value_wig,"
            " gonomics_tpu_torch.cli.bed_graph_to_wig,"
            " gonomics_tpu_torch.cli.multi_fa_count,"
            " gonomics_tpu_torch.cli.multi_fa_scan,"
            " gonomics_tpu_torch.cli.multi_fa_extract,"
            " gonomics_tpu_torch.cli.multi_fa_reduce,"
            " gonomics_tpu_torch.cli.merge_multi_fa,"
            " gonomics_tpu_torch.cli.multi_fa_sequence_swap,"
            " gonomics_tpu_torch.cli.multi_fa_to_chain,"
            " gonomics_tpu_torch.io.bai, gonomics_tpu_torch.io.sam,"
            " gonomics_tpu_torch.io.fastq, gonomics_tpu_torch.fileio,"
            " gonomics_tpu_torch.cli.fastq_filter,"
            " gonomics_tpu_torch.cli.fastq_format,"
            " gonomics_tpu_torch.cli.fastq_replace_seq,"
            " gonomics_tpu_torch.cli.long_read_lib_stats,"
            " gonomics_tpu_torch.cli.sam_info,"
            " gonomics_tpu_torch.cli.sam_to_wig,"
            " gonomics_tpu_torch.cli.bed_count_bam,"
            " gonomics_tpu_torch.cli.bam_tag_to_read_group,"
            " gonomics_tpu_torch.cli.wig_tools,"
            " gonomics_tpu_torch.numbers.gorand,"
            " gonomics_tpu_torch.numbers.distributions,"
            " gonomics_tpu_torch.numbers.gosamplers,"
            " gonomics_tpu_torch.numbers.fit,"
            " gonomics_tpu_torch.cli.rand_seq,"
            " gonomics_tpu_torch.popgen, gonomics_tpu_torch.dna,"
            " gonomics_tpu_torch.align.multi,"
            " gonomics_tpu_torch.align.oracle,"
            " gonomics_tpu_torch.cli.stat_calc,"
            " gonomics_tpu_torch.cli.plot_functions,"
            " gonomics_tpu_torch.cli.popgen_tools,"
            " gonomics_tpu_torch.io.bedpe,"
            " gonomics_tpu_torch.lift_enrichment,"
            " gonomics_tpu_torch.cli.bedpe_filter,"
            " gonomics_tpu_torch.cli.bedpe_overlap,"
            " gonomics_tpu_torch.cli.interval_contacts,"
            " gonomics_tpu_torch.cli.interval_subset_matrix,"
            " gonomics_tpu_torch.cli.gene_assignment_stats,"
            " gonomics_tpu_torch.cli.overlap_enrichments,"
            " gonomics_tpu_torch.cli.lift_coordinates,"
            " gonomics_tpu_torch.cli.divergence_spectrum,"
            " gonomics_tpu_torch.genotype,"
            " gonomics_tpu_torch.cli.vcf_sampling,"
            " gonomics_tpu_torch.cli.allele_split,"
            " gonomics_tpu_torch.io.maf, gonomics_tpu_torch.cli.maf_tools,"
            " gonomics_tpu_torch.cli.ax_tools,"
            " gonomics_tpu_torch.cli.axt_sam,"
            " gonomics_tpu_torch.io.gtf, gonomics_tpu_torch.cli.gtf_tools,"
            " gonomics_tpu_torch.cli.get_promoter,"
            " gonomics_tpu_torch.cli.gene_id_to_name,"
            " gonomics_tpu_torch.cli.sc_count,"
            " gonomics_tpu_torch.cli.quick_orthologs,"
            " gonomics_tpu_torch.phylo.accel,"
            " gonomics_tpu_torch.cli.multi_fa_acceleration,"
            " gonomics_tpu_torch.cli.branch_lengths_multi_fa_bed,"
            " gonomics_tpu_torch.simulate,"
            " gonomics_tpu_torch.cli.simulate_sam,"
            " gonomics_tpu_torch.cli.simulate_tools,"
            " gonomics_tpu_torch.phylo.simpletree,"
            " gonomics_tpu_torch.cli.dot_to_newick,"
            " gonomics_tpu_torch.sketch, gonomics_tpu_torch.phylo.draw,"
            " gonomics_tpu_torch.cli.draw_newick_tree,"
            " gonomics_tpu_torch.io.formats,"
            " gonomics_tpu_torch.cli.simulate_evol,"
            " gonomics_tpu_torch.cli.sim_recon,"
            " gonomics_tpu_torch.cli.ils_reconstruct_seq,"
            " gonomics_tpu_torch.ontology, gonomics_tpu_torch.ontology.obo,"
            " gonomics_tpu_torch.ontology.gaf, gonomics_tpu_torch.io.hic,"
            " gonomics_tpu_torch.cli.ontology_tools,"
            " gonomics_tpu_torch.cli.obo_to_dot,"
            " gonomics_tpu_torch.cli.ontology_histogram,"
            " gonomics_tpu_torch.cli.assign_genome_space,"
            " gonomics_tpu_torch.cli.straw_to_bedpe,"
            " gonomics_tpu_torch.numbers.gomath, gonomics_tpu_torch.pdna,"
            " gonomics_tpu_torch.browser, gonomics_tpu_torch.dna_threebit,"
            " gonomics_tpu_torch.io.giraf, gonomics_tpu_torch.io.binary_giraf,"
            " gonomics_tpu_torch.cli.pfa_tools,"
            " gonomics_tpu_torch.cli.pfa_find_fast,"
            " gonomics_tpu_torch.cli.sort_graph,"
            " gonomics_tpu_torch.cli.giraf_compress,"
            " gonomics_tpu_torch.cli.giraf_sort,"
            " gonomics_tpu_torch.graph, gonomics_tpu_torch.align.draw,"
            " gonomics_tpu_torch.lastz_writer,"
            " gonomics_tpu_torch.cli.giraf_simulate,"
            " gonomics_tpu_torch.cli.mult_fa_visualizer,"
            " gonomics_tpu_torch.cli.mult_fa_visualize_beds,"
            " gonomics_tpu_torch.cli.fa_chunk_align,"
            " gonomics_tpu_torch.cli.fa_draw_aln_chunks,"
            " gonomics_tpu_torch.cli.last_z_writer,"
            " gonomics_tpu_torch.cli.format_ideogram,"
            " gonomics_tpu_torch.cli.slurm_check\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gonomics_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr


def test_umbrella_module_function_targets(tmp_path, monkeypatch):
    """A ``module:function`` target runs that function with the rest of
    the argv, as the JAX umbrella's target.partition(":") does; a bare
    module runs its main. The popgen tools' targets name their JAX
    targets' functions."""
    (tmp_path / "fake_tool_mod.py").write_text(
        "calls = []\n"
        "def main(argv):\n    calls.append(('main', argv))\n"
        "def other(argv):\n    calls.append(('other', argv))\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setitem(umbrella.COMMANDS, "fakeOther",
                        ("fake_tool_mod:other", "a test target"))
    monkeypatch.setitem(umbrella.COMMANDS, "fakeMain",
                        ("fake_tool_mod", "a test target"))
    umbrella.main(["fakeOther", "a", "-b"])
    umbrella.main(["fakeMain", "c"])
    import fake_tool_mod
    assert fake_tool_mod.calls == [("other", ["a", "-b"]), ("main", ["c"])]
    for name in ("selectionMle", "selectionMcmc", "dunnIndex",
                 "mcmcTraceStats", "simulateWrightFisher", "statCalc",
                 "plotFunctions", "sampleVcf", "proximityBlockVcf",
                 "filterGenotypes", "vcfAncestorAnnotation", "vcfAfs",
                 "haplotypeGenerator", "alleleSplit", "mafFilter",
                 "mafToBed", "mafToMultiFa", "mafIndels", "axTools",
                 "axtSam", "gtfTools", "getPromoter", "geneIdToName",
                 "scCount", "quickOrthologs", "multiFaAcceleration",
                 "branchLengthsMultiFaBed", "simulateSam", "simulateBed",
                 "simulateVcf", "simulateDivergentWindowsVcf",
                 "simulatePcr", "dotToNewick", "drawNewickTree",
                 "simulateEvol", "simRecon", "ilsReconstructSeq",
                 "oboTools", "gafFilter", "ontologyEnrichment", "oboToDot",
                 "ontologyHistogram", "assignGenomeSpace", "strawToBedpe"):
        port, jax = umbrella.COMMANDS[name][0], jmain.COMMANDS[name][0]
        assert port.replace("gonomics_tpu_torch.", "gonomics_tpu.") == jax


@pytest.fixture(scope="module")
def popgen_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("popgen_umbrella")
    popgen_vcf(str(d / "p.vcf"), 60, sites=10, samples=5)
    (d / "groups.list").write_text(GROUPS)
    (d / "aln.fa").write_text(_aln(61))
    (d / "r.bed").write_text("chr1\t0\t50\nchr1\t30\t110\n")
    jmain.main(["selectionMcmc", str(d / "p.vcf"), str(d / "t.trace"),
                "-iterations", "12", "-setSeed", "2", "-integralError",
                "1e-5"])
    return {k: str(d / k) for k in ("p.vcf", "groups.list", "aln.fa",
                                    "r.bed", "t.trace")}


@pytest.mark.parametrize("tool", ["statCalc", "plotFunctions",
                                  "selectionMle", "selectionMcmc",
                                  "dunnIndex", "dunnIndex_realign",
                                  "mcmcTraceStats", "simulateWrightFisher"])
def test_umbrella_popgen_tools_equal_jax_umbrella(popgen_inputs, tmp_path,
                                                  tool):
    """Each popgen tool through gonomics-torch writes what the JAX
    umbrella's writes."""
    f = popgen_inputs
    out = {}
    for side, mod in (("jax", jmain), ("port", umbrella)):
        path = str(tmp_path / side)
        argv = {
            "statCalc": ["statCalc", "-outFile", path, "-sampleNormal",
                         "1,2,12", "-setSeed", "3"],
            "plotFunctions": ["plotFunctions", "AfsProbabilityDerived",
                              "1.5,9,1e-5", path],
            "selectionMle": ["selectionMle", f["p.vcf"], path,
                             "-unPolarized", "-integralError", "1e-5"],
            "selectionMcmc": ["selectionMcmc", f["p.vcf"], path,
                              "-iterations", "6", "-setSeed", "5"],
            "dunnIndex": ["dunnIndex", f["r.bed"], f["aln.fa"],
                          f["groups.list"], path],
            "dunnIndex_realign": ["dunnIndex", f["r.bed"], f["aln.fa"],
                                  f["groups.list"], path, "-realign"],
            "mcmcTraceStats": ["mcmcTraceStats", f["t.trace"], path,
                               "-parameterName", "Sigma"],
            "simulateWrightFisher": ["simulateWrightFisher", path, "-N",
                                     "25", "-t", "9", "-g", "2",
                                     "-setSeed", "8"]}[tool]
        mod.main(argv)
        out[side] = _read(path)
    assert out["port"] == out["jax"]
    assert out["jax"]


@pytest.fixture(scope="module")
def interval_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("interval_umbrella")
    rng = np.random.default_rng(2902)
    rows = _bedpe_rows(rng, 30)
    beds = _bed_rows(rng, 20)
    files = {
        "pe.bedpe": ["\t".join(r[:10]) for r in rows],
        "b.bed": ["\t".join(r[:6]) for r in beds],
        "a.bed": ["\t".join(r[:6]) for r in beds[:8]],
        "list.txt": [str(d / "b.bed"), str(d / "a.bed")],
        "union.bed": [f"chr1\t{s}\t{s + 300}" for s in range(0, 2700, 300)],
        "truth.bedpe": ["\t".join(r[:3] + r[:3] + [r[3], "0", "+", "-"])
                        for r in beds],
        "test.bed": ["\t".join(r[:4]) for r in beds[::2]]
        + ["\t".join(r[:3] + ["other"]) for r in beds[1::2]],
        "e1.bed": [f"chr1\t{s}\t{s + 40}" for s in range(0, 2900, 150)],
        "e2.bed": [f"chr1\t{s}\t{s + 9}" for s in range(5, 2900, 97)],
        "space.bed": ["chr1\t0\t3000"],
        "t.chain": [_chain_text(50, "chr1", 3000, "+", 0, 3000, "q1", 2998,
                                "+", 0, 2998, 1, [(1000, 2, 0),
                                                  (1998, 0, 0)])],
        "s.vcf": VCF_HEAD + [_vcf_line("chr1", p, "ACGT"[p % 4],
                                       "ACGT"[(p + 1) % 4])
                             for p in range(7, 2990, 61)]}
    for name, lines in files.items():
        (d / name).write_text("".join(ln + "\n" for ln in lines))
    return {k: str(d / k) for k in files}


@pytest.mark.parametrize("tool", ["bedpeFilter", "bedpeOverlap",
                                  "intervalContacts", "intervalSubsetMatrix",
                                  "geneAssignmentStats", "overlapEnrichments",
                                  "liftCoordinates", "divergenceSpectrum"])
def test_umbrella_interval_tools_equal_jax_umbrella(interval_inputs,
                                                    tmp_path, capsys, tool):
    """Each interval and lift tool through gonomics-torch writes what the
    JAX umbrella's writes, files and stdout."""
    f = interval_inputs
    out = {}
    for side, mod in (("jax", jmain), ("port", umbrella)):
        path = str(tmp_path / side)
        argv = {
            "bedpeFilter": ["bedpeFilter", f["pe.bedpe"], path,
                            "-minDistance", "200"],
            "bedpeOverlap": ["bedpeOverlap", "-bedSelect", f["b.bed"],
                             f["pe.bedpe"], path],
            "intervalContacts": ["intervalContacts", f["pe.bedpe"],
                                 f["b.bed"], path],
            "intervalSubsetMatrix": ["intervalSubsetMatrix", f["union.bed"],
                                     f["list.txt"], path, "-fraction"],
            "geneAssignmentStats": ["geneAssignmentStats", f["truth.bedpe"],
                                    f["test.bed"], path, path + ".non"],
            "overlapEnrichments": ["overlapEnrichments", "exact",
                                   f["e1.bed"], f["e2.bed"], f["space.bed"],
                                   path],
            "liftCoordinates": ["liftCoordinates", f["t.chain"], f["b.bed"],
                                path, path + ".non"],
            "divergenceSpectrum": ["divergenceSpectrum", f["union.bed"],
                                   f["s.vcf"], path]}[tool]
        mod.main(argv)
        out[side] = (_read(path), capsys.readouterr().out)
        if os.path.exists(path + ".non"):
            out[side] += (_read(path + ".non"),)
    assert out["port"] == out["jax"]
    assert out["jax"][0]


@pytest.fixture(scope="module")
def vcf_maf_axt_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("vcf_maf_axt_umbrella")
    rng = np.random.default_rng(3001)
    g = "".join(rng.choice(list("ACGT"), 400))
    trio = []
    for k, p in enumerate(range(20, 380, 23)):
        alt = "ACGT"[("ACGT".index(g[p - 1]) + 1) % 4]
        gts = ("0/0\t1/1\t0/1" if k % 3 else "0/0\t0/0\t0/1")
        trio.append(f"chr1\t{p}\t.\t{g[p - 1]}\t{alt}\t30\tPASS\t.\tGT\t"
                    + gts)
    reads = ["@HD\tVN:1.6\tSO:coordinate", "@SQ\tSN:chr1\tLN:400"]
    for i, s in enumerate(range(0, 340, 17)):
        seq = list(g[s:s + 50])
        if i % 2:  # poppa's alleles
            for row in trio:
                p = int(row.split("\t")[1])
                if s < p <= s + 50:
                    seq[p - 1 - s] = row.split("\t")[4]
        reads.append(f"r{i}\t0\tchr1\t{s + 1}\t60\t50M\t*\t0\t0\t"
                     f"{''.join(seq)}\t*")
    axt = ["0 chr1 11 30 chrQ 1 20 + 120", g[10:30], g[10:20] + "N" + g[21:30],
           "", "1 chr1 101 120 chrQ 31 51 - 80", g[100:110] + "N" + g[111:120]
           + "-", g[100:120] + "A", ""]
    files = {
        "t.fa": [">chr1", g], "t.sizes": ["chr1\t400"],
        "q.sizes": ["chrQ\t100"],
        "trio.vcf": ["##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\t"
                     "QUAL\tFILTER\tINFO\tFORMAT\tmomma\tpoppa\tkiddo"]
        + trio,
        "reads.sam": reads, "names.txt": ["kiddo", "momma"],
        "regions.bed": ["chr1\t0\t200", "chr1\t250\t400"],
        "aln.fa": [">chr1", g[:100] + "--" + g[100:], ">anc",
                   g[:50] + "T" + g[51:100] + "CC" + g[100:]],
        "a.maf": ["##maf version=1", "a score=12.0",
                  f"s t.chr1 10 20 + 400 {g[10:30]}",
                  f"s q.chr1 0 20 + 100 {g[10:30]}", "",
                  "a score=3.5", f"s t.chr1 60 15 + 400 {g[60:75]}",
                  "e q.chr1 30 1 - 100 I", ""],
        "species.txt": ["t", "q"], "c.axt": axt}
    for name, lines in files.items():
        (d / name).write_text("".join(ln + "\n" for ln in lines))
    popgen_vcf(str(d / "afs.vcf"), 61, sites=8, samples=4)
    return {k: str(d / k) for k in list(files) + ["afs.vcf"]}


@pytest.mark.parametrize("tool", [
    "sampleVcf", "proximityBlockVcf", "filterGenotypes",
    "filterGenotypes_byname",
    "vcfAncestorAnnotation", "vcfAfs", "haplotypeGenerator", "alleleSplit",
    "mafFilter", "mafToBed", "mafToMultiFa", "mafIndels", "axTools_stats",
    "axTools_swap", "axTools_fasta", "axtSam"])
def test_umbrella_vcf_maf_axt_tools_equal_jax_umbrella(
        vcf_maf_axt_inputs, tmp_path, monkeypatch, capsys, tool):
    """Each VCF, MAF and axt tool of item 10 and item 11 through
    gonomics-torch writes what the JAX umbrella's writes, files and
    stdout (alleleSplit into its working directory)."""
    f = vcf_maf_axt_inputs
    out = {}
    for side, mod in (("jax", jmain), ("port", umbrella)):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        o = str(d / "out")
        argv = {
            "sampleVcf": ["sampleVcf", f["trio.vcf"], o, "-numVariants", "5",
                          "-numSamples", "2", "-setSeed", "3"],
            "proximityBlockVcf": ["proximityBlockVcf", f["trio.vcf"], o,
                                  "40", "-setSeed", "4"],
            "filterGenotypes": ["filterGenotypes", f["trio.vcf"], o, "-f1",
                                "kiddo", "-parentOne", "momma",
                                "-parentTwo", "poppa"],
            "filterGenotypes_byname": ["filterGenotypes", f["trio.vcf"], o,
                                       "-byname", f["names.txt"]],
            "vcfAncestorAnnotation": ["vcfAncestorAnnotation", f["trio.vcf"],
                                      f["aln.fa"], o],
            "vcfAfs": ["vcfAfs", f["afs.vcf"], o, "-plotSelectionLikelihood",
                       o + ".lik", "-leftBound", "-2", "-rightBound", "3",
                       "-numberOfPoints", "2", "-integralError", "1e-5"],
            "haplotypeGenerator": ["haplotypeGenerator", f["t.fa"],
                                   f["trio.vcf"], f["regions.bed"], str(d),
                                   "-includeRef"],
            "alleleSplit": ["alleleSplit", "-f1", "kiddo", "-parentOne",
                            "momma", "-parentTwo", "poppa", f["reads.sam"],
                            f["trio.vcf"]],
            "mafFilter": ["mafFilter", f["a.maf"], o, "-threshold", "5"],
            "mafToBed": ["mafToBed", f["a.maf"], o, "t"],
            "mafToMultiFa": ["mafToMultiFa", f["a.maf"], f["t.fa"],
                             f["species.txt"], o, "-noMask"],
            "mafIndels": ["mafIndels", f["a.maf"], "t", "q", o, o + ".del",
                          "-eiThreshold", "0.5"],
            "axTools_stats": ["axTools", "--stats", "--bedfile", o,
                              f["c.axt"], f["regions.bed"]],
            "axTools_swap": ["axTools", "--swap", "--tLen", f["t.sizes"],
                             "--qLen", f["q.sizes"], f["c.axt"], o],
            "axTools_fasta": ["axTools", "--gap", f["c.axt"], o],
            "axtSam": ["axtSam", "--fasta", f["t.fa"], f["c.axt"], o]}[tool]
        mod.main(argv)
        files = {n: _read(str(d / n)) for n in sorted(os.listdir(d))}
        out[side] = (files, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert any(out["jax"][0].values())



@pytest.fixture(scope="module")
def gtf_accel_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("gtf_accel_umbrella")
    rng = np.random.default_rng(3120)

    def att(**kv):
        return " ".join(f'{k} "{v}";' for k, v in kv.items())

    gtf = []
    for k, (chrom, s, strand) in enumerate([
            ("chr1", 100, "+"), ("chr1", 900, "-"), ("chr1", 1700, "+"),
            ("chr2", 200, "-"), ("chrU", 50, "+")]):
        g, t = f"G{k}", f"G{k}.1"
        name = "" if k == 2 else f"N{k}"
        gtf.append(f"{chrom}\tt\ttranscript\t{s}\t{s + 300}\t.\t{strand}\t.\t"
                   + att(gene_id=g, transcript_id=t, gene_name=name))
        for e, (a, b) in enumerate([(s, s + 100), (s + 200, s + 300)]):
            ea = att(gene_id=g, transcript_id=t, exon_number=str(e + 1),
                     exon_id=f"{t}.{e}", gene_name=name)
            gtf.append(f"{chrom}\tt\texon\t{a}\t{b}\t.\t{strand}\t.\t{ea}")
            if k % 2 == 0:
                gtf.append(f"{chrom}\tt\tCDS\t{a + 5}\t{b}\t2.5\t{strand}\t"
                           f"{e}\t{ea}")
    sam = ["@SQ\tSN:chr1\tLN:3000", "@SQ\tSN:chr2\tLN:1000"]
    for i, (bx, pos) in enumerate([("AA", 120), ("AA", 950), ("CC", 130),
                                   ("CC", 2500), ("GG", 1750)]):
        sam.append(f"r{i}_BX:{bx}_UMI:U{i}\t0\tchr1\t{pos}\t60\t20M\t*\t0\t"
                   f"0\t{'A' * 20}\t*")
    base = rng.choice(list("ACGT"), 240)
    rows = []
    for k in range(4):
        r = base.copy()
        sub = rng.random(240) < 0.05 * (k + 1)
        r[sub] = rng.choice(list("ACGT"), int(sub.sum()))
        r[30 + 40 * k:34 + 40 * k] = "-"
        rows.append("".join(r))
    files = {
        "g.gtf": gtf, "g.sizes": ["chr1\t3000", "chr2\t1000", "chrU\t500"],
        "names.txt": ["N0", "N3", "N0"], "table.tsv": ["G0\tsym0", "G3\tsym3"],
        "ids.txt": ["chr1\t1\t2\tG0", "chr1\t3\t4\tG1",
                    "chr2\t5\t6\tG3\tG0"],
        "bx.sam": sam, "norm.tsv": ["G1\t2.5"],
        "t_q.chain": ["chain 1 chr1 3000 + 0 3000 q1 3010 + 0 3010 1",
                      "1000\t0\t10", "2000", "",
                      "chain 1 chr2 1000 + 0 1000 q2 1000 - 0 1000 2",
                      "1000", ""],
        "a.fa": [x for nm, r in zip(("hum", "chimp", "gor", "orang"), rows)
                 for x in (f">{nm}", r)],
        "r.bed": ["chr2\t10\t60", "chr2\t100\t150", "chr2\t150\t200"]}
    for name, lines in files.items():
        (d / name).write_text("".join(ln + "\n" for ln in lines))
    return {k: str(d / k) for k in files}


@pytest.mark.parametrize("tool", [
    "gtfTools_filter", "gtfTools_toBed", "gtfTools_tss", "getPromoter",
    "geneIdToName", "scCount", "quickOrthologs", "multiFaAcceleration",
    "branchLengthsMultiFaBed"])
def test_umbrella_gtf_accel_tools_equal_jax_umbrella(
        gtf_accel_inputs, tmp_path, capsys, tool):
    """Each GTF and acceleration tool of slice 11.11b through
    gonomics-torch writes what the JAX umbrella's writes, files and
    stdout."""
    f = gtf_accel_inputs
    out = {}
    for side, mod in (("jax", jmain), ("port", umbrella)):
        d = tmp_path / side
        d.mkdir()
        o = str(d / "out")
        argv = {
            "gtfTools_filter": ["gtfTools", "filter", f["g.gtf"], o,
                                "-geneNameList", f["names.txt"],
                                "-chromFilter", "chr2"],
            "gtfTools_toBed": ["gtfTools", "toBed", f["g.gtf"], o],
            "gtfTools_tss": ["gtfTools", "toBed", f["g.gtf"], o, "-tss",
                             "-chromSizeFile", f["g.sizes"], "-merge"],
            "getPromoter": ["getPromoter", f["names.txt"], f["g.gtf"], o,
                            f["g.sizes"], "-upstream", "150"],
            "geneIdToName": ["geneIdToName", f["table.tsv"], f["ids.txt"], o,
                             "-keepMatching"],
            "scCount": ["scCount", f["bx.sam"], f["g.gtf"], o,
                        "-expNormalizationFile", f["norm.tsv"]],
            "quickOrthologs": ["quickOrthologs", "--canonicalTranscript", "t",
                               "q", f["g.gtf"], f["t_q.chain"], f["g.sizes"],
                               o, o + ".un"],
            "multiFaAcceleration": ["multiFaAcceleration", "chr2", f["a.fa"],
                                    o, o + ".acc", o + ".init",
                                    "-windowSize", "30"],
            "branchLengthsMultiFaBed": ["branchLengthsMultiFaBed", "chr2",
                                        f["a.fa"], f["r.bed"], o, o + ".init",
                                        o + ".ung", "-qOutFile", o + ".q",
                                        "-useSnpDistance"]}[tool]
        mod.main(argv)
        files = {n: _read(str(d / n)) for n in sorted(os.listdir(d))}
        out[side] = (files, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert all(out["jax"][0].values())


@pytest.fixture(scope="module")
def sim_tree_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim_tree_umbrella")
    rng = np.random.default_rng(3201)
    seqs = {"chr1": rng.choice(list("ACGTacgt"), 3000),
            "chr2": rng.choice(list("ACGT"), 1200)}
    clean = [x for k, v in seqs.items() for x in (f">{k}", "".join(v))]
    seqs["chr1"][700:760] = "N"
    seqs["chr2"][400:430] = "N"
    ng = [("chr1", 0, 700), ("chr1", 760, 3000), ("chr2", 0, 400),
          ("chr2", 430, 1200)]
    files = {
        "ref.fa": [x for k, v in seqs.items() for x in (f">{k}", "".join(v))],
        "clean.fa": clean,
        "ng.bed": [f"{c}\t{s}\t{e}\tr{i}" for i, (c, s, e) in enumerate(ng)],
        "tree.dot": ["digraph G {", "R -> A -> C;", "R -> B;", "A -> D;",
                     "B -> E;", "B -> F;", "}"],
        "tree.nh": ["((h:0.1,c:0.2)hc:0.05,(g:0.3,o:0.25)go:0.1)r;"]}
    for name, lines in files.items():
        (d / name).write_text("".join(ln + "\n" for ln in lines))
    return {k: str(d / k) for k in files}


@pytest.mark.parametrize("tool", [
    "simulateSam", "simulateSam_bam", "simulateBed", "simulateVcf",
    "simulateVcf_ref", "simulateDivergentWindowsVcf", "simulatePcr",
    "dotToNewick", "drawNewickTree"])
def test_umbrella_sim_tree_tools_equal_jax_umbrella(
        sim_tree_inputs, tmp_path, capsys, tool):
    """Each simulation and tree tool of slice 12a through gonomics-torch
    writes what the JAX umbrella's writes, files and stdout (the PNG as
    its bytes)."""
    f = sim_tree_inputs
    out = {}
    for side, mod in (("jax", jmain), ("port", umbrella)):
        d = tmp_path / side
        d.mkdir()
        o = str(d / "out")
        argv = {
            "simulateSam": ["simulateSam", f["clean.fa"], o + ".sam", "-n",
                            "40", "-flatErrorRate", "0.02",
                            "-ancientErrorRate", "0.05",
                            "-deaminationDistribution", o + ".d"],
            "simulateSam_bam": ["simulateSam", f["ref.fa"], o + ".bam",
                                "-coverage", "1", "-setSeed", "5"],
            "simulateBed": ["simulateBed", f["ng.bed"], o, "-N", "30", "-L",
                            "200", "-setSeed", "4"],
            "simulateVcf": ["simulateVcf", o, "-numSites", "4",
                            "-numAlleles", "9", "-alpha", "2",
                            "-setSeed", "3"],
            "simulateVcf_ref": ["simulateVcf", o, "-numSites", "4",
                                "-refFile", f["ref.fa"], "-setSeed", "3"],
            "simulateDivergentWindowsVcf": [
                "simulateDivergentWindowsVcf", o + ".lo", o + ".up",
                "-numTotalSites", "6", "-numWindowSites", "3",
                "-numWindows", "4", "-setSeed", "2", "-lowerPercentile",
                "0.25", "-upperPercentile", "0.75"],
            "simulatePcr": ["simulatePcr", "-p", "ACG", "-p", "TTA", "-t",
                            f["ref.fa"], "-bed", o + ".bed", "-fastq",
                            o + ".fq", "-maxProductSize", "400"],
            "dotToNewick": ["dotToNewick", f["tree.dot"], o],
            "drawNewickTree": ["drawNewickTree", "-imgWidth", "600",
                               "-imgHeight", "80", f["tree.nh"],
                               o + ".png"]}[tool]
        mod.main(argv)
        files = {n: _read(str(d / n)) for n in sorted(os.listdir(d))}
        out[side] = (files, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert all(out["jax"][0].values())


def test_only_draw_newick_tree_needs_pil(sim_tree_inputs, tmp_path):
    """With PIL blocked from import, ``help`` lists all the tools and
    dotToNewick and simulateBed run; drawNewickTree and faDrawAlnChunks
    alone fail, on their import of PIL."""
    f = sim_tree_inputs
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "from gonomics_tpu_torch.cli import main as m\n"
        "m.main(['help'])\n"
        f"m.main(['dotToNewick', {f['tree.dot']!r}, {str(tmp_path / 'o.nh')!r}])\n"
        f"m.main(['simulateBed', {f['ng.bed']!r}, {str(tmp_path / 'o.bed')!r},"
        " '-N', '5', '-L', '50', '-setSeed', '1'])\n"
        "try:\n"
        f"    m.main(['drawNewickTree', {f['tree.nh']!r},"
        f" {str(tmp_path / 'o.png')!r}])\n"
        "except ImportError as e:\n"
        "    print('drawNewickTree:', type(e).__name__, e.name)\n"
        "try:\n"
        f"    m.main(['faDrawAlnChunks', {f['tree.nh']!r}, '3',"
        f" {str(tmp_path / 'c.png')!r}])\n"
        "except ImportError as e:\n"
        "    print('faDrawAlnChunks:', type(e).__name__, e.name)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    listed = [ln.split()[0] for ln in out.stdout.splitlines()[2:]
              if ln.startswith("  ")]
    assert listed == PORTED
    assert out.stdout.splitlines()[-2:] == [
        "drawNewickTree: ModuleNotFoundError PIL",
        "faDrawAlnChunks: ModuleNotFoundError PIL"]
    assert (tmp_path / "o.nh").read_text().endswith(";\n")
    assert len((tmp_path / "o.bed").read_text().splitlines()) == 5
    assert not (tmp_path / "o.png").exists()
    assert not (tmp_path / "c.png").exists()


@pytest.fixture(scope="module")
def sim_evol_inputs(tmp_path_factory):
    """A 300-base root with a start codon at 30, a two-exon genePred, a
    three-leaf tree, a 200-base withIndels input and two ILS topologies
    (.pfa rows on a grid of 1/8, wig weights of 1/4 and 3/4)."""
    from gonomics_tpu_torch.io import pfasta

    d = tmp_path_factory.mktemp("sim_evol_umbrella")
    rng = np.random.default_rng(3302)
    root = rng.choice(list("ACGT"), 300)
    root[30:33] = list("ATG")
    files = {
        "root.fa": [">root", "".join(root)],
        "in.fa": [">chrI", "".join(rng.choice(list("ACGT"), 200))],
        "gene.gp": ["g	chr1	+	0	300	30	269	2	30,150,	121,269,	"
                    "0,2,"],
        "tree.nh": ["((a:0.1,b:0.2)ab:0.05,c:0.3)root;"],
        "chrom.sizes": ["t0\t60", "t1\t60"],
        "post.list": [str(d / "t0.wig"), str(d / "t1.wig")],
        "recons.list": [str(d / "t0.pfa"), str(d / "t1.pfa")]}
    for k, w in enumerate((0.25, 0.75)):
        files[f"t{k}.wig"] = [f"fixedStep chrom=t{k} start=1 step=1"] + [
            str(w)] * 60
        counts = rng.multinomial(8, np.ones(4) / 4, 60)
        pfasta.write(str(d / f"t{k}.pfa"), [pfasta.PFasta(
            f"t{k}", (counts / 8).astype(np.float32))])
    for name, lines in files.items():
        (d / name).write_text("".join(ln + "\n" for ln in lines))
    return {k: str(d / k) for k in [*files, "t0.pfa", "t1.pfa"]}


@pytest.mark.parametrize("tool", [
    "simulateEvol_genic", "simulateEvol_withIndels", "simulateEvol_nonCoding",
    "simRecon", "ilsReconstructSeq"])
def test_umbrella_sim_evol_tools_equal_jax_umbrella(
        sim_evol_inputs, tmp_path, capsys, tool):
    """Each command of slice 12b through gonomics-torch writes what the
    JAX umbrella's writes, files and stdout."""
    f = sim_evol_inputs
    out = {}
    for side, mod in (("jax", jmain), ("port", umbrella)):
        d = tmp_path / side
        d.mkdir()
        o = str(d / "out")
        argv = {
            "simulateEvol_genic": [
                "simulateEvol", "genic", "--setSeed", "4",
                "--completeSimOutput", o + ".all.fa", "--genePred",
                f["gene.gp"], f["tree.nh"], f["root.fa"], o + ".fa"],
            "simulateEvol_withIndels": [
                "simulateEvol", "withIndels", "--propIndel", "0.4",
                "--branchLength", "0.2", "--transitionBias", "3",
                "--setSeed", "6", "--vcfOutFile", o + ".vcf", f["in.fa"],
                o + ".fa"],
            "simulateEvol_nonCoding": [
                "simulateEvol", "nonCoding", "--numNodes", "9", "--lenSeq",
                "80", "--setSeed", "2", "--newickOut", o + ".nh",
                o + ".fa"],
            "simRecon": [
                "simRecon", "--baseAccFile", o + ".base", f["root.fa"],
                f["tree.nh"], f["gene.gp"], o + ".sim.fa", o + ".leaf.fa",
                o + ".recon.fa", o + ".acc"],
            "ilsReconstructSeq": [
                "ilsReconstructSeq", f["post.list"], f["recons.list"],
                f["chrom.sizes"], o + ".pfa"]}[tool]
        mod.main(argv)
        files = {n: _read(str(d / n)) for n in sorted(os.listdir(d))}
        out[side] = (files, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert out["jax"][0] and all(out["jax"][0].values())


@pytest.fixture(scope="module")
def onto_straw_inputs(tmp_path_factory):
    """An OBO, two GAFs, TSS beds, a GTF, chrom sizes, contacts and
    queries (tests/test_torch_ontology.py's builders), and a straw map on
    chr1 with its file list (tests/test_torch_straw.py's)."""
    d = tmp_path_factory.mktemp("onto_straw_umbrella")
    obo = obo_lines()
    ids = [ln[4:] for ln in obo if ln.startswith("id: GO:")][:-1]
    tss = tss_lines()
    files = {"in.obo": obo, "a.gaf": gaf_lines(ids),
             "b.gaf": gaf_lines(ids, seed=3407, n=40), "tss.bed": tss,
             "genes.gtf": gtf_lines(),
             "chrom.sizes": ["chr1\t6000", "chr2\t3000"],
             "contacts.bedpe": contact_lines(tss),
             "queries.bed": query_lines(), "chr1.straw": straw_lines(),
             "gafs.txt": [str(d / "a.gaf"), str(d / "b.gaf")],
             "straw.list": [f"{d / 'chr1.straw'}\tchr1"]}
    for name, lines in files.items():
        (d / name).write_text("".join(ln + "\n" for ln in lines))
    return {k: str(d / k) for k in files}


@pytest.mark.parametrize("tool", [
    "oboTools", "gafFilter", "ontologyEnrichment", "oboToDot",
    "ontologyHistogram", "assignGenomeSpace", "strawToBedpe"])
def test_umbrella_onto_straw_tools_equal_jax_umbrella(
        onto_straw_inputs, tmp_path, capsys, tool):
    """Each tool of item 13 and strawToBedpe through gonomics-torch writes
    what the JAX umbrella's writes, files and stdout."""
    f = onto_straw_inputs
    out = {}
    for side, mod in (("jax", jmain), ("port", umbrella)):
        d = tmp_path / side
        d.mkdir()
        o = str(d / "out")
        argv = {
            "oboTools": ["oboTools", "mapping", f["in.obo"], o + ".tsv"],
            "gafFilter": ["gafFilter", f["a.gaf"], o + ".gaf", "-removeNot"],
            "ontologyEnrichment": [
                "ontologyEnrichment", f["queries.bed"], f["chrom.sizes"],
                f["genes.gtf"], f["a.gaf"], f["in.obo"], o + ".bed",
                "-contactFile", f["contacts.bedpe"]],
            "oboToDot": ["oboToDot", f["in.obo"], "GO:9000002", o + ".dot"],
            "ontologyHistogram": ["ontologyHistogram", f["in.obo"],
                                  f["gafs.txt"], o + ".tsv"],
            "assignGenomeSpace": [
                "assignGenomeSpace", "--geneBed", "--proximity",
                o + ".1d.bed", "--contactFile", f["contacts.bedpe"],
                "--nearestGeneBed", o + ".3d.bed", f["tss.bed"],
                f["chrom.sizes"]],
            "strawToBedpe": [
                "strawToBedpe", f["straw.list"], o + ".bedpe", "-binSize",
                "1000", "-rStep", "0.01", "-pStep", "0.01", "-fitStatsFile",
                o + ".fit", "-contactScoreFile", o + ".scores"]}[tool]
        mod.main(argv)
        files = {n: _read(str(d / n)) for n in sorted(os.listdir(d))}
        out[side] = (files, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert out["jax"][0] and all(out["jax"][0].values())


@pytest.fixture(scope="module")
def sim_view_inputs(tmp_path_factory):
    """A variant graph of 600 seeded bases with a SNP every 50; a
    two-row multiFa alignment with gaps and a bed of two of its regions;
    four records of 10-base chunks and a chunk alignment of 3-base
    chunks; a lastZ pairwise tree (tests/test_torch_lastz_misc.py's
    ``layout``); a bed with scores; a fancy job-array file."""
    from gonomics_tpu import graph as jgraph
    from gonomics_tpu.io.fasta import Fasta as JFasta
    from gonomics_tpu.io.vcf import Vcf as JVcf
    from test_torch_lastz_misc import layout
    from test_torch_sim_views import _chunk_records

    d = tmp_path_factory.mktemp("sim_view_umbrella")
    rng = np.random.default_rng(3605)
    ref = rng.integers(0, 4, 600).astype(np.int8)
    vcfs = [JVcf(chrom="chr1", pos=p, id=".", ref="ACGT"[ref[p - 1]],
                 alt=["ACGT"[(ref[p - 1] + 1) % 4]], info="SVTYPE=SNP")
            for p in range(30, 580, 50)]
    jgraph.write(str(d / "g.gg"),
                 jgraph.variant_graph([JFasta("chr1", ref)], {"chr1": vcfs}))
    t_row = "".join("ACGT"[i] for i in ref[:300])
    t_row = t_row[:100] + "---" + t_row[100:]
    q_row = t_row[:50] + "T" + t_row[51:200] + "--" + t_row[202:]
    layout(str(d))
    files = {
        "aln.fa": [">ref", t_row, ">qry", q_row],
        "r.bed": ["ref\t10\t90\ta", "ref\t150\t260\tb"],
        "chunks.fa": [x for n, s in _chunk_records(3606, 4, 10, 10)
                      for x in (">" + n, s)],
        "chunk_aln.fa": [">s1", "ACGTAA---CCC", ">s2", "ACG---TTTCCC"],
        "ideo.bed": ["chr1\t10\t21\tx\t5", "chr2\t40\t80\ty\t900"],
        "slurm.txt": ["sbatch a.sh {check 1 line+ out.txt} --x 3",
                      "sbatch b.sh {check 2 exists out2.txt} --x 4"]}
    for name, lines in files.items():
        (d / name).write_text("".join(ln + "\n" for ln in lines))
    return {k: str(d / k) for k in [*files, "g.gg", "pairwise",
                                    "species.txt", "refs.txt", "dists.txt"]}


@pytest.mark.parametrize("tool", [
    "girafSimulate", "multFaVisualizer", "multFaVisualizeBeds",
    "faChunkAlign", "faDrawAlnChunks", "lastZWriter", "formatIdeogram",
    "slurmCheck"])
def test_umbrella_sim_view_tools_equal_jax_umbrella(
        sim_view_inputs, tmp_path, capsys, tool):
    """Each tool of slices 14b and 15a through gonomics-torch writes what
    the JAX umbrella's writes, files and stdout."""
    f = sim_view_inputs
    out = {}
    for side, mod in (("jax", jmain), ("port", umbrella)):
        d = tmp_path / side
        d.mkdir()
        o = str(d / "out")
        argv = {
            "girafSimulate": [
                "girafSimulate", f["g.gg"], o + ".giraf", "-numReads", "25",
                "-readLen", "80", "-seed", "9", "-somaticSNV", "4",
                "-somaticAF", "0.6"],
            "multFaVisualizer": [
                "multFaVisualizer", f["aln.fa"], o + ".txt", "20", "END",
                "-lineLength", "70"],
            "multFaVisualizeBeds": [
                "multFaVisualizeBeds", f["r.bed"], f["aln.fa"], "-outDir",
                str(d) + "/", "-outFormatName"],
            "faChunkAlign": ["faChunkAlign", f["chunks.fa"], "10", o + ".fa"],
            "faDrawAlnChunks": ["faDrawAlnChunks", f["chunk_aln.fa"], "3",
                                o + ".png"],
            "lastZWriter": [
                "lastZWriter", "-m", "true", "lastz", f["pairwise"],
                f["species.txt"], f["refs.txt"], f["dists.txt"],
                o + ".jobs"],
            "formatIdeogram": ["formatIdeogram", f["ideo.bed"], o + ".txt"],
            "slurmCheck": ["slurmCheck", f["slurm.txt"]]}[tool]
        mod.main(argv)
        files = {n: _read(str(d / n)) for n in sorted(os.listdir(d))}
        out[side] = (files, capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert (out["jax"][0] and all(out["jax"][0].values())) or out["jax"][1]
