"""gonomics-torch: the port's umbrella command, the counterpart of
``gonomics_tpu/cli/main.py`` (``main``, :300-316) for the tools the port
has.

    gonomics-torch <tool> [args...]
    python -m gonomics_tpu_torch.cli.main <tool> [args...]

``gonomics-torch`` alone, or with ``help``, lists the tools. Each tool
keeps its name in the JAX package's ``COMMANDS`` and is imported only
when it is dispatched, so listing them starts no CUDA. A target is a
module, whose ``main`` runs, or ``module:function``, as in the JAX
umbrella (:310-313).
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "globalAlignment": ("gonomics_tpu_torch.cli.global_alignment",
                        "Align 2 single-record fasta files (card kernels)"),
    "cigarToBed": ("gonomics_tpu_torch.cli.cigar_to_bed",
                   "Affine-gap align two fastas, emit indel beds (card "
                   "kernels)"),
    "gsw": ("gonomics_tpu_torch.cli.gsw_cmd",
            "Graph-Smith-Waterman read aligner (host or card engine) and "
            "genome-graph tools (ggtools)"),
    "callVariants": ("gonomics_tpu_torch.cli.call_variants",
                     "Joint variant caller over experimental+normal samples "
                     "(host count; the card's with --mesh)"),
    "pileup": ("gonomics_tpu_torch.cli.pileup_cmd",
               "Count bases from sequencing data (host)"),
    "samConsensus": ("gonomics_tpu_torch.cli.sam_consensus",
                     "Consensus fasta from a sam/bam over a reference "
                     "(host)"),
    "samToBed": ("gonomics_tpu_torch.cli.sam_to_bed",
                 "Aligned read positions as bed records (host)"),
    "faFormat": ("gonomics_tpu_torch.cli.fa_format",
                 "Reformat fasta records (host)"),
    "bedMerge": ("gonomics_tpu_torch.cli.bed_merge",
                 "Combine overlapping bed entries (host)"),
    "bedToWig": ("gonomics_tpu_torch.cli.bed_to_wig",
                 "Convert bed values to wig (host)"),
    "intervalOverlap": ("gonomics_tpu_torch.cli.interval_overlap",
                        "Find non/overlapping genomic regions (host)"),
    "mergesort": ("gonomics_tpu_torch.cli.mergesort",
                  "External merge sort of genomic records (host)"),
    "faFindFast": ("gonomics_tpu_torch.cli.fa_find_fast",
                   "Sliding-window divergence between two sequences "
                   "(host)"),
    "faFilter": ("gonomics_tpu_torch.cli.fa_filter",
                 "Filter fasta records by name/size/GC/range (host)"),
    "gcContent": ("gonomics_tpu_torch.cli.gc_content",
                  "GC content of fasta sequence over bed regions (host)"),
    "faInfo": ("gonomics_tpu_torch.cli.fa_info",
               "Per-record fasta base counts (host)"),
    "faUniq": ("gonomics_tpu_torch.cli.fa_uniq",
               "Pull unique sequences from a fasta (host)"),
    "faBin": ("gonomics_tpu_torch.cli.fa_bin",
              "Bin fasta records into grouped files (host)"),
    "catMultiFa": ("gonomics_tpu_torch.cli.cat_multi_fa",
                   "Concatenate multiFa alignments by sequence (host)"),
    "assemblyStats": ("gonomics_tpu_torch.cli.assembly_stats",
                      "Scaffold/contig N50 statistics (host)"),
    "locateCG": ("gonomics_tpu_torch.cli.locate_cg",
                 "Locate/compare CpG sites (host)"),
    "countPairOfBases": ("gonomics_tpu_torch.cli.count_pair_of_bases",
                         "Count base pairs in sequences or bed regions "
                         "(host)"),
    "digestGenome": ("gonomics_tpu_torch.cli.digest_genome",
                     "Restriction-fragment bed from fasta + motif (host)"),
    "faToPredictSet": ("gonomics_tpu_torch.cli.fa_to_predict_set",
                       "Sliding-window prediction TSVs for deep learning "
                       "(host)"),
    "prcompFormat": ("gonomics_tpu_torch.cli.prcomp_format",
                     "Binary one-hot matrix of variable columns for PCA "
                     "(host)"),
    "findAndReplace": ("gonomics_tpu_torch.cli.find_and_replace",
                       "Find values in a file and replace them (host)"),
    "bedToFasta": ("gonomics_tpu_torch.cli.bed_to_fasta",
                   "Extract fasta subsequences for bed regions (host)"),
    "bedToAminoAcid": ("gonomics_tpu_torch.cli.bed_to_amino_acid",
                       "Translate bed-region DNA to amino acids (host)"),
    "reconstructSeq": ("gonomics_tpu_torch.cli.reconstruct_seq",
                       "Ancestral sequence reconstruction (host)"),
    "primateRecon": ("gonomics_tpu_torch.cli.primate_recon",
                     "[DEPRECATED] HBCGO primate ancestor estimation "
                     "(host)"),
    "mouseRecon": ("gonomics_tpu_torch.cli.mouse_recon",
                   "[DEPRECATED] Mouse-Rat-Hamster-Squirrel ancestor MLE "
                   "(host)"),
    "vcfFormat": ("gonomics_tpu_torch.cli.vcf_format",
                  "Options alter VCF formatting (host)"),
    "vcfToFa": ("gonomics_tpu_torch.cli.vcf_to_fa",
                "Edit a reference fasta with vcf variant data (host)"),
    "vcfFilter": ("gonomics_tpu_torch.cli.vcf_filter",
                  "Filter vcf records (host)"),
    "vcfInfo": ("gonomics_tpu_torch.cli.vcf_info",
                "VCF summary statistics (types/divergence/context) (host)"),
    "multiFaToVcf": ("gonomics_tpu_torch.cli.multi_fa_to_vcf",
                     "VCF from a pairwise multiFa alignment (host)"),
    "bedFormat": ("gonomics_tpu_torch.cli.bed_format",
                  "Options alter bed formatting (host)"),
    "bedFilter": ("gonomics_tpu_torch.cli.bed_filter",
                  "Filter bed records by score/length/position/name "
                  "(host)"),
    "bedMath": ("gonomics_tpu_torch.cli.bed_math",
                "Arithmetic on float values in bed files (host)"),
    "bedSplit": ("gonomics_tpu_torch.cli.bed_split",
                 "Partition a bed by name or chrom (host)"),
    "bedShear": ("gonomics_tpu_torch.cli.bed_shear",
                 "Split bed entries into fragments (host)"),
    "bedSimilarity": ("gonomics_tpu_torch.cli.bed_similarity",
                      "Overlap-proportion statistics between bed files "
                      "(host)"),
    "bedOverlapByWindow": ("gonomics_tpu_torch.cli.bed_overlap_by_window",
                           "Count bp in bed regions per window (host)"),
    "bedDistanceFromChrEnds": (
        "gonomics_tpu_torch.cli.bed_distance_from_chr_ends",
        "Score = min distance to chromosome end (host)"),
    "bedMinimumDistanceName": (
        "gonomics_tpu_torch.cli.bed_minimum_distance_name",
        "Min distance between name-matched beds (host)"),
    "bedTrim": ("gonomics_tpu_torch.cli.bed_trim",
                "Trim bed records by N percent, split across both sides "
                "(host)"),
    "bedValueWig": ("gonomics_tpu_torch.cli.bed_value_wig",
                    "Annotate beds with wig max/min/average (host)"),
    "bedGraphToWig": ("gonomics_tpu_torch.cli.bed_graph_to_wig",
                      "Convert bedGraph to wig (host)"),
    "multiFaCount": ("gonomics_tpu_torch.cli.multi_fa_count",
                     "Count present bases in multiFa sequences (host)"),
    "multiFaExtract": ("gonomics_tpu_torch.cli.multi_fa_extract",
                       "Pull sub-sequence from a multiFa alignment (host)"),
    "multiFaReduce": ("gonomics_tpu_torch.cli.multi_fa_reduce",
                      "Keep only variable multiFa columns (host)"),
    "mergeMultiFa": ("gonomics_tpu_torch.cli.merge_multi_fa",
                     "Merge two multiFa files on a shared reference "
                     "(host)"),
    "multiFaSequenceSwap": ("gonomics_tpu_torch.cli.multi_fa_sequence_swap",
                            "Swap bed regions between multiFa sequences "
                            "(host)"),
    "multiFaScan": ("gonomics_tpu_torch.cli.multi_fa_scan",
                    "Bed spans of N bases in a multiFa sequence (host)"),
    "multiFaToChain": ("gonomics_tpu_torch.cli.multi_fa_to_chain",
                       "Pairwise multiFa alignment to UCSC chain (host)"),
    "fastqFilter": ("gonomics_tpu_torch.cli.fastq_filter",
                    "Filter fastq records by size/name/UMI/cell (host)"),
    "fastqFormat": ("gonomics_tpu_torch.cli.fastq_format",
                    "10x single-cell renaming of paired fastq reads "
                    "(host)"),
    "fastqReplaceSeq": ("gonomics_tpu_torch.cli.fastq_replace_seq",
                        "Replace fastq read prefixes by a find/replace "
                        "table (host)"),
    "longReadLibStats": ("gonomics_tpu_torch.cli.long_read_lib_stats",
                         "Read count and N50 of a long-read fastq (host)"),
    "samInfo": ("gonomics_tpu_torch.cli.sam_info",
                "Read-length, coverage and MAPQ histograms of a sam/bam "
                "(host)"),
    "samToWig": ("gonomics_tpu_torch.cli.sam_to_wig",
                 "Read coverage of a sam/bam as wig (host)"),
    "bedCountBam": ("gonomics_tpu_torch.cli.bed_count_bam",
                    "Read counts in bed regions of an indexed bam (host)"),
    "bamTagToReadGroup": ("gonomics_tpu_torch.cli.bam_tag_to_read_group",
                          "Bam read groups from a tag's values (host)"),
    "wigTools": ("gonomics_tpu_torch.cli.wig_tools",
                 "Wig filter/peaks/math/stats/toTrainingSet (host)"),
    "randSeq": ("gonomics_tpu_torch.cli.rand_seq",
                "Generate pseudorandom DNA fasta (host)"),
    "statCalc": ("gonomics_tpu_torch.cli.stat_calc",
                 "Command line statistics calculator (host)"),
    "plotFunctions": ("gonomics_tpu_torch.cli.plot_functions",
                      "Tab-separated function evaluations for plotting "
                      "(host)"),
    "selectionMle": ("gonomics_tpu_torch.cli.popgen_tools:main_mle",
                     "MLE of selection from a VCF AFS (host)"),
    "selectionMcmc": ("gonomics_tpu_torch.cli.popgen_tools:main_mcmc",
                      "MCMC posterior for selection parameters (host)"),
    "dunnIndex": ("gonomics_tpu_torch.cli.popgen_tools:main_dunn",
                  "Dunn index per bed region of a multiFa (host)"),
    "mcmcTraceStats": (
        "gonomics_tpu_torch.cli.popgen_tools:main_trace_stats",
        "Summary statistics on an MCMC trace (host)"),
    "simulateWrightFisher": (
        "gonomics_tpu_torch.cli.popgen_tools:main_wright_fisher",
        "Multiallelic Wright-Fisher simulation (host)"),
    "bedpeFilter": ("gonomics_tpu_torch.cli.bedpe_filter",
                    "Filter bedpe contacts by score/distance/position/"
                    "chrom (host)"),
    "bedpeOverlap": ("gonomics_tpu_torch.cli.bedpe_overlap",
                     "Filter bedpe contacts by overlap with a select file "
                     "(host)"),
    "intervalContacts": ("gonomics_tpu_torch.cli.interval_contacts",
                         "Regions contacting an interval set via bedpe "
                         "links (host)"),
    "intervalSubsetMatrix": ("gonomics_tpu_torch.cli.interval_subset_matrix",
                             "Binary/fraction overlap matrix of interval "
                             "files over union regions (host)"),
    "geneAssignmentStats": ("gonomics_tpu_torch.cli.gene_assignment_stats",
                            "Truth bedpe gene assignments against a test "
                            "bed (host)"),
    "overlapEnrichments": ("gonomics_tpu_torch.cli.overlap_enrichments",
                           "Enrichment/depletion p-values of element "
                           "overlaps (host)"),
    "liftCoordinates": ("gonomics_tpu_torch.cli.lift_coordinates",
                        "Lift bed/vcf coordinates through a chain (host)"),
    "divergenceSpectrum": ("gonomics_tpu_torch.cli.divergence_spectrum",
                           "Six-class substitution spectrum per bed region "
                           "(host)"),
    "sampleVcf": ("gonomics_tpu_torch.cli.vcf_sampling:main_sample",
                  "Random sample of VCF variants/samples (host)"),
    "proximityBlockVcf": ("gonomics_tpu_torch.cli.vcf_sampling:main_proximity",
                          "Distance-blocked variant sampling (host)"),
    "filterGenotypes": (
        "gonomics_tpu_torch.cli.vcf_sampling:main_filter_genotypes",
        "Allele-specific genotype filter / sample subsetting (host)"),
    "vcfAncestorAnnotation": (
        "gonomics_tpu_torch.cli.vcf_sampling:main_ancestor",
        "Add ancestral alleles to VCF INFO (host)"),
    "vcfAfs": ("gonomics_tpu_torch.cli.vcf_sampling:main_afs",
               "Allele frequency spectrum from a VCF (host)"),
    "haplotypeGenerator": (
        "gonomics_tpu_torch.cli.vcf_sampling:main_haplotype",
        "Per-sample haplotype fastas for regions (host)"),
    "alleleSplit": ("gonomics_tpu_torch.cli.allele_split",
                    "Split F1-hybrid SAM reads by parental allele (host)"),
    "mafFilter": ("gonomics_tpu_torch.cli.maf_tools:main_filter",
                  "Filter maf blocks by score threshold (host)"),
    "mafToBed": ("gonomics_tpu_torch.cli.maf_tools:main_to_bed",
                 "Maf blocks to reference-species bed (host)"),
    "mafToMultiFa": ("gonomics_tpu_torch.cli.maf_tools:main_to_multi_fa",
                     "Maf alignment to multi-fasta (host)"),
    "mafIndels": ("gonomics_tpu_torch.cli.maf_tools:main_indels",
                  "Insertions/deletions from pairwise maf e-lines (host)"),
    "axTools": ("gonomics_tpu_torch.cli.ax_tools",
                "Axt utilities: stats/filter/consensus/swap (host)"),
    "axtSam": ("gonomics_tpu_torch.cli.axt_sam",
               "Convert axt alignments to sam (host)"),
    "gtfTools": ("gonomics_tpu_torch.cli.gtf_tools",
                 "GTF filter/toBed subcommands (host)"),
    "getPromoter": ("gonomics_tpu_torch.cli.get_promoter",
                    "Promoter beds for a gene list (host)"),
    "geneIdToName": ("gonomics_tpu_torch.cli.gene_id_to_name",
                     "Replace gene IDs with names via a table (host)"),
    "scCount": ("gonomics_tpu_torch.cli.sc_count",
                "Count matrix from single-cell sequencing data (host)"),
    "quickOrthologs": ("gonomics_tpu_torch.cli.quick_orthologs",
                       "Orthologous TSS positions via liftover chains "
                       "(host)"),
    "multiFaAcceleration": ("gonomics_tpu_torch.cli.multi_fa_acceleration",
                            "Windowed velocity/acceleration scores of a "
                            "four-way multiFa (host)"),
    "branchLengthsMultiFaBed": (
        "gonomics_tpu_torch.cli.branch_lengths_multi_fa_bed",
        "Fitch-Margoliash branch lengths per bed region (host)"),
    "simulateSam": ("gonomics_tpu_torch.cli.simulate_sam",
                    "Simulate Illumina paired reads from a reference "
                    "(host)"),
    "simulateBed": ("gonomics_tpu_torch.cli.simulate_tools:main_bed",
                    "Random bed regions within a search space (host)"),
    "simulateVcf": ("gonomics_tpu_torch.cli.simulate_tools:main_vcf",
                    "Simulated VCF variants from an AFS (host)"),
    "simulateDivergentWindowsVcf": (
        "gonomics_tpu_torch.cli.simulate_tools:main_divergent_windows",
        "Upper/lower divergence-percentile VCF windows (host)"),
    "simulatePcr": ("gonomics_tpu_torch.cli.simulate_tools:main_pcr",
                    "Predict PCR amplicon products (host)"),
    "dotToNewick": ("gonomics_tpu_torch.cli.dot_to_newick",
                    "Newick tree from a dot-format digraph (host)"),
    "drawNewickTree": ("gonomics_tpu_torch.cli.draw_newick_tree",
                       "Create PNG of a newick tree (host, needs PIL)"),
    "ilsReconstructSeq": ("gonomics_tpu_torch.cli.ils_reconstruct_seq",
                          "ILS-aware weighted ancestral reconstruction "
                          "(host)"),
    "simRecon": ("gonomics_tpu_torch.cli.sim_recon",
                 "Simulate evolution + reconstruct + score accuracy "
                 "(host)"),
    "simulateEvol": ("gonomics_tpu_torch.cli.simulate_evol",
                     "Evolution simulation: genic/withIndels/nonCoding "
                     "(host)"),
    "oboTools": ("gonomics_tpu_torch.cli.ontology_tools:main_obo_tools",
                 "OBO manipulation (mapping subcommand) (host)"),
    "gafFilter": ("gonomics_tpu_torch.cli.ontology_tools:main_gaf_filter",
                  "Filter GAF annotation records (host)"),
    "ontologyEnrichment": (
        "gonomics_tpu_torch.cli.ontology_tools:main_ontology_enrichment",
        "GREAT-style GO-term enrichment over 1D/3D space (host)"),
    "oboToDot": ("gonomics_tpu_torch.cli.obo_to_dot",
                 "Dot-format subtree for a GO term (host)"),
    "ontologyHistogram": ("gonomics_tpu_torch.cli.ontology_histogram",
                          "Gene counts per ontology term from gaf files "
                          "(host)"),
    "assignGenomeSpace": ("gonomics_tpu_torch.cli.assign_genome_space",
                          "Nearest gene per base by proximity/3D contacts "
                          "(host)"),
    "strawToBedpe": ("gonomics_tpu_torch.cli.straw_to_bedpe",
                     "HiC straw contact maps to significant bedpe peaks "
                     "(host)"),
    "sortGraph": ("gonomics_tpu_torch.cli.sort_graph",
                  "Topologically sort genome-graph nodes (host)"),
    "girafCompress": ("gonomics_tpu_torch.cli.giraf_compress",
                      "GIRAF <-> binary GIRAF.FE conversion (host)"),
    "girafSort": ("gonomics_tpu_torch.cli.giraf_sort",
                  "External sort of giraf records by graph topology "
                  "(host)"),
    "pFaTools": ("gonomics_tpu_torch.cli.pfa_tools",
                 "pFasta toolkit: entropy/extract/sample/visualize/convert "
                 "(host)"),
    "pfaFindFast": ("gonomics_tpu_torch.cli.pfa_find_fast",
                    "Sliding-window probabilistic divergence over a pFa "
                    "(host)"),
    "girafSimulate": ("gonomics_tpu_torch.cli.giraf_simulate",
                      "Simulated giraf alignments from a genome graph "
                      "(host)"),
    "multFaVisualizer": ("gonomics_tpu_torch.cli.mult_fa_visualizer",
                         "Human-readable multiFa alignment view (host)"),
    "multFaVisualizeBeds": ("gonomics_tpu_torch.cli.mult_fa_visualize_beds",
                            "Per-bed-region multiFa alignment views (host)"),
    "faChunkAlign": ("gonomics_tpu_torch.cli.fa_chunk_align",
                     "Align sequences by chunks of bases (host)"),
    "faDrawAlnChunks": ("gonomics_tpu_torch.cli.fa_draw_aln_chunks",
                        "Render a chunk alignment to PNG (host)"),
    "lastZWriter": ("gonomics_tpu_torch.cli.last_z_writer",
                    "lastZ pairwise job inputs by contig (host)"),
    "formatIdeogram": ("gonomics_tpu_torch.cli.format_ideogram",
                       "UCSC Genome Graphs ideogram points from a bed "
                       "(host)"),
    "slurmCheck": ("gonomics_tpu_torch.cli.slurm_check",
                   "Check SLURM job-array completion (host)"),
}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("gonomics_tpu_torch — sequence analysis on a CUDA card\n\n"
              "Commands:")
        for name, (_, desc) in sorted(COMMANDS.items()):
            print(f"  {name:18s} {desc}")
        return
    cmd = argv[0]
    if cmd not in COMMANDS:
        raise SystemExit(f"unknown command: {cmd} (run 'gonomics-torch help')")
    mod_name, _, fn_name = COMMANDS[cmd][0].partition(":")
    getattr(importlib.import_module(mod_name), fn_name or "main")(argv[1:])


if __name__ == "__main__":
    main()
