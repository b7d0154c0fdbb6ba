#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gonomics_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. device:  the card's name and power limit (nvidia-smi); builds the CUDA
            kernels and the host library from the checkout's sources.
2. kernels: a full-size batch (4096 reads x 150 bp, 198 bp windows) through
            banded_align_fused, the main path's kernel (the DP kernel's
            fused mode: the DP, best cell, walk and packing in one
            launch), held against the plain banded_align_full on the card
            (exact equality) and timed eagerly (ms) and in a CUDA graph
            (graph_ms), with its plan (lanes a thread, warps a block,
            registers, spills, shared memory). The same for banded_dp (the
            trace mode) and banded_walk_pack at this shape, which the main
            path does not take, in this phase's line only.
3. end_to_end: ReadAligner on a 100 Mbp seeded genome with the sparse
            index (step 8): 4 pipelined batches of 4096 x 150 bp reads;
            checks the mapped and correctly placed fractions, that junk
            stays unmapped, and that the main path launched the kernel its
            plan names (banded_align_fused); then one batch of 64 reads of
            13,000 bp, whose traces do not fit a block's shared memory,
            through the same aligner: mapped, placed, and launching
            banded_dp and banded_walk_pack. Then (line long_read_kernels)
            those two kernels on that batch's own inputs, as the aligner
            gave them: held against their plain versions (the walk from the
            plain DP's trace and best cells), timed, with banded_dp's plan,
            the walk's longest walk (max_steps) and the tiles its kernel
            loads (rounds: the most a read, and in all), counted on the
            plain walk's path; their rows of the kernels line come from
            here. banded_dp's global-codes variant (codes read from
            device memory), forced on that batch, is held against the
            same plain DP and timed. Then one read of 120,000 bp, past
            the staged codes' reach, through the same aligner: mapped,
            placed, its plan the global-codes variant, one launch each of
            banded_dp and banded_walk_pack; (line huge_read) its device
            step on its own inputs held against the plain
            banded_align_full on the card (the plain version timed once)
            and timed.
4. cli:     `gsw align ... --engine tpu -t 4` of the port (the North
            star's command line) on a 10 Mbp genome, single and paired,
            byte-equal to the library path's SAM for the same reads; and
            with --mesh, byte-equal to the runs without it.
5. mesh:    ReadAligner(mesh=make_mesh(data=1)) on that genome: 3
            batches of 4096 x 150 bp reads through the mesh path
            (shard_local_align: local_wavefront over each read's whole
            150 x 198 grid, then gsw_walk_pack's local side), the wall
            split into seeding, device, wait and emit; mapped and placed
            fractions >= 0.99, junk unmapped; the same SAM on a mesh of
            two data slices on the one card; the first 256 reads equal
            the mesh path on device="cpu"; the lines equal to the banded
            path's, counted; K4 and the local walk launched once a batch
            (twice on two slices), no banded kernel.
6. mesh_kernels: local_wavefront (K4) on the mesh phase's first batch
            (4096 x 150 x 198, the warp design at 8 slots a lane) and the
            local walk on K4's own trace, each held against its plain
            version on the card (exact, whole tensors) and timed eagerly
            and in a CUDA graph, with K4's plan, each bound, and the
            walk's longest walk and tiles; the walk's row of the kernels
            line comes from here, and K4's figures join its row there.
7. pairwise_kernels: affine_wavefront and const_wavefront, trace mode at
            128 pairs and score mode at 256 pairs of 1024 x 1024 (the
            kernel trace_diag but for the affine score mode, which is
            affine_score_diag's), each held against its plain PyTorch
            version on the card (exact equality, whole tensors) and timed,
            with its plan (rows a lane, warps a pair, registers, spills)
            and the device memory a call allocates above its inputs;
            plus trace mode on 2 pairs of 20,000 x 300 for each.
8. pairwise: affine_gap_batch and const_gap_batch on 128 related ~1 kb
            pairs: every route consumes both sequences and replays to its
            score, the first 8 pairs equal device="cpu", score mode
            equals trace mode; pairs/s and the wall split into kernel,
            trace copy to the host, and host walk.
9. pairwise_cli: the port's globalAlignment and cigarToBed on the card,
            stdout, -faOut and beds byte-equal to --device cpu.
10. graph:   GraphAligner with the gsw defaults (-i 32 -w 32, humanChimpTwo,
            gap -600) on the variant graph of a 50 Mbp chromosome (a SNP
            every 1 kb, a 1-30 bp deletion or insertion every 10 kb): one
            warm-up batch, then 4 batches of 2048 x 150 bp reads sampled
            along graph paths, pipelined 2 deep; checks the mapped
            fraction, that each read's giraf path lies on the path it was
            sampled from, that junk gets no path, that the first 256 reads' giraf equals
            device="cpu", and that every graph kernel was launched.
11. graph_kernels: 2048 left and 2048 right jobs of the graph phase's
            warm-up waves through local_wavefront, gsw_right_wavefront and
            gsw_walk_pack, each held against its plain PyTorch version on
            the card (exact equality) and timed (the walks also in a
            CUDA graph, with their max_steps and rounds as in phase 2),
            with each DP's launch plan (graph_dp_plan: one warp a job)
            and two bounds, the contract's whole trace and each job's
            own cells; plus both
            DPs on 2 jobs of a 10,300-base window (the warp design) and on
            16 jobs of 600-base read parts (past its reach: the block
            design), each checked to take that plan, exact and timed.
12. graph_cli: the port's `gsw align` on a 1 Mbp .gg, giraf and SAM, single
            and paired, byte-equal to --device cpu.
13. lowmem_kernels: affine_fwd_block, affine_bwd_window and
            lowmem_walk_block at bench.py's lowmem shape (16 pairs of
            16,384 x 16,384, K = 1024), each once on the middle block from
            the checkpoint and walk state the main path gives it, held
            against its plain PyTorch version on the card (exact equality)
            and timed, with its bound itemised; the cluster plans of
            affine_fwd_block (blocks a pair, clusters the card holds at
            once, shared memory a block) and of affine_bwd_window (blocks
            a pair, lanes a thread, warps a block, clusters held at once,
            waves), each as the kernel's own launch has it; and all three
            on the middle block of the 100 kb pair of phase 14 (K = 4096:
            K6 a global scratch a block, K7 a window of 8,832 lanes, the
            walk over K7's trace), exact and timed.
14. lowmem:  affine_gap_lowmem_batch on that batch: cells/s, the wall split
            into forward, backward and host, peak device memory against
            the full trace's; every route consumes both sequences and
            replays to its score, every score equals K2's score mode, the
            first 2 pairs equal the full-trace path, 4 pairs of 2 kb at
            K = 256 equal device="cpu", and a related 100 kb pair through
            the pairwise API (K = 4096) replays and equals K2's score.
15. score_kernels: affine_stream (K8) at bench.py's P = 8 x B = 256
            random pairs of 1024 x 1024, and affine_score_diag through
            wavefront_align_blocked (K9's contract) on 256 related pairs
            padded to 1024 x 1024 at r_rows = 512 and through K2's score
            mode on the 256 pairs of phase 7, each held against its plain
            PyTorch version on the card (exact equality) and timed, with
            each plan (stream_launch_plan, score_diag_launch_plan: rows a
            lane, warps a pair and a block, blocks, registers, spills);
            plus P = 2 with m even and m > n, n = 1, n below one strip
            with odd m, m much wider than n, r_rows not dividing n,
            r_rows + 1 > 1024 lanes, and K2's score mode with fin_b below
            and past n_b + m_b, m < n, n = 0 and one pair of 20,000 rows.
16. score:  bench.py's stage_score_stream: its parity gate (K2, the
            stream, the blocked kernel) against the plain versions on the
            CPU; K2's score mode, the stream and the blocked kernel once
            each on the stream's 2048 pairs, where all three must give the
            same score for every pair, with each call's peak device
            memory and the plans of affine_score_diag; G cells/s of each
            at bench.py's sizes.
17. prefix: ReadAligner(index_sharding="prefix") on phase 3's 100 Mbp
            genome with the dense index (~100 M entries, ~1.2 GB on the
            card), split over 4 data slices of a mesh that repeats the
            card: the mesh phase's 3 batches of 4096 x 150 bp reads, the
            k-mers looked up on the card, the votes in numpy on the host;
            reads/s and the wall of a batch split into seeding (lookup,
            also on the card's clock, and votes), device, wait and emit,
            beside the replicated index on a mesh of one slice timed
            alike; its SAM equal to the replicated one line for line, the
            first 256 reads equal to the CPU, K4 and the local walk
            launched once a slice of each batch and exactly equal to
            their plain versions on its first batch's inputs.
18. multihost: `gsw align --engine tpu --multihost` in two processes on
            the card (gloo over loopback) on phase 4's 10 Mbp genome, 5
            batches of 4096 x 150 bp reads, with and without
            --index-sharding prefix: each merged SAM byte-identical to
            one process's --mesh output, every child's exit code 0 within
            its time limit, K4 and the local walk launched once a batch
            over the children, and both exactly equal to their plain
            versions on the first batch's inputs.
19. variants: the variant caller's path on a 2 Mbp seeded chromosome,
            an experimental and a normal sample of paired 150 bp reads at
            20x as coordinate-sorted SAM (~40 M pileup events a sample),
            2,000 SNVs and 200 1-5 bp indels planted in the experimental
            one: the port's `callVariants --mesh` on the card (a (1, 1)
            mesh), the library call on a 4 x 2 mesh of the repeated card,
            the call without a mesh (host counts), and the CLI again with
            --profile DIR: the four VCFs byte-identical, each sample's
            card counts equal to the host's, every planted SNV called with
            its alt, the trace written; the wall split into load and
            parse, the count on the card's clock, calling and write; the
            calls off planted sites and the count tensor's bytes printed.
20. motif_popgen: the motif scan of a 50 Mbp seeded sequence (N runs,
            lowercase stretches) with a 20-column PWM, its first 1 Mbp
            against the CPU (the same -inf windows, rtol 1e-5); the AFS
            grid on 262,144 (n, k, alpha) triples at 2049 points, its
            first 4,096 against the CPU (NaN in the same places, the rest
            within the bound of tests/test_torch_popgen.py);
            wright_fisher_sim(10_000, 1_000, s=0.01) twice from one seed,
            identical; each timed. None of these has a hand-written
            kernel: the JAX device code they port is no Pallas kernel.
21. seq_parallel: the sequence-sharded aligner on meshes that repeat the
            card (a CUDA stream a strip): shard_seq_affine_align on the
            lowmem batch of phase 14 at seq = 4 (the main path: its
            launches of affine_fwd_strip, K7 and the walk) and seq = 2,
            every pair's (score, ops, i0, j0) equal to
            affine_gap_lowmem_batch on the card and the gathered
            checkpoints equal to lowmem_forward's, the wall split into
            forward, backward and host beside phase 14's and beside
            lowmem_forward timed here, peak memory; the 100 kb pair of
            phase 14 at seq = 2 (K = 4096) equal to affine_gap_lowmem;
            shard_seq_affine_score on 256 random pairs up to 1024 x 1024
            at seq = 4, equal to K2's score mode at lane n_b;
            pipeline_step at the dry run's shapes on 4 x 2 and on 256
            pairs of 1024^2 with a 2 Mbp genome on 2 x 2, scores equal to
            the unsharded call and counts to numpy's np.add.at. The strip
            kernel's row (affine_fwd_strip, K6's strip mode): each strip
            of the seq = 4 cut of the lowmem batch's middle block, an
            empty strip past lane n and the whole block as one strip in
            a global scratch, exact against the plain version, timed
            eagerly and in a CUDA graph beside K6 on the same block.
22. tools_cli: the tools around the engines through the umbrella
            command (gonomics_tpu_torch.cli.main), in process, on a
            seeded 200 kbp chr1 and 50 kbp chr2 and a query with a SNP
            every ~1 kbp and a 1-10 bp indel every ~20 kbp, joined by a
            chain of the blocks between the indels: gsw ggtools (chain
            to axt, vcf and gg, the VCF to gg, the axt to vcf); gsw align
            of the VCF's graph on the card, 2,000 reads of 150 bp from
            the query (K4, K5 and the graph walk), the first 400 against
            --device cpu; gsw align --engine tpu of 10x of the query on
            the target (the fused K1); pileup, samConsensus -multiFaDir
            and samToBed on that SAM, sorted; then mergesort of the SAM
            in chunks of 4096 records (spilled and merged), bedMerge and
            bedToWig Reads of samToBed's records, intervalOverlap of a
            bed of the planted SNPs with the merged records, and
            faFormat of the target (60 bases a line, the SNPs lower-cased
            from that bed, an index). Gates: every planted SNP in the
            chain's VCF; graph reads mapped >= 0.99 and giraf equal to
            the CPU's; the query's base at >= 99% of the covered planted
            SNPs of the consensus; one bed line a mapped read; pileup's
            rows the covered positions; mergesort's mapped records those
            of the sorted SAM in order, under the input's header; the
            merged bases and the wig's covered positions pileup's rows,
            the wig's sum the records' length; intervalOverlap's lines
            the covered planted SNPs; faFormat's lower-case bases the
            planted SNPs, its sequence the target's, its index that of
            its output. Then the fasta tools: faFindFast of
            samConsensus's chr1 alignment in windows of 1000 bases, short
            and with -longOutput -divergenceRate 0.01; assemblyStats,
            faInfo, faFilter -minSize 100000 and faBin -binNum 2 of the
            target; gcContent of the planted SNPs +-50 bp; catMultiFa of
            the chr1 and chr2 alignments; faUniq of the target's records
            written twice. Gates: a window a first-query base; in every
            window with no gap and no N, muts the differing columns
            (numpy prefix sums); muts >= 1 in every window that holds a
            covered planted SNP the consensus carries; the long output's
            first five columns the short one's; N50, L50, the contig
            count and the length numpy's; faInfo's counts numpy's;
            gcContent's values numpy's; faFilter keeps chr1 alone; faBin
            writes one file a record, named after it, and puts each
            record in one bin; catMultiFa's rows the
            concatenations; faUniq one record a sequence, in order. Then
            slices 11.2b and 11.3a: digestGenome MboI of the target;
            bedToFasta -revComp of the planted SNPs +-50 bp on alternating
            strands; bedToAminoAcid of 200 regions of chr1 whose lengths
            are multiples of 3; faToPredictSet --windowSize 400 --stride
            1000 of the target; prcompFormat of the chr1 alignment;
            findAndReplace -column 0 renaming chr1 in the SNP bed;
            reconstructSeq (and with -subMatrix -unitBranchLength 0.1)
            on four rows, the chr1 alignment's two and two seeded mutants
            of its target row, with 75 all-gap columns inserted;
            primateRecon -mleHcaHumanBiased and -mleHgaGorillaBiased on
            five seeded rows of chr2; mouseRecon -mleTree on four.
            Then slice 11.4 and bedFormat: vcfFilter -substitutionsOnly
            -biAllelicOnly of the chain's VCF; vcfToFa -useAlt of that
            on the target; vcfInfo -types -context; multiFaToVcf
            -substitutionsOnly of the chr1 alignment; vcfFormat -csv
            -clearInfo and -UCSCToEnsembl of the filtered VCF; bedFormat
            -UCSCToEnsembl -evenPadLength 10 of the SNP bed.
            Gates: digestGenome's cut ends the GATC sites under the JAX
            tool's rule, its fragments tiling each record; bedToFasta's
            records numpy's slices, reverse-complemented and named
            _RevComp on -; bedToAminoAcid's lines the script's own
            translation; faToPredictSet numpy's windows, upper-cased;
            prcompFormat numpy's one-hot of the variable columns with no
            gap and no N; findAndReplace the input with chr1 renamed;
            each reconstruction's leaves the input rows, and each
            ancestor the rows' base where they all agree on one and a
            gap where they are all gaps; vcfFilter's records the planted
            SNPs; vcfToFa's sequence numpy's edit; vcfInfo's substitution
            and trinucleotide counts numpy's; a multiFaToVcf record with
            the query's base at each covered planted SNP the consensus
            carries, every REF the target's; a csv row a record;
            vcfFormat's chroms 1 and 2; bedFormat's records numpy's.
            Then slices 11.5 and 11.6, each output against numpy's lines
            from its inputs: bedFilter, bedSplit, bedShear, bedTrim,
            bedMath, bedSimilarity, bedOverlapByWindow (the prefix sums
            of the merged records' coverage), bedDistanceFromChrEnds,
            bedMinimumDistanceName, bedValueWig (bedToWig's wig) and
            bedGraphToWig on the reads, merged records and SNPs;
            multiFaCount, multiFaScan (N planted at the chr1 SNPs),
            multiFaExtract -bed, multiFaReduce -bedFilename,
            multiFaSequenceSwap and mergeMultiFa on the chr1 alignment;
            multiFaToChain of chr1 aligned by the chain, its blocks the
            chain's. Then slice 11.7a and wigTools (sam_wig_steps), each
            output against numpy. Then slice 11.8a: randSeq of 20 x
            50,000 bases at seed 2207, of its first two records and of
            10 bases at seed 1, and the port's Go rand. Gates: 20
            records in 50-base lines, GC share 0.41 +- 0.002 and the
            |G-C|, |A-T| shares under 0.002; the second file the first's
            head; TATTTTGGGC; GoRand(1)'s Int63 and ten Intn(100) Go's
            published values, its burn-in table compute_cooked's. Then
            slice 11.8b (popgen_steps, popgen_checks): statCalc,
            plotFunctions, selectionMle of 2,000 sites drawn from the
            AFS at alpha 4 (and the library's estimate), selectionMcmc
            twice and mcmcTraceStats of its trace, dunnIndex with and
            without -realign, simulateWrightFisher twice and with no
            mutation. Gates: statCalc's values scipy's, its samples'
            means and variances their distributions'; plotFunctions'
            rows scipy's pdfs, its AFS pmfs summing to 1; the estimate
            within 1.2 of 4 and the library's; the traces' bytes equal,
            mcmcTraceStats' mean and HDI numpy's; dunnIndex's index and
            segregating sites numpy's Hamming counts; the Wright-Fisher
            runs' bytes equal, frequencies summing to 1, no absent base
            appearing without mutation. Then slice 11.9 and
            divergenceSpectrum (interval_lift_steps,
            interval_lift_checks): liftCoordinates of samToBed's records
            (-minMatch 0.95 and 0.99) and of the chain's VCF with -faFile
            q.fa; bedpeFilter, bedpeOverlap -bedSelect and
            intervalContacts of 20,000 seeded contacts between 2 kb
            windows against merged.bed and seeded tiles;
            intervalSubsetMatrix (binary and -fraction) over 1 kb
            windows; geneAssignmentStats of a planted truth;
            overlapEnrichments (upperBound, lowerBound, exact,
            normalApproximate) of merged.bed and the tiles against the
            planted SNPs; divergenceSpectrum of 10 kb windows of chr1.
            Gates: the lifted records numpy's map through the chain's
            blocks, the unmapped ones numpy's failures; every SNP of the
            VCF lifted with REF and ALT swapped, its insertions under
            the INDEL message, its deletions failing -minMatch; each
            bedpe output numpy's overlaps of the feet; the matrices
            numpy's; the printed share and lines the planted ones; the
            overlap count numpy's, the p-values scipy's binomial tails,
            numpy's Poisson-binomial convolution and scipy's normal
            densities; the six counts a window numpy's. Then item 10 and
            item 11's MAF and axt tools (vcf_maf_axt_steps,
            vcf_maf_axt_checks): the genotype caller
            (diploid_base_call_batch) on pileup's covered positions on
            the card and on the CPU; a trio VCF of the planted SNPs
            (momma 0/0, poppa 1/1, kiddo 0/1) and 200 decoys through
            filterGenotypes (trio and -byname), alleleSplit of the
            aligner's SAM, haplotypeGenerator -includeRef over 10 kb
            windows of chr1, sampleVcf and proximityBlockVcf at seeds;
            vcfAncestorAnnotation of the chr1 SNPs over the chain's chr1
            pair; vcfAfs of the AFS VCF with a 7-point likelihood grid;
            mafFilter, mafToBed, mafToMultiFa and mafIndels of a MAF of
            the chain's blocks (q e lines in every fifth); axTools
            --stats, --minScore, --swap, --gap and --fasta, and axtSam.
            Gates: the card's calls the CPU's and numpy's argmax, >= 99%
            of the covered planted SNPs at depth >= 10 homozygous for the
            query's base; each output numpy's from its inputs. Then
            slice 11.11b (gtf_accel_steps, gtf_accel_checks): gtfTools
            filter and toBed, getPromoter, geneIdToName, scCount and
            quickOrthologs of a seeded GTF of 194 genes on chr1, chr2 and
            chrU (no chain) with the aligner's SAM barcoded 8 ways;
            multiFaAcceleration (mutation, and SNP over a search space)
            and branchLengthsMultiFaBed of a four-way alignment of 3,000
            columns of chr2 with a stretch where hum mutates 10 times
            faster. Gates: each output numpy's from its inputs (lifts
            through the chain's blocks, the canonical transcript by the
            strictly-longer swap, windows, distances from prefix sums,
            lengths and Q of a plain least-squares fit); the stretch's
            raw velocity >= 3 times the rest's. Then slice 12a
            (sim_tree_steps, sim_tree_checks): simulateSam of t.fa five
            ways (-n 3000 -setSeed 7; -coverage 2; -n 2000
            -flatErrorRate 0.01; -n 2000 -ancientErrorRate 0.05 with the
            deamination table; -n 500 -setSeed 3 as SAM and as BAM);
            simulateBed of tn.fa's (t.fa with 20 runs of N) ungapped
            runs, twice and -matchedBed; simulateVcf (100 sites; with
            -refFile tn.fa; with -refFile of two 12-base chroms);
            simulateDivergentWindowsVcf; simulatePcr with and without
            -includePrimer=false; dotToNewick of a 12-leaf digraph;
            drawNewickTree of the primate tree where PIL imports.
            Gates: headers, pair fields and the chr1 share of pairs;
            every read the reference's bases through the fragment
            buffer's reuse, replayed from the pairs' positions; the flat
            error share 0.01 +- 0.001; damage C->T and G->A only; the
            BAM's records the SAM's; beds inside one region and
            repeatable; VCF records, REF from the FASTA, starts distinct
            across chroms; windows ordered by alt-ancestor counts; PCR
            products str.find's; the newick the digraph's edges; the
            PNG's lines where the draw rule puts them. Then slice 12b
            (sim_evol_steps, sim_evol_checks): simulateEvol genic of a
            3,000-base root with a four-exon gene down a 7-leaf tree
            (leaves, and every node); withIndels of 20,000 bases, with
            its VCF and again at transition bias 1; nonCoding of 13
            nodes x 10,000 bases, again with the identity matrix, and
            over its newick from a FASTA led by n and by a; simRecon, and
            over the tree with every length 0; ilsReconstructSeq of 3
            topologies x 50,000 positions and of weights 1 and 0.
            Gates: genic's records, ATG and a stop codon where the gene
            puts them, at most one gap; withIndels' ref row less its
            gaps the input, each VCF line the alignment's columns;
            nonCoding's records ACGT, the newick its names, the identity
            run all root, the n and a runs equal past column 0 (an N
            uses up a draw); simRecon's leaves, one row a node, its exon
            and nonCoding rows, values in [0, 100], all 100 at length 0;
            the ILS .pfa numpy's float32 sum, which the float64 sum is
            not. Then item 13 and strawToBedpe (onto_straw_steps,
            onto_straw_checks): oboTools mapping, gafFilter -removeNot,
            oboToDot from an alt id and ontologyHistogram over a
            500-term OBO and two GAFs of 2,500 lines; assignGenomeSpace
            of genes.gtf by proximity and through 5,000 contacts, an
            empty contact file and strawToBedpe's output; strawToBedpe
            of a 200 x 30-bin straw map on chr1; ontologyEnrichment of
            2,000 queries through the contacts. Gates: the mapping's
            rows, the filter's records, the dot's nodes and edges, the
            histogram's counts, tiles contiguous and equal to the plain
            1D and 3D fills, the straw histogram, cutoffs and calls, the
            proportions and scipy's binomial tails. Then slice 14a
            (giraf_pfa_steps, giraf_pfa_checks): sortGraph of v.gg;
            girafSort of the mapped girafs in chunks of 512;
            girafCompress and -decompress of those the binary format
            carries; pFaTools faToPfa, vcfToPfa, extract, extractBed,
            entropyTrack, sample and visualize (two forms), pfaFindFast
            short and long on a soft 50,000-column .pfa of chr1's
            alignment. Gates: edges forward; lines kept in .idx key
            order; the round trip but for the strand; rows, entropies
            (Go's Log2), PCG64 draws, printed values and window counts
            against numpy. Then slices 14b and 15a (sim_views_steps,
            sim_views_checks): girafSimulate of 2,000 reads of 150 bp
            on v.gg, aligned back on the card (K4, K5, gsw_walk_pack),
            and again with 50 somatic SNVs; multFaVisualizer of a
            window of chr1's alignment and to its END,
            multFaVisualizeBeds of 4 SNP regions; faChunkAlign of a 1
            kb pair at chunk size 1, of 5 records and of a word pair at
            chunk size 10; faDrawAlnChunks; lastZWriter in its two
            modes; formatIdeogram two ways; slurmCheck. Gates: reads
            mapped, on their true path (named in the read); the
            somatic bases one a location, fewer locations along the
            forward path than strand-aware; the views against numpy;
            faChunkAlign's pair and words equal to the routes of the
            card's K2 trace mode, its records whole chunks; the PNG's
            chunk colours by rank; the job lines, directories,
            parameters and matrices; the ideogram points; slurmCheck's
            report. The five kernels launched. Wall time of each step.

Then the kernels line (launch counts of banded_align_fused from phase 3's
main batches, of banded_dp and banded_walk_pack from its long reads, of
the local walk from phase 5 (and K4's there as mesh_launches; both
kernels' on phases 17 and 18 as prefix_launches and multihost_launches), of
the wavefront kernels from phase 8 (affine_wavefront's and
const_wavefront's, and under "trace_diag_launches" the launches of
the one CUDA kernel, "kernel", both take there), of the graph kernels
from phase 10, of the lowmem kernels from phase 14, of the score kernels
from phase 16, of affine_fwd_strip from phase 21, where K7's and the
walk's are seq_parallel_launches; the fused K1's, K4's, K5's and the
graph walk's in phase 22 as tools_launches) and, last, one JSON object naming the device. Without a
CUDA card, or outside a checkout of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B, L, PAD = 4096, 150, 24
W = L + 2 * PAD
# the end-to-end phase's long-read batch: reads whose traces do not fit a
# block's shared memory (banded_plan), which take banded_dp and
# banded_walk_pack
LONG_READS, LONG_L = 64, 13_000
# and one read whose staged codes do not fit a block's shared memory at
# one warp: banded_dp's global-codes variant
HUGE_L = 120_000
# the mesh phase: the CLI's 10 Mbp genome, MESH_BATCHES batches of B reads
# of L bp; its first MESH_CPU_READS reads against the CPU
CLI_BP, MESH_BATCHES, MESH_CPU_READS = 10_000_000, 3, 256
# the prefix phase: the end-to-end genome's dense index split into
# PREFIX_SLICES chunks on the card, the mesh phase's batches
PREFIX_SLICES = 4
# the multihost phase: MULTIHOST_PROCS processes of `gsw align --multihost`
# on the card over MULTIHOST_BATCHES batches of B reads, each child under
# MULTIHOST_TIMEOUT_S
MULTIHOST_PROCS, MULTIHOST_BATCHES, MULTIHOST_TIMEOUT_S = 2, 5, 300
GAP = -600
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
# int32 lanes: 132 SMs x 64 INT32 units x 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations that banded_dp's function needs, not those of one
# implementation. Per valid band cell (i <= n, i + c <= m): substitution
# address and table load (2), diag = prev + sub (1), base = max(diag,
# up + gap) as one DPX add-max (1), the test j <= m (1), base := NEG//2
# where invalid (1), a = base - gap*c (1), a sequential max-prefix from the
# NEG//2 fill (1), h = max(pre + gap*c, 0) as one DPX add-max (1), h := 0
# where invalid (1), left = h[c-1] + gap (1), trace code (3 compares,
# 3 selects), best cell (DPX max with predicate, 1 select). An invalid
# cell's h (0) and trace code (3) are constants, so it needs only its store.
DP_OPS_PER_VALID_CELL = 19
# per row of a read: clip its code, its score-table row offset, and the
# row's bound m (or 0 past the read); per window base used: clip its code
DP_OPS_PER_ROW = 4
DP_OPS_PER_WINDOW_BASE = 2
# per walk step: trace address, load, stop test, i and c updates, pack
# shift and or (the band walk stays inside the trace, so it needs no clip)
WALK_OPS_PER_STEP = 7

# Pairwise global alignment (BASELINE.json config 2, bench.py:120-129 and
# :179-188): trace mode at 128 pairs, score mode at 256, 1024 x 1024.
PAIR_LEN, PAIR_B_TRACE, PAIR_B_SCORE = 1024, 128, 256
# the API and CLI phases: related pairs of about 1 kb
RELATED_LEN, RELATED_PAIRS = 1000, 128
# the pairwise kernels' long case: 2 pairs of 20,000 x 300
BIG_N, BIG_M = 20_000, 300
AFFINE_GAPS, CONST_GAP = (-600, -150), -430
# int32 operations that each wavefront function needs per cell (i, j) of
# a pair's own n_b x m_b grid, not those of one implementation. Score
# mode, int32 operations only (the substitution score is a table load at
# an offset the cell's row and column fix, not an int32 operation): H =
# max(M, I), which the cell below reads for its D and, one step later,
# for its M (1); M = sub + max(H, D) at (i-1, j-1), a max and an add (2);
# I = max(go+ge+max(M, D), ge+I) at (i, j-1), a max, an add and a DPX
# add-max (3); D = max(go+ge+H, ge+D) at (i-1, j), an add and a DPX
# add-max (2). (An earlier count, 10, took the table's address and load
# as 2 and did not share H between D and M.) Trace mode counts the
# substitution address and table load (2) and writes each state's
# predecessor: the three candidates of I and of D as values (3 adds
# each), their DPX max3 (1 each), and per state an argmax in tie order (2
# compares, 2 selects: 4 each, M too), then the code tM + 4 tI + 16 tD
# (2).
AFFINE_OPS_PER_CELL = {"score": 1 + 2 + 3 + 2,
                       "trace": 2 + (1 + 1 + 4) + 2 * (3 + 1 + 4) + 2}
# const score mode: diag = c(i-1, j-1) + sub (1), max(c(i, j-1),
# c(i-1, j)) and a DPX add-max with the gap against diag (2); trace mode:
# left and up as values (2), a DPX max3 (1) and the argmax (4)
CONST_OPS_PER_CELL = {"score": 2 + 1 + 2, "trace": 2 + 1 + 2 + 1 + 4}

# Graph read aligner: the gsw defaults (-i 32 -w 32, humanChimpTwo, gap
# -600) and the CLI's batch of 2048 reads of 150 bp, on the variant graph
# of a 50 Mbp chromosome (the size of human chr22); the CLI phase on 1 Mbp.
GRAPH_BP, GRAPH_BATCH, GRAPH_BATCHES, GRAPH_JOBS = 50_000_000, 2048, 4, 2048
GRAPH_CLI_BP = 1_000_000
# a wide genome window, above the block design's shared-memory limits
# (8,532 bases for K4, 10,239 for K5): 2 jobs of a 10,300-base window and
# a 32-base part
GRAPH_WIDE_N, GRAPH_WIDE_M, GRAPH_WIDE_C = 10_300, 32, 2
# read parts past the graph DPs' warp design (m + 1 > 512 slots): the
# block design, 16 jobs of an 800-base window and 600-base read parts
GRAPH_BLOCK_N, GRAPH_BLOCK_M, GRAPH_BLOCK_C = 800, 600, 16
# int32 operations the graph DPs need per cell (i, j) of a job's own
# n_b x m_b grid, not those of one implementation. LeftDynamicAln:
# substitution address and table load (2), diag = c(i-1, j-1) + sub (1),
# max(c(i, j-1), c(i-1, j)) and one DPX add-max-relu with the gap against
# diag, which also clamps at 0 (2); left and up as values for the trace
# (2), their argmax in tie order (2 compares, 2 selects: 4), code 3 where
# c == 0 (1), the lane's best value and its diagonal (a DPX max with
# predicate and a select: 2). RightDynamicAln: the same without the clamp
# and the code 3 (13); the cells of its padded rectangle outside the
# job's own grid need all but the best (11); its row 0 and column 0 are
# gap * d, one operation a cell.
BEST_OPS_PER_CELL = 2
LOCAL_OPS_PER_CELL = 2 + 1 + 2 + 2 + 4 + 1 + BEST_OPS_PER_CELL
RIGHT_OPS_PER_CELL = 2 + 1 + 2 + 2 + 4 + BEST_OPS_PER_CELL
# per walk step: trace address, load, stop test, i and j updates, pack
# shift and or; the right side's end is a first-max over the job's lanes
# (a compare and a select a lane)
GSW_WALK_OPS_PER_STEP = 7
GSW_ARGMAX_OPS_PER_LANE = 2

# The lowmem aligner at bench.py's own configuration (bench.py:220-231):
# 16 random pairs of 16,384 x 16,384, humanChimpTwo, -600/-150, K = 1024,
# seed 3 (after bench.py's two 300 bp parity pairs from the same stream).
LOWMEM_B, LOWMEM_LEN, LOWMEM_K, LOWMEM_SEED = 16, 16384, 1024, 3
# its other gates: 4 related pairs of 2 kb at K = 256 against the CPU, and
# one related pair of 100 kb through the pairwise API at its default K
LOWMEM_SMALL, LOWMEM_SMALL_K, LOWMEM_LONG = 2000, 256, 100_000
# the pairwise API's default K (align.affine_gap_lowmem), the 100 kb pair's
LOWMEM_LONG_K = 4096
# affine_fwd_block's time a block in its earlier design, one thread block
# a pair (this script, NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md §6)
K6_EARLIER_MS = 9.3823

# Score-only affine alignment at bench.py's stage_score_stream
# (bench.py:87-150): its parity gate (B0 = 8 pairs of L0 = 96, the stream
# at P0 = 4, seed 5), K2's score mode on B = 256 random pairs of 1024 x
# 1024 (seeds 2, 3) and the stream on P = 8 x B = 256 pairs of that size
# (seeds 0, 1), HUMAN_CHIMP_TWO, -600/-150; the row-blocked kernel at the
# same B and size with its default r_rows = 512.
SCORE_B0, SCORE_L0, SCORE_P0 = 8, 96, 4
SCORE_B, SCORE_L, SCORE_P, SCORE_R = 256, 1024, 8, 512
# per walk step: trace address, load, activity test, the next state's
# shift and mask, i and j updates
LOWMEM_WALK_OPS_PER_STEP = 7

# the seq_parallel phase: the lowmem batch on (1, 4) and (1, 2) meshes of
# the repeated card (the first the main path), and pipeline_step at
# PIPE_B pairs of PIPE_L x PIPE_L with a PIPE_GENOME bp genome
SEQ_SHARDS = (4, 2)
PIPE_B, PIPE_L, PIPE_GENOME = 256, 1024, 2_000_000

# the variants phase: a VARIANT_BP chromosome, an experimental and a normal
# sample at VARIANT_DEPTH x coverage of VARIANT_L bp paired reads (evenly
# spaced starts), VARIANT_SNVS SNVs and VARIANT_INDELS 1-5 bp indels
# planted in the experimental sample, where 3 of every 4 reads carry them;
# VARIANT_ERR sequencing errors a base in both
VARIANT_BP, VARIANT_DEPTH, VARIANT_L = 2_000_000, 20, 150
VARIANT_SNVS, VARIANT_INDELS, VARIANT_ERR = 2000, 200, 0.002
# the motif_popgen phase: the scan of a MOTIF_BP sequence with a MOTIF_L
# column PWM, its first MOTIF_CPU_BP windows against the CPU; the AFS grid
# on AFS_TRIPLES (n, k, alpha) at AFS_POINTS points, its first AFS_CPU
# against the CPU; wright_fisher_sim(*WF_ARGS) twice from one seed
MOTIF_BP, MOTIF_L, MOTIF_CPU_BP = 50_000_000, 20, 1_000_000
AFS_TRIPLES, AFS_POINTS, AFS_CPU = 262_144, 2049, 4096
WF_ARGS = (10_000, 1_000, 0.01)

# the tools_cli phase: a target of TOOLS_SIZES; its query has a SNP every
# ~TOOLS_SNP_EVERY bp (none within TOOLS_SNP_GAP bp of an indel) and a
# 1-10 bp indel every ~TOOLS_INDEL_EVERY bp; TOOLS_GRAPH_READS reads of L
# bp from the query through the chain's graph (the first TOOLS_CPU_READS
# against the CPU), and TOOLS_DEPTH x of the query through the linear
# aligner for pileup, samConsensus and samToBed
TOOLS_SIZES = (("chr1", 200_000), ("chr2", 50_000))
TOOLS_SNP_EVERY, TOOLS_INDEL_EVERY, TOOLS_SNP_GAP = 1000, 20_000, 50
TOOLS_GRAPH_READS, TOOLS_CPU_READS, TOOLS_DEPTH = 2000, 400, 10
TOOLS_SORT_CHUNK = 4096  # mergesort's records a chunk: ~5 chunks spilled
TOOLS_WINDOW, TOOLS_GC_FLANK = 1000, 50  # faFindFast's window; gcContent's
# faToPredictSet's (and wigTools toTrainingSet's) window and stride;
# bedToAminoAcid's regions of chr1
TOOLS_PREDICT_WINDOW, TOOLS_PREDICT_STRIDE, TOOLS_AA_REGIONS = 400, 1000, 200
# the ancestral reconstructions' trees (reconstructSeq's leaves: the chr1
# alignment's two rows and two mutants of its target row; primateRecon's
# and mouseRecon's: seeded rows of chr2 under the reference tools' names)
TOOLS_RECON_TREE = ("((Target:0.01,Query:0.02)tq:0.01,"
                    "(mutA:0.03,mutB:0.02)ab:0.01)root;")
TOOLS_PRIMATE_TREE = ("(((hg38:0.0065,(panTro6:0.0027,panPan2:0.0027)pan:"
                      "0.004)hca:0.0012,gorGor5:0.0089)hga:0.008,"
                      "ponAbe3:0.018)root;")
TOOLS_MOUSE_TREE = ("(((mm10:0.02,rn7:0.03)mra:0.05,criGriChoV2:0.06)mrh:"
                    "0.02,speTri2:0.1)root;")
# slice 11.7a and wigTools: every TOOLS_FQ_EVERY-th read listed for
# fastqFilter, which keeps a seeded TOOLS_FQ_SUBSET of the reads; every
# TOOLS_BAM_EVERY-th planted SNP +- TOOLS_BAM_FLANK as a region of
# bedCountBam and samInfo mapq -bedfile; wigTools peaks' threshold
TOOLS_FQ_EVERY, TOOLS_FQ_SUBSET, TOOLS_FQ_SEED = 7, 0.5, 11
TOOLS_BAM_EVERY, TOOLS_BAM_FLANK, TOOLS_PEAK = 8, 300, 15
# slice 11.8a: randSeq's records, their length, seed and -GC (1 Mbp); its
# GC share within RAND_GC_TOL of -GC (4 sigma on 1 M draws) and the |G-C|,
# |A-T| shares under it (3.1 and 2.6 sigma; the seed fixes the draws);
# Go's published seed-1 stream (rand.Int63, ten rand.Intn(100)) and the
# first ten bases it gives at -GC 0.41
RAND_NUM, RAND_LEN, RAND_SEED, RAND_GC, RAND_GC_TOL = 20, 50_000, 2207, \
    0.41, 0.002
GO_SEED1_INT63 = 5577006791947779410
GO_SEED1_INTN100 = [81, 87, 47, 59, 81, 18, 25, 40, 56, 0]
GO_SEED1_BASES = "TATTTTGGGC"
# slice 11.8b: selectionMle's VCF, POP_SITES sites of POP_N haplotypes
# drawn with numpy (seed POP_SEED) from the stationary AFS at POP_ALPHA,
# its estimate within POP_MLE_TOL of POP_ALPHA (4.1 standard deviations
# of the estimate over 12 seeds at this size, 0.29); selectionMcmc's
# VCF of MCMC_SITES sites of MCMC_N, MCMC_ITER iterations at seed
# MCMC_SEED; dunnIndex's DUNN_ROWS rows (two groups) of DUNN_LEN columns,
# windows of DUNN_WINDOW every DUNN_STEP, the first DUNN_REALIGN of
# DUNN_REALIGN_LEN with -realign; simulateWrightFisher's -N, -t, -g, -m;
# statCalc's samplers' draws, their means within STAT_SE_TOL standard
# errors and variances within STAT_VAR_RTOL; its densities and sums
# within STAT_RTOL (its %e's 7 digits), its integrals within
# STAT_INT_RTOL; plotFunctions' %f values within PLOT_ATOL of scipy's
POP_ALPHA, POP_SITES, POP_N, POP_SEED, POP_MLE_TOL = 4.0, 2000, 20, 2208, \
    1.2
MCMC_SITES, MCMC_N, MCMC_ITER, MCMC_SEED = 10, 10, 20, 7
DUNN_ROWS, DUNN_LEN, DUNN_WINDOW, DUNN_STEP = 8, 6000, 500, 700
DUNN_REALIGN, DUNN_REALIGN_LEN = 2, 200
WF_N, WF_T, WF_G, WF_M, WF_SEED = 100, 100, 4, 0.001, 3
STAT_DRAWS, STAT_SE_TOL, STAT_VAR_RTOL = 20_000, 4.0, 0.06
STAT_RTOL, STAT_INT_RTOL, PLOT_ATOL = 1e-6, 1e-5, 6e-7
# slice 11.9 and divergenceSpectrum: IL_CONTACTS bedpe contacts between
# IL_WINDOW bp windows of the target, IL_INTRA of them within a
# chromosome, at seed IL_SEED; bedpeFilter's -minDistance IL_MIN_DIST; a
# bed of named tiles, one in a IL_TILE bp cell with probability
# IL_TILE_KEEP, beside merged.bed as a select file and elements1;
# intervalSubsetMatrix's union of IL_ISM_WINDOW bp windows;
# geneAssignmentStats' truth region every IL_GENE_EVERY bp, every
# IL_GENE_PAIR-th with a second contact over it, IL_GENE_SHARE of them
# matched; divergenceSpectrum's windows of IL_DIV_WINDOW bp over chr1;
# overlapEnrichments' printed values (%f, %e: 7 digits) within
# IL_PRINT_RTOL of numpy's and scipy's, the library's bounds within
# IL_BINOM_RTOL of scipy.stats.binom; liftCoordinates of the reads again
# at -minMatch IL_STRICT_MATCH (the planted deletions, 1-10 bp, are too
# short to fail 0.95 under a 150 bp read)
IL_CONTACTS, IL_WINDOW, IL_INTRA, IL_SEED = 20_000, 2000, 0.5, 2290
IL_MIN_DIST, IL_TILE, IL_TILE_KEEP = 20_000, 4000, 0.5
IL_ISM_WINDOW, IL_GENE_EVERY, IL_GENE_PAIR, IL_GENE_SHARE = 1000, 1000, 5, \
    0.6
IL_DIV_WINDOW, IL_PRINT_RTOL, IL_BINOM_RTOL = 10_000, 1e-6, 1e-9
IL_STRICT_MATCH = 0.99  # a read over a deletion of 2+ bases fails it
# item 10 and item 11's MAF and axt tools: the trio's samples; the seed of
# the decoys, MAF scores and axt scores, VMA_DECOYS trio sites failing
# the trio test; haplotypeGenerator's windows of chr1; sampleVcf's
# (-setSeed, -numVariants, -numSamples) and proximityBlockVcf's
# (distance, -setSeed); vcfAfs' (-leftBound, -rightBound,
# -numberOfPoints), whose grid steps over alpha 0 (where the likelihood
# raises); the MAF's blocks of at most VMA_MAF_BLOCK bp, each
# VMA_E_EVERY-th with a q e line alone, mafIndels' -eiThreshold VMA_EI;
# the axt's pieces of VMA_AXT_PIECE bp; mafFilter's and axTools'
# thresholds; the genotype caller's epsilon and prior (delta, gamma), and
# the share of covered planted SNPs at depth >= VMA_MIN_DEPTH it must
# call homozygous for the query's base
VMA_TRIO = ("momma", "poppa", "kiddo")
VMA_SEED, VMA_DECOYS, VMA_WINDOW = 2300, 200, 10_000
VMA_SAMPLE, VMA_PROX, VMA_AFS = (2301, 100, 2), (1000, 2302), (-1.0, 11.0, 6)
VMA_MAF_BLOCK, VMA_E_EVERY, VMA_EI, VMA_AXT_PIECE = 2000, 5, 0.1, 500
VMA_MAF_THRESHOLD, VMA_AXT_MIN_SCORE = 500, 50_000
VMA_EPS, VMA_PRIOR, VMA_MIN_DEPTH, VMA_HOM_SHARE = 0.01, (0.01, 3.0), 10, 0.99
# slice 11.11b: GA_GENES genes a chrom (chrU, GA_CHRU_BP bp, in no chain),
# those of chr1 and chr2 at least GA_GENE_GAP bp apart (no read spans
# two), every GA_TIE_EVERY-th of two transcripts of equal lengths; reads
# barcoded with GA_BARCODES seeded barcodes; getPromoter's -upstream and
# -downstream; accel.fa's GA_ACCEL_BP columns of chr2 from GA_ACCEL_AT,
# four rows at GA_RATE with GA_GAP_RUNS gap runs a row (mutant_rows),
# hum's private rate GA_HOT_X times over in columns GA_HOT; windows of
# GA_WINDOW; a search space of runs of 100-399 bases between gaps of
# 40-169 (~70% of the slice) at -searchSpaceProportion GA_PROPORTION;
# GA_REGIONS regions for branchLengthsMultiFaBed; the planted stretch's
# mean raw velocity at least GA_VEL_RATIO times the rest's; Q within
# GA_Q_RTOL or GA_Q_ATOL of the formula's
GA_SEED, GA_GENES = 3100, (("chr1", 150), ("chr2", 40), ("chrU", 4))
GA_CHRU_BP, GA_GENE_GAP, GA_TIE_EVERY = 20_000, 1000, 8
GA_BARCODES, GA_PROMOTER = 8, (1000, 200)
GA_ACCEL_AT, GA_ACCEL_BP, GA_RATE, GA_GAP_RUNS = 10_000, 3000, 0.02, 3
GA_HOT, GA_HOT_X = (1200, 1800), 10
GA_WINDOW, GA_PROPORTION, GA_REGIONS = 100, 0.5, 20
GA_VEL_RATIO, GA_Q_RTOL, GA_Q_ATOL = 3.0, 1e-9, 1e-12
# slice 12a: tn.fa is t.fa with ST_N_RUNS seeded runs of N of ST_N_LEN
# bases; simulateSam's runs (a)-(e) as ST_SAM (name: flags), read length
# ST_READ_LEN, the chr1 share of pairs within ST_SHARE_SD binomial sd,
# the flat error share within ST_FLAT_TOL; simulateBed's -N, -L and seed;
# simulateVcf's sites, alpha, alleles and seed, and a reference of two
# chroms of ST_COLLIDE_BP bases each as many sites as one holds;
# simulateDivergentWindowsVcf's total sites, window sites, windows and
# seed; simulatePcr's primers and -maxProductSize; a dot tree of
# ST_TREE_LEAVES leaves; drawNewickTree's image and its white share
ST_SEED, ST_N_RUNS, ST_N_LEN = 3200, 20, (50, 500)
ST_READ_LEN, ST_SHARE_SD, ST_FLAT, ST_FLAT_TOL = 150, 4.0, 0.01, 0.001
ST_SAM = {"a": ["-n", "3000", "-setSeed", "7"], "b": ["-coverage", "2"],
          "c": ["-n", "2000", "-flatErrorRate", str(ST_FLAT)],
          "d": ["-n", "2000", "-ancientErrorRate", "0.05"],
          "e": ["-n", "500", "-setSeed", "3"]}
ST_BED = (2000, 1000, 10)
ST_VCF, ST_COLLIDE_BP = (100, 4, 100, 11), 12
ST_DIV = (100, 20, 20, 9)
ST_PRIMERS, ST_PCR_MAX = ("ACGTAC", "GATTACA"), 1000
ST_TREE_LEAVES, ST_IMG, ST_WHITE = 12, (1500, 400), 0.95
# slice 12b: a root of SE_ROOT_BP seeded bases with a gene of SE_EXONS
# (0-based half-open) and SE_FRAMES, its start codon at the first exon's
# start and its stop codon's first base at the last exon's end - 3; the
# 7-leaf SE_TREE (and a copy with every length 0); withIndels' input
# length, branch length, propIndel, lambda, transition bias and seed;
# nonCoding's nodes, length, seed and --fastaFile length; the ILS run's
# topologies, positions and precision; the root's GC share within
# SE_GC_TOL of --gcContent's default
SE_SEED, SE_ROOT_BP = 3300, 3000
SE_EXONS = ((300, 601), (900, 1300), (1500, 1801), (2200, 2800))
SE_FRAMES = (0, 2, 1, 0)
SE_TREE = ("((((l0:0.1,l1:0.05)n1:0.08,l2:0.12)n2:0.04,(l3:0.2,l4:0.07)n3:"
           "0.1)n4:0.03,(l5:0.09,l6:0.15)n5:0.06)root;")
SE_WI = (20_000, "0.05", "0.3", "0.5", "2", "5")
SE_NC, SE_NC_FA_BP = (13, 10_000, 3), 2000
SE_ILS, SE_GC_TOL = (3, 50_000, 0.001), 0.02
# item 13 and strawToBedpe: OS_TERMS OBO terms, each with 1-3 parents
# among the OS_PARENT_WINDOW terms before it, every OS_ALT_EVERY-th with
# an alt id (oboToDot starts from term 3's); GAF records in two files, a
# share OS_NOT of them NOT qualifiers and OS_DUP repeats of an earlier
# (GO id, symbol) pair (file b starts from file a's pairs); cis contacts
# and queries, a share OS_HOT of the queries within OS_HOT_BP of
# OS_HOT_GENES genes' TSSs; one straw map on chr1 at OS_BIN bp bins,
# OS_STRAW bins by distances, scores 1 + a negative binomial of mean
# OS_STRAW_MEAN / (1 + d), a share OS_PEAK_SHARE raised by OS_PEAK;
# strawToBedpe's -minBinDistance, -fdr and -minCutoff; printed %e values
# within OS_PRINT_RTOL relative or OS_PRINT_ATOL absolute; a cutoff
# decision whose q lies within OS_Q_RTOL of the fdr is not held
OS_SEED, OS_TERMS, OS_PARENT_WINDOW, OS_ALT_EVERY = 3400, 500, 50, 10
OS_GAF, OS_NOT, OS_DUP = (2500, 2500), 0.1, 0.1
OS_CONTACTS, OS_QUERIES = 5000, 2000
OS_HOT, OS_HOT_BP, OS_HOT_GENES = 0.1, 2000, 5
OS_BIN, OS_STRAW, OS_STRAW_MEAN = 1000, (200, 30), 30.0
OS_PEAK_SHARE, OS_PEAK = 0.01, (40, 80)
OS_MIN_BIN, OS_FDR, OS_MIN_CUTOFF = 1, 0.05, 10
OS_PRINT_RTOL, OS_PRINT_ATOL, OS_Q_RTOL = 1e-6, 1e-12, 1e-9
# slice 14a (giraf_pfa_inputs): girafSort's records a chunk; the soft
# three-record .pfa over the first GP_SOFT_COLS columns of chr1's multiFa
# alignment, a share GP_SOFT of its bases blurred by up to GP_BLUR, an N
# every GP_N_EVERY columns of the second query and a reference gap every
# GP_REF_GAP_EVERY; GP_SAMPLES genotypes a VCF site; GP_REGIONS beds for
# extractBed; sample's draws; visualize's start, end and line length;
# pfaFindFast's window and divergence rate, and its p values' tolerance
GP_SEED, GP_CHUNK, GP_SOFT_COLS, GP_SOFT, GP_BLUR = 3500, 512, 50_000, 0.3, 0.5
GP_N_EVERY, GP_REF_GAP_EVERY, GP_SAMPLES, GP_REGIONS = 4999, 1499, 6, 20
GP_DRAWS, GP_VIS, GP_WINDOW, GP_RATE = 2, (100, 1123, 50), 1000, 0.01
GP_PVAL_RTOL = 1e-5  # pfaFindFast's printed p values against numpy's tails
GP_X_SHARE = 0.5  # girafCompress's input records with a base changed
GP_MIN_CHUNKS = 4  # girafSort's chunk files that its merge must take
# slices 14b and 15a (sim_views_inputs): girafSimulate's reads, read
# length, seed, somatic SNVs and allele frequency, and the share of its
# reads that the card's graph aligner must put on their true path (this
# script's run on the CPU before the card's fixed it); multFaVisualizer's
# line length and its window, SV_VIS bases before and after the first gap
# of the alignment's reference row, and the END view's last SV_END_TAIL
# bases; SV_BEDS planted SNPs padded by SV_BED_PAD for
# multFaVisualizeBeds; faChunkAlign's pair, SV_PAIR_BP bases around a
# planted SNP with SV_PAIR_INDELS indels of 1-8 bases in the query; its
# records and chunks of SV_CHUNK bases (whole-chunk indels, a share
# SV_MSA_SUB of the chunks with a base changed); the word pair's flank
# chunks; the fancy job-array file's lines
SV_SEED, SV_READS, SV_READ_LEN, SV_SNV, SV_AF = 3600, 2000, 150, 50, 0.5
SV_TRUE_SHARE = 0.994
SV_LINE, SV_VIS, SV_END_TAIL, SV_BEDS, SV_BED_PAD = 60, (300, 700), 400, 4, 40
SV_PAIR_BP, SV_PAIR_INDELS = 1000, 3
SV_MSA, SV_CHUNK, SV_MSA_SUB = (5, 40), 10, 0.3
SV_WORD_FLANK, SV_SLURM_LINES = 10, 6
# lastZWriter's parameter sets and matrices by distance category
# (gonomics lastZWriter.go:86-140); a number <= 0.2 is close, >= 0.7 far
LZ_SETS = {
    "close": ("human_chimp_v2.mat",
              "O=600 E=150 H=2000 T=2 M=254 K=4500 L=3000 Y=15000"),
    "default": ("default.mat",
                "O=400 E=30 H=2000 T=1 M=254 K=3000 L=3000 Y=9400"),
    "far": ("hoxD55.mat", "O=400 E=30 H=2000 T=1 M=50 K=2200 L=6000 Y=3400")}
# Go's math.Log constants (FDLIBM e_log.c), for the entropy gate's numpy
# Log2
GO_LOG_L = (6.666666666666735130e-01, 3.999999999940941908e-01,
            2.857142874366239149e-01, 2.222219843214978396e-01,
            1.818357216161805012e-01, 1.531383769920937332e-01,
            1.479819860511658591e-01)
GO_LN2_HI, GO_LN2_LO = 6.93147180369123816490e-01, 1.90821492927058770002e-10
# the standard code in TCAG order, and the three-letter names
CODE_TCAG = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
AA_NAMES = dict(zip("ARNDCQEGHILKMFPSTWYV*", (
    "Ala Arg Asn Asp Cys Gln Glu Gly His Ile Leu Lys Met Phe Pro Ser Thr "
    "Trp Tyr Val Ter").split()))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def once_ms(fn):
    """fn() and its time on the card's clock, one call (for plain
    versions too slow to repeat)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def median_ms(fn, runs: int = 25, inner: int = 1) -> float:
    """Median over `runs` samples of the card time per call of fn, each
    sample timed with CUDA events around `inner` back-to-back calls (so
    that the host's launch overhead hides behind a short kernel)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def graph_ms(fn, runs: int = 15, inner: int = 20) -> float:
    """Median over `runs` replays of a CUDA graph of `inner` calls of fn,
    per call: the card's time for back-to-back launches without the
    host's time a call (tens of microseconds of Python and ctypes), which
    a kernel shorter than it would otherwise wait for between launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def dp_operations(n_vec: np.ndarray, m_vec: np.ndarray, length: int = L) -> int:
    """int32 operations banded_dp's function needs for reads of lengths
    n_vec (at most `length`) in windows of lengths m_vec (see
    DP_OPS_PER_VALID_CELL)."""
    rows = np.minimum(n_vec.astype(np.int64), length)
    i = np.arange(1, length + 1)
    lanes = np.clip(m_vec[:, None].astype(np.int64) - i + 1, 0, 64)
    valid = int(np.where(i <= rows[:, None], lanes, 0).sum())
    bases = int(np.clip(np.minimum(m_vec, rows + 63), 0, None).sum())
    return (DP_OPS_PER_VALID_CELL * valid + DP_OPS_PER_ROW * int(rows.sum())
            + DP_OPS_PER_WINDOW_BASE * bases)


def phase_device() -> dict:
    from gonomics_tpu_torch import native
    from gonomics_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    # build the host library and the kernels side by side
    t0 = time.perf_counter()
    host = threading.Thread(target=native.available)
    host.start()
    _kernels.build_all()
    host.join()
    info = {"phase": "device", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "build_s": time.perf_counter() - t0,
            "native_host_library": native.available(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def kernel_batch(seed: int, n: int = B, length: int = L):
    """n anchored (read, window) pairs of reads of `length` in windows of
    length + 2 PAD: SNPs, 5 bp deletions and insertions, short reads,
    lowercase bases and junk rows."""
    rng = np.random.default_rng(seed)
    width = length + 2 * PAD
    wins = rng.integers(0, 4, (n, width)).astype(np.int8)
    wins[rng.random((n, width)) < 0.001] = 4
    reads = wins[:, PAD:PAD + length].copy()
    n_vec = np.full(n, length, np.int32)
    for b in range(n):
        kind = b % 10
        if kind == 1:      # 5 bp deletion from the read
            reads[b, 75:] = wins[b, PAD + 80:PAD + 80 + length - 75]
        elif kind == 2:    # 5 bp insertion into the read
            reads[b, 80:] = reads[b, 75:length - 5].copy()
            reads[b, 75:80] = rng.integers(0, 4, 5)
        elif kind == 3:    # short read
            n_vec[b] = int(rng.integers(100, length))
            reads[b, n_vec[b]:] = 4
        elif kind == 4:    # lowercase bases
            reads[b, rng.integers(0, length, 12)] += 5
        elif kind == 5:    # junk
            reads[b] = rng.integers(0, 4, length)
        snp = rng.integers(0, length, 1 + b % 3)
        reads[b, snp] = (reads[b, snp] % 5 + 1) % 4
    return reads, wins, n_vec, np.full(n, width, np.int32)


def equal_err(got, want):
    """Whether two tuples of tensors are equal, and their largest absolute
    difference."""
    torch.cuda.synchronize()
    return (all(torch.equal(g, w) for g, w in zip(got, want)),
            max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                for g, w in zip(got, want)))


BANDED_DP_REPLACES = ("gonomics_tpu/ops/wavefront.py:709 (_banded_kernel, "
                      "pallas_call :850)")
BANDED_WALK_REPLACES = ("gonomics_tpu/ops/wavefront.py:789 (_banded_walk) + "
                        ":874-883 (packing)")


def banded_row(name: str, equal: bool, err: int, bound: dict, replaces: str,
               timing: tuple, **extra) -> dict:
    """One kernel's row of the kernels line (launches filled in later):
    timing is (ms, graph_ms, plain_ms); bound the bytes and operations
    times, the larger of which is bound_ms."""
    by = max(bound, key=bound.get)
    ms, gms, plain = timing
    return {"name": name, "route": "cuda",
            "source": "gonomics_tpu_torch/csrc/banded.cu",
            "replaces": replaces, "launches": None,
            "equal_to_plain": equal, "tolerance": "exact",
            "max_abs_err": err, "ms": ms, "graph_ms": gms,
            "plain_ms": plain, "bound_ms": bound[by], "bound_by": by,
            "library_ms": None, **extra}


def dp_and_walk_rows(dp_args: tuple, length: int, plain_once: bool):
    """banded_dp and banded_walk_pack on one batch, dp_args = (reads,
    windows, n_vec, m_vec, scores, gap) on the card: each held against
    its plain version (the walk from the plain DP's trace and best cells)
    and timed eagerly (ms) and in a CUDA graph (graph_ms), with bounds
    from this batch's inputs, banded_dp's plan and the walk's longest
    walk (max_steps) and the tiles its kernel loads (rounds: the most a
    read, and in all), counted on the plain walk's path. The plain
    versions are timed once where plain_once (long reads), else as the
    kernels are. Returns (rows, the plain DP's result, the walk's steps
    and ops bytes a read)."""
    from gonomics_tpu_torch.ops import banded

    reads, wins, n_vec, m_vec = dp_args[:4]
    n, width = wins.shape
    plain_dp = (lambda: banded.banded_dp_reference(*dp_args))
    if plain_once:
        want, dp_plain_ms = once_ms(plain_dp)
    else:
        want, dp_plain_ms = plain_dp(), median_ms(plain_dp)
    dp_equal, dp_err = equal_err(banded.banded_dp(*dp_args), want)

    bv, bi, trace = want
    score, i_star, c_star = banded.best_cell(bv, bi)
    walk_args = (trace, i_star, c_star, score > 0,
                 banded.walk_length(length))
    plain_walk = (lambda: banded.banded_walk_pack_reference(*walk_args))
    if plain_once:
        wwant, walk_plain_ms = once_ms(plain_walk)
    else:
        wwant, walk_plain_ms = plain_walk(), median_ms(plain_walk)
    walk_equal, walk_err = equal_err(banded.banded_walk_pack(*walk_args),
                                     wwant)

    # bounds from this batch: bytes each input read once and each output
    # written once, and the operations this batch's cells need over the
    # int32 rate
    in_bytes = n * length + n * width + 8 * n + 100
    dp_bytes = in_bytes + 2 * n * 64 * 4 + length * n * 64
    dp_ops = dp_operations(n_vec.cpu().numpy(), m_vec.cpu().numpy(), length)
    dp_bound = {"bytes": dp_bytes / HBM_BYTES_PER_S * 1e3,
                "operations": dp_ops / INT32_OPS_PER_S * 1e3}
    # the cells the walk reads (one a move, plus the one it stops on) and
    # the tiles its kernel enters, from the plain walk's path
    w_steps, w_rounds = banded.walk_rounds(*walk_args)
    steps = int(w_steps.sum())
    P = wwant[2].shape[1]
    walk_bytes = n * (4 + 4 + 1) + n * (4 + 4 + P) + steps
    walk_bound = {"bytes": walk_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": WALK_OPS_PER_STEP * steps / INT32_OPS_PER_S * 1e3}

    def dp():
        return banded.banded_dp(*dp_args)

    def walk():
        return banded.banded_walk_pack(*walk_args)

    # eager (`ms`) and in a CUDA graph (`graph_ms`): launched eagerly, a
    # call may wait on the host's time a call
    rows = [banded_row("banded_dp", dp_equal, dp_err, dp_bound,
                       BANDED_DP_REPLACES,
                       (median_ms(dp, inner=20), graph_ms(dp), dp_plain_ms),
                       plan=banded.banded_launch_plan(n, length, "dp"),
                       dp_operations=dp_ops),
            banded_row("banded_walk_pack", walk_equal, walk_err, walk_bound,
                       BANDED_WALK_REPLACES,
                       (median_ms(walk, inner=20), graph_ms(walk),
                        walk_plain_ms),
                       max_steps=int(w_steps.max()),
                       rounds=int(w_rounds.max()),
                       rounds_total=int(w_rounds.sum()), walk_steps=steps)]
    return rows, want, (steps, P)


ROW_KEYS = ("name", "equal_to_plain", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "graph_ms", "plan", "dp_operations",
            "max_steps", "rounds", "rounds_total", "walk_steps")


def phase_kernels(dev: torch.device) -> list[dict]:
    """The main path's kernel, banded_align_fused, on the main batch;
    banded_dp and banded_walk_pack at the same shape too, in this phase's
    line only (the main path does not take them: their rows come from
    the long reads, phase_long_read_kernels)."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import banded

    reads, wins, n_vec, m_vec = (torch.from_numpy(x).to(dev)
                                 for x in kernel_batch(1))
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    dp_args = (reads, wins, n_vec, m_vec, sc, GAP)
    off_path, _, (steps, P) = dp_and_walk_rows(dp_args, L, plain_once=False)
    fwant = banded.banded_align_full_reference(*dp_args)
    fused_equal, fused_err = equal_err(banded.banded_align_fused(*dp_args),
                                       fwant)
    # the fused mode: the DP's and the walk's operations; its bytes are
    # the inputs and the six outputs (no trace leaves the chip)
    dp_ops = off_path[0]["dp_operations"]
    fused_bytes = B * L + B * W + 8 * B + 100 + B * (5 * 4 + P)
    fused_bound = {"bytes": fused_bytes / HBM_BYTES_PER_S * 1e3,
                   "operations": (dp_ops + WALK_OPS_PER_STEP * steps)
                   / INT32_OPS_PER_S * 1e3}

    def fused():
        return banded.banded_align_fused(*dp_args)

    row = banded_row(
        "banded_align_fused", fused_equal, fused_err, fused_bound,
        BANDED_DP_REPLACES + " + :789 (_banded_walk) + :874-883 (packing) "
        "in banded_align_full :815",
        (median_ms(fused, inner=20), graph_ms(fused),
         median_ms(lambda: banded.banded_align_full_reference(*dp_args),
                   runs=5)),
        plan=banded.banded_launch_plan(B, L, "fused"))
    emit({"phase": "kernels", "shape": {"B": B, "L": L, "W": W},
          "kernels": [{k: r[k] for k in ROW_KEYS if k in r} for r in [row]],
          "trace_mode_at_this_shape": [{k: r[k] for k in ROW_KEYS if k in r}
                                       for r in off_path]})
    if not (fused_equal and all(r["equal_to_plain"] for r in off_path)):
        raise SystemExit("a kernel disagrees with its plain version")
    return [row]


def phase_long_read_kernels(dev: torch.device, batch: tuple) -> list[dict]:
    """banded_dp and banded_walk_pack on the inputs the end-to-end phase's
    long-read batch gave them (batch: its reads, windows, n_vec and m_vec
    as the aligner made them, and the aligner's scores and gap), the path
    that takes them: each held against its plain version, timed, with its
    bound and plan from these inputs."""
    from gonomics_tpu_torch.ops import banded

    reads, wins, n_vec, m_vec, scores = (
        torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in batch[:5])
    n, length = reads.shape
    dp_args = (reads, wins, n_vec, m_vec, scores.to(torch.int32),
               int(batch[5]))
    rows, want, _ = dp_and_walk_rows(dp_args, length, plain_once=True)
    # banded_dp's global-codes variant (the plan of reads past the staged
    # codes' reach), forced on these inputs, against the same plain DP
    plan = banded.banded_launch_plan(n, length, "dp", codes="global")

    def dp_global():
        return banded._banded_launch(plan, *dp_args)

    g_equal, g_err = equal_err(dp_global(), want)
    global_codes = {"plan": plan, "equal_to_plain": g_equal,
                    "max_abs_err": g_err,
                    "ms": median_ms(dp_global, runs=5, inner=3),
                    "graph_ms": graph_ms(dp_global, runs=5, inner=3)}
    emit({"phase": "long_read_kernels",
          "shape": {"B": n, "L": length, "W": wins.shape[1]},
          "kernels": [{k: r[k] for k in ROW_KEYS if k in r} for r in rows],
          "banded_dp_global_codes_at_this_shape": global_codes})
    if not (g_equal and all(r["equal_to_plain"] for r in rows)):
        raise SystemExit("a kernel disagrees with its plain version")
    rows[0]["global_codes"] = {k: global_codes[k] for k in (
        "equal_to_plain", "ms", "graph_ms")}
    return rows


def phase_huge_read(dev: torch.device, batch: tuple) -> dict:
    """The device step of the end-to-end phase's HUGE_L bp read, on its
    own inputs (batch as phase_long_read_kernels takes it): the plan
    banded_plan gives it (the trace mode's global-codes variant), the
    step through banded_align_full held against
    banded_align_full_reference on the card (exact; the plain version
    timed once) and timed, banded_dp and banded_walk_pack each timed."""
    from gonomics_tpu_torch.ops import banded

    reads, wins, n_vec, m_vec, scores = (
        torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in batch[:5])
    n, length = reads.shape
    args = (reads, wins, n_vec, m_vec, scores.to(torch.int32), int(batch[5]))
    plan = banded.banded_launch_plan(n, length)
    want, plain_ms = once_ms(lambda: banded.banded_align_full_reference(
        *args))
    equal, err = equal_err(banded.banded_align_full(*args), want)
    bv, bi, trace = banded.banded_dp(*args)
    score, i_star, c_star = banded.best_cell(bv, bi)
    walk_args = (trace, i_star, c_star, score > 0,
                 banded.walk_length(length))
    out = {"phase": "huge_read", "shape": {"B": n, "L": length,
                                           "W": wins.shape[1]},
           "plan": plan, "equal_to_plain": equal, "max_abs_err": err,
           "tolerance": "exact", "score": int(want[0][0]),
           "ms": median_ms(lambda: banded.banded_align_full(*args), runs=5),
           "plain_ms": plain_ms,
           "banded_dp_ms": median_ms(lambda: banded.banded_dp(*args),
                                     runs=5),
           "banded_walk_pack_ms": median_ms(
               lambda: banded.banded_walk_pack(*walk_args), runs=5)}
    emit(out)
    if not (equal and plan["codes"] == "global"):
        raise SystemExit("the huge read's device step disagrees with its "
                         "plain version")
    return out


def make_reads(genome: np.ndarray, n: int, seed: int, prefix: str = "r",
               L: int = L):
    """n reads of L bp with one SNP each, every other one reverse-
    complemented; every 64th a 5 bp deletion, every 64th (offset 32) a
    5 bp insertion, every 100th junk. Returns (reads, truth) with truth
    the start (or -1 for junk)."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io.fastq import Fastq

    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - L - 10, n)
    reads, truth = [], []
    qual = np.full(L, 30, np.uint8)
    for i, s in enumerate(starts):
        s = int(s)
        seq = genome[s:s + L].copy()
        if i % 64 == 1:
            seq = np.concatenate([genome[s:s + 75], genome[s + 80:s + L + 5]])
        elif i % 64 == 33:
            seq = np.concatenate([genome[s:s + 75],
                                  rng.integers(0, 4, 5).astype(np.int8),
                                  genome[s + 75:s + L - 5]])
        p = int(rng.integers(0, L))
        seq[p] = (seq[p] + 1) % 4
        if i % 100 == 7:
            seq = rng.integers(0, 4, L).astype(np.int8)
            s = -1
        if i % 2:
            seq = dna.reverse_complement(seq).astype(np.int8)
        reads.append(Fastq(f"{prefix}{i}", seq, qual))
        truth.append(s)
    return reads, np.array(truth)


def check_sam(text: str, truth: np.ndarray) -> dict:
    lines = text.splitlines()
    assert len(lines) == len(truth), (len(lines), len(truth))
    mapped = placed = junk_mapped = 0
    for line, s in zip(lines, truth):
        f = line.split("\t")
        flag, pos, cigar = int(f[1]), int(f[3]), f[5]
        if s < 0:
            junk_mapped += not flag & 4
            continue
        if flag & 4:
            continue
        mapped += 1
        m = re.match(r"(\d+)S", cigar)
        placed += pos - 1 - (int(m.group(1)) if m else 0) == s
    real = int((truth >= 0).sum())
    return {"mapped_frac": mapped / real, "placed_frac": placed / real,
            "junk": len(truth) - real, "junk_mapped": junk_mapped}


def phase_end_to_end(dev: torch.device, G: int) -> tuple[dict, tuple,
                                                          tuple]:
    """ReadAligner end to end on the main batches, then on one batch of
    long reads and on one read of HUGE_L bp; returns the phase's line and
    the long batch's and the huge read's inputs to the device step, each
    with the aligner's scores and gap (phase_long_read_kernels,
    phase_huge_read)."""
    from gonomics_tpu_torch import dna, native
    from gonomics_tpu_torch.io.fasta import Fasta
    from gonomics_tpu_torch.ops import banded
    from gonomics_tpu_torch.read_align import ReadAligner

    # the reads/s and host split below are those of the native host path
    if not native.available():
        raise SystemExit("the native host library did not build")
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, G, dtype=np.int8)
    t0 = time.perf_counter()
    al = ReadAligner([Fasta("chr1", genome)], index_mode="sparse",
                     index_step=8, device=dev)
    build_s = time.perf_counter() - t0

    # span on the card's clock of each batch's device step, from the first
    # upload to the result in host memory (host enqueue gaps included)
    spans = []
    device_result = al._device_result
    last_inputs = []  # the last batch's (read_seqs, windows, n_vec, m_vec)

    def timed_device_result(*args):
        last_inputs[:] = [args]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = device_result(*args)
        end.record()
        spans.append((start, end))
        return res

    al._device_result = timed_device_result
    batches = [make_reads(genome, B, 100 + t) for t in range(4)]
    al.finish_batch_lines(al.align_batch_async(batches[0][0]))  # warm-up

    # host seed+vote alone, on the same batches
    seed_ms = []
    for reads, _ in batches:
        fwd = np.stack([r.seq for r in reads])
        rev = dna.complement(fwd[:, ::-1]).astype(np.int8)
        t1 = time.perf_counter()
        al._candidates(fwd, rev)
        seed_ms.append((time.perf_counter() - t1) * 1e3)

    # the main path: launch counts from this loop only
    banded.dp_launches = banded.walk_launches = banded.fused_launches = 0
    spans.clear()
    texts, dispatch_ms, finish_ms = [], [], []

    def finish(handle) -> None:
        t1 = time.perf_counter()
        texts.append(al.finish_batch_lines(handle))
        finish_ms.append((time.perf_counter() - t1) * 1e3)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = None
    for reads, _ in batches:
        t1 = time.perf_counter()
        handle = al.align_batch_async(reads)
        dispatch_ms.append((time.perf_counter() - t1) * 1e3)
        if pending is not None:
            finish(pending)
        pending = handle
    finish(pending)
    wall = time.perf_counter() - t0
    device_ms = [s.elapsed_time(e) for s, e in spans]
    launches = {"banded_align_fused": banded.fused_launches,
                "banded_dp": banded.dp_launches,
                "banded_walk_pack": banded.walk_launches}
    # the kernel banded_plan gives the main path's batches
    main_kernel = ("banded_align_fused"
                   if banded.banded_launch_plan(B, L)["mode"] == "fused"
                   else "banded_dp")

    checks = check_sam("".join(texts),
                       np.concatenate([t for _, t in batches]))
    # the long-read path: reads whose traces do not fit a block's shared
    # memory take banded_dp and banded_walk_pack; launch counts from this
    # batch only
    long_reads, long_truth = make_reads(genome, LONG_READS, 200, "long",
                                        LONG_L)
    banded.dp_launches = banded.walk_launches = banded.fused_launches = 0
    t1 = time.perf_counter()
    long_text = al.finish_batch_lines(al.align_batch_async(long_reads))
    long_path = {"reads": LONG_READS, "read_len": LONG_L,
                 "plan": banded.banded_launch_plan(LONG_READS, LONG_L)["mode"],
                 "wall_ms": (time.perf_counter() - t1) * 1e3,
                 "launches": {"banded_align_fused": banded.fused_launches,
                              "banded_dp": banded.dp_launches,
                              "banded_walk_pack": banded.walk_launches},
                 **check_sam(long_text, long_truth)}
    long_inputs = last_inputs[0]
    # one read past the staged codes' reach (fault 3.3 before): the trace
    # mode's global-codes variant and the walk
    huge_reads, huge_truth = make_reads(genome, 1, 201, "huge", HUGE_L)
    banded.dp_launches = banded.walk_launches = banded.fused_launches = 0
    t1 = time.perf_counter()
    huge_text = al.finish_batch_lines(al.align_batch_async(huge_reads))
    huge_plan = banded.banded_launch_plan(1, HUGE_L)
    huge_path = {"reads": 1, "read_len": HUGE_L,
                 "plan": {k: huge_plan[k] for k in (
                     "mode", "codes", "lanes_per_thread", "warps_per_block",
                     "smem_bytes", "registers", "spill_bytes")},
                 "wall_ms": (time.perf_counter() - t1) * 1e3,
                 "launches": {"banded_align_fused": banded.fused_launches,
                              "banded_dp": banded.dp_launches,
                              "banded_walk_pack": banded.walk_launches},
                 **check_sam(huge_text, huge_truth)}
    out = {"phase": "end_to_end", "genome_bp": G, "index": "sparse step 8",
           "batches": len(batches), "batch": B, "read_len": L,
           "index_build_s": build_s, "reads_per_s": len(batches) * B / wall,
           "wall_ms_per_batch": wall * 1e3 / len(batches),
           # span on the card's clock from the first upload to the result
           # in host memory, over wall time; the span includes the host's
           # enqueue gaps, so it bounds the card's busy share from above
           "device_span_share": sum(device_ms) / (wall * 1e3),
           "host_seed_vote_ms_per_batch": float(np.mean(seed_ms)),
           "host_dispatch_ms_per_batch": float(np.mean(dispatch_ms)),
           "host_finish_ms_per_batch": float(np.mean(finish_ms)),
           "device_ms_per_batch": float(np.mean(device_ms)),
           "native_host_library": native.available(),
           "main_kernel": main_kernel, "launches": launches, **checks,
           "long_reads": long_path, "huge_read": huge_path}
    emit(out)
    long_launches = long_path["launches"]
    huge_launches = huge_path["launches"]
    if not (checks["mapped_frac"] >= 0.99 and checks["placed_frac"] >= 0.99
            and checks["junk_mapped"] == 0
            and main_kernel == "banded_align_fused"
            and launches["banded_align_fused"] > 0
            and long_path["plan"] == "dp"
            and long_launches["banded_dp"] > 0
            and long_launches["banded_walk_pack"] > 0
            and long_launches["banded_align_fused"] == 0
            and long_path["mapped_frac"] >= 0.99
            and long_path["placed_frac"] >= 0.99
            and long_path["junk_mapped"] == 0
            and huge_path["plan"]["codes"] == "global"
            and huge_launches["banded_dp"] == 1
            and huge_launches["banded_walk_pack"] == 1
            and huge_path["mapped_frac"] == 1.0
            and huge_path["placed_frac"] == 1.0):
        raise SystemExit("end-to-end check failed")
    # each kernel's launches from the path that takes it
    out["launches"] = {"banded_align_fused": launches["banded_align_fused"],
                       "banded_dp": long_launches["banded_dp"],
                       "banded_walk_pack": long_launches["banded_walk_pack"]}
    return (out, (*long_inputs, al.scores, al.gap),
            (*last_inputs[0], al.scores, al.gap))


def cli_genome(G: int) -> np.ndarray:
    """The CLI and mesh phases' genome of G bases, from seed 2."""
    return np.random.default_rng(2).integers(0, 4, G, dtype=np.int8)


def phase_cli(dev: torch.device, G: int) -> dict:
    """`gsw align --engine tpu` single and paired, byte-equal to the
    library path; then with --mesh, byte-equal to the runs without it."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.cli import gsw_cmd
    from gonomics_tpu_torch.io import fasta, fastq
    from gonomics_tpu_torch.read_align import ReadAligner

    genome = cli_genome(G)
    single, _ = make_reads(genome, 3000, 7)
    r1, _ = make_reads(genome, 1000, 8, prefix="p")
    r2, _ = make_reads(genome, 1000, 9, prefix="p")
    result = {"phase": "cli", "genome_bp": len(genome)}
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref.fa")
        s = dna.to_string(genome)
        with open(ref, "w") as f:
            f.write(">chrS\n")
            f.writelines(s[i:i + 60] + "\n" for i in range(0, len(s), 60))
        paths = {}
        for name, reads in (("single", single), ("r1", r1), ("r2", r2)):
            paths[name] = os.path.join(tmp, name + ".fq")
            with open(paths[name], "w") as f:
                for r in reads:
                    f.write(f"@{r.name}\n{dna.to_string(r.seq)}\n+\n"
                            f"{fastq.qual_string(r.qual)}\n")
        # the North star's command line: gsw align ref.fa reads.fq
        # --engine tpu, with -t as the JAX CLI takes it
        flags = ["--engine", "tpu", "-t", "4", "--device", dev.type]
        result["flags"] = " ".join(flags)
        t0 = time.perf_counter()
        gsw_cmd.main(["align", ref, paths["single"], "-o",
                      os.path.join(tmp, "single.sam"), *flags])
        gsw_cmd.main(["align", ref, paths["r1"], paths["r2"], "-o",
                      os.path.join(tmp, "paired.sam"), *flags])
        result["cli_s"] = time.perf_counter() - t0

        al = ReadAligner(fasta.read(ref), device=dev)
        head = "".join(line + "\n" for line in al.header().text)
        reads = fastq.read(paths["single"])
        want_single = head + "".join(
            al.finish_batch_lines(al.align_batch_async(reads[i:i + 2048]))
            for i in range(0, len(reads), 2048))
        pairs = list(zip(fastq.read(paths["r1"]), fastq.read(paths["r2"])))
        want_paired = head + "".join(
            s.to_string() + "\n" for i in range(0, len(pairs), 2048)
            for s in al.align_pairs(pairs[i:i + 2048]))
        for name, want in (("single", want_single), ("paired", want_paired)):
            with open(os.path.join(tmp, name + ".sam")) as f:
                got = f.read()
            result[f"{name}_equal"] = got == want
            result[f"{name}_lines"] = got.count("\n")
        # --mesh: every CUDA device of the process, the mesh path
        t0 = time.perf_counter()
        gsw_cmd.main(["align", ref, paths["single"], "-o",
                      os.path.join(tmp, "single_mesh.sam"), *flags,
                      "--mesh"])
        gsw_cmd.main(["align", ref, paths["r1"], paths["r2"], "-o",
                      os.path.join(tmp, "paired_mesh.sam"), *flags,
                      "--mesh"])
        result["mesh_cli_s"] = time.perf_counter() - t0
        for name in ("single", "paired"):
            with open(os.path.join(tmp, name + ".sam"), "rb") as f:
                plain = f.read()
            with open(os.path.join(tmp, name + "_mesh.sam"), "rb") as f:
                result[f"{name}_mesh_equal"] = f.read() == plain
    emit(result)
    if not (result["single_equal"] and result["paired_equal"]):
        raise SystemExit("CLI SAM differs from the library path")
    if not (result["single_mesh_equal"] and result["paired_mesh_equal"]):
        raise SystemExit("gsw align --mesh differs from the run without it")
    return result


def phase_mesh(dev: torch.device, G: int) -> dict:
    """ReadAligner's mesh path (ReadAligner(mesh=), each batch through
    shard_local_align: local_wavefront over every read's whole (L, W)
    grid and the local walk) on the CLI phase's genome: MESH_BATCHES
    batches of B reads of L bp on make_mesh(data=1), one after another,
    with the wall split into seeding (host), device (the card's span from
    the upload to the result in host memory), the wait for it and emit
    (SAM text); the same batches on a mesh of two data slices on the one
    card (the device repeated), which must give the same SAM; the first
    MESH_CPU_READS reads against the mesh path on the CPU; the lines equal
    to the banded path's, counted (a full local DP and a 64-lane band may
    end differently on ties). Returns the phase's line, with the first
    batch's inputs to the device step for phase_mesh_kernels."""
    from gonomics_tpu_torch import native
    from gonomics_tpu_torch.io.fasta import Fasta
    from gonomics_tpu_torch.ops import banded, gsw_dp, wavefront
    from gonomics_tpu_torch.parallel import make_mesh
    from gonomics_tpu_torch.read_align import ReadAligner

    genome = cli_genome(G)
    t0 = time.perf_counter()
    base = ReadAligner([Fasta("chrS", genome)], device=dev)
    build_s = time.perf_counter() - t0
    state = base.state()
    al = ReadAligner.from_state(state, device=dev, mesh=make_mesh(data=1))
    al2 = ReadAligner.from_state(
        state, device=dev, mesh=make_mesh(devices=["cuda:0"] * 2, data=2))
    batches = [make_reads(genome, B, 300 + t) for t in range(MESH_BATCHES)]

    spans, seeding, inputs = [], [], []
    device_result, candidates = al._device_result, al._candidates

    def timed_device_result(*args):
        inputs.append(args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = device_result(*args)
        end.record()
        spans.append((start, end))
        return res

    def timed_candidates(*args):
        t1 = time.perf_counter()
        out = candidates(*args)
        seeding.append((time.perf_counter() - t1) * 1e3)
        return out

    al._device_result, al._candidates = timed_device_result, timed_candidates
    al.finish_batch_lines(al.align_batch_async(batches[0][0]))  # warm-up
    al2.finish_batch_lines(al2.align_batch_async(batches[0][0]))
    spans.clear()
    seeding.clear()
    inputs.clear()

    # the main path: launch counts from this loop only
    wavefront.local_launches = gsw_dp.local_walk_launches = 0
    banded.fused_launches = banded.dp_launches = banded.walk_launches = 0
    texts, dispatch_ms, wait_ms, emit_ms = [], [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for reads, _ in batches:
        t1 = time.perf_counter()
        handle = al.align_batch_async(reads)
        t2 = time.perf_counter()
        handle[5].numpy()  # the device result in host memory
        t3 = time.perf_counter()
        texts.append(al.finish_batch_lines(handle))
        t4 = time.perf_counter()
        dispatch_ms.append((t2 - t1) * 1e3)
        wait_ms.append((t3 - t2) * 1e3)
        emit_ms.append((t4 - t3) * 1e3)
    wall = time.perf_counter() - t0
    launches = {"local_wavefront": wavefront.local_launches,
                "local_walk_pack": gsw_dp.local_walk_launches,
                "banded_kernels": banded.fused_launches + banded.dp_launches
                + banded.walk_launches}
    device_ms = [s.elapsed_time(e) for s, e in spans]
    checks = check_sam("".join(texts),
                       np.concatenate([t for _, t in batches]))

    # two data slices on the one card
    wavefront.local_launches = gsw_dp.local_walk_launches = 0
    texts2 = [al2.finish_batch_lines(al2.align_batch_async(reads))
              for reads, _ in batches]
    launches2 = {"local_wavefront": wavefront.local_launches,
                 "local_walk_pack": gsw_dp.local_walk_launches}
    # the mesh path on the CPU, the first reads
    cpu = ReadAligner.from_state(state, device="cpu",
                                 mesh=make_mesh(devices=["cpu"], data=1))
    head = batches[0][0][:MESH_CPU_READS]
    cpu_text = cpu.finish_batch_lines(cpu.align_batch_async(head))
    card_head = "".join(texts[0].splitlines(True)[:MESH_CPU_READS])
    # the banded path on the same batches
    lines = "".join(texts).splitlines()
    banded_lines = "".join(
        base.finish_batch_lines(base.align_batch_async(reads))
        for reads, _ in batches).splitlines()
    same = sum(a == b for a, b in zip(lines, banded_lines))
    n_reads = MESH_BATCHES * B
    out = {"phase": "mesh", "genome_bp": G, "batches": MESH_BATCHES,
           "batch": B, "read_len": L, "window": W, "walk_steps": L + W,
           "index_build_s": build_s, "reads_per_s": n_reads / wall,
           "wall_ms_per_batch": wall * 1e3 / MESH_BATCHES,
           "host_seed_vote_ms_per_batch": float(np.mean(seeding)),
           "host_dispatch_ms_per_batch": float(np.mean(dispatch_ms)),
           "device_ms_per_batch": float(np.mean(device_ms)),
           "wait_ms_per_batch": float(np.mean(wait_ms)),
           "host_emit_ms_per_batch": float(np.mean(emit_ms)),
           "device_span_share": sum(device_ms) / (wall * 1e3),
           "native_host_library": native.available(),
           "launches": launches, **checks,
           "data2_same_sam": texts2 == texts, "data2_launches": launches2,
           "cpu_reads": MESH_CPU_READS, "cpu_equal": cpu_text == card_head,
           "banded_equal_lines": same, "banded_equal_frac": same / n_reads}
    emit(out)
    if not (checks["mapped_frac"] >= 0.99 and checks["placed_frac"] >= 0.99
            and checks["junk_mapped"] == 0 and out["data2_same_sam"]
            and out["cpu_equal"] and len(lines) == n_reads
            and launches["local_wavefront"] == MESH_BATCHES
            and launches["local_walk_pack"] == MESH_BATCHES
            and launches["banded_kernels"] == 0
            and launches2["local_wavefront"] == 2 * MESH_BATCHES
            and launches2["local_walk_pack"] == 2 * MESH_BATCHES):
        raise SystemExit("mesh check failed")
    out["inputs"] = (*inputs[0], al.scores, al.gap)
    return out


MESH_WALK_REPLACES = ("gonomics_tpu/ops/wavefront.py:661-696 "
                      "(local_align_full's best cell, lax.scan walk and "
                      "packing: jnp glue after K4)")


def phase_mesh_kernels(dev: torch.device, batch: tuple) -> tuple[dict, dict]:
    """local_wavefront (K4) at the mesh path's shape, on the inputs the
    mesh phase's first batch gave it, and the local walk on K4's own
    trace: each held against its plain version on the card (exact, whole
    tensors) and timed eagerly (ms) and in a CUDA graph (graph_ms), with
    K4's plan, each bound from these inputs (K4: its inputs, bv and bd,
    and the whole trace, or its job's own cells' operations; the walk: the
    cells its steps read, the bests its first-max reads, the rows it
    writes, or those steps' and lanes' operations) and the walk's longest
    walk and tiles. Returns the walk's row of the kernels line and K4's
    figures at this shape."""
    from gonomics_tpu_torch.ops import gsw_dp, wavefront

    alpha, beta, nv, mv, scores = (
        torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in batch[:5])
    args = (alpha, beta, nv, mv, scores.to(torch.int32), int(batch[5]))
    C, n = alpha.shape
    m = beta.shape[1]
    S = n + 1

    def k4():
        return wavefront.local_wavefront(*args)

    want, k4_plain_ms = once_ms(lambda: wavefront.local_wavefront_reference(
        *args))
    k4_equal, k4_err = equal_err(k4(), want)
    bv, bd, trace = want
    walk_args = ("local", trace, bv, bd)

    def walk():
        return gsw_dp.gsw_walk_pack(*walk_args)

    wwant, walk_plain_ms = once_ms(lambda: gsw_dp.gsw_walk_pack_reference(
        *walk_args))
    walk_equal, walk_err = equal_err((walk(),), (wwant,))
    steps, rounds = gsw_dp.walk_rounds(*walk_args)
    n_steps = int(steps.sum())

    k4_bound = graph_dp_bound("local", nv.cpu().numpy(), mv.cpu().numpy(),
                              n, m, corner=False)
    walk_bytes = C * (4 * S + 4) + n_steps + wwant.numel()
    walk_bound = {"bytes": walk_bytes / HBM_BYTES_PER_S * 1e3,
                  "operations": (GSW_WALK_OPS_PER_STEP * n_steps
                                 + GSW_ARGMAX_OPS_PER_LANE * C * S)
                  / INT32_OPS_PER_S * 1e3}
    k4_by = max(("bytes", "operations"), key=k4_bound.get)
    walk_by = max(walk_bound, key=walk_bound.get)
    k4_row = {"shape": {"B": C, "n": n, "m": m},
              "plan": wavefront.graph_dp_plan(C, n, m, "local"),
              "equal_to_plain": k4_equal, "max_abs_err": k4_err,
              "ms": median_ms(k4, runs=15, inner=5),
              "graph_ms": graph_ms(k4, runs=10, inner=5),
              "plain_ms": k4_plain_ms, "bound_ms": k4_bound[k4_by],
              "bound_by": k4_by, "trace_bytes": C * (n + m) * S,
              "cells": k4_bound["cells"],
              "bound_job_cells_ms": k4_bound["bound_job_cells_ms"]}
    walk_row = {"name": "local_walk_pack", "route": "cuda",
                "source": "gonomics_tpu_torch/csrc/gsw_dp.cu",
                "replaces": MESH_WALK_REPLACES, "launches": None,
                "equal_to_plain": walk_equal, "tolerance": "exact",
                "max_abs_err": walk_err,
                "ms": median_ms(walk, runs=15, inner=20),
                "graph_ms": graph_ms(walk), "plain_ms": walk_plain_ms,
                "bound_ms": walk_bound[walk_by], "bound_by": walk_by,
                "library_ms": None,
                "shape": f"{C} reads of {n} bp in {m} bp windows",
                "max_steps": int(steps.max()), "rounds": int(rounds.max()),
                "rounds_total": int(rounds.sum()), "walk_steps": n_steps}
    emit({"phase": "mesh_kernels", "tolerance": "exact",
          "local_wavefront": k4_row,
          "local_walk_pack": {k: v for k, v in walk_row.items()
                              if k not in ("route", "source", "launches",
                                           "library_ms")}})
    if not (k4_equal and walk_equal and k4_row["plan"]["design"] == "warp"):
        raise SystemExit("a mesh kernel disagrees with its plain version or "
                         "did not take its plan")
    return walk_row, k4_row


def related_pair(rng, L: int, same_length: bool):
    """A random sequence of L bases and a relative of it: 2% SNPs, 0.5%
    N, a deletion and an insertion of 1-30 bp each (of the same length
    when same_length, so that the pair stays L x L)."""
    a = rng.integers(0, 4, L).astype(np.int8)
    b = a.copy()
    b[rng.random(L) < 0.02] = rng.integers(0, 4)
    b[rng.random(L) < 0.005] = 4
    k_del = int(rng.integers(1, 31))
    k_ins = k_del if same_length else int(rng.integers(1, 31))
    cut = int(rng.integers(0, L - k_del))
    b = np.concatenate([b[:cut], b[cut + k_del:]])
    at = int(rng.integers(0, len(b)))
    b = np.concatenate([b[:at], rng.integers(0, 4, k_ins).astype(np.int8),
                        b[at:]])
    return a, b


def pair_batch(B: int, n: int, m: int, seed: int, dev):
    """B related pairs padded to (n, m) as tensors on dev: alpha, beta,
    fin = n_b + m_b, and each pair's (n_b, m_b). Pair b has a prefix of
    length n - b % 7 of one related n-bp pair against m - b % 5 bases of
    its relative (cut or padded with random bases)."""
    rng = np.random.default_rng(seed)
    alpha = np.full((B, n), 4, np.int8)
    beta = np.full((B, m), 4, np.int8)
    dims = []
    for b in range(B):
        a, r = related_pair(rng, n, same_length=True)
        nb, mb = n - b % 7, m - b % 5
        r = np.concatenate([r, rng.integers(0, 4, max(0, mb - len(r)))])[:mb]
        alpha[b, :nb] = a[:nb]
        beta[b, :mb] = r
        dims.append((nb, mb))
    dims = np.array(dims)
    fin = dims.sum(1).astype(np.int32)
    return (torch.from_numpy(alpha).to(dev), torch.from_numpy(beta).to(dev),
            torch.from_numpy(fin).to(dev), dims)


def wavefront_bound(mode: str, kind: str, dims: np.ndarray, n: int, m: int,
                    results: int | None = None, cells: int | None = None
                    ) -> dict:
    """Least time for one wavefront call: each input read once and each
    output written once (in trace mode the whole (n+m, B, n+1) trace, and
    `results` int32 values, by default the (B, n+1) rows of K2/K3) at the
    memory rate, and the operations that `cells` (by default each pair's
    own n_b x m_b) need at the int32 rate."""
    B = len(dims)
    if cells is None:
        cells = int((dims[:, 0].astype(np.int64) * dims[:, 1]).sum())
    if results is None:
        results = (3 if (mode, kind) == ("affine", "trace") else 1) * B * (n + 1)
    nbytes = B * (n + m) + 4 * B + 100 + 4 * results
    if kind == "trace":
        nbytes += (n + m) * B * (n + 1)
    per_cell = (AFFINE_OPS_PER_CELL if mode == "affine"
                else CONST_OPS_PER_CELL)[kind]
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": per_cell * cells / INT32_OPS_PER_S * 1e3,
            "cells": cells}


def diagonal_cells(rows: int, m: int, fin) -> int:
    """The cells (i, j), 1 <= i <= rows and 1 <= j <= m, on or before each
    pair's diagonal fin_b, summed over the pairs: what affine_score_diag's
    function needs to read out diagonal fin_b of a grid of rows x m."""
    i = np.arange(1, rows + 1, dtype=np.int64)
    f = np.asarray(fin, np.int64).reshape(-1, 1)
    return int(np.clip(f - i, 0, m).sum())


def phase_pairwise_kernels(dev: torch.device) -> list[dict]:
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import wavefront

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    gaps = {"affine": AFFINE_GAPS, "const": (CONST_GAP, 0)}

    def kernel(mode, a, b, f, with_trace):
        go, ge = gaps[mode]
        return wavefront.wavefront_align(a, b, f, sc, gap_open=go,
                                         gap_extend=ge, with_trace=with_trace,
                                         mode=mode)

    def plain(mode, a, b, f, with_trace):
        if mode == "affine":
            return wavefront.affine_wavefront_reference(
                a, b, f, sc, *AFFINE_GAPS, with_trace)
        return wavefront.const_wavefront_reference(a, b, f, sc, CONST_GAP,
                                                   with_trace)

    def compare(mode, args, with_trace):
        got = kernel(mode, *args, with_trace)
        want = plain(mode, *args, with_trace)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        return equal, err

    def plan_of(mode, kind, B, n, m):
        """trace_diag's launch plan (K2's score mode is
        affine_score_diag's)."""
        if (mode, kind) == ("affine", "score"):
            return wavefront.score_diag_launch_plan(B, n, m)
        return wavefront.trace_diag_launch_plan(
            B, n, m, mode if kind == "trace" else "const_score")

    cases, ok = [], True
    for mode in ("affine", "const"):
        for kind, B in (("trace", PAIR_B_TRACE), ("score", PAIR_B_SCORE)):
            a, b, f, dims = pair_batch(B, PAIR_LEN, PAIR_LEN,
                                       seed=B + len(mode), dev=dev)
            tr = kind == "trace"
            equal, err = compare(mode, (a, b, f), tr)
            # device memory the call allocates above its inputs, at its peak
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            out = kernel(mode, a, b, f, tr)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - before
            del out
            # trace mode: the whole padded grid; score mode: the cells on
            # or before each pair's diagonal fin_b, where the kernel stops
            cells = (B * PAIR_LEN * PAIR_LEN if tr else diagonal_cells(
                PAIR_LEN, PAIR_LEN, f.cpu().numpy()))
            bound = wavefront_bound(mode, kind, dims, PAIR_LEN, PAIR_LEN,
                                    cells=cells)
            by = "bytes" if bound["bytes"] > bound["operations"] else \
                "operations"
            cases.append({
                "mode": mode, "kind": kind, "B": B, "n": PAIR_LEN,
                "m": PAIR_LEN,
                "plan": plan_of(mode, kind, B, PAIR_LEN, PAIR_LEN),
                "equal_to_plain": equal, "max_abs_err": err,
                "ms": median_ms(lambda: kernel(mode, a, b, f, tr), runs=15,
                                inner=5),
                "plain_ms": median_ms(lambda: plain(mode, a, b, f, tr),
                                      runs=3),
                "bound_ms": bound[by], "bound_by": by,
                "cells": bound["cells"], "peak_above_inputs_bytes": peak})
            ok &= equal
        # 2 pairs of 20,000 rows against a small m: 157 strips a pair at
        # R = 4, over the most warps a pair
        a, b, f, _ = pair_batch(2, BIG_N, BIG_M, seed=3, dev=dev)
        equal, err = compare(mode, (a, b, f), True)
        cases.append({"mode": mode, "kind": "trace", "B": 2, "n": BIG_N,
                      "m": BIG_M, "plan": plan_of(mode, "trace", 2, BIG_N,
                                                  BIG_M),
                      "equal_to_plain": equal, "max_abs_err": err})
        ok &= equal
    emit({"phase": "pairwise_kernels", "tolerance": "exact", "cases": cases})
    if not ok:
        raise SystemExit("a wavefront kernel disagrees with its plain version")
    rows = []
    plan_keys = ("rows_per_lane", "warps_per_pair", "registers",
                 "spill_bytes")
    for mode, name in (("affine", "affine_wavefront"),
                       ("const", "const_wavefront")):
        trace_case, score_case, _ = [c for c in cases if c["mode"] == mode]
        rows.append({
            "name": name, "route": "cuda",
            "source": "gonomics_tpu_torch/csrc/wavefront.cu",
            "kernel": "trace_diag",
            "replaces": (f"gonomics_tpu/ops/wavefront.py:"
                         f"{94 if mode == 'affine' else 243} "
                         f"(_{mode}_kernel, pallas_call :1584)"),
            "launches": None, "tolerance": "exact",
            "equal_to_plain": all(c["equal_to_plain"] for c in cases
                                  if c["mode"] == mode),
            "max_abs_err": max(c["max_abs_err"] for c in cases
                               if c["mode"] == mode),
            "ms": trace_case["ms"], "plain_ms": trace_case["plain_ms"],
            "bound_ms": trace_case["bound_ms"],
            "bound_by": trace_case["bound_by"], "library_ms": None,
            "shape": f"trace mode, {trace_case['B']} pairs of "
                     f"{PAIR_LEN} x {PAIR_LEN}",
            "plan": {k: trace_case["plan"][k] for k in plan_keys}})
        if mode == "const":  # the affine score mode is affine_score_diag's
            rows[-1]["score_mode"] = {
                **{k: score_case[k] for k in (
                    "B", "ms", "plain_ms", "bound_ms", "bound_by")},
                "plan": {k: score_case["plan"][k] for k in plan_keys}}
    return rows


def replay_score(a, b, route, scores, gap_open: int, gap_extend: int) -> int:
    """Score of a route, replayed from the cigar alone: scores[a, b] per
    match column, and gap_open + gap_extend * length per gap run (a
    linear gap g is gap_open 0, gap_extend g)."""
    from gonomics_tpu_torch.align.cigar import COL_I, COL_M

    total = i = j = 0
    for c in route:
        if c.op == COL_M:
            total += int(scores[a[i:i + c.run_length],
                                b[j:j + c.run_length]].sum())
            i += c.run_length
            j += c.run_length
        else:
            total += gap_open + gap_extend * c.run_length
            if c.op == COL_I:
                j += c.run_length
            else:
                i += c.run_length
    return total


def consumed(route) -> tuple[int, int]:
    from gonomics_tpu_torch.align.cigar import COL_D, COL_I

    return (sum(c.run_length for c in route if c.op != COL_I),
            sum(c.run_length for c in route if c.op != COL_D))


def phase_pairwise(dev: torch.device) -> dict:
    from gonomics_tpu_torch import align
    from gonomics_tpu_torch.align import pairwise
    from gonomics_tpu_torch.ops import wavefront

    H = align.HUMAN_CHIMP_TWO
    rng = np.random.default_rng(17)
    pairs = [related_pair(rng, RELATED_LEN, same_length=False)
             for _ in range(RELATED_PAIRS)]
    calls = {"affine": lambda p, **kw: align.affine_gap_batch(
                 p, H, *AFFINE_GAPS, **kw),
             "const": lambda p, **kw: align.const_gap_batch(
                 p, H, CONST_GAP, **kw)}
    gaps = {"affine": AFFINE_GAPS, "const": (0, CONST_GAP)}
    calls["affine"](pairs[:2], device=dev)  # warm-up
    calls["const"](pairs[:2], device=dev)

    # split of the wall: the kernel (card clock, synchronised here so
    # that the copy after it is timed alone), the copies to the host and
    # the host walks
    split = {}
    wrapped = {}

    def timed(name, fn, device_side=False):
        def run(*args, **kw):
            if device_side:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                end.synchronize()
                split[name] = split.get(name, 0.0) + start.elapsed_time(end)
                return out
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            split[name] = (split.get(name, 0.0)
                           + (time.perf_counter() - t0) * 1e3)
            return out
        return run

    for attr, name, dev_side in (("wavefront_align", "kernel_ms", True),
                                 ("_to_host", "copy_ms", False),
                                 ("_walk_affine", "walk_ms", False),
                                 ("_walk_const", "walk_ms", False)):
        wrapped[attr] = getattr(pairwise, attr)
        setattr(pairwise, attr, timed(name, wrapped[attr], dev_side))

    # the main path: launch counts from these calls only
    wavefront.affine_launches = wavefront.const_launches = 0
    wavefront.trace_diag_launches = 0
    out = {"phase": "pairwise", "pairs": len(pairs),
           "lengths": [int(min(len(a) for a, _ in pairs)),
                       int(max(max(len(a), len(b)) for a, b in pairs))]}
    results = {}
    try:
        for mode in ("affine", "const"):
            split.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[mode] = calls[mode](pairs, device=dev)
            wall = (time.perf_counter() - t0) * 1e3
            out[mode] = {"wall_ms": wall,
                         "pairs_per_s": len(pairs) / wall * 1e3,
                         **split,
                         "other_ms": wall - sum(split.values())}
    finally:
        for attr, fn in wrapped.items():
            setattr(pairwise, attr, fn)
    launches = {"affine_wavefront": wavefront.affine_launches,
                "const_wavefront": wavefront.const_launches,
                "trace_diag": wavefront.trace_diag_launches}
    out["launches"] = launches

    ok = all(v > 0 for v in launches.values())
    for mode in ("affine", "const"):
        got = results[mode]
        consumes = all(consumed(r) == (len(a), len(b))
                       for (a, b), (_, r) in zip(pairs, got))
        replays = all(replay_score(a, b, r, H, *gaps[mode]) == s
                      for (a, b), (s, r) in zip(pairs, got))
        cpu = calls[mode](pairs[:8], device="cpu")
        same_as_cpu = [(s, [(c.run_length, c.op) for c in r])
                       for s, r in got[:8]] == \
            [(s, [(c.run_length, c.op) for c in r]) for s, r in cpu]
        scores_only = calls[mode](pairs, device=dev, with_cigar=False)
        score_mode = [s for s, _ in scores_only] == [s for s, _ in got]
        out[mode].update({"routes_consume_both": consumes,
                          "routes_replay_to_score": replays,
                          "first_8_equal_cpu": same_as_cpu,
                          "score_mode_equal": score_mode})
        ok &= consumes and replays and same_as_cpu and score_mode
    emit(out)
    if not ok:
        raise SystemExit("pairwise check failed")
    return out


def phase_pairwise_cli() -> dict:
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.cli import cigar_to_bed, global_alignment

    rng = np.random.default_rng(23)
    a, b = related_pair(rng, RELATED_LEN, same_length=False)
    inputs = {"chelsea_eric": ("TTGTTATTC", "TTGTTC"),
              "related_1kb": (dna.to_string(a), dna.to_string(b))}
    result = {"phase": "pairwise_cli"}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for case, (s_a, s_b) in inputs.items():
            fa = []
            for name, seq in (("chelsea", s_a), ("eric", s_b)):
                path = os.path.join(tmp, f"{case}.{name}.fa")
                with open(path, "w") as f:
                    f.write(f">{name}\n")
                    f.writelines(seq[i:i + 60] + "\n"
                                 for i in range(0, len(seq), 60))
                fa.append(path)
            outputs = {}
            for device in ("cuda", "cpu"):
                pre = os.path.join(tmp, f"{case}.{device}")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    global_alignment.main([*fa, "-faOut", pre + ".ga.fa",
                                           "--device", device])
                    cigar_to_bed.main([*fa, "-faOut", pre + ".c2b.fa",
                                       "-insBedOut", pre + ".ins.bed",
                                       "-delBedOut", pre + ".del.bed",
                                       "--device", device])
                files = []
                for ext in (".ga.fa", ".c2b.fa", ".ins.bed", ".del.bed"):
                    with open(pre + ext, "rb") as f:
                        files.append(f.read())
                outputs[device] = [buf.getvalue().encode(), *files]
            equal = outputs["cuda"] == outputs["cpu"]
            lines = outputs["cuda"][0].decode().split("\n")
            result[case] = {"card_equals_cpu": equal,
                            "stdout_bytes": len(outputs["cuda"][0]),
                            "ins_bed_lines": outputs["cuda"][3].count(b"\n")}
            ok &= equal
            if case == "chelsea_eric":
                view_ok = lines[1:3] == ["TTGTTATTC", "TTG---TTC"]
                result[case]["view"] = lines[1:3]
                ok &= view_ok
    emit(result)
    if not ok:
        raise SystemExit("pairwise CLI output differs")
    return result


def graph_vcfs(genome: np.ndarray, seed: int) -> list:
    """Variants of a chromosome: a SNP every 1 kb and, at 5 kb past every
    10 kb, a deletion (odd tens of kb) or an insertion (even) of 1-30
    bp."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io.vcf import Vcf

    rng = np.random.default_rng(seed)
    out = []
    for p in range(1000, len(genome) - 1000, 1000):
        base = genome[p - 1:p]
        if p % 10000 == 5000:
            k = int(rng.integers(1, 31))
            if (p // 10000) % 2:
                out.append(Vcf("chr1", p, ".",
                               dna.to_string(genome[p - 1:p + k]),
                               [dna.to_string(base)], info="SVTYPE=DEL"))
            else:
                ins = rng.integers(0, 4, k).astype(np.int8)
                out.append(Vcf("chr1", p, ".", dna.to_string(base),
                               [dna.to_string(np.concatenate([base, ins]))],
                               info="SVTYPE=INS"))
        else:
            alt = (base + int(rng.integers(1, 4))) % 4
            out.append(Vcf("chr1", p, ".", dna.to_string(base),
                           [dna.to_string(alt.astype(np.int8))],
                           info="SVTYPE=SNP"))
    return out


def build_graph(G: int, seed: int):
    from gonomics_tpu_torch import graph as port_graph
    from gonomics_tpu_torch.io.fasta import Fasta

    genome = np.random.default_rng(seed).integers(0, 4, G, dtype=np.int8)
    return port_graph.variant_graph([Fasta("chr1", genome)],
                                    {"chr1": graph_vcfs(genome, seed + 1)})


def graph_reads(g, n: int, seed: int, prefix: str):
    """n reads of L bp along random paths of g (start uniform over the
    graph's bases, a random successor at every node end, so alt alleles
    and indel branches are taken), one substitution each, every other
    one reverse-complemented, every 100th random junk. Returns the reads
    (FastqBig) and each one's sampled path: the nodes its bases came from,
    in order (empty for junk)."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io.fastq import FastqBig

    rng = np.random.default_rng(seed)
    lens = np.array([len(nd.seq) for nd in g.nodes], np.int64)
    cum = np.concatenate([[0], np.cumsum(lens)])
    qual = np.full(L, 30, np.uint8)
    reads, truth = [], []
    while len(reads) < n:
        i = len(reads)
        if i % 100 == 7:
            seq, path = rng.integers(0, 4, L).astype(np.int8), []
        else:
            r = int(rng.integers(0, cum[-1]))
            start = int(np.searchsorted(cum, r, side="right")) - 1
            cur = g.nodes[start]
            parts = [cur.seq[r - cum[start]:]]
            path = [start]
            got = len(parts[0])
            while got < L and cur.next:
                cur = g.nodes[cur.next[int(rng.integers(0, len(cur.next)))].dest]
                parts.append(cur.seq)
                path.append(cur.id)
                got += len(cur.seq)
            if got < L:
                continue
            seq = np.concatenate(parts)[:L].astype(np.int8)
            p = int(rng.integers(0, L))
            seq[p] = (seq[p] + int(rng.integers(1, 4))) % 4
        if i % 2:
            seq = dna.reverse_complement(seq).astype(np.int8)
        reads.append(FastqBig(f"{prefix}{i}", seq,
                              dna.reverse_complement(seq).astype(np.int8),
                              qual))
        truth.append(path)
    return reads, truth


def check_girafs(girafs, truth: list) -> dict:
    """Mapped: a path and a score of at least 1200 (the SAM projection's
    threshold). A giraf path lists the nodes of the read's winning seed
    only (the reference's toGiraf), not those its extensions reach, so a
    read that starts a few bases before a node boundary can have its path
    start at the next node: placed counts the reads whose path nodes all
    lie on their sampled path, and the start node's presence is reported
    beside it."""
    mapped = placed = has_start = junk_pathed = 0
    for gr, path in zip(girafs, truth):
        if not path:
            junk_pathed += bool(gr.path.nodes)
            continue
        if gr.path.nodes and gr.aln_score >= 1200:
            mapped += 1
            placed += set(gr.path.nodes) <= set(path)
            has_start += path[0] in gr.path.nodes
    real = sum(bool(p) for p in truth)
    return {"mapped_frac": mapped / real, "path_on_sampled_path_frac":
            placed / real, "start_node_in_path_frac": has_start / real,
            "junk": len(truth) - real, "junk_with_path": junk_pathed}


def phase_graph(dev: torch.device) -> tuple[dict, list]:
    from gonomics_tpu_torch import native
    from gonomics_tpu_torch.graph_align import GraphAligner
    from gonomics_tpu_torch.io import giraf
    from gonomics_tpu_torch.ops import gsw_dp, wavefront

    # the reads/s and host split below are those of the native seed path
    if not native.available():
        raise SystemExit("the native host library did not build")
    t0 = time.perf_counter()
    g = build_graph(GRAPH_BP, 5)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    al = GraphAligner(g, device=dev)
    index_s = time.perf_counter() - t0
    batches = [graph_reads(g, GRAPH_BATCH, 200 + t, "g")
               for t in range(1 + GRAPH_BATCHES)]

    # each wave's jobs and its span on the card's clock, from the first
    # upload to the result copy enqueued to the host; host seeding time
    jobs, spans, seed_ms = [], [], []
    start_wave, find_seeds = al.dp.start_wave, al._find_seeds_arrays

    def timed_start_wave(*args):
        jobs.append(args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        wave = start_wave(*args)
        end.record()
        spans.append((start, end))
        return wave

    def timed_find_seeds(reads):
        t1 = time.perf_counter()
        out = find_seeds(reads)
        seed_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    al.dp.start_wave, al._find_seeds_arrays = timed_start_wave, \
        timed_find_seeds
    al.finish_batch(al.align_batch_async(batches[0][0]))  # warm-up
    warm_jobs = list(jobs)

    # the main path: launch counts from this loop only
    wavefront.local_launches = wavefront.gsw_right_launches = 0
    gsw_dp.walk_launches = 0
    jobs.clear()
    spans.clear()
    seed_ms.clear()
    finish_ms, results = [], []

    def finish(handle):
        t1 = time.perf_counter()
        out = al.finish_batch(handle)
        finish_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = deque()
        for reads, _ in batches[1:]:
            futs.append(ex.submit(finish, al.align_batch_async(reads)))
            while len(futs) > 1:
                results.extend(futs.popleft().result())
        while futs:
            results.extend(futs.popleft().result())
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    device_ms = [s.elapsed_time(e) for s, e in spans]
    launches = {"local_wavefront": wavefront.local_launches,
                "gsw_right_wavefront": wavefront.gsw_right_launches,
                "gsw_walk_pack": gsw_dp.walk_launches}
    del al.dp.start_wave, al._find_seeds_arrays

    checks = check_girafs(results, [p for _, t in batches[1:] for p in t])
    # the first 256 reads again, with the DPs' plain versions on the CPU
    cpu = copy.copy(al)
    cpu.dp = gsw_dp.GswDpBatch(al.host.scores, -600, device="cpu")
    first = batches[1][0][:256]
    same_as_cpu = ([giraf.to_string(x) for x in results[:256]]
                   == [giraf.to_string(x) for x in cpu.align_batch(first)])
    n_reads = GRAPH_BATCHES * GRAPH_BATCH
    out = {"phase": "graph", "genome_bp": GRAPH_BP, "nodes": len(g.nodes),
           "edges": sum(len(nd.next) for nd in g.nodes),
           "seed_len": al.host.seed_len, "step": al.host.step_size,
           "batches": GRAPH_BATCHES, "batch": GRAPH_BATCH, "read_len": L,
           "graph_build_s": graph_s, "index_build_s": index_s,
           "reads_per_s": n_reads / wall,
           "wall_ms_per_batch": wall * 1e3 / GRAPH_BATCHES,
           "host_seed_ms_per_batch": float(np.mean(seed_ms)),
           "waves": len(device_ms),
           "jobs_left": int(sum(len(j[0]) for j in jobs)),
           "jobs_right": int(sum(len(j[4]) for j in jobs)),
           "device_span_ms_per_batch": sum(device_ms) / GRAPH_BATCHES,
           "device_span_share": sum(device_ms) / (wall * 1e3),
           "host_finish_ms_per_batch": float(np.mean(finish_ms)),
           "dims": {"left": list(al.dp._dims["left"]),
                    "right": list(al.dp._dims["right"])},
           "native_host_library": native.available(),
           "first_256_equal_cpu": same_as_cpu, "launches": launches,
           **checks}
    emit(out)
    if not (checks["mapped_frac"] >= 0.99
            and checks["path_on_sampled_path_frac"] >= 0.99
            and checks["junk_with_path"] == 0 and same_as_cpu
            and all(v > 0 for v in launches.values())):
        raise SystemExit("graph check failed")
    return out, warm_jobs


def stack_jobs(waves: list, side: int, count: int, dims: list):
    """The first `count` jobs of one side (0 left, 4 right) over the
    recorded waves, padded with code 4 to the widest wave or to the main
    path's final sticky dims, whichever is wider."""
    n = max([dims[0]] + [w[side].shape[1] for w in waves])
    m = max([dims[1]] + [w[side + 1].shape[1] for w in waves])
    al, be = [], []
    for w in waves:
        a, b = w[side], w[side + 1]
        al.append(np.pad(a, ((0, 0), (0, n - a.shape[1])), constant_values=4))
        be.append(np.pad(b, ((0, 0), (0, m - b.shape[1])), constant_values=4))
    nv = np.concatenate([np.asarray(w[side + 2], np.int32) for w in waves])
    mv = np.concatenate([np.asarray(w[side + 3], np.int32) for w in waves])
    return (np.concatenate(al)[:count], np.concatenate(be)[:count],
            nv[:count], mv[:count])


def graph_dp_bound(kind: str, nv: np.ndarray, mv: np.ndarray, n: int,
                   m: int, corner: bool = True) -> dict:
    """Least time of one graph DP call. bytes: the inputs read once and
    the outputs written once, the trace whole as the contract has it (C
    (n+m) S bytes, most of them its constant), at the memory rate;
    operations: the cells whose values the contract needs at the int32
    rate (K4 each job's own n_b x m_b cells; K5 its padded rectangle, n x m
    interior cells and n + m edge cells a job, since the trace there is
    part of the contract, with the row's best updated on the job's own
    cells only). The job-cells figure (the trace as each job's own cells,
    the operations of those cells) is what a DP fused with its walk could
    reach."""
    C = len(nv)
    cells = int((nv.astype(np.int64) * mv).sum())
    rows = 3 if kind == "local" and corner else 2   # bv, bd (and corner)
    inputs = C * (n + m) + 8 * C + 100 + rows * 4 * C * (n + 1)
    nbytes = inputs + C * (n + m) * (n + 1)
    job_ops = (LOCAL_OPS_PER_CELL * cells if kind == "local" else
               RIGHT_OPS_PER_CELL * cells + int((nv + mv).sum()))
    ops = (job_ops if kind == "local" else
           C * ((RIGHT_OPS_PER_CELL - BEST_OPS_PER_CELL) * n * m + n + m)
           + BEST_OPS_PER_CELL * cells)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return {"bytes": t_bytes, "operations": t_ops, "cells": cells,
            "bound_job_cells_ms": max((inputs + cells) / HBM_BYTES_PER_S,
                                      job_ops / INT32_OPS_PER_S) * 1e3}


def walk_bound(left_rows, right_rows, steps: int, S_r: int) -> dict:
    """Least time of one wave's two walk-packs: the trace cells the walks
    read (`steps`: one a move, plus the cell a left walk stops on), the
    values they need (one corner a left job, all bv lanes and one bd a
    right job), the rows written; the operations of those steps and of
    the right side's first-max."""
    C_l, C_r = len(left_rows), len(right_rows)
    nbytes = (C_l * (4 + 8) + C_r * (4 * S_r + 4) + steps
              + left_rows.size + right_rows.size)
    ops = (GSW_WALK_OPS_PER_STEP * steps
           + GSW_ARGMAX_OPS_PER_LANE * C_r * S_r)
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "operations": ops / INT32_OPS_PER_S * 1e3, "steps": steps}


def wide_window_jobs(left: bool, dev):
    """GRAPH_WIDE_C jobs of a GRAPH_WIDE_N-base window: read parts copied
    from the window's end (left jobs) or start (right jobs) with a SNP,
    the second job shorter on both sides."""
    n, m, C = GRAPH_WIDE_N, GRAPH_WIDE_M, GRAPH_WIDE_C
    rng = np.random.default_rng(41)
    al = rng.integers(0, 4, (C, n)).astype(np.int8)
    be = np.ascontiguousarray(al[:, -m:] if left else al[:, :m])
    be[:, m // 2] = (be[:, m // 2] + 1) % 4
    nv = np.array([n, n - 700], np.int32)
    mv = np.array([m, m - 2], np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (al, be, nv, mv))


def block_design_jobs(left: bool, dev):
    """GRAPH_BLOCK_C jobs of a GRAPH_BLOCK_N-base window and read parts of
    GRAPH_BLOCK_M bases, past the warp design's reach: read parts copied
    from the window's end (left jobs) or start (right jobs) with a SNP
    every 50 bases, every other job shorter on both sides."""
    n, m, C = GRAPH_BLOCK_N, GRAPH_BLOCK_M, GRAPH_BLOCK_C
    rng = np.random.default_rng(43)
    al = rng.integers(0, 4, (C, n)).astype(np.int8)
    be = np.ascontiguousarray(al[:, -m:] if left else al[:, :m])
    be[:, 25::50] = (be[:, 25::50] + 1) % 4
    nv = np.where(np.arange(C) % 2, n - 100, n).astype(np.int32)
    mv = np.where(np.arange(C) % 2, m - 40, m).astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (al, be, nv, mv))


def phase_graph_kernels(dev: torch.device, waves: list,
                        dims: dict) -> list[dict]:
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import gsw_dp, wavefront

    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    sides = {}
    for name, side in (("left", 0), ("right", 4)):
        al, be, nv, mv = stack_jobs(waves, side, GRAPH_JOBS, dims[name])
        sides[name] = (nv, mv, al.shape[1], be.shape[1],
                       tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                             for x in (al, be, nv, mv)))

    def equal_err(got, want):
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        return equal, err

    nv_l, mv_l, n_l, m_l, left = sides["left"]
    nv_r, mv_r, n_r, m_r, right = sides["right"]
    local = lambda: wavefront.local_wavefront(*left, sc, GAP, True)  # noqa: E731
    local_plain = lambda: wavefront.local_wavefront_reference(  # noqa: E731
        *left, sc, GAP, True)
    rdp = lambda: wavefront.gsw_right_wavefront(*right, sc, GAP)  # noqa: E731
    rdp_plain = lambda: wavefront.gsw_right_wavefront_reference(  # noqa: E731
        *right, sc, GAP)
    lres, rres = local_plain(), rdp_plain()
    _, _, ltrace, corner = lres
    bv, bd, rtrace = rres

    def walks(fn):
        return (fn("left", ltrace, corner, None, left[2], left[3]),
                fn("right", rtrace, bv, bd))

    wplain = walks(gsw_dp.gsw_walk_pack_reference)
    # the cells the walks read and the tiles the kernel loads, from the
    # plain walks' paths
    paths = [gsw_dp.walk_rounds("left", ltrace, corner, None, left[2],
                                left[3]),
             gsw_dp.walk_rounds("right", rtrace, bv, bd)]
    walk_steps = int(sum(st.sum() for st, _ in paths))
    walk_path = {"max_steps": max(int(st.max()) for st, _ in paths),
                 "rounds": max(int(rd.max()) for _, rd in paths),
                 "rounds_total": int(sum(rd.sum() for _, rd in paths)),
                 "max_steps_by_side": [int(st.max()) for st, _ in paths],
                 "rounds_by_side": [int(rd.max()) for _, rd in paths]}
    cases = {
        "local_wavefront": (local, local_plain,
                            graph_dp_bound("local", nv_l, mv_l, n_l, m_l)),
        "gsw_right_wavefront": (rdp, rdp_plain,
                                graph_dp_bound("right", nv_r, mv_r, n_r,
                                               m_r)),
        "gsw_walk_pack": (lambda: walks(gsw_dp.gsw_walk_pack),
                          lambda: walks(gsw_dp.gsw_walk_pack_reference),
                          walk_bound(wplain[0].cpu().numpy(),
                                     wplain[1].cpu().numpy(), walk_steps,
                                     n_r + 1)),
    }
    replaces = {
        "local_wavefront": "gonomics_tpu/ops/wavefront.py:179 (_local_kernel,"
                           " pallas_call :451 in wavefront_local :415)",
        "gsw_right_wavefront": "gonomics_tpu/ops/wavefront.py:289 "
                               "(_gsw_right_kernel, pallas_call :368 in "
                               "wavefront_gsw_right :348)",
        "gsw_walk_pack": "gonomics_tpu/ops/gsw_dp.py:30-157 (_walk_left, "
                         "_walk_right, _left_full, _right_full, "
                         "_pack_result: jnp glue)"}
    # K4 and K5 on the main path's jobs at their plans, then on 2 jobs of
    # a 10,300-base window (the warp design, the trace filled first) and
    # on jobs whose read part is past the warp design's reach (the block
    # design, a barrier a diagonal), each with the plan it should take
    plans = {"local_wavefront": wavefront.graph_dp_plan(len(nv_l), n_l, m_l,
                                                        "local"),
             "gsw_right_wavefront": wavefront.graph_dp_plan(
                 len(nv_r), n_r, m_r, "gsw_right")}
    ok = all(p["design"] == "warp" for p in plans.values())
    extra = {"wide_window": {}, "block_design": {}}
    # the job-cells bounds go to this phase's line only: the kernels line
    # keeps bound_ms as each kernel's one bound
    job_cells = {}
    for case, make, design in (("wide_window", wide_window_jobs, "warp"),
                               ("block_design", block_design_jobs,
                                "block")):
        for name, kind in (("local_wavefront", "local"),
                           ("gsw_right_wavefront", "gsw_right")):
            jobs = make(kind == "local", dev)
            if kind == "local":
                kernel = lambda: wavefront.local_wavefront(  # noqa: E731
                    *jobs, sc, GAP, True)
                plain = lambda: wavefront.local_wavefront_reference(  # noqa: E731
                    *jobs, sc, GAP, True)
            else:
                kernel = lambda: wavefront.gsw_right_wavefront(  # noqa: E731
                    *jobs, sc, GAP)
                plain = lambda: wavefront.gsw_right_wavefront_reference(  # noqa: E731
                    *jobs, sc, GAP)
            C, n = jobs[0].shape
            m = jobs[1].shape[1]
            plan = wavefront.graph_dp_plan(C, n, m, kind)
            want, plain_ms = once_ms(plain)
            equal, err = equal_err(kernel(), want)
            ok &= (equal and plan["design"] == design
                   and int(want[0].max()) > 0)
            bound = graph_dp_bound(kind, jobs[2].cpu().numpy(),
                                   jobs[3].cpu().numpy(), n, m)
            by = ("bytes" if bound["bytes"] > bound["operations"]
                  else "operations")
            extra[case][name] = {
                "jobs": C, "n": n, "m": m, "plan": plan,
                "equal_to_plain": equal, "max_abs_err": err,
                "ms": median_ms(kernel, runs=5), "plain_ms": plain_ms,
                "bound_ms": bound[by], "bound_by": by}
            job_cells[(case, name)] = bound["bound_job_cells_ms"]
    rows = []
    for name, (kernel, plain, bound) in cases.items():
        equal, err = equal_err(kernel(), plain())
        ok &= equal
        by = "bytes" if bound["bytes"] > bound["operations"] else "operations"
        rows.append({
            "name": name, "route": "cuda",
            "source": "gonomics_tpu_torch/csrc/gsw_dp.cu",
            "replaces": replaces[name], "launches": None,
            "equal_to_plain": equal, "tolerance": "exact",
            "max_abs_err": err,
            "ms": median_ms(kernel, runs=15, inner=5),
            "plain_ms": median_ms(plain, runs=3),
            "bound_ms": bound[by], "bound_by": by, "library_ms": None,
            "shape": (f"{len(nv_l)} left jobs at (n, m) = ({n_l}, {m_l}), "
                      f"{len(nv_r)} right jobs at ({n_r}, {m_r})"
                      + (": both walks" if name == "gsw_walk_pack" else "")),
            **{k: v for k, v in bound.items()
               if k not in ("bytes", "operations", "bound_job_cells_ms")}})
        if "bound_job_cells_ms" in bound:
            job_cells[("main", name)] = bound["bound_job_cells_ms"]
        if name in plans:
            rows[-1]["plan"] = plans[name]
            for case in extra:
                rows[-1][case] = extra[case][name]
        if name == "gsw_walk_pack":
            rows[-1].update(walk_path, graph_ms=graph_ms(kernel))
    emit({"phase": "graph_kernels", "tolerance": "exact",
          "kernels": [{**{k: r.get(k) for k in (
              "name", "equal_to_plain", "max_abs_err", "ms", "plain_ms",
              "bound_ms", "bound_by", "plan", "shape", "graph_ms",
              "max_steps", "rounds", "rounds_total")},
              "bound_job_cells_ms": job_cells.get(("main", r["name"]))}
              for r in rows],
          **{case: {name: {**v, "bound_job_cells_ms": job_cells[(case, name)]}
                    for name, v in by_name.items()}
             for case, by_name in extra.items()}})
    if not ok:
        raise SystemExit("a graph kernel disagrees with its plain version "
                         "or did not take its plan")
    return rows


def phase_graph_cli(dev: torch.device) -> dict:
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch import graph as port_graph
    from gonomics_tpu_torch.cli import gsw_cmd
    from gonomics_tpu_torch.io import fastq

    g = build_graph(GRAPH_CLI_BP, 9)
    single, _ = graph_reads(g, 400, 11, "s")
    r1, _ = graph_reads(g, 200, 12, "p")
    r2, _ = graph_reads(g, 200, 13, "p")
    result = {"phase": "graph_cli", "genome_bp": GRAPH_CLI_BP,
              "nodes": len(g.nodes)}
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        gg = os.path.join(tmp, "ref.gg")
        port_graph.write(gg, g)
        sizes = os.path.join(tmp, "ref.sizes")
        with open(sizes, "w") as f:
            f.write(f"chr1\t{GRAPH_CLI_BP}\n")
        paths = {}
        for name, reads in (("single", single), ("r1", r1), ("r2", r2)):
            paths[name] = os.path.join(tmp, name + ".fq")
            with open(paths[name], "w") as f:
                for r in reads:
                    f.write(f"@{r.name}\n{dna.to_string(r.seq)}\n+\n"
                            f"{fastq.qual_string(r.qual)}\n")
        t0 = time.perf_counter()
        for case, files in (("single", [paths["single"]]),
                            ("paired", [paths["r1"], paths["r2"]])):
            for fmt, extra in (("giraf", []), ("sam", ["-l", sizes])):
                out = {}
                for device in (dev.type, "cpu"):
                    path = os.path.join(tmp, f"{case}.{fmt}.{device}")
                    gsw_cmd.main(["align", gg, *files, "-o", path,
                                  "--device", device, *extra])
                    with open(path, "rb") as f:
                        out[device] = f.read()
                equal = out[dev.type] == out["cpu"]
                lines = out[dev.type].decode().splitlines()
                body = [ln for ln in lines if not ln.startswith("@")]
                result[f"{case}_{fmt}"] = {"card_equals_cpu": equal,
                                           "lines": len(body)}
                ok &= equal and len(body) == 400
        result["cli_s"] = time.perf_counter() - t0
    emit(result)
    if not ok:
        raise SystemExit("graph CLI output on the card differs from the CPU")
    return result


def lowmem_pairs():
    """bench.py's lowmem batch: LOWMEM_B random pairs of LOWMEM_LEN bases,
    drawn after its two 300 bp parity pairs from the seed-3 stream."""
    rng = np.random.default_rng(LOWMEM_SEED)
    rng.integers(0, 4, (2, 300))
    rng.integers(0, 4, (2, 300))
    shape = (LOWMEM_B, LOWMEM_LEN)
    return (rng.integers(0, 4, shape).astype(np.int8),
            rng.integers(0, 4, shape).astype(np.int8))


def block_cells(d0: int, K: int, lo_lane, n: int, m: int, W: int) -> int:
    """Interior cells (1 <= i <= n, 1 <= j <= m) of diagonals d0+1..d0+K
    on lanes [lo_lane_b, lo_lane_b + W) of each pair."""
    d = np.arange(d0 + 1, d0 + K + 1)[None, :]
    lo = np.maximum(np.maximum(1, d - m), np.asarray(lo_lane)[:, None])
    hi = np.minimum(np.minimum(d - 1, n),
                    np.asarray(lo_lane)[:, None] + W - 1)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def long_pair_blocks(dev: torch.device, sc, go: int, ge: int) -> dict:
    """affine_fwd_block and affine_bwd_window on the middle block of the
    lowmem phase's 100 kb pair (B = 1, S = 100,001 lanes, K = 4096): K6
    from the checkpoint its forward gives (a cluster whose blocks keep
    their state in a global scratch), and K7 (a window of 8,832 lanes)
    from that checkpoint and the walk's row after the blocks above it.
    Each exact against its plain version over that block, and the walk
    over K7's trace of that block."""
    from gonomics_tpu_torch.ops import wavefront

    a, b = related_pair(np.random.default_rng(37), LOWMEM_LONG,
                        same_length=False)
    alpha, beta = (torch.from_numpy(x[None]).to(dev) for x in (a, b))
    n, m, K = len(a), len(b), LOWMEM_LONG_K
    ck, cap = wavefront.lowmem_forward(alpha, beta, sc, go, ge, K)
    nb = ck.shape[0]
    mid = nb // 2
    shape = f"block {mid} of {nb} (d0 = {mid * K}), 1 pair of {n} x {m}"

    def fwd():
        return wavefront.affine_fwd_block(alpha, beta, ck[mid], mid * K,
                                          n + m, sc, go, ge, K)

    want, plain_ms = once_ms(lambda: wavefront.affine_fwd_block_reference(
        alpha, beta, ck[mid], mid * K, n + m, sc, go, ge, K))
    got = fwd()
    torch.cuda.synchronize()
    k6 = {"n": n, "m": m, "K": K, "shape": shape,
          "equal_to_plain": all(torch.equal(g, w) for g, w in zip(got, want)),
          "max_abs_err": max(int((g.to(torch.int64) - w).abs().max())
                             for g, w in zip(got, want)),
          "next_checkpoint_equal": torch.equal(want[0], ck[mid + 1]),
          "ms": median_ms(fwd, runs=3), "plain_ms": plain_ms,
          **wavefront.fwd_block_plan(1, n, dev)}
    # the walk's row at the entry of block mid
    k = wavefront._argmax3(*cap[:, :, n]).to(torch.int32)
    i = torch.full((1,), n, dtype=torch.int32, device=dev)
    j = torch.full((1,), m, dtype=torch.int32, device=dev)
    later = list(reversed(range(mid + 1, nb)))
    wavefront.lowmem_backward(i, j, k, [blk * K for blk in later],
                              [ck[blk] for blk in later], alpha, beta, sc, go,
                              ge, K)

    def bwd():
        return wavefront.affine_bwd_window(alpha, beta, ck[mid], mid * K, i,
                                           sc, go, ge, K)

    want, plain_ms = once_ms(lambda: wavefront.affine_bwd_window_reference(
        alpha, beta, ck[mid], mid * K, i, sc, go, ge, K))
    got = bwd()
    torch.cuda.synchronize()
    k7 = {"n": n, "m": m, "K": K, "shape": shape,
          "equal_to_plain": all(torch.equal(g, w) for g, w in zip(got, want)),
          "max_abs_err": max(int((g.to(torch.int64) - w).abs().max())
                             for g, w in zip(got, want)),
          "ms": median_ms(bwd, runs=5), "plain_ms": plain_ms,
          **wavefront.bwd_window_plan(1, n, K, dev)}
    # the walk over that block's trace, from the same row
    trace, wlo = want

    def walk(fn):
        return lambda: fn(trace, wlo, mid * K, i.clone(), j.clone(),
                          k.clone())

    wi, wj, wk = i.clone(), j.clone(), k.clone()
    ops_want, walk_plain_ms = once_ms(
        lambda: wavefront.lowmem_walk_block_reference(trace, wlo, mid * K,
                                                      wi, wj, wk))
    gi, gj, gk = i.clone(), j.clone(), k.clone()
    ops_got = wavefront.lowmem_walk_block(trace, wlo, mid * K, gi, gj, gk)
    torch.cuda.synchronize()
    pairs = list(zip((ops_got, gi, gj, gk), (ops_want, wi, wj, wk)))
    walk_row = {"n": n, "m": m, "K": K, "shape": shape,
                "equal_to_plain": all(torch.equal(g, w) for g, w in pairs),
                "max_abs_err": max(int((g.to(torch.int64) - w).abs().max())
                                   for g, w in pairs),
                "steps": int((ops_want < 3).sum()),
                "ms": median_ms(walk(wavefront.lowmem_walk_block), runs=5,
                                inner=5),
                "plain_ms": walk_plain_ms}
    return {"affine_fwd_block": k6, "affine_bwd_window": k7,
            "lowmem_walk_block": walk_row}


def phase_lowmem_kernels(dev: torch.device) -> list[dict]:
    """affine_fwd_block (K6), affine_bwd_window (K7) and lowmem_walk_block
    at the full-width shape, each on the block in the middle of the
    forward, from the checkpoint and walk state the main path gives it."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import wavefront

    go, ge = AFFINE_GAPS
    K, n = LOWMEM_K, LOWMEM_LEN
    m, B = n, LOWMEM_B
    alpha, beta = (torch.from_numpy(x).to(dev) for x in lowmem_pairs())
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)
    ck, cap = wavefront.lowmem_forward(alpha, beta, sc, go, ge, K)
    nb = ck.shape[0]
    mid = nb // 2
    d0 = mid * K
    # the walk's state at the entry of block mid: the backward of the
    # blocks after it
    k = wavefront._argmax3(*cap[:, :, n]).to(torch.int32)
    i = torch.full((B,), n, dtype=torch.int32, device=dev)
    j = torch.full((B,), m, dtype=torch.int32, device=dev)
    later = list(reversed(range(mid + 1, nb)))
    wavefront.lowmem_backward(i, j, k, [b * K for b in later],
                              [ck[b] for b in later], alpha, beta, sc, go, ge,
                              K)
    W = wavefront.window_width(n, K)
    walk_from = (i.clone(), j.clone(), k.clone())

    def fwd():
        return wavefront.affine_fwd_block(alpha, beta, ck[mid], d0, n + m, sc,
                                          go, ge, K)

    def fwd_plain():
        return wavefront.affine_fwd_block_reference(alpha, beta, ck[mid], d0,
                                                    n + m, sc, go, ge, K)

    def bwd():
        return wavefront.affine_bwd_window(alpha, beta, ck[mid], d0, i, sc,
                                           go, ge, K)

    def bwd_plain():
        return wavefront.affine_bwd_window_reference(alpha, beta, ck[mid], d0,
                                                     i, sc, go, ge, K)

    trace, wlo = bwd_plain()

    def walk(fn):
        # a fresh copy of the walk state each call (three 64-byte copies)
        return lambda: fn(trace, wlo, d0, *(t.clone() for t in walk_from))

    def equal_err(got, want):
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        return equal, err

    fwd_want = fwd_plain()
    checks = {"affine_fwd_block": equal_err(fwd(), fwd_want),
              "affine_bwd_window": equal_err(bwd(), (trace, wlo))}
    wi, wj, wk = (t.clone() for t in walk_from)
    ops_want = wavefront.lowmem_walk_block_reference(trace, wlo, d0, wi, wj,
                                                     wk)
    gi, gj, gk = (t.clone() for t in walk_from)
    ops_got = wavefront.lowmem_walk_block(trace, wlo, d0, gi, gj, gk)
    checks["lowmem_walk_block"] = equal_err((ops_got, gi, gj, gk),
                                            (ops_want, wi, wj, wk))
    # the forward's end state is the next checkpoint of the main path
    next_ck = torch.equal(fwd_want[0], ck[mid + 1])

    # bounds from this run's inputs: bytes each input read once and each
    # output written once, and the int32 operations the cells need
    S = n + 1
    fwd_cells = block_cells(d0, K, np.zeros(B, np.int64), n, m, S)
    fwd_bytes = B * (n + m) + 100 + 4 * 6 * B * S + 4 * (6 + 3) * B * S
    wlo_np = wlo.cpu().numpy()
    bwd_cells = block_cells(d0, K, wlo_np, n, m, W)
    # the window's part of the checkpoint, of alpha and of beta (W + K
    # columns), i; the trace and wlo
    bwd_bytes = (4 * 6 * B * W + B * W + B * (W + K) + 4 * B + 100
                 + K * B * W + 4 * B)
    steps = int((ops_want < 3).sum())
    walk_bytes = steps + K * B + 4 * 4 * B + 3 * 4 * B
    bounds = {
        "affine_fwd_block": {
            "bytes": fwd_bytes / HBM_BYTES_PER_S * 1e3,
            "operations": AFFINE_OPS_PER_CELL["score"] * fwd_cells
            / INT32_OPS_PER_S * 1e3, "cells": fwd_cells},
        "affine_bwd_window": {
            "bytes": bwd_bytes / HBM_BYTES_PER_S * 1e3,
            "operations": AFFINE_OPS_PER_CELL["trace"] * bwd_cells
            / INT32_OPS_PER_S * 1e3, "cells": bwd_cells},
        "lowmem_walk_block": {
            "bytes": walk_bytes / HBM_BYTES_PER_S * 1e3,
            "operations": LOWMEM_WALK_OPS_PER_STEP * steps
            / INT32_OPS_PER_S * 1e3, "steps": steps}}
    plan = wavefront.fwd_block_plan(B, n, dev)
    bwd_plan = wavefront.bwd_window_plan(B, n, K, dev)
    # K7 keeps its state in registers, the walk none
    smem = {"affine_fwd_block": plan["state_in_shared_memory"],
            "affine_bwd_window": None, "lowmem_walk_block": None}
    timings = {
        "affine_fwd_block": (median_ms(fwd, runs=5),
                             median_ms(fwd_plain, runs=1)),
        "affine_bwd_window": (median_ms(bwd, runs=15, inner=5),
                              median_ms(bwd_plain, runs=1)),
        "lowmem_walk_block": (
            median_ms(walk(wavefront.lowmem_walk_block), runs=15, inner=5),
            median_ms(walk(wavefront.lowmem_walk_block_reference), runs=1))}
    replaces = {
        "affine_fwd_block": "gonomics_tpu/ops/wavefront.py:895 "
                            "(_affine_fwd_chunked_kernel, pallas_call :991)",
        "affine_bwd_window": "gonomics_tpu/ops/wavefront.py:1007 "
                             "(_affine_bwd_window_kernel, pallas_call :1085)",
        "lowmem_walk_block": "gonomics_tpu/ops/wavefront.py:1102 "
                             "(_walk_block: jnp glue)"}
    rows = []
    for name, (equal, err) in checks.items():
        bound = bounds[name]
        by = "bytes" if bound["bytes"] > bound["operations"] else "operations"
        ms, plain = timings[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "gonomics_tpu_torch/csrc/wavefront.cu",
            "replaces": replaces[name], "launches": None,
            "equal_to_plain": equal, "tolerance": "exact",
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[by], "bound_by": by, "library_ms": None,
            "state_in_shared_memory": smem[name],
            "shape": (f"block {mid} of {nb} (d0 = {d0}), {B} pairs of "
                      f"{n} x {m}, K = {K}, W = {W}"),
            "bound_itemised": bound})
    # K6 and K7: one thread-block cluster a pair, their plans at this
    # shape, and their cases on the 100 kb pair (K6 a global scratch a
    # block, K7 a window of 8,832 lanes)
    long_pair = long_pair_blocks(dev, sc, go, ge)
    rows[0].update({"design": "cluster", "cluster": plan["cluster"],
                    "resident_clusters": plan["resident_clusters"],
                    "waves": plan["waves"],
                    "lanes_per_block": plan["lanes_per_block"],
                    "smem_bytes_per_block": plan["smem_bytes_per_block"],
                    "long_pair": long_pair["affine_fwd_block"]})
    rows[1].update({"design": "warp strips in a cluster", **bwd_plan,
                    "long_pair": long_pair["affine_bwd_window"]})
    rows[2].update({"design": "a tile at a time",
                    "long_pair": long_pair["lowmem_walk_block"]})
    emit({"phase": "lowmem_kernels", "tolerance": "exact",
          "next_checkpoint_equal": next_ck, "window_starts":
              sorted(set(wlo_np.tolist())),
          "affine_fwd_block_plan": plan,
          "affine_bwd_window_plan": bwd_plan,
          "affine_fwd_block_earlier_ms": K6_EARLIER_MS,
          "affine_fwd_block_long_pair": long_pair["affine_fwd_block"],
          "affine_bwd_window_long_pair": long_pair["affine_bwd_window"],
          "lowmem_walk_block_long_pair": long_pair["lowmem_walk_block"],
          "kernels": [{k: r[k] for k in (
              "name", "equal_to_plain", "max_abs_err", "ms", "plain_ms",
              "bound_ms", "bound_by", "state_in_shared_memory", "shape",
              "bound_itemised")} for r in rows]})
    k6_long, k7_long = (long_pair["affine_fwd_block"],
                        long_pair["affine_bwd_window"])
    if not (next_ck and all(r["equal_to_plain"] for r in rows)
            and k6_long["equal_to_plain"] and k6_long["next_checkpoint_equal"]
            and not k6_long["state_in_shared_memory"]
            and k7_long["equal_to_plain"]
            and long_pair["lowmem_walk_block"]["equal_to_plain"]
            and k7_long["window_lanes"] == wavefront.window_width(
                k7_long["n"], LOWMEM_LONG_K)):
        raise SystemExit("a lowmem kernel disagrees with its plain version")
    return rows


def phase_lowmem(dev: torch.device) -> dict:
    """The lowmem aligner on bench.py's batch (the main path of this
    slice), its gates against the full-trace kernel K2, and a 100 kb pair
    through the pairwise API."""
    from gonomics_tpu_torch import align
    from gonomics_tpu_torch.align import pairwise
    from gonomics_tpu_torch.ops import wavefront

    H = align.HUMAN_CHIMP_TWO
    go, ge = AFFINE_GAPS
    alphas, betas = lowmem_pairs()
    B, n = alphas.shape
    m = betas.shape[1]
    split = {}
    wrapped = {}

    def timed(name, fn):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            end.synchronize()
            split[name] = split.get(name, 0.0) + start.elapsed_time(end)
            return out
        return run

    for attr, name in (("lowmem_forward", "forward_ms"),
                       ("lowmem_backward", "backward_ms")):
        wrapped[attr] = getattr(wavefront, attr)
        setattr(wavefront, attr, timed(name, wrapped[attr]))
    # the main path: launch counts from this call only
    wavefront.affine_fwd_block_launches = 0
    wavefront.affine_bwd_window_launches = 0
    wavefront.lowmem_walk_launches = 0
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = wavefront.affine_gap_lowmem_batch(
            alphas, betas, H, go, ge, checkersize=LOWMEM_K, device=dev)
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        for attr, fn in wrapped.items():
            setattr(wavefront, attr, fn)
    launches = {"affine_fwd_block": wavefront.affine_fwd_block_launches,
                "affine_bwd_window": wavefront.affine_bwd_window_launches,
                "lowmem_walk_block": wavefront.lowmem_walk_launches}
    full_trace_bytes = (n + m) * B * (n + 1)
    out = {"phase": "lowmem", "pairs": B, "n": n, "m": m, "K": LOWMEM_K,
           "fwd_cluster": wavefront.fwd_block_plan(B, n, dev)["cluster"],
           "bwd_cluster": wavefront.bwd_window_plan(B, n, LOWMEM_K,
                                                    dev)["cluster"],
           "blocks": (n + m - 1) // LOWMEM_K + 1,
           "wall_ms": wall, "cells_per_s": B * n * m / wall * 1e3,
           **split, "host_ms": wall - sum(split.values()),
           "peak_device_bytes": peak,
           "full_trace_bytes": full_trace_bytes, "launches": launches}

    pairs = list(zip(alphas, betas))
    routes = [pairwise.lowmem_route(ops, i0, j0) for _, ops, i0, j0 in res]
    scores = [s for s, _, _, _ in res]
    out["routes_consume_both"] = all(
        consumed(r) == (n, m) for r in routes)
    out["routes_replay_to_score"] = all(
        replay_score(a, b, r, H, go, ge) == s
        for (a, b), r, s in zip(pairs, routes, scores))
    t0 = time.perf_counter()
    k2 = align.affine_gap_batch(pairs, H, go, ge, device=dev,
                                with_cigar=False)
    out["k2_score_mode_s"] = time.perf_counter() - t0
    out["scores_equal_k2"] = [s for s, _ in k2] == scores
    t0 = time.perf_counter()
    full = align.affine_gap_batch(pairs[:2], H, go, ge, device=dev)
    out["k2_trace_2_pairs_s"] = time.perf_counter() - t0
    out["first_2_equal_full_trace"] = [
        (s, [(c.run_length, c.op) for c in r]) for s, r in full] == [
        (s, [(c.run_length, c.op) for c in r])
        for s, r in zip(scores[:2], routes[:2])]
    del full

    # 4 related pairs of 2 kb at K = 256 (the window moves) against the CPU
    rng = np.random.default_rng(31)
    small = [related_pair(rng, LOWMEM_SMALL, same_length=True)
             for _ in range(4)]
    sa = np.stack([a for a, _ in small])
    sb = np.stack([b for _, b in small])
    on_card, on_cpu = (
        wavefront.affine_gap_lowmem_batch(sa, sb, H, go, ge,
                                          checkersize=LOWMEM_SMALL_K,
                                          device=d) for d in (dev, "cpu"))
    out["small_equal_cpu"] = all(
        (g[0], g[2], g[3]) == (w[0], w[2], w[3]) and np.array_equal(g[1], w[1])
        for g, w in zip(on_card, on_cpu))

    # one related pair of 100 kb through the pairwise API, default K
    a, b = related_pair(np.random.default_rng(37), LOWMEM_LONG,
                        same_length=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    score, route = align.affine_gap_lowmem(a, b, H, go, ge, device=dev)
    long_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    [(k2_score, _)] = align.affine_gap_batch([(a, b)], H, go, ge, device=dev,
                                             with_cigar=False)
    out["long_pair"] = {
        "n": len(a), "m": len(b), "K": LOWMEM_LONG_K, "lowmem_s": long_s,
        "k2_score_mode_s": time.perf_counter() - t0,
        "cigar_runs": len(route),
        "consumes_both": consumed(route) == (len(a), len(b)),
        "replays_to_score": replay_score(a, b, route, H, go, ge) == score,
        "score_equal_k2": score == k2_score}
    emit(out)
    lp = out["long_pair"]
    if not (all(v > 0 for v in launches.values())
            and out["routes_consume_both"] and out["routes_replay_to_score"]
            and out["scores_equal_k2"] and out["first_2_equal_full_trace"]
            and out["small_equal_cpu"] and lp["consumes_both"]
            and lp["replays_to_score"] and lp["score_equal_k2"]):
        raise SystemExit("lowmem check failed")
    return out


def stream_batch(dev):
    """bench.py's stream batch: P x B random pairs of L x L (seeds 0, 1)."""
    shape = (SCORE_P, SCORE_B, SCORE_L)
    return tuple(torch.from_numpy(np.random.default_rng(seed).integers(
        0, 4, shape).astype(np.int8)).to(dev) for seed in (0, 1))


def random_score_batch(B: int, n: int, m: int, seed: int, dev):
    """B random pairs padded to (n, m) with code 4, each of its own
    n_b x m_b (pair 0 the full widths), codes 0..4; alpha, beta, fin."""
    rng = np.random.default_rng(seed)
    nb, mb = rng.integers(1, n + 1, B), rng.integers(1, m + 1, B)
    nb[0], mb[0] = n, m
    alpha = rng.integers(0, 5, (B, n)).astype(np.int8)
    beta = rng.integers(0, 5, (B, m)).astype(np.int8)
    alpha[np.arange(n) >= nb[:, None]] = 4
    beta[np.arange(m) >= mb[:, None]] = 4
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (alpha, beta, (nb + mb).astype(np.int32)))


def phase_score_kernels(dev: torch.device) -> list[dict]:
    """affine_stream (K8) and affine_score_diag (through K9's contract and
    K2's score mode) against their plain versions at full size and on edge
    cases, exact."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import wavefront

    go, ge = AFFINE_GAPS
    sc = torch.as_tensor(HUMAN_CHIMP_TWO, dtype=torch.int32, device=dev)

    def stream(a, b):
        return wavefront.wavefront_affine_stream(
            a, b, sc, n=a.shape[2], m=b.shape[2], gap_open=go, gap_extend=ge)

    def stream_plain(a, b):
        return wavefront.affine_stream_reference(a, b, sc, go, ge)

    def blocked(a, b, f, r_rows):
        return wavefront.wavefront_align_blocked(
            a, b, f, sc, n=a.shape[1], m=b.shape[1], gap_open=go,
            gap_extend=ge, r_rows=r_rows)

    def blocked_plain(a, b, f, r_rows):
        return wavefront.affine_block_reference(a, b, f, sc, go, ge, r_rows)

    def k2_score(a, b, f):
        return wavefront.affine_wavefront(a, b, f, sc, go, ge, False)

    def k2_score_plain(a, b, f):
        return wavefront.affine_wavefront_reference(a, b, f, sc, go, ge,
                                                    False)

    def check(kernel, plain, args) -> dict:
        """The kernel against its plain version; the plain call timed."""
        got = kernel(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain(*args)
        end.record()
        end.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        return {"equal_to_plain": torch.equal(got, want), "max_abs_err": err,
                "plain_ms": start.elapsed_time(end)}

    L, P, B, R = SCORE_L, SCORE_P, SCORE_B, SCORE_R
    sa, sb = stream_batch(dev)
    ba, bb, bf, dims = pair_batch(B, L, L, seed=41, dev=dev)
    # phase 7's score-mode batch
    ka, kb, kf, kdims = pair_batch(PAIR_B_SCORE, PAIR_LEN, PAIR_LEN,
                                   seed=PAIR_B_SCORE + len("affine"), dev=dev)
    full = {
        "affine_stream": (stream, stream_plain, (sa, sb),
                          f"{P} x {B} random pairs of {L} x {L}"),
        "affine_block": (blocked, blocked_plain, (ba, bb, bf, R),
                         f"{B} related pairs padded to {L} x {L} (n_b = "
                         f"{int(dims[:, 0].min())}-{L}, m_b = "
                         f"{int(dims[:, 1].min())}-{L}), r_rows = {R}"),
        "k2_score_mode": (k2_score, k2_score_plain, (ka, kb, kf),
                          f"{PAIR_B_SCORE} related pairs padded to "
                          f"{PAIR_LEN} x {PAIR_LEN} (n_b = "
                          f"{int(kdims[:, 0].min())}-{PAIR_LEN}, m_b = "
                          f"{int(kdims[:, 1].min())}-{PAIR_LEN})")}

    def codes(shape, seed):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            0, 5, shape).astype(np.int8)).to(dev)

    def k2_batch(B, n, m, seed, fin_of=lambda f: f):
        """random_score_batch with fin_b = fin_of(n_b + m_b)."""
        a, b, f = random_score_batch(B, max(n, 1), m, seed, dev)
        return (a[:, :n].contiguous(), b,
                fin_of(f).to(torch.int32).contiguous())

    def edges_of(n, m):
        def fin_of(f):
            f = f.clone()
            f[:4] = torch.tensor([n + m + 1, 0, 1, n + m])[:len(f)]
            return f
        return fin_of

    edges = [
        ("affine_stream", "P = 2, m even and m > n (300 x 512)",
         (codes((2, 16, 300), 51), codes((2, 16, 512), 52))),
        ("affine_stream", "n = 1 (1 x 7)",
         (codes((2, 8, 1), 53), codes((2, 8, 7), 54))),
        ("affine_stream", "n below one strip, odd m (100 x 301)",
         (codes((2, 16, 100), 58), codes((2, 16, 301), 59))),
        ("affine_stream", "m much wider than n (64 x 4096)",
         (codes((2, 4, 64), 60), codes((2, 4, 4096), 61))),
        ("affine_block", "r_rows = 384 not dividing n = 1000",
         (*random_score_batch(16, 1000, 700, 55, dev), 384)),
        ("affine_block", "n = 1, r_rows = 512",
         (*random_score_batch(4, 1, 50, 56, dev), 512)),
        ("affine_block", "r_rows + 1 = 1501 > 1024 lanes",
         (*random_score_batch(8, 3000, 300, 57, dev), 1500)),
        ("k2_score_mode", "fin_b 1-3 below n_b + m_b (300 x 200)",
         k2_batch(12, 300, 200, 62,
                  lambda f: f - 1 - torch.arange(len(f), device=dev) % 3)),
        ("k2_score_mode", "fin_b past n + m, 0, 1 and n + m (90 x 70)",
         k2_batch(6, 90, 70, 63, edges_of(90, 70))),
        ("k2_score_mode", "m < n (600 x 50)", k2_batch(8, 600, 50, 64)),
        ("k2_score_mode", "n = 0 (0 x 7)",
         k2_batch(3, 0, 7, 65, lambda f: f - 1)),
        ("k2_score_mode", "one pair of 20,000 x 300 (79 strips)",
         k2_batch(1, 20_000, 300, 66))]
    cases = []
    for name, (kernel, plain, args, what) in full.items():
        cases.append({"kernel": name, "case": "full size: " + what,
                      **check(kernel, plain, args)})
    for name, what, args in edges:
        kernel, plain = full[name][:2]
        cases.append({"kernel": name, "case": what,
                      **check(kernel, plain, args)})
    ok = all(c["equal_to_plain"] for c in cases)

    # bounds from this run's inputs: the stream's cells are P B n m;
    # affine_score_diag's are those on or before each pair's diagonal
    # fin_b, over nb r_rows padded rows for K9 and n rows for K2
    nb = -(-L // R)
    bounds = {
        "affine_stream": wavefront_bound(
            "affine", "score", np.tile([L, L], (P * B, 1)), L, L,
            results=P * B),
        "affine_block": wavefront_bound(
            "affine", "score", dims, L, L, results=nb * B * (R + 1),
            cells=diagonal_cells(nb * R, L, bf.cpu().numpy())),
        "k2_score_mode": wavefront_bound(
            "affine", "score", kdims, PAIR_LEN, PAIR_LEN,
            cells=diagonal_cells(PAIR_LEN, PAIR_LEN, kf.cpu().numpy()))}
    times = {"affine_stream": median_ms(lambda: stream(sa, sb), runs=10,
                                        inner=2),
             "affine_block": median_ms(lambda: blocked(ba, bb, bf, R),
                                       runs=10, inner=2),
             "k2_score_mode": median_ms(lambda: k2_score(ka, kb, kf),
                                        runs=10, inner=2)}
    plans = {"affine_stream": wavefront.stream_launch_plan(P * B, L, L),
             "affine_block": wavefront.score_diag_launch_plan(B, nb * R, L),
             "k2_score_mode": wavefront.score_diag_launch_plan(
                 PAIR_B_SCORE, PAIR_LEN, PAIR_LEN)}
    summary = {}
    for name, bound in bounds.items():
        by = "bytes" if bound["bytes"] > bound["operations"] else "operations"
        mine = [c for c in cases if c["kernel"] == name]
        summary[name] = {
            "shape": full[name][3], "ms": times[name],
            "plain_ms": mine[0]["plain_ms"], "bound_ms": bound[by],
            "bound_by": by, "cells": bound["cells"], "plan": plans[name],
            "equal_to_plain": all(c["equal_to_plain"] for c in mine),
            "max_abs_err": max(c["max_abs_err"] for c in mine)}
    emit({"phase": "score_kernels", "tolerance": "exact", "cases": cases,
          "kernels": summary})
    if not ok:
        raise SystemExit("a score kernel disagrees with its plain version")
    common = {"route": "cuda", "source": "gonomics_tpu_torch/csrc/wavefront.cu",
              "launches": None, "tolerance": "exact", "library_ms": None}
    row_keys = ("equal_to_plain", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "shape", "cells")
    k2 = summary["k2_score_mode"]
    return [
        {"name": "affine_stream", **common,
         "replaces": "gonomics_tpu/ops/wavefront.py:1306 "
                     "(_affine_stream_kernel, pallas_call :1507 in "
                     "wavefront_affine_stream :1449)",
         **{k: summary["affine_stream"][k] for k in row_keys}},
        {"name": "affine_score_diag", **common,
         "replaces": "gonomics_tpu/ops/wavefront.py:466 "
                     "(_affine_block_kernel, pallas_call :620 in "
                     "wavefront_align_blocked :569) and :94 (_affine_kernel's "
                     "score mode, pallas_call :1584)",
         **{k: summary["affine_block"][k] for k in row_keys},
         "equal_to_plain": (summary["affine_block"]["equal_to_plain"]
                            and k2["equal_to_plain"]),
         "max_abs_err": max(summary["affine_block"]["max_abs_err"],
                            k2["max_abs_err"]),
         "k2_score_mode": {k: k2[k] for k in (
             "shape", "ms", "plain_ms", "bound_ms", "bound_by", "cells")}}]


def phase_score(dev: torch.device) -> dict:
    """bench.py's stage_score_stream on the card: its parity gate against
    the plain versions on the CPU, one call each of K2's score mode, the
    stream (K8) and the blocked entry point (K9's contract) on the
    stream's batch (the main path of this slice, launch counts from it)
    with the gate that all three agree on every pair, their peak device
    memory, the plans of affine_score_diag (which K2's score mode and the
    blocked entry point launch), and G cells/s of each at bench.py's
    sizes."""
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO
    from gonomics_tpu_torch.ops import wavefront

    go, ge = AFFINE_GAPS
    kw = dict(gap_open=go, gap_extend=ge)

    def k2(a, b):
        n, m = a.shape[1], b.shape[1]
        fin = torch.full((a.shape[0],), n + m, dtype=torch.int32,
                         device=a.device)
        return wavefront.wavefront_align(a, b, fin, HUMAN_CHIMP_TWO,
                                         with_trace=False, **kw)[:, n]

    def k8(a, b):
        return wavefront.wavefront_affine_stream(
            a, b, HUMAN_CHIMP_TWO, n=a.shape[2], m=b.shape[2], **kw)

    def k9(a, b, r_rows):
        n, m = a.shape[1], b.shape[1]
        fin = torch.full((a.shape[0],), n + m, dtype=torch.int32,
                         device=a.device)
        res = wavefront.wavefront_align_blocked(
            a, b, fin, HUMAN_CHIMP_TWO, n=n, m=m, r_rows=r_rows, **kw)
        k = (n - 1) // r_rows
        return res[k, :, n - k * r_rows]

    # bench.py's compiled-parity gate, held against the plain versions on
    # the CPU (bench.py holds it against the numpy oracle)
    B0, L0, P0 = SCORE_B0, SCORE_L0, SCORE_P0
    rng = np.random.default_rng(5)
    a0 = torch.from_numpy(rng.integers(0, 4, (B0, L0)).astype(np.int8))
    b0 = torch.from_numpy(rng.integers(0, 5, (B0, L0)).astype(np.int8))
    als = torch.from_numpy(rng.integers(0, 4, (P0, B0, L0)).astype(np.int8))
    bes = torch.from_numpy(rng.integers(0, 5, (P0, B0, L0)).astype(np.int8))
    r0 = L0 // 3 + 8  # three blocks, the last one short
    gate = {
        "k2_b0": torch.equal(k2(a0.to(dev), b0.to(dev)).cpu(), k2(a0, b0)),
        "stream_p0": torch.equal(k8(als.to(dev), bes.to(dev)).cpu(),
                                 k8(als, bes)),
        "blocked_b0": torch.equal(k9(a0.to(dev), b0.to(dev), r0).cpu(),
                                  k9(a0, b0, r0))}

    # the main path: launch counts from these three calls only
    sa, sb = stream_batch(dev)
    P, B, L, R = SCORE_P, SCORE_B, SCORE_L, SCORE_R
    flat_a, flat_b = sa.reshape(P * B, L), sb.reshape(P * B, L)
    wavefront.affine_launches = wavefront.affine_block_launches = 0
    wavefront.affine_stream_launches = wavefront.affine_score_diag_launches = 0
    scores, peak = {}, {}
    for name, fn in (("k2", lambda: k2(flat_a, flat_b)),
                     ("stream", lambda: k8(sa, sb).reshape(-1)),
                     ("blocked", lambda: k9(flat_a, flat_b, R))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        scores[name] = fn()
        torch.cuda.synchronize()
        peak[name] = {"peak_bytes": torch.cuda.max_memory_allocated(dev),
                      "above_inputs_bytes":
                          torch.cuda.max_memory_allocated(dev) - before}
    launches = {"affine_stream": wavefront.affine_stream_launches,
                "affine_score_diag": wavefront.affine_score_diag_launches}
    wrapper_launches = {"k2_score_mode": wavefront.affine_launches,
                        "blocked": wavefront.affine_block_launches}
    agree = (torch.equal(scores["k2"], scores["stream"])
             and torch.equal(scores["k2"], scores["blocked"]))

    # G cells/s at bench.py's sizes: K2 on its B = 256 batch, the stream
    # on P x B, the blocked kernel on K2's batch
    a1, b1 = (torch.from_numpy(np.random.default_rng(s).integers(
        0, 4, (B, L)).astype(np.int8)).to(dev) for s in (2, 3))
    timed = {"k2": (lambda: k2(a1, b1), B * L * L, 15, 5),
             "stream": (lambda: k8(sa, sb), P * B * L * L, 10, 2),
             "blocked": (lambda: k9(a1, b1, R), B * L * L, 10, 2)}
    rates = {}
    for name, (fn, cells, runs, inner) in timed.items():
        ms = median_ms(fn, runs=runs, inner=inner)
        rates[name] = {"ms": ms, "cells": cells,
                       "g_cells_per_s": cells / ms / 1e6}
    nb = -(-L // R)
    plans = {"shared_batch": {
                 "k2_score_mode": wavefront.score_diag_launch_plan(P * B, L, L),
                 "blocked": wavefront.score_diag_launch_plan(P * B, nb * R, L)},
             "rates": {
                 "k2_score_mode": wavefront.score_diag_launch_plan(B, L, L),
                 "blocked": wavefront.score_diag_launch_plan(B, nb * R, L)}}
    out = {"phase": "score", "parity_gate": gate,
           "shared_batch": f"{P} x {B} random pairs of {L} x {L}",
           "all_three_agree": agree, "launches": launches,
           "wrapper_launches": wrapper_launches,
           "peak_device_memory": peak, "r_rows": R,
           "affine_score_diag_plans": plans, "rates": rates}
    emit(out)
    if not (all(gate.values()) and agree
            and all(v > 0 for v in launches.values())
            and all(v > 0 for v in wrapper_launches.values())):
        raise SystemExit("score check failed")
    return out


def hold_local_kernels(dev: torch.device, batch: tuple) -> dict:
    """local_wavefront (K4) and the local walk on one batch's inputs to
    the mesh path's device step (read_seqs, windows, n_vec, m_vec, scores,
    gap), each against its plain version on the card (exact, whole
    tensors; the walk on the plain DP's trace). These calls are not the
    path's launches."""
    from gonomics_tpu_torch.ops import gsw_dp, wavefront

    alpha, beta, nv, mv, scores = (
        torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in batch[:5])
    args = (alpha, beta, nv, mv, scores.to(torch.int32), int(batch[5]))
    want = wavefront.local_wavefront_reference(*args)
    k4_equal, k4_err = equal_err(wavefront.local_wavefront(*args), want)
    walk_args = ("local", want[2], want[0], want[1])  # trace, bv, bd
    walk_equal, walk_err = equal_err(
        (gsw_dp.gsw_walk_pack(*walk_args),),
        (gsw_dp.gsw_walk_pack_reference(*walk_args),))
    return {"shape": {"B": alpha.shape[0], "n": alpha.shape[1],
                      "m": beta.shape[1]},
            "local_wavefront": {"equal_to_plain": k4_equal,
                                "max_abs_err": k4_err},
            "local_walk_pack": {"equal_to_plain": walk_equal,
                                "max_abs_err": walk_err}}


def phase_prefix(dev: torch.device, G: int) -> dict:
    """ReadAligner(index_sharding="prefix") on the end-to-end phase's G bp
    genome with the dense index, split into PREFIX_SLICES chunks, one a
    data slice of a mesh that repeats the card (``split_index_prefix``,
    ``place_index_chunks``): the mesh phase's MESH_BATCHES batches of B
    reads of L bp, one after another, the read k-mers looked up on the
    card (``shard_seed_lookup``) and voted on the host in numpy; the wall
    of a batch split into seeding (of it: the lookup, also on the card's
    clock, and the votes), device step, wait and emit. Gates: its SAM
    equals the replicated index's on a mesh of one slice (the same loop,
    timed alike) line for line; the first MESH_CPU_READS reads equal the
    prefix path on the CPU; K4 and the local walk launched once a slice
    of each batch, and exactly equal to their plain versions on the first
    batch's inputs."""
    from gonomics_tpu_torch.io.fasta import Fasta
    from gonomics_tpu_torch.ops import banded, gsw_dp, wavefront
    from gonomics_tpu_torch.parallel import make_mesh
    from gonomics_tpu_torch.read_align import ReadAligner

    genome = np.random.default_rng(0).integers(0, 4, G, dtype=np.int8)
    t0 = time.perf_counter()
    repl = ReadAligner([Fasta("chr1", genome)], device=dev,
                       mesh=make_mesh(data=1))
    build_s = time.perf_counter() - t0
    state = repl.state()
    t0 = time.perf_counter()
    al = ReadAligner.from_state(
        state, device=dev, index_sharding="prefix",
        mesh=make_mesh(devices=["cuda:0"] * PREFIX_SLICES,
                       data=PREFIX_SLICES))
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    card_bytes = sum(t.numel() * t.element_size()
                     for ts in al._shards for t in ts)
    batches = [make_reads(genome, B, 300 + t) for t in range(MESH_BATCHES)]

    timers = {"seed": [], "lookup": [], "vote": []}
    lookup_spans, device_spans, inputs = [], [], []

    def timed(name, fn, spans=None):
        def wrapped(*args):
            if spans is not None:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t1 = time.perf_counter()
            out = fn(*args)
            if name:
                timers[name].append((time.perf_counter() - t1) * 1e3)
            if spans is not None:
                end.record()
                spans.append((start, end))
            return out
        return wrapped

    device_result = al._device_result

    def capture(*args):
        inputs.append(args)
        return device_result(*args)

    al._candidates = timed("seed", al._candidates)
    al._lookup_hits = timed("lookup", al._lookup_hits, lookup_spans)
    al._vote = timed("vote", al._vote)
    al._device_result = timed(None, capture, device_spans)

    def run(aligner) -> tuple[list, dict]:
        texts, dispatch, wait, emit_ms = [], [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for reads, _ in batches:
            t1 = time.perf_counter()
            handle = aligner.align_batch_async(reads)
            t2 = time.perf_counter()
            handle[5].numpy()  # the device result in host memory
            t3 = time.perf_counter()
            texts.append(aligner.finish_batch_lines(handle))
            t4 = time.perf_counter()
            dispatch.append((t2 - t1) * 1e3)
            wait.append((t3 - t2) * 1e3)
            emit_ms.append((t4 - t3) * 1e3)
        wall = time.perf_counter() - t0
        return texts, {"reads_per_s": len(batches) * B / wall,
                       "wall_ms_per_batch": wall * 1e3 / len(batches),
                       "host_dispatch_ms_per_batch": float(np.mean(dispatch)),
                       "wait_ms_per_batch": float(np.mean(wait)),
                       "host_emit_ms_per_batch": float(np.mean(emit_ms))}

    for aligner in (al, repl):  # warm-up
        aligner.finish_batch_lines(aligner.align_batch_async(batches[0][0]))
    for v in (*timers.values(), lookup_spans, device_spans, inputs):
        v.clear()
    # the main path: launch counts from this loop only
    wavefront.local_launches = gsw_dp.local_walk_launches = 0
    banded.fused_launches = banded.dp_launches = banded.walk_launches = 0
    texts, split = run(al)
    launches = {"local_wavefront": wavefront.local_launches,
                "local_walk_pack": gsw_dp.local_walk_launches,
                "banded_kernels": banded.fused_launches + banded.dp_launches
                + banded.walk_launches}
    lookup_card = [s.elapsed_time(e) for s, e in lookup_spans]
    device_ms = [s.elapsed_time(e) for s, e in device_spans]
    repl_texts, repl_split = run(repl)
    lines, repl_lines = ("".join(t).splitlines() for t in (texts, repl_texts))
    same = sum(a == b for a, b in zip(lines, repl_lines))
    checks = check_sam("".join(texts),
                       np.concatenate([t for _, t in batches]))
    cpu = ReadAligner.from_state(
        state, device="cpu", index_sharding="prefix",
        mesh=make_mesh(devices=["cpu"] * PREFIX_SLICES, data=PREFIX_SLICES))
    head = batches[0][0][:MESH_CPU_READS]
    cpu_text = cpu.finish_batch_lines(cpu.align_batch_async(head))
    del cpu
    card_head = "".join(texts[0].splitlines(True)[:MESH_CPU_READS])
    kernels = hold_local_kernels(dev, (*inputs[0], al.scores, al.gap))
    n_reads = MESH_BATCHES * B
    out = {"phase": "prefix", "genome_bp": G, "index": "dense",
           "index_entries": len(state["codes"]), "slices": PREFIX_SLICES,
           "batches": MESH_BATCHES, "batch": B, "read_len": L,
           "index_build_s": build_s, "index_split_place_s": split_s,
           "index_bytes_on_card": card_bytes, **split,
           "host_seed_vote_ms_per_batch": float(np.mean(timers["seed"])),
           "lookup_ms_per_batch": float(np.mean(timers["lookup"])),
           "lookup_card_ms_per_batch": float(np.mean(lookup_card)),
           # two votes a batch, one a strand
           "vote_ms_per_batch": sum(timers["vote"]) / MESH_BATCHES,
           "device_ms_per_batch": float(np.mean(device_ms)),
           "device_span_share": sum(device_ms) / (split["wall_ms_per_batch"]
                                                  * MESH_BATCHES),
           "replicated": repl_split, "launches": launches, **checks,
           "replicated_equal_lines": same, "replicated_lines": len(repl_lines),
           "cpu_reads": MESH_CPU_READS, "cpu_equal": cpu_text == card_head,
           "kernels_on_its_inputs": kernels}
    emit(out)
    if not (same == n_reads == len(lines) == len(repl_lines)
            and out["cpu_equal"] and checks["mapped_frac"] >= 0.99
            and checks["placed_frac"] >= 0.99 and checks["junk_mapped"] == 0
            and launches["local_wavefront"] == MESH_BATCHES * PREFIX_SLICES
            and launches["local_walk_pack"] == MESH_BATCHES * PREFIX_SLICES
            and launches["banded_kernels"] == 0
            and kernels["local_wavefront"]["equal_to_plain"]
            and kernels["local_walk_pack"]["equal_to_plain"]):
        raise SystemExit("prefix check failed")
    return out


# a child of the multihost phase: `python -m gonomics_tpu_torch.cli.gsw_cmd`
# run as Python runs it (runpy), then the launch counts of the mesh path's
# kernels in this process, on the last line of its standard output
MULTIHOST_CHILD = (
    "import json, runpy, sys\n"
    "from gonomics_tpu_torch.ops import gsw_dp, wavefront\n"
    "runpy.run_module('gonomics_tpu_torch.cli.gsw_cmd', run_name='__main__',"
    " alter_sys=True)\n"
    "print(json.dumps({'local_wavefront': wavefront.local_launches,"
    " 'local_walk_pack': gsw_dp.local_walk_launches}))\n")


def run_multihost(argv: list[str], nproc: int) -> dict:
    """`gsw align ... --multihost` in nproc processes of this checkout on
    the card, meeting over loopback gloo (MASTER_ADDR 127.0.0.1, a free
    port); each under MULTIHOST_TIMEOUT_S, killed past it. Raises where a
    child fails or times out; returns the wall and each child's
    launches."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_CHILD, *argv, "--multihost"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "RANK": str(r), "WORLD_SIZE": str(nproc),
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port})
        for r in range(nproc)]
    try:
        outs = [p.communicate(timeout=MULTIHOST_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        raise SystemExit("a multihost child timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, (_, err) in zip(procs, outs):
        if p.returncode != 0:
            print(err[-4000:], file=sys.stderr)
            raise SystemExit(f"a multihost child exited {p.returncode}")
    return {"wall_s": wall, "exit_codes": [p.returncode for p in procs],
            "launches": [json.loads(out.splitlines()[-1]) for out, _ in outs]}


def phase_multihost(dev: torch.device, G: int) -> dict:
    """`gsw align --engine tpu --multihost` in MULTIHOST_PROCS processes on
    the one card (each its own mesh of the card, as one process a host
    has its host's devices) on the CLI phase's genome and
    MULTIHOST_BATCHES batches of B reads of L bp, with and without
    --index-sharding prefix: each merged SAM byte-identical to one
    process's --mesh output on the same files (mapped and placed checked
    there), every child's exit code 0, K4 and the local walk launched
    once a batch over the children; then both kernels on the inputs the
    first batch gives the mesh path, exactly equal to their plain
    versions."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.cli import gsw_cmd
    from gonomics_tpu_torch.io import fasta, fastq
    from gonomics_tpu_torch.parallel import make_mesh
    from gonomics_tpu_torch.read_align import ReadAligner

    genome = cli_genome(G)
    reads, truth = make_reads(genome, MULTIHOST_BATCHES * B, 400)
    out = {"phase": "multihost", "genome_bp": G, "procs": MULTIHOST_PROCS,
           "batches": MULTIHOST_BATCHES, "batch": B, "read_len": L,
           "backend": "gloo"}
    with tempfile.TemporaryDirectory() as tmp:
        ref, fq = os.path.join(tmp, "ref.fa"), os.path.join(tmp, "reads.fq")
        s = dna.to_string(genome)
        with open(ref, "w") as f:
            f.write(">chrS\n")
            f.writelines(s[i:i + 60] + "\n" for i in range(0, len(s), 60))
        with open(fq, "w") as f:
            for r in reads:
                f.write(f"@{r.name}\n{dna.to_string(r.seq)}\n+\n"
                        f"{fastq.qual_string(r.qual)}\n")
        flags = ["--engine", "tpu", "--batch", str(B)]
        one = os.path.join(tmp, "one.sam")
        t0 = time.perf_counter()
        gsw_cmd.main(["align", ref, fq, "-o", one, *flags, "--mesh"])
        out["one_process_s"] = time.perf_counter() - t0
        with open(one, "rb") as f:
            want = f.read()
        body = "".join(ln for ln in want.decode().splitlines(True)
                       if not ln.startswith("@"))
        out.update(check_sam(body, truth))
        for name, extra in (("replicated", []),
                            ("prefix", ["--index-sharding", "prefix"])):
            merged = os.path.join(tmp, f"{name}.sam")
            got = run_multihost(["align", ref, fq, "-o", merged, *flags,
                                 *extra], MULTIHOST_PROCS)
            with open(merged, "rb") as f:
                got["byte_identical"] = f.read() == want
            out[name] = got
        al = ReadAligner(fasta.read(ref), device=dev, mesh=make_mesh(data=1))
    inputs = []
    device_result = al._device_result

    def capture(*args):
        inputs.append(args)
        return device_result(*args)

    al._device_result = capture
    al.finish_batch_lines(al.align_batch_async(reads[:B]))
    out["kernels_on_its_inputs"] = hold_local_kernels(
        dev, (*inputs[0], al.scores, al.gap))
    emit(out)
    kernels = out["kernels_on_its_inputs"]
    if not (all(out[n]["byte_identical"]
                and sum(c["local_wavefront"] for c in out[n]["launches"])
                == MULTIHOST_BATCHES
                and sum(c["local_walk_pack"] for c in out[n]["launches"])
                == MULTIHOST_BATCHES
                for n in ("replicated", "prefix"))
            and out["mapped_frac"] >= 0.99 and out["placed_frac"] >= 0.99
            and out["junk_mapped"] == 0
            and kernels["local_wavefront"]["equal_to_plain"]
            and kernels["local_walk_pack"]["equal_to_plain"]):
        raise SystemExit("multihost check failed")
    return out


def walk_read(genome: np.ndarray, start: int, L: int, kind: str, p: int,
              payload):
    """The bases and cigar of a read of L bases whose alignment starts at
    0-based start, through one deletion ("del", payload its length) or
    insertion ("ins", payload its bases) at p."""
    bases, ops = [], []
    pos = start
    while len(bases) < L:
        if pos == p and ops and kind == "del":
            ops.append(["D", payload])
            pos += payload
            continue
        if pos == p and ops and kind == "ins" and L - len(bases) > len(payload):
            bases.extend(payload.tolist())
            ops.append(["I", len(payload)])
        bases.append(int(genome[pos]))
        if ops and ops[-1][0] == "M":
            ops[-1][1] += 1
        else:
            ops.append(["M", 1])
        pos += 1
    return (np.asarray(bases[:L], np.int8),
            "".join(f"{n}{op}" for op, n in ops))


def variant_data(tmp: str, seed: int = 800):
    """ref.fa (+ .fai), exp.sam and norm.sam under tmp (see VARIANT_BP):
    coordinate-sorted paired reads (flag R1 or R2 alternately, every
    other pair on the reverse strand, mapq 60). Planted variants lie at
    least 300 bp apart, so a read holds at most one. Returns (ref, exp,
    norm, variants {0-based pos: (kind, payload)})."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io import fai

    rng = np.random.default_rng(seed)
    G, Lr = VARIANT_BP, VARIANT_L
    genome = rng.integers(0, 4, G).astype(np.int8)
    slots = np.arange(1000, G - 1000, 400)
    count = VARIANT_SNVS + VARIANT_INDELS
    pos = np.sort(rng.choice(slots, count, replace=False)
                  + rng.integers(0, 100, count))
    kinds = np.array(["snv"] * VARIANT_SNVS + ["del"] * (VARIANT_INDELS // 2)
                     + ["ins"] * (VARIANT_INDELS - VARIANT_INDELS // 2))
    rng.shuffle(kinds)
    variants = {}
    for p, kind in zip(pos.tolist(), kinds.tolist()):
        if kind == "snv":
            variants[p] = (kind, int((genome[p] + rng.integers(1, 4)) % 4))
        elif kind == "del":
            variants[p] = (kind, int(rng.integers(1, 6)))
        else:
            variants[p] = (kind, rng.integers(0, 4, int(rng.integers(1, 6)))
                           .astype(np.int8))
    ref = os.path.join(tmp, "ref.fa")
    s = dna.to_string(genome)
    with open(ref, "w") as f:
        f.write(">chrS\n")
        f.writelines(s[i:i + 60] + "\n" for i in range(0, len(s), 60))
    fai.write_index(fai.create_index(ref), ref + ".fai")
    n = G * VARIANT_DEPTH // Lr
    vpos = np.array(sorted(variants))
    ascii_ = np.frombuffer(b"ACGTN", np.uint8)
    paths = []
    for name, tumour, shift in (("exp", True, 0), ("norm", False, 3)):
        starts = (np.arange(n, dtype=np.int64) * (G - Lr - 20)) // n + shift
        seqs = genome[starts[:, None] + np.arange(Lr)]
        cigars = np.full(n, f"{Lr}M", dtype=object)
        if tumour:
            mutant = np.arange(n) % 4 != 0
            at = vpos[np.minimum(np.searchsorted(vpos, starts), len(vpos) - 1)]
            inside = mutant & (at >= starts) & (at < starts + Lr)
            for i in np.nonzero(inside)[0].tolist():
                p = int(at[i])
                kind, payload = variants[p]
                if kind == "snv":
                    seqs[i, p - starts[i]] = payload
                else:
                    seqs[i], cigars[i] = walk_read(genome, int(starts[i]), Lr,
                                                   kind, p, payload)
        err = rng.random(seqs.shape) < VARIANT_ERR
        seqs[err] = (seqs[err] + rng.integers(1, 4, int(err.sum()))) % 4
        text = ascii_[seqs]
        flags = 1 + np.where(np.arange(n) % 2 == 0, 64, 128) + np.where(
            (np.arange(n) // 2) % 2 == 1, 16, 0)
        path = os.path.join(tmp, f"{name}.sam")
        with open(path, "w") as f:
            f.write(f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chrS\tLN:{G}\n")
            f.writelines(
                f"{name}{i}\t{flags[i]}\tchrS\t{starts[i] + 1}\t60\t"
                f"{cigars[i]}\t=\t{starts[i] + 201}\t0\t"
                f"{text[i].tobytes().decode()}\t*\n" for i in range(n))
        paths.append(path)
    return ref, paths[0], paths[1], variants


def phase_variants(dev: torch.device) -> dict:
    """The variant caller's path (``callVariants``) on the seeded samples
    of ``variant_data``: (1) the port's CLI ``-i exp.sam -n norm.sam -r
    ref.fa --mesh`` on the card (``make_mesh()`` over the one card, a (1,
    1) mesh); (2) the library ``call_variants`` on a mesh that repeats the
    card 8 times (data 4 x seq 2); (3) the same call without a mesh (the
    native host counts); (4) run 1 again with ``--profile DIR``. Each
    run's wall split into load and parse (from the first file's load to
    the last's, their counts taken out), the count on the card (CUDA
    events around each ``shard_pileup_counts`` call), calling (the rest:
    the header, the reference, the prescreen, the per-site caller) and
    write. Gates: the four
    VCFs byte-identical; each sample's card counts equal to the host
    ``runs_to_counts`` tensor exactly, chromosome for chromosome; every
    planted SNV called with its alt; the profiler's trace written; every
    count made on the card."""
    from gonomics_tpu_torch import parallel, pileup
    from gonomics_tpu_torch.cli import call_variants as cv
    from gonomics_tpu_torch.io import vcf as vcfio
    from gonomics_tpu_torch.parallel import make_mesh

    out = {"phase": "variants", "chrom_bp": VARIANT_BP,
           "depth": VARIANT_DEPTH, "read_len": VARIANT_L,
           "snvs": VARIANT_SNVS, "indels": VARIANT_INDELS}
    orig = (pileup.pileup_dense_from_sam_path, parallel.shard_pileup_counts,
            vcfio.write_vcf)
    stats: dict = {}
    dense: dict = {}

    def load(path, header, min_mapq, mesh=None, nthreads=0):
        t = time.perf_counter()
        res = orig[0](path, header, min_mapq, mesh=mesh, nthreads=nthreads)
        stats["loads"].append((t, time.perf_counter()))
        dense[stats["run"]][os.path.basename(path)] = res
        return res

    def shard(mesh, *, span, n_base=13):
        fn = orig[1](mesh, span=span, n_base=n_base)

        def timed(rel, code, valid):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn(rel, code, valid)
            end.record()
            end.synchronize()
            stats["count_ms"].append(start.elapsed_time(end))
            stats["count_events"] += len(rel)
            stats["count_bytes"] += res.numel() * res.element_size()
            stats["count_devices"].add(res.device.type)
            return res
        return timed

    def write(f, record):
        t = time.perf_counter()
        orig[2](f, record)
        stats["write_s"] += time.perf_counter() - t

    def run(name: str, fn) -> dict:
        stats.clear()
        stats.update(run=name, loads=[], write_s=0.0, count_ms=[],
                     count_events=0, count_bytes=0, count_devices=set())
        dense[name] = {}
        t = time.perf_counter()
        fn()
        wall = time.perf_counter() - t
        # the files load one after another on a mesh, in threads without
        # one: their wall runs from the first load's start to the last's end
        loads = stats["loads"]
        load_s = max(e for _, e in loads) - min(b for b, _ in loads)
        count_s = sum(stats["count_ms"]) / 1e3
        return {"wall_s": wall, "load_and_parse_s": load_s - count_s,
                "count_ms": stats["count_ms"],
                "calling_s": wall - load_s - stats["write_s"],
                "write_s": stats["write_s"],
                "count_events": stats["count_events"],
                "count_tensor_bytes": stats["count_bytes"],
                "count_devices": sorted(stats["count_devices"])}

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref, exp, norm, variants = variant_data(tmp)
        out["data_s"] = time.perf_counter() - t0
        out["reads_per_sample"] = VARIANT_BP * VARIANT_DEPTH // VARIANT_L
        vcfs = [os.path.join(tmp, f"v{i}.vcf") for i in range(4)]
        prof = os.path.join(tmp, "prof")
        pileup.pileup_dense_from_sam_path = load
        parallel.shard_pileup_counts = shard
        vcfio.write_vcf = write
        try:
            argv = ["-i", exp, "-n", norm, "-r", ref, "--mesh"]
            out["cli_mesh"] = run("cli_mesh", lambda: cv.main(
                [*argv, "-o", vcfs[0]]))
            mesh8 = make_mesh(devices=[dev] * 8, data=4, seq=2)
            out["mesh_4x2"] = run("mesh_4x2", lambda: cv.call_variants(
                [exp], [norm], ref, vcfs[1], mesh=mesh8))
            out["host"] = run("host", lambda: cv.call_variants(
                [exp], [norm], ref, vcfs[2]))
            out["cli_mesh_profiled"] = run("profiled", lambda: cv.main(
                [*argv, "-o", vcfs[3], "--profile", prof]))
        finally:
            (pileup.pileup_dense_from_sam_path, parallel.shard_pileup_counts,
             vcfio.write_vcf) = orig
        texts = []
        for v in vcfs:
            with open(v, "rb") as f:
                texts.append(f.read())
        trace = os.path.join(prof, "call_variants.pt.trace.json")
        out["trace_bytes"] = (os.path.getsize(trace)
                              if os.path.exists(trace) else 0)
    out["vcf_byte_identical"] = texts[0] == texts[1] == texts[2] == texts[3]
    counts_equal = []
    for run_name in ("cli_mesh", "mesh_4x2", "profiled"):
        for f, cds in dense[run_name].items():
            host = dense["host"][f]
            counts_equal.append(sorted(cds) == sorted(host) and all(
                cds[k].lo == host[k].lo and np.array_equal(
                    cds[k].counts, host[k].counts.astype(np.int32))
                for k in cds))
    out["card_counts_equal_host"] = counts_equal
    rows = [ln.split("\t") for ln in texts[0].decode().splitlines()
            if not ln.startswith("#")]
    called = {int(r[1]): r[4].split(",") for r in rows}
    snvs = {p: a for p, (k, a) in variants.items() if k == "snv"}
    out["records"] = len(rows)
    out["snvs_called_with_alt"] = sum(
        "ACGT"[a] in called.get(p + 1, []) for p, a in snvs.items())
    indel_sites = {p for p, (k, _) in variants.items() if k != "snv"}
    out["indels_called"] = sum(p in called or p + 1 in called
                               for p in indel_sites)
    planted = {p + 1 for p in snvs} | indel_sites | {p + 1
                                                     for p in indel_sites}
    out["calls_off_planted_sites"] = sum(p not in planted for p in called)
    emit(out)
    if not (out["vcf_byte_identical"] and all(counts_equal)
            and len(counts_equal) == 6
            and out["snvs_called_with_alt"] == len(snvs)
            and out["trace_bytes"] > 0
            and all(out[r]["count_devices"] == ["cuda"]
                    and len(out[r]["count_ms"]) == 2
                    for r in ("cli_mesh", "mesh_4x2", "cli_mesh_profiled"))
            and out["host"]["count_ms"] == []):
        raise SystemExit("variants check failed")
    return out


def phase_motif_popgen(dev: torch.device) -> dict:
    """The motif scan, the AFS grid and the Wright-Fisher simulation on
    the card (device=None): the scan of a MOTIF_BP seeded sequence with N
    runs and lowercase stretches and a MOTIF_L column PWM, its first
    MOTIF_CPU_BP scores against the CPU (the same -inf windows, rtol
    1e-5); the grid on AFS_TRIPLES triples, its first AFS_CPU against the
    CPU (NaN in the same places, the rest within rtol 1e-5, atol 1e-6 and
    8 float32 ulp of lgamma(n + 1) + |F|: tests/test_torch_popgen.py);
    wright_fisher_sim(*WF_ARGS) twice from one seed, identical. Each
    timed on the card's clock."""
    import math

    from gonomics_tpu_torch import motif, popgen

    out = {"phase": "motif_popgen"}
    rng = np.random.default_rng(900)
    seq = rng.integers(0, 4, MOTIF_BP).astype(np.int8)
    for s, n in zip(rng.integers(0, MOTIF_BP - 1000, 500),
                    rng.integers(1, 1000, 500)):
        seq[s:s + n] = 4
    for s, n in zip(rng.integers(0, MOTIF_BP - 5000, 2000),
                    rng.integers(1, 5000, 2000)):
        part = seq[s:s + n]
        part[part <= 4] += 5
    pfm = rng.integers(0, 100, (4, MOTIF_L)) + 0.5
    pm = motif.PositionMatrix(id="M0", name="seeded", type="Weight",
                              mat=np.log2(pfm / pfm.sum(0) / 0.25))
    seq_dev = torch.from_numpy(seq).to(dev)
    scores, first_ms = once_ms(lambda: motif.scan_scores_device(pm, seq_dev))
    cpu = motif.scan_scores_device(pm, seq[:MOTIF_CPU_BP + MOTIF_L - 1],
                                   device="cpu").numpy()
    got = scores[:MOTIF_CPU_BP].cpu().numpy()
    fin = np.isfinite(cpu)
    out["motif"] = {
        "bp": MOTIF_BP, "columns": MOTIF_L, "device": scores.device.type,
        "windows": scores.numel(), "first_ms": first_ms,
        "ms": median_ms(lambda: motif.scan_scores_device(pm, seq_dev),
                        runs=5),
        "neg_inf_windows": int(torch.isinf(scores).sum()),
        "same_neg_inf": bool(np.array_equal(np.isfinite(got), fin)),
        "allclose_rtol_1e-5": bool(np.allclose(got[fin], cpu[fin],
                                               rtol=1e-5, atol=0)),
        "equal_to_cpu": bool(np.array_equal(got, cpu))}
    del scores, seq_dev
    n = rng.integers(2, 200, AFS_TRIPLES)
    k = (rng.random(AFS_TRIPLES) * (n - 1)).astype(np.int64) + 1
    alpha = rng.uniform(-20, 20, AFS_TRIPLES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grid, first_ms = once_ms(lambda: popgen.afs_sample_density_grid(
        n, k, alpha, grid_points=AFS_POINTS))
    peak = torch.cuda.max_memory_allocated() - base
    cpu = popgen.afs_sample_density_grid(
        n[:AFS_CPU], k[:AFS_CPU], alpha[:AFS_CPU], grid_points=AFS_POINTS,
        device="cpu").numpy()
    got = grid[:AFS_CPU].cpu().numpy()
    nan = np.isnan(cpu)
    lg = np.array([math.lgamma(float(x) + 1) for x in n[:AFS_CPU]])
    bound = (1e-6 + 1e-5 * np.abs(cpu)
             + 8 * float(np.finfo(np.float32).eps) * (lg + np.abs(cpu)))
    ratio = (np.abs(got - cpu) / bound)[~nan]
    out["afs_grid"] = {
        "triples": AFS_TRIPLES, "points": AFS_POINTS,
        "device": grid.device.type, "first_ms": first_ms,
        "ms": median_ms(lambda: popgen.afs_sample_density_grid(
            n, k, alpha, grid_points=AFS_POINTS), runs=3),
        "peak_bytes": peak, "nan": int(torch.isnan(grid).sum()),
        "same_nan": bool(np.array_equal(np.isnan(got), nan)),
        "max_err_over_bound": float(ratio.max()),
        "max_abs_err": float(np.abs(got - cpu)[~nan].max()),
        "equal_to_cpu_frac": float((got == cpu)[~nan].mean())}
    del grid
    pop, gens, sel = WF_ARGS
    a, a_ms = once_ms(lambda: popgen.wright_fisher_sim(pop, gens, s=sel,
                                                       seed=17))
    b, b_ms = once_ms(lambda: popgen.wright_fisher_sim(pop, gens, s=sel,
                                                       seed=17))
    out["wright_fisher"] = {
        "pop_size": pop, "generations": gens, "s": sel,
        "device": a.device.type, "ms": [a_ms, b_ms],
        "identical": bool(torch.equal(a, b)), "final": float(a[-1])}
    emit(out)
    m, g, w = out["motif"], out["afs_grid"], out["wright_fisher"]
    if not (m["device"] == g["device"] == w["device"] == "cuda"
            and m["same_neg_inf"] and m["allclose_rtol_1e-5"]
            and g["same_nan"] and g["max_err_over_bound"] <= 1
            and w["identical"] and a.shape == (gens,)):
        raise SystemExit("motif_popgen check failed")
    return out


def card_mesh(dev: torch.device, data: int, seq: int):
    """A (data, seq) mesh that repeats the card."""
    from gonomics_tpu_torch import parallel

    return parallel.make_mesh(devices=[dev] * (data * seq), data=data,
                              seq=seq)


def event_ms(fn):
    """fn() and its wall on the card's clock, from a synchronised start to
    its last enqueued work (several streams and host round trips
    included)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def score_batch_rows(B: int, n: int, seed: int) -> np.ndarray:
    """The n_b of random_score_batch(B, n, m, seed): its first draw."""
    nb = np.random.default_rng(seed).integers(1, n + 1, B)
    nb[0] = n
    return nb


def strip_row(dev: torch.device, alpha, beta, sc, ck, mesh) -> dict:
    """affine_fwd_strip (K6's strip mode) on the middle block of the
    lowmem batch as the (1, 4) mesh cuts it: each of its strips, in lane
    order, from the main path's checkpoint and the edge its plain left
    neighbour hands on, held against the plain version (end state, edge,
    and a capture on each pair's own diagonal inside the block, written
    into junk); an empty strip past lane n; the whole block as one strip
    forced to clusters of 2 (8,193 lanes a block: the state in a global
    scratch) against the whole block's plain forward. Timed: strip 1 (an
    edge in and out) eagerly and in a CUDA graph, its plain version once,
    the four strips one after another, and K6 on the same block."""
    from gonomics_tpu_torch import NEG, parallel
    from gonomics_tpu_torch.ops import wavefront

    go, ge = AFFINE_GAPS
    B, n = alpha.shape
    m, K = beta.shape[1], LOWMEM_K
    nb = ck.shape[0]
    mid = nb // 2
    d0 = mid * K
    strips = [(lo, hi) for _, lo, hi in parallel.seq_strips(mesh, n)]
    rng = np.random.default_rng(19)
    fin_in = torch.from_numpy(rng.integers(d0 + 1, d0 + K + 1, B).astype(
        np.int32)).to(dev)
    fin_main = torch.full((B,), n + m, dtype=torch.int32, device=dev)
    args, checks, edge = [], [], None
    for lo, hi in strips:
        st = ck[mid][..., lo:hi].contiguous()
        junk = torch.from_numpy(rng.integers(-9, 9, (3, B, hi - lo)).astype(
            np.int32)).to(dev)
        cap, cap_want = junk.clone(), junk.clone()
        got = wavefront.affine_fwd_strip(alpha, beta, st, edge, d0, fin_in,
                                         cap, lo, sc, go, ge, K)
        want = wavefront.affine_fwd_strip_reference(
            alpha, beta, st, edge, d0, fin_in, cap_want, lo, sc, go, ge, K)
        checks.append(equal_err((*got, cap), (*want, cap_want)))
        args.append((st, edge, lo, hi))
        edge = want[1]
    # an empty strip past lane n launches nothing and hands its edge on
    before = wavefront.affine_fwd_strip_launches
    empty = wavefront.affine_fwd_strip(
        alpha, beta, torch.empty((3, 2, B, 0), dtype=torch.int32, device=dev),
        edge, d0, fin_in, torch.empty((3, B, 0), dtype=torch.int32,
                                      device=dev), n + 1, sc, go, ge, K)
    empty_ok = (wavefront.affine_fwd_strip_launches == before
                and torch.equal(empty[1], edge) and empty[0].shape[3] == 0)
    # the whole block as one strip at clusters of 2: global scratch
    whole_want, whole_plain_ms = once_ms(
        lambda: wavefront.affine_fwd_block_reference(
            alpha, beta, ck[mid], d0, n + m, sc, go, ge, K)[0])
    chunk = wavefront.fwd_block_lanes(n + 1, 2)
    cap_all = torch.full((3, B, n + 1), NEG, dtype=torch.int32, device=dev)

    def whole():
        return wavefront._fwd_strip_launch(alpha, beta, ck[mid], None, d0,
                                           fin_main, cap_all, 0, sc, go, ge,
                                           K, 2)

    whole_got = whole()
    scratch = {"cluster": 2, "lanes_per_block": chunk,
               "state_in_shared_memory": wavefront.state_in_shared_memory(
                   chunk, "affine"),
               "equal_to_plain": equal_err((whole_got[0],), (whole_want,))[0],
               "ms": median_ms(whole, runs=3), "plain_ms": whole_plain_ms}
    # strip 1 on the main path's inputs: timed, and its bound
    st, e_in, lo, hi = args[1]
    w = hi - lo
    cap1 = torch.full((3, B, w), NEG, dtype=torch.int32, device=dev)

    def one():
        return wavefront.affine_fwd_strip(alpha, beta, st, e_in, d0, fin_main,
                                          cap1, lo, sc, go, ge, K)

    _, plain_ms = once_ms(lambda: wavefront.affine_fwd_strip_reference(
        alpha, beta, st, e_in, d0, fin_main, cap1.clone(), lo, sc, go, ge, K))
    caps = [torch.full((3, B, b - a), NEG, dtype=torch.int32, device=dev)
            for _, _, a, b in args]

    def four():
        for (s_, e_, a_, _), c_ in zip(args, caps):
            wavefront.affine_fwd_strip(alpha, beta, s_, e_, d0, fin_main, c_,
                                       a_, sc, go, ge, K)

    cells = block_cells(d0, K, np.full(B, lo), n, m, w)
    ops_ms = AFFINE_OPS_PER_CELL["score"] * cells / INT32_OPS_PER_S * 1e3
    # alpha and the beta bases the block's diagonals touch, the state in
    # and out, the edge in and out, the scores
    nbytes = B * (w + w + K) + 2 * 4 * 6 * B * w + 2 * 4 * 3 * B * (K + 1) \
        + 100
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    by = "bytes" if bytes_ms > ops_ms else "operations"
    plan = wavefront.fwd_block_plan(B, w, dev, strip=True)
    k6 = lambda: wavefront.affine_fwd_block(alpha, beta, ck[mid], d0, n + m,
                                            sc, go, ge, K)
    return {
        "name": "affine_fwd_strip", "route": "cuda",
        "source": "gonomics_tpu_torch/csrc/wavefront.cu",
        "replaces": "gonomics_tpu/parallel/__init__.py:323-368 (block_fwd) "
                    "and :482-537 (local): jnp glue",
        "launches": None, "equal_to_plain": all(e for e, _ in checks)
        and empty_ok and scratch["equal_to_plain"],
        "tolerance": "exact", "max_abs_err": max(err for _, err in checks),
        "ms": median_ms(one, runs=5), "graph_ms": graph_ms(one, runs=5,
                                                           inner=3),
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": by, "library_ms": None,
        "shape": (f"block {mid} of {nb} (d0 = {d0}), {B} pairs of {n} x {m}, "
                  f"K = {K}, strip 1 of {len(strips)}: lanes [{lo}, {hi})"),
        "bound_itemised": {"operations": ops_ms, "bytes": bytes_ms,
                           "cells": cells},
        "plan": plan, "strips": strips,
        "strips_equal": [e for e, _ in checks], "empty_strip_ok": empty_ok,
        "four_strips_ms": median_ms(four, runs=3),
        "affine_fwd_block_same_block_ms": median_ms(k6, runs=3),
        "global_scratch": scratch}


def phase_seq_parallel(dev: torch.device, lowmem: dict) -> tuple[dict,
                                                                 dict]:
    """The sequence-sharded aligner and the sharded pipeline step on
    meshes that repeat the card: shard_seq_affine_align on bench.py's
    lowmem batch at seq = 4 (the main path: launch counts from it) and 2,
    the 100 kb pair at seq = 2, shard_seq_affine_score on the score
    phase's 256 random pairs at seq = 4, pipeline_step at the dry run's
    shapes (4 x 2) and at 256 pairs of 1024^2 on a 2 Mbp genome (2 x 2),
    and the strip kernel's row (``strip_row``)."""
    from gonomics_tpu_torch import align, parallel
    from gonomics_tpu_torch.ops import wavefront

    H = align.HUMAN_CHIMP_TWO
    go, ge = AFFINE_GAPS
    K = LOWMEM_K
    alphas, betas = lowmem_pairs()
    B, n = alphas.shape
    m = betas.shape[1]
    alpha, beta = (torch.from_numpy(x).to(dev) for x in (alphas, betas))
    sc = torch.as_tensor(H, dtype=torch.int32, device=dev)
    want = wavefront.affine_gap_lowmem_batch(alphas, betas, H, go, ge,
                                             checkersize=K, device=dev)
    lowmem_ck, lowmem_fwd_ms = event_ms(
        lambda: wavefront.lowmem_forward(alpha, beta, sc, go, ge, K)[0])

    def same(got, ref) -> bool:
        return len(got) == len(ref) and all(
            (g[0], g[2], g[3]) == (r[0], r[2], r[3])
            and np.array_equal(g[1], r[1]) for g, r in zip(got, ref))

    out = {"phase": "seq_parallel", "pairs": B, "n": n, "m": m, "K": K,
           "lowmem_forward_ms": lowmem_fwd_ms,
           "lowmem_phase": {k: lowmem.get(k) for k in (
               "wall_ms", "forward_ms", "backward_ms",
               "peak_device_bytes")}}
    checks = {}
    main_launches = None
    for seq in SEQ_SHARDS:
        mesh = card_mesh(dev, 1, seq)
        run = parallel.shard_seq_affine_align(mesh, H, n=n, m=m, gap_open=go,
                                              gap_extend=ge, checkersize=K)
        split, wrapped = {}, {}

        def timed(name, fn):
            def call(*a, **kw):
                res, ms = event_ms(lambda: fn(*a, **kw))
                split[name] = split.get(name, 0.0) + ms
                return res
            return call

        for mod, attr, name in ((parallel, "shard_seq_forward", "forward_ms"),
                                (wavefront, "lowmem_backward",
                                 "backward_ms")):
            wrapped[(mod, attr)] = getattr(mod, attr)
            setattr(mod, attr, timed(name, wrapped[(mod, attr)]))
        wavefront.affine_fwd_strip_launches = 0
        wavefront.affine_bwd_window_launches = 0
        wavefront.lowmem_walk_launches = 0
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            res = run(alphas, betas)
            wall = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(dev)
        finally:
            for (mod, attr), fn in wrapped.items():
                setattr(mod, attr, fn)
        launches = {"affine_fwd_strip": wavefront.affine_fwd_strip_launches,
                    "affine_bwd_window": wavefront.affine_bwd_window_launches,
                    "lowmem_walk_block": wavefront.lowmem_walk_launches}
        if seq == SEQ_SHARDS[0]:
            main_launches = launches
        ck, _ = parallel.shard_seq_forward(mesh, alpha, beta, sc, go, ge, K)
        # the forward alone, three more times (the first call of a
        # process also makes its streams and the strips' plans)
        fwd_ms = [event_ms(lambda: parallel.shard_seq_forward(
            mesh, alpha, beta, sc, go, ge, K))[1] for _ in range(3)]
        checks[f"seq{seq}_equal_lowmem"] = same(res, want)
        checks[f"seq{seq}_checkpoints_equal"] = torch.equal(ck, lowmem_ck)
        out[f"seq{seq}"] = {
            "strips": [(lo, hi) for _, lo, hi in parallel.seq_strips(mesh,
                                                                      n)],
            "wall_ms": wall, "cells_per_s": B * n * m / wall * 1e3, **split,
            "host_ms": wall - sum(split.values()),
            "forward_over_lowmem_forward": split["forward_ms"] / lowmem_fwd_ms,
            "forward_repeats_ms": fwd_ms,
            "peak_device_bytes": peak, "launches": launches,
            "strip_plan": wavefront.fwd_block_plan(
                B, -(-(n + 1) // seq), dev, strip=True)}
        if seq == SEQ_SHARDS[0]:
            row = strip_row(dev, alpha, beta, sc, ck, mesh)
        del ck
    del lowmem_ck

    # the chromosome-scale case: the 100 kb related pair at seq = 2
    a, b = related_pair(np.random.default_rng(37), LOWMEM_LONG,
                        same_length=False)
    run = parallel.shard_seq_affine_align(
        card_mesh(dev, 1, 2), H, n=len(a), m=len(b), gap_open=go,
        gap_extend=ge, checkersize=LOWMEM_LONG_K)
    got, long_ms = event_ms(lambda: run(a[None], b[None]))
    ref, ref_ms = event_ms(lambda: wavefront.affine_gap_lowmem(
        a, b, H, go, ge, checkersize=LOWMEM_LONG_K, device=dev))
    checks["long_pair_equal_lowmem"] = same(got, [ref])
    out["long_pair"] = {"n": len(a), "m": len(b), "K": LOWMEM_LONG_K,
                        "seq": 2, "wall_ms": long_ms,
                        "lowmem_wall_ms": ref_ms}

    # the score variant on the score phase's 256 random pairs at seq = 4
    sa, sb, sfin = random_score_batch(SCORE_B, SCORE_L, SCORE_L, 2, dev)
    nv = torch.from_numpy(score_batch_rows(SCORE_B, SCORE_L, 2)).to(dev)
    score_fn = parallel.shard_seq_affine_score(
        card_mesh(dev, 1, SEQ_SHARDS[0]), H, n=SCORE_L, m=SCORE_L,
        gap_open=go, gap_extend=ge)
    before = wavefront.affine_fwd_strip_launches
    sgot, score_ms = event_ms(lambda: score_fn(sa, sb, sfin, nv))
    score_launches = wavefront.affine_fwd_strip_launches - before
    score_repeats = [event_ms(lambda: score_fn(sa, sb, sfin, nv))[1]
                     for _ in range(3)]
    k2, k2_ms = event_ms(lambda: wavefront.affine_wavefront(
        sa, sb, sfin, sc, go, ge, False)[torch.arange(SCORE_B, device=dev),
                                        nv.long()])
    checks["score_equal_k2"] = torch.equal(sgot, k2)
    out["score"] = {"pairs": SCORE_B, "n": SCORE_L, "m": SCORE_L,
                    "seq": SEQ_SHARDS[0], "K": parallel.SEQ_SCORE_K,
                    "ms": score_ms, "repeats_ms": score_repeats,
                    "k2_score_mode_ms": k2_ms,
                    "strip_launches": score_launches}

    # pipeline_step: the dry run's shapes on 4 x 2, then 256 pairs of
    # 1024^2 on a 2 Mbp genome on 2 x 2
    out["pipeline_step"] = {}
    for (data, seq), (Bp, L, genome_len) in (
            ((4, 2), (8, 32, 128)), ((2, 2), (PIPE_B, PIPE_L, PIPE_GENOME))):
        mesh = card_mesh(dev, data, seq)
        step = parallel.pipeline_step(mesh, n=L, m=L, genome_len=genome_len,
                                      scores=H, gap_open=go, gap_extend=ge)
        args = parallel.example_step_inputs(mesh, B=Bp, n=L, m=L,
                                            genome_len=genome_len)
        wavefront.affine_score_diag_launches = 0
        (scores, counts), ms = event_ms(lambda: step(*args))
        step_launches = wavefront.affine_score_diag_launches
        whole = wavefront.wavefront_align(*args[:3], sc, gap_open=go,
                                          gap_extend=ge, with_trace=False)
        pos, base = args[3].cpu().numpy(), args[4].cpu().numpy()
        ref = np.zeros((genome_len, 13), np.int32)
        np.add.at(ref, (pos.ravel(), base.ravel()), 1)
        key = f"{data}x{seq}"
        checks[f"pipeline_{key}_scores_equal"] = torch.equal(scores, whole)
        checks[f"pipeline_{key}_counts_equal"] = np.array_equal(
            counts.cpu().numpy(), ref)
        out["pipeline_step"][key] = {
            "pairs": Bp, "n": L, "m": L, "genome_len": genome_len,
            "ms": ms, "median_ms": median_ms(lambda: step(*args), runs=5),
            "scores_shape": list(scores.shape),
            "counts_shape": list(counts.shape),
            "affine_score_diag_launches": step_launches}
    out["launches"] = main_launches
    out["strip_row"] = {k: row[k] for k in (
        "equal_to_plain", "ms", "graph_ms", "plain_ms", "bound_ms",
        "bound_by", "four_strips_ms", "affine_fwd_block_same_block_ms",
        "global_scratch", "empty_strip_ok", "plan")}
    out["checks"] = checks
    emit(out)
    if not (all(checks.values()) and row["equal_to_plain"]
            and all(v > 0 for v in main_launches.values())
            and not row["global_scratch"]["state_in_shared_memory"]
            and out["score"]["strip_launches"] > 0
            and all(p["affine_score_diag_launches"] == data
                    for (data, _), p in zip(((4, 2), (2, 2)),
                                            out["pipeline_step"].values()))):
        raise SystemExit("seq_parallel check failed")
    return out, row


def tools_data(tmp: str, seed: int = 2200):
    """t.fa, q.fa and t_q.chain under tmp (see TOOLS_SIZES): each target
    chromosome random; its query with the planted edits; one chain a
    chromosome of the ungapped blocks between the indels, written from the
    edits. Returns (paths, planted SNPs {chrom: [(1-based pos, ref,
    alt)]}, query sequences {chrom: codes})."""
    from gonomics_tpu_torch import dna

    rng = np.random.default_rng(seed)
    snps, queries, chains, fastas = {}, {}, [], ([], [])
    for k, (name, n) in enumerate(TOOLS_SIZES):
        g = rng.integers(0, 4, n).astype(np.int8)
        step = TOOLS_INDEL_EVERY
        at = np.arange(step, n - step // 2, step)
        at = (at + rng.integers(-step // 4, step // 4 + 1, len(at))).tolist()
        sizes = rng.integers(1, 11, len(at)).tolist()
        near = np.zeros(n, bool)
        for p, size in zip(at, sizes):
            near[max(0, p - TOOLS_SNP_GAP):p + size + TOOLS_SNP_GAP] = True
        step = TOOLS_SNP_EVERY
        cand = np.arange(step // 2, n - step // 2, step)
        cand = cand + rng.integers(-step // 4, step // 4 + 1, len(cand))
        cand = cand[~near[cand]]
        q = g.copy()
        q[cand] = (g[cand] + rng.integers(1, 4, len(cand))) % 4
        parts, blocks, t0 = [], [], 0
        for i, (p, size) in enumerate(zip(at, sizes)):
            parts.append(q[t0:p])
            if i % 2:  # a deletion of the query
                blocks.append(f"{p - t0}\t{size}\t0")
                t0 = p + size
            else:  # an insertion into the query
                parts.append(rng.integers(0, 4, size).astype(np.int8))
                blocks.append(f"{p - t0}\t0\t{size}")
                t0 = p
        parts.append(q[t0:])
        blocks.append(str(n - t0))
        queries[name] = np.concatenate(parts)
        snps[name] = [(int(c) + 1, dna.to_string(g[c:c + 1]),
                       dna.to_string(q[c:c + 1])) for c in cand]
        m = len(queries[name])
        chains.append(f"chain {m} {name} {n} + 0 {n} {name} {m} + 0 {m} "
                      f"{k + 1}\n" + "\n".join(blocks) + "\n\n")
        fastas[0].append((name, g))
        fastas[1].append((name, queries[name]))
    paths = [os.path.join(tmp, f) for f in ("t.fa", "q.fa", "t_q.chain")]
    for path, records in zip(paths, fastas):
        with open(path, "w") as f:
            for name, seq in records:
                s = dna.to_string(seq)
                f.write(f">{name}\n")
                f.writelines(s[i:i + 60] + "\n" for i in range(0, len(s), 60))
    with open(paths[2], "w") as f:
        f.write("".join(chains))
    return paths, snps, queries


def tools_reads(path: str, queries: dict, n: int, seed: int) -> list[str]:
    """n reads of L bp drawn from the query chromosomes in proportion to
    their length, every other one reverse-complemented, as FASTQ; returns
    the reads' names."""
    from gonomics_tpu_torch import dna

    rng = np.random.default_rng(seed)
    names = list(queries)
    sizes = np.array([len(queries[c]) for c in names], np.float64)
    pick = rng.choice(len(names), n, p=sizes / sizes.sum())
    out = []
    with open(path, "w") as f:
        for i, ci in enumerate(pick.tolist()):
            q = queries[names[ci]]
            s = int(rng.integers(0, len(q) - L))
            seq = q[s:s + L]
            if i % 2:
                seq = dna.reverse_complement(seq)
            out.append(f"t{i}_{names[ci]}_{s}")
            f.write(f"@{out[-1]}\n{dna.to_string(seq)}\n+\n{'I' * L}\n")
    return out


def sort_sam(src: str, dst: str) -> int:
    """src's records by (reference order, position), under its header
    with SO:coordinate, as pileup and samConsensus want them; the
    unmapped last. Returns the mapped records' count."""
    head, body = [], []
    with open(src) as f:
        for line in f:
            (head if line.startswith("@") else body).append(line)
    order = {ln.split("\t")[1][3:]: i for i, ln in enumerate(head)
             if ln.startswith("@SQ")}
    rows = [ln.split("\t", 6) for ln in body]
    keys = [(order.get(r[2], len(order)), int(r[3])) for r in rows]
    head = [ln.replace("SO:unsorted", "SO:coordinate") for ln in head]
    with open(dst, "w") as f:
        f.writelines(head)
        f.writelines(body[i] for i in sorted(range(len(body)),
                                             key=keys.__getitem__))
    return sum(r[5] != "*" for r in rows)


def covered_positions(sam: str) -> dict:
    """{chrom: sorted 1-based positions} that the mapped reads of sam span
    (the aligner writes M, I, D and S: a read covers [pos, pos + its
    reference length), and its insertions lie inside that span)."""
    spans: dict = {}
    with open(sam) as f:
        for line in f:
            if line.startswith("@"):
                continue
            r = line.split("\t", 6)
            if r[5] == "*":
                continue
            ref_len = sum(int(n) for n, op in re.findall(r"(\d+)([MDN=X])",
                                                         r[5]))
            spans.setdefault(r[2], []).append((int(r[3]), ref_len))
    out = {}
    for chrom, s in spans.items():
        starts = np.array([a for a, _ in s], np.int64)
        ends = starts + np.array([b for _, b in s], np.int64)
        cover = np.zeros(int(ends.max()) + 1, np.int64)
        np.add.at(cover, starts, 1)
        np.add.at(cover, ends, -1)
        out[chrom] = np.flatnonzero(np.cumsum(cover) > 0)
    return out


def host_tools_checks(f: dict, t_fa: str) -> dict:
    """What the gates of phase_tools_cli's mergesort, bedMerge,
    bedToWig, intervalOverlap and faFormat steps read from their files
    (f: the phase's file names)."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io import fai, fasta

    def sam_parts(path):
        with open(path) as fh:
            lines = fh.readlines()
        head = [ln for ln in lines if ln.startswith("@")]
        mapped = [ln for ln in lines if not ln.startswith("@")
                  and ln.split("\t", 6)[5] != "*"]
        return head, mapped

    head_in, _ = sam_parts(f["aln.sam"])
    _, mapped_sorted = sam_parts(f["s.sam"])
    head_m, mapped_m = sam_parts(f["m.sam"])

    def bed_bases(path):
        with open(path) as fh:
            return sum(int(end) - int(start) for _, start, end, *_ in
                       (ln.split("\t") for ln in fh))

    with open(f["reads.wig"]) as fh:
        wig_values = [float(ln) for ln in fh
                      if not ln.startswith("fixedStep")]
    with open(f["hit.bed"]) as fh:
        overlap_lines = sum(1 for _ in fh)
    formatted, target = fasta.read(f["t60.fa"]), fasta.read(t_fa)
    lower = sum(int((r.seq >= dna.LOWER_A).sum()) for r in formatted)
    upper_equal = [r.name for r in formatted] == [r.name for r in target] \
        and all(np.array_equal(dna.to_upper(a.seq), b.seq)
                for a, b in zip(formatted, target))
    with open(f["m.sam"]) as fh:
        n_records = sum(1 for ln in fh if not ln.startswith("@"))
    return {
        "mergesort_chunks": -(-n_records // TOOLS_SORT_CHUNK),
        "mergesort_mapped_equal_sorted": mapped_m == mapped_sorted,
        "mergesort_header_equal_input": head_m == head_in,
        "bed_bases": bed_bases(f["aln.bed"]),
        "merged_bases": bed_bases(f["merged.bed"]),
        "wig_covered": len(wig_values), "wig_sum": sum(wig_values),
        "overlap_lines": overlap_lines,
        "fa_lower_bases": lower, "fa_upper_equals_target": upper_equal,
        "fai_equals_index": fai.read_index(f["t60.fa"] + ".fai")
        == fai.create_index(f["t60.fa"])}


def bed_rows(path: str) -> list:
    """The tab-split lines of a bed-like file."""
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh]


def fasta_tools_checks(f: dict, t_fa: str, snps: dict, depth: dict) -> dict:
    """What the gates of phase_tools_cli's fasta-tool steps read from
    their files (f: the phase's file names; depth: {(chrom, 1-based
    position): pileup depth}), beside what numpy gives from the inputs."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io import fasta

    target = fasta.read(t_fa)
    seqs = {r.name: r.seq for r in target}
    out = {}

    # faFindFast: a window is W first-query (target) bases, from column
    # cols[s] to cols[e - 1] of the alignment
    t_rec, q_rec = fasta.read(os.path.join(f["multi"], "chr1.fa"))
    t, q = t_rec.seq, q_rec.seq
    cols = np.flatnonzero(t != dna.GAP)
    bad = ((t == dna.GAP) | (q == dna.GAP) | (dna.to_upper(t) == dna.N)
           | (dna.to_upper(q) == dna.N))
    c_bad = np.concatenate(([0], np.cumsum(bad)))
    c_diff = np.concatenate(([0], np.cumsum(t != q)))
    short = bed_rows(f["ff.bed"])
    s = np.array([int(r[1]) for r in short], np.int64)
    e = np.array([int(r[2]) for r in short], np.int64)
    muts = np.array([int(r[4]) for r in short], np.int64)
    lo, hi = cols[s], cols[e - 1] + 1
    clean = c_bad[hi] == c_bad[lo]
    carried = np.array(sorted(
        p - 1 for p, _, alt in snps["chr1"] if depth.get(("chr1", p), 0)
        and dna.to_string(dna.to_upper(q[cols[p - 1]:cols[p - 1] + 1]))
        == alt), np.int64)
    with_snp = (np.searchsorted(carried, e) - np.searchsorted(carried, s)) > 0
    out["fa_find_fast"] = {
        "windows": len(short), "first_query_bases": len(cols),
        "widths_equal_window": bool((e - s == TOOLS_WINDOW).all()),
        "clean_windows": int(clean.sum()),
        "clean_muts_equal_differing": bool(np.array_equal(
            muts[clean], (c_diff[hi] - c_diff[lo])[clean])),
        "carried_snps": len(carried),
        "snp_windows": int(with_snp.sum()),
        "snp_windows_muts_min": int(muts[with_snp].min())
        if with_snp.any() else 0,
        "total_muts": int(muts.sum()),
        "long_first_five_equal_short": [r[:5] for r in bed_rows(
            f["ff_long.bed"])] == short}

    # assemblyStats and faInfo against numpy on the target's records
    contigs = []
    for seq in seqs.values():
        edges = np.flatnonzero(np.diff(np.concatenate(
            ([1], (seq == dna.N).astype(np.int8), [1]))))
        contigs += (edges[1::2] - edges[0::2]).tolist()
    contigs.sort(reverse=True)
    length = sum(contigs)
    l50 = int(np.searchsorted(np.cumsum(contigs), length // 2)) + 1
    with open(f["stats.txt"]) as fh:
        stats = dict(ln.rstrip("\n").split(": ", 1) for ln in fh)
    out["assembly_stats"] = {
        "tool": [int(stats[k]) for k in ("N50", "L50", "Number of contigs",
                                         "genomeLength")],
        "numpy": [contigs[l50 - 1], l50, len(contigs), length]}
    order = [dna.A, dna.T, dna.C, dna.G, dna.GAP, dna.N]
    want = [[name] + [str(int(x)) for x in np.bincount(
        seq, minlength=dna.NUM_BASES)[order]] for name, seq in seqs.items()]
    total = np.sum([[int(x) for x in w[1:]] for w in want], axis=0)
    want.append(["total"] + [str(int(x)) for x in total])
    out["fa_info_counts_equal"] = bed_rows(f["info.txt"])[1:] == want

    # gcContent of the planted SNPs +- TOOLS_GC_FLANK
    gc_rows = bed_rows(f["gc.bed"])
    values = []
    for c, start, end, _ in gc_rows:
        up = dna.to_upper(seqs[c][int(start):int(end)])
        acgt = int((up <= dna.T).sum())
        gc = int(((up == dna.C) | (up == dna.G)).sum())
        values.append(f"{float(gc) * 100 / float(acgt):e}")
    out["gc_content"] = {
        "lines": len(gc_rows),
        "values_equal_numpy": [r[3] for r in gc_rows] == values}

    def records(path):
        return [(r.name, r.seq) for r in fasta.read(path)]

    def same(a, b):
        return [n for n, _ in a] == [n for n, _ in b] and all(
            np.array_equal(x, y) for (_, x), (_, y) in zip(a, b))

    tgt = list(seqs.items())
    out["fa_filter_keeps_chr1"] = same(records(f["big.fa"]), tgt[:1])
    bin_files = sorted(os.listdir(f["bins"]))
    binned = [rec for name in bin_files
              for rec in records(os.path.join(f["bins"], name))]
    out["fa_bin"] = {"files": len(bin_files),
                     "each_record_once": same(
                         sorted(binned, key=lambda r: r[0]), tgt),
                     "a_file_a_record_named_after_it":
                         bin_files == sorted(c + ".fa" for c in seqs)
                         and all(same(records(os.path.join(f["bins"], n)),
                                      [(n[:-3], seqs[n[:-3]])])
                                 for n in bin_files)}
    parts = [records(os.path.join(f["multi"], c + ".fa"))
             for c in ("chr1", "chr2")]
    joined = [(n, np.concatenate([x, y]))
              for (n, x), (_, y) in zip(*parts)]
    out["cat_multi_fa_rows_joined"] = same(records(f["cat.fa"]), joined)
    out["fa_uniq_one_a_sequence"] = same(
        records(f["uniq.fa"]), [(f"{n}; {n}_copy", x) for n, x in tgt])
    return out


def fasta_strings(path: str) -> dict:
    """{name: sequence text} of a FASTA file, through the port's reader,
    as the neighbouring fasta checks read theirs."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io import fasta
    return {r.name: dna.to_string(r.seq) for r in fasta.read(path)}


def write_fasta_strings(path: str, records) -> None:
    """(name, sequence text) records to a FASTA file, through the port's
    writer."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io import fasta
    fasta.write(path, [fasta.Fasta(n, dna.from_string(x))
                       for n, x in records])


def mutant_rows(rng, base: str, n_rows: int, rate: float, gap_runs: int):
    """n_rows rows from base (an aligned row): substitutions shared by all
    at rate / 2, private ones at rate each, and gap_runs runs of 5-40
    gaps a row; the base's own gaps kept."""
    b = np.frombuffer(base.encode(), np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    shared = rng.random(len(b)) < rate / 2
    rows = []
    for _ in range(n_rows):
        r = b.copy()
        sub = (shared | (rng.random(len(b)) < rate)) & (b != ord("-"))
        r[sub] = acgt[(np.searchsorted(acgt, b[sub])
                       + rng.integers(1, 4, int(sub.sum()))) % 4]
        for _ in range(gap_runs):
            a = int(rng.integers(0, len(b) - 40))
            r[a:a + int(rng.integers(5, 41))] = ord("-")
        rows.append(r.tobytes().decode())
    return rows


def seq_recon_inputs(f: dict, t_fa: str, snps: dict, seed: int = 2203):
    """The input files of phase_tools_cli's 11.2b and reconstruction
    steps, written from the target, the planted SNPs and samConsensus's
    chr1 alignment (f: the phase's file names). Returns what their gates
    need beside those files: the bedToAminoAcid regions, the four
    reconstructSeq rows (with three blocks of all-gap columns inserted)
    and the primate and rodent rows, each as (name, row text)."""
    rng = np.random.default_rng(seed)
    target = fasta_strings(t_fa)
    meta = {}
    with open(f["snps_strand.bed"], "w") as fh:
        for i, (c, p) in enumerate((c, p) for c in snps
                                   for p, _, _ in snps[c]):
            fh.write(f"{c}\t{p - 1 - TOOLS_GC_FLANK}\t{p + TOOLS_GC_FLANK}\t"
                     f"snp{i}\t0\t{'+-'[i % 2]}\n")
    n1 = len(target["chr1"])
    widths = 3 * rng.integers(5, 120, TOOLS_AA_REGIONS)
    starts = rng.integers(0, n1 - int(widths.max()), TOOLS_AA_REGIONS)
    meta["aa_regions"] = list(zip(starts.tolist(), (starts + widths).tolist()))
    with open(f["aa.bed"], "w") as fh:
        fh.writelines(f"chr1\t{s}\t{e}\n" for s, e in meta["aa_regions"])
    with open(f["rename.txt"], "w") as fh:
        fh.write("chr1\tchrOne\n")
    # reconstructSeq: the chr1 alignment's rows and two mutants of its
    # target row, with three blocks of 25 all-gap columns inserted
    aln = fasta_strings(os.path.join(f["multi"], "chr1.fa"))
    (t_name, t_row), (q_name, q_row) = aln.items()
    rows = [t_row, q_row] + mutant_rows(rng, t_row, 2, 0.02, 8)
    cuts = sorted(rng.integers(1, len(t_row), 3).tolist())
    block = "-" * 25
    rows = [block.join([r[:cuts[0]], r[cuts[0]:cuts[1]], r[cuts[1]:cuts[2]],
                        r[cuts[2]:]]) for r in rows]
    meta["recon_rows"] = list(zip((t_name, q_name, "mutA", "mutB"), rows))
    write_fasta_strings(f["recon.fa"], meta["recon_rows"])
    with open(f["recon.nh"], "w") as fh:
        fh.write(TOOLS_RECON_TREE + "\n")
    chr2 = target["chr2"]
    meta["primate_rows"] = list(zip(
        ("hg38", "panTro6", "panPan2", "gorGor5", "ponAbe3"),
        mutant_rows(rng, chr2, 5, 0.01, 4)))
    write_fasta_strings(f["primates.fa"], meta["primate_rows"])
    meta["mouse_rows"] = list(zip(("mm10", "rn7", "criGriChoV2", "speTri2"),
                                  mutant_rows(rng, chr2, 4, 0.03, 4)))
    write_fasta_strings(f["rodents.fa"], meta["mouse_rows"])
    for name, tree in (("primates.nh", TOOLS_PRIMATE_TREE),
                       ("rodents.nh", TOOLS_MOUSE_TREE)):
        with open(f[name], "w") as fh:
            fh.write(tree + "\n")
    return meta


def agreed_columns(rows) -> tuple:
    """(the columns where every row holds one upper-case base, that base;
    the columns where every row holds a gap) of equal-length rows."""
    m = np.stack([np.frombuffer(r.encode(), np.uint8) for r in rows])
    base = np.isin(m[0], np.frombuffer(b"ACGT", np.uint8)) \
        & (m == m[0]).all(axis=0)
    return np.flatnonzero(base), m[0][base], np.flatnonzero(
        (m == ord("-")).all(axis=0))


def ancestor_checks(path: str, rows, internal: list) -> dict:
    """What a reconstruction's gates read: the output's names, its leaves
    against the input rows, and each internal node's bases at the
    columns where the rows agree on a base or are all gaps."""
    out = fasta_strings(path)
    cols, bases, gaps = agreed_columns([r for _, r in rows])
    keep = {}
    for name in internal:
        seq = np.frombuffer(out.get(name, "").encode(), np.uint8)
        same_len = len(seq) == len(rows[0][1])
        keep[name] = {
            "length_equal": same_len,
            "agreed_base_kept": same_len
            and bool((seq[cols] == bases).all()),
            "all_gap_kept": same_len and bool((seq[gaps] == ord("-")).all())}
    return {"names": list(out), "leaves": len(rows),
            "agreed_columns": len(cols),
            "all_gap_columns": len(gaps),
            "leaves_equal_input": [(n, out.get(n)) for n, _ in rows]
            == [(n, r) for n, r in rows], "nodes": keep}


def seq_recon_checks(f: dict, t_fa: str, meta: dict) -> dict:
    """What the gates of phase_tools_cli's 11.2b and reconstruction steps
    read from their files, beside what numpy gives from the inputs."""
    target = fasta_strings(t_fa)
    out = {}

    # digestGenome MboI: the cut ends are the GATC sites in order, with
    # the fragment to the record's end where ``last`` fires, one window
    # before the final one
    frags = bed_rows(f["digest.bed"])
    want, tiled, named = [], True, True
    gatc = np.frombuffer(b"GATC", np.uint8)
    for c, seq in target.items():
        n, k = len(seq), len(gatc)
        windows = np.lib.stride_tricks.sliding_window_view(
            np.frombuffer(seq.upper().encode(), np.uint8), k)
        sites = np.flatnonzero((windows == gatc).all(axis=1)).tolist()
        prev = 0
        for p in sorted(set(sites) | {n - k - 1}):
            if p == n - k - 1:
                want.append((c, prev, n))
            else:
                want.append((c, prev, p))
                prev = p
        got = [r for r in frags if r[0] == c]
        ends = [int(r[2]) for r in got]
        upto = ends.index(n) + 1 if n in ends else 0
        tiled = tiled and upto > 0 and int(got[0][1]) == 0 and all(
            int(got[j][1]) == ends[j - 1] for j in range(1, upto))
        named = named and all(r[3] == f"MboI_{c}_{j}" and r[5] == "+"
                              for j, r in enumerate(got))
    out["digest_genome"] = {
        "fragments": len(frags),
        "cut_ends_equal_numpy": [(r[0], int(r[1]), int(r[2]))
                                 for r in frags] == want,
        "tiles_each_record": tiled, "names_and_strands": named}

    # bedToFasta -revComp: numpy's slice, reverse-complemented on -
    comp = str.maketrans("ACGTacgtNn", "TGCAtgcaNn")
    got = fasta_strings(f["snps_rc.fa"])
    want = []
    for c, s, e, name, _, strand in bed_rows(f["snps_strand.bed"]):
        seq = target[c][int(s):int(e)]
        if strand == "-":
            want.append((name + "_RevComp", seq.translate(comp)[::-1]))
        else:
            want.append((name, seq))
    out["bed_to_fasta"] = {"records": len(got),
                           "equal_numpy": list(got.items()) == want}

    # bedToAminoAcid: the script's own translation of the regions
    tcag = {"T": 0, "C": 1, "A": 2, "G": 3}
    chr1 = target["chr1"].upper()
    names = []
    for s, e in meta["aa_regions"]:
        seq = chr1[s:e]
        names += [AA_NAMES[CODE_TCAG[16 * tcag[seq[i]] + 4 * tcag[seq[i + 1]]
                                     + tcag[seq[i + 2]]]]
                  for i in range(0, e - s, 3)]
    with open(f["aa.txt"]) as fh:
        aa = fh.read().split("\n")[:-1]
    out["bed_to_amino_acid"] = {"lines": len(aa), "equal_numpy": aa == names}

    # faToPredictSet: numpy's window count, each window upper-cased
    lines = bed_rows(f["predict.txt"])
    want = [[f"{c}:{j}-{j + TOOLS_PREDICT_WINDOW}",
             seq[j:j + TOOLS_PREDICT_WINDOW].upper()]
            for c, seq in target.items()
            for j in range(0, len(seq) - TOOLS_PREDICT_WINDOW,
                           TOOLS_PREDICT_STRIDE)]
    count = int(sum(max(0, -(-(len(seq) - TOOLS_PREDICT_WINDOW)
                             // TOOLS_PREDICT_STRIDE))
                    for seq in target.values()))
    out["fa_to_predict_set"] = {"lines": len(lines), "numpy_count": count,
                                "windows_equal": lines == want}

    # prcompFormat of the chr1 alignment: four columns a variable column
    # with no gap and no N, each row's one-hot
    aln = fasta_strings(os.path.join(f["multi"], "chr1.fa"))
    m = np.stack([np.frombuffer(r.upper().encode(), np.uint8)
                  for r in aln.values()])
    bad = np.isin(m, np.frombuffer(b"-N", np.uint8)).any(axis=0)
    keep = ~bad & ~(m == m[0]).all(axis=0)
    hot = {ord(b): "\t" + "\t".join("1" if b == x else "0" for x in "ACGT")
           for b in "ACGT"}
    want = [["Sample"] + [f"Var_{j}" for j in range(4 * int(keep.sum()))]]
    want += [(name + "".join(hot[int(x)] for x in row[keep])).split("\t")
             for name, row in zip(aln, m)]
    out["prcomp_format"] = {"variable_columns": int(keep.sum()),
                            "equal_numpy": bed_rows(f["prcomp.txt"]) == want}

    # findAndReplace -column 0: the SNP bed with chr1 renamed
    want = [[("chrOne" if w[0] == "chr1" else w[0])] + w[1:]
            for w in bed_rows(f["snps.bed"])]
    out["find_and_replace_equal"] = bed_rows(f["renamed.bed"]) == want

    out["reconstruct_seq"] = ancestor_checks(
        f["recon_out.fa"], meta["recon_rows"], ["root", "tq", "ab"])
    out["reconstruct_seq_sub_matrix"] = ancestor_checks(
        f["recon_sub.fa"], meta["recon_rows"], ["root", "tq", "ab"])
    out["primate_recon_hca"] = ancestor_checks(
        f["hca.fa"], meta["primate_rows"], ["hca"])
    out["primate_recon_hga"] = ancestor_checks(
        f["hga.fa"], meta["primate_rows"], ["hga"])
    out["mouse_recon"] = ancestor_checks(
        f["mra.fa"], meta["mouse_rows"], ["mra"])
    return out


def vcf_tools_checks(f: dict, t_fa: str, snps: dict, depth: dict) -> dict:
    """What the gates of phase_tools_cli's slice 11.4 and bedFormat steps
    read from their files, beside what numpy gives from the target and
    the planted SNPs (depth: {(chrom, 1-based position): pileup depth});
    none of these tools' modules is imported."""
    def records(path):
        with open(path) as fh:
            return [ln.rstrip("\n").split("\t") for ln in fh
                    if not ln.startswith("#")]

    target = fasta_strings(t_fa)
    planted = sorted((c, p, r, a) for c in snps for p, r, a in snps[c])
    out = {}
    filtered = records(f["snv.vcf"])
    out["vcf_filter"] = {
        "chain_vcf_records": len(records(f["c.vcf"])),
        "records": len(filtered),
        "equal_planted": sorted((r[0], int(r[1]), r[3], r[4])
                                for r in filtered) == planted}

    want = {c: list(s) for c, s in target.items()}
    for c, p, _, a in planted:
        want[c][p - 1] = a
    out["vcf_to_fa_equal_numpy"] = fasta_strings(f["alt.fa"]) == {
        c: "".join(s) for c, s in want.items()}

    # vcfInfo: the twelve substitution counts; each SNP's trinucleotide,
    # a top strand of C or T kept and the others reverse-complemented
    with open(f["types.txt"]) as fh:
        counts = {ln.split(":\t")[0]: int(ln.split(":\t")[1]) for ln in fh
                  if ":\t" in ln and " to " in ln}
    subs = {f"{a} to {b}": 0 for a in "ACGT" for b in "ACGT" if a != b}
    for _, _, r, a in planted:
        subs[f"{r} to {a}"] += 1
    comp = str.maketrans("ACGT", "TGCA")
    ctx = {f"{r}>{a}\t{x}{r}{y}": 0 for r in "CT" for a in "ACGT"
           if a != r for x in "ACGT" for y in "ACGT"}
    for c, p, r, a in planted:
        tri = target[c][p - 2:p + 1]
        if r in "AG":
            r, a, tri = r.translate(comp), a.translate(comp), \
                tri.translate(comp)[::-1]
        ctx[f"{r}>{a}\t{tri}"] += 1
    with open(f["context.txt"]) as fh:
        got = {ln.rsplit("\t", 1)[0]: int(ln.rsplit("\t", 1)[1])
               for ln in list(fh)[1:]}
    out["vcf_info"] = {
        "types_equal_numpy": {k: counts.get(k) for k in subs} == subs,
        "context_lines": len(got), "context_sum": sum(got.values()),
        "context_equal_numpy": got == ctx}

    # multiFaToVcf of the chr1 alignment: a record at each covered
    # planted SNP the consensus carries, every REF the target's base
    t_rec, q_rec = fasta_strings(os.path.join(f["multi"],
                                              "chr1.fa")).values()
    cols = np.flatnonzero(np.frombuffer(t_rec.encode(), np.uint8)
                          != ord("-"))
    carried = {p: a for c, p, _, a in planted if c == "chr1"
               and depth.get((c, p), 0) and q_rec[cols[p - 1]] == a}
    multi = records(f["multi.vcf"])
    at = {int(r[1]): r for r in multi}
    out["multi_fa_to_vcf"] = {
        "records": len(multi), "carried_snps": len(carried),
        "carried_with_record": sum(p in at and at[p][4] == a
                                   for p, a in carried.items()),
        "refs_equal_target": all(r[3] == target["chr1"][int(r[1]) - 1]
                                 for r in multi),
        "substitutions_only": all(len(r[3]) == len(r[4]) == 1
                                  for r in multi)}

    with open(f["snv.csv"]) as fh:
        csv = [ln.rstrip("\n") for ln in fh]
    ens = records(f["ens.vcf"])
    out["vcf_format"] = {
        "csv_lines": len(csv),
        "csv_header": csv[0].split(",")[:7] if csv else [],
        "csv_rows_equal_records": [ln.split(",")[:5] for ln in csv[1:]]
        == [r[:5] for r in filtered],
        "ensembl_chroms": sorted({r[0] for r in ens}),
        "ensembl_rest_equal": [r[1:] for r in ens]
        == [r[1:] for r in filtered]}

    sizes = dict(TOOLS_SIZES)
    with open(f["snps.bed"]) as fh:
        want_bed = [f"{c[3:]}\t{max(int(s) - 10, 0)}\t"
                    f"{min(int(e) + 10, sizes[c])}"
                    for c, s, e in (ln.split() for ln in fh)]
    with open(f["snps_pad.bed"]) as fh:
        got_bed = [ln.rstrip("\n") for ln in fh]
    out["bed_format"] = {"lines": len(got_bed),
                         "equal_numpy": got_bed == want_bed}
    return out


def wig_arrays(path: str, sizes: dict, default: float) -> dict:
    """{chrom: float64 values} of a fixed-step wig of step 1, default
    where it sets nothing."""
    out = {c: np.full(n, default) for c, n in sizes.items()}
    chrom = pos = None
    with open(path) as fh:
        for line in fh:
            if line.startswith("fixedStep"):
                kv = dict(x.split("=", 1) for x in line.split()[1:])
                chrom, pos = kv["chrom"], int(kv["start"]) - 1
            else:
                out[chrom][pos] = float(line)
                pos += 1
    return out


def go_g(x: float) -> str:
    """Go's %g of a float64: the shortest text that reads back equal."""
    s = repr(float(x))
    return s[:-2] if s.endswith(".0") else s


def merged_columns(ref_a: np.ndarray, ref_b: np.ndarray) -> tuple:
    """mergeMultiFa's columns rebuilt from the gap positions of its two
    reference rows (uint8 text, the same bases in both): for each merged
    column, the column of A and of B it takes, -1 for a gap. Between two
    bases the two rows' gap runs pair up as far as the shorter goes, the
    longer's rest stands alone, then the base; after the last base only
    the pairs."""
    a_nz = np.flatnonzero(ref_a != ord("-"))
    b_nz = np.flatnonzero(ref_b != ord("-"))
    a0, b0 = np.concatenate([[0], a_nz + 1]), np.concatenate([[0], b_nz + 1])
    ga = np.concatenate([a_nz, [len(ref_a)]]) - a0
    gb = np.concatenate([b_nz, [len(ref_b)]]) - b0
    pair, extra = np.minimum(ga, gb), np.abs(ga - gb)
    extra[-1] = 0
    length = pair + extra + (np.arange(len(ga)) < len(a_nz))
    seg = np.repeat(np.arange(len(ga)), length)
    off = np.arange(len(seg)) - np.repeat(np.cumsum(length) - length, length)
    alone = (off >= pair[seg]) & (off < pair[seg] + extra[seg])
    ia = np.where((off < pair[seg]) | (alone & (ga[seg] > gb[seg])),
                  a0[seg] + off, -1)
    ib = np.where((off < pair[seg]) | (alone & (gb[seg] > ga[seg])),
                  b0[seg] + off, -1)
    base = off == pair[seg] + extra[seg]
    ia[base], ib[base] = a_nz[seg[base]], b_nz[seg[base]]
    return ia, ib


def bed_multifa_inputs(f: dict, t_fa: str, chain: str, snps: dict,
                       meta: dict, seed: int = 2504) -> dict:
    """The input files of phase_tools_cli's slice 11.5 and 11.6 steps,
    written from the merged records, the planted SNPs, samConsensus's
    chr1 alignment, the reconstruction rows and the chain's chr1 blocks
    (f: the phase's file names). Returns what their gates need beside
    those files."""
    rng = np.random.default_rng(seed)
    bm = {}
    with open(f["num.bed"], "w") as fh:
        fh.writelines(f"{c}\t{p - 1 - TOOLS_GC_FLANK}\t{p + TOOLS_GC_FLANK}\t"
                      f"{p / 8}\n" for c in snps for p, _, _ in snps[c])
    merged = bed_rows(f["merged.bed"])
    with open(f["merged.bedGraph"], "w") as fh:
        fh.writelines(f"{c}\t{s}\t{e}\t{i % 9 + 0.5}\n"
                      for i, (c, s, e, *_) in enumerate(merged))
    # bedMinimumDistanceName: a 10-base record a SNP, within 500 bases of
    # it, named after its snps_strand.bed record
    sizes = dict(TOOLS_SIZES)
    with open(f["snps_near.bed"], "w") as fh:
        for i, (c, p) in enumerate((c, p) for c in snps
                                   for p, _, _ in snps[c]):
            s = min(max(p - 1 + int(rng.integers(-500, 501)), 0),
                    sizes[c] - 10)
            fh.write(f"{c}\t{s}\t{s + 10}\tsnp{i}\n")
    n1 = sizes["chr1"]
    # the last region ends a base short of chr1's end: the column of the
    # end base itself is where the reference's walk runs out
    bm["extract_regions"] = [(1000, 2000), (50_000, 52_500),
                             (n1 - 777, n1 - 1)]
    with open(f["extract.bed"], "w") as fh:
        fh.writelines(f"chr1\t{s}\t{e}\n" for s, e in bm["extract_regions"])
    # multiFaScan: the chr1 alignment with N in the query row at the
    # planted chr1 SNPs' columns
    (t_name, t_row), (q_name, q_row) = fasta_strings(
        os.path.join(f["multi"], "chr1.fa")).items()
    cols = np.flatnonzero(np.frombuffer(t_row.encode(), np.uint8)
                          != ord("-"))
    q = np.frombuffer(q_row.encode(), np.uint8).copy()
    q[cols[[p - 1 for p, _, _ in snps["chr1"]]]] = ord("N")
    write_fasta_strings(f["chr1_n.fa"], [(t_name, t_row),
                                         (q_name, q.tobytes().decode())])
    # mergeMultiFa: the reconstruction's target row (three blocks of
    # all-gap columns inserted) and its two mutants
    write_fasta_strings(f["merge_b.fa"], [(t_name, meta["recon_rows"][0][1])]
                        + meta["recon_rows"][2:])
    # multiFaToChain: chr1's target and query aligned by the chain's
    # blocks (an insertion or a deletion of the query between two)
    with open(chain) as fh:
        text = fh.read().split("\n\n")[0].splitlines()
    bm["chain_head"], bm["chain_blocks"] = text[0].split(), text[1:]
    seqs = [fasta_strings(t_fa)["chr1"], fasta_strings(f["q.fa"])["chr1"]]
    rows, ti, qi = ["", ""], 0, 0
    for block in bm["chain_blocks"]:
        size, dt, dq = (list(map(int, block.split("\t"))) + [0, 0])[:3]
        rows[0] += seqs[0][ti:ti + size + dt] + "-" * dq
        rows[1] += seqs[1][qi:qi + size] + "-" * dt \
            + seqs[1][qi + size:qi + size + dq]
        ti, qi = ti + size + dt, qi + size + dq
    write_fasta_strings(f["pair.fa"], [("chr1", rows[0]),
                                       ("chr1q", rows[1])])
    bm["pair_rows_whole"] = (ti, qi) == (len(seqs[0]), len(seqs[1]))
    return bm


def bed_multifa_checks(f: dict, t_fa: str, snps: dict, meta: dict,
                       bm: dict) -> dict:
    """What the gates of phase_tools_cli's slice 11.5 and 11.6 steps read
    from their files, each beside what numpy gives from the inputs (bm:
    what bed_multifa_inputs returned); none of these tools' modules is
    imported. Each entry holds the lines (or count) it compared and
    whether they equal numpy's."""
    sizes = dict(TOOLS_SIZES)
    target = fasta_strings(t_fa)
    out = {}

    def entry(got, want, n=None):
        return {"lines": len(want) if n is None else n,
                "equal_numpy": got == want}

    aln = bed_rows(f["aln.bed"])
    out["bed_filter"] = entry(bed_rows(f["filt.bed"]), [
        r for r in aln if r[0] == "chr1" and int(r[2]) - int(r[1]) >= 100])
    split = {n: bed_rows(os.path.join(f["split"], n))
             for n in sorted(os.listdir(f["split"]))}
    out["bed_split"] = entry(split, {
        f"{c}.bed": [r for r in aln if r[0] == c] for c in sorted(sizes)},
        n=len(aln))
    merged = bed_rows(f["merged.bed"])
    out["bed_shear"] = entry(bed_rows(f["shear.bed"]), [
        [c, str(s), str(min(s + 50, int(e))), *rest]
        for c, s0, e, *rest in merged for s in range(int(s0), int(e), 50)])
    trimmed = []
    for c, s, e, *rest in aln:
        s, e = int(s), int(e)
        rm = int(np.floor((e - s) * 0.2 + 0.5))
        s, e = s + rm // 2 + rm % 2, e - rm // 2
        if e > s:
            trimmed.append([c, str(s), str(e), *rest])
    out["bed_trim"] = entry(bed_rows(f["trim.bed"]), trimmed)

    # the merged records' coverage a chrom, and the planted SNPs under it
    cover = {}
    for c, n in sizes.items():
        d = np.zeros(n + 1, np.int64)
        for cc, s, e, *_ in merged:
            if cc == c:
                d[int(s)] += 1
                d[int(e)] -= 1
        cover[c] = np.cumsum(d[:-1])
    snp_at = [(c, p) for c in snps for p, _, _ in snps[c]]
    hit = sum(bool(cover[c][p - 1]) for c, p in snp_at)
    by_chrom = {c: np.array(sorted(p for cc, p in snp_at if cc == c))
                for c in sizes}
    with_snp = sum(bool(((by_chrom[c] > int(s))
                         & (by_chrom[c] <= int(e))).any())
                   for c, s, e, *_ in merged)
    with open(f["sim.txt"]) as fh:
        sim = fh.read().splitlines()
    pa, pb = with_snp / len(merged), hit / len(snp_at)
    out["bed_similarity"] = entry(
        sim[1:], [f"{pa:f}\t{pb:f}\t{(pa + pb) / 2:f}"], n=hit)

    want = []
    for c, n in sizes.items():
        csum = np.concatenate([[0], np.cumsum(np.concatenate(
            [cover[c], np.zeros(TOOLS_WINDOW, np.int64)]))])
        counts = csum[TOOLS_WINDOW:TOOLS_WINDOW + n] - csum[:n]
        want += [[c, str(j), str(j + TOOLS_WINDOW), ".", str(v)]
                 for j, v in enumerate(counts.tolist())]
    out["bed_overlap_by_window"] = entry(bed_rows(f["win.bed"]), want)

    snp_bed = bed_rows(f["snps.bed"])
    out["bed_distance_from_chr_ends"] = entry(bed_rows(f["dist.bed"]), [
        [c, s, e, "", str(min(sizes[c] - int(e), int(s)))]
        for c, s, e in snp_bed])
    genome = {r[3]: r for r in bed_rows(f["snps_strand.bed"])}
    want = []
    for c, s, e, name in bed_rows(f["snps_near.bed"]):
        g = genome[name]
        s, e, gs, ge = int(s), int(e), int(g[1]), int(g[2])
        dist = 0 if max(s, gs) < min(e, ge) else (
            gs - e + 1 if gs - e >= 0 else s - ge + 1)
        up = s <= gs if g[5] == "+" else e >= ge
        want.append([c, str(s), str(e), name, str(dist), "-" if up else "+"])
    out["bed_minimum_distance_name"] = entry(bed_rows(f["mind.bed"]), want)
    out["bed_math"] = entry(bed_rows(f["math.bed"]), [
        [c, s, e, f"{2 * float(v):.8g}"]
        for c, s, e, v in bed_rows(f["num.bed"])])
    reads = wig_arrays(f["reads.wig"], sizes, np.finfo(np.float64).max)
    out["bed_value_wig"] = entry(bed_rows(f["val.bed"]), [
        [c, s, e, "", "0", ".", go_g(reads[c][int(s)])]
        for c, s, e in snp_bed])
    want = {c: np.zeros(n) for c, n in sizes.items()}
    for c, s, e, v in bed_rows(f["merged.bedGraph"]):
        want[c][int(s):int(e)] = float(v)
    got = wig_arrays(f["bg.wig"], sizes, 0.0)
    out["bed_graph_to_wig"] = entry(
        all(np.array_equal(got[c], want[c]) for c in sizes), True,
        n=int(sum((v != 0).sum() for v in want.values())))

    # the multiFa tools, on samConsensus's chr1 alignment
    (t_name, t_row), (q_name, q_row) = fasta_strings(
        os.path.join(f["multi"], "chr1.fa")).items()
    t_b = np.frombuffer(t_row.encode(), np.uint8)
    q_b = np.frombuffer(q_row.encode(), np.uint8)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(f["count.txt"]) as fh:
        count = fh.read().splitlines()
    present = int(np.isin(q_b, acgt).sum())
    out["multi_fa_count"] = entry(count, [
        "#querySequenceName\tpresentBaseCount", f"{q_name}\t{present}"],
        n=present)
    with open(f["count_both.txt"]) as fh:
        both = int(fh.read().splitlines()[1].split("\t")[-1])
    want = int((np.isin(q_b, acgt) & np.isin(t_b, acgt)).sum())
    out["multi_fa_count_both"] = entry(both, want, n=want)
    ref_pos = np.cumsum(t_b != ord("-")) - (t_b != ord("-"))
    n_cols = np.flatnonzero(np.frombuffer(
        fasta_strings(f["chr1_n.fa"])[q_name].encode(), np.uint8) == ord("N"))
    out["multi_fa_scan"] = entry(bed_rows(f["scan.bed"]), [
        ["chr1", str(ref_pos[c]), str(ref_pos[c] + 1), t_name]
        for c in n_cols])
    extracted = {}
    for s, e in bm["extract_regions"]:
        path = os.path.join(f["extract"], f"chr1.{s}.{e}.fa")
        extracted[(s, e)] = fasta_strings(path).get(t_name) \
            if os.path.exists(path) else None
    out["multi_fa_extract"] = entry(extracted, {
        (s, e): target["chr1"][s:e] for s, e in bm["extract_regions"]})

    cols = np.flatnonzero(t_b != q_b)
    out["multi_fa_reduce"] = entry(
        (fasta_strings(f["red.fa"]), bed_rows(f["red.bed"])),
        ({t_name: t_b[cols].tobytes().decode(),
          q_name: q_b[cols].tobytes().decode()},
         [["chr1", str(ref_pos[i]), str(ref_pos[i] + 1),
           f"{t_row[i]}_{q_row[i]}", str(i)] for i in cols]),
        n=len(cols))
    # multiFaSequenceSwap: the query row with the target's bases in the
    # columns whose reference position is a planted chr1 SNP's
    swap = np.isin(ref_pos, [p - 1 for p, _, _ in snps["chr1"]])
    want = q_b.copy()
    want[swap] = t_b[swap]
    out["multi_fa_sequence_swap"] = entry(
        list(fasta_strings(f["swap.fa"]).items()),
        [(t_name, t_row), (q_name, q_row),
         (f"{q_name}.swapped", want.tobytes().decode())],
        n=int(swap.sum()))

    # mergeMultiFa of the chr1 alignment (A) with the reconstruction's
    # target row and its mutants (B)
    b_rows = [np.frombuffer(r.encode(), np.uint8)
              for _, r in [meta["recon_rows"][0]] + meta["recon_rows"][2:]]
    ia, ib = merged_columns(t_b, b_rows[0])

    def gather(row, idx):
        return np.where(idx < 0, ord("-"), row[np.maximum(idx, 0)]
                        ).astype(np.uint8).tobytes().decode()

    out["merge_multi_fa"] = entry(
        list(fasta_strings(f["merged.fa"]).items()),
        [(t_name, gather(t_b, ia)), (q_name, gather(q_b, ia))]
        + [(n, gather(r, ib)) for (n, _), r in
           zip(meta["recon_rows"][2:], b_rows[1:])],
        n=len(ia))

    with open(f["pair.chain"]) as fh:
        lines = fh.read().split("\n")
    n_t, n_q = int(bm["chain_head"][3]), int(bm["chain_head"][8])
    out["multi_fa_to_chain"] = entry(
        (lines[0], lines[1:-3], lines[-3:], bm["pair_rows_whole"]),
        (f"chain 100 chr1 {n_t} + 0 {n_t} chr1q {n_q} + 0 {n_q} 1",
         bm["chain_blocks"][:-1], [bm["chain_blocks"][-1], "", ""], True),
        n=len(bm["chain_blocks"]))
    return out


def write_bai(bam: str, path: str) -> dict:
    """A BAI index of a coordinate-sorted BAM, written to path, as the SAM
    spec (section 5.2) builds one: each BGZF block inflated in turn, its
    compressed offset noted, so that a record's start and end in the
    stream become virtual offsets (coffset << 16 | uoffset); a record
    joins the bin its own ``bin`` field names, as one chunk, merged with
    that bin's last chunk where they touch; each 16 kbp window of a
    reference takes the smallest start of the records overlapping it, a
    window with none its predecessor's (the reference's first start before
    any); records with no reference count as no-coordinate reads. The
    repository has no BAI writer: this one is held against the JAX
    package's ``read_bai`` and seek by tests/test_torch_sam_tools.py.
    Returns {"refs": references, "records": mapped records,
    "no_coord": no-coordinate reads}."""
    import struct
    import zlib

    with open(bam, "rb") as fh:
        raw = fh.read()
    coffs, ustarts, blocks, off, u = [], [], [], 0, 0
    while off < len(raw):
        xlen = struct.unpack_from("<H", raw, off + 10)[0]
        i, bsize = off + 12, None
        while i < off + 12 + xlen:
            slen = struct.unpack_from("<H", raw, i + 2)[0]
            if raw[i:i + 2] == b"BC":
                bsize = struct.unpack_from("<H", raw, i + 4)[0] + 1
            i += 4 + slen
        data = zlib.decompress(raw[off + 12 + xlen:off + bsize - 8], -15)
        if data:
            coffs.append(off)
            ustarts.append(u)
            blocks.append(data)
        u, off = u + len(data), off + bsize
    stream, starts = b"".join(blocks), np.array(ustarts, np.int64)

    def voff(x: int) -> int:
        b = int(np.searchsorted(starts, x, side="right")) - 1
        return coffs[b] << 16 | (x - ustarts[b])

    l_text = struct.unpack_from("<I", stream, 4)[0]
    pos = 8 + l_text
    n_ref = struct.unpack_from("<I", stream, pos)[0]
    pos += 4
    for _ in range(n_ref):
        pos += 8 + struct.unpack_from("<I", stream, pos)[0]
    bins = [{} for _ in range(n_ref)]
    windows = [{} for _ in range(n_ref)]
    mapped = no_coord = 0
    while pos + 4 <= len(stream):
        blk = struct.unpack_from("<I", stream, pos)[0]
        ref_id, start, l_name, _, bin_id, n_cig = struct.unpack_from(
            "<iiBBHH", stream, pos + 4)
        cigar = struct.unpack_from(f"<{n_cig}I", stream, pos + 36 + l_name)
        ref_len = sum(c >> 4 for c in cigar if (c & 0xF) in (0, 2, 3, 7, 8))
        beg, end = voff(pos), voff(pos + 4 + blk)
        pos += 4 + blk
        if ref_id < 0:
            no_coord += 1
            continue
        mapped += 1
        chunks = bins[ref_id].setdefault(bin_id, [])
        if chunks and chunks[-1][1] == beg:
            chunks[-1][1] = end
        else:
            chunks.append([beg, end])
        last = start + max(ref_len, 1) - 1
        for w in range(start >> 14, (last >> 14) + 1):
            windows[ref_id][w] = min(windows[ref_id].get(w, beg), beg)
    out = bytearray(b"BAI\x01" + struct.pack("<I", n_ref))
    for ref_bins, ref_windows in zip(bins, windows):
        out += struct.pack("<I", len(ref_bins))
        for bin_id in sorted(ref_bins):
            chunks = ref_bins[bin_id]
            out += struct.pack("<II", bin_id, len(chunks))
            out += b"".join(struct.pack("<QQ", a, b) for a, b in chunks)
        n_win = max(ref_windows, default=-1) + 1
        offsets = []
        for w in range(n_win):
            offsets.append(ref_windows.get(w, offsets[-1] if offsets else
                                           min(ref_windows.values())))
        out += struct.pack(f"<I{n_win}Q", n_win, *offsets)
    out += struct.pack("<Q", no_coord)
    with open(path, "wb") as fh:
        fh.write(bytes(out))
    return {"refs": n_ref, "records": mapped, "no_coord": no_coord}


def fastq_records(path: str) -> list:
    """(name, sequence, quality) of each record of a FASTQ file."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    return list(zip([n[1:] for n in lines[0::4]], lines[1::4], lines[3::4]))


def sam_rows(path: str) -> list:
    """The tab-split alignment lines of a SAM file."""
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh
                if not ln.startswith("@")]


def ref_span(row) -> tuple:
    """A SAM row's (0-based start, end) on its reference, and its M runs
    as (start, end) pairs."""
    pos, runs, ms = int(row[3]) - 1, re.findall(r"(\d+)([MIDNSHP=X])",
                                                row[5]), []
    for n, op in runs:
        if op == "M":
            ms.append((pos, pos + int(n)))
        if op in "MDN=X":
            pos += int(n)
    return int(row[3]) - 1, pos, ms


def bam_payload(path: str) -> tuple:
    """A BAM's header text and, for each record, (name, flag, {tag: value})
    of its i and Z tags, read with gzip and struct alone."""
    import gzip
    import struct

    with open(path, "rb") as fh:
        data = gzip.decompress(fh.read())
    l_text = struct.unpack_from("<I", data, 4)[0]
    text = data[8:8 + l_text].decode()
    off = 8 + l_text
    n_ref = struct.unpack_from("<I", data, off)[0]
    off += 4
    for _ in range(n_ref):
        off += 8 + struct.unpack_from("<I", data, off)[0]
    records = []
    while off + 4 <= len(data):
        blk = struct.unpack_from("<I", data, off)[0]
        l_name, _, _, n_cig, flag, l_seq = struct.unpack_from(
            "<BBHHHI", data, off + 12)
        name = data[off + 36:off + 35 + l_name].decode()
        t = off + 36 + l_name + 4 * n_cig + (l_seq + 1) // 2 + l_seq
        end, tags = off + 4 + blk, {}
        while t < end:
            tag, typ = data[t:t + 2].decode(), chr(data[t + 2])
            if typ == "Z":
                stop = data.index(0, t + 3)
                tags[tag] = data[t + 3:stop].decode()
                t = stop + 1
            else:
                size = {"c": 1, "C": 1, "A": 1, "s": 2, "S": 2}.get(typ, 4)
                fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H",
                       "i": "<i", "I": "<I"}.get(typ)
                tags[tag] = (struct.unpack_from(fmt, data, t + 3)[0]
                             if fmt else None)
                t += 3 + size
        records.append((name, flag, tags))
        off = end
    return text, records


def sam_wig_steps(step, f: dict, t_fa: str, snps: dict, times: dict) -> dict:
    """The steps of slice 11.7a and wigTools in phase_tools_cli, with the
    inputs they need, on the phase's r.fq, aln.sam, s.sam, t.sizes,
    reads.wig, bg.wig, planted SNPs and target (f: the phase's file
    names; step: its umbrella runner; the .bai's wall goes into times).
    Returns what sam_wig_checks needs beside the files."""
    reads = fastq_records(f["r.fq"])
    sw = {"listed": [n for n, _, _ in reads[::TOOLS_FQ_EVERY]]}
    with open(f["names.txt"], "w") as fh:
        fh.writelines(n + "\n" for n in sw["listed"])
    step("fastqFilter", "fastqFilter", f["r.fq"], f["fq_filt.fq"],
         "-minSize", "100", "-subSet", str(TOOLS_FQ_SUBSET), "-setSeed",
         str(TOOLS_FQ_SEED), "-retainNamesList", f["names.txt"])
    step("fastqFormat", "fastqFormat", "-pairedEnd", "-singleCell",
         f["r.fq"], f["r.fq"], f["fmt1.fq"], f["fmt2.fq"])
    sw["pairs"] = [(seq[:8], seq[:8][::-1]) for _, seq, _ in reads[::700]]
    with open(f["replace.tsv"], "w") as fh:
        fh.writelines(f"{a}\t{b}\n" for a, b in sw["pairs"])
    step("fastqReplaceSeq", "fastqReplaceSeq", f["r.fq"], f["replace.tsv"],
         f["replaced.fq"])
    step("longReadLibStats", "longReadLibStats", f["r.fq"], f["lrs.txt"],
         "-readLengths", f["lens.txt"])

    step("samInfo_readLength", "samInfo", "readLength", f["s.sam"],
         f["rl.txt"])
    step("samInfo_coverage", "samInfo", "coverage", f["s.sam"],
         f["cov_hist.txt"], f["cov_stats.txt"])
    step("samInfo_mapq", "samInfo", "mapq", f["s.sam"], f["mapq.txt"])
    step("samToWig", "samToWig", f["s.sam"], f["t.sizes"], f["cov.wig"])
    step("mergesort_bam", "mergesort", f["aln.sam"], f["sorted.bam"])
    t = time.perf_counter()
    sw["bai"] = write_bai(f["sorted.bam"], f["sorted.bam"] + ".bai")
    times["write_bai"] = time.perf_counter() - t
    sw["regions"] = [(c, max(p - 1 - TOOLS_BAM_FLANK, 0), p + TOOLS_BAM_FLANK)
                     for c in snps for p, _, _ in snps[c][::TOOLS_BAM_EVERY]]
    with open(f["regions.bed"], "w") as fh:
        fh.writelines(f"{c}\t{s}\t{e}\tsnp{i}\n"
                      for i, (c, s, e) in enumerate(sw["regions"]))
    step("bedCountBam", "bedCountBam", f["sorted.bam"], f["regions.bed"],
         f["bcb.txt"])
    step("samInfo_mapq_bedfile", "samInfo", "mapq", f["sorted.bam"],
         f["mapq_bed.txt"], "-bedfile", f["regions.bed"])
    scores = [r[11][5:] for r in sam_rows(f["s.sam"]) if len(r) > 11]
    values, counts = np.unique(scores, return_counts=True)
    sw["as_values"] = values[np.argsort(-counts, kind="stable")[:3]].tolist()
    with open(f["as.txt"], "w") as fh:
        fh.writelines(v + "\n" for v in sw["as_values"])
    step("bamTagToReadGroup", "bamTagToReadGroup", "-i", f["sorted.bam"],
         "-o", f["rg.bam"], "-tagId", "AS", "-tagValues", f["as.txt"])

    step("wigTools_filter", "wigTools", "filter", f["reads.wig"],
         f["t.sizes"], f["wf.wig"], "-chrom", "chr1")
    step("wigTools_peaks", "wigTools", "peaks", f["cov.wig"], f["t.sizes"],
         f["peaks.bed"], "-threshold", str(TOOLS_PEAK))
    step("wigTools_subtract", "wigTools", "math", f["cov.wig"], f["t.sizes"],
         f["sub.wig"], "-elementWiseSubtract", f["bg.wig"])
    step("wigTools_smooth", "wigTools", "math", f["cov.wig"], f["t.sizes"],
         f["smooth.wig"], "-movingAverageSmoothing", "5")
    step("wigTools_pearson", "wigTools", "math", f["cov.wig"], f["t.sizes"],
         f["pcc.txt"], "-pearson", f["bg.wig"], "-sampleFrequency", "1")
    with open(f["nogap.bed"], "w") as fh:
        fh.writelines(f"{c}\t0\t{n}\n" for c, n in TOOLS_SIZES)
    step("wigTools_stats", "wigTools", "stats", f["cov.wig"], f["t.sizes"],
         f["nogap.bed"], f["wstats.txt"])
    step("wigTools_toTrainingSet", "wigTools", "toTrainingSet", f["cov.wig"],
         t_fa, f["train.txt"], f["val.txt"], f["test.txt"], "-windowSize",
         str(TOOLS_PREDICT_WINDOW), "-stride", str(TOOLS_PREDICT_STRIDE),
         "-setSeed", "3", "-missing", "0")
    return sw


def sam_wig_checks(f: dict, t_fa: str, sw: dict) -> dict:
    """What the gates of phase_tools_cli's slice 11.7a and wigTools steps
    read from their files, each beside what numpy and plain Python give
    from the steps' inputs (sw: what sam_wig_steps returned); none of
    these tools' modules is imported. Each entry holds the lines (or
    count) it compared and whether they equal numpy's."""
    sizes = dict(TOOLS_SIZES)
    out = {}

    def entry(got, want, n=None):
        return {"lines": len(want) if n is None else n,
                "equal_numpy": got == want}

    reads = fastq_records(f["r.fq"])
    listed = set(sw["listed"])
    draws = np.random.default_rng(TOOLS_FQ_SEED).random(len(reads))
    out["fastq_filter"] = entry(
        [n for n, _, _ in fastq_records(f["fq_filt.fq"])],
        [n for (n, _, _), d in zip(reads, draws)
         if d <= TOOLS_FQ_SUBSET and n in listed])
    out["fastq_format"] = entry(
        (fastq_records(f["fmt1.fq"]), fastq_records(f["fmt2.fq"])),
        ([(f"{n}_UMI:{s[16:28]}_BX:{s[:16]}", s[28:], q[28:])
          for n, s, q in reads],
         [(f"{n}_UMI:{s[16:28]}_BX:{s[:16]}", s, q) for n, s, q in reads]),
        n=len(reads))
    replaced, want = 0, []
    for n, s, q in reads:
        for a, b in sw["pairs"]:
            if s.startswith(a):
                s, replaced = b + s[len(a):], replaced + 1
                break
        want.append((n, s, q))
    out["fastq_replace_seq"] = entry(fastq_records(f["replaced.fq"]), want)
    out["fastq_replace_seq"]["replaced"] = replaced
    lens = sorted(len(s) for _, s, _ in reads)
    n50 = lens[int(np.searchsorted(np.cumsum(lens), sum(lens) // 2))]
    with open(f["lrs.txt"]) as fh, open(f["lens.txt"]) as fl:
        out["long_read_lib_stats"] = entry(
            (fh.read(), fl.read().split()),
            (f"Total number of reads: {len(reads)}\nN50: {n50}\n",
             [str(len(s)) for _, s, _ in reads]), n=len(reads))

    rows = sam_rows(f["s.sam"])
    mapped = [r for r in rows if not int(r[1]) & 4]
    hist = np.bincount([len(r[9]) if r[9] != "*" else 0 for r in rows])
    want = np.zeros(max(200, len(hist)), np.int64)
    want[:len(hist)] += hist
    out["sam_info_read_length"] = entry(
        bed_rows(f["rl.txt"]), [["ReadLength", "Count"]]
        + [[str(i), str(c)] for i, c in enumerate(want)])
    # coverage: a covered position's depth is its M bases; its rows past
    # numpy's histogram must be zero
    depth = {c: np.zeros(n + 1, np.int64) for c, n in sizes.items()}
    spans = {c: np.zeros(n + 1, np.int64) for c, n in sizes.items()}
    mapped_spans = [(r, *ref_span(r)) for r in mapped]
    for r, start, end, ms in mapped_spans:
        np.add.at(spans[r[2]], [start, end], [1, -1])
        for a, b in ms:
            np.add.at(depth[r[2]], [a, b], [1, -1])
    covered = np.concatenate([np.cumsum(depth[c])[np.cumsum(spans[c]) > 0]
                              for c in sizes])
    emp = [(int(i), int(n)) for i, n, g, _ in bed_rows(f["cov_hist.txt"])[1:]
           if g == "Empirical"]
    want = np.bincount(covered)
    with open(f["cov_stats.txt"]) as fh:
        lam = float(fh.readline().split("\t")[1])
    out["sam_info_coverage"] = entry(
        ([n for _, n in emp[:len(want)]], sum(n for _, n in emp[len(want):]),
         [i for i, _ in emp] == list(range(len(emp))), lam),
        (want.tolist(), 0, True, int(covered.sum()) / len(covered)),
        n=len(emp))
    mq = np.bincount([int(r[4]) for r in mapped], minlength=61)
    out["sam_info_mapq"] = entry(bed_rows(f["mapq.txt"]),
                                 [["mapQ", "count"]]
                                 + [[str(i), str(c)] for i, c in
                                    enumerate(mq)])
    cov = {c: np.cumsum(spans[c])[:-1].astype(np.float64) for c in sizes}
    out["sam_to_wig"] = entry(
        {c: v.tolist() for c, v in wig_arrays(f["cov.wig"], sizes,
                                              0.0).items()},
        {c: v.tolist() for c, v in cov.items()}, n=len(covered))

    aln = sam_rows(f["aln.sam"])
    n_unmapped = sum(int(r[1]) & 4 > 0 for r in aln)
    out["bai"] = {**sw["bai"], "lines": sw["bai"]["records"],
                  "equal_numpy": sw["bai"] == {
        "refs": len(sizes), "records": len(aln) - n_unmapped,
        "no_coord": n_unmapped}}
    hits, mq_bed = [], np.zeros(61, np.int64)
    for c, s, e in sw["regions"]:
        names = set()
        for r, start, end, _ in mapped_spans:
            if r[2] == c and start < e and end > s:
                names.add((r[0], int(r[1]) & 64))
                mq_bed[int(r[4])] += 1
        hits.append(len(names))
    out["bed_count_bam"] = entry(
        bed_rows(f["bcb.txt"]), [["bedRegion", "counts"]]
        + [[f"snp{i}", str(n)] for i, n in enumerate(hits)])
    out["bed_count_bam"]["reads"] = sum(hits)
    out["sam_info_mapq_bedfile"] = entry(
        bed_rows(f["mapq_bed.txt"]), [["mapQ", "count"]]
        + [[str(i), str(c)] for i, c in enumerate(mq_bed)])
    text, records = bam_payload(f["rg.bam"])
    values = set(sw["as_values"])
    out["bam_tag_to_read_group"] = entry(
        ([ln for ln in text.split("\n") if ln.startswith("@RG")],
         [t.get("RG") for _, _, t in records]),
        ([f"@RG\tID:{v}\tSM:{v}\tLB:{v}" for v in sw["as_values"]],
         [str(t["AS"]) if str(t.get("AS")) in values else None
          for _, _, t in records]), n=len(records))
    out["bam_tag_to_read_group"]["grouped"] = sum(
        "RG" in t for _, _, t in records)

    reads_wig = wig_arrays(f["reads.wig"], sizes, 0.0)
    bg = wig_arrays(f["bg.wig"], sizes, 0.0)
    out["wig_filter"] = entry(
        {c: v.tolist() for c, v in wig_arrays(f["wf.wig"], sizes,
                                              0.0).items()},
        {c: (reads_wig[c] if c == "chr1" else 0 * reads_wig[c]).tolist()
         for c in sizes}, n=int((reads_wig["chr1"] != 0).sum()))
    peaks = []
    for c in sorted(sizes):
        hit = np.concatenate([[False], cov[c] >= TOOLS_PEAK, [False]])
        edges = np.flatnonzero(hit[1:] != hit[:-1]).reshape(-1, 2)
        # the skeleton's start of 1 shifts every peak a base right
        peaks += [[c, str(a + 1), str(b + 1), "", str(int(cov[c][a:b].max()))]
                  for a, b in edges]
    out["wig_peaks"] = entry(bed_rows(f["peaks.bed"]), peaks)
    out["wig_subtract"] = entry(
        {c: v.tolist() for c, v in wig_arrays(f["sub.wig"], sizes,
                                              0.0).items()},
        {c: np.where((cov[c] != 0) & (bg[c] != 0), cov[c] - bg[c],
                     0.0).tolist() for c in sizes},
        n=sum(int(((cov[c] != 0) & (bg[c] != 0)).sum()) for c in sizes))
    smooth = {}
    for c in sizes:
        win = np.lib.stride_tricks.sliding_window_view(cov[c], 5)[:-1]
        v = np.zeros(len(cov[c]))
        ok = (win != 0).all(axis=1)
        v[np.flatnonzero(ok) + 2] = win[ok].sum(axis=1) / 5
        smooth[c] = v.tolist()
    out["wig_smooth"] = entry(
        {c: v.tolist() for c, v in wig_arrays(f["smooth.wig"], sizes,
                                              0.0).items()}, smooth,
        n=sum(int((np.array(v) != 0).sum()) for v in smooth.values()))
    keep = {c: (cov[c] != 0) & (bg[c] != 0) for c in sizes}
    a = np.concatenate([cov[c][keep[c]] for c in sorted(sizes)])
    b = np.concatenate([bg[c][keep[c]] for c in sorted(sizes)])
    r = float(((a - a.mean()) * (b - b.mean())).sum()) / float(
        np.sqrt(float(((a - a.mean()) ** 2).sum()))
        * np.sqrt(float(((b - b.mean()) ** 2).sum())))
    with open(f["pcc.txt"]) as fh:
        pcc = float(fh.read().split("\t")[1])
    out["wig_pearson"] = {"lines": len(a), "pcc": pcc, "numpy": r,
                          "equal_numpy": abs(pcc - r) <= 5e-7}
    values = np.concatenate([cov[c][cov[c] != 0] for c in sizes])
    stat = np.bincount(values.astype(np.int64))
    want = np.zeros(max(1000, len(stat)), np.int64)
    want[:len(stat)] += stat
    out["wig_stats"] = entry(bed_rows(f["wstats.txt"]),
                             [["coverage", "count"]]
                             + [[str(i), str(c)] for i, c in enumerate(want)])
    # toTrainingSet: each entry of cov.wig from index 0, the target's bases
    # from the chrom's start whatever the entry's start, a draw a window
    target = fasta_strings(t_fa)
    rng = np.random.default_rng(3)
    shards = {"train": [], "val": [], "test": []}
    entries = []
    with open(f["cov.wig"]) as fh:
        for line in fh:
            if line.startswith("fixedStep"):
                kv = dict(x.split("=", 1) for x in line.split()[1:])
                entries.append((kv["chrom"], []))
            else:
                entries[-1][1].append(float(line))
    for chrom, vals in entries:
        for s in range(0, len(vals) - TOOLS_PREDICT_WINDOW,
                       TOOLS_PREDICT_STRIDE):
            mid = (2 * s + TOOLS_PREDICT_WINDOW) // 2
            if vals[mid] == 0:  # -missing 0
                continue
            seq = target[chrom][s:s + TOOLS_PREDICT_WINDOW].upper()
            line = [f"{chrom}:{s}-{s + TOOLS_PREDICT_WINDOW}", seq,
                    go_g(vals[mid])]
            x = rng.random()
            shards["test" if x < 0.1 else "val" if x < 0.2
                   else "train"].append(line)
    out["wig_to_training_set"] = entry(
        {k: bed_rows(f[k + ".txt"]) for k in shards},
        {k: [["name", "seq", "value"]] + v for k, v in shards.items()},
        n=sum(len(v) for v in shards.values()))
    return out


def rand_seq_steps(step, f: dict, times: dict) -> dict:
    """The steps of slice 11.8a in phase_tools_cli: randSeq of RAND_NUM
    records of RAND_LEN bases (rs.fa), of the first two of them (rs2.fa)
    and of Go's seed-1 stream (rs1.fa); then the host check of the port's
    Go rand (its wall into times): GoRand(1)'s Int63 and ten Intn(100)
    against Go's published values, and the stored burn-in table against
    its jump-ahead rebuild."""
    from gonomics_tpu_torch.numbers import gorand

    step("randSeq", "randSeq", f["rs.fa"], "-numSeq", str(RAND_NUM),
         "-lenSeq", str(RAND_LEN), "-setSeed", str(RAND_SEED))
    step("randSeq_two", "randSeq", f["rs2.fa"], "-numSeq", "2", "-lenSeq",
         str(RAND_LEN), "-setSeed", str(RAND_SEED))
    step("randSeq_seed1", "randSeq", f["rs1.fa"], "-numSeq", "1",
         "-lenSeq", "10", "-setSeed", "1")
    t = time.perf_counter()
    first = gorand.GoRand(1).int63()
    rng = gorand.GoRand(1)
    intn = [rng.intn(100) for _ in range(10)]
    cooked = bool((gorand._load_cooked()
                   == gorand.compute_cooked(7_800_000_000_000)).all())
    times["gorand_check"] = time.perf_counter() - t
    return {"seed1_int63": first,
            "seed1_int63_equal_go": first == GO_SEED1_INT63,
            "seed1_intn100": intn,
            "seed1_intn100_equal_go": intn == GO_SEED1_INTN100,
            "cooked_equal_rebuilt": cooked}


def rand_seq_checks(f: dict) -> dict:
    """What the gates of phase_tools_cli's randSeq steps read from their
    files, with numpy and text alone: the records' names, lengths and
    line widths, the base shares, rs2.fa against the head of rs.fa, and
    rs1.fa's sequence."""
    with open(f["rs.fa"], "rb") as fh:
        text = fh.read()
    lines = text.decode().splitlines()
    names = [ln[1:] for ln in lines if ln.startswith(">")]
    seqs, widths = [], set()
    for ln in lines:
        if ln.startswith(">"):
            seqs.append([])
        else:
            seqs[-1].append(ln)
            widths.add(len(ln))
    joined = "".join("".join(x) for x in seqs)
    counts = np.bincount(np.frombuffer(joined.encode(), np.uint8),
                         minlength=256)
    n = max(len(joined), 1)
    a, c, g, t = (int(counts[ord(x)]) for x in "ACGT")
    with open(f["rs2.fa"], "rb") as fh:
        two = fh.read()
    head = b"".join(ln + b"\n" for ln in text.split(b"\n")[
        :2 * (1 - -RAND_LEN // 50)])
    with open(f["rs1.fa"]) as fh:
        one = fh.read().splitlines()
    return {"names": names,
            "names_equal": names == [f"Sequence_{i}" for i in range(RAND_NUM)],
            "lengths": sorted({sum(map(len, x)) for x in seqs}),
            "line_widths": sorted(widths), "bases": n,
            "acgt_only": a + c + g + t == n,
            "gc_share": (g + c) / n, "g_minus_c_share": abs(g - c) / n,
            "a_minus_t_share": abs(a - t) / n,
            "two_equal_head": two == head, "seed1": one,
            "seed1_equal_go": one == [">Sequence_0", GO_SEED1_BASES]}


def afs_pmf(n: int, alpha: float) -> np.ndarray:
    """P(i | n, alpha) for i = 1 .. n - 1 under the stationary allele
    frequency density of selection alpha, by scipy's quad: C(n, i) times
    the integral of p^(i-1) (1-p)^(n-i-1) 2 (1 - e^(-alpha (1-p))) /
    (1 - e^(-alpha)) over [0, 1], normalised."""
    from scipy import integrate, special

    def f(p, i):
        return (p ** (i - 1) * (1 - p) ** (n - i - 1) * 2
                * -np.expm1(-alpha * (1 - p)) / -np.expm1(-alpha))

    w = np.array([special.comb(n, i) * integrate.quad(f, 0, 1, args=(i,))[0]
                  for i in range(1, n)])
    return w / w.sum()


def afs_vcf(path: str, sites: int, n: int, alpha: float, seed: int) -> list:
    """A VCF of sites biallelic SNPs over n / 2 phased diploid samples,
    each site's ALT count drawn from afs_pmf(n, alpha) and placed on
    random haplotypes, AA the REF (so the counts are derived counts);
    the counts."""
    rng = np.random.default_rng(seed)
    counts = rng.choice(np.arange(1, n), size=sites, p=afs_pmf(n, alpha))
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t"
                + "\t".join(f"s{j}" for j in range(n // 2)) + "\n")
        for s, k in enumerate(counts):
            hap = np.zeros(n, np.int64)
            hap[rng.permutation(n)[:k]] = 1
            f.write(f"chr1\t{s + 1}\t.\tA\tG\t50\tPASS\tAA=A\tGT\t"
                    + "\t".join(f"{a}|{b}" for a, b in hap.reshape(-1, 2))
                    + "\n")
    return [int(k) for k in counts]


def dunn_inputs(tmp: str, seed: int = 2209) -> dict:
    """dunnIndex's inputs: DUNN_ROWS rows of DUNN_LEN columns, row 0 (the
    reference) gap-free so that a reference position is its column, the
    others with gap runs, lower case runs and an N or two, the first half
    of the rows group "close" (1% apart from a common row), the second
    "far" (8%); a bed of windows of DUNN_WINDOW every DUNN_STEP, and one
    of the first DUNN_REALIGN windows cut to DUNN_REALIGN_LEN for
    -realign; the groups list (with a member the alignment lacks)."""
    rng = np.random.default_rng(seed)
    base = rng.choice(np.frombuffer(b"ACGT", np.uint8), DUNN_LEN)
    rows, names, half = [], [], DUNN_ROWS // 2
    far = base.copy()
    far[rng.random(DUNN_LEN) < 0.06] = rng.choice(
        np.frombuffer(b"ACGT", np.uint8))
    for r in range(DUNN_ROWS):
        row = (base if r < half else far).copy()
        flip = rng.random(DUNN_LEN) < (0.01 if r < half else 0.03)
        row[flip] = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                               int(flip.sum()))
        if r:
            for start in rng.integers(0, DUNN_LEN - 10, 12):
                row[start:start + int(rng.integers(1, 8))] = ord("-")
            for start in rng.integers(0, DUNN_LEN - 10, 4):
                run = row[start:start + 5]
                row[start:start + 5] = np.where(run == ord("-"), run,
                                                run | 0x20)   # lower case
            row[rng.integers(0, DUNN_LEN, 2)] = ord("N")
        rows.append(row)
        names.append(f"{'close' if r < half else 'far'}{r % half}")
    paths = {k: os.path.join(tmp, k) for k in (
        "dunn.fa", "dunn.groups", "dunn.bed", "dunn_re.bed")}
    with open(paths["dunn.fa"], "w") as f:
        f.writelines(f">{n}\n{r.tobytes().decode()}\n"
                     for n, r in zip(names, rows))
    with open(paths["dunn.groups"], "w") as f:
        f.write(">close\n" + "".join(n + "\n" for n in names[:half])
                + ">far\n" + "".join(n + "\n" for n in names[half:])
                + "farMissing\n")
    starts = list(range(0, DUNN_LEN - DUNN_WINDOW, DUNN_STEP))
    with open(paths["dunn.bed"], "w") as f:
        f.writelines(f"chr1\t{a}\t{a + DUNN_WINDOW}\n" for a in starts)
    with open(paths["dunn_re.bed"], "w") as f:
        f.writelines(f"chr1\t{a}\t{a + DUNN_REALIGN_LEN}\n"
                     for a in starts[:DUNN_REALIGN])
    return {"paths": paths, "names": names, "rows": rows, "starts": starts}


def popgen_steps(step, tmp: str, times: dict) -> dict:
    """The steps of slice 11.8b in phase_tools_cli: statCalc's densities,
    sums, integrals and seeded samplers; plotFunctions' Normal, Beta,
    Gamma and AFS pmf rows; selectionMle of afs_vcf's POP_SITES sites at
    POP_ALPHA, then the port's library selection_maximum_likelihood_
    estimate on the same VCF (its wall into times); selectionMcmc twice
    from one seed, mcmcTraceStats of its trace for Mu and for Sigma
    after a burn-in; dunnIndex without and with -realign; and
    simulateWrightFisher twice from one seed and once with no mutation
    and two of the four bases at the start. Returns the paths and what
    the checks need."""
    from gonomics_tpu_torch import popgen

    p = {k: os.path.join(tmp, k) for k in (
        "sel.vcf", "mle.txt", "mcmc.vcf", "mc1.trace", "mc2.trace",
        "mts_mu.txt", "mts_sigma.txt", "dunn.out.bed", "dunn_re.out.bed",
        "wf1.tsv", "wf2.tsv", "wf0.tsv")}
    stat = {
        "normal_density": ["-normal", "0.5,2", "1.3"],
        "normal_window": ["-normal", "1,2", "0.5", "1.5"],
        "normal_left_tail": ["-normal", "0,0.1", "--", "-INF", "-0.4"],
        "binomial_mass": ["-binomial", "20,0.3", "4"],
        "binomial_right": ["-binomial", "20,0.3", "3", "N"],
        "binomial_left": ["-binomial", "20,0.3", "0", "7"],
        "poisson_mass": ["-poisson", "3.5", "2"],
        "poisson_right": ["-poisson", "3.5", "4", "INF"],
        "beta_density": ["-beta", "2,5", "0.3"],
        "beta_window": ["-beta", "2,5", "0", "1"],
        "gamma_density": ["-gamma", "2,1.5", "0.7"],
        "gamma_window": ["-gamma", "2,1.5", "0.5", "1.5"],
        "gamma_right": ["-gamma", "3,1", "1", "Inf"],
        "sample_normal": ["-sampleNormal", f"1,2,{STAT_DRAWS}", "-setSeed",
                          "21"],
        "sample_beta": ["-sampleBeta", f"2,3,{STAT_DRAWS}", "-setSeed",
                        "22"],
        "sample_gamma": ["-sampleGamma", f"2,1.5,{STAT_DRAWS}", "-setSeed",
                         "23"],
        "sample_afs": ["-sampleAfs", f"2,{STAT_DRAWS},50,100,0.01,0.99",
                       "-setSeed", "24"]}
    for k, argv in stat.items():
        p["sc_" + k] = os.path.join(tmp, f"sc_{k}.txt")
        step("statCalc_" + k, "statCalc", "-outFile", p["sc_" + k], *argv)
    plots = {"normal": ["Normal", "0,1", "-3", "3", "60"],
             "beta": ["Beta", "2,3", "0", "1", "50"],
             "gamma": ["Gamma", "2,1.5", "0", "6", "60"],
             "afs": ["AfsProbability", "2,12,1e-6"],
             "afs_ancestral": ["AfsProbabilityAncestral", "2,12,1e-6"],
             "afs_derived": ["AfsProbabilityDerived", "2,12,1e-6"]}
    for k, argv in plots.items():
        p["pf_" + k] = os.path.join(tmp, f"pf_{k}.txt")
        step("plotFunctions_" + k, "plotFunctions", *argv, p["pf_" + k])

    afs_vcf(p["sel.vcf"], POP_SITES, POP_N, POP_ALPHA, POP_SEED)
    step("selectionMle", "selectionMle", p["sel.vcf"], p["mle.txt"])
    t = time.perf_counter()
    library = popgen.selection_maximum_likelihood_estimate(
        popgen.vcf_to_afs(p["sel.vcf"]))
    times["selection_mle_library"] = time.perf_counter() - t

    afs_vcf(p["mcmc.vcf"], MCMC_SITES, MCMC_N, POP_ALPHA, POP_SEED + 1)
    for k in ("mc1.trace", "mc2.trace"):
        step("selectionMcmc_" + k[:3], "selectionMcmc", p["mcmc.vcf"], p[k],
             "-iterations", str(MCMC_ITER), "-setSeed", str(MCMC_SEED))
    step("mcmcTraceStats", "mcmcTraceStats", p["mc1.trace"],
         p["mts_mu.txt"])
    step("mcmcTraceStats_sigma", "mcmcTraceStats", p["mc1.trace"],
         p["mts_sigma.txt"], "-parameterName", "Sigma", "-burnIn", "5",
         "-hdiProportion", "0.5")

    dunn = dunn_inputs(tmp)
    d = dunn["paths"]
    step("dunnIndex", "dunnIndex", d["dunn.bed"], d["dunn.fa"],
         d["dunn.groups"], p["dunn.out.bed"])
    step("dunnIndex_realign", "dunnIndex", d["dunn_re.bed"], d["dunn.fa"],
         d["dunn.groups"], p["dunn_re.out.bed"], "-realign")

    wf = ["-N", str(WF_N), "-t", str(WF_T), "-g", str(WF_G)]
    for k in ("wf1.tsv", "wf2.tsv"):
        step("simulateWrightFisher_" + k[:3], "simulateWrightFisher", p[k],
             *wf, "-m", str(WF_M), "-setSeed", str(WF_SEED))
    step("simulateWrightFisher_m0", "simulateWrightFisher", p["wf0.tsv"],
         *wf, "-m", "0", "-i", "0.5,0,0.5,0,A", "-setSeed", str(WF_SEED))
    return {"paths": p, "library_mle": library, "dunn": dunn}


def popgen_checks(pg: dict) -> dict:
    """What the gates of phase_tools_cli's slice 11.8b steps read from
    their files, each against numpy or scipy alone: statCalc's values
    against scipy.stats (its integrals as differences of cdfs), its
    samples' means and variances against their distributions'; the
    plotFunctions rows against scipy's pdfs, the AFS pmfs summed in
    linear space; selectionMle's estimate against POP_ALPHA and the
    library's; the traces' header, rows and bytes, mcmcTraceStats' mean
    and HDI against numpy's from the trace; dunnIndex's index and
    segregating sites against numpy's Hamming distances on each window,
    the realigned output's rows; simulateWrightFisher's frequencies a
    site and generation, its two runs' bytes, the absent bases with no
    mutation."""
    from scipy import integrate, stats

    p = pg["paths"]

    def lines(path):
        with open(path) as fh:
            return fh.read().splitlines()

    def rel(got, want):
        return abs(got - want) / max(abs(want), 1e-300)

    one = {k: float(lines(p["sc_" + k])[0]) for k in (
        "normal_density", "normal_window", "normal_left_tail",
        "binomial_mass", "binomial_right", "binomial_left", "poisson_mass",
        "poisson_right", "beta_density", "beta_window", "gamma_density",
        "gamma_window", "gamma_right")}
    gam = stats.gamma(2, scale=1 / 1.5)
    want = {"normal_density": stats.norm(0.5, 2).pdf(1.3),
            "normal_window": stats.norm(1, 2).cdf(1.5)
            - stats.norm(1, 2).cdf(0.5),
            "normal_left_tail": stats.norm(0, 0.1).cdf(-0.4),
            "binomial_mass": stats.binom(20, 0.3).pmf(4),
            "binomial_right": stats.binom(20, 0.3).sf(2),
            "binomial_left": stats.binom(20, 0.3).cdf(7),
            "poisson_mass": stats.poisson(3.5).pmf(2),
            "poisson_right": stats.poisson(3.5).sf(3),
            "beta_density": stats.beta(2, 5).pdf(0.3), "beta_window": 1.0,
            "gamma_density": gam.pdf(0.7),
            "gamma_window": gam.cdf(1.5) - gam.cdf(0.5),
            "gamma_right": stats.gamma(3).sf(1)}
    integral = ("normal_window", "normal_left_tail", "beta_window",
                "gamma_window", "gamma_right")
    stat_err = {k: rel(one[k], float(want[k])) for k in one}
    stat_ok = all(stat_err[k] <= (STAT_INT_RTOL if k in integral
                                  else STAT_RTOL) for k in one)

    def afs_f(x):
        return 2 * -np.expm1(-2 * (1 - x)) / (-np.expm1(-2) * x * (1 - x))
    z = integrate.quad(afs_f, 0.01, 0.99)[0]
    afs_mean = integrate.quad(lambda x: x * afs_f(x), 0.01, 0.99)[0] / z
    afs_var = integrate.quad(lambda x: x * x * afs_f(x), 0.01,
                             0.99)[0] / z - afs_mean ** 2
    # (mean, variance, support) of each sampler's distribution
    dists = {"sample_normal": (1.0, 4.0, (-np.inf, np.inf)),
             "sample_beta": (0.4, 0.04, (0, 1)),
             "sample_gamma": (2 / 1.5, 2 / 1.5 ** 2, (0, np.inf)),
             "sample_afs": (afs_mean, afs_var, (0.01, 0.99))}
    samples = {}
    for k, (mean, var, (lo, hi)) in dists.items():
        x = np.array([float(v) for v in lines(p["sc_" + k])])
        se = np.sqrt(var / len(x))
        samples[k] = {"draws": len(x), "mean": float(x.mean()),
                      "mean_se": float(abs(x.mean() - mean) / se),
                      "var_rel": float(rel(x.var(ddof=1), var)),
                      "ok": bool(len(x) == STAT_DRAWS
                                 and ((x >= lo) & (x <= hi)).all()
                                 and abs(x.mean() - mean) <= STAT_SE_TOL * se
                                 and rel(x.var(ddof=1), var)
                                 <= STAT_VAR_RTOL)}

    pdfs = {"normal": (stats.norm(0, 1).pdf, -3.0, 3.0, 60),
            "beta": (stats.beta(2, 3).pdf, 0.0, 1.0, 50),
            "gamma": (gam.pdf, 0.0, 6.0, 60)}
    plot = {}
    for k, (pdf, left, right, bins) in pdfs.items():
        rows = [r.split("\t") for r in lines(p["pf_" + k])]
        xs, cur, step_ = [], left, (right - left) / bins
        for _ in range(bins):
            xs.append(cur)
            cur += step_
        err = max(abs(float(r[1]) - pdf(x)) for r, x in zip(rows[1:], xs))
        plot[k] = {"rows": len(rows) - 1, "max_abs_err": float(err),
                   "ok": bool(rows[0] == ["X", "f(X)"]
                              and len(rows) == bins + 1
                              and [r[0] for r in rows[1:]]
                              == [f"{x:f}" for x in xs]
                              and err <= PLOT_ATOL)}
    for k in ("afs", "afs_ancestral", "afs_derived"):
        rows = [r.split("\t") for r in lines(p["pf_" + k])[1:]]
        total = float(np.exp([float(r[1]) for r in rows]).sum())
        plot[k] = {"rows": len(rows), "sum": total,
                   "ok": bool(len(rows) == 11
                              and [int(r[0]) for r in rows]
                              == list(range(1, 12))
                              and abs(total - 1) <= 1e-5)}

    head, row = lines(p["mle.txt"])
    est = float(row.split("\t")[1])
    mle = {"estimate": est, "library": pg["library_mle"],
           "ok": bool(head == "#FILENAME\tMaximumLikelihood"
                      and row.split("\t")[0] == p["sel.vcf"]
                      and abs(est - POP_ALPHA) <= POP_MLE_TOL
                      and row.split("\t")[1] == f"{pg['library_mle']:e}")}

    with open(p["mc1.trace"], "rb") as a, open(p["mc2.trace"], "rb") as b:
        t1, t2 = a.read(), b.read()
    trace = [r.split("\t") for r in t1.decode().splitlines()]
    mcmc = {"rows": len(trace) - 1, "same_bytes": t1 == t2,
            "accepted": sum(r[3] == "true" for r in trace[1:])}
    mcmc["ok"] = bool(trace[0] == ["Iteration", "Mu", "Sigma", "Accept"]
                      and mcmc["rows"] == MCMC_ITER and t1 == t2
                      and [int(r[0]) for r in trace[1:]]
                      == list(range(MCMC_ITER))
                      and all(r[3] in ("true", "false") for r in trace[1:]))
    for k, col, burn, prop in (("mts_mu.txt", 1, 0, 0.95),
                               ("mts_sigma.txt", 2, 5, 0.5)):
        vals = np.array([float(r[col]) for r in trace[1:]])[burn:]
        mean = float(np.cumsum(vals)[-1] / len(vals))   # left to right
        srt = np.sort(vals)
        pi = int(np.ceil(prop * len(srt))) - 1
        i0 = int(np.argmin(srt[pi:] - srt[:len(srt) - pi]))
        h, r = lines(p[k])
        got = r.split("\t")
        mcmc[k] = {"mean": float(got[1]), "hdi": got[3:5],
                   "ok": bool(h == "#FILENAME\tMEAN\tPROPORTION\tSTART\tEND"
                              and float(got[1]) == mean
                              and got[2] == f"{prop:f}"
                              and got[3:5] == [f"{srt[i0]:f}",
                                               f"{srt[i0 + pi]:f}"])}

    dn = pg["dunn"]
    aln = np.stack(dn["rows"])
    half = DUNN_ROWS // 2
    out_rows = [r.split("\t") for r in lines(p["dunn.out.bed"])]
    dunn = {"windows": len(out_rows), "equal": 0}
    for a, r in zip(dn["starts"], out_rows):
        win = aln[:, a:a + DUNN_WINDOW]
        keep = [i for i in range(DUNN_ROWS)
                if (win[i] != ord("-")).any()]
        sub = win[keep]
        cols = ~(((sub == ord("-")) | (sub >= ord("a"))).any(axis=0))
        sub = sub[:, cols]
        pos = {i: k for k, i in enumerate(keep)}

        def ham(i, j):
            return int((sub[pos[i]] != sub[pos[j]]).sum())
        intra = max(ham(i, j) for grp in (range(half),
                                          range(half, DUNN_ROWS))
                    for i in grp for j in grp if i < j and i in pos
                    and j in pos)
        inter = min(ham(i, j) for i in range(half)
                    for j in range(half, DUNN_ROWS) if i in pos and j in pos)
        seg = int((sub != sub[0]).any(axis=0).sum())
        dunn["equal"] += (r[:3] == ["chr1", str(a), str(a + DUNN_WINDOW)]
                          and r[6] == f"{inter / intra:f}"
                          and r[7] == str(seg)
                          and r[8] == "Missing: close: far: farMissing, ")
    re_rows = [r.split("\t") for r in lines(p["dunn_re.out.bed"])]
    dunn["realign_rows"] = len(re_rows)
    dunn["realign_index"] = [r[6] for r in re_rows]
    dunn["ok"] = bool(dunn["windows"] == len(dn["starts"])
                      and dunn["equal"] == dunn["windows"]
                      and len(re_rows) == DUNN_REALIGN
                      and all(len(r) == 9 and float(r[6]) >= 0
                              and int(r[7]) >= 0 for r in re_rows))

    with open(p["wf1.tsv"], "rb") as a, open(p["wf2.tsv"], "rb") as b:
        w1, w2 = a.read(), b.read()
    wf_rows = [r.split("\t") for r in w1.decode().splitlines()[2:]]
    freqs = np.array([[float(x) for x in r[2:6]] for r in wf_rows])
    w0 = [r.split("\t") for r in lines(p["wf0.tsv"])[2:]]
    wf = {"rows": len(wf_rows), "same_bytes": w1 == w2,
          "max_sum_err": float(np.abs(freqs.sum(axis=1) - 1).max()),
          "absent_appear": sum(r[3] != "0.00000" or r[5] != "0.00000"
                               for r in w0)}
    wf["ok"] = bool(wf["rows"] == (WF_T + 1) * WF_G and w1 == w2
                    and [(int(r[0]), int(r[1])) for r in wf_rows]
                    == [(t, g) for t in range(WF_T + 1)
                        for g in range(WF_G)]
                    and wf["max_sum_err"] <= 2e-5
                    and np.allclose(freqs * WF_N, np.round(freqs * WF_N),
                                    atol=1e-3)
                    and len(w0) == (WF_T + 1) * WF_G
                    and wf["absent_appear"] == 0)
    return {"stat_calc": {"rel_err": stat_err, "ok": stat_ok,
                          "samples": samples},
            "plot_functions": plot, "selection_mle": mle, "mcmc": mcmc,
            "dunn_index": dunn, "wright_fisher": wf}


def popgen_ok(pt: dict) -> bool:
    """Every gate of popgen_checks met."""
    return bool(pt["stat_calc"]["ok"]
                and all(v["ok"] for v in pt["stat_calc"]["samples"].values())
                and all(v["ok"] for v in pt["plot_functions"].values())
                and pt["selection_mle"]["ok"] and pt["mcmc"]["ok"]
                and pt["mcmc"]["mts_mu.txt"]["ok"]
                and pt["mcmc"]["mts_sigma.txt"]["ok"]
                and pt["dunn_index"]["ok"] and pt["wright_fisher"]["ok"])


def interval_lift_inputs(f: dict, tmp: str, snps: dict) -> dict:
    """The seeded inputs of slice 11.9 and divergenceSpectrum in
    phase_tools_cli, under tmp: IL_CONTACTS bedpe contacts of 10 fields
    between IL_WINDOW bp windows of the target (IL_INTRA of them within one
    chromosome); a bed of non-overlapping named tiles, at most one a
    IL_TILE bp cell; intervalSubsetMatrix's union of IL_ISM_WINDOW bp
    windows and its list (merged.bed, snps.bed, the tiles);
    geneAssignmentStats' truth, a region every IL_GENE_EVERY bp (every
    IL_GENE_PAIR-th with a second contact overlapping it), and its test
    bed, one record inside each region, IL_GENE_SHARE of them named as a
    truth name of the region; the search space of the chromosomes' spans;
    a VCF of the planted SNPs and divergenceSpectrum's IL_DIV_WINDOW bp
    windows of chr1. Returns the paths and what the checks need."""
    rng = np.random.default_rng(IL_SEED)
    p = {k: os.path.join(tmp, k) for k in (
        "contacts.bedpe", "tiles.bed", "ism_union.bed", "ism_list.txt",
        "truth.bedpe", "test.bed", "space.bed", "snps.vcf", "div.bed")}
    sizes = dict(TOOLS_SIZES)
    names = [c for c, _ in TOOLS_SIZES]
    weights = np.array([n for _, n in TOOLS_SIZES], np.float64)
    weights /= weights.sum()

    def window(chrom):
        k = int(rng.integers(0, sizes[chrom] // IL_WINDOW))
        return chrom, k * IL_WINDOW, (k + 1) * IL_WINDOW

    with open(p["contacts.bedpe"], "w") as fh:
        for i in range(IL_CONTACTS):
            a = window(names[int(rng.choice(len(names), p=weights))])
            b = window(a[0] if rng.random() < IL_INTRA else
                       names[int(rng.choice(len(names), p=weights))])
            fh.write("\t".join(map(str, (*a, *b, f"c{i}",
                                         int(rng.integers(0, 1000)),
                                         "+-."[int(rng.integers(0, 3))],
                                         "+-."[int(rng.integers(0, 3))])))
                     + "\n")
    with open(p["tiles.bed"], "w") as fh:
        i = 0
        for c, n in TOOLS_SIZES:
            for cell in range(0, n, IL_TILE):
                if rng.random() < IL_TILE_KEEP:
                    s = cell + int(rng.integers(0, IL_TILE // 2))
                    e = min(n, s + int(rng.integers(200, cell + IL_TILE
                                                    - s + 1)))
                    fh.write(f"{c}\t{s}\t{e}\tt{i}\n")
                    i += 1
    with open(p["ism_union.bed"], "w") as fh:
        fh.writelines(f"{c}\t{s}\t{s + IL_ISM_WINDOW}\n"
                      for c, n in TOOLS_SIZES
                      for s in range(0, n, IL_ISM_WINDOW))
    with open(p["ism_list.txt"], "w") as fh:
        fh.writelines(x + "\n" for x in (f["merged.bed"], f["snps.bed"],
                                         p["tiles.bed"]))
    regions = [(c, s) for c, n in TOOLS_SIZES
               for s in range(0, n, IL_GENE_EVERY)]
    matched = set(rng.permutation(len(regions))[
        :round(IL_GENE_SHARE * len(regions))].tolist())
    truth, test, want = [], [], {"matched": [], "non_matched": []}
    for k, (c, s) in enumerate(regions):
        mates = [f"g{k}"] + ([f"g{k}b"] if k % IL_GENE_PAIR == 0 else [])
        for j, name in enumerate(mates):
            b = window(names[int(rng.integers(0, len(names)))])
            truth.append((c, s + 100 + 200 * j, s + 500 + 200 * j, *b, name,
                          0, "+", "-"))
        name = (mates[int(rng.integers(0, len(mates)))] if k in matched
                else f"x{k}")
        test.append(f"{c}\t{s + 350}\t{s + 380}\t{name}\n")
        if k in matched:
            want["matched"].append(f"{name},{name}")
        else:
            want["non_matched"].append(f"{mates[-1]},{name}")
    with open(p["truth.bedpe"], "w") as fh:
        fh.writelines("\t".join(map(str, t)) + "\n" for t in truth)
    with open(p["test.bed"], "w") as fh:
        fh.writelines(test)
    with open(p["space.bed"], "w") as fh:
        fh.writelines(f"{c}\t0\t{n}\n" for c, n in TOOLS_SIZES)
    with open(p["snps.vcf"], "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\n")
        fh.writelines(f"{c}\t{pos}\t.\t{ref}\t{alt}\t30\tPASS\t.\n"
                      for c in snps for pos, ref, alt in snps[c])
    with open(p["div.bed"], "w") as fh:
        fh.writelines(f"chr1\t{s}\t{s + IL_DIV_WINDOW}\n"
                      for s in range(0, sizes["chr1"], IL_DIV_WINDOW))
    return {"paths": p, "genes": len(regions), "gene_names": want}


def interval_lift_steps(step, f: dict, q_fa: str, chain: str, snps: dict,
                        tmp: str, times: dict) -> dict:
    """The steps of slice 11.9 and divergenceSpectrum in phase_tools_cli,
    on the inputs of interval_lift_inputs: liftCoordinates of samToBed's
    records (at the default -minMatch 0.95 and at IL_STRICT_MATCH) and,
    with -faFile q.fa (its .fai written first), of the
    chain's VCF; bedpeFilter -minDistance IL_MIN_DIST -onlyIntraChrom;
    bedpeOverlap -bedSelect of merged.bed (threshold 0, 0.5 and
    -overlapBoth) and of the tiles (-overlapThreshold 0.5 -keepNames, and
    -overlapBoth at 0.5); intervalContacts of merged.bed and of the tiles;
    intervalSubsetMatrix binary and -fraction; geneAssignmentStats (its
    stdout kept); overlapEnrichments upperBound, lowerBound and exact of
    merged.bed and the planted SNPs, upperBound, normalApproximate and
    exact of the tiles, then the port's library bounds at full precision
    (their wall into times); divergenceSpectrum of the SNP VCF. Returns
    the paths and what the checks need."""
    from gonomics_tpu_torch import lift_enrichment
    from gonomics_tpu_torch.io import fai

    il = interval_lift_inputs(f, tmp, snps)
    p = il["paths"]
    p.update({k: os.path.join(tmp, k) for k in (
        "lift.bed", "lift_un.txt", "lift_strict.bed", "lift_strict_un.txt",
        "lift.vcf", "lift_vcf_un.txt", "bpf.bedpe", "bpo0.bedpe",
        "bpo5.bedpe", "bpob.bedpe", "bpo_tiles.bedpe", "bpob_tiles.bedpe", "ic.bed", "ic_tiles.bed",
        "ism.tsv", "ism_frac.tsv", "gas_m.bed", "gas_n.bed", "oe_upper.tsv",
        "oe_lower.tsv", "oe_exact.tsv", "oe_tiles_upper.tsv",
        "oe_tiles_normal.tsv", "oe_tiles_exact.tsv", "div.out.bed")})
    step("liftCoordinates_reads", "liftCoordinates", chain, f["aln.bed"],
         p["lift.bed"], p["lift_un.txt"])
    step("liftCoordinates_reads_strict", "liftCoordinates", chain,
         f["aln.bed"], p["lift_strict.bed"], p["lift_strict_un.txt"],
         "-minMatch", str(IL_STRICT_MATCH))
    fai.write_index(fai.create_index(q_fa), q_fa + ".fai")
    step("liftCoordinates_vcf", "liftCoordinates", chain, f["c.vcf"],
         p["lift.vcf"], p["lift_vcf_un.txt"], "-faFile", q_fa)
    step("bedpeFilter", "bedpeFilter", p["contacts.bedpe"], p["bpf.bedpe"],
         "-minDistance", str(IL_MIN_DIST), "-onlyIntraChrom")
    for k, sel, flags in (
            ("bpo0", "merged.bed", []),
            ("bpo5", "merged.bed", ["-overlapThreshold", "0.5"]),
            ("bpob", "merged.bed", ["-overlapBoth"]),
            ("bpo_tiles", "tiles.bed", ["-overlapThreshold", "0.5",
                                        "-keepNames"]),
            ("bpob_tiles", "tiles.bed", ["-overlapBoth",
                                         "-overlapThreshold", "0.5"])):
        step("bedpeOverlap_" + k, "bedpeOverlap", "-bedSelect", *flags,
             f.get(sel) or p[sel], p["contacts.bedpe"], p[k + ".bedpe"])
    step("intervalContacts", "intervalContacts", p["contacts.bedpe"],
         f["merged.bed"], p["ic.bed"])
    step("intervalContacts_tiles", "intervalContacts", p["contacts.bedpe"],
         p["tiles.bed"], p["ic_tiles.bed"])
    step("intervalSubsetMatrix", "intervalSubsetMatrix", p["ism_union.bed"],
         p["ism_list.txt"], p["ism.tsv"])
    step("intervalSubsetMatrix_fraction", "intervalSubsetMatrix",
         p["ism_union.bed"], p["ism_list.txt"], p["ism_frac.tsv"],
         "-fraction")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        step("geneAssignmentStats", "geneAssignmentStats", p["truth.bedpe"],
             p["test.bed"], p["gas_m.bed"], p["gas_n.bed"])
    for k, e1, method in (("oe_upper", f["merged.bed"], "upperBound"),
                          ("oe_lower", f["merged.bed"], "lowerBound"),
                          ("oe_exact", f["merged.bed"], "exact"),
                          ("oe_tiles_upper", p["tiles.bed"], "upperBound"),
                          ("oe_tiles_normal", p["tiles.bed"],
                           "normalApproximate"),
                          ("oe_tiles_exact", p["tiles.bed"], "exact")):
        step("overlapEnrichments_" + k[3:], "overlapEnrichments", method, e1,
             f["snps.bed"], p["space.bed"], p[k + ".tsv"])
    t = time.perf_counter()
    library = {}
    for key, e1 in (("merged", f["merged.bed"]), ("tiles", p["tiles.bed"])):
        recs = {k: lift_enrichment.go_read(x) for k, x in (
            ("e1", e1), ("e2", f["snps.bed"]), ("space", p["space.bed"]))}
        for r in recs.values():
            lift_enrichment.sort_by_coord(r)
        k = lift_enrichment.overlap_count(recs["e2"], recs["e1"])
        library[key] = {m: lift_enrichment.enrichment_p_value_bound(
            recs["e1"], recs["e2"], recs["space"], k, m == "upper")
            for m in ("upper", "lower")}
    times["overlap_enrichments_library"] = time.perf_counter() - t
    step("divergenceSpectrum", "divergenceSpectrum", p["div.bed"],
         p["snps.vcf"], p["div.out.bed"])
    return {**il, "inputs": {k: f[k] for k in (
        "aln.bed", "merged.bed", "snps.bed", "c.vcf")}, "chain": chain,
        "q_fa": q_fa, "gas_stdout": buf.getvalue(), "library": library}


def chain_maps(path: str) -> dict:
    """{target name: (query name, block target starts, block query starts,
    block sizes, gaps as (target start, target end, query bases) rows)}
    of a chain file with plus strands, parsed as text."""
    out, cur = {}, None
    with open(path) as fh:
        for line in fh:
            w = line.split()
            if not w:
                continue
            if w[0] == "chain":
                cur = [w[7], [], [], [], []]
                t, q = int(w[5]), int(w[10])
                out[w[2]] = cur
                continue
            size = int(w[0])
            cur[1].append(t)
            cur[2].append(q)
            cur[3].append(size)
            t, q = t + size, q + size
            if len(w) == 3:
                dt, dq = int(w[1]), int(w[2])
                cur[4].append((t, t + dt, dq))
                t, q = t + dt, q + dq
    return {k: (v[0], *(np.array(x, np.int64) for x in v[1:4]),
                np.array(v[4], np.int64).reshape(-1, 3))
            for k, v in out.items()}


def lift_numpy(cm: tuple, s: np.ndarray, e: np.ndarray,
               min_match: float = 0.95) -> tuple:
    """What liftCoordinates does to target spans [s, e) through one chain,
    in numpy: (passes min_match, lifted start, lifted end). A span's
    matched bases are its bases in blocks; its target gap bases and the
    query bases of the gaps it touches make the two shares; a position
    in a gap maps to the query position where the gap starts."""
    _, t0, q0, size, gaps = cm
    d_t = np.zeros(len(s), np.int64)
    d_q = np.zeros(len(s), np.int64)
    for gs, ge, gq in gaps.tolist():
        ot = np.maximum(0, np.minimum(e, ge) - np.maximum(s, gs))
        d_t += ot
        d_q += np.where(ot > 0, gq, 0)
    match = (e - s) - d_t
    with np.errstate(invalid="ignore", divide="ignore"):
        a = match / (match + d_t)
        b = match / (match + d_q)
    ok = (match > 0) & (a >= min_match) & (b >= min_match)

    def to_q(t):
        k = np.searchsorted(t0, t, "right") - 1
        return q0[k] + np.minimum(t - t0[k], size[k])

    return ok, to_q(s), to_q(e - 1) + 1


def spans_index(rows) -> dict:
    """{chrom: (starts, ends)} of disjoint bed rows, sorted."""
    out: dict = {}
    for r in rows:
        out.setdefault(r[0], []).append((int(r[1]), int(r[2])))
    return {c: tuple(np.array(x, np.int64).T) for c, x in
            ((c, sorted(v)) for c, v in out.items())}


def span_hits(idx: dict, c: str, s: int, e: int) -> tuple:
    """(first index, overlap lengths) of [s, e) with idx[c]'s spans."""
    if c not in idx:
        return 0, np.zeros(0, np.int64)
    st, en = idx[c]
    lo = int(np.searchsorted(en, s, "right"))
    hi = int(np.searchsorted(st, e, "left"))
    return lo, np.minimum(en[lo:hi], e) - np.maximum(st[lo:hi], s)


def interval_lift_checks(il: dict) -> dict:
    """What the gates of phase_tools_cli's slice 11.9 and
    divergenceSpectrum steps read from their files, each against numpy
    (or scipy) from the inputs, importing none of these tools' modules:
    the lifted reads and their unmapped file against lift_numpy through
    the chain's blocks; the VCF's SNPs lifted with REF and ALT swapped,
    its insertions under the INDEL message and its deletions (whose probe
    covers the deleted bases alone) failing -minMatch; bedpeFilter's
    lines numpy's filter; bedpeOverlap's and intervalContacts' lines
    numpy's overlaps of each foot with merged.bed and the tiles;
    intervalSubsetMatrix's matrices numpy's, value for value;
    geneAssignmentStats' share and lines the planted ones;
    overlapEnrichments' count numpy's covered SNPs, its bounds scipy's
    binomial tails at numpy's probability, its exact values numpy's
    convolution of the Poisson-binomial, its normal approximation scipy's
    densities summed, the library's bounds scipy's to IL_BINOM_RTOL;
    divergenceSpectrum's six counts a window numpy's."""
    from scipy import stats

    p, f = il["paths"], il["inputs"]

    def lines(path):
        with open(path) as fh:
            return fh.read().splitlines()

    def rel(got, want):
        return abs(got - want) / max(abs(want), 1e-300)

    cms = chain_maps(il["chain"])
    out = {}
    # liftCoordinates of the reads, at -minMatch 0.95 and IL_STRICT_MATCH
    rows = bed_rows(f["aln.bed"])
    by_chrom: dict = {}
    for i, r in enumerate(rows):
        by_chrom.setdefault(r[0], []).append(i)
    for key, mm, suffix in (("lift_reads", 0.95, ""),
                            ("lift_reads_strict", IL_STRICT_MATCH,
                             "_strict")):
        lifted = [None] * len(rows)
        for c, idx in by_chrom.items():
            s = np.array([int(rows[i][1]) for i in idx], np.int64)
            e = np.array([int(rows[i][2]) for i in idx], np.int64)
            ok, ns, ne = lift_numpy(cms[c], s, e, mm)
            for j, i in enumerate(idx):
                lifted[i] = (bool(ok[j]), int(ns[j]), int(ne[j]))
        want_out = ["\t".join([cms[r[0]][0], str(ns), str(ne)] + r[3:])
                    for r, (ok, ns, ne) in zip(rows, lifted) if ok]
        want_un = ["\t".join(r) for r, x in zip(rows, lifted) if not x[0]]
        un = lines(p[f"lift{suffix}_un.txt"])
        out[key] = {
            "records": len(rows), "lifted": len(want_out),
            "unmapped": len(want_un),
            "lifted_equal_numpy": lines(p[f"lift{suffix}.bed"]) == want_out,
            "unmapped_equal_numpy": un[1::2] == want_un
            and all(x.startswith("Record below fails minMatch")
                    for x in un[0::2])}
    # liftCoordinates -faFile of the chain's VCF
    query = fasta_strings(il["q_fa"])
    vcf = lines(f["c.vcf"])
    head = [x for x in vcf if x.startswith("#")]
    want_out, want_un = list(head), []
    kinds = {"snps": 0, "insertions": 0, "deletions": 0}
    for line in vcf[len(head):]:
        w = line.split("\t")
        pos, ref, alt = int(w[1]), w[3], w[4]
        s, e = (pos - 1, pos) if len(ref) == 1 else (pos, pos + len(ref) - 1)
        ok, ns, _ = lift_numpy(cms[w[0]], np.array([s]), np.array([e]))
        kind = ("snps" if len(ref) == len(alt) == 1 else "insertions"
                if len(ref) == 1 else "deletions")
        kinds[kind] += 1
        if not ok[0]:
            want_un += ["fails minMatch", line]
            continue
        lw = [cms[w[0]][0], str(int(ns[0]) + 1)] + w[2:]
        if kind != "snps":
            want_un += ["INDEL records", "\t".join(lw)]
        elif query[lw[0]][int(lw[1]) - 1].upper() == ref:
            want_out.append("\t".join(lw))
        elif query[lw[0]][int(lw[1]) - 1].upper() == alt:
            want_un += ["alleles are inverted", "\t".join(lw)]
            want_out.append("\t".join(lw[:3] + [alt, ref] + lw[5:]))
        else:
            want_un += ["neither the Ref nor the Alt", "\t".join(lw)]
    got_un = lines(p["lift_vcf_un.txt"])
    messages = want_un[0::2]
    out["lift_vcf"] = {
        **kinds,
        "snps_swapped": sum(m == "alleles are inverted" for m in messages),
        "insertions_indel_message": sum(m == "INDEL records"
                                        for m in messages),
        "deletions_fail_min_match": sum(m == "fails minMatch"
                                        for m in messages),
        "out_equal_numpy": lines(p["lift.vcf"]) == want_out,
        "unmapped_equal_numpy": got_un[1::2] == want_un[1::2]
        and len(got_un) == len(want_un)
        and all(m in g for m, g in zip(messages, got_un[0::2]))}
    # bedpeFilter, bedpeOverlap, intervalContacts
    contacts = bed_rows(p["contacts.bedpe"])
    keep = [r for r in contacts if r[0] == r[3]
            and abs(int(r[1]) - int(r[4])) >= IL_MIN_DIST]
    bpf = lines(p["bpf.bedpe"])
    out["bedpe_filter"] = {"lines": len(bpf), "intra": sum(
        r[0] == r[3] for r in contacts),
        "equal_numpy": bpf == ["\t".join(r) for r in keep]}
    sel = {"merged": spans_index(bed_rows(f["merged.bed"])),
           "tiles": spans_index(bed_rows(p["tiles.bed"]))}
    tile_names = {}
    for r in bed_rows(p["tiles.bed"]):
        tile_names.setdefault(r[0], []).append((int(r[1]), r[3]))
    tile_names = {c: [n for _, n in sorted(v)] for c, v in tile_names.items()}
    want = {k: [] for k in ("bpo0", "bpo5", "bpob", "bpo_tiles",
                            "bpob_tiles", "ic", "ic_tiles")}
    for r in contacts:
        line = "\t".join(r)
        feet = ((r[0], int(r[1]), int(r[2])), (r[3], int(r[4]), int(r[5])))
        # the foot across from each: B's bed where A overlaps, and A's
        across = ("\t".join(r[3:6] + r[6:8] + [r[9]]),
                  "\t".join(r[0:3] + r[6:9]))
        hits = {k: [span_hits(sel[k], *ft) for ft in feet] for k in sel}
        frac = {k: [ov / (ft[2] - ft[1])
                    for (_, ov), ft in zip(hits[k], feet)] for k in sel}
        ha, hb = (len(h[1]) > 0 for h in hits["merged"])
        if ha or hb:
            want["bpo0"].append(line)
        if ha:
            want["bpo5"] += [line] * bool((frac["merged"][0] >= 0.5).any())
        else:
            want["bpo5"] += [line] * int((frac["merged"][1] >= 0.5).sum())
        if ha and hb:
            want["bpob"].append(line)
        for key, k in (("ic", "merged"), ("ic_tiles", "tiles")):
            for side in (0, 1):
                if len(hits[k][side][1]):
                    want[key].append(across[side])
        ta = len(hits["tiles"][0][1]) > 0
        for side, n_rows in ((0, int(ta and (frac["tiles"][0] >= 0.5).any())),
                             (1, 0 if ta else int((frac["tiles"][1] >= 0.5)
                                                  .sum()))):
            lo, ov = hits["tiles"][side]
            names = sorted(tile_names[feet[side][0]][lo:lo + len(ov)])
            want["bpo_tiles"] += [(r[:6], names)] * n_rows
        if all((x >= 0.5).any() for x in frac["tiles"]):
            want["bpob_tiles"].append(line)
    bp = {}
    for k in ("bpo0", "bpo5", "bpob", "bpob_tiles"):
        got = lines(p[k + ".bedpe"])
        bp[k] = {"lines": len(got), "equal_numpy": got == want[k]}
    got = [x.split("\t") for x in lines(p["bpo_tiles.bedpe"])]
    bp["bpo_tiles"] = {"lines": len(got), "equal_numpy": [
        (w[:6], sorted(w[6].split(","))) for w in got] == want["bpo_tiles"]
        and all(len(w) == 7 for w in got)}
    out["bedpe_overlap"] = bp
    out["interval_contacts"] = {}
    for k in ("ic", "ic_tiles"):
        got = lines(p[k + ".bed"])
        out["interval_contacts"][k] = {"lines": len(got),
                                       "equal_numpy": got == want[k]}
    # intervalSubsetMatrix
    files = lines(p["ism_list.txt"])
    W = IL_ISM_WINDOW
    keys = [f"{c}:{s}-{s + W}" for c, n in TOOLS_SIZES
            for s in range(0, n, W)]
    col = {k: i for i, k in enumerate(keys)}
    binary = np.zeros((len(keys), len(files)))
    fraction = [[0.0] * len(files) for _ in keys]
    for j, path in enumerate(files):
        for r in bed_rows(path):
            s, e = int(r[1]), int(r[2])
            for ws in range(s // W * W, e, W):
                i = col[f"{r[0]}:{ws}-{ws + W}"]
                binary[i, j] = 1
                fraction[i][j] += (min(e, ws + W) - max(s, ws)) / W
    ism = {}
    for name, m in (("binary", binary.tolist()), ("fraction", fraction)):
        want_rows = [["Region", *files]] + [[k, *m[col[k]]]
                                            for k in sorted(keys)]
        got = [x.split("\t") for x in lines(
            p["ism.tsv" if name == "binary" else "ism_frac.tsv"])]
        ism[name] = {"rows": len(got) - 1, "equal_numpy": got[0]
                     == want_rows[0] and len(got) == len(want_rows)
                     and all(g[0] == w[0] and [float(x) for x in g[1:]]
                             == w[1:] for g, w in zip(got[1:],
                                                      want_rows[1:]))}
    ism["nonzero_fraction_cells"] = int(sum(v > 0 for r in fraction
                                            for v in r))
    out["interval_subset_matrix"] = ism
    # geneAssignmentStats
    gm = [x.split("\t") for x in lines(p["gas_m.bed"])]
    gn = [x.split("\t") for x in lines(p["gas_n.bed"])]
    names = il["gene_names"]
    share = len(names["matched"]) / il["genes"]
    out["gene_assignment_stats"] = {
        "regions": il["genes"], "planted_share": share,
        "printed": il["gas_stdout"].strip(),
        "matched": len(gm), "non_matched": len(gn),
        "equal_planted": il["gas_stdout"] == repr(share) + "\n"
        and len(gm) == len(names["matched"])
        and len(gn) == il["genes"] - len(names["matched"])
        and [w[3] for w in gm] == names["matched"]
        and [w[3] for w in gn] == names["non_matched"]}
    # overlapEnrichments
    snp_rows = bed_rows(f["snps.bed"])
    space = sum(n for _, n in TOOLS_SIZES)
    oe = {}
    for key, e1 in (("merged", f["merged.bed"]), ("tiles", p["tiles.bed"])):
        idx = spans_index(bed_rows(e1))
        covered = sum(len(span_hits(idx, r[0], int(r[1]), int(r[2]))[1]) > 0
                      for r in snp_rows)
        prob = sum(int(e) - int(s) for st, en in idx.values()
                   for s, e in zip(st, en)) / space
        n = len(snp_rows)
        binom = stats.binom(n, prob)
        want_b = {"enrich": float(binom.sf(covered - 1)),
                  "deplete": float(binom.cdf(covered))}
        pmf = np.array([1.0])
        for _ in range(n):
            pmf = np.convolve(pmf, [1 - prob, prob])
        want_x = [float(pmf.sum()), float(np.arange(n + 1) @ pmf),
                  float(pmf[covered:].sum()), float(pmf[:covered + 1].sum())]
        mu = sum([prob] * n)
        sigma = float(np.sqrt(sum([prob * (1 - prob)] * n)))
        dens = stats.norm(mu, sigma).pdf(np.arange(n + 1))
        want_n = [1.0, mu, float(dens[covered:].sum()),
                  float(dens[:covered + 1].sum())]
        kinds = (("upper", "lower", "exact") if key == "merged"
                 else ("upper", "normal", "exact"))
        res = {"elements2": n, "covered_snps": covered, "probability": prob}
        for kind in kinds:
            fk = "oe_" + ("" if key == "merged" else "tiles_") + kind
            w = lines(p[fk + ".tsv"])[1].split("\t")
            vals = [float(x) for x in w[6:]]
            want_v = {"exact": want_x, "normal": want_n}.get(
                kind, [1.0, prob * n, want_b["enrich"], want_b["deplete"]])
            want_v = want_v[:2] + [covered / want_v[1]] + want_v[2:]
            err = max(rel(g, v) for g, v in zip(vals, want_v))
            res[kind] = {
                "count": int(w[5]), "values": vals, "max_rel_err": err,
                "ok": int(w[5]) == covered and err <= IL_PRINT_RTOL
                and (kind not in ("upper", "lower")
                     or w[7] == f"{prob * n:f}")}
        for m, v in il["library"][key].items():
            err = max(rel(v[2], want_b["enrich"]),
                      rel(v[3], want_b["deplete"]))
            res["library_" + m] = {"max_rel_err": err,
                                   "ok": err <= IL_BINOM_RTOL
                                   and v[1] == prob * n}
        oe[key] = res
    out["overlap_enrichments"] = oe
    # divergenceSpectrum
    cls = {("A", "C"): 5, ("A", "G"): 1, ("A", "T"): 2, ("C", "A"): 4,
           ("C", "G"): 3, ("C", "T"): 0, ("G", "A"): 0, ("G", "C"): 3,
           ("G", "T"): 4, ("T", "A"): 2, ("T", "C"): 1, ("T", "G"): 5}
    recs = [x.split("\t") for x in lines(p["snps.vcf"]) if x[0] != "#"]
    chr1 = [(int(w[1]) - 1) // IL_DIV_WINDOW * 6 + cls[(w[3], w[4])]
            for w in recs if w[0] == "chr1"]
    n_win = dict(TOOLS_SIZES)["chr1"] // IL_DIV_WINDOW
    counts = np.bincount(chr1, minlength=n_win * 6).reshape(n_win, 6)
    want_div = [f"chr1\t{k * IL_DIV_WINDOW}\t{(k + 1) * IL_DIV_WINDOW}\t\t0"
                "\t.\t" + "\t".join(map(str, counts[k])) for k in range(n_win)]
    got = lines(p["div.out.bed"])
    out["divergence_spectrum"] = {"windows": len(got),
                                  "snps": int(counts.sum()),
                                  "equal_numpy": got == want_div}
    return out


def interval_lift_ok(x: dict) -> bool:
    """Every gate of interval_lift_checks met."""
    lr, ls, lv = x["lift_reads"], x["lift_reads_strict"], x["lift_vcf"]
    ism, oe = x["interval_subset_matrix"], x["overlap_enrichments"]
    return bool(
        lr["lifted_equal_numpy"] and lr["unmapped_equal_numpy"]
        and lr["lifted"] > 0.9 * lr["records"]
        and ls["lifted_equal_numpy"] and ls["unmapped_equal_numpy"]
        and ls["unmapped"] > 0
        and lv["out_equal_numpy"] and lv["unmapped_equal_numpy"]
        and lv["snps"] > 0 and lv["snps_swapped"] == lv["snps"]
        and lv["insertions_indel_message"] == lv["insertions"] > 0
        and lv["deletions_fail_min_match"] == lv["deletions"] > 0
        and x["bedpe_filter"]["equal_numpy"] and x["bedpe_filter"]["lines"]
        and all(v["equal_numpy"] and v["lines"] > 0
                for v in x["bedpe_overlap"].values())
        and all(v["equal_numpy"] and v["lines"] > 0
                for v in x["interval_contacts"].values())
        and ism["binary"]["equal_numpy"] and ism["fraction"]["equal_numpy"]
        and ism["nonzero_fraction_cells"] > 0
        and x["gene_assignment_stats"]["equal_planted"]
        and all(v["ok"] for r in oe.values() for v in r.values()
                if isinstance(v, dict))
        and x["divergence_spectrum"]["equal_numpy"]
        and x["divergence_spectrum"]["snps"] > 0)


def vcf_maf_axt_inputs(f: dict, t_fa: str, chain: str, snps: dict,
                       tmp: str) -> dict:
    """The seeded inputs of item 10 and item 11's MAF and axt tools in
    phase_tools_cli, under tmp: the trio VCF (every planted SNP with
    momma 0/0, poppa 1/1 and kiddo 0/1, and VMA_DECOYS sites whose
    genotypes fail the trio test), the names file of -byname, a VCF of
    the chr1 SNPs, VMA_WINDOW bp windows of chr1; a pairwise MAF of the
    chain's ungapped blocks cut to VMA_MAF_BLOCK bp, seeded scores, a
    block in VMA_E_EVERY carrying only a q e line (status C or I, I of
    sizes about and under VMA_EI of the block's), its chr1 part and its
    target FASTA; an axt of the blocks cut to VMA_AXT_PIECE bp and one of
    the blocks whole, N planted in the target row at the SNPs; q.sizes.
    Returns the paths and what the checks need."""
    rng = np.random.default_rng(VMA_SEED)
    p = {k: os.path.join(tmp, k) for k in (
        "trio.vcf", "trio_names.txt", "chr1_snps.vcf", "hap.bed",
        "blocks.maf", "chr1.maf", "t_chr1.fa", "maf_species.txt",
        "n.axt", "nf.axt", "q.sizes")}
    target, query = fasta_strings(t_fa), fasta_strings(f["q.fa"])
    sizes = dict(TOOLS_SIZES)
    names = [c for c, _ in TOOLS_SIZES]
    snp_at = {(c, pos): (ref, alt) for c in snps for pos, ref, alt in snps[c]}
    rows = {(c, pos): (ref, alt, "0/0", "1/1", "0/1")
            for (c, pos), (ref, alt) in snp_at.items()}
    decoy_gts = (("0/0", "0/0", "0/1"), ("1/1", "1/1", "0/1"),
                 ("0/1", "1/1", "0/1"), ("0/0", "1/1", "1/1"),
                 ("1|1", "0|0", "0|0"))
    while len(rows) < len(snp_at) + VMA_DECOYS:
        c = names[int(rng.integers(0, len(names)))]
        pos = int(rng.integers(1, sizes[c] + 1))
        if (c, pos) in rows:
            continue
        ref = target[c][pos - 1]
        alt = "ACGT"[("ACGT".index(ref) + int(rng.integers(1, 4))) % 4]
        rows[(c, pos)] = (ref, alt, *decoy_gts[len(rows) % len(decoy_gts)])
    order = sorted(rows, key=lambda k: (names.index(k[0]), k[1]))
    head = ("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\t"
            "INFO")
    with open(p["trio.vcf"], "w") as fh:
        fh.write(head + "\tFORMAT\t" + "\t".join(VMA_TRIO) + "\n")
        fh.writelines(f"{c}\t{pos}\t.\t{rows[c, pos][0]}\t{rows[c, pos][1]}"
                      "\t30\tPASS\t.\tGT\t" + "\t".join(rows[c, pos][2:])
                      + "\n" for c, pos in order)
    with open(p["trio_names.txt"], "w") as fh:
        fh.write("poppa\nkiddo\n")
    with open(p["chr1_snps.vcf"], "w") as fh:
        fh.write(head + "\n")
        fh.writelines(f"chr1\t{pos}\t.\t{ref}\t{alt}\t30\tPASS\t.\n"
                      for pos, ref, alt in snps["chr1"])
    with open(p["hap.bed"], "w") as fh:
        fh.writelines(f"chr1\t{s}\t{s + VMA_WINDOW}\n"
                      for s in range(0, sizes["chr1"], VMA_WINDOW))
    with open(p["q.sizes"], "w") as fh:
        fh.writelines(f"{c}\t{len(q)}\n" for c, q in query.items())

    # the chain's ungapped blocks, cut to pieces of at most `cut` bases
    cm = chain_maps(chain)

    def pieces(cut):
        for c in names:
            _, t0, q0, size, _ = cm[c]
            for ts, qs, n in zip(t0.tolist(), q0.tolist(), size.tolist()):
                for k in range(0, n, cut):
                    yield c, ts + k, qs + k, min(cut, n - k)

    blocks = []
    with open(p["blocks.maf"], "w") as fh, open(p["chr1.maf"], "w") as c1:
        for out in (fh, c1):
            out.write("##maf version=1 scoring=chip_smoke\n")
        for c, ts, qs, n in pieces(VMA_MAF_BLOCK):
            score = float(rng.integers(0, 2000)) + 0.25 * int(
                rng.integers(0, 4))
            e = None
            if len(blocks) % VMA_E_EVERY == VMA_E_EVERY - 1:
                status = "CI"[len(blocks) // VMA_E_EVERY % 2]
                e_size = (int(n * VMA_EI * rng.uniform(0.2, 1.8))
                          if status == "I" else n)
                e = (status, e_size)
            blocks.append((c, ts, qs, n, score, e))
            text = (f"a score={score}\ns t.{c} {ts} {n} + {sizes[c]} "
                    f"{target[c][ts:ts + n]}\n")
            if e is None:
                text += (f"s q.{c} {qs} {n} + {len(query[c])} "
                         f"{query[c][qs:qs + n]}\n\n")
            else:
                text += f"e q.{c} {qs} {e[1]} + {len(query[c])} {e[0]}\n\n"
            fh.write(text)
            if c == "chr1":
                c1.write(text)
    write_fasta_strings(p["t_chr1.fa"], [("chr1", target["chr1"])])
    with open(p["maf_species.txt"], "w") as fh:
        fh.write("t\nq\n")

    def axt(path, cut):
        out = []
        with open(path, "w") as fh:
            for k, (c, ts, qs, n) in enumerate(pieces(cut)):
                r = bytearray(target[c][ts:ts + n].encode())
                hit = [pos for pos in range(ts + 1, ts + n + 1)
                       if (c, pos) in snp_at]
                for pos in hit:
                    r[pos - 1 - ts] = ord("N")
                score = int(rng.integers(100, 100_000))
                fh.write(f"{k} {c} {ts + 1} {ts + n} {c} {qs + 1} {qs + n} + "
                         f"{score}\n{r.decode()}\n{query[c][qs:qs + n]}\n\n")
                out.append((c, ts, qs, n, score, hit))
        return out

    return {"paths": p, "blocks": blocks, "n_axt": axt(p["n.axt"],
                                                       VMA_AXT_PIECE),
            "nf_axt": axt(p["nf.axt"], 10 ** 9), "rows": rows,
            "order": order, "target": target, "query": query,
            "snp_at": snp_at}


def vcf_maf_axt_steps(step, f: dict, t_fa: str, chain: str, snps: dict,
                      pg: dict, tmp: str, times: dict,
                      dev: torch.device) -> dict:
    """The steps of item 10 and item 11's MAF and axt tools in
    phase_tools_cli, on the inputs of vcf_maf_axt_inputs: the genotype
    caller (``genotype.diploid_base_call_batch``) on pileup's covered
    positions on the card and with device="cpu" (its walls into times);
    filterGenotypes (the trio, and -byname poppa,kiddo), alleleSplit of
    the aligner's SAM (in a directory of its own, the working directory
    restored after), haplotypeGenerator -includeRef, sampleVcf and
    proximityBlockVcf of the trio VCF; vcfAncestorAnnotation of the chr1
    SNPs over multiFaToChain's chr1 pair; vcfAfs of popgen_steps' AFS
    VCF; mafFilter, mafToBed, mafToMultiFa and mafIndels of the MAF;
    axTools --stats (the swapped wiring), --minScore, --swap, --gap and
    --fasta; axtSam --fasta of c.axt. Returns the paths and what the
    checks need."""
    from gonomics_tpu_torch import genotype

    vm = vcf_maf_axt_inputs(f, t_fa, chain, snps, tmp)
    p = vm["paths"]
    p.update({k: os.path.join(tmp, k) for k in (
        "trio_f.vcf", "trio_n.vcf", "allele_split", "hap", "sample.vcf",
        "prox.vcf", "aa.vcf", "afs.txt", "afs_lik.tsv", "maf_f.maf",
        "maf.bed", "maf.fa", "maf_ins.bed", "maf_del.bed", "axt_stats.txt",
        "axt_min.axt", "axt_swap.axt", "axt_gap.axt", "axt_fa.fa",
        "axt.sam")})

    # the genotype caller on pileup's (P, 4) counts at the covered positions
    pos, counts = [], []
    with open(f["pileup.txt"]) as fh:
        for line in fh:
            if not line.startswith("#"):
                w = line.split("\t")
                pos.append((w[0], int(w[1])))
                counts.append([int(x) for x in w[2:6]])
    counts = np.array(counts, np.int64)
    code = {b: i for i, b in enumerate("ACGT")}
    ref = np.array([code[vm["target"][c][q - 1]] for c, q in pos], np.int64)
    prior = genotype.make_diploid_base_prior_cache(*VMA_PRIOR)
    genotype.diploid_base_call_batch(counts[:8], ref[:8], prior, VMA_EPS,
                                     device=dev)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    card = genotype.diploid_base_call_batch(counts, ref, prior, VMA_EPS,
                                            device=dev)
    times["genotype_card"] = time.perf_counter() - t
    t = time.perf_counter()
    cpu = genotype.diploid_base_call_batch(counts, ref, prior, VMA_EPS,
                                           device="cpu")
    times["genotype_cpu"] = time.perf_counter() - t

    step("filterGenotypes", "filterGenotypes", p["trio.vcf"], p["trio_f.vcf"],
         "-f1", "kiddo", "-parentOne", "momma", "-parentTwo", "poppa")
    step("filterGenotypes_byname", "filterGenotypes", p["trio.vcf"],
         p["trio_n.vcf"], "-byname", p["trio_names.txt"])
    # alleleSplit writes <f1>.<parent>.SNPs.sam into the working directory
    os.mkdir(p["allele_split"])
    cwd = os.getcwd()
    os.chdir(p["allele_split"])
    try:
        step("alleleSplit", "alleleSplit", "-f1", "kiddo", "-parentOne",
             "momma", "-parentTwo", "poppa", f["aln.sam"], p["trio.vcf"])
    finally:
        os.chdir(cwd)
    os.mkdir(p["hap"])
    step("haplotypeGenerator", "haplotypeGenerator", t_fa, p["trio.vcf"],
         p["hap.bed"], p["hap"], "-includeRef")
    seed, n_var, n_sam = VMA_SAMPLE
    step("sampleVcf", "sampleVcf", p["trio.vcf"], p["sample.vcf"],
         "-setSeed", str(seed), "-numVariants", str(n_var), "-numSamples",
         str(n_sam))
    step("proximityBlockVcf", "proximityBlockVcf", p["trio.vcf"],
         p["prox.vcf"], str(VMA_PROX[0]), "-setSeed", str(VMA_PROX[1]))
    step("vcfAncestorAnnotation", "vcfAncestorAnnotation",
         p["chr1_snps.vcf"], f["pair.fa"], p["aa.vcf"])
    left, right, points = VMA_AFS
    step("vcfAfs", "vcfAfs", pg["paths"]["sel.vcf"], p["afs.txt"],
         "-plotSelectionLikelihood", p["afs_lik.tsv"], "-leftBound",
         str(left), "-rightBound", str(right), "-numberOfPoints", str(points))

    step("mafFilter", "mafFilter", p["blocks.maf"], p["maf_f.maf"],
         "-threshold", str(VMA_MAF_THRESHOLD))
    step("mafToBed", "mafToBed", p["blocks.maf"], p["maf.bed"], "t")
    step("mafToMultiFa", "mafToMultiFa", p["chr1.maf"], p["t_chr1.fa"],
         p["maf_species.txt"], p["maf.fa"])
    step("mafIndels", "mafIndels", p["blocks.maf"], "t", "q",
         p["maf_ins.bed"], p["maf_del.bed"], "-eiThreshold", str(VMA_EI))

    step("axTools_stats", "axTools", "--stats", "--bedfile",
         p["axt_stats.txt"], f["c.axt"], f["merged.bed"])
    step("axTools_minScore", "axTools", "--minScore",
         str(VMA_AXT_MIN_SCORE), p["n.axt"], p["axt_min.axt"])
    step("axTools_swap", "axTools", "--swap", "--tLen", f["t.sizes"],
         "--qLen", p["q.sizes"], p["n.axt"], p["axt_swap.axt"])
    step("axTools_gap", "axTools", "--gap", p["n.axt"], p["axt_gap.axt"])
    step("axTools_fasta", "axTools", "--fasta", t_fa, p["nf.axt"],
         p["axt_fa.fa"])
    step("axtSam", "axtSam", "--fasta", t_fa, f["c.axt"], p["axt.sam"])
    return {**vm, "inputs": {k: f[k] for k in (
        "aln.sam", "c.axt", "merged.bed", "pair.fa", "t.sizes")},
        "afs_vcf": pg["paths"]["sel.vcf"],
        "genotype": {"counts": counts, "ref": ref, "pos": pos,
                     "prior": prior, "card": card, "cpu": cpu}}


def genotype_numpy(counts: np.ndarray, ref: np.ndarray, prior: np.ndarray,
                   eps: float) -> np.ndarray:
    """The diploid caller's calls in numpy: the flat-error log likelihoods
    of the ten genotypes AA, AC, AG, AT, CC, CG, CT, GG, GT, TT in float64
    plus the prior row of each reference base, numpy's argmax, then the
    homozygous-reference genotype where a row counts no read."""
    x = counts.astype(np.float64)
    a, c, g, t = x.T
    ome, e3 = np.log(1 - eps), np.log(eps / 3)
    het = np.log(0.5 - eps / 3)
    ll = np.stack([
        ome * a + e3 * (c + g + t), het * (a + c) + e3 * (g + t),
        het * (a + g) + e3 * (c + t), het * (a + t) + e3 * (c + g),
        ome * c + e3 * (a + g + t), het * (c + g) + e3 * (a + t),
        het * (c + t) + e3 * (a + g), ome * g + e3 * (a + c + t),
        het * (g + t) + e3 * (a + c), ome * t + e3 * (a + c + g)], axis=1)
    calls = np.argmax(ll + prior[ref], axis=1).astype(np.int8)
    hom = np.array([0, 4, 7, 9], np.int8)
    return np.where(x.sum(axis=1) < 1, hom[ref], calls)


def cigar_runs(r: np.ndarray, q: np.ndarray) -> str:
    """The =/X/I/D runs of two aligned rows of text bytes, as a CIGAR."""
    gap = ord("-")
    op = np.where(r == gap, 2, np.where(q == gap, 3, np.where(r == q, 0, 1)))
    cut = np.flatnonzero(np.diff(op)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(op)]])
    return "".join(f"{e - s}{'=XID'[op[s]]}" for s, e in zip(starts, ends))


def maf_rows(path: str) -> list:
    """The blocks of a MAF as (score text, [s line words]) pairs."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("a"):
                out.append((line.split("score=")[1].split()[0], []))
            elif line.startswith("s"):
                out[-1][1].append(line.split())
    return out


def axt_rows(path: str) -> list:
    """The records of an axt file: (header words, target row, query
    row)."""
    with open(path) as fh:
        lines = [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]
    return [(lines[i].split(), lines[i + 1], lines[i + 2])
            for i in range(0, len(lines) - 2, 4)]


def vcf_maf_axt_checks(vm: dict) -> dict:
    """What the gates of phase_tools_cli's item 10 and item 11 MAF and axt
    steps read from their files, each against numpy or text alone: the
    genotype calls against each other and genotype_numpy, and the share
    of covered planted SNPs at depth >= VMA_MIN_DEPTH called homozygous
    for the query's base; filterGenotypes' records the sites passing
    numpy's trio test, -byname's columns poppa's and kiddo's;
    alleleSplit's reads those of numpy's allele counts from each read's
    CIGAR and bases at the trio SNPs; haplotypeGenerator's records numpy's
    slices with each sample's alts; sampleVcf's records and columns those
    of numpy's PCG64 permutations; proximityBlockVcf's kept records
    VMA_PROX[0] apart and each dropped one near one kept before it in
    numpy's permutation; the AA alleles the query row's bases at the SNPs'
    columns; vcfAfs' frequencies and alpha grid numpy's, its likelihoods
    finite and the largest within a grid step of POP_ALPHA; the MAF
    tools' outputs numpy's from the blocks; the axt tools' outputs
    numpy's from the records."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.io import fasta

    p, t, q = vm["paths"], vm["target"], vm["query"]
    rows, order, snp_at = vm["rows"], vm["order"], vm["snp_at"]
    out = {}

    gt = vm["genotype"]
    want = genotype_numpy(gt["counts"], gt["ref"], gt["prior"], VMA_EPS)
    depth = gt["counts"].sum(axis=1)
    hom = np.array([0, 4, 7, 9])
    at = {k: i for i, k in enumerate(gt["pos"])}
    deep = [(at[k], alt) for k, (_, alt) in snp_at.items()
            if k in at and depth[at[k]] >= VMA_MIN_DEPTH]
    called = sum(int(gt["card"][i]) == hom["ACGT".index(alt)]
                 for i, alt in deep)
    out["genotype"] = {
        "positions": len(gt["pos"]),
        "card_equal_cpu": bool(np.array_equal(gt["card"], gt["cpu"])),
        "card_equal_numpy": bool(np.array_equal(gt["card"], want)),
        "dtype": str(gt["card"].dtype), "deep_snps": len(deep),
        "hom_query_share": called / max(len(deep), 1)}

    def records(path):
        with open(path) as fh:
            lines = fh.read().splitlines()
        return ([ln for ln in lines if ln.startswith("#")],
                [ln.split("\t") for ln in lines if not ln.startswith("#")])

    def homo(g):
        return len(g) == 3 and g[0] == g[2]

    passing = [k for k in order
               if homo(rows[k][2]) and homo(rows[k][3])
               and len(rows[k][4]) == 3 and rows[k][4][0] != rows[k][4][2]
               and rows[k][2][0] != rows[k][3][2]]
    _, got = records(p["trio_f.vcf"])
    out["filter_genotypes"] = {
        "records": len(got), "planted": len(snp_at),
        "equal_numpy": [(r[0], int(r[1])) for r in got] == passing}
    head, got = records(p["trio_n.vcf"])
    out["filter_genotypes_byname"] = {
        "records": len(got),
        "equal_numpy": head[-1].split("\t")[9:] == ["poppa", "kiddo"]
        and [(r[0], int(r[1]), *r[9:]) for r in got]
        == [(*k, rows[k][3], rows[k][4]) for k in order]}

    # alleleSplit: momma's allele is REF, poppa's ALT, at the trio SNPs
    sites = {}
    for c, pos in passing:
        sites.setdefault(c, {})[pos - 1] = rows[c, pos][:2]
    site_pos = {c: np.array(sorted(v), np.int64) for c, v in sites.items()}
    want = {"momma": [], "poppa": []}
    header = []
    with open(vm["inputs"]["aln.sam"]) as fh:
        for line in fh:
            if line.startswith("@"):
                header.append(line.rstrip("\n"))
                continue
            w = line.split("\t")
            if w[5] == "*" or w[2] not in sites:
                continue
            n = [0, 0]
            tp, qp = int(w[3]) - 1, 0
            for size, op in re.findall(r"(\d+)([MIDNSHP=X])", w[5]):
                size = int(size)
                if op in "SI":
                    qp += size
                elif op == "D":
                    tp += size
                elif op == "M":
                    sp = site_pos[w[2]]
                    for s in sp[np.searchsorted(sp, tp):
                                np.searchsorted(sp, tp + size)].tolist():
                        base = w[9][qp + s - tp].upper()
                        ref, alt = sites[w[2]][s]
                        n[0] += base == ref
                        n[1] += base == alt
                    tp += size
                    qp += size
            if n[0] != n[1]:
                want["momma" if n[0] > n[1] else "poppa"].append(w[0])
    split = {}
    for parent in want:
        with open(os.path.join(p["allele_split"],
                               f"kiddo.{parent}.SNPs.sam")) as fh:
            lines = fh.read().splitlines()
        split[parent] = (lines[:len(header)] == header,
                         [ln.split("\t")[0] for ln in lines[len(header):]])
    out["allele_split"] = {
        "poppa_reads": len(split["poppa"][1]),
        "momma_reads": len(split["momma"][1]),
        "headers_equal_input": all(v[0] for v in split.values()),
        "equal_numpy": all(split[k][1] == want[k] for k in want)}

    # haplotypeGenerator: chr1's windows, each sample's alts on the target
    hap_ok, files = True, 0
    for s in range(0, dict(TOOLS_SIZES)["chr1"], VMA_WINDOW):
        e = s + VMA_WINDOW
        seqs = fasta_strings(os.path.join(p["hap"], f"chr1.{s}.{e}.fa"))
        files += 1
        want_h = {"chr1": t["chr1"][s:e]}
        for j, name in enumerate(VMA_TRIO):
            for h, suffix in ((0, "A"), (2, "B")):
                x = bytearray(t["chr1"][s:e].encode())
                for c, pos in order:
                    if c == "chr1" and s < pos <= e \
                            and rows[c, pos][2 + j][h] == "1":
                        x[pos - s - 1] = ord(rows[c, pos][1])
                want_h[f"{name}_{suffix}"] = x.decode()
        hap_ok &= list(seqs.items()) == list(want_h.items())
    out["haplotype_generator"] = {"files": files, "equal_numpy": hap_ok}

    seed, n_var, n_sam = VMA_SAMPLE
    rng = np.random.default_rng(seed)
    pick = [order[i] for i in rng.permutation(len(order))[:n_var]]
    keep = rng.permutation(len(VMA_TRIO))[:n_sam].tolist()
    head, got = records(p["sample.vcf"])
    out["sample_vcf"] = {
        "records": len(got),
        "equal_numpy": head[-1].split("\t")[9:]
        == [VMA_TRIO[i] for i in keep]
        and [(r[0], int(r[1]), r[9:]) for r in got]
        == [(*k, [rows[k][2 + i] for i in keep]) for k in pick]}

    dist, seed = VMA_PROX
    perm = [order[i] for i in np.random.default_rng(seed).permutation(
        len(order))]
    _, got = records(p["prox.vcf"])
    kept = [(r[0], int(r[1])) for r in got]
    kept_set, before, prox_ok = set(kept), [], True
    for k in perm:
        near = any(c == k[0] and abs(pos - k[1]) < dist for c, pos in before)
        if k in kept_set:
            prox_ok &= not near
            before.append(k)
        else:
            prox_ok &= near
    out["proximity_block_vcf"] = {
        "kept": len(kept), "records": len(order),
        "equal_numpy": prox_ok and kept == before}

    pair = list(fasta_strings(vm["inputs"]["pair.fa"]).values())
    cols = np.flatnonzero(np.frombuffer(pair[0].encode(), np.uint8)
                          != ord("-"))
    _, got = records(p["aa.vcf"])
    out["vcf_ancestor_annotation"] = {
        "records": len(got),
        "equal_numpy": [r[7] for r in got]
        == [f"AA={pair[1][cols[int(r[1]) - 1]]}" for r in got],
        "aa_is_alt": all(r[7] == f"AA={r[4]}" for r in got)}

    with open(vm["afs_vcf"]) as fh:
        alts = [ln.split("\t")[9:] for ln in fh if not ln.startswith("#")]
    n_afs = [sum(g.count("1") for g in a) for a in alts]
    with open(p["afs.txt"]) as fh:
        freq = fh.read().splitlines()
    left, right, points = VMA_AFS
    grid = left + (np.arange(points + 1) / points) * (right - left)
    with open(p["afs_lik.tsv"]) as fh:
        lik = [ln.split("\t") for ln in fh.read().splitlines()[1:]]
    values = np.array([float(x[1]) for x in lik])
    best = (float(grid[int(np.argmax(values))]) if len(lik) == len(grid)
            else None)
    out["vcf_afs"] = {
        "sites": len(freq),
        "freq_equal_numpy": freq == [f"{k / POP_N:f}" for k in n_afs],
        "alphas_equal_numpy": [x[0] for x in lik] == [f"{a:e}" for a in grid],
        "likelihoods_finite": bool(np.isfinite(values).all()),
        "best_alpha": best,
        "best_within_step": best is not None
        and abs(best - POP_ALPHA) <= (right - left) / points}

    blocks = vm["blocks"]
    got = maf_rows(p["maf_f.maf"])
    want_f = [b for b in blocks if b[4] >= VMA_MAF_THRESHOLD]
    out["maf_filter"] = {
        "blocks": len(got), "of": len(blocks),
        "equal_numpy": [(s, [w[1:6] for w in ws]) for s, ws in got]
        == [(f"{b[4]:.1f}", [["t." + b[0], str(b[1]), str(b[3]), "+",
                               str(len(t[b[0]]))]]
             + ([] if b[5] else [["q." + b[0], str(b[2]), str(b[3]), "+",
                                  str(len(q[b[0]]))]])) for b in want_f]}
    got = bed_rows(p["maf.bed"])
    out["maf_to_bed"] = {
        "lines": len(got),
        "equal_numpy": got == [[b[0], str(b[1]), str(b[1] + b[3]), "t;q",
                                str(int(b[4]))] for b in blocks]}
    rows_fa = list(fasta_strings(p["maf.fa"]).items())
    q_want = np.full(len(t["chr1"]), ord("-"), np.uint8)
    for c, ts, qs, n, _, e in blocks:
        if c == "chr1" and e is None:
            q_want[ts:ts + n] = np.frombuffer(q[c][qs:qs + n].encode(),
                                              np.uint8)
    out["maf_to_multi_fa"] = {
        "names": [n for n, _ in rows_fa],
        "target_equal": rows_fa[0][1] == t["chr1"],
        "query_equal_numpy": rows_fa[1][1] == q_want.tobytes().decode()}
    ins, dele = [], []
    for c, ts, qs, n, score, e in blocks:
        if e is not None and (e[0] == "C" or e[1] < VMA_EI * n):
            tag = "eC" if e[0] == "C" else "eI"
            ins.append([c, str(ts), str(ts + n), f"ins_{tag}",
                        str(int(score))])
            dele.append([c, str(qs), str(qs + e[1]), f"del_{tag}",
                         str(int(score))])
    got_i, got_d = bed_rows(p["maf_ins.bed"]), bed_rows(p["maf_del.bed"])
    out["maf_indels"] = {
        "lines": len(got_i), "ei": sum(r[3] == "ins_eI" for r in got_i),
        "equal_numpy": got_i == ins and got_d == dele}

    merged = spans_index(bed_rows(vm["inputs"]["merged.bed"]))
    want_s = ["length\tpercentIdentity"]
    for w, r, qr in axt_rows(vm["inputs"]["c.axt"]):
        cs, ce = int(w[2]) - 1, int(w[3])
        if not len(span_hits(merged, w[1], cs, ce)[1]):
            continue
        rb = np.frombuffer(r.upper().encode(), np.uint8)
        qb = np.frombuffer(qr.upper().encode(), np.uint8)
        end = int(np.flatnonzero(rb != ord("-"))[-1]) + 1
        eq = rb[:end] == qb[:end]
        nn = int((eq & (rb[:end] == ord("N"))).sum())
        pid = (int(eq.sum()) - nn) / (end - nn) * 100
        want_s.append(f"{ce - cs}\t{pid:.2f}")
    with open(p["axt_stats.txt"]) as fh:
        got = fh.read().splitlines()
    out["ax_tools_stats"] = {"lines": len(got) - 1,
                             "equal_numpy": got == want_s}
    n_axt = vm["n_axt"]
    got = axt_rows(p["axt_min.axt"])
    out["ax_tools_min_score"] = {
        "records": len(got),
        "equal_numpy": [int(w[8]) for w, _, _ in got]
        == [a[4] for a in n_axt if a[4] >= VMA_AXT_MIN_SCORE]}
    got = axt_rows(p["axt_swap.axt"])
    src = axt_rows(p["n.axt"])
    out["ax_tools_swap"] = {
        "records": len(got),
        "equal_numpy": [(w[1:8], r, qr) for w, r, qr in got]
        == [([w[4], w[5], w[6], w[1], w[2], w[3], "+"], r, qr)
            for w, r, qr in src]}
    got = axt_rows(p["axt_gap.axt"])
    out["ax_tools_gap"] = {
        "records": len(got), "of": len(n_axt),
        "equal_numpy": [(w[1], int(w[2])) for w, _, _ in got]
        == [(a[0], a[1] + 1) for a in n_axt if a[5]]}
    got = [(r.name, dna.to_string(r.seq))
           for r in fasta.read_forced(p["axt_fa.fa"])]
    fa_want = []
    for c, ts, qs, n, _, hit in vm["nf_axt"]:
        x = bytearray(t[c].encode())
        for pos in hit:
            x[pos - 1] = ord(snp_at[c, pos][1])
        fa_want.append((c, x.decode()))
    out["ax_tools_fasta"] = {"records": len(got),
                             "equal_numpy": got == fa_want}

    sam_want, x_want = [], []
    for w, r, qr in axt_rows(vm["inputs"]["c.axt"]):
        rb, qb = (np.frombuffer(x.encode(), np.uint8) for x in (r, qr))
        sam_want.append((w[4], w[1], w[2], cigar_runs(rb, qb),
                         qr.replace("-", "")))
        x_want.append(sum(1 for c, pos in snp_at
                          if c == w[1] and int(w[2]) <= pos <= int(w[3])))
    with open(p["axt.sam"]) as fh:
        got = [ln.split("\t") for ln in fh.read().splitlines()
               if not ln.startswith("@")]
    out["axt_sam"] = {
        "records": len(got),
        "equal_numpy": [(r[0], r[2], r[3], r[5], r[9]) for r in got]
        == sam_want,
        "x_equal_planted": [sum(int(n) for n, op in re.findall(
            r"(\d+)([=XID])", r[5]) if op == "X") for r in got] == x_want}
    return out


def vcf_maf_axt_ok(x: dict) -> bool:
    """Every gate of vcf_maf_axt_checks met."""
    g, a = x["genotype"], x["allele_split"]
    return bool(
        g["card_equal_cpu"] and g["card_equal_numpy"] and g["dtype"] == "int8"
        and g["deep_snps"] > 0 and g["hom_query_share"] >= VMA_HOM_SHARE
        and x["filter_genotypes"]["records"]
        == x["filter_genotypes"]["planted"]
        and a["poppa_reads"] > a["momma_reads"] and a["headers_equal_input"]
        and all(v["equal_numpy"] for k, v in x.items()
                if isinstance(v, dict) and "equal_numpy" in v)
        and all(x[k]["records"] > 0 for k in (
            "filter_genotypes_byname", "sample_vcf", "vcf_ancestor_annotation",
            "ax_tools_min_score", "ax_tools_swap", "ax_tools_gap",
            "ax_tools_fasta", "axt_sam"))
        and x["vcf_ancestor_annotation"]["aa_is_alt"]
        and x["vcf_afs"]["freq_equal_numpy"]
        and x["vcf_afs"]["alphas_equal_numpy"]
        and x["vcf_afs"]["likelihoods_finite"]
        and x["vcf_afs"]["best_within_step"]
        and x["maf_to_multi_fa"]["target_equal"]
        and x["maf_to_multi_fa"]["query_equal_numpy"]
        and x["maf_indels"]["ei"] > 0 and x["axt_sam"]["x_equal_planted"]
        and 0 < x["ax_tools_gap"]["records"] < x["ax_tools_gap"]["of"]
        and 0 < x["proximity_block_vcf"]["kept"]
        < x["proximity_block_vcf"]["records"])


def gtf_accel_inputs(f: dict, t_fa: str, tmp: str) -> dict:
    """The seeded inputs of slice 11.11b in phase_tools_cli, under tmp:
    genes.gtf, GA_GENES genes a chrom, those of chr1 and chr2 at least
    GA_GENE_GAP bp apart, chrU's at its ends too (no chain covers chrU);
    each of 1-3 transcripts of 1-6 exons on either strand, two thirds
    coding (a CDS line on every exon past a 5UTR, frames 0-2, some 5UTR
    and 3UTR lines, start_codon and stop_codon lines), about one in ten
    of chr1's and chr2's with an empty gene_name, every GA_TIE_EVERY-th
    of two transcripts of equal CDS and cDNA lengths, the second
    shifted; ga.sizes (t.sizes and chrU); the aligner's SAM with each
    read's name extended by _BX:<barcode>_UMI:<umi> (GA_BARCODES seeded
    barcodes), sorted by barcode, stably; a normalisation table for a
    seeded third of the genes; getPromoter's list, filter's list,
    geneIdToName's table and its tab file of TSSs named by gene id;
    accel.fa, four rows (hum, chimp, gor, orang) of GA_ACCEL_BP columns
    of chr2 from GA_ACCEL_AT in the manner of mutant_rows, hum's private
    rate GA_HOT_X times over in columns GA_HOT; a search space over about
    70% of the slice; GA_REGIONS regions for branchLengthsMultiFaBed and
    one equal to a window of the SNP run.
    Returns the paths and what the checks need."""
    rng = np.random.default_rng(GA_SEED)
    p = {k: os.path.join(tmp, k) for k in (
        "genes.gtf", "ga.sizes", "bx.sam", "norm.tsv", "promoter_names.txt",
        "filter_names.txt", "id_table.tsv", "tss_ids.txt", "accel.fa",
        "space.bed", "regions.bed")}
    sizes = {**dict(TOOLS_SIZES), "chrU": GA_CHRU_BP}
    with open(p["ga.sizes"], "w") as fh:
        fh.writelines(f"{c}\t{n}\n" for c, n in sizes.items())
    n_all = sum(n for _, n in GA_GENES)
    ids = [f"ENSG{i:05d}" for i in rng.permutation(n_all) * 7 + 11]

    def transcript(tid, gs, ge, coding):
        ne = int(rng.integers(1, 7))
        pts = np.sort(rng.choice(np.arange(gs, ge + 1), 2 * ne,
                                 replace=False)).tolist()
        tx = {"id": tid, "exons": [], "cds": [], "utr5": [], "utr3": []}
        utr5, utr3 = coding and rng.random() < 0.5, coding and \
            rng.random() < 0.5
        for i in range(ne):
            s, e = pts[2 * i], pts[2 * i + 1]
            tx["exons"].append((s, e))
            u5 = u3 = cds = None
            if coding:
                cs, ce = s, e
                if i == 0 and utr5 and e - s >= 4:
                    cut = int(rng.integers(s + 1, e))
                    u5, cs = (s, cut - 1), cut
                if i == ne - 1 and utr3 and ce - cs >= 4:
                    cut = int(rng.integers(cs + 1, ce))
                    u3, ce = (cut + 1, ce), cut
                cds = (cs, ce, int(rng.integers(0, 3)))
            tx["utr5"].append(u5)
            tx["cds"].append(cds)
            tx["utr3"].append(u3)
        return tx

    def shifted(tx, tid, by):
        def mv(x):
            return None if x is None else (x[0] + by, x[1] + by, *x[2:])
        return {"id": tid, **{k: [mv(x) for x in tx[k]]
                              for k in ("exons", "cds", "utr5", "utr3")}}

    genes, k = [], 0
    for chrom, n in GA_GENES:
        size = sizes[chrom]
        if chrom == "chrU":  # at the ends too: promoters clipped at both
            spans = [(1, 150), (size // 3, size // 3 + 200),
                     (2 * size // 3, 2 * size // 3 + 150),
                     (size - 160, size - 10)][:n]
        else:
            slot = (size - 2 * GA_GENE_GAP) // n
            spans = []
            for i in range(n):
                length = int(rng.integers(100, slot - GA_GENE_GAP + 1))
                off = int(rng.integers(0, slot - GA_GENE_GAP - length + 1))
                gs = GA_GENE_GAP + i * slot + off + 1
                spans.append((gs, gs + length - 1))
        for gs, ge in spans:
            gid = ids[k]
            tie = k % GA_TIE_EVERY == 0 and chrom != "chrU"
            coding = rng.random() < 2 / 3
            name = ("" if chrom != "chrU" and rng.random() < 0.1
                    else f"gene{k}")
            g = {"id": gid, "name": name, "chrom": chrom, "span": (gs, ge),
                 "strand": "+" if rng.random() < 0.5 else "-", "tx": []}
            if tie:
                t0 = transcript(f"{gid}.1", gs, ge - 10, coding)
                room = ge - t0["exons"][-1][1]
                g["tx"] = [t0, shifted(t0, f"{gid}.2",
                                       int(rng.integers(1, room + 1)))]
            else:
                g["tx"] = [transcript(f"{gid}.{t + 1}", gs, ge, coding)
                           for t in range(int(rng.integers(1, 4)))]
            genes.append(g)
            k += 1

    def att(**kv):
        return " ".join(f'{a} "{v}";' for a, v in kv.items())

    lines = ["#!genome-build chip_smoke"]
    for g in genes:
        c, st = g["chrom"], g["strand"]

        def row(feature, s, e, score=".", frame="."):
            return f"{c}\tchip\t{feature}\t{s}\t{e}\t{score}\t{st}\t{frame}\t"

        lines.append(row("gene", *g["span"]) + att(gene_id=g["id"],
                                                   gene_name=g["name"]))
        for tx in g["tx"]:
            ta = att(gene_id=g["id"], transcript_id=tx["id"],
                     gene_name=g["name"])
            score = "." if rng.random() < 0.8 else f"{rng.integers(1, 99)}.5"
            lines.append(row("transcript", tx["exons"][0][0],
                             tx["exons"][-1][1], score) + ta)
            ne = len(tx["exons"])
            for i, (s, e) in enumerate(tx["exons"]):
                ea = att(gene_id=g["id"], transcript_id=tx["id"],
                         exon_number=str(i + 1), exon_id=f"{tx['id']}.e{i}",
                         gene_name=g["name"])
                lines.append(row("exon", s, e) + ea)
                u5, cds, u3 = tx["utr5"][i], tx["cds"][i], tx["utr3"][i]
                if u5:
                    lines.append(row("5UTR", *u5) + ea)
                if cds:
                    lines.append(row("CDS", cds[0], cds[1], ".",
                                     str(cds[2])) + ea)
                    if i == 0:
                        lines.append(row("start_codon", cds[0],
                                         min(cds[0] + 2, cds[1]), ".", "0")
                                     + ea)
                    if i == ne - 1:
                        lines.append(row("stop_codon", max(cds[1] - 2, cds[0]),
                                         cds[1], ".", "0") + ea)
                if u3:
                    lines.append(row("3UTR", *u3) + ea)
    with open(p["genes.gtf"], "w") as fh:
        fh.writelines(ln + "\n" for ln in lines)

    # the aligner's SAM, barcoded and sorted by barcode (stably)
    codes = ["".join(rng.choice(list("ACGT"), 16)) for _ in range(GA_BARCODES)]
    head, body = [], []
    with open(f["aln.sam"]) as fh:
        for line in fh:
            if line.startswith("@"):
                head.append(line)
                continue
            w = line.split("\t", 1)
            bx = codes[int(rng.integers(0, GA_BARCODES))]
            umi = "".join(rng.choice(list("ACGT"), 10))
            body.append((bx, f"{w[0]}_BX:{bx}_UMI:{umi}\t{w[1]}"))
    body.sort(key=lambda r: r[0])
    with open(p["bx.sam"], "w") as fh:
        fh.writelines(head)
        fh.writelines(r for _, r in body)
    norm = {g["id"]: f"{rng.uniform(0.2, 3.0):.4f}" for g in genes
            if rng.random() < 1 / 3}
    with open(p["norm.tsv"], "w") as fh:
        fh.writelines(f"{a}\t{v}\n" for a, v in norm.items())

    named = [g for g in genes if g["name"]]
    pick = rng.permutation(len(named))
    promoter = [named[i]["name"] for i in sorted(pick[:len(named) // 4])]
    promoter += [promoter[0]] + [g["name"] for g in genes
                                 if g["chrom"] == "chrU"]
    listed = [g["name"] for g in named[::9]]
    for path, names in ((p["promoter_names.txt"], promoter),
                        (p["filter_names.txt"], listed)):
        with open(path, "w") as fh:
            fh.writelines(x + "\n" for x in names)
    table = {g["id"]: f"sym_{g['id'][4:]}" for g in genes
             if rng.random() < 0.5}
    with open(p["id_table.tsv"], "w") as fh:
        fh.writelines(f"{a}\t{v}\n" for a, v in table.items())
    tss_ids = []
    for g in genes:
        for tx in g["tx"]:
            s, e = tx["exons"][0][0], tx["exons"][-1][1]
            at = s if g["strand"] == "+" else e
            tss_ids.append(f"{g['chrom']}\t{at - 1}\t{at}\t{g['id']}")
    with open(p["tss_ids.txt"], "w") as fh:
        fh.writelines(x + "\n" for x in tss_ids)

    # accel.fa: hum, chimp, gor, orang from a slice of chr2
    base = fasta_strings(t_fa)["chr2"][GA_ACCEL_AT:GA_ACCEL_AT + GA_ACCEL_BP]
    rows = [np.frombuffer(r.encode(), np.uint8).copy()
            for r in mutant_rows(rng, base, 4, GA_RATE, GA_GAP_RUNS)]
    acgt = np.frombuffer(b"ACGT", np.uint8)
    hum, b = rows[0], np.frombuffer(base.encode(), np.uint8)
    hot = np.zeros(len(b), bool)
    hot[GA_HOT[0]:GA_HOT[1]] = True
    extra = hot & (hum != ord("-")) & (rng.random(len(b))
                                       < (GA_HOT_X - 1) * GA_RATE)
    hum[extra] = acgt[(np.searchsorted(acgt, hum[extra])
                       + rng.integers(1, 4, int(extra.sum()))) % 4]
    hum[0], hum[-1] = b[0], b[-1]  # the reference starts and ends a base
    rows = [r.tobytes().decode() for r in rows]
    write_fasta_strings(p["accel.fa"], zip(("hum", "chimp", "gor", "orang"),
                                           rows))
    ref_len = sum(ch != "-" for ch in rows[0][:-1])
    space, at = [], 0
    while at < ref_len:
        n_on = int(rng.integers(100, 400))
        space.append((at, min(at + n_on, ref_len)))
        at += n_on + int(rng.integers(40, 170))
    with open(p["space.bed"], "w") as fh:
        fh.writelines(f"chr2\t{s}\t{e}\n" for s, e in space)
        fh.write("chr1\t0\t5000\n")
    bits = np.zeros(ref_len, bool)
    for s, e in space:
        bits[s:e] = True
    snp_windows = accel_windows(rows[0], GA_WINDOW, bits,
                                int(GA_PROPORTION * GA_WINDOW))
    twin = snp_windows[len(snp_windows) // 2]
    starts = np.sort(rng.choice(np.arange(0, ref_len - 320), GA_REGIONS,
                                replace=False))
    regions = sorted({(int(s), int(s) + int(rng.integers(50, 301)))
                      for s in starts} | {twin})
    with open(p["regions.bed"], "w") as fh:
        fh.writelines(f"chr2\t{s}\t{e}\n" for s, e in regions)
    return {"paths": p, "genes": genes, "sizes": sizes, "norm": norm,
            "promoter": promoter, "listed": listed, "table": table,
            "tss_ids": tss_ids, "rows": rows, "ref_len": ref_len,
            "bits": bits, "regions": regions, "twin": twin}


def gtf_accel_steps(step, f: dict, t_fa: str, chain: str, tmp: str,
                    times: dict) -> dict:
    """The steps of slice 11.11b in phase_tools_cli, on the inputs of
    gtf_accel_inputs: gtfTools filter (-codingTranscript, -chromFilter
    chr2, -geneNameList with -chromFilter chr2) and toBed (plain, -tss
    with and without -merge, -firstTwoCodonBases); getPromoter -upstream
    and -downstream GA_PROMOTER; geneIdToName with and without
    -keepMatching (its stdout kept); scCount of the barcoded SAM with and
    without -expNormalizationFile; quickOrthologs t q through t_q.chain,
    with and without --canonicalTranscript; multiFaAcceleration chr2 of
    accel.fa at -windowSize GA_WINDOW with -rawVelOut -rawInitialOut,
    and with -useSnpDistance -searchSpaceBed at -searchSpaceProportion
    GA_PROPORTION (raw outputs too); branchLengthsMultiFaBed chr2 of the
    regions with -qOutFile -useSnpDistance. Returns the paths and what
    the checks need."""
    ga = gtf_accel_inputs(f, t_fa, tmp)
    p = ga["paths"]
    p.update({k: os.path.join(tmp, k) for k in (
        "gtf_coding.gtf", "gtf_chr2.gtf", "gtf_listed.gtf", "gtf.bed",
        "gtf_tss.bed", "gtf_tss_merged.bed", "gtf_codons.bed", "promoter.bed",
        "named.txt", "named_keep.txt", "sc.tsv", "sc_norm.tsv", "orth.tsv",
        "orth_un.txt", "orth_canon.tsv", "orth_canon_un.txt", "vel.bed",
        "acc.bed", "init.bed", "raw_vel.bed", "raw_init.bed", "vel_snp.bed",
        "acc_snp.bed", "init_snp.bed", "raw_vel_snp.bed", "raw_init_snp.bed",
        "bl_vel.bed", "bl_init.bed", "bl_ungapped.bed", "bl_q.bed")})
    gtf, sizes = p["genes.gtf"], p["ga.sizes"]
    step("gtfTools_filter_coding", "gtfTools", "filter", gtf,
         p["gtf_coding.gtf"], "-codingTranscript")
    step("gtfTools_filter_chrom", "gtfTools", "filter", gtf,
         p["gtf_chr2.gtf"], "-chromFilter", "chr2")
    step("gtfTools_filter_names", "gtfTools", "filter", gtf,
         p["gtf_listed.gtf"], "-geneNameList", p["filter_names.txt"],
         "-chromFilter", "chr2")
    step("gtfTools_toBed", "gtfTools", "toBed", gtf, p["gtf.bed"])
    step("gtfTools_toBed_tss", "gtfTools", "toBed", gtf, p["gtf_tss.bed"],
         "-tss", "-chromSizeFile", sizes)
    step("gtfTools_toBed_tss_merge", "gtfTools", "toBed", gtf,
         p["gtf_tss_merged.bed"], "-tss", "-chromSizeFile", sizes, "-merge")
    step("gtfTools_toBed_codons", "gtfTools", "toBed", gtf,
         p["gtf_codons.bed"], "-firstTwoCodonBases")
    step("getPromoter", "getPromoter", p["promoter_names.txt"], gtf,
         p["promoter.bed"], sizes, "-upstream", str(GA_PROMOTER[0]),
         "-downstream", str(GA_PROMOTER[1]))
    stdout = {}
    for name, out, keep in (("geneIdToName", "named.txt", []),
                            ("geneIdToName_keep", "named_keep.txt",
                             ["-keepMatching"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            step(name, "geneIdToName", p["id_table.tsv"], p["tss_ids.txt"],
                 p[out], *keep)
        stdout[name] = buf.getvalue()
    step("scCount", "scCount", p["bx.sam"], gtf, p["sc.tsv"])
    step("scCount_norm", "scCount", p["bx.sam"], gtf, p["sc_norm.tsv"],
         "-expNormalizationFile", p["norm.tsv"])
    step("quickOrthologs", "quickOrthologs", "t", "q", gtf, chain, sizes,
         p["orth.tsv"], p["orth_un.txt"])
    step("quickOrthologs_canonical", "quickOrthologs",
         "--canonicalTranscript", "t", "q", gtf, chain, sizes,
         p["orth_canon.tsv"], p["orth_canon_un.txt"])
    step("multiFaAcceleration", "multiFaAcceleration", "chr2", p["accel.fa"],
         p["vel.bed"], p["acc.bed"], p["init.bed"], "-windowSize",
         str(GA_WINDOW), "-rawVelOut", p["raw_vel.bed"], "-rawInitialOut",
         p["raw_init.bed"])
    step("multiFaAcceleration_snp", "multiFaAcceleration", "chr2",
         p["accel.fa"], p["vel_snp.bed"], p["acc_snp.bed"], p["init_snp.bed"],
         "-windowSize", str(GA_WINDOW), "-useSnpDistance", "-searchSpaceBed",
         p["space.bed"], "-searchSpaceProportion", str(GA_PROPORTION),
         "-rawVelOut", p["raw_vel_snp.bed"], "-rawInitialOut",
         p["raw_init_snp.bed"])
    step("branchLengthsMultiFaBed", "branchLengthsMultiFaBed", "chr2",
         p["accel.fa"], p["regions.bed"], p["bl_vel.bed"], p["bl_init.bed"],
         p["bl_ungapped.bed"], "-qOutFile", p["bl_q.bed"], "-useSnpDistance")
    return {**ga, "stdout": stdout, "chain": chain}


def accel_windows(row0: str, window: int, bits=None, threshold: int = 0):
    """The (start, end) of the rows multiFaAcceleration writes, in numpy:
    a window at each reference base of the first row while the reference
    counter stays under the reference length (the non-gap columns before
    the last) less the window; with a search space, a window needs
    threshold of its bases in bits, counted by a sum that slides at every
    alignment column, gap columns too, as the tool slides it."""
    ref = np.frombuffer(row0.encode(), np.uint8) != ord("-")
    rc = np.concatenate([[0], np.cumsum(ref)[:-1]])
    keep = ref & (rc < int(ref[:-1].sum()) - window)
    if bits is not None:
        padded = np.concatenate([bits, np.zeros(window + 1, bool)])
        delta = np.where(rc > 0, padded[rc + window - 1].astype(np.int64)
                         - padded[np.maximum(rc - 1, 0)].astype(np.int64), 0)
        keep &= int(bits[:window].sum()) + np.cumsum(delta) >= threshold
    return [(int(r), int(r) + window) for r in rc[keep]]


def accel_q(d, w, b) -> float:
    """The four-way least-squares objective of lengths b = (hum_hca,
    chimp_hca, hca_hga, hga_gor, hga_orang) at distances d, weights w,
    in the reference's form: its first term doubles chimp_hca."""
    h, c, hh, g, o = b
    total = w[0] * (d[0] - (c + c)) ** 2
    total += w[1] * (d[1] - (h + hh + g)) ** 2
    total += w[2] * (d[2] - (h + hh + o)) ** 2
    total += w[3] * (d[3] - (c + hh + g)) ** 2
    total += w[4] * (d[4] - (c + hh + o)) ** 2
    total += w[5] * (d[5] - (g + o)) ** 2
    return float(total)


def accel_fit_numpy(d, w, zero_constant: float = 1000.0,
                    epsilon: float = 1e-8) -> list:
    """The alternating least squares of the four-way tree in plain
    floats (no negative lengths, the distance weights): each round fits
    the left triple (hum, chimp, the rest) and then the right one (the
    hca node, gor, orang) in closed form, a negative length clamped to 0
    and the other two refit, and keeps the round only while Q falls."""
    def wt(x):
        return zero_constant if x == 0 else 1.0 / (x * x)

    def nn(d1, d2, v1, v2, w1, w2):
        return max((w1 * (d1 - v1) + w2 * (d2 - v2)) / (w1 + w2), 0.0)

    def triple(dab, dac, dbc, wab, wac, wbc, right):
        va, vb, vc = ((dab + dac - dbc) / 2.0, (dab + dbc - dac) / 2.0,
                      (dac + dbc - dab) / 2.0)
        if va < 0 and vb < 0 and vc < 0:
            return 0.0, 0.0, 0.0
        if va < 0:
            va = 0.0
            if vb < 0:
                vb = 0.0
                vc = nn(dac, dbc, va, vb, wac, wbc)
            elif vc < 0:
                vc = 0.0
                vb = nn(dab, dbc, va, vc, wab, wbc)
            else:
                vc = nn(dac, dbc, va, vb, wac, wbc)
                vb = nn(dab, dbc, va, vc, wab, wbc)
        elif vb < 0:
            vb = 0.0
            if vc < 0:
                vc = 0.0
                va = nn(dac, dab, vc, vb, wac, wab)
            elif right:
                vc = nn(dac, dbc, va, vb, wac, wbc)
                va = nn(dab, dac, vb, vc, wab, wac)
            else:
                va = nn(dac, dab, vc, vb, wac, wab)
                vc = nn(dac, dbc, va, vb, wac, wbc)
        elif vc < 0:
            vc = 0.0
            if right:
                vb = nn(dab, dbc, va, vc, wab, wbc)
                va = nn(dab, dac, vb, vc, wab, wac)
            else:
                va = nn(dac, dab, vc, vb, wac, wab)
                vb = nn(dab, dbc, va, vc, wab, wbc)
        return va, vb, vc

    b = [1.0] * 5
    q = accel_q(d, w, b)
    diff, rounds = epsilon + 1, 0
    while diff > epsilon and rounds < 100_000:
        old = list(b)
        hum_hga = (w[1] * (d[1] - b[3]) + w[2] * (d[2] - b[4])) / (w[1] + w[2])
        chimp_hga = (w[3] * (d[3] - b[3]) + w[4] * (d[4] - b[4])) / (w[3]
                                                                    + w[4])
        b[0], b[1], b[2] = triple(d[0], hum_hga, chimp_hga, wt(d[0]),
                                  wt(hum_hga), wt(chimp_hga), False)
        hca_gor = (w[1] * (d[1] - b[0]) + w[3] * (d[3] - b[1])) / (w[1] + w[3])
        hca_orang = (w[2] * (d[2] - b[0]) + w[4] * (d[4] - b[1])) / (w[2]
                                                                    + w[4])
        b[2], b[3], b[4] = triple(hca_gor, hca_orang, d[5], wt(hca_gor),
                                  wt(hca_orang), wt(d[5]), True)
        nq = accel_q(d, w, b)
        diff = abs(q - nq)
        if nq > q:
            b, diff = old, 0
        q = nq
        rounds += 1
    return b


def gtf_accel_checks(ga: dict) -> dict:
    """What the gates of phase_tools_cli's slice 11.11b steps read from
    their files, each against numpy or text alone, importing none of
    these tools' modules: filter's gene ids and line counts from the
    generated genes (the name list passing a listed gene whatever its
    chrom); toBed's lines, TSSs, merged TSSs and codons; getPromoter's
    windows (minus strand around the transcript's start, clipped);
    geneIdToName's lines and counts; scCount's matrices from each read's
    CIGAR span against each gene's first transcript; quickOrthologs'
    lifts against lift_numpy through chain_maps, chrU unmapped, the
    canonical transcript by the strictly-longer swap; the acceleration
    windows, normalisation and planted stretch; branchLengthsMultiFaBed's
    distances (numpy prefix sums over the ungapped columns), lengths and
    Q against accel_fit_numpy and accel_q, and the region equal to a
    window of the SNP run against that run's raw lengths."""
    p, genes, sizes = ga["paths"], ga["genes"], ga["sizes"]
    out = {}

    def lines(path):
        with open(path) as fh:
            return fh.read().splitlines()

    def rows(path):
        return [ln.split("\t") for ln in lines(path)]

    def start_end(tx):
        return tx["exons"][0][0], tx["exons"][-1][1]

    def n_lines(g):
        return sum(1 + len(tx["exons"]) + sum(
            x is not None for k in ("cds", "utr5", "utr3") for x in tx[k])
            for tx in g["tx"])

    listed = set(ga["listed"])
    for key, path, keep in (
            ("coding", "gtf_coding.gtf",
             lambda g: any(x for tx in g["tx"] for x in tx["cds"])),
            ("chrom", "gtf_chr2.gtf", lambda g: g["chrom"] == "chr2"),
            ("names", "gtf_listed.gtf",
             lambda g: g["name"] in listed or g["chrom"] == "chr2")):
        got = rows(p[path])
        ids = []
        for r in got:
            gid = r[8].split('"')[1]
            if not ids or ids[-1] != gid:
                ids.append(gid)
        want = [g for g in genes if keep(g)]
        out[f"filter_{key}"] = {
            "genes": len(ids), "lines": len(got),
            "equal_numpy": ids == [g["id"] for g in want]
            and len(got) == sum(n_lines(g) for g in want)
            and not {r[2] for r in got} - {"transcript", "exon", "5UTR",
                                            "CDS", "3UTR"}}
    out["filter_names"]["listed_off_chrom"] = sum(
        g["name"] in listed and g["chrom"] != "chr2" for g in genes)

    src = [ln.split("\t") for ln in lines(p["genes.gtf"])
           if not ln.startswith("#")]
    got = rows(p["gtf.bed"])
    out["to_bed"] = {"lines": len(got), "equal_numpy": len(got) == len(src)
                     and all(b[:3] + b[5:] == [w[0], str(int(w[3]) - 1), w[4],
                                               w[6]]
                             and b[3] == ":".join([w[1], w[2]] + w[5:])
                             for b, w in zip(got, src))}
    tss = []
    for g in genes:
        for tx in g["tx"]:
            s, e = start_end(tx)
            at = s if g["strand"] == "+" else e
            tss.append((g["chrom"], max(at - 1, 0), min(at, sizes[g["chrom"]]),
                        g["name"]))
    got = [(r[0], int(r[1]), int(r[2]), r[3]) for r in rows(p["gtf_tss.bed"])]
    out["to_bed_tss"] = {"lines": len(got), "equal_numpy": got == tss}
    spans = sorted({t[:3] for t in tss})
    got = [(r[0], int(r[1]), int(r[2])) for r in rows(p["gtf_tss_merged.bed"])]
    out["to_bed_tss_merge"] = {"lines": len(got), "equal_numpy": got == spans}
    codons = []
    for g in genes:
        for tx in g["tx"]:
            for cds in tx["cds"]:
                if cds is None:
                    continue
                at = np.arange(cds[0] + cds[2] - 1, cds[1] - 1, 3)
                lo = at if g["strand"] == "+" else at + 1
                codons += [(g["chrom"], int(x), int(x) + 2) for x in lo]
    got = [(r[0], int(r[1]), int(r[2])) for r in rows(p["gtf_codons.bed"])]
    out["to_bed_codons"] = {"lines": len(got),
                            "equal_numpy": got == sorted(codons)}

    up, down = GA_PROMOTER
    want = []
    for name in ga["promoter"]:
        for g in genes:
            if g["name"] != name:
                continue
            for tx in g["tx"]:
                s = start_end(tx)[0]
                lo, hi = (up, down + 1) if g["strand"] == "+" else (down,
                                                                     up + 1)
                want.append((g["chrom"], max(s - lo, 0),
                             min(s + hi, sizes[g["chrom"]]), name))
    got = [(r[0], int(r[1]), int(r[2]), r[3]) for r in rows(p["promoter.bed"])]
    out["get_promoter"] = {
        "lines": len(got), "equal_numpy": got == want,
        "clipped": sum(w[1] == 0 or w[2] == sizes[w[0]] for w in want)}

    table = ga["table"]
    mapped = [ln.split("\t")[:3] + [table[ln.split("\t")[3]]]
              if ln.split("\t")[3] in table else ln.split("\t")
              for ln in ga["tss_ids"]]
    hit = sum(ln.split("\t")[3] in table for ln in ga["tss_ids"])
    miss = len(ga["tss_ids"]) - hit
    counts = f"geneIDs lifted: {hit}\ngeneIDs not found: {miss}\n"
    for key, path, keep in (("gene_id_to_name", "named.txt", False),
                            ("gene_id_to_name_keep", "named_keep.txt", True)):
        want = ["\t".join(m) for m, ln in zip(mapped, ga["tss_ids"])
                if not keep or ln.split("\t")[3] in table]
        got = lines(p[path])
        out[key] = {"lines": len(got), "lifted": hit, "missed": miss,
                    "equal_numpy": got == want,
                    "counts_printed": ga["stdout"][
                        "geneIdToName_keep" if keep else "geneIdToName"]
                    == counts}

    # scCount: a read counts for the gene whose first transcript's
    # [start - 1, end) its CIGAR span overlaps
    order = sorted(g["id"] for g in genes)
    col = {gid: i for i, gid in enumerate(order)}
    spans = {}
    for g in genes:
        s, e = start_end(g["tx"][0])
        spans.setdefault(g["chrom"], []).append((s - 1, e, col[g["id"]]))
    index = {c: tuple(np.array(x, np.int64).T) for c, x in
             ((c, sorted(v)) for c, v in spans.items())}
    bx_rows, counts = [], {}
    for r in sam_rows(p["bx.sam"]):
        if r[5] == "*" or r[2] not in index:
            continue
        s, e, _ = ref_span(r)
        st, en, cols = index[r[2]]
        lo = int(np.searchsorted(en, s, "right"))
        hi = int(np.searchsorted(st, e, "left"))
        if hi <= lo:
            continue
        bx = r[0].split("_BX:")[1].split("_")[0]
        if not bx_rows or bx_rows[-1] != bx:
            bx_rows.append(bx)
            counts[bx] = np.zeros(len(order))
        counts[bx][cols[lo:hi]] += 1
    norm = np.ones(len(order))
    for gid, v in ga["norm"].items():
        norm[col[gid]] = float(v)
    for key, path, scale in (("sc_count", "sc.tsv", None),
                             ("sc_count_norm", "sc_norm.tsv", norm)):
        got = rows(p[path])
        want = [[bx] + [go_g(x * scale[i] if scale is not None else x)
                        for i, x in enumerate(counts[bx].tolist())]
                for bx in bx_rows]
        out[key] = {"rows": len(got) - 1, "barcodes": len(bx_rows),
                    "reads": int(sum(v.sum() for v in counts.values())),
                    "header_equal": got[0] == ["Bx"] + order,
                    "equal_numpy": got[1:] == want}

    cm = chain_maps(ga["chain"])

    def canonical(tx):
        def longer(a, b):
            def cds(t):
                return sum(x[1] - x[0] + 1 for x in t["cds"] if x)

            def cdna(t):
                return sum(e - s + 1 for s, e in t["exons"])
            return cds(a) > cds(b) or (cds(a) == cds(b) and cdna(a) > cdna(b))
        txs = list(tx)
        for i in range(1, len(txs)):
            if longer(txs[i], txs[0]):
                txs[0], txs[i] = txs[i], txs[0]
        return txs[:1]

    ties = sum(1 for g in genes if len(g["tx"]) == 2 and g["chrom"] != "chrU"
               and canonical(g["tx"])[0] is g["tx"][0]
               and start_end(g["tx"][0]) != start_end(g["tx"][1])
               and sum(e - s for s, e in g["tx"][0]["exons"])
               == sum(e - s for s, e in g["tx"][1]["exons"]))
    for key, tsv, un, pick in (("quick_orthologs", "orth.tsv", "orth_un.txt",
                                lambda txs: txs),
                               ("quick_orthologs_canonical", "orth_canon.tsv",
                                "orth_canon_un.txt", canonical)):
        want, want_un = [], []
        for g in genes:
            for tx in pick(g["tx"]):
                if not g["name"]:
                    continue
                s, e = start_end(tx)
                at = s if g["strand"] == "+" else e
                c, a, b = g["chrom"], at - 1, at
                if c not in cm:
                    want_un += ["Record below has no ortholog in new "
                                "assembly:", f"{c}\t{a}\t{b}\t{g['name']}"]
                    continue
                _, qs, qe = lift_numpy(cm[c], np.array([a]), np.array([b]))
                want.append(f"{g['name']}\tt\t{c}\t{a}\t{b}\tq\t{cm[c][0]}\t"
                            f"{int(qs[0])}\t{int(qe[0])}")
        got, got_un = lines(p[tsv]), lines(p[un])
        out[key] = {"lines": len(got) - 1, "unmapped": len(got_un) // 2,
                    "equal_numpy": got[1:] == want and got_un == want_un,
                    "header": got[0].startswith("#geneName\ttName")}
    out["quick_orthologs_canonical"]["tie_genes"] = ties

    # multiFaAcceleration
    row0 = ga["rows"][0]
    ref = np.frombuffer(row0.encode(), np.uint8) != ord("-")
    rc = np.concatenate([[0], np.cumsum(ref)])
    hot = (int(rc[GA_HOT[0]]), int(rc[GA_HOT[1]]))
    raw_snp = {}
    for key, sfx, bits in (("multi_fa_acceleration", "", None),
                           ("multi_fa_acceleration_snp", "_snp", ga["bits"])):
        vel, acc, ini, rv, ri = (rows(p[n + sfx + ".bed"]) for n in (
            "vel", "acc", "init", "raw_vel", "raw_init"))
        want = accel_windows(row0, GA_WINDOW, bits,
                             int(GA_PROPORTION * GA_WINDOW))
        v, a, i_, x, y = (np.array([float(r[3]) for r in t], np.float64)
                          for t in (vel, acc, ini, rv, ri))
        tol = 1e-7 * (np.abs(a) + np.abs(v) + np.abs(i_)) + 1e-12

        def constant(raw, norm):
            ratio = raw[norm != 0] / norm[norm != 0]
            return bool(len(ratio) and np.allclose(ratio, ratio[0],
                                                   rtol=1e-6, atol=0))
        inside = np.array([int(r[1]) >= hot[0] and int(r[2]) <= hot[1]
                           for r in vel], bool)
        out[key] = {
            "windows": len(vel),
            "windows_equal_numpy": [(int(r[1]), int(r[2])) for r in vel]
            == want and all(r[0] == "chr2" for r in vel)
            and all([r[:3] for r in t] == [r[:3] for r in vel]
                    for t in (acc, ini, rv, ri)),
            "accel_is_vel_less_initial": bool((np.abs(a - (v - i_))
                                               <= tol).all()),
            "vel_mean": float(v.mean()), "initial_mean": float(i_.mean()),
            "raw_over_norm_constant": constant(x, v) and constant(y, i_),
            "non_negative": bool(min(v.min(), i_.min(), x.min(), y.min())
                                 >= 0),
            "hot_windows": int(inside.sum()),
            "raw_vel_ratio_hot": float(x[inside].mean()
                                       / max(x[~inside].mean(), 1e-300))}
        if sfx:
            raw_snp = {(int(r[1]), int(r[2])): (float(r[3]), float(q[3]))
                       for r, q in zip(rv, ri)}

    # branchLengthsMultiFaBed: the SNP distances of each region from
    # prefix sums over the ungapped columns
    m = np.stack([np.frombuffer(r.encode(), np.uint8) for r in ga["rows"]])
    ungapped = np.isin(m, np.frombuffer(b"ACGTacgt", np.uint8)).all(axis=0)
    cols = np.flatnonzero(ref)
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    pre = np.concatenate([np.zeros((6, 1), np.int64), np.cumsum(
        [(m[a] != m[b]) & ungapped for a, b in pairs], axis=1)], axis=1)
    pre_u = np.concatenate([[0], np.cumsum(ungapped)])
    vel, ini, ung, qs = (rows(p[n]) for n in (
        "bl_vel.bed", "bl_init.bed", "bl_ungapped.bed", "bl_q.bed"))
    ok_len = ok_q = ok_below = True
    for (s, e), rv, ri, ru, rq in zip(ga["regions"], vel, ini, ung, qs):
        a, b = int(cols[s]), int(cols[e - 1]) + 1
        d = (pre[:, b] - pre[:, a]).astype(np.float64)
        w = np.array([1000.0 if x == 0 else 1.0 / (x * x) for x in d])
        fit = accel_fit_numpy(d, w)
        h, hh = float(rv[3]), float(ri[3])
        ok_len &= (abs(h - fit[0]) <= 1e-9 * abs(fit[0]) + 1e-12
                   and abs(hh - fit[2]) <= 1e-9 * abs(fit[2]) + 1e-12
                   and int(ru[3]) == int(pre_u[min(a + e - s, len(row0))]
                                         - pre_u[a]))
        q = accel_q(d, w, [h, fit[1], hh, fit[3], fit[4]])
        ok_q &= abs(float(rq[3]) - q) <= max(GA_Q_RTOL * abs(q), GA_Q_ATOL)
        ok_below &= float(rq[3]) <= accel_q(d, w, [1.0] * 5)
    twin = ga["twin"]
    tv = [(float(rv[3]), float(ri[3])) for rv, ri in zip(vel, ini)
          if (int(rv[1]), int(rv[2])) == twin]
    want_twin = raw_snp.get(twin)

    def close(x, y):
        return abs(x - y) <= 1e-7 * max(abs(x), abs(y)) + 1e-12
    out["branch_lengths"] = {
        "regions": len(vel), "lines_equal_regions":
            [(int(r[1]), int(r[2])) for r in ung] == ga["regions"]
            and all(r[0] == "chr2" for r in ung),
        "lengths_and_ungapped_equal_numpy": bool(ok_len),
        "q_equal_formula": bool(ok_q), "q_at_most_ones": bool(ok_below),
        "twin_equal_snp_window": len(tv) == 1 and want_twin is not None
        and close(tv[0][0], want_twin[0]) and close(tv[0][1], want_twin[1])}
    return out


def gtf_accel_ok(x: dict) -> bool:
    """Every gate of gtf_accel_checks met."""
    mfa = [x["multi_fa_acceleration"], x["multi_fa_acceleration_snp"]]
    bl, qo = x["branch_lengths"], x["quick_orthologs"]
    return bool(
        all(v["equal_numpy"] and v["lines"] > 0 for k, v in x.items()
            if "lines" in v and "equal_numpy" in v)
        and x["filter_names"]["listed_off_chrom"] > 0
        and x["get_promoter"]["clipped"] > 0
        and 0 < x["gene_id_to_name"]["lifted"]
        and x["gene_id_to_name"]["missed"] > 0
        and x["gene_id_to_name"]["counts_printed"]
        and x["gene_id_to_name_keep"]["counts_printed"]
        and all(x[k]["equal_numpy"] and x[k]["header_equal"]
                and x[k]["rows"] == x[k]["barcodes"] == GA_BARCODES
                and x[k]["reads"] > 0 for k in ("sc_count", "sc_count_norm"))
        and qo["unmapped"] > 0 and qo["header"]
        and x["quick_orthologs_canonical"]["tie_genes"] > 0
        and x["quick_orthologs_canonical"]["header"]
        and all(m["windows"] > 0 and m["windows_equal_numpy"]
                and m["accel_is_vel_less_initial"]
                and abs(m["vel_mean"] - 1) < 1e-6
                and abs(m["initial_mean"] - 1) < 1e-6
                and m["raw_over_norm_constant"] and m["non_negative"]
                for m in mfa)
        and mfa[0]["hot_windows"] > 0
        and mfa[0]["raw_vel_ratio_hot"] >= GA_VEL_RATIO
        and bl["regions"] > 0 and bl["lines_equal_regions"]
        and bl["lengths_and_ungapped_equal_numpy"] and bl["q_equal_formula"]
        and bl["q_at_most_ones"] and bl["twin_equal_snp_window"])


def fasta_text(path: str) -> dict:
    """{name: sequence} of a FASTA file, read as plain text."""
    out, name = {}, None
    with open(path) as fh:
        for ln in fh:
            ln = ln.rstrip("\n")
            if ln.startswith(">"):
                name = ln[1:]
                out[name] = []
            elif name is not None:
                out[name].append(ln)
    return {k: "".join(v) for k, v in out.items()}


def sim_tree_inputs(t_fa: str, tmp: str) -> dict:
    """The inputs of slice 12a's steps, from ST_SEED: tn.fa (t.fa with
    ST_N_RUNS runs of N, shared among the chroms by length), ng.bed (its
    ungapped runs by numpy, each named), collide.fa (two chroms of
    ST_COLLIDE_BP seeded bases), tree.dot (a binary tree of
    ST_TREE_LEAVES leaves in digraph lines, parents before children, half
    of the left edges chained one deeper as ``p -> a -> a's left;``) and
    tree.nh (TOOLS_PRIMATE_TREE). Returns the paths, the sequences, the
    regions and the tree's edges."""
    rng = np.random.default_rng(ST_SEED)
    seqs = fasta_text(t_fa)
    total = sum(len(s) for s in seqs.values())
    tn, ng = {}, []
    for name, s in seqs.items():
        a = np.frombuffer(s.encode(), np.uint8).copy()
        for _ in range(max(1, round(ST_N_RUNS * len(s) / total))):
            n = int(rng.integers(ST_N_LEN[0], ST_N_LEN[1] + 1))
            at = int(rng.integers(0, len(s) - n))
            a[at:at + n] = ord("N")
        tn[name] = a.tobytes().decode()
        base = np.concatenate([[False], a != ord("N"), [False]])
        edges = np.flatnonzero(np.diff(base.astype(np.int8)))
        ng += [(name, int(b), int(e), f"ng{len(ng) + i}")
               for i, (b, e) in enumerate(zip(edges[0::2], edges[1::2]))]
    children, nodes = {}, [f"leaf{i}" for i in range(ST_TREE_LEAVES)]
    while len(nodes) > 1:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False).tolist())
        right, left = nodes.pop(j), nodes.pop(i)
        children[f"anc{len(children)}"] = (left, right)
        nodes.append(f"anc{len(children) - 1}")
    root, dot, chained, stack = nodes[0], ["digraph tree {"], set(), [nodes[0]]
    while stack:
        node = stack.pop()
        if node not in children:
            continue
        left, right = children[node]
        if node not in chained:
            if left in children and rng.random() < 0.5:
                dot.append(f"{node} -> {left} -> {children[left][0]};")
                chained.add(left)
            else:
                dot.append(f"{node} -> {left};")
        dot.append(f"{node} -> {right};")
        stack += [right, left]
    collide = {c: "".join(rng.choice(list("ACGT"), ST_COLLIDE_BP))
               for c in ("chrA", "chrB")}
    paths = {k: os.path.join(tmp, k) for k in (
        "tn.fa", "ng.bed", "collide.fa", "tree.dot", "tree.nh")}
    texts = {
        "tn.fa": [x for k, v in tn.items() for x in (f">{k}", v)],
        "ng.bed": ["\t".join(map(str, r)) for r in ng],
        "collide.fa": [x for k, v in collide.items() for x in (f">{k}", v)],
        "tree.dot": dot + ["}"], "tree.nh": [TOOLS_PRIMATE_TREE]}
    for k, lines in texts.items():
        with open(paths[k], "w") as fh:
            fh.writelines(ln + "\n" for ln in lines)
    return {"paths": paths, "seqs": seqs, "tn": tn, "ng": ng,
            "collide": collide, "children": children, "root": root,
            "chained": len(chained)}


def sim_tree_steps(step, t_fa: str, tmp: str) -> dict:
    """The steps of slice 12a in phase_tools_cli, on t.fa and the inputs
    of sim_tree_inputs: simulateSam runs ST_SAM (d with
    -deaminationDistribution, e once more into a .bam); simulateBed of
    ng.bed twice at ST_BED and once -matchedBed of the first; simulateVcf
    at ST_VCF, with -refFile tn.fa and with -refFile collide.fa;
    simulateDivergentWindowsVcf at ST_DIV; simulatePcr of ST_PRIMERS
    with and without -includePrimer=false (stdout kept); dotToNewick of
    tree.dot; drawNewickTree of tree.nh at ST_IMG where PIL imports (else
    a line says why it did not run). Returns the paths and what the
    checks need."""
    st = sim_tree_inputs(t_fa, tmp)
    p = st["paths"]
    p.update({k: os.path.join(tmp, k) for k in (
        "st_a.sam", "st_b.sam", "st_c.sam", "st_d.sam", "st_e.sam",
        "st_e.bam", "st_d.txt", "st_bed1.bed", "st_bed2.bed", "st_bed_m.bed",
        "st.vcf", "st_ref.vcf", "st_collide.vcf", "st_lo.vcf", "st_up.vcf",
        "st_p.bed", "st_p.fq", "st_pn.bed", "st_pn.fq", "st_tree.nh",
        "st_tree.png")})
    for k, args in ST_SAM.items():
        extra = ["-deaminationDistribution", p["st_d.txt"]] if k == "d" else []
        step(f"simulateSam_{k}", "simulateSam", t_fa, p[f"st_{k}.sam"], *args,
             *extra)
    step("simulateSam_e_bam", "simulateSam", t_fa, p["st_e.bam"],
         *ST_SAM["e"])
    n, length, seed = (str(x) for x in ST_BED)
    for name in ("bed1", "bed2"):
        step(f"simulateBed_{name}", "simulateBed", p["ng.bed"],
             p[f"st_{name}.bed"], "-N", n, "-L", length, "-setSeed", seed)
    step("simulateBed_matched", "simulateBed", p["ng.bed"], p["st_bed_m.bed"],
         "-matchedBed", p["st_bed1.bed"], "-setSeed", seed)
    sites, alpha, alleles, seed = (str(x) for x in ST_VCF)
    step("simulateVcf", "simulateVcf", p["st.vcf"], "-numSites", sites,
         "-alpha", alpha, "-numAlleles", alleles, "-setSeed", seed)
    step("simulateVcf_ref", "simulateVcf", p["st_ref.vcf"], "-refFile",
         p["tn.fa"], "-numSites", sites, "-setSeed", seed)
    step("simulateVcf_collide", "simulateVcf", p["st_collide.vcf"],
         "-refFile", p["collide.fa"], "-numSites", str(ST_COLLIDE_BP),
         "-setSeed", seed)
    total, per, windows, seed = (str(x) for x in ST_DIV)
    step("simulateDivergentWindowsVcf", "simulateDivergentWindowsVcf",
         p["st_lo.vcf"], p["st_up.vcf"], "-numTotalSites", total,
         "-numWindowSites", per, "-numWindows", windows, "-setSeed", seed)
    primers = [x for pr in ST_PRIMERS for x in ("-p", pr)]
    stdout = {}
    for name, bed, fq, extra in (
            ("simulatePcr", "st_p.bed", "st_p.fq", []),
            ("simulatePcr_no_primer", "st_pn.bed", "st_pn.fq",
             ["-includePrimer=false"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            step(name, "simulatePcr", *primers, "-t", t_fa, "-bed", p[bed],
                 "-fastq", p[fq], "-maxProductSize", str(ST_PCR_MAX), *extra)
        stdout[name] = buf.getvalue()
    step("dotToNewick", "dotToNewick", p["tree.dot"], p["st_tree.nh"])
    try:
        import PIL  # noqa: F401  (drawNewickTree's one extra need)
    except ImportError:
        st["draw"] = {"ran": False,
                      "why": "PIL is not installed on this machine"}
        emit({"drawNewickTree": st["draw"]})
    else:
        step("drawNewickTree", "drawNewickTree", "-imgWidth", str(ST_IMG[0]),
             "-imgHeight", str(ST_IMG[1]), p["tree.nh"], p["st_tree.png"])
        st["draw"] = {"ran": True}
    return {**st, "stdout": stdout}


def sim_sam_checks(path: str, seqs: dict, flat: bool = False) -> dict:
    """What the gates read from one simulateSam run: its header; its
    pairs' fields; each read against the reference through the fragment
    buffer's reuse, replayed from the pairs' positions (a fragment of
    span s from 0-based start b holds the reference's bases up to
    min(b + 2 * (s // 2), contig end), the rest of its slots what the
    previous fragments left, A in a new buffer, which grows only where
    the previous span plus this one passes its size; where b is 0 the
    midpoint is unknown, so slots from s // 2 on are unknown); and each
    read against the plain reference at its POS."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    head = [ln for ln in lines if ln.startswith("@")]
    rows = [ln.split("\t") for ln in lines if not ln.startswith("@")]
    want_head = ["@HD\tVN:1.6\tSO:unsorted"] + [
        f"@SQ\tSN:{c}\tLN:{len(s)}" for c, s in seqs.items()]
    refs = {c: np.frombuffer(s.upper().encode(), np.uint8)
            for c, s in seqs.items()}
    rl = ST_READ_LEN
    fields_ok, names_ok = True, True
    counts = {"equal_all": 0, "last_base_only": 0, "at_contig_ends": 0,
              "other": 0, "carried_differ": 0, "model_bases": 0,
              "model_mismatch_bases": 0}
    kinds = set()
    chrom_pairs = {c: 0 for c in seqs}
    cap, buf, known, length, prev_chrom = 0, None, None, 0, None
    for k in range(0, len(rows) - 1, 2):
        r0, r1 = rows[k], rows[k + 1]
        chrom = r0[2]
        chrom_pairs[chrom] = chrom_pairs.get(chrom, 0) + 1
        idx = chrom_pairs[chrom] - 1
        fields_ok &= (
            r0[0] == r1[0] == f"{chrom}_Read:{idx}" and r1[2] == chrom
            and {int(r0[1]), int(r1[1])} in ({99, 147}, {83, 163})
            and r0[6] == r1[6] == "=" and r0[7] == r1[3] and r1[7] == r0[3]
            and r0[8] == r1[8] == str(rl) and r0[5] == r1[5] == f"{rl}M"
            and all(30 <= int(r[4]) < 40 and len(r[9]) == len(r[10]) == rl
                    and all(63 <= ord(ch) < 73 for ch in r[10])
                    for r in (r0, r1)))
        if chrom != prev_chrom:  # a new contig: a new buffer
            cap, length, prev_chrom = 400 + int(5 * 50.0), 0, chrom
            buf, known = np.full(cap, ord("A"), np.uint8), np.ones(cap, bool)
        ref = refs[chrom]
        n = len(ref)
        a, b = sorted((r0, r1), key=lambda r: int(r[3]))
        start = int(a[3]) - 1
        size = int(b[3]) - int(a[3]) + rl
        if length + size > cap:
            cap = length + size
            buf, known = np.full(cap, ord("A"), np.uint8), np.ones(cap, bool)
        length = size
        if start == 0:
            lo = min(size // 2, n)
            buf[:lo], known[:lo], known[lo:size] = ref[:lo], True, False
        else:
            m = min(size, min(start + 2 * (size // 2), n) - start)
            buf[:m], known[:m] = ref[start:start + m], True
        at_end = start == 0 or start + size > n
        for r, off in ((a, 0), (b, size - rl)):
            got = np.frombuffer(r[9].encode(), np.uint8)
            model, kn = buf[off:off + rl], known[off:off + rl]
            diff = kn & (got != model)
            counts["model_bases"] += int(kn.sum())
            counts["model_mismatch_bases"] += int(diff.sum())
            kinds |= {(chr(x), chr(y)) for x, y in zip(model[diff],
                                                      got[diff])}
            pos = int(r[3]) - 1
            plain = ref[pos:pos + rl]
            if at_end:
                counts["at_contig_ends"] += 1
            elif np.array_equal(got, plain):
                counts["equal_all"] += 1
            elif (r is b and size % 2 and np.array_equal(got[:-1],
                                                          plain[:-1])):
                counts["last_base_only"] += 1
                counts["carried_differ"] += int(kn[-1])
            else:
                counts["other"] += 1
    pairs = len(rows) // 2
    share = chrom_pairs.get("chr1", 0) / max(pairs, 1)
    p1 = len(seqs["chr1"]) / sum(len(s) for s in seqs.values())
    sd = (p1 * (1 - p1) / max(pairs, 1)) ** 0.5
    out = {"header_equal": head == want_head, "records": len(rows),
           "pairs": pairs, "even_records": len(rows) % 2 == 0,
           "fields_ok": bool(fields_ok), "chr1_share": share,
           "chr1_share_sd": sd,
           "chr1_share_ok": abs(share - p1) <= ST_SHARE_SD * sd, **counts,
           "mismatch_kinds": sorted("".join(x) for x in kinds)}
    if flat:
        out["mismatch_share"] = (counts["model_mismatch_bases"]
                                 / max(counts["model_bases"], 1))
    return out


def pcr_products(seqs: dict, include_primer: bool) -> list:
    """The (chrom, start, end, name) products of ST_PRIMERS found afresh
    by str.find, each hit stepped past: for each reverse site (a primer's
    reverse complement), the last forward site that ends at or after the
    previous reverse site's start and before this one's; the primers
    included or not; within ST_PCR_MAX."""
    comp = str.maketrans("ACGT", "TGCA")
    out = []
    for chrom, t in seqs.items():
        t = t.upper()
        fwd, rev = [], []
        for pr in ST_PRIMERS:
            rc = pr.translate(comp)[::-1]
            for seq, sites, end in ((pr, fwd, True), (rc, rev, False)):
                i = t.find(seq)
                while i != -1:
                    sites.append((i + len(seq) if end else i, pr))
                    i = t.find(seq, i + len(seq))
        fwd.sort()
        rev.sort()
        for k, (r, pr_r) in enumerate(rev):
            lo = rev[k - 1][0] if k else -1
            cands = [x for x in fwd if lo <= x[0] < r]
            if not cands:
                continue
            s, pr_f = cands[-1]
            e = r
            if include_primer:
                s, e = s - len(pr_f), e + len(pr_r)
            if e - s <= ST_PCR_MAX:
                out.append((chrom, s, e, f"{pr_f}+{pr_r}"))
    return out


def newick_rows(text: str) -> list:
    """(x_start, x_end) of each node's horizontal line in a drawn newick
    tree, in the draw's row order (left subtree, node, right subtree):
    1000 px a unit of branch length from the root's left edge, a node
    with no length 1.0 long."""
    def label(s):
        name, _, bl = s.partition(":")
        return float(bl) if bl else 1.0

    def parse(s):
        if "(" not in s:
            return label(s), None, None
        close, depth = s.rindex(")"), 0
        for i in range(1, close):
            depth += {"(": 1, ")": -1}.get(s[i], 0)
            if s[i] == "," and depth == 0:
                break
        return label(s[close + 1:]), parse(s[1:i]), parse(s[i + 1:close])

    rows = []

    def walk(node, above):
        bl, left, right = node
        if left is not None:
            walk(left, above + bl)
        rows.append((int(above * 1000.0), int((above + bl) * 1000.0)))
        if right is not None:
            walk(right, above + bl)

    walk(parse(text.strip().rstrip(";")), 0.0)
    return rows


def sim_tree_checks(st: dict) -> dict:
    """What the gates of phase_tools_cli's slice 12a steps read from
    their files, with numpy and plain text alone, importing none of these
    tools' modules; the .bam alone is read back through the port's
    io/sam.read, and the PNG through PIL."""
    from gonomics_tpu_torch.io import sam as samio

    p, seqs, tn = st["paths"], st["seqs"], st["tn"]
    out = {k: sim_sam_checks(p[f"st_{k}.sam"], seqs, flat=k == "c")
           for k in ST_SAM}
    total = sum(len(s) for s in seqs.values())
    out["b"]["pairs_want"] = int(2 * total / (2 * ST_READ_LEN))
    with open(p["st_d.txt"]) as fh:
        dt = fh.read().splitlines()
    counts = [int(r.split("\t")[1]) for r in dt[1:]]
    out["d"]["table"] = {
        "header": dt[0] == "Position\tCount", "rows": len(dt) - 1,
        "positions_in_order": [int(r.split("\t")[0]) for r in dt[1:]]
        == list(range(len(dt) - 1)), "count_0": counts[0] if counts else -1,
        "count_10": counts[10] if len(counts) > 10 else -1}
    with open(p["st_e.sam"]) as fh:
        e_rows = [ln.rstrip("\n") for ln in fh if not ln.startswith("@")]
    _, bam_recs = samio.read(p["st_e.bam"])
    out["e"]["bam_equal_sam"] = [r.to_string() for r in bam_recs] == e_rows
    out["e"]["bam_records"] = len(bam_recs)

    regions = {}
    for c, b, e, name in st["ng"]:
        regions.setdefault(c, []).append((b, e, name))

    def in_region(r):
        rs = regions.get(r[0], [])
        i = int(np.searchsorted([x[0] for x in rs], int(r[1]), "right")) - 1
        return (i >= 0 and int(r[2]) <= rs[i][1] and len(r) == 4
                and r[3] == rs[i][2])

    _, len_bed, _ = ST_BED
    beds = {k: bed_rows(p[f"st_{k}.bed"]) for k in ("bed1", "bed2", "bed_m")}
    with open(p["st_bed1.bed"], "rb") as f1, open(p["st_bed2.bed"], "rb") as f2:
        twice_equal = f1.read() == f2.read()
    out["simulate_bed"] = {
        "runs_byte_equal": twice_equal,
        **{f"{k}_records": len(v) for k, v in beds.items()},
        **{f"{k}_length_ok": all(int(r[2]) - int(r[1]) == len_bed for r in v)
           for k, v in beds.items()},
        **{f"{k}_in_one_region": all(in_region(r) for r in v)
           for k, v in beds.items()}}

    sites, _, alleles, _ = ST_VCF
    v = bed_rows(p["st.vcf"])
    alts = [sum(int(a) for s in r[9:] for a in s.split("/")) for r in v]
    out["simulate_vcf"] = {
        "records": len(v),
        "chrom_pos_ok": [(r[0], int(r[1])) for r in v]
        == [("chr1", i + 1) for i in range(sites)],
        "ref_alt_ok": all(r[3:6] == ["A", "T", "100"] for r in v),
        "diploid_samples": all(len(r) == 9 + alleles // 2 and all(
            len(s.split("/")) == 2 and set(s.split("/")) <= {"0", "1"}
            for s in r[9:]) for r in v),
        "alt_min": min(alts, default=-1), "alt_max": max(alts, default=-1),
        "aa_ref_or_alt": all(r[7] in (f"AA={r[3]}", f"AA={r[4]}")
                             for r in v)}
    for key, path, ref in (("simulate_vcf_ref", "st_ref.vcf", tn),
                           ("simulate_vcf_collide", "st_collide.vcf",
                            st["collide"])):
        v = bed_rows(p[path])
        starts = [int(r[1]) for r in v]
        out[key] = {
            "records": len(v),
            "ref_equal_fasta": all(r[3] == ref[r[0]][int(r[1]) - 1]
                                   for r in v),
            "ref_never_n": all(r[3] in ("A", "C", "G", "T") for r in v),
            "alt_differs": all(r[4] in ("A", "C", "G", "T") and r[4] != r[3]
                               for r in v),
            "starts_distinct_across_chroms": len(set(starts)) == len(starts),
            "chroms": sorted({r[0] for r in v}), "max_pos": max(starts,
                                                                default=0)}
    total_sites, per, windows, _ = ST_DIV
    lo, up = bed_rows(p["st_lo.vcf"]), bed_rows(p["st_up.vcf"])

    def chunks(rows):
        return [rows[i:i + per] for i in range(0, len(rows), per)]

    def alt_anc(w):
        return sum(r[7] == f"AA={r[4]}" for r in w)

    wl, wu = chunks(lo), chunks(up)
    out["divergent_windows"] = {
        "lower_windows": len(wl), "upper_windows": len(wu),
        "window_sizes": sorted({len(w) for w in wl + wu}),
        "positions_distinct_in_range": all(
            len({int(r[1]) for r in w}) == len(w)
            and all(1 <= int(r[1]) <= total_sites for r in w)
            for w in wl + wu),
        "lower_alt": [alt_anc(w) for w in wl],
        "upper_alt": [alt_anc(w) for w in wu]}

    for key, bed, fq, inc in (("simulate_pcr", "st_p.bed", "st_p.fq", True),
                              ("simulate_pcr_no_primer", "st_pn.bed",
                               "st_pn.fq", False)):
        rows = bed_rows(p[bed])
        exp = pcr_products(seqs, inc)
        recs = fastq_records(p[fq])
        out[key] = {
            "lines": len(rows),
            "equal_find": [(r[0], int(r[1]), int(r[2]), r[3]) for r in rows]
            == exp,
            "fastq_equal_slices": [(n, s, q) for n, s, q in recs] == [
                (f"{c}:{s}-{e}_{n}", seqs[c].upper()[s:e],
                 "I" * (e - s)) for c, s, e, n in exp],
            "printed_equal_lines": st["stdout"][
                "simulatePcr" if inc else "simulatePcr_no_primer"]
            == f"found {len(rows)} potential products\n"}

    def newick(node):
        if node not in st["children"]:
            return node
        left, right = st["children"][node]
        return f"({newick(left)},{newick(right)}){node}"

    with open(p["st_tree.nh"]) as fh:
        nh = fh.read()
    out["dot_to_newick"] = {"equal_edges": nh == newick(st["root"]) + ";\n",
                            "nodes": 2 * ST_TREE_LEAVES - 1,
                            "chained_lines": st["chained"]}
    draw = dict(st["draw"])
    if draw["ran"]:
        from PIL import Image
        with Image.open(p["st_tree.png"]) as img:
            size = img.size
            px = np.asarray(img.convert("RGB"))
        rows = newick_rows(TOOLS_PRIMATE_TREE)
        draw.update({
            "size": list(size), "nodes": len(rows),
            "white_share": float((px == 255).all(-1).mean()),
            "lines_black": all((px[k * 10 + 5, a:b] == 0).all()
                               for k, (a, b) in enumerate(rows)),
            "root_line": list(rows[[i for i, (a, _) in enumerate(rows)
                                    if a == 0][0]])})
    out["draw_newick_tree"] = draw
    return out


def sim_tree_ok(x: dict) -> bool:
    """Every gate of sim_tree_checks met (drawNewickTree's where it ran)."""
    n_bed, _, _ = ST_BED
    sites, _, alleles, _ = ST_VCF
    _, per, windows, _ = ST_DIV
    want_pairs = {k: int(v[1]) for k, v in ST_SAM.items() if v[0] == "-n"}
    sam_ok = all(
        x[k]["header_equal"] and x[k]["even_records"] and x[k]["fields_ok"]
        and x[k]["chr1_share_ok"]
        and x[k]["pairs"] == want_pairs.get(k, x[k].get("pairs_want"))
        for k in ST_SAM) and all(
        x[k]["other"] == 0 and x[k]["model_mismatch_bases"] == 0
        for k in ("a", "b", "e"))
    a, c, d = x["a"], x["c"], x["d"]
    sam_ok = (sam_ok and a["equal_all"] > 0 and a["last_base_only"] > 0
              and a["carried_differ"] > 0 and a["at_contig_ends"] > 0
              and abs(c["mismatch_share"] - ST_FLAT) <= ST_FLAT_TOL
              and d["model_mismatch_bases"] > 0
              and set(d["mismatch_kinds"]) <= {"CT", "GA"}
              and d["table"]["header"] and d["table"]["rows"] == ST_READ_LEN
              and d["table"]["positions_in_order"]
              and d["table"]["count_0"] > d["table"]["count_10"]
              and x["e"]["bam_equal_sam"]
              and x["e"]["bam_records"] == x["e"]["records"] == 2 * int(
                  ST_SAM["e"][1]))
    sb = x["simulate_bed"]
    bed_ok = sb["runs_byte_equal"] and all(
        sb[f"{k}_records"] == n_bed and sb[f"{k}_length_ok"]
        and sb[f"{k}_in_one_region"] for k in ("bed1", "bed2", "bed_m"))
    v, vr, vc = (x["simulate_vcf"], x["simulate_vcf_ref"],
                 x["simulate_vcf_collide"])
    vcf_ok = (v["records"] == sites and v["chrom_pos_ok"] and v["ref_alt_ok"]
              and v["diploid_samples"] and v["alt_min"] >= 1
              and v["alt_max"] <= alleles - 1 and v["aa_ref_or_alt"]
              and vr["records"] == sites and vc["records"] == ST_COLLIDE_BP
              and vc["max_pos"] == ST_COLLIDE_BP
              and all(r["ref_equal_fasta"] and r["ref_never_n"]
                      and r["alt_differs"]
                      and r["starts_distinct_across_chroms"]
                      for r in (vr, vc)))
    dw = x["divergent_windows"]
    div_ok = (dw["lower_windows"] == dw["upper_windows"] == int(0.1 * windows)
              and dw["window_sizes"] == [per]
              and dw["positions_distinct_in_range"]
              and max(dw["lower_alt"]) <= min(dw["upper_alt"]))
    pcr_ok = all(x[k]["lines"] > 0 and x[k]["equal_find"]
                 and x[k]["fastq_equal_slices"] and x[k]["printed_equal_lines"]
                 for k in ("simulate_pcr", "simulate_pcr_no_primer"))
    dn = x["dot_to_newick"]
    dr = x["draw_newick_tree"]
    draw_ok = not dr["ran"] or (
        dr["size"] == list(ST_IMG) and dr["white_share"] >= ST_WHITE
        and dr["lines_black"] and dr["root_line"] == [0, 1000])
    return bool(sam_ok and bed_ok and vcf_ok and div_ok and pcr_ok
                and dn["equal_edges"] and dn["chained_lines"] > 0 and draw_ok)


def newick_names(text: str) -> list:
    """The node names of a newick string, in the text's order."""
    return [t.split(":")[0] for t in re.split(r"[(),;]", text.strip()) if t]


def pfa_records(path: str) -> dict:
    """{name: (length, 4) float32 rows} of a .pfa, read as bytes;
    ValueError where its first line is not the format's, a record's name
    repeats or the header's lengths do not add up to the rows after
    EndHeader."""
    with open(path, "rb") as fh:
        data = fh.read()
    end = data.index(b"EndHeader\n")
    head = data[:end].decode().splitlines()
    if head[0] != "pFasta_format_1.0":
        raise ValueError(f"{path}: not a pFasta file")
    rows = np.frombuffer(data[end + len(b"EndHeader\n"):], "<f2")
    rows = rows.astype(np.float32).reshape(-1, 4)
    out, at = {}, 0
    for name, n in (ln.rsplit("\t", 1) for ln in head[1:]):
        if name in out:
            raise ValueError(f"{path}: record {name} repeats")
        out[name] = rows[at:at + int(n)]
        at += int(n)
    if at != len(rows):
        raise ValueError(f"{path}: header gives {at} rows, file {len(rows)}")
    return out


def write_pfa(path: str, records: dict) -> None:
    """A .pfa of {name: rows}: the text header, then the rows as
    float16."""
    with open(path, "wb") as fh:
        fh.write(("pFasta_format_1.0\n" + "".join(
            f"{k}\t{len(v)}\n" for k, v in records.items())
            + "EndHeader\n").encode())
        for v in records.values():
            fh.write(np.asarray(v).astype("<f2").tobytes())


def sim_evol_inputs(tmp: str) -> dict:
    """The inputs of slice 12b's steps, from SE_SEED: root.fa (SE_ROOT_BP
    bases, ATG at the gene's start, GGC where its stop codon goes);
    gene.gp (SE_EXONS and SE_FRAMES) and gene_nostop.gp (its CDS end one
    base short, so no codon starts at end - 3); tree.nh (SE_TREE) and
    tree0.nh (every length 0); wi.fa (SE_WI's length); ident.txt (the
    identity substitution matrix); nc_n.fa and nc_a.fa (SE_NC_FA_BP
    lower-case bases, the first n in one and a in the other); the ILS
    run's SE_ILS topologies (.pfa rows of multinomial(16) / 16, so
    float16 keeps them; Dirichlet weights in wigs) and a run with weights
    1 and 0. Returns the paths and what the checks need."""
    rng = np.random.default_rng(SE_SEED)
    root = rng.choice(list("ACGT"), SE_ROOT_BP)
    start, end = SE_EXONS[0][0], SE_EXONS[-1][1]
    root[start:start + 3] = list("ATG")
    root[end - 3:end] = list("GGC")
    starts = ",".join(str(a) for a, _ in SE_EXONS) + ","
    ends = ",".join(str(b) for _, b in SE_EXONS) + ","
    frames = ",".join(map(str, SE_FRAMES)) + ","

    def gene(cds_end):
        return (f"g1\tchr1\t+\t0\t{SE_ROOT_BP}\t{start}\t{cds_end}\t"
                f"{len(SE_EXONS)}\t{starts}\t{ends}\t{frames}")

    wi_bp = SE_WI[0]
    nc_fa = rng.choice(list("acgt"), SE_NC_FA_BP)
    texts = {
        "root.fa": [">root", "".join(root)],
        "gene.gp": [gene(end)], "gene_nostop.gp": [gene(end - 1)],
        "tree.nh": [SE_TREE], "tree0.nh": [re.sub(r":[0-9.]+", ":0",
                                                  SE_TREE)],
        "wi.fa": [">chrW", "".join(rng.choice(list("ACGT"), wi_bp))],
        "ident.txt": ["\t".join("1" if i == j else "0" for j in range(4))
                      for i in range(4)],
        "nc_n.fa": [">inN", "n" + "".join(nc_fa[1:])],
        "nc_a.fa": [">inA", "a" + "".join(nc_fa[1:])]}
    n_top, n_pos, _ = SE_ILS
    weights = rng.dirichlet(np.ones(n_top), n_pos)
    recons = [(rng.multinomial(16, np.ones(4) / 4, n_pos) / 16).astype(
        np.float32) for _ in range(n_top)]
    paths = {k: os.path.join(tmp, "se_" + k) for k in texts}
    for run, ws in (("ils", weights.T),
                    ("ils10", (np.ones(n_pos), np.zeros(n_pos)))):
        wigs, pfas = [], []
        for k, w in enumerate(ws):
            name = f"top{k}"
            wig = os.path.join(tmp, f"se_{run}_{name}.wig")
            with open(wig, "w") as fh:
                fh.write(f"fixedStep chrom={name} start=1 step=1\n")
                fh.writelines(repr(float(x)) + "\n" for x in w)
            pfa = os.path.join(tmp, f"se_{run}_{name}.pfa")
            write_pfa(pfa, {name: recons[k]})
            wigs.append(wig)
            pfas.append(pfa)
        texts[f"{run}_post.list"] = wigs
        texts[f"{run}_recons.list"] = pfas
        texts[f"{run}.sizes"] = [f"top{k}\t{n_pos}" for k in range(len(ws))]
        paths.update({k: os.path.join(tmp, "se_" + k) for k in (
            f"{run}_post.list", f"{run}_recons.list", f"{run}.sizes")})
    for k, lines in texts.items():
        with open(paths[k], "w") as fh:
            fh.writelines(ln + "\n" for ln in lines)
    return {"paths": paths, "root": "".join(root),
            "wi": texts["wi.fa"][1], "nc_fa": texts["nc_n.fa"][1],
            "weights": weights, "recons": recons}


def sim_evol_steps(step, tmp: str) -> dict:
    """The steps of slice 12b in phase_tools_cli, on sim_evol_inputs:
    simulateEvol genic of root.fa down tree.nh (leaves; and every node
    with --completeSimOutput, same seed); withIndels of wi.fa at SE_WI
    with --vcfOutFile, and again at transition bias 1 (-lambda); nonCoding
    at SE_NC with --newickOut, again with the identity matrix, and over
    that newick with nc_n.fa and with nc_a.fa; simRecon with
    --baseAccFile, and over tree0.nh with gene_nostop.gp;
    ilsReconstructSeq of the SE_ILS topologies and of weights 1 and 0.
    Returns the inputs and the output paths."""
    se = sim_evol_inputs(tmp)
    p = se["paths"]
    p.update({k: os.path.join(tmp, "se_" + k) for k in (
        "leaves.fa", "all.fa", "all_leaves.fa", "wi_out.fa", "wi.vcf",
        "wi1_out.fa", "nc.fa", "nc.nh", "nc_ident.fa", "nc_ident.nh",
        "nc_n_out.fa", "nc_a_out.fa", "sr_sim.fa", "sr_leaf.fa",
        "sr_recon.fa", "sr_acc.txt", "sr_base.txt", "sr0_sim.fa",
        "sr0_leaf.fa", "sr0_recon.fa", "sr0_acc.txt", "sr0_base.txt",
        "ils.pfa", "ils10.pfa")})
    step("simulateEvol_genic", "simulateEvol", "genic", "--setSeed", "7",
         "--genePred", p["gene.gp"], p["tree.nh"], p["root.fa"],
         p["leaves.fa"])
    step("simulateEvol_genic_complete", "simulateEvol", "genic",
         "--setSeed", "7", "--completeSimOutput", p["all.fa"], "--genePred",
         p["gene.gp"], p["tree.nh"], p["root.fa"], p["all_leaves.fa"])
    _, branch, prop, lam, bias, seed = SE_WI
    step("simulateEvol_withIndels", "simulateEvol", "withIndels",
         "--branchLength", branch, "--propIndel", prop, "--lambdaValue",
         lam, "--transitionBias", bias, "--setSeed", seed, "--vcfOutFile",
         p["wi.vcf"], p["wi.fa"], p["wi_out.fa"])
    step("simulateEvol_withIndels_bias1", "simulateEvol", "withIndels",
         "--branchLength", branch, "--propIndel", prop, "-lambda", lam,
         "--setSeed", seed, p["wi.fa"], p["wi1_out.fa"])
    nodes, length, seed = (str(x) for x in SE_NC)
    nc = ["--numNodes", nodes, "--lenSeq", length, "--setSeed", seed]
    step("simulateEvol_nonCoding", "simulateEvol", "nonCoding", *nc,
         "--newickOut", p["nc.nh"], p["nc.fa"])
    step("simulateEvol_nonCoding_identity", "simulateEvol", "nonCoding",
         *nc, "--substitutionMatrix", p["ident.txt"], "--newickOut",
         p["nc_ident.nh"], p["nc_ident.fa"])
    for k in ("n", "a"):
        step(f"simulateEvol_nonCoding_fasta_{k}", "simulateEvol",
             "nonCoding", "--treeFile", p["nc.nh"], "--fastaFile",
             p[f"nc_{k}.fa"], "--setSeed", "9", p[f"nc_{k}_out.fa"])
    step("simRecon", "simRecon", "--baseAccFile", p["sr_base.txt"],
         p["root.fa"], p["tree.nh"], p["gene.gp"], p["sr_sim.fa"],
         p["sr_leaf.fa"], p["sr_recon.fa"], p["sr_acc.txt"])
    step("simRecon_zero_lengths", "simRecon", "--baseAccFile",
         p["sr0_base.txt"], p["root.fa"], p["tree0.nh"],
         p["gene_nostop.gp"], p["sr0_sim.fa"], p["sr0_leaf.fa"],
         p["sr0_recon.fa"], p["sr0_acc.txt"])
    for run in ("ils", "ils10"):
        step(f"ilsReconstructSeq_{run}", "ilsReconstructSeq", "--precision",
             str(SE_ILS[2]), p[f"{run}_post.list"], p[f"{run}_recons.list"],
             p[f"{run}.sizes"], p[f"{run}.pfa"])
    return se


def sim_evol_checks(se: dict) -> dict:
    """What the gates of phase_tools_cli's slice 12b steps read from
    their files, with numpy and plain text alone, importing none of these
    tools' modules."""
    p, root = se["paths"], se["root"]
    start, end = SE_EXONS[0][0], SE_EXONS[-1][1]
    leaf_names = sorted(n for n in newick_names(SE_TREE)
                        if n.startswith("l"))
    out = {}

    leaves, every = fasta_text(p["leaves.fa"]), fasta_text(p["all.fa"])
    out["genic"] = {
        "leaves": sorted(leaves), "records": len(every),
        "leaves_equal_complete_run": leaves == fasta_text(
            p["all_leaves.fa"]) and all(every.get(k) == v
                                        for k, v in leaves.items()),
        "lengths": sorted({len(v) for v in every.values()}),
        "start_atg": sum(v[start:start + 3] == "ATG"
                         for v in every.values()),
        "stop_codon": sum(v[end - 3:end] in ("TAA", "TAG", "TGA")
                          for v in every.values()),
        "start_or_stop_gapped": sum("-" in v[start:start + 3] + v[end - 3:end]
                                    for v in every.values()),
        "most_gaps": max(v.count("-") for v in every.values()),
        "with_gap": sum("-" in v for v in every.values()),
        "acgt_or_gap": all(set(v) <= set("ACGT-") for v in every.values()),
        "differing_bases": sum(a != b for v in every.values()
                               for a, b in zip(v, root))}

    n_wi = SE_WI[0]
    for key, path, vcf in (("with_indels", "wi_out.fa", "wi.vcf"),
                           ("with_indels_bias1", "wi1_out.fa", None)):
        rows = fasta_text(p[path])
        names = list(rows)
        ref, alt = rows[names[0]], rows[names[-1]]
        o = {"names": names, "equal_lengths": len(ref) == len(alt),
             "ref_ungapped_is_input": ref.replace("-", "") == se["wi"],
             "columns": len(ref), "ref_gaps": ref.count("-"),
             "alt_gaps": alt.count("-"),
             "substitutions": sum(a != b and "-" not in (a, b)
                                  for a, b in zip(ref, alt))}
        if vcf:
            with open(p[vcf]) as fh:
                lines = fh.read().splitlines()
            col = [i for i, b in enumerate(ref) if b != "-"]
            kinds = {"sub": 0, "del": 0, "ins": 0}
            agree = 0
            for ln in lines[2:]:
                f = ln.split("\t")
                c, r, a = col[int(f[1]) - 1], f[3], f[4]
                kind = ("sub" if len(r) == len(a) == 1 else
                        "del" if len(a) == 1 else "ins")
                kinds[kind] += 1
                width = max(len(r), len(a))
                ok = (ref[c:c + width].replace("-", "") == r
                      and alt[c:c + width].replace("-", "") == a
                      and f[0] == names[0] and f[2] == "."
                      and f[5:] == ["100", "PASS", ".", ".", ""])
                if kind == "sub":
                    ok = ok and r != a
                elif kind == "del":
                    ok = ok and alt[c + 1:c + width] == "-" * (width - 1)
                else:
                    ok = ok and ref[c + 1:c + width] == "-" * (width - 1)
                agree += ok
            o.update({"vcf_header": lines[:2] == [
                "##fileformat=VCFv4.2", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT"], "vcf_lines": len(lines) - 2,
                "vcf_lines_match_columns": agree, "vcf_kinds": kinds})
        out[key] = o
    out["with_indels"]["input_bp"] = n_wi

    nodes, length, _ = SE_NC
    nc, nci = fasta_text(p["nc.fa"]), fasta_text(p["nc_ident.fa"])
    with open(p["nc.nh"]) as fh:
        nh = fh.read()
    with open(p["nc_ident.nh"]) as fh:
        nh_ident = fh.read()
    nc_root = nc.get("root", "")
    out["non_coding"] = {
        "records": len(nc), "lengths": sorted({len(v) for v in nc.values()}),
        "acgt_only": all(set(v) <= set("ACGT") for v in nc.values()),
        "root_gc": (nc_root.count("G") + nc_root.count("C"))
        / max(len(nc_root), 1),
        "newick_nodes": len(newick_names(nh)),
        "newick_names_equal_records": sorted(newick_names(nh)) == sorted(nc),
        "newick_one_line": nh.endswith(";\n") and nh.count("\n") == 1,
        "differing_from_root": sum(a != b for v in nc.values()
                                   for a, b in zip(v, nc_root)),
        "identity_records_equal_root": len(nci) == nodes and all(
            v == nci["root"] for v in nci.values()),
        "identity_root_equal": nci.get("root") == nc_root,
        "identity_newick_equal": nh_ident == nh}
    runs = {k: list(fasta_text(p[f"nc_{k}_out.fa"]).items())
            for k in ("n", "a")}
    nn, na = runs["n"], runs["a"]
    out["non_coding_fasta"] = {
        "records": [len(nn), len(na)],
        "root_names": [nn[0][0], na[0][0]],
        "roots_upper_input": nn[0][1] == se["nc_fa"].upper()
        and na[0][1] == "A" + se["nc_fa"][1:].upper(),
        "n_column_all_n": all(v[0] == "N" for _, v in nn),
        "rest_acgt": all(set(v[1:]) <= set("ACGT") for _, v in nn + na),
        "rest_equal_a_run": len(nn) == len(na) and all(
            a[1][1:] == b[1][1:] and (i == 0 or a[0] == b[0])
            for i, (a, b) in enumerate(zip(nn, na))),
        "differing_from_root": sum(a != b for _, v in nn
                                   for a, b in zip(v[1:], nn[0][1][1:]))}

    def table(path):
        with open(path) as fh:
            return [ln.split("\t") for ln in fh.read().splitlines()]

    sim = fasta_text(p["sr_sim.fa"])
    leaf, recon = fasta_text(p["sr_leaf.fa"]), fasta_text(p["sr_recon.fa"])
    acc, base = table(p["sr_acc.txt"]), table(p["sr_base.txt"])
    want = [r for n in sim for r in (
        f"{n}(leaf)" if n in leaf else n, f"{n} exon", f"{n} nonCoding")]
    values = [float(v) for _, v in acc + base]
    out["sim_recon"] = {
        "records": [len(sim), len(leaf), len(recon)],
        "leaves": sorted(leaf) == leaf_names,
        "recon_leaves_equal_leaf_fasta": all(recon.get(k) == v
                                            for k, v in leaf.items()),
        "recon_names_equal_sim": sorted(recon) == sorted(sim),
        "rows_equal_nodes": [r[0] for r in acc]
        == want + ["All Reconstructed Nodes"],
        "base_rows": len(base), "in_0_100": all(0 <= v <= 100
                                               for v in values),
        "six_decimals": all(re.fullmatch(r"-?\d+\.\d{6}", v)
                            for _, v in acc + base),
        "all_nodes": float(acc[-1][1]) if acc else -1.0,
        "zero_lengths_all_100": all(
            v == "100.000000" for _, v in table(p["sr0_acc.txt"])
            + table(p["sr0_base.txt"])),
        "zero_lengths_rows": len(table(p["sr0_acc.txt"]))}

    n_top, n_pos, precision = SE_ILS
    ils = pfa_records(p["ils.pfa"])
    got = ils["ilsRecon"]
    total32 = np.zeros((n_pos, 4), np.float32)
    total64 = np.zeros((n_pos, 4), np.float64)
    for k, rec in enumerate(se["recons"]):
        w = se["weights"][:, k]
        total32 = total32 + rec * w.astype(np.float32)[:, None]
        total64 = total64 + rec.astype(np.float64) * w[:, None]
    want32 = total32.astype("<f2").astype(np.float32)
    want64 = total64.astype(np.float32).astype("<f2").astype(np.float32)
    got10 = next(iter(pfa_records(p["ils10.pfa"]).values()))
    out["ils_reconstruct_seq"] = {
        "header": list(ils) == ["ilsRecon"] and len(got) == n_pos,
        "rows": len(got),
        "float32_sum_mismatches": int((got != want32).sum()),
        "float64_sum_mismatches": int((want64 != want32).sum()),
        "float32_rows_off_one": float(np.abs(total32.sum(1) - 1).max()),
        "file_rows_off_one": float(np.abs(got.sum(1) - 1).max()),
        "weights_1_0_equal_first": np.array_equal(got10, se["recons"][0])}
    return out


def sim_evol_ok(x: dict) -> bool:
    """Every gate of sim_evol_checks met."""
    nodes, length, _ = SE_NC
    n_leaves = (nodes + 1) // 2
    g = x["genic"]
    genic_ok = (len(g["leaves"]) == n_leaves and g["records"] == nodes
                and g["leaves_equal_complete_run"]
                and g["lengths"] == [SE_ROOT_BP] and g["acgt_or_gap"]
                and g["start_atg"] + g["start_or_stop_gapped"] >= nodes
                and g["stop_codon"] + g["start_or_stop_gapped"] >= nodes
                and g["stop_codon"] > 0 and g["most_gaps"] <= 1
                and g["differing_bases"] > 0)
    wi_ok = all(
        w["equal_lengths"] and w["ref_ungapped_is_input"]
        and w["names"] == ["chrW", "chrW_evol"] and w["substitutions"] > 0
        and w["ref_gaps"] > 0 and w["alt_gaps"] > 0
        for w in (x["with_indels"], x["with_indels_bias1"]))
    w = x["with_indels"]
    wi_ok = (wi_ok and w["vcf_header"] and w["vcf_lines"] > 0
             and w["vcf_lines_match_columns"] == w["vcf_lines"]
             and all(v > 0 for v in w["vcf_kinds"].values()))
    nc, ncf = x["non_coding"], x["non_coding_fasta"]
    nc_ok = (nc["records"] == nodes and nc["lengths"] == [length]
             and nc["acgt_only"] and abs(nc["root_gc"] - 0.41) <= SE_GC_TOL
             and nc["newick_nodes"] == nodes
             and nc["newick_names_equal_records"] and nc["newick_one_line"]
             and nc["differing_from_root"] > 0
             and nc["identity_records_equal_root"]
             and nc["identity_root_equal"] and nc["identity_newick_equal"]
             and ncf["records"] == [nodes, nodes]
             and ncf["root_names"] == ["inN", "inA"]
             and ncf["roots_upper_input"] and ncf["n_column_all_n"]
             and ncf["rest_acgt"] and ncf["rest_equal_a_run"]
             and ncf["differing_from_root"] > 0)
    sr = x["sim_recon"]
    sr_ok = (sr["records"] == [nodes, n_leaves, nodes] and sr["leaves"]
             and sr["recon_leaves_equal_leaf_fasta"]
             and sr["recon_names_equal_sim"] and sr["rows_equal_nodes"]
             and sr["base_rows"] == 3 * nodes and sr["in_0_100"]
             and sr["six_decimals"] and sr["all_nodes"] < 100
             and sr["zero_lengths_all_100"]
             and sr["zero_lengths_rows"] == 3 * nodes + 1)
    il = x["ils_reconstruct_seq"]
    ils_ok = (il["header"] and il["rows"] == SE_ILS[1]
              and il["float32_sum_mismatches"] == 0
              and il["float64_sum_mismatches"] > 0
              and il["float32_rows_off_one"] <= SE_ILS[2]
              and il["weights_1_0_equal_first"])
    return bool(genic_ok and wi_ok and nc_ok and sr_ok and ils_ok)


def onto_straw_inputs(tmp: str, genes: list, sizes: dict, gtf=None, *,
                      terms: int = OS_TERMS, gaf_lines=OS_GAF,
                      contacts: int = OS_CONTACTS, queries: int = OS_QUERIES,
                      straw_bins: int = OS_STRAW[0],
                      straw_distances: int = OS_STRAW[1]) -> dict:
    """The seeded inputs of item 13's and strawToBedpe's steps, under tmp,
    from OS_SEED, over genes (dicts of name, chrom, strand and tx, each a
    dict of 1-based exons, as gtf_accel_inputs makes them) and sizes:
    os_in.obo (a header with a # line; terms of 1-3 parents, # lines
    between and inside stanzas, alt ids, an obsolete term, a [Typedef]
    and a last stanza with no blank line after it); os_a.gaf and
    os_b.gaf (15-17 fields, NOT qualifiers, duplicate pairs, # and blank
    lines; symbols the genes' names, a few upper-cased, and two no gene
    has); os_chrom.sizes; os_genes.gtf where gtf is None; cis contacts
    (and ten on chrM, which has no TSS); an empty contact file; queries;
    a straw map on chr1 led by a # line, a tenth of its pairs with the
    later bin first. Returns the paths and what the checks need."""
    rng = np.random.default_rng(OS_SEED)
    p = {k: os.path.join(tmp, "os_" + k) for k in (
        "in.obo", "a.gaf", "b.gaf", "gafs.txt", "chrom.sizes", "genes.gtf",
        "contacts.bedpe", "empty.bedpe", "queries.bed", "chr1.straw",
        "straw.list")}
    ids = [f"GO:{i:07d}" for i in range(terms)]
    alts = {ids[i]: f"GO:9{i:06d}" for i in range(3, terms, OS_ALT_EVERY)}
    parents = {ids[0]: []}
    for i in range(1, terms):
        lo = max(0, i - OS_PARENT_WINDOW)
        parents[ids[i]] = sorted({ids[int(j)] for j in rng.integers(
            lo, i, int(rng.integers(1, 4)))})
    obo = ["format-version: 1.2", "data-version: chip_smoke",
           "# a header comment", "ontology: go", ""]
    namespaces = ("biological_process", "molecular_function",
                  "cellular_component")
    for i, t in enumerate(ids):
        obo += ["[Term]", f"id: {t}", f"name: term {i}",
                f"namespace: {namespaces[i % 3]}", f'def: "term {i}." [cs]']
        if t in alts:
            obo.append(f"alt_id: {alts[t]}")
        obo += [f"is_a: {q} ! term {int(q[3:])}" for q in parents[t]]
        if i % 11 == 5:
            obo += ["# inside a stanza", "subset: goslim_generic"]
        obo.append("")
        if i % 50 == 49:
            obo.append("# between stanzas")
    obo += ["[Term]", "id: GO:0999999", "name: obsolete term",
            "namespace: biological_process", 'def: "gone." []',
            "is_obsolete: true", "", "[Typedef]", "id: part_of",
            "name: part of", "", "[Term]", "id: GO:0888888",
            "name: unterminated", "namespace: biological_process",
            'def: "never read." []']
    complete = [(t, f"term {i}") for i, t in enumerate(ids)]
    complete.append(("GO:0999999", "obsolete term"))

    named = list(dict.fromkeys(g["name"] for g in genes if g["name"]))
    symbols = named + [n.upper() for n in named[::15]] + ["orphan1",
                                                          "orphan2"]
    alt_ids, quals = list(alts.values()), ("involved_in", "enables",
                                           "located_in")
    gafs, pairs = {}, []
    for name, n in zip("ab", gaf_lines):
        lines = ["!gaf-version: 2.2", "!generated-by: chip_smoke"]
        for i in range(n):
            if pairs and rng.random() < OS_DUP:
                go, sym = pairs[int(rng.integers(0, len(pairs)))]
            else:
                u = rng.random()
                go = (ids[int(rng.integers(0, terms))] if u < 0.9 else
                      alt_ids[int(rng.integers(0, len(alt_ids)))]
                      if u < 0.95 else "GO:7777777")
                sym = symbols[int(rng.integers(0, len(symbols)))]
                pairs.append((go, sym))
            qual = ("NOT|" + quals[i % 3] if rng.random() < OS_NOT
                    else quals[i % 3])
            w = ["UniProtKB", f"P{name}{i:05d}", sym, qual, go, "PMID:1",
                 "IEA", "", "PFC"[i % 3], f"protein {i}", "", "protein",
                 "taxon:9606", "20260101", "chip_smoke"]
            w += [[], ["ext"], ["ext", f"UniProtKB:P{i:05d}-1"]][i % 3]
            lines.append("\t".join(w))
            if i % 500 == 7:
                lines += ["# a comment", ""]
        gafs[name] = lines

    tss = {}  # (chrom, 0-based start) -> names, in the GTF's order
    for g in genes:
        for tx in g["tx"]:
            at = tx["exons"][0][0] if g["strand"] == "+" else \
                tx["exons"][-1][1]
            tss.setdefault((g["chrom"], at - 1), []).append(g["name"])
    chroms = sorted({c for c, _ in tss})
    weight = np.array([sizes[c] for c in chroms], float)
    weight /= weight.sum()
    bedpe = []
    for _ in range(contacts):
        c = chroms[int(rng.choice(len(chroms), p=weight))]
        wa, wb = (int(x) for x in rng.integers(1000, 5000, 2))
        a = int(rng.integers(0, sizes[c] - wa))
        b = min(a + int(rng.exponential(20_000)), sizes[c] - wb)
        (a, wa), (b, wb) = ((a, wa), (b, wb))[::int(rng.choice([1, -1]))]
        bedpe.append(f"{c}\t{a}\t{a + wa}\t{c}\t{b}\t{b + wb}\t.\t"
                     f"{int(rng.integers(1, 100))}")
    bedpe += [f"chrM\t{i * 100}\t{i * 100 + 50}\tchrM\t{i * 300}\t"
              f"{i * 300 + 50}\t.\t1" for i in range(10)]
    hot = [list(tss)[int(i)] for i in rng.choice(len(tss), OS_HOT_GENES,
                                                 replace=False)]
    beds = []
    for _ in range(queries):
        if rng.random() < OS_HOT:
            c, at = hot[int(rng.integers(0, len(hot)))]
            s = int(np.clip(at + rng.integers(-OS_HOT_BP, OS_HOT_BP), 0,
                            sizes[c] - 1))
        else:
            c = chroms[int(rng.choice(len(chroms), p=weight))]
            s = int(rng.integers(0, sizes[c] - 1))
        beds.append(f"{c}\t{s}\t{min(s + int(rng.integers(1, 500)), sizes[c])}")

    straw = []
    for i in range(straw_bins):
        for d in range(min(straw_distances, straw_bins - i)):
            mean = OS_STRAW_MEAN / (1 + d)
            score = 1 + int(rng.negative_binomial(2, 2 / (2 + mean)))
            if rng.random() < OS_PEAK_SHARE:
                score += int(rng.integers(*OS_PEAK))
            a, b = i * OS_BIN, (i + d) * OS_BIN
            straw.append((b, a, score) if rng.random() < 0.1 else
                         (a, b, score))
    texts = {
        "in.obo": obo, "a.gaf": gafs["a"], "b.gaf": gafs["b"],
        "gafs.txt": [p["a.gaf"], p["b.gaf"]],
        "chrom.sizes": [f"{c}\t{n}" for c, n in sizes.items()],
        "contacts.bedpe": bedpe, "empty.bedpe": [], "queries.bed": beds,
        "chr1.straw": ["# chr1 observed NONE BP 1000"] + [
            f"{a}\t{b}\t{s}" for a, b, s in straw],
        "straw.list": [f"{p['chr1.straw']}\tchr1"]}
    if gtf is None:
        gtf, rows = p["genes.gtf"], []
        for k, g in enumerate(genes):
            att = f'gene_id "OS{k}"; gene_name "{g["name"]}";'
            for t, tx in enumerate(g["tx"]):
                s, e = tx["exons"][0][0], tx["exons"][-1][1]
                ta = f'{att} transcript_id "OS{k}.{t}";'
                rows.append(f"{g['chrom']}\tcs\ttranscript\t{s}\t{e}\t.\t"
                            f"{g['strand']}\t.\t{ta}")
                rows += [f"{g['chrom']}\tcs\texon\t{a}\t{b}\t.\t"
                         f"{g['strand']}\t.\t{ta} exon_number \"{j + 1}\"; "
                         f'exon_id "OS{k}.{t}.{j}";'
                         for j, (a, b) in enumerate(tx["exons"])]
        texts["genes.gtf"] = rows
    for k, lines in texts.items():
        with open(p[k], "w") as fh:
            fh.writelines(ln + "\n" for ln in lines)
    return {"paths": p, "gtf": gtf, "ids": ids, "alts": alts,
            "parents": parents, "complete": complete, "gafs": gafs,
            "tss": tss, "sizes": dict(sizes), "straw": np.array(straw),
            "alt_start": ids[3]}


def onto_straw_steps(step, os_in: dict) -> dict:
    """The steps of item 13 and strawToBedpe in phase_tools_cli, on
    onto_straw_inputs: oboTools mapping; gafFilter -removeNot of os_a.gaf;
    oboToDot from term 3's alt id; ontologyHistogram of the two GAFs;
    assignGenomeSpace of the GTF with --proximity, with --contactFile of
    the seeded contacts, of the empty file and of strawToBedpe's output;
    strawToBedpe with -fitStatsFile and -contactScoreFile;
    ontologyEnrichment of the
    queries with -contactFile. Returns os_in with the output paths."""
    p = os_in["paths"]
    tmp = os.path.dirname(p["in.obo"])
    p.update({k: os.path.join(tmp, "os_" + k) for k in (
        "map.tsv", "a_filt.gaf", "sub.dot", "hist.tsv", "1d.bed", "3d.bed",
        "3d_empty.bed", "straw.bedpe", "fit.txt", "scores.txt",
        "3d_straw.bed", "enrich.bed")})
    gtf, sizes = os_in["gtf"], p["chrom.sizes"]
    step("oboTools_mapping", "oboTools", "mapping", p["in.obo"],
         p["map.tsv"])
    step("gafFilter_removeNot", "gafFilter", p["a.gaf"], p["a_filt.gaf"],
         "-removeNot")
    step("oboToDot_alt_id", "oboToDot", p["in.obo"],
         os_in["alts"][os_in["alt_start"]], p["sub.dot"])
    step("ontologyHistogram", "ontologyHistogram", p["in.obo"],
         p["gafs.txt"], p["hist.tsv"])
    step("assignGenomeSpace_proximity", "assignGenomeSpace", "--proximity",
         p["1d.bed"], gtf, sizes)
    for name, contacts, out in (("contacts", "contacts.bedpe", "3d.bed"),
                                ("empty_contacts", "empty.bedpe",
                                 "3d_empty.bed")):
        step(f"assignGenomeSpace_{name}", "assignGenomeSpace",
             "--contactFile", p[contacts], "--nearestGeneBed", p[out], gtf,
             sizes)
    step("strawToBedpe", "strawToBedpe", p["straw.list"], p["straw.bedpe"],
         "-binSize", str(OS_BIN), "-minBinDistance", str(OS_MIN_BIN),
         "-fdr", str(OS_FDR), "-minCutoff", str(OS_MIN_CUTOFF),
         "-fitStatsFile", p["fit.txt"], "-contactScoreFile", p["scores.txt"])
    step("assignGenomeSpace_straw", "assignGenomeSpace", "--contactFile",
         p["straw.bedpe"], "--nearestGeneBed", p["3d_straw.bed"], gtf, sizes)
    step("ontologyEnrichment_contacts", "ontologyEnrichment",
         p["queries.bed"], sizes, gtf, p["a.gaf"], p["in.obo"],
         p["enrich.bed"], "-contactFile", p["contacts.bedpe"])
    return os_in


def tss_plain(tss: dict) -> list:
    """The TSSs as a merged TSS bed holds them: one 1 bp record a
    position, sorted, named by its first gene in the GTF's order; as
    mutable [chrom, start, end, name, score] rows of score 0."""
    return [[c, s, s + 1, names[0], 0] for (c, s), names in sorted(
        tss.items())]


def fill_1d_plain(tss: list, sizes: dict) -> list:
    """Every base to its TSS by 1D distance, the boundary after
    (start + previous end) // 2: [chrom, start, end, name, TSS start]."""
    out = []
    for i, (c, s, e, name, _) in enumerate(tss):
        first = i == 0 or tss[i - 1][0] != c
        last = i == len(tss) - 1 or tss[i + 1][0] != c
        lo = 0 if first else (s + tss[i - 1][2]) // 2 + 1
        hi = sizes[c] if last else (tss[i + 1][1] + e) // 2 + 1
        out.append([c, lo, hi, name, s])
    return out


def tile_of(tiles: dict, c: str, x: int):
    """The tile of chrom c that holds base x, or None."""
    if c not in tiles:
        return None
    starts, rows = tiles[c]
    i = int(np.searchsorted(starts, x, "right")) - 1
    return rows[i] if i >= 0 and rows[i][1] <= x < rows[i][2] else None


def tile_index(rows: list) -> dict:
    """chrom -> (tile starts, tiles) of sorted, non-overlapping tiles
    (empty ones left out)."""
    out = {}
    for r in rows:
        if r[2] > r[1]:
            out.setdefault(r[0], []).append(r)
    return {c: (np.array([r[1] for r in v]), v) for c, v in out.items()}


def fill_3d_plain(tss: list, contact_rows: list, sizes: dict) -> list:
    """The 3D fill as the reference's rules make it, in plain Python:
    each contact foot's midpoint takes its 1D tile's TSS and distance,
    the nearer foot's to both; with the TSSs, one pass of the merge that
    keeps the lower distance (a lower one carried across a gap as
    distance + gap), the territory pass to a fixed point, then tiles
    between the survivors. [chrom, start, end, name] rows."""
    one_d = fill_1d_plain(tss, sizes)
    if not contact_rows:
        return [r[:4] for r in one_d]
    tiles = tile_index(one_d)
    recs = [list(t) for t in tss]
    for w in contact_rows:
        if w[0] not in tiles:
            continue
        halves = []
        for c, s, e in ((w[0], int(w[1]), int(w[2])),
                        (w[3], int(w[4]), int(w[5]))):
            m = (s + e) // 2
            t = tile_of(tiles, c, m)
            if t is None:
                raise SystemExit("fill_3d_plain: a foot off the tiles")
            halves.append([c, m, m + 1, t[3], abs(m - t[4])])
        a, b = halves
        if a[4] < b[4]:
            b[4], b[3] = a[4], a[3]
        elif b[4] < a[4]:
            a[4], a[3] = b[4], b[3]
        recs += halves
    recs = [r for r in recs if r[0] in sizes]
    recs.sort(key=lambda r: (r[0], r[1], r[2]))
    merged, curr = [], recs[0]
    for r in recs[1:]:
        if curr[0] == r[0] and max(curr[1], r[1]) < min(curr[2], r[2]):
            if r[4] < curr[4]:
                curr = r
        elif curr[0] == r[0]:
            gap = r[1] - curr[2]
            if curr[4] + gap < r[4]:
                r[4], r[3] = curr[4] + gap, curr[3]
            elif r[4] + gap < curr[4]:
                curr[4], curr[3] = r[4] + gap, r[3]
            merged.append(curr)
            curr = r
        else:
            merged.append(curr)
            curr = r
    merged.append(curr)
    violation = True
    while violation:
        kept, violation = [], False
        for prev, r in zip(merged, merged[1:]):
            if prev[0] == r[0] and \
                    (prev[2] - prev[4] + r[1] + r[4]) // 2 < prev[2]:
                violation = True
            else:
                kept.append(prev)
        merged = kept + [merged[-1]]
    out = []
    curr = [merged[0][0], 0, merged[0][2], merged[0][3], 0]
    for i, r in enumerate(merged[1:], 1):
        prev = merged[i - 1]
        if r[0] != curr[0]:
            curr[2] = sizes[prev[0]]
            out.append(curr)
            curr = [r[0], 0, 0, curr[3], 0]
        elif curr[3] == r[3]:
            curr[1], curr[2] = min(curr[1], r[1]), max(curr[2], r[2])
            curr[4] = min(curr[4], r[4])
        else:
            mid = (curr[2] - prev[4] + r[1] + r[4]) // 2
            curr[2], curr[3] = mid + 1, prev[3]
            out.append(curr)
            curr = [r[0], mid + 1, 0, "", 0]
        curr[2], curr[3] = r[2], r[3]
    curr[2] = sizes[merged[-1][0]]
    out.append(curr)
    return [r[:4] for r in out]


def tiles_gates(rows: list, sizes: dict, names: dict) -> dict:
    """Tiles [chrom, start, end, name, ...] sorted by chrom, a chrom's
    contiguous over [0, size), no tile reversed, each name a gene of its
    chrom (names: chrom -> gene names)."""
    keys = [(r[0], int(r[1])) for r in rows]
    by = {}
    for r in rows:
        by.setdefault(r[0], []).append((int(r[1]), int(r[2]), r[3]))
    contiguous = all(
        v[0][0] == 0 and v[-1][1] == sizes[c]
        and all(a[1] == b[0] for a, b in zip(v, v[1:]))
        and all(e >= s for s, e, _ in v) for c, v in by.items())
    return {"tiles": len(rows), "sorted": keys == sorted(keys),
            "contiguous": contiguous, "chroms": sorted(by),
            "names_of_chrom": all(n in names.get(c, ()) for c, v in
                                  by.items() for _, _, n in v)}


def onto_straw_checks(os_in: dict) -> dict:
    """What the gates of item 13's and strawToBedpe's steps read from
    their files, with numpy, scipy and text alone, importing none of
    these tools' modules."""
    from scipy import special, stats

    p, sizes, tss = os_in["paths"], os_in["sizes"], os_in["tss"]
    out = {}
    rows = bed_rows(p["map.tsv"])
    out["obo_mapping"] = {
        "rows": len(rows),
        "equal_complete_stanzas": [tuple(r) for r in rows]
        == os_in["complete"]}

    def records(lines):
        return [ln.split("\t") for ln in lines
                if ln and not ln.startswith(("!", "#"))]

    a_lines = os_in["gafs"]["a"]
    want = [ln for ln in a_lines if ln.startswith("!")] + [
        "\t".join(w + [""] * (17 - len(w))) for w in records(a_lines)
        if "NOT" not in w[3]]
    with open(p["a_filt.gaf"]) as fh:
        got = fh.read().splitlines()
    out["gaf_filter"] = {"lines": len(got), "equal_numpy": got == want,
                         "not_records": sum("NOT" in w[3] for w in
                                            records(a_lines))}

    children = {t: [] for t in os_in["ids"]}
    for t in os_in["ids"]:
        for q in os_in["parents"][t]:
            children[q].append(t)
    start, seen, stack = os_in["alt_start"], set(), [os_in["alt_start"]]
    while stack:
        t = stack.pop()
        if t not in seen:
            seen.add(t)
            stack += children[t]
    with open(p["sub.dot"]) as fh:
        dot = fh.read().splitlines()
    nodes = {ln.split('"')[1] for ln in dot if "[label" in ln}
    edges = sorted(tuple(ln.split('"')[1::2]) for ln in dot if "->" in ln)
    out["obo_to_dot"] = {
        "nodes": len(nodes), "nodes_equal_descendants": nodes == seen,
        "edges_equal_children": edges == sorted(
            (t, c) for t in seen for c in children[t]),
        "framed": dot[:1] == ["digraph G {"] and dot[-1:] == ["}"]}

    counts = {}
    for name in "ab":
        pairs = {(w[4], w[2]) for w in records(os_in["gafs"][name])}
        for go, _ in pairs:
            counts[go] = counts.get(go, 0) + 1
    known = set(os_in["ids"]) | {"GO:0999999"}
    hist = [f"{k}\t{v}" for k, v in sorted(counts.items()) if k in known]
    with open(p["hist.tsv"]) as fh:
        out["ontology_histogram"] = {"terms": len(hist), "equal_numpy":
                                     fh.read().splitlines() == hist}

    names = {}
    for (c, _), ns in tss.items():
        names.setdefault(c, set()).update(ns)
    plain_tss = tss_plain(tss)
    one_d = fill_1d_plain(plain_tss, sizes)
    rows = bed_rows(p["1d.bed"])
    starts = {}
    for c, s, *_ in plain_tss:
        starts.setdefault(c, []).append(s)
    rng = np.random.default_rng(OS_SEED + 1)
    idx = tile_index([[r[0], int(r[1]), int(r[2]), r[3], int(r[4])]
                      for r in rows])
    farther = []
    for c, at in starts.items():
        at = np.array(at)
        xs = np.concatenate([rng.integers(0, sizes[c], 2000),
                             idx[c][0] if c in idx else []]).astype(int)
        for x in xs:
            t = tile_of(idx, c, int(x))
            farther.append(10 ** 9 if t is None else
                           abs(int(x) - t[4]) - int(np.abs(at - x).min()))
    out["proximity"] = {
        **tiles_gates(rows, sizes, names),
        "merged_tss": len(plain_tss),
        "one_tile_a_tss": sorted((r[0], int(r[4])) for r in rows)
        == sorted(tss),
        "sampled": len(farther), "most_bases_farther": int(max(farther)),
        "equal_plain": [[r[0], int(r[1]), int(r[2]), r[3], int(r[4])]
                        for r in rows] == one_d}

    contact_rows = bed_rows(p["contacts.bedpe"])
    for key, path, crows in (
            ("contacts", "3d.bed", contact_rows),
            ("straw_contacts", "3d_straw.bed", bed_rows(p["straw.bedpe"]))):
        rows = bed_rows(p[path])
        out[key] = {**tiles_gates(rows, sizes, names),
                    "equal_plain": [[r[0], int(r[1]), int(r[2]), r[3]]
                                    for r in rows]
                    == fill_3d_plain(tss_plain(tss), crows, sizes)}
    with open(p["3d_empty.bed"], "rb") as a, open(p["1d.bed"], "rb") as b:
        out["contacts"]["empty_file_equal_proximity"] = a.read() == b.read()

    # ontologyEnrichment: the written bed, then numpy's proportions, k
    # and scipy's tails
    rows = bed_rows(p["enrich.bed"])
    three_d = bed_rows(p["3d.bed"])
    lengths = {}
    for r in rows:
        g = r[3].upper()
        lengths[g] = lengths.get(g, 0) + int(r[2]) - int(r[1])
    total = sum(lengths.values())
    gene_p = {g: v / total for g, v in lengths.items()}
    term_genes, seen_pairs = {t: [] for t in known}, set()
    for w in records(a_lines):
        if w[4] + w[2] not in seen_pairs:
            seen_pairs.add(w[4] + w[2])
            if w[4] in term_genes:
                term_genes[w[4]].append(w[2])
    gene_terms = {}
    for t in [*os_in["ids"], "GO:0999999"]:
        for g in term_genes[t]:
            gene_terms.setdefault(g, []).append(t)
    term_name = dict(os_in["complete"])

    def close(got, want):
        return abs(got - want) <= OS_PRINT_RTOL * abs(want) + OS_PRINT_ATOL

    printed = {r[0]: float(r[1]) for r in
               bed_rows(os.path.splitext(p["enrich.bed"])[0]
                         + ".geneProportions.txt")[1:]}
    term_p = {t: math.fsum(gene_p.get(g.upper(), 0.0) for g in gs)
              for t, gs in term_genes.items()}
    term_rows = bed_rows(os.path.splitext(p["enrich.bed"])[0]
                          + ".termProportions.txt")
    enrich_rows = bed_rows(os.path.splitext(p["enrich.bed"])[0]
                            + ".termEnrichment.txt")
    idx = tile_index([[r[0], int(r[1]), int(r[2]), r[3]] for r in rows])
    k, off = {}, 0
    queries = bed_rows(p["queries.bed"])
    for c, s, e in queries:
        t = tile_of(idx, c, (int(s) + int(e)) // 2)
        if t is None:
            off += 1
            continue
        for term in gene_terms.get(t[3], []):
            k[term] = k.get(term, 0) + 1
    n = len(queries)
    errs, branches, zmax = [], {"zero": 0, "normal": 0, "exact": 0}, 0.0
    for r in enrich_rows[1:]:
        t, pt, kt = r[0], term_p[r[0]], k.get(r[0], 0)
        if kt == 0:
            want, branch = 0.0, "zero"
        elif n * pt > 10 and n * (1 - pt) > 10:
            z = (kt - 0.5 - n * pt) / math.sqrt(n * pt * (1 - pt))
            want, branch, zmax = float(special.log_ndtr(-z)), "normal", \
                max(zmax, z)
        else:
            want, branch = float(stats.binom.logsf(kt - 1, n, pt)), "exact"
        branches[branch] += 1
        errs.append(not close(float(r[2]), want))
    annotated = all(r[5] == "." and r[6:] == [
        term_name[t] for t in gene_terms.get(r[3], [])] for r in rows)
    out["ontology_enrichment"] = {
        "tiles_equal_assign": [r[:4] for r in rows] == three_d,
        "annotations_equal": annotated,
        "gene_props_equal": set(printed) == set(gene_p) and all(
            close(printed[g], v) for g, v in gene_p.items()),
        "gene_props_sum_off_one": abs(math.fsum(printed.values()) - 1),
        "term_props_equal": [r[0] for r in term_rows[1:]] == [
            t for t in [*os_in["ids"], "GO:0999999"] if term_p[t] > 0]
        and all(close(float(r[2]), term_p[r[0]]) and r[1] == term_name[r[0]]
                for r in term_rows[1:]),
        "enrichment_terms": len(enrich_rows) - 1,
        "enrichment_mismatches": sum(errs), "branches": branches,
        "largest_z": zmax, "queries_off_tiles": off,
        "terms_with_hits": len(k)}

    # strawToBedpe
    st = os_in["straw"]
    d = np.abs(st[:, 0] - st[:, 1]) // OS_BIN
    length = max(2, int(d.max()) + 1)
    hist = ["BinDistance\tScore\tCount", ""]
    for i in range(length):
        row = np.bincount(st[d == i, 2], minlength=100)
        hist += [f"{i}\t{s}\t{row[s]}" for s in range(100)]
    with open(p["scores.txt"]) as fh:
        scores_equal = fh.read() == "\n".join(hist) + "\n"
    lo, hi = np.minimum(st[:, 0], st[:, 1]), np.maximum(st[:, 0], st[:, 1])
    span = (int(hi.max()) - int(lo.min())) // OS_BIN
    fit = bed_rows(p["fit.txt"])
    cutoffs = np.full(length, OS_MIN_CUTOFF)
    mismatches = ambiguous = 0
    for r in fit[1:]:
        i, rr, pp, cut = int(r[0]), float(r[1]), float(r[2]), int(r[3])
        row = np.bincount(st[d == i, 2]) if (d == i).any() else [0]
        want, rank, near = OS_MIN_CUTOFF, 0, False
        for s in range(len(row) - 1, OS_MIN_CUTOFF, -1):
            rank += int(row[s])
            if not rank:
                continue
            q = (1 - stats.nbinom.cdf(s, rr, pp)) * (span - i) / rank
            near |= abs(q - OS_FDR) <= OS_Q_RTOL * OS_FDR
            if np.isfinite(q) and q > OS_FDR:
                want = s
                break
        ambiguous += int(near)
        mismatches += int(want != cut and not near)
        cutoffs[i] = cut
    dists = [int(r[0]) for r in fit[1:]]
    cuts = [int(r[3]) for r in fit[1:]]
    rows_ok = (fit[:1] == [["BinDistance", "R", "P", "Cutoff"]]
               and dists == list(range(OS_MIN_BIN, OS_MIN_BIN + len(dists)))
               and OS_MIN_CUTOFF not in cuts[:-1]
               and (cuts[-1:] == [OS_MIN_CUTOFF] or dists[-1] == length - 1))
    keep = (d >= OS_MIN_BIN) & (st[:, 2] > cutoffs[np.minimum(d, length -
                                                               1)])
    written = bed_rows(p["straw.bedpe"])
    got = [(int(w[1]), int(w[4]), int(w[7])) for w in written]
    out["straw_to_bedpe"] = {
        "contacts": len(st), "written": len(got), "fit_rows": len(dists),
        "score_file_equal_numpy": scores_equal,
        "fit_rows_ordered": rows_ok, "cutoff_mismatches": mismatches,
        "cutoffs_near_fdr": ambiguous,
        "written_equal_numpy": got == [tuple(map(int, x)) for x in st[keep]],
        "feet_one_bin": all(w[0] == w[3] == "chr1"
                            and int(w[2]) - int(w[1]) == OS_BIN
                            and int(w[5]) - int(w[4]) == OS_BIN
                            for w in written)}
    return out


def onto_straw_ok(x: dict) -> bool:
    """Every gate of onto_straw_checks met."""
    om, gf, dt, oh = (x["obo_mapping"], x["gaf_filter"], x["obo_to_dot"],
                      x["ontology_histogram"])
    obo_ok = (om["equal_complete_stanzas"] and gf["equal_numpy"]
              and gf["not_records"] > 0 and dt["nodes"] > 1
              and dt["nodes_equal_descendants"] and dt["edges_equal_children"]
              and dt["framed"] and oh["equal_numpy"] and oh["terms"] > 0)
    px = x["proximity"]
    space_ok = (px["equal_plain"] and px["one_tile_a_tss"]
                and px["most_bases_farther"] <= 1
                and px["tiles"] == px["merged_tss"])
    for key in ("proximity", "contacts", "straw_contacts"):
        t = x[key]
        space_ok = (space_ok and t["sorted"] and t["contiguous"]
                    and t["names_of_chrom"] and t["equal_plain"])
    space_ok = space_ok and x["contacts"]["empty_file_equal_proximity"]
    oe = x["ontology_enrichment"]
    enrich_ok = (oe["tiles_equal_assign"] and oe["annotations_equal"]
                 and oe["gene_props_equal"]
                 and oe["gene_props_sum_off_one"] <= 1e-6
                 and oe["term_props_equal"] and oe["enrichment_terms"] > 0
                 and oe["enrichment_mismatches"] == 0
                 and oe["branches"]["normal"] > 0
                 and oe["branches"]["exact"] > 0
                 and oe["largest_z"] < 26 and oe["queries_off_tiles"] == 0)
    sb = x["straw_to_bedpe"]
    straw_ok = (sb["score_file_equal_numpy"] and sb["fit_rows_ordered"]
                and sb["fit_rows"] > 0 and sb["cutoff_mismatches"] == 0
                and sb["written_equal_numpy"] and sb["feet_one_bin"]
                and 0 < sb["written"] < sb["contacts"])
    return bool(obo_ok and space_ok and enrich_ok and straw_ok)


def gg_text(path: str) -> tuple:
    """{node id: sequence} and the (from, to) edges of a .gg file, read as
    plain text."""
    seqs, edges, cur = {}, [], None
    with open(path) as fh:
        for ln in fh:
            ln = ln.rstrip("\n")
            if not ln:
                continue
            if ln.startswith(">"):
                cur = int(ln[1:])
                seqs[cur] = []
            elif "\t" in ln:
                w = ln.split("\t")
                edges += [(int(w[0]), int(w[i + 1]))
                          for i in range(1, len(w) - 1, 2)]
            else:
                seqs[cur].append(ln)
    return {k: "".join(v) for k, v in seqs.items()}, edges


def rebuilt_read(runs: list, read: str, seqs: list, t0: int) -> str | None:
    """The read that gonomics' binary giraf format gives back from the
    path's node sequences seqs, its start t0 and the cigar runs. Its
    writer (getFancySeq) keeps the read's bases under S, X and I runs,
    its index into the read moving by every run's length, D's too; its
    reader (addFullSeq) takes = bases from the nodes, moving to the next
    node's first base past a node's end, and the kept bases in order
    for S, X and I, X and D stepping over reference bases without
    changing node. None where the path runs out."""
    kept, at = [], 0
    for n, op in runs:
        if op in "SXI":
            kept.append(read[at:at + n])
        at += n
    out, at, node = [], t0, 0
    for n, op in runs:
        if op == "=":
            for _ in range(n):
                if at > len(seqs[node]) - 1:
                    at, node = 0, node + 1
                    if node == len(seqs):
                        return None
                out.append(seqs[node][at])
                at += 1
        elif op in "SXI":
            out.append(kept.pop(0))
        at += n if op in "XD" else 0
    return "".join(out)


def resolve_match_ops(line: str, nodes: dict) -> str | None:
    """A mapped giraf line with each M run split into = and X runs
    against the graph's bases along its path (the binary giraf format
    keeps =, X, I, D and S, and its reader refuses M); None where the
    format cannot carry it: a path end is negative (it stores them as
    uint32) or the read that its reader would rebuild is not the read
    (rebuilt_read)."""
    w = line.split("\t")
    t0, path, t1 = w[5].split(":")
    if min(int(t0), int(t1)) < 0:
        return None
    seqs = [nodes[int(n)] for n in path.split(">")]
    ref = "".join(seqs)[int(t0):]
    runs, q, t = [], 0, 0
    for n, op in re.findall(r"(\d+)([MIDNSHP=X])", w[6]):
        n = int(n)
        if op in "M=X":
            ops = ["=" if a == b else "X"
                   for a, b in zip(w[9][q:q + n], ref[t:t + n])]
            q, t = q + n, t + n
        else:
            ops = [op] * n
            q += n if op in "IS" else 0
            t += n if op == "D" else 0
        for o in ops:
            if runs and runs[-1][1] == o:
                runs[-1][0] += 1
            else:
                runs.append([1, o])
    if rebuilt_read(runs, w[9], seqs, int(t0)) != w[9]:
        return None
    w[6] = "".join(f"{n}{o}" for n, o in runs)
    return "\t".join(w)


def one_hot(text: str) -> np.ndarray:
    """faToPfa's rows of a sequence by numpy: one-hot on A, C, G and T
    in either case, 0.25 on N, zero on a gap."""
    a = np.frombuffer(text.upper().encode(), np.uint8)
    out = np.zeros((len(a), 4), np.float32)
    for i, c in enumerate(b"ACGT"):
        out[a == c, i] = 1
    out[a == ord("N")] = 0.25
    return out


def go_log2_np(x: np.ndarray) -> np.ndarray:
    """Go's math.Log2 of positive finite float64s by numpy: frexp, exact
    powers of two, else FDLIBM's Log of the fraction over Ln2 plus the
    exponent, each step in Go's order."""
    l1, l2, l3, l4, l5, l6, l7 = GO_LOG_L
    frac, exp = np.frexp(x)
    f1, ki = np.frexp(frac)
    small = f1 < math.sqrt(2) / 2
    f1 = np.where(small, f1 * 2, f1)
    k = np.where(small, ki - 1, ki).astype(np.float64)
    f = f1 - 1
    s = f / (2 + f)
    s2 = s * s
    s4 = s2 * s2
    t1 = s2 * (l1 + s4 * (l3 + s4 * (l5 + s4 * l7)))
    t2 = s4 * (l2 + s4 * (l4 + s4 * l6))
    r = t1 + t2
    hfsq = 0.5 * f * f
    log = k * GO_LN2_HI - ((hfsq - (s * (hfsq + r) + k * GO_LN2_LO)) - f)
    return np.where(frac == 0.5, exp - 1.0,
                    log * 1.4426950408889634 + exp.astype(np.float64))


def entropy_np(rows: np.ndarray) -> np.ndarray:
    """Shannon entropy in bits of each row, through go_log2_np, summed
    over A, C, G and T in that order, zero entries skipped."""
    out = np.zeros(len(rows))
    for c in range(4):
        p = rows[:, c].astype(np.float64)
        term = -p * go_log2_np(np.where(p > 0, p, 1.0))
        out = out + np.where(p > 0, term, 0.0)
    return out


def giraf_pfa_inputs(tmp: str, giraf: str, gg: str, t_fa: str, vcf: str,
                     aln: str, *, chunk: int = GP_CHUNK,
                     soft_cols: int = GP_SOFT_COLS) -> dict:
    """The inputs of slice 14a's steps, under tmp, from GP_SEED: of the
    aligner's giraf on the graph gg, gp_mapped.giraf (its records with a
    path: girafSort keys each by its first node) and gp_match.giraf
    (those that the binary format can carry, with M runs resolved to =
    and X, resolve_match_ops, after a share GP_X_SHARE had a seeded base
    changed, so that X runs and the 3-bit packed bases are there); of the
    target t_fa, gp_t1.fa (its first chrom alone, as vcfToPfa wants) and
    gp_regions.bed (GP_REGIONS seeded beds on that chrom); gp_g.vcf (the
    VCF's biallelic substitutions on that chrom with GP_SAMPLES seeded
    genotypes each); gp_soft.pfa of the first ``soft_cols`` columns of
    the multiFa alignment aln: the reference (the target row, a gap
    every GP_REF_GAP_EVERY columns), ``first`` (the target row) and
    ``second`` (the query row, N every GP_N_EVERY columns), the bases
    of both a share GP_SOFT blurred towards a Dirichlet draw by up to
    GP_BLUR. Returns the paths and what the checks need."""
    rng = np.random.default_rng(GP_SEED)
    p = {k: os.path.join(tmp, "gp_" + k) for k in (
        "mapped.giraf", "match.giraf", "t1.fa", "g.vcf", "soft.pfa",
        "regions.bed")}
    with open(giraf) as fh:
        lines = fh.read().splitlines()
    mapped = [ln for ln in lines if ln.split("\t")[5].split(":")[1]]
    nodes, edges = gg_text(gg)
    matched, uncarried = [], []
    for ln in mapped:
        w = ln.split("\t")
        k = int(rng.integers(len(w[9])))
        if rng.random() < GP_X_SHARE and w[9][k] in "ACGT":
            w[9] = (w[9][:k] + "ACGT"[("ACGT".index(w[9][k]) + 1) % 4]
                    + w[9][k + 1:])
        m = resolve_match_ops("\t".join(w), nodes)
        if m is not None:
            matched.append(m)
        else:
            uncarried.append(ln)
    for key, rows in (("mapped.giraf", mapped), ("match.giraf", matched)):
        with open(p[key], "w") as fh:
            fh.writelines(ln + "\n" for ln in rows)

    chrom, target = next(iter(fasta_text(t_fa).items()))
    with open(p["t1.fa"], "w") as fh:
        fh.write(f">{chrom}\n")
        fh.writelines(target[i:i + 60] + "\n"
                      for i in range(0, len(target), 60))
    starts = rng.integers(0, len(target) - 1000, GP_REGIONS)
    beds = [(int(s), int(s + n)) for s, n in
            zip(starts, rng.integers(1, 1000, GP_REGIONS))]
    with open(p["regions.bed"], "w") as fh:
        fh.writelines(f"{chrom}\t{s}\t{e}\n" for s, e in beds)

    head, sites = [], []
    with open(vcf) as fh:
        for ln in fh:
            w = ln.rstrip("\n").split("\t")
            if ln.startswith("##"):
                head.append(ln)
            elif (not ln.startswith("#") and w[0] == chrom
                  and len(w[3]) == 1 and len(w[4]) == 1):
                sites.append(w[:8])
    sites.sort(key=lambda w: int(w[1]))
    gts = rng.choice(["0/0", "0/1", "1/0", "1/1", "0|1", "1|1"],
                     (len(sites), GP_SAMPLES))
    with open(p["g.vcf"], "w") as fh:
        fh.writelines(head)
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                 + "\t".join(f"s{i}" for i in range(GP_SAMPLES)) + "\n")
        fh.writelines("\t".join(w + ["GT"] + list(g)) + "\n"
                      for w, g in zip(sites, gts))

    t_row, q_row = list(fasta_text(aln).values())[:2]
    cols = min(soft_cols, len(t_row))

    def blur(rows):
        sel = (rows.max(axis=1) == 1) & (rng.random(len(rows)) < GP_SOFT)
        e = rng.uniform(0, GP_BLUR, (int(sel.sum()), 1))
        mix = rng.dirichlet(np.ones(4), int(sel.sum()))
        rows[sel] = ((1 - e) * rows[sel] + e * mix).astype(np.float32)
        return rows

    ref = one_hot(t_row[:cols])
    ref[GP_REF_GAP_EVERY - 1::GP_REF_GAP_EVERY] = 0
    second = one_hot(q_row[:cols])
    second[GP_N_EVERY - 1::GP_N_EVERY] = 0.25
    soft = {chrom: ref, "first": blur(one_hot(t_row[:cols])),
            "second": blur(second)}
    write_pfa(p["soft.pfa"], soft)
    soft = {k: v.astype("<f2").astype(np.float32) for k, v in soft.items()}
    return {"paths": p, "gg": gg, "t_fa": t_fa, "chrom": chrom,
            "target": target, "beds": beds, "sites": sites, "gts": gts,
            "soft": soft, "nodes": nodes, "edges": edges,
            "all_records": len(lines), "mapped": mapped, "matched": matched,
            "uncarried": uncarried, "chunk": chunk}


def giraf_pfa_steps(step, gp: dict) -> dict:
    """The steps of slice 14a in phase_tools_cli, on giraf_pfa_inputs:
    sortGraph of the graph; girafSort of gp_mapped.giraf in chunks of
    gp["chunk"] records; girafCompress of a copy of gp_match.giraf, then
    -decompress of its .fe against the graph; pFaTools faToPfa of the
    target's first chrom, vcfToPfa of gp_g.vcf over gp_t1.fa, extract
    and visualize (blocks and -tsvOut) of GP_VIS's columns of the soft
    second query, extractBed of the regions, entropyTrack and sample of
    the soft .pfa; pfaFindFast of first against second, short and long.
    Returns gp with the output paths."""
    p = gp["paths"]
    tmp = os.path.dirname(p["soft.pfa"])
    p.update({k: os.path.join(tmp, "gp_" + k) for k in (
        "sorted.gg", "sorted.giraf", "rt.giraf", "t.pfa", "v.pfa", "ex.pfa",
        "exbed.pfa", "ent.wig", "samples", "vis.txt", "vis.tsv", "ff.bed",
        "ff_long.bed")})
    chrom, (lo, hi, width) = gp["chrom"], GP_VIS
    step("sortGraph", "sortGraph", gp["gg"], p["sorted.gg"])
    step("girafSort", "girafSort", p["mapped.giraf"], gp["gg"],
         p["sorted.giraf"], "-chunkSize", str(gp["chunk"]))
    with open(p["match.giraf"]) as src, open(p["rt.giraf"], "w") as dst:
        dst.write(src.read())
    step("girafCompress", "girafCompress", p["rt.giraf"])
    step("girafCompress_decompress", "girafCompress", p["rt.giraf"] + ".fe",
         "-decompress", "-ref", gp["gg"])
    step("pFaTools_faToPfa", "pFaTools", "faToPfa", gp["t_fa"], p["t.pfa"],
         "-chrom", chrom)
    step("pFaTools_vcfToPfa", "pFaTools", "vcfToPfa", p["g.vcf"], p["t1.fa"],
         p["v.pfa"], "-end", str(len(gp["target"])))
    step("pFaTools_extract", "pFaTools", "extract", p["soft.pfa"], "second",
         str(lo), str(hi), p["ex.pfa"], "-outName", "ex")
    step("pFaTools_extractBed", "pFaTools", "extractBed", p["t.pfa"],
         p["regions.bed"], p["exbed.pfa"], "-takeCoords")
    step("pFaTools_entropyTrack", "pFaTools", "entropyTrack", p["soft.pfa"],
         p["ent.wig"])
    os.mkdir(p["samples"])
    step("pFaTools_sample", "pFaTools", "sample", p["soft.pfa"], "second",
         p["samples"], "-numSamples", str(GP_DRAWS), "-setseed",
         str(GP_SEED))
    step("pFaTools_visualize", "pFaTools", "visualize", p["soft.pfa"],
         str(lo), str(hi), p["vis.txt"], "-chrom", "second", "-lineLength",
         str(width))
    step("pFaTools_visualize_tsv", "pFaTools", "visualize", p["soft.pfa"],
         str(lo), str(hi), p["vis.tsv"], "-chrom", "second", "-sigFigs", "4",
         "-tsvOut")
    ff = [p["soft.pfa"], "-firstQueryName", "first", "-secondQueryName",
          "second", "-windowSize", str(GP_WINDOW), "-chrom", chrom]
    step("pfaFindFast", "pfaFindFast", ff[0], p["ff.bed"], *ff[1:])
    step("pfaFindFast_long", "pfaFindFast", ff[0], p["ff_long.bed"], *ff[1:],
         "-longOutput", "-divergenceRate", str(GP_RATE), "-outputAlnPos")
    return gp


def printed_within(text: str, value: float) -> bool:
    """A %.Nf or %.Ne print of value off it by at most half a unit of its
    last digit."""
    mant, _, ex = text.partition("e")
    places = len(mant.partition(".")[2])
    unit = 10.0 ** ((int(ex) if ex else 0) - places)
    return abs(float(text) - value) <= 0.5 * unit * (1 + 1e-9)


def giraf_pfa_checks(gp: dict) -> dict:
    """What the gates of slice 14a's steps read from their files, with
    numpy and text alone, importing none of these tools' modules."""
    p, nodes, edges = gp["paths"], gp["nodes"], gp["edges"]
    out = {}
    with open(p["sorted.giraf"] + ".idx") as fh:
        idx = [int(x) for x in fh.read().split()]
    rank = {n: i for i, n in enumerate(idx)}
    idx_ok = (sorted(idx) == sorted(nodes)
              and all(rank[u] < rank[v] for u, v in edges))
    s_nodes, s_edges = gg_text(p["sorted.gg"])
    out["sort_graph"] = {
        "nodes": len(s_nodes), "edges": len(s_edges),
        "edges_forward": all(u < v for u, v in s_edges),
        "equal_reordered": idx_ok and len(s_nodes) == len(nodes)
        and all(s_nodes[i] == nodes[n] for i, n in enumerate(idx))
        and sorted(s_edges) == sorted((rank[u], rank[v]) for u, v in edges)}

    def key(ln):
        w = ln.split("\t")
        t0, path, _ = w[5].split(":")
        r = [rank[int(n)] for n in path.split(">")]
        return r[0], int(t0), tuple(r[1:])

    with open(p["sorted.giraf"]) as fh:
        got = fh.read().splitlines()
    keys = [key(ln) for ln in got]
    out["giraf_sort"] = {
        "records": len(got), "unmapped_left_out":
        gp["all_records"] - len(gp["mapped"]),
        "chunks": -(-len(gp["mapped"]) // gp["chunk"]),
        "same_lines": sorted(got) == sorted(gp["mapped"]),
        "keys_nondecreasing": all(a <= b for a, b in zip(keys, keys[1:])),
        "idx_topological": idx_ok}

    with open(p["rt.giraf"]) as fh:
        back = fh.read().splitlines()
    want = []
    for ln in gp["matched"]:
        w = ln.split("\t")
        w[4] = "+" if int(w[3]) & 8 else "-"
        want.append("\t".join(w))
    out["giraf_compress"] = {
        "records": len(back), "uncarried_left_out": len(gp["uncarried"]),
        "first_uncarried": "\t".join(
            gp["uncarried"][0].split("\t")[i] for i in (0, 5, 6))
        if gp["uncarried"] else None,
        "equal_but_strand": back == want,
        "strands_turned": sum(a.split("\t")[4] != b.split("\t")[4]
                              for a, b in zip(gp["matched"], back)),
        "x_runs": sum(ln.split("\t")[6].count("X") for ln in gp["matched"]),
        "fe_bytes": os.path.getsize(p["rt.giraf"] + ".fe"),
        "giraf_bytes": os.path.getsize(p["match.giraf"])}

    chrom, target, soft = gp["chrom"], gp["target"], gp["soft"]
    hot = one_hot(target)
    t_pfa = pfa_records(p["t.pfa"])
    out["fa_to_pfa_one_hot"] = (list(t_pfa) == [chrom]
                                and np.array_equal(t_pfa[chrom], hot))
    want, total = hot.copy(), np.float32(2 * gp["gts"].shape[1])
    for w, g in zip(gp["sites"], gp["gts"]):
        if int(w[1]) >= len(target):
            continue
        alleles = "/".join(g).replace("|", "/").split("/")
        row = np.zeros(4, np.float32)
        for a, base in ((0, w[3]), (1, w[4])):
            row["ACGT".index(base)] = (np.float32(alleles.count(str(a)))
                                       / total)
        want[int(w[1]) - 1] = row
    v_pfa = pfa_records(p["v.pfa"])
    out["vcf_to_pfa"] = {
        "sites": len(gp["sites"]),
        "equal_numpy": list(v_pfa) == [chrom] and np.array_equal(
            v_pfa[chrom], want.astype("<f2").astype(np.float32))}
    lo, hi, width = GP_VIS
    ex, exbed = pfa_records(p["ex.pfa"]), pfa_records(p["exbed.pfa"])
    out["extract_equal"] = (list(ex) == ["ex"] and np.array_equal(
        ex["ex"], soft["second"][lo:hi]))
    out["extract_bed_equal"] = (
        list(exbed) == [f"{chrom}:{s}-{e}" for s, e in gp["beds"]]
        and all(np.array_equal(v, hot[s:e])
                for v, (s, e) in zip(exbed.values(), gp["beds"])))

    wig, name = {}, None
    with open(p["ent.wig"]) as fh:
        for ln in fh:
            if ln.startswith("fixedStep"):
                name = ln.split()[1].partition("=")[2]
                wig[name] = [ln.split()[2:]]
            else:
                wig[name].append(float(ln))
    out["entropy"] = {
        "records": len(wig),
        "headers_equal": all(wig[k][0] == ["start=1", "step=1", "span=0"]
                             for k in wig),
        "equal_numpy": sorted(wig) == sorted(soft) and all(
            np.array_equal(np.asarray(wig[k][1:]), entropy_np(soft[k]))
            for k in soft)}

    rng, sec = np.random.default_rng(GP_SEED), soft["second"]
    cdf_a, cdf_c = sec[:, 0], sec[:, 0] + sec[:, 1]
    cdf_g = cdf_c + sec[:, 2]
    draws_equal = True
    for i in range(GP_DRAWS):
        r = rng.random(len(sec), np.float32)
        bases = np.where(r < cdf_a, "A", np.where(
            r < cdf_c, "C", np.where(r < cdf_g, "G", "T")))
        draws_equal &= (fasta_text(os.path.join(p["samples"],
                                                f"sample_{i}.fa"))
                        == {"second": "".join(bases)})
    out["sample_equal_numpy"] = bool(draws_equal)

    with open(p["vis.txt"]) as fh:
        vis = fh.read().splitlines()
    seen, vis_ok = [], vis[0] == f"Start: {lo}. End: {hi}. Decimal Places: 5."
    for i in (i for i, ln in enumerate(vis) if ln.startswith("Position: ")):
        at = int(vis[i].split()[1])
        rows = [vis[i + 1 + c].split("\t") for c in range(4)]
        vis_ok &= all(r[2] == "ACGT"[c] for c, r in enumerate(rows))
        n = len(rows[0]) - 4
        seen += range(at, at + n)
        vis_ok &= all(printed_within(t, float(sec[at + j, c]))
                      for c, r in enumerate(rows)
                      for j, t in enumerate(r[4:]))
    with open(p["vis.tsv"]) as fh:
        tsv = [ln.split("\t") for ln in fh.read().splitlines()]
    tsv_ok = tsv[0] == ["Position", "Base", "Probability"] and [
        (int(w[0]), w[1]) for w in tsv[1:]] == [
        (i, b) for i in range(lo, hi) for b in "ACGT"]
    tsv_ok &= all(printed_within(w[2], float(sec[int(w[0]),
                                                 "ACGT".index(w[1])]))
                  for w in tsv[1:])
    out["visualize"] = {"blocks_equal": bool(vis_ok)
                        and seen == list(range(lo, hi)),
                        "tsv_equal": bool(tsv_ok), "rows": len(tsv) - 1}

    ref, fq, W = soft[chrom], soft["first"], GP_WINDOW

    def gap(r):
        return (r == 0).all(axis=1)

    def is_n(r):
        return (r[:, 0] != 0) & (r == r[:, :1]).all(axis=1)

    def sums(x):
        c = np.concatenate(([0], np.cumsum(x)))
        return c[W:] - c[:-W]

    pos = np.flatnonzero(~gap(fq))
    first, last = pos[:len(pos) - W + 1], pos[W - 1:]
    keep = ~(gap(ref)[first] | gap(ref)[last])
    c_ref = np.concatenate(([0], np.cumsum(~gap(ref))))
    dot = (fq[:, 0] * sec[:, 0] + fq[:, 1] * sec[:, 1]
           + fq[:, 2] * sec[:, 2] + fq[:, 3] * sec[:, 3]).astype(np.float64)
    subst = sums((~gap(sec) & (1.0 - dot >= 0.8))[pos])
    confident = sums((sec.max(axis=1) >= np.float32(0.8))[pos])
    dirty = np.concatenate(([0], np.cumsum(
        gap(fq) | gap(sec) | is_n(fq) | is_n(sec))))
    clean = dirty[last + 1] == dirty[first]
    aln_pos = np.concatenate(([0], pos[:-1] + 1))[:len(first)]
    short, long_ = bed_rows(p["ff.bed"]), bed_rows(p["ff_long.bed"])
    k = np.flatnonzero(keep)
    lines_ok = len(short) == len(long_) == len(k) and all(
        w[:5] == v[:5] and w[0] == chrom and w[3] == f"{chrom}_{w[1]}"
        for w, v in zip(short, long_))
    cols = np.array([[int(x) for x in (w[1], w[2], w[4], w[8], w[9], w[10],
                                       w[11], w[12])] for w in long_],
                    np.int64).reshape(-1, 8)
    s_, e_, muts, sub, gaps, span, conf, apos = cols.T
    c = clean[k]
    pval = np.array([float(w[7]) for w in long_])
    j = np.arange(W + 1)
    log_pmf = (np.array([math.lgamma(W + 1) - math.lgamma(x + 1)
                         - math.lgamma(W - x + 1) for x in j])
               + j * math.log(GP_RATE) + (W - j) * math.log1p(-GP_RATE))
    upper = np.logaddexp.accumulate(log_pmf[::-1])[::-1]  # ln P(X >= k)
    tail = np.where(muts > 0, -upper[muts] / math.log(10), 0.0)
    out["pfa_find_fast"] = {
        "windows": len(short), "clean_windows": int(c.sum()),
        "clean_with_muts": int((c & (muts > 0)).sum()),
        "lines_equal": bool(lines_ok)
        and np.array_equal(s_, c_ref[first[k]])
        and np.array_equal(e_, c_ref[last[k] + 1])
        and np.array_equal(span, e_ - s_) and np.array_equal(apos, aln_pos[k]),
        "muts_sum": np.array_equal(muts, sub + gaps),
        "clean_equal_numpy": np.array_equal(sub[c], subst[k][c])
        and not gaps[c].any() and np.array_equal(muts[c], subst[k][c]),
        "confident_equal_numpy": np.array_equal(conf, confident[k]),
        "pct_equal": all(printed_within(w[6], 100 * (int(w[4]) / W))
                         for w in long_),
        "pval_off": float(np.max(np.abs(pval - tail)
                                 / np.maximum(np.abs(tail), 1e-300),
                                 initial=0.0))}
    return out


def giraf_pfa_ok(x: dict) -> bool:
    """Every gate of giraf_pfa_checks met, girafSort's merge over at
    least GP_MIN_CHUNKS chunks."""
    sg, gs, gc, ff = (x["sort_graph"], x["giraf_sort"], x["giraf_compress"],
                      x["pfa_find_fast"])
    giraf_ok = (sg["edges_forward"] and sg["equal_reordered"]
                and sg["edges"] > 0 and gs["same_lines"]
                and gs["keys_nondecreasing"] and gs["idx_topological"]
                and gs["chunks"] >= GP_MIN_CHUNKS and gc["equal_but_strand"]
                and gc["records"] > 0 and gc["strands_turned"] > 0
                and gc["x_runs"] > 0 and gc["fe_bytes"] < gc["giraf_bytes"])
    pfa_ok = (x["fa_to_pfa_one_hot"] and x["vcf_to_pfa"]["equal_numpy"]
              and x["vcf_to_pfa"]["sites"] > 0 and x["extract_equal"]
              and x["extract_bed_equal"] and x["entropy"]["equal_numpy"]
              and x["entropy"]["headers_equal"] and x["sample_equal_numpy"]
              and x["visualize"]["blocks_equal"]
              and x["visualize"]["tsv_equal"])
    find_ok = (ff["windows"] > 0 and ff["clean_windows"] > 0
               and ff["clean_with_muts"] > 0 and ff["lines_equal"]
               and ff["muts_sum"] and ff["clean_equal_numpy"]
               and ff["confident_equal_numpy"] and ff["pct_equal"]
               and ff["pval_off"] <= GP_PVAL_RTOL)
    return bool(giraf_ok and pfa_ok and find_ok)


def route_rows(a: str, b: str, route: list, unit: int = 1) -> tuple:
    """The two rows that an alignment route of (run, op) pairs over units
    of ``unit`` characters makes of a and b: op 0 (M) takes a unit of
    each, 1 (I) a gap in a, 2 (D) a gap in b."""
    ra, rb, i, j = [], [], 0, 0
    for run, op in route:
        for _ in range(run):
            ra.append("-" * unit if op == 1 else a[i:i + unit])
            rb.append("-" * unit if op == 2 else b[j:j + unit])
            i += unit * (op != 1)
            j += unit * (op != 2)
    return "".join(ra), "".join(rb)


def sim_views_inputs(tmp: str, gg: str, t_fa: str, q_fa: str, aln: str,
                     snps: dict, *, reads: int = SV_READS,
                     snv: int = SV_SNV, msa: tuple = SV_MSA) -> dict:
    """The inputs of slices 14b and 15a's steps, under tmp/sv, from
    SV_SEED, on the first chrom of t_fa (chrom) and the multiFa
    alignment aln of chrom: multFaVisualizer's window around the first
    gap of aln's reference row; vis.bed, SV_BEDS planted SNPs of chrom
    (snps: {chrom: [(1-based pos, ref, alt)]}) padded by SV_BED_PAD;
    ideo.bed, every planted SNP padded by 0-19 seeded bases a side, with
    a name and a seeded score; pair.fa, SV_PAIR_BP bases of chrom around
    a planted SNP (target) and the same with its alt and SV_PAIR_INDELS
    indels of 1-8 bases (query); msa.fa, msa[0] records of msa[1] chunks
    of SV_CHUNK bases of chrom, each with a share SV_MSA_SUB of its
    chunks given a changed base, one or two whole-chunk deletions and,
    half the time, a random chunk inserted; words.fa, two records of
    SV_CHUNK-base words: word 2 three times in a and word 3 three times
    in b, between flanks of words 0 and 1 (b's left flank one word
    shorter, its right one longer), word 3 being word 2 with the fewest
    changed bases that make the three word-2/word-3 columns score
    between the cost of the two 3-chunk gaps with the extend penalty
    scaled by the chunk size and without it; a pairwise/ directory of
    three assemblies' .byChrom/ fasta files (hg t_fa's chroms, pt
    q_fa's, mm chrom in two halves and q_fa's last chrom), a species
    list, a ref list and an allDists file of one close, one far and one
    numeric distance; a fancy job-array file of SV_SLURM_LINES lines.
    Returns the paths and what the steps and checks need."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.align.matrices import HUMAN_CHIMP_TWO

    rng = np.random.default_rng(SV_SEED)
    d = os.path.join(tmp, "sv")
    os.mkdir(d)
    p = {k: os.path.join(d, k) for k in (
        "vis.bed", "ideo.bed", "pair.fa", "msa.fa", "words.fa", "slurm.txt",
        "pairwise", "species.txt", "refs.txt", "dists.txt")}
    targets, queries = fasta_text(t_fa), fasta_text(q_fa)
    chrom, ref = next(iter(targets.items()))
    ref_row = next(iter(fasta_text(aln).values()))
    g = ref_row.find("-")  # the reference bases before its first gap
    g = len(ref) // 2 if g < 0 else g
    vis = (max(0, g - SV_VIS[0]), min(len(ref), g + SV_VIS[1]))

    def rand_bases(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    def changed(base):
        return "ACGT"[("ACGT".index(base) + int(rng.integers(1, 4))) % 4]

    on = [pos for pos, _, _ in snps[chrom]
          if SV_BED_PAD < pos < len(ref) - SV_BED_PAD]
    regions = [(on[i] - 1 - SV_BED_PAD, on[i] + SV_BED_PAD)
               for i in sorted(rng.choice(len(on), SV_BEDS, replace=False))]
    with open(p["vis.bed"], "w") as fh:
        fh.writelines(f"{chrom}\t{s}\t{e}\tsnp{k}\n"
                      for k, (s, e) in enumerate(regions))
    ideo = []
    for c, sites in snps.items():
        for pos, _, _ in sites:
            lo, hi = (int(x) for x in rng.integers(0, 20, 2))
            ideo.append((c, pos - 1 - lo, pos + hi,
                         int(rng.integers(1, 1000))))
    with open(p["ideo.bed"], "w") as fh:
        fh.writelines(f"{c}\t{s}\t{e}\tsnp_{c}_{s}\t{score}\n"
                      for c, s, e, score in ideo)

    half = SV_PAIR_BP // 2
    cand = [(pos, alt) for pos, _, alt in snps[chrom]
            if SV_PAIR_BP <= pos <= len(ref) - SV_PAIR_BP]
    pos, alt = cand[int(rng.integers(len(cand)))]
    pair_t = ref[pos - 1 - half:pos - 1 + half]
    q = list(pair_t)
    q[half] = alt
    spots = np.r_[50:half - 50, half + 50:SV_PAIR_BP - 50]
    for k, at in enumerate(sorted(rng.choice(spots, SV_PAIR_INDELS,
                                             replace=False), reverse=True)):
        n = int(rng.integers(1, 9))
        if k % 2:
            q[at:at] = list(rand_bases(n))
        else:
            del q[at:at + n]
    pair_q = "".join(q)
    with open(p["pair.fa"], "w") as fh:
        fh.write(f">target\n{pair_t}\n>query\n{pair_q}\n")

    C, (n_rec, n_chunks) = SV_CHUNK, msa
    at = int(rng.integers(0, len(ref) - n_chunks * C))
    base = [ref[at + i * C:at + (i + 1) * C] for i in range(n_chunks)]
    records = {}
    for r in range(n_rec):
        ch = list(base)
        for i, w in enumerate(ch):
            if rng.random() < SV_MSA_SUB:
                k = int(rng.integers(C))
                ch[i] = w[:k] + changed(w[k]) + w[k + 1:]
        for _ in range(int(rng.integers(1, 3))):
            k = int(rng.integers(1, 3))
            at = int(rng.integers(len(ch) - k))
            del ch[at:at + k]
        if rng.random() < 0.5:
            at = int(rng.integers(len(ch) + 1))
            ch[at:at] = [rand_bases(C)]
        records[f"s{r}"] = "".join(ch)
    with open(p["msa.fa"], "w") as fh:
        fh.writelines(f">{k}\n{v}\n" for k, v in records.items())

    hct = np.asarray(HUMAN_CHIMP_TWO, np.int64)

    def chunk_score(x, y):
        return int(hct[dna.from_string(x), dna.from_string(y)].sum())

    words = [rand_bases(C) for _ in range(3)]
    scaled, unscaled = 2 * (-300 - 3 * 40 * C), 2 * (-300 - 3 * 40)
    for k in range(1, C + 1):
        w3 = list(words[2])
        for i in rng.choice(C, k, replace=False):
            w3[i] = changed(w3[i])
        if scaled < 3 * chunk_score(words[2], "".join(w3)) < unscaled:
            break
    else:
        raise SystemExit("no word 3 between the two gap costs")
    words.append("".join(w3))
    left, right = rng.integers(0, 2, (2, SV_WORD_FLANK)).tolist()
    b_left = list(left)
    del b_left[int(rng.integers(SV_WORD_FLANK))]
    b_right = list(right)
    b_right.insert(int(rng.integers(SV_WORD_FLANK + 1)), int(rng.integers(2)))
    letters = (left + [2, 2, 2] + right, b_left + [3, 3, 3] + b_right)
    scores = np.full((5, 5), -1000, np.int32)
    scores[:4, :4] = [[chunk_score(x, y) for y in words] for x in words]
    word_seqs = ["".join(words[i] for i in x) for x in letters]
    with open(p["words.fa"], "w") as fh:
        fh.write(f">a\n{word_seqs[0]}\n>b\n{word_seqs[1]}\n")

    pw = p["pairwise"]
    asm = {"hg": list(targets.items()), "pt": list(queries.items()),
           "mm": [("c1a", ref[:len(ref) // 2]), ("c1b", ref[len(ref) // 2:]),
                  ("c2", list(queries.values())[-1])]}
    for a, recs in asm.items():
        os.makedirs(f"{pw}/{a}.byChrom")
        for name, s in recs:
            with open(f"{pw}/{a}.byChrom/{name}.fa", "w") as fh:
                fh.write(f">{name}\n{s}\n")
    species, refs = ["hg", "pt", "mm"], ["hg", "mm"]
    for key, rows in (("species.txt", species), ("refs.txt", refs),
                      ("dists.txt", ["hg\tpt\tclose", "mm\thg\tfar",
                                     "pt\tmm\t0.45"])):
        with open(p[key], "w") as fh:
            fh.writelines(r + "\n" for r in rows)

    with open(p["slurm.txt"], "w") as fh:
        for i in range(SV_SLURM_LINES):
            kind = ("exists", "exists+", "line", "line+")[rng.integers(4)]
            fh.write(f"sbatch --mem={rng.integers(1, 65)}G job_{i}.sh "
                     f"{{check {i} {kind} {d}/out_{i}.txt}} "
                     f"--tail={rng.integers(100)}\n")
    return {"paths": p, "gg": gg, "aln": aln, "chrom": chrom, "ref": ref,
            "reads": reads, "snv": snv, "vis": vis,
            "end_start": len(ref) - SV_END_TAIL, "regions": regions,
            "ideo": ideo, "pair": (pair_t, pair_q), "msa": records,
            "words": word_seqs, "letters": letters, "word_scores": scores,
            "asm": {a: [n for n, _ in r] for a, r in asm.items()},
            "species": species, "refs": refs,
            "lz_pairs": {("hg", "pt"): "close", ("hg", "mm"): "far",
                         ("mm", "hg"): "far", ("mm", "pt"): "default"}}


def sim_views_steps(step, sv: dict, dev: torch.device, times: dict) -> dict:
    """The steps of slices 14b and 15a in phase_tools_cli, on
    sim_views_inputs: girafSimulate of the graph; its records as FASTQ
    aligned back to the graph by ``gsw align`` on dev (K4, K5 and the
    graph walk, counted); girafSimulate again with -somaticSNV;
    multFaVisualizer of the window and an END view of the last
    SV_END_TAIL bases, multFaVisualizeBeds of vis.bed and
    multFaVisualizer of each of its regions; faChunkAlign of the pair at
    chunk size 1 and of the records and the words at SV_CHUNK;
    faDrawAlnChunks of the records' alignment; lastZWriter in the
    default mode (-m false) and, on a copy of the pairwise tree made
    before, in -simple mode; formatIdeogram with and without --noScore;
    slurmCheck, its stdout kept. Then the routes of the card's
    ``align.affine_gap`` (K2's trace mode, counted) for the pair (its
    bases, HUMAN_CHIMP_TWO, -300, -40) and for the words (a letter a
    word, their chunk scores, -300, -40 x SV_CHUNK). Returns sv with the
    output paths, the routes, slurmCheck's stdout and the launches."""
    import shutil

    from gonomics_tpu_torch import align, dna
    from gonomics_tpu_torch.ops import gsw_dp, wavefront

    p = sv["paths"]
    d = os.path.dirname(p["pair.fa"])
    p.update({k: os.path.join(d, k) for k in (
        "sim.giraf", "sim.fq", "sim_aln.giraf", "som.giraf", "vis.txt",
        "vis_end.txt", "beds", "bed_vis", "pair_aln.fa", "msa_aln.fa",
        "words_aln.fa", "msa.png", "mats", "pairwise_simple", "lz.txt",
        "lz_simple.txt", "ideo.txt", "ideo_noscore.txt")})
    sim = ["-numReads", str(sv["reads"]), "-readLen", str(SV_READ_LEN),
           "-seed", str(SV_SEED)]
    step("girafSimulate", "girafSimulate", sv["gg"], p["sim.giraf"], *sim)
    with open(p["sim.giraf"]) as src, open(p["sim.fq"], "w") as dst:
        for ln in src:
            w = ln.rstrip("\n").split("\t")
            dst.write(f"@{w[0]}\n{w[9]}\n+\n{w[10]}\n")
    wavefront.local_launches = wavefront.gsw_right_launches = 0
    gsw_dp.walk_launches = 0
    step("gsw_align_simulated", "gsw", "align", sv["gg"], p["sim.fq"], "-o",
         p["sim_aln.giraf"], "--device", dev.type)
    launches = {"local_wavefront": wavefront.local_launches,
                "gsw_right_wavefront": wavefront.gsw_right_launches,
                "gsw_walk_pack": gsw_dp.walk_launches}
    step("girafSimulate_somatic", "girafSimulate", sv["gg"], p["som.giraf"],
         *sim, "-somaticSNV", str(sv["snv"]), "-somaticAF", str(SV_AF))

    line = ["-lineLength", str(SV_LINE)]
    step("multFaVisualizer", "multFaVisualizer", sv["aln"], p["vis.txt"],
         *(str(x) for x in sv["vis"]), *line)
    step("multFaVisualizer_end", "multFaVisualizer", sv["aln"],
         p["vis_end.txt"], str(sv["end_start"]), "END", *line)
    os.mkdir(p["beds"])
    os.mkdir(p["bed_vis"])
    step("multFaVisualizeBeds", "multFaVisualizeBeds", p["vis.bed"],
         sv["aln"], *line, "-outDir", p["beds"] + "/")
    for k, (s, e) in enumerate(sv["regions"]):
        step(f"multFaVisualizer_bed{k}", "multFaVisualizer", sv["aln"],
             os.path.join(p["bed_vis"], f"{sv['chrom']}_{s}_{e}.txt"),
             str(s), str(e), *line)

    step("faChunkAlign_pair", "faChunkAlign", p["pair.fa"], "1",
         p["pair_aln.fa"])
    step("faChunkAlign_msa", "faChunkAlign", p["msa.fa"], str(SV_CHUNK),
         p["msa_aln.fa"])
    step("faChunkAlign_words", "faChunkAlign", p["words.fa"], str(SV_CHUNK),
         p["words_aln.fa"])
    step("faDrawAlnChunks", "faDrawAlnChunks", p["msa_aln.fa"],
         str(SV_CHUNK), p["msa.png"])

    shutil.copytree(p["pairwise"], p["pairwise_simple"])
    lists = [p["species.txt"], p["refs.txt"], p["dists.txt"]]
    step("lastZWriter", "lastZWriter", "-m", "false", "-mPath", p["mats"],
         "lastz", p["pairwise"], *lists, p["lz.txt"])
    step("lastZWriter_simple", "lastZWriter", "-simple", "-parameters", "M=0",
         "lastz", p["pairwise_simple"], *lists, p["lz_simple.txt"])
    step("formatIdeogram", "formatIdeogram", p["ideo.bed"], p["ideo.txt"])
    step("formatIdeogram_noScore", "formatIdeogram", "--noScore",
         p["ideo.bed"], p["ideo_noscore.txt"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        step("slurmCheck", "slurmCheck", p["slurm.txt"])
    sv["slurm_stdout"] = buf.getvalue()

    wavefront.affine_launches = 0
    t = time.perf_counter()
    _, r_pair = align.affine_gap(*(dna.from_string(s) for s in sv["pair"]),
                                 align.HUMAN_CHIMP_TWO, -300, -40, device=dev)
    _, r_words = align.affine_gap(
        *(np.asarray(x, np.int8) for x in sv["letters"]), sv["word_scores"],
        -300, -40 * SV_CHUNK, device=dev)
    times["k2_routes"] = time.perf_counter() - t
    launches["affine_wavefront"] = wavefront.affine_launches
    sv["routes"] = {k: [(c.run_length, c.op) for c in r]
                    for k, r in (("pair", r_pair), ("words", r_words))}
    sv["launches"] = launches
    return sv


def locate_in_path(lens: dict, nodes: list, t0: int, k: int) -> tuple:
    """(node, position) of base k along a read's forward path: node ids
    ``nodes`` of lengths ``lens``, from position t0 of the first."""
    off = t0 + k
    for n in nodes:
        if off < lens[n]:
            return n, off
        off -= lens[n]
    return nodes[-1], off + lens[nodes[-1]]


def multi_fa_view(rows: list, start: int, end, line: int) -> tuple:
    """What multFaVisualizer prints of the multiFa rows [(name, text)]
    from reference base start to end (None: the alignment's end), by
    numpy: the header, each block's Position and rows (a query's
    character a dot where it equals the reference row's)."""
    ref = np.frombuffer(rows[0][1].encode(), np.uint8)
    cols = np.flatnonzero(ref != ord("-"))
    c0 = int(cols[start - 1]) + 1 if start else 0
    c1 = len(ref) if end is None else int(cols[end - 1]) + 1
    width = max(len(n) for n, _ in rows)
    header = f"Start: {start}. refCounter: {start}. alignCounter: {c0}"
    at, positions, blocks = start, [], []
    for k in range(c0, c1, line):
        stop = min(c1, k + line)
        positions.append(at)
        block = []
        for i, (name, text) in enumerate(rows):
            seg = np.frombuffer(text[k:stop].encode(), np.uint8)
            if i:
                seg = np.where(seg == ref[k:stop], ord("."), seg)
            block.append(f"|{name:<{width}}| "
                         + seg.astype(np.uint8).tobytes().decode())
        blocks.append(block)
        at += line - int((ref[k:stop] == ord("-")).sum())
    return header, positions, blocks


def read_view(path: str) -> tuple:
    """A multFaVisualizer file's header, Position values and blocks of
    rows."""
    with open(path) as fh:
        lines = fh.read().split("\n")
    positions, blocks = [], []
    for ln in lines[1:]:
        if ln.startswith("Position: "):
            positions.append(int(ln.split()[1]))
            blocks.append([])
        elif ln:
            blocks[-1].append(ln)
    return lines[0], positions, blocks


def sim_views_checks(sv: dict) -> dict:
    """What the gates of slices 14b and 15a's steps read from their files,
    with numpy and text alone and the card's routes from the steps,
    importing none of these tools' modules."""
    from PIL import Image

    from gonomics_tpu_torch.sketch import BLACK, TRUBETSKOY_PALETTE

    p, out, C = sv["paths"], {}, SV_CHUNK
    nodes, _ = gg_text(sv["gg"])
    lens = {k: len(v) for k, v in nodes.items()}
    sim, aln = bed_rows(p["sim.giraf"]), bed_rows(p["sim_aln.giraf"])
    truth, own = [], True
    for w in sim:
        n0, s1, nl, e1, strand = w[0].split("_")
        t0, path, t1 = w[5].split(":")
        ns = [int(x) for x in path.split(">")]
        truth.append((strand, int(n0), int(s1) - 1, int(nl), int(e1) - 1))
        own &= (w[4], ns[0], int(t0), ns[-1], int(t1)) == truth[-1]
    mapped = placed = 0
    for w, tr in zip(aln, truth):
        t0, path, t1 = w[5].split(":")
        if not path or int(w[7]) < 1200:
            continue
        mapped += 1
        ns = [int(x) for x in path.split(">")]
        placed += (w[4], ns[0], int(t0), ns[-1], int(t1)) == tr
    out["giraf_simulate"] = {
        "reads": len(sim), "aligned": len(aln),
        "order_kept": [w[0] for w in aln] == [w[0] for w in sim],
        "qname_is_path": bool(own),
        "lengths": sorted({len(w[9]) for w in sim}),
        "minus_strand": sum(w[4] == "-" for w in sim),
        "cross_edges": sum(">" in w[5] for w in sim),
        "mapped": mapped, "true_path": placed,
        "mapped_frac": mapped / max(len(sim), 1),
        "true_path_share": placed / max(len(sim), 1)}

    som = bed_rows(p["som.giraf"])
    fwd, aware, reads, bases = {}, set(), 0, 0
    for a, b in zip(sim, som):
        diff = [k for k, (x, y) in enumerate(zip(a[9], b[9])) if x != y]
        if not diff:
            continue
        reads += 1
        bases += len(diff)
        t0, path, _ = a[5].split(":")
        ns = [int(x) for x in path.split(">")]
        for k in diff:
            fwd.setdefault(locate_in_path(lens, ns, int(t0), k),
                           set()).add(b[9][k])
            mirror = k if a[4] == "+" else len(a[9]) - 1 - k
            aware.add(locate_in_path(lens, ns, int(t0), mirror))
    out["somatic"] = {
        "snv": sv["snv"], "records_equal_but_seq": len(som) == len(sim)
        and all(a[:9] + a[10:] == b[:9] + b[10:] and len(a[9]) == len(b[9])
                for a, b in zip(sim, som)),
        "reads_mutated": reads, "bases_mutated": bases,
        "locations": len(fwd), "strand_aware_locations": len(aware),
        "one_base_a_location": all(len(v) == 1 for v in fwd.values())}

    rows = list(fasta_text(sv["aln"]).items())
    ref = sv["ref"]
    vis = {}
    for key, name, (s, e) in (("window", "vis.txt", sv["vis"]),
                              ("end", "vis_end.txt", (sv["end_start"], None))):
        head, at, blocks = read_view(p[name])
        want = multi_fa_view(rows, s, e, SV_LINE)
        bases = [b[0].partition("| ")[2].replace("-", "") for b in blocks]
        starts = s + np.cumsum([0] + [len(x) for x in bases[:-1]])
        vis[key] = {
            "blocks": len(blocks), "header_equal": head == want[0],
            "positions_equal": at == want[1],
            "ref_bases_equal": "".join(bases) == ref[s:e] and all(
                x == ref[i:i + len(x)] for x, i in zip(bases, starts)),
            "rows_equal": blocks == want[2],
            "dots": sum(r.partition("| ")[2].count(".") for b in blocks
                        for r in b[1:])}
    names = sorted(f"{sv['chrom']}_{s}_{e}.txt" for s, e in sv["regions"])

    def same(name):
        with open(os.path.join(p["beds"], name), "rb") as x, \
                open(os.path.join(p["bed_vis"], name), "rb") as y:
            return x.read() == y.read()

    vis["beds"] = {"files_named": sorted(os.listdir(p["beds"])) == names,
                   "equal_visualizer": all(same(n) for n in names)}
    out["visualizer"] = vis

    pair = fasta_text(p["pair_aln.fa"])
    want = route_rows(*sv["pair"], sv["routes"]["pair"])
    words = fasta_text(p["words_aln.fa"])
    want_words = route_rows(*sv["words"], sv["routes"]["words"], C)
    msa = fasta_text(p["msa_aln.fa"])
    chunks = [[r[i:i + C] for i in range(0, len(r), C)] for r in msa.values()]
    out["chunk_align"] = {
        "pair_equal_card": list(pair) == ["target", "query"]
        and tuple(pair.values()) == want,
        "pair_gaps": sum(r.count("-") for r in want),
        "words_equal_card": list(words) == ["a", "b"]
        and tuple(words.values()) == want_words,
        "words_gap_chunks": sum(r.count("-" * C) for r in want_words),
        "msa_rows": len(msa), "msa_columns": len(next(iter(msa.values()))),
        "msa_inputs_kept": sorted(msa) == sorted(sv["msa"]) and all(
            msa[k].replace("-", "") == v for k, v in sv["msa"].items()),
        "msa_one_length": len({len(r) for r in msa.values()}) == 1
        and all(len(r) % C == 0 for r in msa.values()),
        "msa_whole_chunk_gaps": all(c.count("-") in (0, C)
                                    for r in chunks for c in r),
        "msa_gap_chunks": sum(c == "-" * C for r in chunks for c in r)}

    img = np.asarray(Image.open(p["msa.png"]).convert("RGB"))
    counts = {}
    for r in chunks:
        for c in r:
            if c != "-" * C:
                counts[c] = counts.get(c, 0) + 1
    rank = {c: i for i, c in enumerate(sorted(counts,
                                              key=lambda c: -counts[c]))}
    colours = [[BLACK if c == "-" * C
                else TRUBETSKOY_PALETTE[min(rank[c], 19)] for c in r]
               for r in chunks]
    top = sorted(counts.values(), reverse=True)[:19]
    out["draw"] = {
        "size": list(img.shape[:2]),
        "size_equal": list(img.shape[:2]) == [
            12 * len(chunks), len(chunks[0]) * 6 + 10 + 200],
        "centres_equal": all(
            tuple(img[i * 12 + 6, j * 6 + 3]) == tuple(col)
            for i, r in enumerate(colours) for j, col in enumerate(r)),
        "distinct_chunks": len(counts), "past_rank_19": len(counts) - 19,
        "tied_in_top_19": sum(top.count(v) > 1 for v in top)}

    lz = {}
    mats = p["mats"]
    for key, pw, simple in (("default", p["pairwise"], False),
                            ("simple", p["pairwise_simple"], True)):
        with open(p["lz_simple.txt" if simple else "lz.txt"]) as fh:
            lines = fh.read().splitlines()
        want = sorted((r, t, s, q) for r in sv["refs"] for s in sv["species"]
                      if s != r for t in sv["asm"][r] for q in sv["asm"][s])
        got, dirs, params = [], True, True
        for ln in lines:
            w = ln.split(" ")
            r, _, t = w[1][len(pw) + 1:].partition(".byChrom/")
            s, _, q = w[2][len(pw) + 1:].partition(".byChrom/")
            t, q = t.removesuffix(".fa"), q.removesuffix(".fa")
            got.append((r, t, s, q))
            o = w[3].removeprefix("--output=")
            dirs &= (o == (f"{pw}/{r}.{s}/{q}/{t}.{q}.axt" if simple
                           else f"{pw}/{r}.{s}/{t}/{q}.{t}.axt")
                     and os.path.isdir(os.path.dirname(o)))
            if simple:
                params &= ln.endswith(" --format=axt M=0") and "--scores" \
                    not in ln
            else:
                mat, par = LZ_SETS[sv["lz_pairs"][(r, s)]]
                params &= (w[4] == f"--scores={mats}/{mat}"
                           and ln.endswith(f" --format=axt {par} "))
        lz[key] = {"lines": len(lines), "lines_expected": len(want),
                   "pairs_equal": sorted(got) == want,
                   "output_dirs": bool(dirs), "params_by_distance":
                   bool(params)}
    files = sorted(os.listdir(mats)) if os.path.isdir(mats) else []

    def matrix_ok(name):
        with open(os.path.join(mats, name)) as fh:
            m = [ln.split("\t") for ln in fh.read().splitlines()]
        return (m[0] == list("ACGT") and len(m) == 5
                and all(len(x) == 5 and x[0] == "ACGT"[i]
                        for i, x in enumerate(m[1:])))

    lz["matrices"] = files == sorted(m for m, _ in LZ_SETS.values()) and all(
        matrix_ok(f) for f in files)
    out["last_z_writer"] = lz

    ideo = np.array([(s, e, score) for _, s, e, score in sv["ideo"]],
                    np.int64).reshape(-1, 3)
    mid = (ideo[:, 0] + ideo[:, 1]) // 2
    for key, name, score in (("ideogram", "ideo.txt", ideo[:, 2]),
                             ("ideogram_no_score", "ideo_noscore.txt",
                              np.full(len(ideo), 10))):
        with open(p[name]) as fh:
            got = fh.read().splitlines()
        want = [f"{c}\t{m + dm}\t{v if dm == 0 else 1}"
                for (c, *_), m, v in zip(sv["ideo"], mid, score)
                for dm in (-1, 0, 1)]
        out[key] = {"lines": len(got), "equal_numpy": got == want}

    with open(p["slurm.txt"]) as fh:
        first = fh.readline().rstrip("\n")
    begin, _, rest = first.partition("{")
    inner, _, end = rest.partition("}")
    w = inner.split()
    out["slurm_check_equal"] = sv["slurm_stdout"] == (
        f"begin: {begin} \n out: {w[3]} \n check: {w[2]} \n end: {end} \n")
    out["launches"] = sv["launches"]
    return out


def sim_views_ok(x: dict, true_share: float = SV_TRUE_SHARE) -> bool:
    """Every gate of sim_views_checks met: the simulated reads mapped
    (>= 0.99) and on their true path (>= true_share); the somatic run
    the clean one's but for the bases, on at most as many locations as
    SNVs, one base a location, fewer locations along the forward path
    than strand-aware (the reverse complement taken before the
    mutations); the views, faChunkAlign against the card's routes,
    the drawing, lastZWriter, formatIdeogram and slurmCheck."""
    g, s, v, ca = (x["giraf_simulate"], x["somatic"], x["visualizer"],
                   x["chunk_align"])
    lz = x["last_z_writer"]
    sim_ok = (g["order_kept"] and g["qname_is_path"]
              and g["lengths"] == [SV_READ_LEN] and g["minus_strand"] > 0
              and g["cross_edges"] > 0 and g["mapped_frac"] >= 0.99
              and g["true_path_share"] >= true_share
              and s["records_equal_but_seq"] and s["reads_mutated"] > 0
              and 0 < s["locations"] <= s["snv"]
              and s["locations"] < s["strand_aware_locations"]
              and s["one_base_a_location"])
    vis_ok = all(v[k]["header_equal"] and v[k]["positions_equal"]
                 and v[k]["ref_bases_equal"] and v[k]["rows_equal"]
                 and v[k]["blocks"] > 1 and v[k]["dots"] > 0
                 for k in ("window", "end")) and all(v["beds"].values())
    align_ok = (ca["pair_equal_card"] and ca["pair_gaps"] > 0
                and ca["words_equal_card"] and ca["words_gap_chunks"] > 0
                and ca["msa_inputs_kept"] and ca["msa_one_length"]
                and ca["msa_whole_chunk_gaps"] and ca["msa_gap_chunks"] > 0
                and x["draw"]["size_equal"] and x["draw"]["centres_equal"]
                and x["draw"]["past_rank_19"] > 0
                and x["draw"]["tied_in_top_19"] > 0)
    lz_ok = lz["matrices"] and all(
        lz[k]["lines"] == lz[k]["lines_expected"] > 0
        and lz[k]["pairs_equal"] and lz[k]["output_dirs"]
        and lz[k]["params_by_distance"] for k in ("default", "simple"))
    return bool(sim_ok and vis_ok and align_ok and lz_ok
                and x["ideogram"]["equal_numpy"] and x["ideogram"]["lines"] > 0
                and x["ideogram_no_score"]["equal_numpy"]
                and x["slurm_check_equal"])


def phase_tools_cli(dev: torch.device) -> dict:
    """The tools around the engines, through the umbrella
    (``gonomics_tpu_torch.cli.main.main``), in process, on the data of
    ``tools_data``: (1) ``gsw ggtools`` chain to axt, vcf and gg, the VCF
    to gg and the axt to vcf; (2) ``gsw align <vcf>.gg`` of
    TOOLS_GRAPH_READS reads on the card with the default engine (K4, K5
    and the graph walk) and of the first TOOLS_CPU_READS with ``--device
    cpu``; (3) ``gsw align t.fa --engine tpu`` of TOOLS_DEPTH x of the
    query (the fused K1); (4) ``pileup``, ``samConsensus -multiFaDir``
    and ``samToBed`` on that SAM, sorted. Gates: every planted SNP in the
    chain's VCF with its position, ref and alt; graph reads mapped >=
    0.99 and the first TOOLS_CPU_READS girafs byte-equal to the CPU's;
    the consensus carries the query's base at >= 99% of the planted SNPs
    that reads cover (read through the multiFa alignment); one bed line
    a mapped read; pileup's rows are the covered positions; each of the
    four kernels launched in this phase. (5) Five more host tools on
    those files: ``mergesort`` of the aligner's SAM in chunks of
    4096 records (the spill-and-merge path), gated on its mapped records
    being the sorted SAM's in order under the input's header;
    ``bedMerge`` and ``bedToWig Reads`` of samToBed's records, gated on
    the merged bases and the wig's non-default positions being pileup's
    rows and the wig's sum the records' total length;
    ``intervalOverlap`` of a bed of the planted SNPs with the merged
    records, gated on its lines being the covered planted SNPs;
    ``faFormat -lineLength 60 -toLower snps.bed -index`` of the target,
    gated on its lower-case bases being the planted SNPs, its sequence
    upper-cased the target's, and its .fai the index of its output.
    (6) The fasta tools (``fasta_tools_checks`` reads their files):
    ``faFindFast`` of samConsensus's ``multi/chr1.fa`` in windows of
    TOOLS_WINDOW, gated on a window a first-query base, on muts being the
    differing columns in every window with no gap and no N, and on muts
    >= 1 in every window holding a covered planted SNP the consensus
    carries; with ``-longOutput -divergenceRate 0.01``, gated on its
    first five columns being the short output; ``assemblyStats``,
    ``faInfo``, ``faFilter -minSize 100000`` and ``faBin -binNum 2`` of
    the target, ``gcContent`` of the planted SNPs +- TOOLS_GC_FLANK,
    ``catMultiFa`` of the chr1 and chr2 alignments and ``faUniq`` of the
    target's records written twice, each gated on what numpy gives.
    (7) Slices 11.2b and 11.3a (``seq_recon_inputs`` writes their inputs,
    ``seq_recon_checks`` reads their files): ``digestGenome``,
    ``bedToFasta -revComp``, ``bedToAminoAcid``, ``faToPredictSet``,
    ``prcompFormat``, ``findAndReplace``, ``reconstructSeq`` (twice),
    ``primateRecon`` (hca and hga) and ``mouseRecon``, each gated on what
    numpy gives from the inputs; the checks import none of these tools'
    modules. (8) Slice 11.4 and bedFormat (``vcf_tools_checks`` reads
    their files): ``vcfFilter -substitutionsOnly -biAllelicOnly`` of the
    chain's VCF, gated on its records being the planted SNPs; ``vcfToFa
    -useAlt`` of that VCF on the target, gated on numpy's edit;
    ``vcfInfo -types -context`` of it (the target's .fai written by the
    port's ``fai``), gated on the twelve substitution counts and the
    trinucleotide counts (complements merged) numpy gives;
    ``multiFaToVcf -substitutionsOnly`` of the chr1 alignment, gated on a
    record with the query's base at each covered planted SNP the
    consensus carries and every REF the target's; ``vcfFormat -csv
    -clearInfo`` and ``-UCSCToEnsembl`` of the filtered VCF, gated on a
    row a record and on chroms 1 and 2 with the rest unchanged (``-csv``
    raises without ``-clearInfo`` on ggtools' INFO, and on multiFaToVcf's
    FORMAT ".", in the JAX too: neither is a header key);
    ``bedFormat -UCSCToEnsembl -evenPadLength 10`` of the SNP bed, gated
    on numpy's renamed, padded and clipped records. (9) Slice 11.5's bed
    tools and (10) slice 11.6's multiFa tools (``bed_multifa_inputs``
    writes their inputs, ``bed_multifa_checks`` reads their files and
    imports none of these tools' modules; each gate is numpy's lines from
    the inputs): ``bedFilter -minLength 100 -chrom chr1`` and ``bedSplit
    byChrom`` of samToBed's records; ``bedShear -fragmentSize 50``
    of the merged records; ``bedTrim -trimPercent 20`` of samToBed's;
    ``bedMath add`` of a numeric-named bed of the SNPs +- TOOLS_GC_FLANK
    with itself; ``bedSimilarity`` of the merged records against the SNP
    bed; ``bedOverlapByWindow -windowSize
    TOOLS_WINDOW`` of the merged records, gated on the prefix sums of
    their coverage; ``bedDistanceFromChrEnds`` of the SNP bed;
    ``bedMinimumDistanceName`` of a named record near each SNP against
    ``snps_strand.bed``; ``bedValueWig`` of the SNP bed on bedToWig's
    wig, gated on the wig's values; ``bedGraphToWig`` of a bedGraph of
    the merged records; ``multiFaCount`` (alone and ``-both``),
    ``multiFaExtract -bed -removeGaps`` (into a directory of its own,
    the working directory restored after), ``multiFaReduce
    -bedFilename`` and ``multiFaSequenceSwap`` (the query row with the
    target's bases at the chr1 SNPs) of the chr1 alignment;
    ``multiFaScan`` of that alignment with N planted in the query row at
    the chr1 SNPs; ``mergeMultiFa`` of it with the reconstruction's
    target row and mutants, gated on the rows that ``merged_columns``
    rebuilds from the two target rows' gaps; ``multiFaToChain`` of chr1's target and
    query aligned by the chain, gated on its blocks being chr1's blocks
    in ``t_q.chain``. (11) Slice 11.7a and wigTools (``sam_wig_steps``
    writes their inputs and runs them, ``sam_wig_checks`` reads their
    files and imports none of these tools' modules; each gate is what
    numpy or plain Python gives from the inputs): ``fastqFilter`` of
    r.fq with a seeded ``-subSet`` and a names list; ``fastqFormat
    -pairedEnd -singleCell`` of r.fq as both mates; ``fastqReplaceSeq``
    of a table of some reads' prefixes; ``longReadLibStats``; ``samInfo``
    ``readLength``, ``coverage`` and ``mapq`` of the sorted SAM;
    ``samToWig`` of it; ``mergesort`` of the aligner's SAM to a BAM, then
    ``write_bai``'s index of it (gated on its counts); ``bedCountBam``
    and ``samInfo mapq -bedfile`` of regions around every
    TOOLS_BAM_EVERY-th SNP; ``bamTagToReadGroup -tagId AS`` with the
    three commonest scores; ``wigTools filter -chrom chr1`` of bedToWig's
    wig; ``peaks``, ``math -movingAverageSmoothing 5``,
    ``-elementWiseSubtract`` and ``-pearson`` (against bedGraphToWig's
    wig), ``stats`` and ``toTrainingSet`` of samToWig's wig. (12) Slice
    11.8a (``rand_seq_steps`` runs the steps and the library check,
    ``rand_seq_checks`` reads their files with numpy and text alone):
    ``randSeq`` of RAND_NUM records of RAND_LEN bases at seed RAND_SEED,
    gated on the records' names, 50-base lines, a GC share within
    RAND_GC_TOL of 0.41 and |G-C|, |A-T| shares under it; of the first
    two records, gated on its bytes being the head of the first file's;
    of 10 bases at seed 1, gated on Go's published ``TATTTTGGGC``; and
    the port's ``GoRand(1)`` gated on Go's published Int63 and ten
    Intn(100), its stored burn-in table on ``compute_cooked``'s rebuild
    (``rand_seq`` in the phase line). (13) Slice 11.8b (``popgen_steps``
    writes the inputs and runs the steps, ``popgen_checks`` reads their
    files with numpy and scipy alone, ``popgen_ok`` gates them;
    ``popgen_tools`` in the phase line): ``statCalc`` densities, sums and
    integrals against scipy.stats, its seeded samplers against their
    means and variances; ``plotFunctions`` Normal, Beta and Gamma rows
    against scipy's pdfs, its three AFS pmfs summing to 1; ``selectionMle``
    of POP_SITES sites drawn from the AFS at POP_ALPHA, its estimate
    within POP_MLE_TOL of it and equal to the library's;
    ``selectionMcmc`` twice from one seed (the same bytes, MCMC_ITER
    rows) and ``mcmcTraceStats`` of its trace against numpy's mean and
    HDI; ``dunnIndex`` of DUNN_ROWS rows in two groups against numpy's
    Hamming distances on each window, and with ``-realign`` a row a
    window; ``simulateWrightFisher`` twice from one seed (the same
    bytes, frequencies summing to 1) and with ``-m 0`` from two bases,
    the other two never appearing. (14) Slice 11.9 and
    divergenceSpectrum (``interval_lift_inputs`` writes the seeded
    inputs, ``interval_lift_steps`` runs the steps, ``interval_lift_checks``
    reads their files with numpy and scipy alone, ``interval_lift_ok``
    gates them; ``interval_lift_tools`` in the phase line):
    ``liftCoordinates`` of samToBed's records at -minMatch 0.95 and
    IL_STRICT_MATCH, gated on numpy's map through the chain's blocks and
    its list of the reads that fail; of the chain's VCF with ``-faFile
    q.fa``, gated on every SNP written with REF and ALT swapped (the query
    carries the alt), every insertion under the INDEL message and every
    deletion failing -minMatch (its probe, from pos, covers the deleted
    bases alone); ``bedpeFilter``, ``bedpeOverlap -bedSelect`` (merged.bed
    at thresholds 0 and 0.5 and with -overlapBoth; the seeded tiles with
    -keepNames and with -overlapBoth at 0.5) and ``intervalContacts`` (of
    merged.bed and of the tiles) of IL_CONTACTS seeded contacts, gated on
    numpy's overlaps of each foot; ``intervalSubsetMatrix`` binary and
    -fraction of merged.bed, snps.bed and the tiles over 1 kb windows,
    value for value; ``geneAssignmentStats`` of a planted truth, its
    printed share and lines the planted ones; ``overlapEnrichments``
    upperBound, lowerBound and exact of merged.bed, and upperBound,
    normalApproximate and exact of the tiles, against the planted SNPs,
    gated on numpy's covered SNPs, scipy.stats.binom at numpy's
    probability, numpy's convolution of the Poisson-binomial and scipy's
    normal densities, the library's bounds on scipy's to IL_BINOM_RTOL;
    ``divergenceSpectrum`` of 10 kb windows of chr1 with a VCF of the
    planted SNPs, its six counts a window numpy's. (15) Item 10 and item
    11's MAF and axt tools (``vcf_maf_axt_inputs`` writes the seeded
    inputs, ``vcf_maf_axt_steps`` runs the steps, ``vcf_maf_axt_checks``
    reads their files with numpy and text alone, ``vcf_maf_axt_ok`` gates
    them; ``vcf_maf_axt_tools`` in the phase line): the genotype caller
    ``diploid_base_call_batch`` on the (P, 4) ACGT counts of pileup's
    rows, the target's bases as ref, on the card and with
    ``device="cpu"``, gated on the two being identical, equal to
    ``genotype_numpy`` (numpy's argmax of the same float64 formula), and
    on >= VMA_HOM_SHARE of the covered planted SNPs at depth >=
    VMA_MIN_DEPTH called homozygous for the query's base;
    ``filterGenotypes`` of the trio VCF (the planted SNPs as momma 0/0,
    poppa 1/1, kiddo 0/1, and VMA_DECOYS decoys failing the test) and
    with ``-byname poppa,kiddo``, gated on numpy's trio test and columns;
    ``alleleSplit -f1 kiddo -parentOne momma -parentTwo poppa`` of the
    aligner's SAM (in a directory of its own, the working directory
    restored after), gated on numpy's allele counts from each read's
    CIGAR and bases at the SNPs; ``haplotypeGenerator -includeRef`` over
    VMA_WINDOW bp windows of chr1, each record numpy's slice with the
    sample's alts; ``sampleVcf`` and ``proximityBlockVcf`` at their
    seeds, gated on numpy's PCG64 permutations (the kept records
    VMA_PROX[0] apart, each dropped one near one kept before it);
    ``vcfAncestorAnnotation`` of the chr1 SNPs over multiFaToChain's chr1
    pair, AA= the query row's base at the SNP's column; ``vcfAfs`` of
    popgen_steps' AFS VCF with a likelihood grid over VMA_AFS (a grid
    point at alpha 0 exactly raises), its frequencies and alphas
    numpy's, its likelihoods finite,
    the largest within a step of POP_ALPHA; ``mafFilter``, ``mafToBed``,
    ``mafToMultiFa`` (chr1, species t and q) and ``mafIndels`` of a MAF of
    the chain's ungapped blocks, each numpy's lines from the blocks;
    ``axTools --stats`` (the swapped wiring: c.axt, merged.bed and
    ``--bedfile`` the stats), ``--minScore``, ``--swap --tLen --qLen``,
    ``--gap`` and ``--fasta`` on axts of the chain's blocks with N
    planted at the SNPs, and ``axtSam --fasta`` of c.axt, each numpy's
    from the records (axtSam's CIGARs the rows' =/X/I/D runs, its X count
    the planted SNPs). (16) Slice 11.11b (``gtf_accel_inputs`` writes the
    seeded inputs, ``gtf_accel_steps`` runs the steps, ``gtf_accel_checks``
    reads their files with numpy and text alone, ``gtf_accel_ok`` gates
    them; ``gtf_accel_tools`` in the phase line): ``gtfTools filter``
    (-codingTranscript, -chromFilter chr2, -geneNameList with
    -chromFilter chr2) and ``toBed`` (plain, -tss with and without
    -merge, -firstTwoCodonBases) of a GTF of GA_GENES seeded genes,
    gated on numpy's gene ids and line counts (a listed gene passing
    off the chrom), lines, TSSs, merged TSSs and codons;
    ``getPromoter`` at GA_PROMOTER, gated on numpy's windows (the minus
    strand around the transcript's start, clipped at 0 and the chrom's
    size); ``geneIdToName`` with and without -keepMatching, gated on the
    lines and the printed counts; ``scCount`` of the aligner's SAM with
    GA_BARCODES barcodes in the read names, with and without
    -expNormalizationFile, gated on the header and numpy's matrix from
    each read's CIGAR span over each gene's first transcript;
    ``quickOrthologs`` through t_q.chain with and without
    --canonicalTranscript, gated on ``lift_numpy`` through
    ``chain_maps``, chrU's TSSs unmapped, no empty name, the canonical
    transcript by the strictly-longer swap (every GA_TIE_EVERY-th gene a
    tie); ``multiFaAcceleration`` of a four-way alignment of
    GA_ACCEL_BP columns (mutation distance, and SNP distance over a
    search space), gated on numpy's windows, acceleration = velocity -
    initial, means of 1, raw over normalised one constant, no negative
    length and the planted stretch's raw velocity >= GA_VEL_RATIO times
    the rest's; ``branchLengthsMultiFaBed -qOutFile -useSnpDistance`` of
    GA_REGIONS regions and one SNP window, gated on numpy's distances
    (prefix sums over the ungapped columns), ``accel_fit_numpy``'s
    lengths, Q by ``accel_q`` (the doubled chimp_hca) within GA_Q_RTOL
    and below Q at lengths 1, the ungapped count over size alignment
    columns, and the window's lengths equal to the SNP run's raw ones.
    (17) Slice 12a (``sim_tree_inputs`` writes the seeded inputs,
    ``sim_tree_steps`` runs the steps, ``sim_tree_checks`` reads their
    files with numpy and text alone, the .bam through the port's
    ``io/sam.read`` and the PNG through PIL, ``sim_tree_ok`` gates them;
    ``sim_tree_tools`` in the phase line): ``simulateSam`` of t.fa as
    ST_SAM, gated on the header, each pair's name, flags ({99, 147} or
    {83, 163}), RNEXT, PNEXT, TLEN, CIGAR, quals and MAPQs, the pair
    count (-coverage 2: int(2 * 250,000 / 300)), the chr1 share within
    ST_SHARE_SD binomial sd, each read equal to the reference through
    the fragment buffer's reuse (``sim_sam_checks``: the last base of an
    odd span carries the previous fragment's), the flat error share
    ST_FLAT +- ST_FLAT_TOL, ancient damage C->T or G->A only with the
    deamination table's count at 0 above its count at 10, and the .bam's
    records the .sam's; ``simulateBed`` of ng.bed twice (byte-equal) and
    ``-matchedBed``, each record ST_BED's length inside one named region;
    ``simulateVcf`` (chr1 at 1..100, A/T, diploid samples, 1-99 alt
    alleles, AA= REF or ALT), with ``-refFile tn.fa`` and ``-refFile
    collide.fa`` (REF the FASTA's, never N, ALT another base, starts
    distinct across chroms: the collide run takes each of its 12 starts
    once); ``simulateDivergentWindowsVcf`` at ST_DIV (2 windows of 20 a
    file, positions distinct in 1..100, lower windows' alt-ancestor
    counts at most the upper's); ``simulatePcr`` of ST_PRIMERS with and
    without ``-includePrimer=false`` (``pcr_products``: the products
    str.find gives with the same pairing rule, the FASTQ the template's
    slices with quals I, the printed count the lines); ``dotToNewick``
    (the newick the edges give, left child first); ``drawNewickTree`` at
    ST_IMG where PIL imports (else a line says it did not run): the
    size, ST_WHITE white, each node's line black where ``newick_rows``
    puts it. (18) Slice 12b (``sim_evol_inputs``, ``sim_evol_steps``,
    ``sim_evol_checks`` with numpy and text alone, ``sim_evol_ok``;
    ``sim_evol_tools`` in the phase line): ``simulateEvol genic`` of
    root.fa (SE_ROOT_BP bases) with gene.gp down SE_TREE, gated on 7
    leaves equal to those of the ``--completeSimOutput`` run's 13
    records, ATG at the CDS start and TAA, TAG or TGA at its end - 3 in
    every record (or a gap there), at most one gap a record;
    ``withIndels`` at SE_WI with ``--vcfOutFile`` and at bias 1 with
    ``-lambda``, gated on the ref row less its gaps the input, equal row
    lengths, each VCF line's REF and ALT the alignment's columns at its
    position (substitution, deletion and insertion each seen);
    ``nonCoding`` at SE_NC, gated on its records (ACGT, SE_NC's length,
    the root's GC 0.41 within SE_GC_TOL), the newick's names the
    records', the identity matrix's run all equal to its root, and runs
    over that newick from nc_n.fa and nc_a.fa equal past column 0, N
    there in every record; ``simRecon`` with ``--baseAccFile``, gated on
    the recon's leaves the leaf FASTA, a row a node with its exon and
    nonCoding rows and the total, values in [0, 100] with six
    decimals, and ``100.000000`` on every row over tree0.nh with
    gene_nostop.gp; ``ilsReconstructSeq`` of SE_ILS, gated on the .pfa
    equal to numpy's float32 sum (which a float64 sum is not, at some
    positions), rows within the precision of 1, and with weights 1 and
    0 the first recon. (19) Item 13 and strawToBedpe
    (``onto_straw_inputs`` over genes.gtf and its sizes,
    ``onto_straw_steps``, ``onto_straw_checks`` with numpy, scipy and
    text alone, ``onto_straw_ok``; ``onto_straw_tools`` in the phase
    line): ``oboTools mapping`` of OS_TERMS terms, gated on a row a
    complete stanza in file order (no [Typedef], no unterminated last
    stanza); ``gafFilter -removeNot``, the header and the non-NOT
    records padded to 17 fields; ``oboToDot`` from an alt id, its nodes
    the term's descendants by a walk and its edges their child edges;
    ``ontologyHistogram`` of two GAFs, numpy's counts of the pairs left
    after each file's duplicates go; ``assignGenomeSpace --proximity``,
    a tile a merged TSS, contiguous over each chrom, sampled bases at
    most one base farther from their tile's TSS than from the nearest,
    equal to ``fill_1d_plain``; ``--contactFile`` of OS_CONTACTS seeded
    contacts and of strawToBedpe's output, tiles sorted, contiguous and
    named by genes of their chrom, equal to ``fill_3d_plain`` (one merge
    pass), and an empty contact file giving --proximity's bytes;
    ``strawToBedpe`` of OS_STRAW at OS_BIN bp bins, the score histogram
    numpy's, the cutoffs re-derived from the fit's R and P with scipy's
    negative binomial, the written contacts exactly those above their
    distance's cutoff; ``ontologyEnrichment -contactFile`` of
    OS_QUERIES queries, its bed the 3D tiles with their terms, gene
    proportions each upper-cased name's share (summing to 1 within
    1e-6), term proportions their genes' sums, enrichments scipy's
    ``binom.logsf(k - 1, n, p)`` or ``log_ndtr(-z)`` within the print
    precision, k counted from the query midpoints. (20) Slice 14a
    (``giraf_pfa_inputs`` over the card's g.giraf and v.gg, the target,
    c.vcf and chr1's multiFa alignment, ``giraf_pfa_steps``,
    ``giraf_pfa_checks`` with numpy and text alone,
    ``giraf_pfa_ok``; ``giraf_pfa_tools`` in the phase line):
    ``sortGraph`` of v.gg, gated on every edge pointing forward and the
    nodes and edges v.gg's in girafSort's .idx order; ``girafSort
    -chunkSize GP_CHUNK`` of the mapped records (4 or more chunks),
    gated on the same multiset of lines in nondecreasing (first rank,
    start, ranks) order by the .idx, itself a topological order of
    v.gg; ``girafCompress`` of the records the binary format can carry
    (M resolved to = and X), then ``-decompress -ref v.gg``, gated on
    the text equal to the input but for the strand column, which
    follows flag bit 8, and the .fe smaller; ``pFaTools faToPfa``,
    one-hot rows; ``vcfToPfa`` of seeded genotypes at c.vcf's chr1
    substitutions, their shares at the sites; ``extract`` and
    ``extractBed``, the rows; ``entropyTrack`` of the soft .pfa, equal
    to a numpy entropy through a numpy copy of Go's Log2; ``sample``,
    numpy's CDF inversion under the same PCG64 seed; ``visualize`` in
    blocks and ``-tsvOut``, the probabilities at the printed precision;
    ``pfaFindFast`` short and long, windows and coordinates numpy's,
    substitutions in gap- and N-free windows and confident bases a
    numpy sliding-window sum, p values numpy's binomial tails. (21)
    Slices 14b and 15a (``sim_views_inputs`` over v.gg, the target and
    query, chr1's multiFa alignment and the planted SNPs,
    ``sim_views_steps``, ``sim_views_checks`` with numpy, text and the
    card's K2 routes, ``sim_views_ok``; ``sim_views_tools`` in the phase
    line, its launches added to the phase's): girafSimulate's reads
    aligned back on the card, >= 0.99 mapped and >= SV_TRUE_SHARE on the
    path their names give; the somatic run the clean one but for
    bases, one base a location along the forward path, fewer locations
    so than strand-aware; multFaVisualizer's header, positions,
    reference bases and dots, multFaVisualizeBeds' files equal to
    multFaVisualizer's; faChunkAlign at chunk size 1 equal to the route
    of the card's ``align.affine_gap`` (K2's trace mode), a word pair at
    chunk size 10 equal to K2's route over one letter a word scored by
    their chunk scores, 5 records kept whole in whole-chunk gaps;
    faDrawAlnChunks' size and each chunk's centre pixel by its rank;
    lastZWriter's job lines, output directories, parameter sets and
    matrices; formatIdeogram's points; slurmCheck's report."""
    from gonomics_tpu_torch import dna
    from gonomics_tpu_torch.cli.main import main as gonomics_torch
    from gonomics_tpu_torch.io import fai, fasta
    from gonomics_tpu_torch.io import vcf as vcfio
    from gonomics_tpu_torch.ops import banded, gsw_dp, wavefront

    out = {"phase": "tools_cli", "target_bp": dict(TOOLS_SIZES),
           "snp_every": TOOLS_SNP_EVERY, "indel_every": TOOLS_INDEL_EVERY}
    times = {}

    def step(name: str, *argv: str) -> None:
        t = time.perf_counter()
        gonomics_torch(list(argv))
        times[name] = time.perf_counter() - t

    with tempfile.TemporaryDirectory() as tmp:
        (t_fa, q_fa, chain), snps, queries = tools_data(tmp)
        planted = {(c, *s) for c in snps for s in snps[c]}
        out["planted_snps"] = len(planted)
        out["query_bp"] = sum(len(q) for q in queries.values())
        f = {k: os.path.join(tmp, k) for k in (
            "c.axt", "c.vcf", "c.gg", "v.gg", "a.vcf", "g.fq", "g400.fq",
            "g.giraf", "g400.giraf", "r.fq", "aln.sam", "s.sam",
            "pileup.txt", "cons.fa", "multi", "aln.bed", "m.sam",
            "merged.bed", "t.sizes", "reads.wig", "snps.bed", "hit.bed",
            "t60.fa", "ff.bed", "ff_long.bed", "stats.txt", "info.txt",
            "snps_gc.bed", "gc.bed", "big.fa", "bins", "cat.fa", "t2.fa",
            "uniq.fa", "digest.bed", "snps_strand.bed", "snps_rc.fa",
            "aa.bed", "aa.txt", "predict.txt", "prcomp.txt", "rename.txt",
            "renamed.bed", "recon.fa", "recon.nh", "recon_out.fa",
            "recon_sub.fa", "primates.fa", "primates.nh", "hca.fa", "hga.fa",
            "rodents.fa", "rodents.nh", "mra.fa", "snv.vcf", "alt.fa",
            "types.txt", "context.txt", "multi.vcf", "snv.csv", "ens.vcf",
            "snps_pad.bed", "q.fa", "filt.bed", "split", "shear.bed",
            "trim.bed", "sim.txt", "win.bed", "dist.bed", "snps_near.bed",
            "mind.bed", "num.bed", "math.bed", "val.bed", "merged.bedGraph",
            "bg.wig", "count.txt", "count_both.txt", "chr1_n.fa",
            "scan.bed", "extract", "extract.bed", "red.fa", "red.bed",
            "swap.fa", "merge_b.fa", "merged.fa", "pair.fa", "pair.chain",
            "names.txt", "fq_filt.fq", "fmt1.fq", "fmt2.fq", "replace.tsv",
            "replaced.fq", "lrs.txt", "lens.txt", "rl.txt", "cov_hist.txt",
            "cov_stats.txt", "mapq.txt", "cov.wig", "sorted.bam",
            "regions.bed", "bcb.txt", "mapq_bed.txt", "as.txt", "rg.bam",
            "wf.wig", "peaks.bed", "sub.wig", "smooth.wig", "pcc.txt",
            "nogap.bed", "wstats.txt", "train.txt", "val.txt", "test.txt",
            "rs.fa", "rs2.fa", "rs1.fa")}
        for fmt in ("axt", "vcf", "gg"):
            step(f"ggtools_chain_to_{fmt}", "gsw", "ggtools", chain, "-t",
                 t_fa, "-q", q_fa, "-f", fmt, "-o", f["c." + fmt])
        step("ggtools_vcf_to_gg", "gsw", "ggtools", f["c.vcf"], "-t", t_fa,
             "-o", f["v.gg"])
        step("ggtools_axt_to_vcf", "gsw", "ggtools", f["c.axt"], "-f", "vcf",
             "-o", f["a.vcf"])
        records, _ = vcfio.read(f["c.vcf"])
        called = {(v.chrom, v.pos, v.ref, v.alt[0]) for v in records}
        out["ggtools"] = {
            "vcf_records": len(records),
            "planted_snps_in_vcf": len(planted & called),
            "axt_vcf_records": len(vcfio.read(f["a.vcf"])[0])}

        names = tools_reads(f["g.fq"], queries, TOOLS_GRAPH_READS, 2201)
        with open(f["g.fq"]) as src, open(f["g400.fq"], "w") as dst:
            dst.writelines(src.readlines()[:4 * TOOLS_CPU_READS])
        wavefront.local_launches = wavefront.gsw_right_launches = 0
        gsw_dp.walk_launches = 0
        step("graph_align_card", "gsw", "align", f["v.gg"], f["g.fq"], "-o",
             f["g.giraf"], "--device", dev.type)
        launches = {"local_wavefront": wavefront.local_launches,
                    "gsw_right_wavefront": wavefront.gsw_right_launches,
                    "gsw_walk_pack": gsw_dp.walk_launches}
        step("graph_align_cpu", "gsw", "align", f["v.gg"], f["g400.fq"],
             "-o", f["g400.giraf"], "--device", "cpu")
        with open(f["g.giraf"]) as a, open(f["g400.giraf"]) as b:
            card, cpu = a.read().splitlines(), b.read().splitlines()
        mapped = sum(ln.split("\t")[5].split(":")[1] != ""
                     and int(ln.split("\t")[7]) >= 1200 for ln in card)
        out["graph"] = {
            "reads": len(names), "lines": len(card),
            "mapped_frac": mapped / len(names),
            "cpu_reads": TOOLS_CPU_READS,
            "card_equals_cpu": card[:TOOLS_CPU_READS] == cpu,
            "reads_per_s": len(names) / times["graph_align_card"]}

        n_reads = TOOLS_DEPTH * out["query_bp"] // L
        tools_reads(f["r.fq"], queries, n_reads, 2202)
        banded.fused_launches = 0
        step("linear_align_card", "gsw", "align", t_fa, f["r.fq"],
             "--engine", "tpu", "-o", f["aln.sam"], "--device", dev.type)
        launches["banded_align_fused"] = banded.fused_launches
        t = time.perf_counter()
        sam_mapped = sort_sam(f["aln.sam"], f["s.sam"])
        times["sort_sam"] = time.perf_counter() - t
        out["linear"] = {"reads": n_reads, "mapped_frac": sam_mapped / n_reads,
                         "reads_per_s": n_reads / times["linear_align_card"]}

        step("pileup", "pileup", f["s.sam"], "-o", f["pileup.txt"])
        os.mkdir(f["multi"])
        step("samConsensus", "samConsensus", f["s.sam"], t_fa,
             f["cons.fa"], "-multiFaDir", f["multi"])
        step("samToBed", "samToBed", f["s.sam"], f["aln.bed"])

        step("mergesort", "mergesort", f["aln.sam"], f["m.sam"],
             "-numRecordsPerChunk", str(TOOLS_SORT_CHUNK))
        step("bedMerge", "bedMerge", f["aln.bed"], f["merged.bed"])
        with open(f["t.sizes"], "w") as fh:
            fh.writelines(f"{c}\t{n}\n" for c, n in TOOLS_SIZES)
        step("bedToWig", "bedToWig", "Reads", f["aln.bed"], f["t.sizes"],
             f["reads.wig"])
        with open(f["snps.bed"], "w") as fh:
            fh.writelines(f"{c}\t{p - 1}\t{p}\n" for c in snps
                          for p, _, _ in snps[c])
        step("intervalOverlap", "intervalOverlap", f["merged.bed"],
             f["snps.bed"], f["hit.bed"])
        step("faFormat", "faFormat", t_fa, f["t60.fa"], "-lineLength", "60",
             "-toLower", f["snps.bed"], "-index")
        out["host_tools"] = host_tools_checks(f, t_fa)

        aln = [os.path.join(f["multi"], c + ".fa") for c in ("chr1", "chr2")]
        step("faFindFast", "faFindFast", aln[0], f["ff.bed"], "-chrom",
             "chr1", "-windowSize", str(TOOLS_WINDOW))
        step("faFindFast_long", "faFindFast", aln[0], f["ff_long.bed"],
             "-chrom", "chr1", "-windowSize", str(TOOLS_WINDOW),
             "-longOutput", "-divergenceRate", "0.01")
        step("assemblyStats", "assemblyStats", t_fa, f["stats.txt"])
        step("faInfo", "faInfo", t_fa, "-outFile", f["info.txt"])
        with open(f["snps_gc.bed"], "w") as fh:
            fh.writelines(f"{c}\t{p - 1 - TOOLS_GC_FLANK}\t"
                          f"{p + TOOLS_GC_FLANK}\n"
                          for c in snps for p, _, _ in snps[c])
        step("gcContent", "gcContent", f["snps_gc.bed"], t_fa, f["gc.bed"])
        step("faFilter", "faFilter", t_fa, f["big.fa"], "-minSize", "100000")
        os.mkdir(f["bins"])
        step("faBin", "faBin", t_fa, f["bins"], "-binNum", "2")
        step("catMultiFa", "catMultiFa", *aln, "-o", f["cat.fa"])
        target = fasta.read(t_fa)
        fasta.write(f["t2.fa"], target + [fasta.Fasta(r.name + "_copy", r.seq)
                                          for r in target])
        step("faUniq", "faUniq", f["t2.fa"], f["uniq.fa"])

        meta = seq_recon_inputs(f, t_fa, snps)
        step("digestGenome", "digestGenome", t_fa, "MboI", f["digest.bed"])
        step("bedToFasta", "bedToFasta", t_fa, f["snps_strand.bed"],
             f["snps_rc.fa"], "-revComp")
        step("bedToAminoAcid", "bedToAminoAcid", f["aa.bed"], t_fa,
             f["aa.txt"])
        step("faToPredictSet", "faToPredictSet", "--windowSize",
             str(TOOLS_PREDICT_WINDOW), "--stride", str(TOOLS_PREDICT_STRIDE),
             t_fa, f["predict.txt"])
        step("prcompFormat", "prcompFormat", aln[0], f["prcomp.txt"])
        step("findAndReplace", "findAndReplace", f["snps.bed"],
             f["rename.txt"], f["renamed.bed"], "-column", "0")
        step("reconstructSeq", "reconstructSeq", f["recon.nh"], f["recon.fa"],
             f["recon_out.fa"])
        step("reconstructSeq_subMatrix", "reconstructSeq", f["recon.nh"],
             f["recon.fa"], f["recon_sub.fa"], "-subMatrix",
             "-unitBranchLength", "0.1")
        step("primateRecon_hca", "primateRecon", "-mleHcaHumanBiased", "-mle",
             f["primates.nh"], f["primates.fa"], f["hca.fa"])
        step("primateRecon_hga", "primateRecon", "-mleHgaGorillaBiased",
             "-mle", f["primates.nh"], f["primates.fa"], f["hga.fa"])
        step("mouseRecon", "mouseRecon", "-mleTree", f["rodents.nh"],
             f["rodents.fa"], f["mra.fa"])

        step("vcfFilter", "vcfFilter", f["c.vcf"], f["snv.vcf"],
             "-substitutionsOnly", "-biAllelicOnly")
        step("vcfToFa", "vcfToFa", f["snv.vcf"], t_fa, f["alt.fa"],
             "-useAlt")
        fai.write_index(fai.create_index(t_fa), t_fa + ".fai")
        step("vcfInfo", "vcfInfo", "-i", f["snv.vcf"], "-types",
             f["types.txt"], "-context", f["context.txt"], "-r", t_fa)
        step("multiFaToVcf", "multiFaToVcf", aln[0], "chr1", f["multi.vcf"],
             "-substitutionsOnly")
        step("vcfFormat_csv", "vcfFormat", f["snv.vcf"], f["snv.csv"], "-csv",
             "-clearInfo")
        step("vcfFormat_ensembl", "vcfFormat", f["snv.vcf"], f["ens.vcf"],
             "-UCSCToEnsembl")
        step("bedFormat", "bedFormat", f["snps.bed"], f["snps_pad.bed"],
             "-UCSCToEnsembl", "-evenPadLength", "10", "-chromSizeFile",
             f["t.sizes"])

        bm = bed_multifa_inputs(f, t_fa, chain, snps, meta)
        step("bedFilter", "bedFilter", f["aln.bed"], f["filt.bed"],
             "-minLength", "100", "-chrom", "chr1")
        step("bedSplit", "bedSplit", "byChrom", f["aln.bed"], f["split"])
        step("bedShear", "bedShear", f["merged.bed"], f["shear.bed"],
             "-fragmentSize", "50")
        step("bedTrim", "bedTrim", "-trimPercent", "20", f["aln.bed"],
             f["trim.bed"])
        step("bedSimilarity", "bedSimilarity", f["merged.bed"], f["snps.bed"],
             f["sim.txt"])
        step("bedOverlapByWindow", "bedOverlapByWindow", f["merged.bed"],
             f["t.sizes"], f["win.bed"], "-windowSize", str(TOOLS_WINDOW))
        step("bedDistanceFromChrEnds", "bedDistanceFromChrEnds",
             f["snps.bed"], f["t.sizes"], f["dist.bed"])
        step("bedMinimumDistanceName", "bedMinimumDistanceName",
             f["snps_near.bed"], f["snps_strand.bed"], f["mind.bed"])
        step("bedMath", "bedMath", f["num.bed"], "add", f["num.bed"],
             f["math.bed"])
        step("bedValueWig", "bedValueWig", f["snps.bed"], f["reads.wig"],
             f["t.sizes"], f["val.bed"])
        step("bedGraphToWig", "bedGraphToWig", f["merged.bedGraph"],
             f["t.sizes"], f["bg.wig"])
        step("multiFaCount", "multiFaCount", "Query", aln[0], f["count.txt"])
        step("multiFaCount_both", "multiFaCount", "Query", aln[0],
             f["count_both.txt"], "-both", "-secondQueryName", "Target")
        step("multiFaScan", "multiFaScan", "--queryName", "Query", "--chrom",
             "chr1", f["chr1_n.fa"], f["scan.bed"])
        # multiFaExtract -bed writes into the working directory
        os.mkdir(f["extract"])
        cwd = os.getcwd()
        os.chdir(f["extract"])
        try:
            step("multiFaExtract", "multiFaExtract", aln[0], "-bed",
                 f["extract.bed"], "-removeGaps")
        finally:
            os.chdir(cwd)
        step("multiFaReduce", "multiFaReduce", aln[0], f["red.fa"],
             "-bedFilename", f["red.bed"], "-chrom", "chr1")
        step("multiFaSequenceSwap", "multiFaSequenceSwap", aln[0],
             f["snps.bed"], "Query", "Target", "chr1", f["swap.fa"])
        step("mergeMultiFa", "mergeMultiFa", aln[0], f["merge_b.fa"],
             f["merged.fa"])
        step("multiFaToChain", "multiFaToChain", f["pair.fa"], "chr1",
             "chr1q", f["pair.chain"])
        sw = sam_wig_steps(step, f, t_fa, snps, times)
        gorand_check = rand_seq_steps(step, f, times)
        pg = popgen_steps(step, tmp, times)
        il = interval_lift_steps(step, f, q_fa, chain, snps, tmp, times)
        vm = vcf_maf_axt_steps(step, f, t_fa, chain, snps, pg, tmp, times,
                               dev)
        ga = gtf_accel_steps(step, f, t_fa, chain, tmp, times)
        stt = sim_tree_steps(step, t_fa, tmp)
        se = sim_evol_steps(step, tmp)
        ost = onto_straw_steps(step, onto_straw_inputs(
            tmp, ga["genes"], ga["sizes"], ga["paths"]["genes.gtf"]))
        gp = giraf_pfa_steps(step, giraf_pfa_inputs(
            tmp, f["g.giraf"], f["v.gg"], t_fa, f["c.vcf"], aln[0]))
        sv = sim_views_steps(step, sim_views_inputs(
            tmp, f["v.gg"], t_fa, q_fa, aln[0], snps), dev, times)
        for k, v in sv["launches"].items():
            launches[k] = launches.get(k, 0) + v

        rows = {}
        with open(f["pileup.txt"]) as fh:
            for line in fh:
                if not line.startswith("#"):
                    c, p, a, cc, g, tt = line.split("\t")[:6]
                    rows.setdefault(c, []).append(
                        (int(p), int(a) + int(cc) + int(g) + int(tt)))
        covered = covered_positions(f["s.sam"])
        rows_equal = (set(rows) == set(covered) and all(
            np.array_equal([p for p, _ in rows[c]], covered[c])
            for c in covered))
        depth = {(c, p): d for c in rows for p, d in rows[c]}
        # a target position's column in the multiFa alignment is the
        # position-th non-gap column of its target record
        carried = covered_snps = 0
        for c, pos_snps in snps.items():
            path = os.path.join(f["multi"], c + ".fa")
            if not os.path.exists(path):
                continue
            target, query = fasta.read(path)
            cols = np.flatnonzero(target.seq != dna.GAP)
            for p, _, alt in pos_snps:
                if depth.get((c, p), 0) == 0:
                    continue
                covered_snps += 1
                base = dna.to_string(dna.to_upper(query.seq[cols[p - 1]:
                                                            cols[p - 1] + 1]))
                carried += base == alt
        with open(f["aln.bed"]) as fh:
            bed_lines = sum(1 for _ in fh)
        out["consensus"] = {
            "pileup_rows": sum(len(v) for v in rows.values()),
            "pileup_rows_equal_covered": rows_equal,
            "covered_planted_snps": covered_snps,
            "carried_frac": carried / max(covered_snps, 1),
            "bed_lines": bed_lines, "mapped_reads": sam_mapped,
            "consensus_records": [r.name for r in fasta.read(f["cons.fa"])]}
        out["fasta_tools"] = fasta_tools_checks(f, t_fa, snps, depth)
        out["seq_recon_tools"] = seq_recon_checks(f, t_fa, meta)
        out["vcf_tools"] = vcf_tools_checks(f, t_fa, snps, depth)
        out["bed_multifa_tools"] = bed_multifa_checks(f, t_fa, snps, meta, bm)
        out["sam_wig_tools"] = sam_wig_checks(f, t_fa, sw)
        out["rand_seq"] = {**rand_seq_checks(f), "gorand": gorand_check}
        out["popgen_tools"] = popgen_checks(pg)
        out["interval_lift_tools"] = interval_lift_checks(il)
        out["vcf_maf_axt_tools"] = vcf_maf_axt_checks(vm)
        out["gtf_accel_tools"] = gtf_accel_checks(ga)
        out["sim_tree_tools"] = sim_tree_checks(stt)
        out["sim_evol_tools"] = sim_evol_checks(se)
        out["onto_straw_tools"] = onto_straw_checks(ost)
        out["giraf_pfa_tools"] = giraf_pfa_checks(gp)
        out["sim_views_tools"] = sim_views_checks(sv)
    out["times_s"] = times
    out["launches"] = launches
    emit(out)
    g, c, h = out["graph"], out["consensus"], out["host_tools"]
    ft = out["fasta_tools"]
    ff, stats = ft["fa_find_fast"], ft["assembly_stats"]
    fasta_ok = (ff["windows"] == ff["first_query_bases"] - TOOLS_WINDOW + 1
                and ff["widths_equal_window"] and ff["clean_windows"] > 0
                and ff["clean_muts_equal_differing"]
                and ff["snp_windows"] > 0 and ff["snp_windows_muts_min"] >= 1
                and ff["long_first_five_equal_short"]
                and stats["tool"] == stats["numpy"]
                and stats["numpy"] == [max(n for _, n in TOOLS_SIZES), 1,
                                       len(TOOLS_SIZES),
                                       sum(n for _, n in TOOLS_SIZES)]
                and ft["fa_info_counts_equal"]
                and ft["gc_content"]["lines"] == len(planted)
                and ft["gc_content"]["values_equal_numpy"]
                and ft["fa_filter_keeps_chr1"]
                and ft["fa_bin"]["each_record_once"]
                and ft["fa_bin"]["files"] == len(TOOLS_SIZES)
                and ft["fa_bin"]["a_file_a_record_named_after_it"]
                and ft["cat_multi_fa_rows_joined"]
                and ft["fa_uniq_one_a_sequence"])
    sr = out["seq_recon_tools"]
    dg = sr["digest_genome"]
    recon_ok = all(
        r["leaves_equal_input"] and r["agreed_columns"] > 0
        and len(r["names"]) == r["leaves"] + len(r["nodes"])
        and all(v["length_equal"] and v["agreed_base_kept"]
                and v["all_gap_kept"] for v in r["nodes"].values())
        for r in (sr["reconstruct_seq"], sr["reconstruct_seq_sub_matrix"],
                  sr["primate_recon_hca"], sr["primate_recon_hga"],
                  sr["mouse_recon"]))
    seq_ok = (recon_ok and sr["reconstruct_seq"]["all_gap_columns"] >= 75
              and dg["fragments"] > 0 and dg["cut_ends_equal_numpy"]
              and dg["tiles_each_record"] and dg["names_and_strands"]
              and sr["bed_to_fasta"]["records"] == len(planted)
              and sr["bed_to_fasta"]["equal_numpy"]
              and sr["bed_to_amino_acid"]["lines"] > 0
              and sr["bed_to_amino_acid"]["equal_numpy"]
              and sr["fa_to_predict_set"]["lines"]
              == sr["fa_to_predict_set"]["numpy_count"] > 0
              and sr["fa_to_predict_set"]["windows_equal"]
              and sr["prcomp_format"]["variable_columns"] > 0
              and sr["prcomp_format"]["equal_numpy"]
              and sr["find_and_replace_equal"])
    vt = out["vcf_tools"]
    mv, vf = vt["multi_fa_to_vcf"], vt["vcf_format"]
    vcf_ok = (vt["vcf_filter"]["records"] == len(planted)
              and vt["vcf_filter"]["equal_planted"]
              and vt["vcf_to_fa_equal_numpy"]
              and vt["vcf_info"]["types_equal_numpy"]
              and vt["vcf_info"]["context_equal_numpy"]
              and vt["vcf_info"]["context_sum"] == len(planted)
              and mv["carried_snps"] > 0
              and mv["carried_with_record"] == mv["carried_snps"]
              and mv["refs_equal_target"] and mv["substitutions_only"]
              and vf["csv_lines"] == len(planted) + 1
              and vf["csv_rows_equal_records"]
              and vf["ensembl_chroms"] == ["1", "2"]
              and vf["ensembl_rest_equal"]
              and vt["bed_format"]["lines"] == len(planted)
              and vt["bed_format"]["equal_numpy"])
    bmt = out["bed_multifa_tools"]
    bed_multifa_ok = (all(v["equal_numpy"] and v["lines"] > 0
                          for v in bmt.values())
                      and bmt["multi_fa_scan"]["lines"]
                      == len(snps["chr1"])
                      and bmt["bed_distance_from_chr_ends"]["lines"]
                      == len(planted))
    swt = out["sam_wig_tools"]
    sam_wig_ok = (all(v["equal_numpy"] and v["lines"] > 0
                      for v in swt.values())
                  and swt["fastq_replace_seq"]["replaced"] >= len(sw["pairs"])
                  and swt["bed_count_bam"]["reads"] > 0
                  and swt["bam_tag_to_read_group"]["grouped"] > 0)
    rs, go = out["rand_seq"], out["rand_seq"]["gorand"]
    rand_ok = (rs["names_equal"] and rs["lengths"] == [RAND_LEN]
               and rs["line_widths"] == [50] and rs["acgt_only"]
               and abs(rs["gc_share"] - RAND_GC) <= RAND_GC_TOL
               and rs["g_minus_c_share"] < RAND_GC_TOL
               and rs["a_minus_t_share"] < RAND_GC_TOL
               and rs["two_equal_head"] and rs["seed1_equal_go"]
               and go["seed1_int63_equal_go"] and go["seed1_intn100_equal_go"]
               and go["cooked_equal_rebuilt"])
    host_ok = (h["mergesort_mapped_equal_sorted"]
               and h["mergesort_header_equal_input"]
               and h["merged_bases"] == c["pileup_rows"]
               and h["wig_covered"] == c["pileup_rows"]
               and h["wig_sum"] == h["bed_bases"]
               and h["overlap_lines"] == c["covered_planted_snps"]
               and h["fa_lower_bases"] == len(planted)
               and h["fa_upper_equals_target"] and h["fai_equals_index"])
    if not (host_ok and fasta_ok and seq_ok and vcf_ok and bed_multifa_ok
            and sam_wig_ok and rand_ok and popgen_ok(out["popgen_tools"])
            and interval_lift_ok(out["interval_lift_tools"])
            and vcf_maf_axt_ok(out["vcf_maf_axt_tools"])
            and gtf_accel_ok(out["gtf_accel_tools"])
            and sim_tree_ok(out["sim_tree_tools"])
            and sim_evol_ok(out["sim_evol_tools"])
            and onto_straw_ok(out["onto_straw_tools"])
            and giraf_pfa_ok(out["giraf_pfa_tools"])
            and sim_views_ok(out["sim_views_tools"])
            and out["ggtools"]["planted_snps_in_vcf"] == len(planted)
            and g["mapped_frac"] >= 0.99 and g["card_equals_cpu"]
            and c["covered_planted_snps"] > 0.9 * len(planted)
            and c["carried_frac"] >= 0.99 and c["pileup_rows_equal_covered"]
            and c["bed_lines"] == sam_mapped
            and all(v > 0 for v in launches.values())):
        raise SystemExit("tools_cli check failed")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    info = phase_device()
    rows = phase_kernels(dev)
    e2e, long_batch, huge_batch = phase_end_to_end(dev, 100_000_000)
    rows += phase_long_read_kernels(dev, long_batch)
    phase_huge_read(dev, huge_batch)
    del long_batch, huge_batch
    phase_cli(dev, CLI_BP)
    mesh = phase_mesh(dev, CLI_BP)
    walk_row, k4_mesh = phase_mesh_kernels(dev, mesh.pop("inputs"))
    rows.append(walk_row)
    rows += phase_pairwise_kernels(dev)
    pairwise = phase_pairwise(dev)
    phase_pairwise_cli()
    graph, waves = phase_graph(dev)
    rows += phase_graph_kernels(dev, waves, graph["dims"])
    del waves
    phase_graph_cli(dev)
    rows += phase_lowmem_kernels(dev)
    lowmem = phase_lowmem(dev)
    rows += phase_score_kernels(dev)
    score = phase_score(dev)
    prefix = phase_prefix(dev, 100_000_000)
    multihost = phase_multihost(dev, CLI_BP)
    phase_variants(dev)
    phase_motif_popgen(dev)
    seq_par, strip = phase_seq_parallel(dev, lowmem)
    rows.append(strip)
    tools = phase_tools_cli(dev)
    launches = {**e2e["launches"], **pairwise["launches"],
                **graph["launches"], **lowmem["launches"],
                **score["launches"],
                "local_walk_pack": mesh["launches"]["local_walk_pack"],
                "affine_fwd_strip": seq_par["launches"]["affine_fwd_strip"]}
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] in ("local_wavefront", "local_walk_pack"):
            # the mesh path's kernels on the prefix and multihost paths
            r["prefix_launches"] = prefix["launches"][r["name"]]
            r["multihost_launches"] = sum(
                c[r["name"]] for run in ("replicated", "prefix")
                for c in multihost[run]["launches"])
        if r["name"] == "local_wavefront":  # K4 on the mesh path too
            r["mesh_launches"] = mesh["launches"]["local_wavefront"]
            r["mesh_path"] = {k: k4_mesh[k] for k in (
                "shape", "ms", "graph_ms", "plain_ms", "bound_ms",
                "bound_by", "equal_to_plain")}
        if r["name"] in ("affine_bwd_window", "lowmem_walk_block"):
            # the sequence-sharded aligner's backward runs them too
            r["seq_parallel_launches"] = seq_par["launches"][r["name"]]
        if r.get("kernel") == "trace_diag":
            r["trace_diag_launches"] = launches["trace_diag"]
        if r["name"] in tools["launches"]:
            r["tools_launches"] = tools["launches"][r["name"]]
    emit({"phase": "done", "total_s": time.perf_counter() - t0})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
