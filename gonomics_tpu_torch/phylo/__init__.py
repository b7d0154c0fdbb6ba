"""Phylogenetics: newick trees carrying sequences, the Felsenstein
ancestral reconstruction and the four-way branch-length fit (the part of
``gonomics_tpu/phylo/`` that reconstructSeq, primateRecon, mouseRecon,
multiFaAcceleration and branchLengthsMultiFaBed use)."""
