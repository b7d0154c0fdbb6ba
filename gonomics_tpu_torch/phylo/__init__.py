"""Phylogenetics: newick trees carrying sequences, and the Felsenstein
ancestral reconstruction (the part of ``gonomics_tpu/phylo/`` that
reconstructSeq, primateRecon and mouseRecon use)."""
