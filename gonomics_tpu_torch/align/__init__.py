"""Pairwise alignment: the exports of ``gonomics_tpu/align/__init__.py``."""

from .cigar import COL_D, COL_I, COL_M, Cigar, go_format, print_cigar, view
from .matrices import (BY_NAME, DEFAULT, HOXD55, HUMAN_CHIMP_TWO, MOUSE_RAT)
from .pairwise import (affine_gap, affine_gap_batch, affine_gap_lowmem,
                       const_gap, const_gap_batch)

__all__ = [
    "COL_D", "COL_I", "COL_M", "Cigar", "go_format", "print_cigar", "view",
    "BY_NAME", "DEFAULT", "HOXD55", "HUMAN_CHIMP_TWO", "MOUSE_RAT",
    "affine_gap", "affine_gap_batch", "affine_gap_lowmem", "const_gap",
    "const_gap_batch",
]
