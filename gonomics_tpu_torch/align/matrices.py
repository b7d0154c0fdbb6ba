"""Substitution matrices over the A, C, G, T, N codes 0..4: the subset
of ``gonomics_tpu/align/matrices.py`` that the read aligner uses."""

from __future__ import annotations

import numpy as np

# the same values as gonomics_tpu/gsw.py:35, the read aligner's default
HUMAN_CHIMP_TWO = np.array(
    [
        [90, -330, -236, -356, -208],
        [-330, 100, -318, -236, -196],
        [-236, -318, 100, -330, -196],
        [-356, -236, -330, 90, -208],
        [-208, -196, -196, -208, -202],
    ],
    dtype=np.int32,
)
