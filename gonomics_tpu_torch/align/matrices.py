"""Score matrices for pairwise DNA alignment: a copy of
``gonomics_tpu/align/matrices.py``.

Values of the published substitution matrices in gonomics'
``align/align.go:28-64``. Matrices are 5x5 over the A, C, G, T, N code
space (``dna`` codes 0..4).
"""

from __future__ import annotations

import numpy as np

VERY_NEG_INT32 = -(2 ** 30)  # plays the role of veryNegNum (align.go:8)

DEFAULT = np.array(
    [
        [91, -114, -31, -123, -44],
        [-114, 100, -125, -31, -43],
        [-31, -125, 100, -114, -43],
        [-123, -31, -114, 91, -44],
        [-44, -43, -43, -44, -43],
    ],
    dtype=np.int32,
)

HOXD55 = np.array(
    [
        [91, -114, -31, -123, 0],
        [-114, 100, -125, -31, 0],
        [-31, -125, 100, -114, 0],
        [-123, -31, -114, 91, 0],
        [0, 0, 0, 0, 0],
    ],
    dtype=np.int32,
)

MOUSE_RAT = HOXD55.copy()  # align.go:40-55: same values, different gap params

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

BY_NAME = {
    "default": DEFAULT,
    "defaultScoreMatrix": DEFAULT,
    "hoxD55": HOXD55,
    "hoxD55ScoreMatrix": HOXD55,
    "mouseRat": MOUSE_RAT,
    "mouseRatScoreMatrix": MOUSE_RAT,
    "humanChimpTwo": HUMAN_CHIMP_TWO,
    "humanChimpTwoScoreMatrix": HUMAN_CHIMP_TWO,
}
