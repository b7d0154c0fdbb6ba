"""Fractional powers of symmetric matrices, the part of
``gonomics_tpu/numbers/matrix.py`` that ``phylo.etree``'s substitution
matrices use (``is_symmetric``, ``dense_log_symmetric``,
``_expm_symmetric`` and ``fractional_symmetric_matrix_exponentiation``,
:14-44), gonomics' ``numbers/matrix/matrix.go``.

The eigendecomposition is ``np.linalg.eig``, as in the JAX package, and
not ``eigh``: the two round differently, and reconstructSeq's calls
follow the last bits of these matrices.
"""

from __future__ import annotations

import numpy as np


def is_symmetric(m: np.ndarray) -> bool:
    m = np.asarray(m)
    return m.ndim == 2 and m.shape[0] == m.shape[1] \
        and bool((m == m.T).all())


def dense_log_symmetric(m: np.ndarray) -> np.ndarray:
    """matrix.DenseLogSymmetric (matrix.go:30): log(A) = V log(D) V^-1
    with imaginary parts discarded (real for symmetric input)."""
    m = np.asarray(m, np.float64)
    if not is_symmetric(m):
        raise ValueError("DenseLogSymmetric supports only symmetric input")
    vals, vecs = np.linalg.eig(m)
    vals = np.log(vals.real)
    vecs = vecs.real
    return vecs @ np.diag(vals) @ np.linalg.inv(vecs)


def _expm_symmetric(m: np.ndarray) -> np.ndarray:
    """exp(M) for matrices with a real eigendecomposition."""
    vals, vecs = np.linalg.eig(np.asarray(m, np.float64))
    vals = np.exp(vals.real)
    vecs = vecs.real
    return vecs @ np.diag(vals) @ np.linalg.inv(vecs)


def fractional_symmetric_matrix_exponentiation(m: np.ndarray,
                                               power: float) -> np.ndarray:
    """matrix.FractionalSymmetricMatrixExponentiation (matrix.go:16):
    A^t = exp(t * log(A)) for symmetric A and fractional t."""
    return _expm_symmetric(power * dense_log_symmetric(m))
