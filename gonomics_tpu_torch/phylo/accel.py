"""Four-way branch lengths by alternating least squares over a
(hum, chimp, gor, orang) alignment; a copy of
``gonomics_tpu/phylo/accel.py`` (282 lines, whole), gonomics'
``phylo/{acceleration,searchSpace}.go``.

The hca and hga internal nodes and the Fitch-Margoliash weighted least
squares follow the reference: ``calculate_q``'s first term is
``d[0] - 2 * chimp_hca``; ``_optimize_triple``'s left and right forms
update the two remaining branches in opposite orders in two of the
negative cases; the fit reverts to the last lengths and stops where Q
rises, and exits after 100,000 rounds. A distance of 0 weighs
``zero_constant``, and ``cavalli`` sets every weight to 1. The mutation
distance counts an indel run once. All of it is numpy on the host."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna
from ..io import bed as bedio

_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
# index into the distances vector: humChimp, humGor, humOrang, chimpGor,
# chimpOrang, gorOrang


@dataclass
class Distances:
    """AccelDistancesAndWeights (acceleration.go:12): d[6] and w[6]."""

    d: np.ndarray
    w: np.ndarray


@dataclass
class BranchLengths:
    """AccelBranchLengths (acceleration.go:27)."""

    hum_hca: float = 1.0
    chimp_hca: float = 1.0
    hca_hga: float = 1.0
    hga_gor: float = 1.0
    hga_orang: float = 1.0


def _weight(d: float, zero_constant: float, cavalli: bool) -> float:
    if cavalli:
        return 1.0
    if d == 0:
        return zero_constant
    return 1.0 / (d * d)


def _is_ungapped(b: int) -> bool:
    return (0 <= b <= dna.T) or (dna.LOWER_A <= b <= dna.LOWER_T)


def is_ungapped_column(mat: np.ndarray, i: int) -> bool:
    """phylo.IsUngappedColumn (acceleration.go:176)."""
    col = mat[:, i]
    return bool((((col >= 0) & (col <= dna.T))
                 | ((col >= dna.LOWER_A)
                    & (col <= dna.LOWER_T))).all())


def four_way_snp_distances(records, aln_counter: int, window_size: int,
                           zero_constant: float, cavalli: bool):
    """phylo.AccelFourWaySnpDistancesAndWeights (acceleration.go:94)."""
    if len(records) != 4:
        raise SystemExit("multiFaAcceleration must take in a four-way "
                         "multiple alignment.")
    mat = np.stack([np.asarray(r.seq) for r in records])
    d = np.zeros(6)
    base_count = 0
    i = aln_counter
    while base_count < window_size and i < mat.shape[1]:
        if mat[0, i] != dna.GAP:
            base_count += 1
        if is_ungapped_column(mat, i):
            for k, (a, b) in enumerate(_PAIRS):
                if mat[a, i] != mat[b, i]:
                    d[k] += 1
        i += 1
    reached_end = base_count != window_size
    w = np.array([_weight(x, zero_constant, cavalli) for x in d])
    return Distances(d, w), reached_end


def pairwise_mutation_distance_window(seq1, seq2, aln_start: int,
                                      window_size: int):
    """fasta.PairwiseMutationDistanceReferenceWindow (multiFa.go:268)."""
    diff = base_count = 0
    s1_indel = s2_indel = False
    a, b = np.asarray(seq1), np.asarray(seq2)
    i = aln_start
    while base_count < window_size and i < len(a):
        if a[i] == b[i]:
            if a[i] != dna.GAP:
                s1_indel = s2_indel = False
                base_count += 1
        elif a[i] == dna.GAP:
            s2_indel = False
            if not s1_indel:
                s1_indel = True
                diff += 1
        elif b[i] == dna.GAP:
            base_count += 1
            s1_indel = False
            if not s2_indel:
                s2_indel = True
                diff += 1
        else:
            s1_indel = s2_indel = False
            base_count += 1
            diff += 1
        i += 1
    return diff, base_count != window_size, i


def pairwise_mutation_distance_range(seq1, seq2, aln_start: int,
                                     aln_end: int) -> int:
    """fasta.PairwiseMutationDistanceInRange (multiFa.go:313)."""
    diff = 0
    s1_indel = s2_indel = False
    a, b = np.asarray(seq1), np.asarray(seq2)
    if aln_end >= len(a) + 1:
        raise SystemExit("alnEnd must be less than the sequence length")
    for i in range(aln_start, aln_end):
        if a[i] == b[i]:
            if a[i] != dna.GAP:
                s1_indel = s2_indel = False
        elif a[i] == dna.GAP:
            s2_indel = False
            if not s1_indel:
                s1_indel = True
                diff += 1
        elif b[i] == dna.GAP:
            s1_indel = False
            if not s2_indel:
                s2_indel = True
                diff += 1
        else:
            s1_indel = s2_indel = False
            diff += 1
    return diff


def four_way_mutation_distances(records, aln_counter: int,
                                window_size: int, zero_constant: float,
                                cavalli: bool):
    """phylo.AccelFourWayMutationDistancesAndWeights
    (acceleration.go:133)."""
    d = np.zeros(6)
    d01, reached_end, aln_end = pairwise_mutation_distance_window(
        records[0].seq, records[1].seq, aln_counter, window_size)
    d[0] = d01
    for k, (a, b) in enumerate(_PAIRS[1:], start=1):
        d[k] = pairwise_mutation_distance_range(
            records[a].seq, records[b].seq, aln_counter, aln_end)
    w = np.array([_weight(x, zero_constant, cavalli) for x in d])
    return Distances(d, w), reached_end


def calculate_q(dist: Distances, b: BranchLengths) -> float:
    """phylo.CalculateQ (acceleration.go:334): the first term doubles
    BchimpHca, matching the reference verbatim."""
    d, w = dist.d, dist.w
    total = w[0] * (d[0] - (b.chimp_hca + b.chimp_hca)) ** 2
    total += w[1] * (d[1] - (b.hum_hca + b.hca_hga + b.hga_gor)) ** 2
    total += w[2] * (d[2] - (b.hum_hca + b.hca_hga + b.hga_orang)) ** 2
    total += w[3] * (d[3] - (b.chimp_hca + b.hca_hga + b.hga_gor)) ** 2
    total += w[4] * (d[4] - (b.chimp_hca + b.hca_hga + b.hga_orang)) ** 2
    total += w[5] * (d[5] - (b.hga_gor + b.hga_orang)) ** 2
    return float(total)


def _non_negative(d1, d2, v1, v2, w1, w2) -> float:
    return max((w1 * (d1 - v1) + w2 * (d2 - v2)) / (w1 + w2), 0.0)


def _optimize_triple(d_ab, d_ac, d_bc, w_ab, w_ac, w_bc,
                     allow_negative: bool, right: bool):
    """optimizeSubtreeLeft/Right (acceleration.go:231,280): returns
    (v_a, v_b, v_c) for the 3-leaf star with distances d_ab (a-b),
    d_ac (a-c), d_bc (b-c). The left and right variants update the
    remaining two branches in OPPOSITE orders in two of the negative
    cases, matching the reference verbatim."""
    v_a = (d_ab + d_ac - d_bc) / 2.0
    v_b = (d_ab + d_bc - d_ac) / 2.0
    v_c = (d_ac + d_bc - d_ab) / 2.0
    if allow_negative:
        return v_a, v_b, v_c
    if v_a < 0 and v_b < 0 and v_c < 0:
        return 0.0, 0.0, 0.0
    if v_a < 0:
        v_a = 0.0
        if v_b < 0:
            v_b = 0.0
            v_c = _non_negative(d_ac, d_bc, v_a, v_b, w_ac, w_bc)
        elif v_c < 0:
            v_c = 0.0
            v_b = _non_negative(d_ab, d_bc, v_a, v_c, w_ab, w_bc)
        else:
            v_c = _non_negative(d_ac, d_bc, v_a, v_b, w_ac, w_bc)
            v_b = _non_negative(d_ab, d_bc, v_a, v_c, w_ab, w_bc)
    elif v_b < 0:
        v_b = 0.0
        if v_c < 0:
            v_c = 0.0
            v_a = _non_negative(d_ac, d_ab, v_c, v_b, w_ac, w_ab)
        elif right:
            v_c = _non_negative(d_ac, d_bc, v_a, v_b, w_ac, w_bc)
            v_a = _non_negative(d_ab, d_ac, v_b, v_c, w_ab, w_ac)
        else:
            v_a = _non_negative(d_ac, d_ab, v_c, v_b, w_ac, w_ab)
            v_c = _non_negative(d_ac, d_bc, v_a, v_b, w_ac, w_bc)
    elif v_c < 0:
        v_c = 0.0
        if right:
            v_b = _non_negative(d_ab, d_bc, v_a, v_c, w_ab, w_bc)
            v_a = _non_negative(d_ab, d_ac, v_b, v_c, w_ab, w_ac)
        else:
            v_a = _non_negative(d_ac, d_ab, v_c, v_b, w_ac, w_ab)
            v_b = _non_negative(d_ab, d_bc, v_a, v_c, w_ab, w_bc)
    return v_a, v_b, v_c


def branch_lengths_alternating_least_squares(
        dist: Distances, allow_negative: bool = False,
        zero_constant: float = 1000.0, epsilon: float = 1e-8,
        cavalli: bool = False) -> BranchLengths:
    """phylo.BranchLengthsAlternatingLeastSquares
    (acceleration.go:58)."""
    d, w = dist.d, dist.w
    answer = BranchLengths()
    q = calculate_q(dist, answer)
    curr_diff = epsilon + 1
    i = 0
    while curr_diff > epsilon and i < 100000:
        old = BranchLengths(answer.hum_hca, answer.chimp_hca,
                            answer.hca_hga, answer.hga_gor,
                            answer.hga_orang)
        # pruneLeft (acceleration.go:209)
        d_hum_hga = (w[1] * (d[1] - answer.hga_gor)
                     + w[2] * (d[2] - answer.hga_orang)) / (w[1] + w[2])
        d_chimp_hga = (w[3] * (d[3] - answer.hga_gor)
                       + w[4] * (d[4] - answer.hga_orang)) / (w[3] + w[4])
        w_hum_chimp = _weight(d[0], zero_constant, cavalli)
        w_hum_hga = _weight(d_hum_hga, zero_constant, cavalli)
        w_chimp_hga = _weight(d_chimp_hga, zero_constant, cavalli)
        answer.hum_hca, answer.chimp_hca, answer.hca_hga = \
            _optimize_triple(d[0], d_hum_hga, d_chimp_hga, w_hum_chimp,
                             w_hum_hga, w_chimp_hga, allow_negative,
                             right=False)
        # pruneRight (acceleration.go:219)
        d_hca_gor = (w[1] * (d[1] - answer.hum_hca)
                     + w[3] * (d[3] - answer.chimp_hca)) / (w[1] + w[3])
        d_hca_orang = (w[2] * (d[2] - answer.hum_hca)
                       + w[4] * (d[4] - answer.chimp_hca)) / (w[2] + w[4])
        w_gor_orang = _weight(d[5], zero_constant, cavalli)
        w_hca_gor = _weight(d_hca_gor, zero_constant, cavalli)
        w_hca_orang = _weight(d_hca_orang, zero_constant, cavalli)
        answer.hca_hga, answer.hga_gor, answer.hga_orang = \
            _optimize_triple(d_hca_gor, d_hca_orang, d[5], w_hca_gor,
                             w_hca_orang, w_gor_orang, allow_negative,
                             right=True)
        next_q = calculate_q(dist, answer)
        curr_diff = abs(q - next_q)
        if next_q > q:
            answer = old
            curr_diff = 0
        q = next_q
        i += 1
    if i >= 100000:
        raise SystemExit("Failed to converge on a tree with these "
                         "distances.")
    return answer


def make_bit_array_from_search_space(search_space_file: str,
                                     reference_length: int,
                                     chrom: str) -> np.ndarray:
    """phylo.MakeBitArrayFromSearchSpaceBed (searchSpace.go:8)."""
    bits = np.zeros(reference_length, dtype=bool)
    for b in bedio.read(search_space_file):
        if b.chrom == chrom:
            bits[b.chrom_start:b.chrom_end] = True
    return bits
