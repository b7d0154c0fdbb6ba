"""Pile consensus calling: the whole of ``gonomics_tpu/consensus.py`` on
the port's ``pileup.Pile``.

The base majority over A/C/G/T; then deletions compete with the best
base; then an insertion is called where its count exceeds
insertion_threshold x (base + deletion depth) or beats the current
deletion or insertion. Where two alleles tie, the first in sorted order
wins (the reference draws one at random; its own goldens have no such
tie).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import dna
from .pileup import Pile

BASE, INSERTION, DELETION, UNDEFINED = 0, 1, 2, 3


@dataclass
class Consensus:
    base: int = 0
    insertion: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    deletion: int = 0
    type: int = UNDEFINED


def _get_deletion_counts(p: Pile) -> int:
    return sum(p.del_count_f.values()) + sum(p.del_count_r.values())


def pile_consensus(p: Pile, substitutions_only: bool,
                   insertion_threshold: float) -> Consensus:
    best = Consensus(base=dna.A, type=BASE)
    max_count = int(p.count_f[dna.A] + p.count_r[dna.A])
    for b in (dna.C, dna.G, dna.T):
        count = int(p.count_f[b] + p.count_r[b])
        if count > max_count:
            best = Consensus(base=b, type=BASE)
            max_count = count

    if substitutions_only:
        if max_count < 1:
            return Consensus(type=UNDEFINED)
        return best

    # deletions compete with the max base (getMaxDeletion)
    del_keys = sorted(set(p.del_count_f) | set(p.del_count_r))
    for k in del_keys:
        count = p.del_count_f.get(k, 0) + p.del_count_r.get(k, 0)
        if count > max_count:
            best = Consensus(deletion=k, type=DELETION)
            max_count = count
    if max_count < 1:
        return Consensus(type=UNDEFINED)

    # insertions (getMaxInsertion)
    deletion_sum = _get_deletion_counts(p)
    total_base_counts = int(p.count_f[:4].sum() + p.count_r[:4].sum()
                            + deletion_sum)
    threshold = int(insertion_threshold * total_base_counts)
    max_ins_score = 0
    ins_keys = sorted(set(p.ins_count_f) | set(p.ins_count_r))
    for key in ins_keys:
        count = p.ins_count_f.get(key, 0) + p.ins_count_r.get(key, 0)
        if best.type == BASE:
            if count > threshold:
                best = Consensus(base=best.base, type=INSERTION,
                                 insertion=dna.from_string(key))
                max_ins_score = count
        elif best.type == DELETION:
            del_score = (p.del_count_f.get(best.deletion, 0)
                         + p.del_count_r.get(best.deletion, 0))
            if count > del_score:
                best = Consensus(base=best.base, type=INSERTION,
                                 insertion=dna.from_string(key))
                max_ins_score = count
        else:  # INSERTION
            if count > max_ins_score:
                best = Consensus(base=best.base, type=INSERTION,
                                 insertion=dna.from_string(key))
                max_ins_score = count
    return best
