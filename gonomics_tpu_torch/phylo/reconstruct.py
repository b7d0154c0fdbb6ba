"""Felsenstein ancestral sequence reconstruction over all alignment
columns at once, with its accuracy scores and the ILS-weighted average:
a copy of ``gonomics_tpu/phylo/reconstruct.py`` (375 lines), gonomics'
``reconstruct`` package (reconstruct.go, accuracy.go,
ilsReconstruct.go). ``inside`` and ``fix_fc`` are the JAX's ``_inside``
and ``_fix_fc`` under the public names it aliases them to (:374-375).
``reconstruct_tree`` leaves out the JAX's ``pdna_node_multi``, which no
tool of the port sets (ROADMAP item 14), and returns only the
``pdna_node`` record. ``recon_accuracy``, ``recon_accuracy_by_base``
and ``ils_reconstruct_seq`` (:239-372) are simRecon's and
ilsReconstructSeq's.

The reference walks the tree once a (column, internal node, state):
FixFc runs bubbleUp again for each of the 4 states of every internal
node. Here each walk takes every column at once, as (P, 4) float64
arrays:

    inside[node]  = sum over (l, r) of M_L[n, l] * inside[L][l]
                    * M_R[n, r] * inside[R][r]
    fix[node][s]  = bubbleUp of inside[node] one-hot at s, to the root

The sums keep the reference's double (l, r) loop and its left-associated
multiplies, so an exact likelihood tie, which the base caller breaks by
its first maximum, breaks on the same base as in the JAX package. A
matrix product in their place rounds differently and moves such ties.

Base calling (LikelihoodsToBase) and the gap/base-present logic
(BaseExistsAtNodes) follow the reference, NaN comparisons for a total
of zero included.
"""

from __future__ import annotations

import numpy as np

from .. import dna
from ..io import fasta as fastaio
from ..io.pfasta import PFasta
from .etree import ETree, find_node, get_branch, get_leaves


def branch_matrix(node: ETree, sub_matrix: bool) -> np.ndarray:
    """P(parent state -> node state): mutationProbability
    (reconstruct.go:37) or the node's substitution matrix."""
    if sub_matrix:
        return np.asarray(node.substitution_matrix, np.float64)
    t = node.branch_length
    m = np.full((4, 4), t / 3, np.float64)
    np.fill_diagonal(m, 1 - t)
    return m


def _leaf_stored(seq: np.ndarray, P: int) -> np.ndarray:
    """SetState leaf case: one-hot, N/Gap -> 0.25 everywhere."""
    stored = np.zeros((P, 4), np.float64)
    s = np.asarray(seq[:P], np.int64)
    amb = (s == dna.N) | (s == dna.GAP)
    ok = ~amb & (s < 4)
    stored[np.arange(P)[ok], s[ok]] = 1.0
    stored[amb] = 0.25
    return stored


def inside(node: ETree, P: int, sub: bool, store: dict) -> np.ndarray:
    """SetState (reconstruct.go:108) vectorized over positions, preserving
    the reference's exact accumulation order — the double (l, r) loop with
    left-associated multiplies — so exact likelihood TIES (which the base
    caller breaks by first-max) resolve identically at the ulp level."""
    if node.left is None and node.right is None:
        res = _leaf_stored(node.fasta.seq, P)
    else:
        li = inside(node.left, P, sub, store)
        ri = inside(node.right, P, sub, store)
        ml = branch_matrix(node.left, sub)
        mr = branch_matrix(node.right, sub)
        A = ml[None, :, :] * li[:, None, :]       # mut(n,l) * storedL[l]
        res = np.zeros((P, 4), np.float64)
        for l in range(4):
            for r in range(4):
                res += (A[:, :, l] * mr[None, :, r]) * ri[:, r, None]
    store[id(node)] = res
    return res


def _bubble_up(node: ETree, prev: ETree, scrap: np.ndarray, sub: bool,
               store: dict) -> np.ndarray:
    """bubbleUp (reconstruct.go:190) vectorized over positions with the
    literal term order/multiply associativity."""
    ml = branch_matrix(node.left, sub)
    mr = branch_matrix(node.right, sub)
    mm = ml[:, :, None] * mr[:, None, :]          # (n, l, r)
    from_left = prev is node.left
    other = store[id(node.right)] if from_left else store[id(node.left)]
    P = scrap.shape[0]
    new = np.zeros((P, 4), np.float64)
    for l in range(4):
        for r in range(4):
            if from_left:
                new += (mm[None, :, l, r] * scrap[:, l, None]) \
                    * other[:, r, None]
            else:
                new += (mm[None, :, l, r] * scrap[:, r, None]) \
                    * other[:, l, None]
    if node.up is not None:
        return _bubble_up(node.up, node, new, sub, store)
    return ((new[:, 0] + new[:, 1]) + new[:, 2]) + new[:, 3]


def fix_fc(root: ETree, node: ETree, sub: bool, store: dict) -> np.ndarray:
    """FixFc (reconstruct.go:233): per-state one-hot scrap bubbled to the
    root; vectorized over positions."""
    stored = store[id(node)]
    if node.up is None:
        return stored
    P = stored.shape[0]
    fix = np.zeros((P, 4), np.float64)
    for s in range(4):
        scrap = np.zeros((P, 4), np.float64)
        scrap[:, s] = stored[:, s]
        fix[:, s] = _bubble_up(node.up, node, scrap, sub, store)
    return fix


def _base_exists(root: ETree, P: int) -> dict:
    """BaseExistsAtNodes (reconstruct.go:253): vectorized bools (P,)."""
    desc: dict[int, np.ndarray] = {}
    present: dict[int, np.ndarray] = {}

    def desc_pass(node: ETree) -> np.ndarray:
        if node.left is None and node.right is None:
            d = np.asarray(node.fasta.seq[:P]) != dna.GAP
        else:
            d = desc_pass(node.left) | desc_pass(node.right)
        desc[id(node)] = d
        return d

    def present_pass(node: ETree) -> None:
        count = np.zeros(P, np.int64)
        if node.up is not None:
            count += present[id(node.up)]
        if node.left is not None:
            count += desc[id(node.left)]
            count += desc[id(node.right)]
        present[id(node)] = count >= 2
        if node.left is not None:
            present_pass(node.left)
            present_pass(node.right)

    desc_pass(root)
    present_pass(root)
    return present


def _call_bases(fix: np.ndarray, non_bias_threshold: float,
                bias_base: np.ndarray, bias_n: bool,
                highest_threshold: float) -> np.ndarray:
    """LikelihoodsToBase (reconstruct.go:50) vectorized, with Go NaN
    comparison semantics (NaN < x is false)."""
    P = fix.shape[0]
    total = fix.sum(axis=1)
    highest = fix.max(axis=1)
    arg = np.argmax(fix, axis=1).astype(np.int8)  # first max, like strict >
    all_zero = highest <= 0
    answer = np.where(all_zero, bias_base, arg).astype(np.int8)

    with np.errstate(invalid="ignore", divide="ignore"):
        frac_high = np.where(total != 0, highest / total, np.nan)
        in_range = bias_base < 4
        bias_prob = np.take_along_axis(
            fix, np.clip(bias_base, 0, 3).astype(np.int64)[:, None],
            axis=1)[:, 0]
        non_bias = np.where(in_range, total - bias_prob, total)
        frac_nb = np.where(total != 0, non_bias / total, np.nan)

    low_conf = ~np.isnan(frac_high) & (frac_high < highest_threshold)
    answer = np.where(low_conf, dna.N, answer).astype(np.int8)
    biased = ~low_conf & ~np.isnan(frac_nb) & (frac_nb < non_bias_threshold)
    if bias_n:
        to_n = biased & ((1 - frac_nb) < non_bias_threshold)
        answer = np.where(to_n, dna.N, np.where(biased, bias_base,
                                                answer)).astype(np.int8)
    else:
        answer = np.where(biased, bias_base, answer).astype(np.int8)
    return answer


def reconstruct_tree(root: ETree, *, bias_leaf_name: str = "",
                     bias_node_name: str = "",
                     non_bias_threshold: float = 0.0, bias_n: bool = False,
                     highest_threshold: float = 0.0, sub_matrix: bool = False,
                     pdna_node: str = "") -> PFasta:
    """Assign reconstructed sequences to all internal nodes (the
    vectorized equivalent of looping reconstruct.LoopNodes over every
    position). Returns pdna_node's probabilities at its present columns
    (an empty record when pdna_node is empty)."""
    leaves = get_leaves(root)
    P = len(leaves[0].fasta.seq)

    bias_node = bias_node_name
    bias_seq = None
    if bias_leaf_name:
        leaf = find_node(root, bias_leaf_name)
        if leaf is None:
            raise ValueError(f"didn't find {bias_leaf_name} in tree")
        if leaf.up is None:
            raise ValueError("bias node cannot be the root")
        if not bias_node:
            bias_node = leaf.up.name
        bias_seq = np.asarray(leaf.fasta.seq[:P], np.int8)

    store: dict[int, np.ndarray] = {}
    inside(root, P, sub_matrix, store)
    present = _base_exists(root, P)

    pdna_rec = PFasta(pdna_node)

    for node in get_branch(root):
        fix = fix_fc(root, node, sub_matrix, store)
        if bias_seq is not None and node.name == bias_node:
            calls = _call_bases(fix, non_bias_threshold, bias_seq, bias_n,
                                highest_threshold)
        else:
            calls = _call_bases(fix, 0.0, np.full(P, dna.N, np.int8),
                                bias_n, highest_threshold)
        pres = present[id(node)]
        calls = np.where(pres, calls, dna.GAP).astype(np.int8)
        node.fasta.seq = calls

        total = fix.sum(axis=1)
        with np.errstate(invalid="ignore", divide="ignore"):
            probs = np.where(total[:, None] > 0, fix / total[:, None], 0.0)
        if pdna_node and node.name == pdna_node:
            pdna_rec.seq = probs[pres].astype(np.float32)
    return pdna_rec


def _calc_location_in_codon(gene, exon: int, position: int) -> int:
    """reconstruct.calcLocationInCodon (accuracy.go:161)."""
    return (position - gene.exon_starts[exon] + gene.exon_frames[exon]) % 3


def recon_accuracy_by_base(sim_filename: str, recon_filename: str,
                           gp_filename: str) -> dict[str, list[float]]:
    """reconstruct.ReconAccuracyByBase (accuracy.go:110): for each
    simulated record, the percentage of exon bases at the first, second
    and third codon position that the reconstruction got right."""
    # simulate imports phylo.etree, so these imports wait for the call
    from ..io import formats
    from ..simulate import check_exon

    sim = fastaio.read(sim_filename)
    recon = fastaio.to_map(fastaio.read(recon_filename))
    genes = formats.read_gene_pred(gp_filename)
    answer: dict[str, list[float]] = {}
    for s in sim:
        if s.name not in recon:
            raise SystemExit(f"Cannot find a reconstructed sequence match "
                             f"for simulated sequence: {s.name}.")
        r_seq = recon[s.name]
        mistakes = [0.0, 0.0, 0.0]
        totals = [0.0, 0.0, 0.0]
        for i in range(len(s.seq)):
            for g in genes:
                in_exon, exon = check_exon(g, i)
                if in_exon:
                    loc = _calc_location_in_codon(g, exon, i)
                    totals[loc] += 1
                    if s.seq[i] != r_seq[i]:
                        mistakes[loc] += 1
        answer[s.name] = [100 - (mistakes[k] / totals[k]) * 100
                          for k in range(3)]
    return answer


def recon_accuracy(sim_filename: str, recon_filename: str,
                   leaves_only_file: str, gp_filename: str,
                   calc_base_acc: bool):
    """reconstruct.ReconAccuracy (accuracy.go:14): the percentage of
    bases right for each node ("(leaf)" after a leaf's name), in its exons
    and outside them, and over all reconstructed nodes; and, with
    calc_base_acc, recon_accuracy_by_base's table (else None). A record
    with no exon base, or none outside the exons, raises
    ZeroDivisionError, as in the JAX."""
    from ..io import formats
    from ..simulate import check_exon

    acc_by_base = None
    if calc_base_acc:
        acc_by_base = recon_accuracy_by_base(sim_filename, recon_filename,
                                             gp_filename)
    sim = fastaio.read(sim_filename)
    recon = fastaio.read(recon_filename)
    leaves = fastaio.read(leaves_only_file)
    leaf_names = {l.name for l in leaves}
    genes = formats.read_gene_pred(gp_filename) if gp_filename else []
    answer: dict[str, float] = {}
    total = 0.0
    for s in sim:
        mistakes = exon_mistakes = non_coding_mistakes = 0.0
        exon_bases = non_coding_bases = 0.0
        leaf_mistakes = 0.0
        found = False
        leaf = False
        for r in recon:
            if s.name != r.name:
                continue
            leaf = r.name in leaf_names
            found = True
            for g in genes:
                for k in range(len(s.seq)):
                    exon, _ = check_exon(g, k)
                    if exon:
                        exon_bases += 1
                    else:
                        non_coding_bases += 1
                    if s.seq[k] != r.seq[k]:
                        if not leaf:
                            mistakes += 1
                        else:
                            leaf_mistakes += 1
                        if exon:
                            exon_mistakes += 1
                        else:
                            non_coding_mistakes += 1
        if not found:
            raise SystemExit("Did not find all simulated sequences in "
                             "reconstructed fasta.")
        if not leaf:
            answer[s.name] = 100 - mistakes / len(s.seq) * 100.0
            total += mistakes
        else:
            answer[s.name + "(leaf)"] = 100 - leaf_mistakes / len(s.seq) \
                * 100.0
        answer[s.name + " exon"] = 100 - exon_mistakes / exon_bases * 100.0
        answer[s.name + " nonCoding"] = \
            100 - non_coding_mistakes / non_coding_bases * 100.0
    accuracy = total / (float(len(sim) - len(leaves))
                        * float(len(sim[0].seq))) * 100.0
    answer["All Reconstructed Nodes"] = 100 - accuracy
    return answer, acc_by_base


def ils_reconstruct_seq(all_post_probs: list[dict], all_recons: list,
                        precision: float) -> PFasta:
    """reconstruct.IlsReconstructSeq (ilsReconstruct.go:11): the
    reconstructions' probabilities summed with each position's weight
    from its wig; every output position must sum to 1 within precision.
    The sum is float32, each float64 weight rounded to float32 before it
    multiplies, in the records' order, as in the JAX: another order
    changes the ``.pfa`` bytes."""
    if len(all_post_probs) != len(all_recons):
        raise SystemExit(
            f"IlsReconstructSeq requires the same number of postProbs "
            f"({len(all_post_probs)}) as recons ({len(all_recons)})")
    for idx in range(len(all_recons) - 1):
        a = all_post_probs[idx][all_recons[idx].name]
        b = all_post_probs[idx + 1][all_recons[idx + 1].name]
        if len(a.values) != len(b.values):
            raise SystemExit("Requested posterior probabilities do not "
                             "have the same length.")
        if len(all_recons[idx].seq) != len(all_recons[idx + 1].seq):
            raise SystemExit("Requested sequences do not have the same "
                             "length.")
    total = np.zeros_like(np.asarray(all_recons[0].seq, np.float32))
    for pp, rec in zip(all_post_probs, all_recons):
        w = np.asarray(pp[rec.name].values, np.float64)[:len(rec.seq)]
        total = total + np.asarray(rec.seq, np.float32) \
            * w.astype(np.float32)[:, None]
    sums = total.sum(axis=1)
    bad = np.flatnonzero(np.abs(sums - 1) > precision)
    if len(bad):
        raise SystemExit(f"This reconstruction returns a pDNA base that "
                         f"does not sum to 1 at {int(bad[0])}")
    return PFasta("ilsRecon", total)
