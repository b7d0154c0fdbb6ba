"""primateRecon: the Human-Chimp or Human-Gorilla ancestor of a
Human-Bonobo-Chimp-Gorilla-Orangutan multiFa, a copy of
``gonomics_tpu/cli/primate_recon.py`` (273 lines, whole), its flags and
defaults unchanged; deprecated in the reference in favour of
reconstructSeq and kept for its command line.

    gonomics-torch primateRecon in.fa out.fa [-messyToN]
        [-mleHcaUnbiased | -mleHcaHumanBiased | -mleHcaChimpBiased
         | -mleHgaGorillaBiased] [-mle tree.nh] [-probThreshold 0]
        [-nonBiasProbThreshold 0] [-useGenericNames]

Three modes (cmd/DEPRECATED/primateRecon/primateRecon.go):

- by default, or with -messyToN, the parsimony voter
  (``ParsimonyPrimateRecon``, primateRecon.go:276-355) over the records
  by position: 0 human, 1 bonobo, 2 chimp, 3 orangutan, 4 gorilla;
- -mleHcaUnbiased, -mleHcaHumanBiased and -mleHcaChimpBiased: the
  Felsenstein marginals at the node "hca" (primateRecon.go:124-201) with
  the deprecated tools' own base callers (likelihoodsToBase{Unbiased,
  Bias}, primateRecon.go:22-70), which differ from reconstructSeq's;
- -mleHgaGorillaBiased: the same at the node "hga", biased to gorilla
  (primateRecon.go:203-273).

The marginals are ``phylo.reconstruct``'s ``inside`` and ``fix_fc`` over
all columns at once, in the reference's order of sums, so likelihood
ties break on the same base.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import dna
from ..io import fasta as fastaio
from ..phylo.etree import find_node, read_tree
from ..phylo.reconstruct import fix_fc, inside


def base_is_present(b: np.ndarray) -> np.ndarray:
    """dna.DefineBase(b) || b == dna.N (primateRecon.go:72-77),
    vectorized."""
    return dna.define_base_mask(b) | (np.asarray(b) == dna.N)


def node_likelihoods(root, node_name: str):
    """FixFc marginals for one internal node, all positions at once.
    Returns (fix (P,4), node)."""
    node = find_node(root, node_name)
    if node is None:
        raise SystemExit(f"Didn't find {node_name} in the tree")
    cur = root
    while cur.left is not None:
        cur = cur.left
    if cur.fasta is None:
        raise SystemExit(
            f"leaf {cur.name} has no sequence in the input multiFa "
            "(every tree leaf must appear in the alignment)")
    P = len(cur.fasta.seq)
    store: dict[int, np.ndarray] = {}
    inside(root, P, False, store)
    return fix_fc(root, node, False, store), node


def call_bases_unbiased(fix: np.ndarray, prob_threshold: float) -> np.ndarray:
    """likelihoodsToBaseUnbiased (primateRecon.go:22-39): default N; best
    base among those with likes[i]/total >= threshold, requiring a
    strictly positive winner. Go NaN semantics: total==0 -> no call."""
    total = fix.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(total[:, None] != 0, fix / total[:, None], np.nan)
    elig = ~np.isnan(frac) & (frac >= prob_threshold)
    cand = np.where(elig, fix, -np.inf)
    best = cand.max(axis=1)
    arg = cand.argmax(axis=1).astype(np.int8)  # first max, like strict >
    return np.where(best > 0, arg, dna.N).astype(np.int8)


def call_bases_bias(fix: np.ndarray, bias: np.ndarray, prob_threshold: float,
                    non_bias_threshold: float) -> np.ndarray:
    """likelihoodsToBaseBias (primateRecon.go:44-70): default = bias base
    (N if the bias base is a gap); a non-default call additionally needs
    the summed non-bias likelihood fraction to pass non_bias_threshold."""
    bias = np.asarray(bias, np.int8)
    total = fix.sum(axis=1)
    default = np.where(bias == dna.GAP, dna.N, bias).astype(np.int8)
    idx = np.clip(bias, 0, 3).astype(np.int64)
    bias_like = np.take_along_axis(fix, idx[:, None], axis=1)[:, 0]
    # i != int(biasBase) excludes nothing when the bias base is not A..T
    non_bias = np.where(bias < 4, total - bias_like, total)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(total[:, None] != 0, fix / total[:, None], np.nan)
        frac_nb = np.where(total != 0, non_bias / total, np.nan)
    nb_ok = ~np.isnan(frac_nb) & (frac_nb >= non_bias_threshold)
    elig = ~np.isnan(frac) & (frac >= prob_threshold) & nb_ok[:, None]
    cand = np.where(elig, fix, -np.inf)
    best = cand.max(axis=1)
    arg = cand.argmax(axis=1).astype(np.int8)
    return np.where(best > 0, arg, default).astype(np.int8)


def _find(root, name: str):
    node = find_node(root, name)
    if node is None:
        raise SystemExit(f"Didn't find {name} in the tree")
    return node


_ASSEMBLY = ("hg38", "panPan2", "panTro6", "gorGor5", "ponAbe3")
_GENERIC = ("human", "bonobo", "chimp", "gorilla", "orangutan")


def _roll_call(root, use_generic_names: bool):
    names = _GENERIC if use_generic_names else _ASSEMBLY
    return tuple(_find(root, n) for n in names)


def hca_is_present(h, b, c, g, o) -> np.ndarray:
    """hcaIsPresent (primateRecon.go:79-87), vectorized."""
    h, b, c, g, o = map(base_is_present, (h, b, c, g, o))
    return (h & (b | c)) | ((h | b | c) & (g | o))


def hga_is_present(h, b, c, g, o) -> np.ndarray:
    """hgaIsPresent (primateRecon.go:89-97), vectorized."""
    h, b, c, g, o = map(base_is_present, (h, b, c, g, o))
    return (g & (h | c | b)) | (o & (g | h | c | b))


def primate_recon_hca_mle(in_fa: str, in_tree: str, human_bias: bool,
                          chimp_bias: bool, prob_threshold: float,
                          non_human_prob_threshold: float,
                          use_generic_names: bool, out_fa: str) -> None:
    """primateReconHcaMle (primateRecon.go:124-201)."""
    root = read_tree(in_tree, in_fa)
    human, bonobo, chimp, gorilla, orangutan = _roll_call(
        root, use_generic_names)
    human_alt = None
    if not (human_bias or chimp_bias):
        human_alt = _find(root, "hg38alt")
    fix, hca = node_likelihoods(root, "hca")
    hseq = np.asarray(human.fasta.seq, np.int8)
    present = hca_is_present(hseq, bonobo.fasta.seq, chimp.fasta.seq,
                             gorilla.fasta.seq, orangutan.fasta.seq)
    if human_bias:
        calls = call_bases_bias(fix, hseq, prob_threshold,
                                non_human_prob_threshold)
    elif chimp_bias:
        calls = call_bases_bias(fix, np.asarray(chimp.fasta.seq, np.int8),
                                prob_threshold, non_human_prob_threshold)
    else:
        calls = call_bases_unbiased(fix, prob_threshold)
    hca.fasta.seq = np.where(present, calls, dna.GAP).astype(np.int8)
    if human_bias or chimp_bias:
        out = [human.fasta, chimp.fasta, bonobo.fasta, gorilla.fasta,
               orangutan.fasta, hca.fasta]
    else:
        out = [human.fasta, human_alt.fasta, chimp.fasta, bonobo.fasta,
               gorilla.fasta, orangutan.fasta, hca.fasta]
    fastaio.write(out_fa, out)


def primate_recon_hga_mle(in_fa: str, in_tree: str, prob_threshold: float,
                          non_bias_prob_threshold: float,
                          use_generic_names: bool, out_fa: str) -> None:
    """primateReconHgaMle (primateRecon.go:203-273)."""
    root = read_tree(in_tree, in_fa)
    human, bonobo, chimp, gorilla, orangutan = _roll_call(
        root, use_generic_names)
    fix, hga = node_likelihoods(root, "hga")
    present = hga_is_present(human.fasta.seq, bonobo.fasta.seq,
                             chimp.fasta.seq, gorilla.fasta.seq,
                             orangutan.fasta.seq)
    calls = call_bases_bias(fix, np.asarray(gorilla.fasta.seq, np.int8),
                            prob_threshold, non_bias_prob_threshold)
    hga.fasta.seq = np.where(present, calls, dna.GAP).astype(np.int8)
    fastaio.write(out_fa, [human.fasta, chimp.fasta, bonobo.fasta,
                           gorilla.fasta, orangutan.fasta, hga.fasta])


def parsimony_primate_recon(records: list[fastaio.Fasta],
                            messy_to_n: bool) -> fastaio.Fasta:
    """ParsimonyPrimateRecon (primateRecon.go:281-355): positional
    Human-Bonobo-Chimp-Orangutan-Gorilla voter, as an ordered np.select
    chain mirroring the if/else ladder."""
    if len(records) != 5:
        raise SystemExit(
            f"Wrong number of sequences, expecting five, found {len(records)}.")
    first = len(records[0].seq)
    for i, rec in enumerate(records[1:], start=2):
        if len(rec.seq) != first:
            raise SystemExit(f"Sequence {i} is the wrong length.")
    hum = np.asarray(records[0].seq, np.int8)
    bon = np.asarray(records[1].seq, np.int8)
    chi = np.asarray(records[2].seq, np.int8)
    ora = np.asarray(records[3].seq, np.int8)
    gor = np.asarray(records[4].seq, np.int8)

    human_insertion = (hum != dna.GAP) & (chi == dna.GAP) & \
        (bon == dna.GAP) & (gor == dna.GAP) & (ora == dna.GAP)
    messy = np.int8(dna.N) if messy_to_n else hum
    chimp_real = (chi != dna.N) & (chi != dna.GAP)
    gor_real = (gor != dna.N) & (gor != dna.GAP)
    ora_real = (ora != dna.N) & (ora != dna.GAP)
    conds = [
        hum == dna.N,
        human_insertion,
        (hum != dna.GAP) & (chi == dna.GAP) & (bon == dna.GAP),
        (gor == dna.GAP) & (ora == dna.GAP),
        (hum == chi) & (hum == bon),
        ((hum == chi) | (hum == bon)) & (hum != dna.GAP),
        (chi == bon) & ((chi == gor) | (chi == ora)) & chimp_real,
        ((hum == gor) | (chi == gor) | (bon == gor)) & gor_real,
        ((hum == ora) | (chi == ora) | (bon == ora) | (gor == ora)) & ora_real,
    ]
    outs = [hum, np.int8(dna.GAP), messy, messy, hum, hum, chi, gor, ora]
    fallback = np.where((hum != dna.GAP) & (not messy_to_n), hum, dna.N)
    seq = np.select(conds, outs, fallback).astype(np.int8)
    return fastaio.Fasta("Human_Chimp_Ancestor", seq)


def primate_recon(in_fa: str, out_fa: str, messy_to_n: bool) -> None:
    records = fastaio.read(in_fa)
    fastaio.write(out_fa, records +
                  [parsimony_primate_recon(records, messy_to_n)])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="primateRecon",
        description="[DEPRECATED — use reconstructSeq] Returns maximum "
                    "likelihood sequence from an HBCGO primate alignment")
    p.add_argument("-messyToN", action="store_true")
    p.add_argument("-mleHcaUnbiased", action="store_true")
    p.add_argument("-mleHcaHumanBiased", action="store_true")
    p.add_argument("-mleHcaChimpBiased", action="store_true")
    p.add_argument("-mleHgaGorillaBiased", action="store_true")
    p.add_argument("-mle", default="", help="newick tree with branch lengths")
    p.add_argument("-probThreshold", type=float, default=0.0)
    p.add_argument("-nonBiasProbThreshold", type=float, default=0.0)
    p.add_argument("-useGenericNames", action="store_true")
    p.add_argument("inFile")
    p.add_argument("outFile")
    a = p.parse_args(argv)

    hca_mle = a.mleHcaUnbiased or a.mleHcaHumanBiased or a.mleHcaChimpBiased
    if a.mleHcaHumanBiased and a.mleHcaChimpBiased:
        raise SystemExit("Error: cannot be biased for both the human and the chimp base")
    if a.messyToN and hca_mle:
        raise SystemExit("Error: -messyToN can not be used with mle estimates")
    if a.mle == "" and hca_mle:
        raise SystemExit("Error: you need to provide a tree when using an mle estimate")
    if a.mleHcaUnbiased and (a.mleHcaHumanBiased or a.mleHcaChimpBiased):
        raise SystemExit("Error: Can not do both a biased and unbiased mle estimate")
    if (a.probThreshold != 0 or a.nonBiasProbThreshold != 0) and not (
            hca_mle or a.mleHgaGorillaBiased):
        raise SystemExit("Error: Can not use probability threshold flags "
                         "without also using an mle estimate")
    if a.nonBiasProbThreshold != 0 and a.mleHcaUnbiased:
        raise SystemExit("Error: Can not do a nonBiasProbThreshold when also "
                         "doing an unbiased estimate")
    if a.mleHgaGorillaBiased and hca_mle:
        raise SystemExit("Error: cannot estimate both the HCA and the HGA at once")

    if hca_mle:
        primate_recon_hca_mle(a.inFile, a.mle, a.mleHcaHumanBiased,
                              a.mleHcaChimpBiased, a.probThreshold,
                              a.nonBiasProbThreshold, a.useGenericNames,
                              a.outFile)
    elif a.mleHgaGorillaBiased:
        primate_recon_hga_mle(a.inFile, a.mle, a.probThreshold,
                              a.nonBiasProbThreshold, a.useGenericNames,
                              a.outFile)
    else:
        primate_recon(a.inFile, a.outFile, a.messyToN)


if __name__ == "__main__":
    main()
