"""The standard genetic code and codon translation, a copy of
``gonomics_tpu/codon.py`` (96 lines, whole), gonomics' ``dna/codon.go``.

The code is a flat 64-entry table indexed by 16*b0 + 4*b1 + b2 of the
upper-case base codes, so a whole sequence translates in one gather.
``bedToAminoAcid`` reads ``translate_seq`` and ``AA_LONG``.
"""

from __future__ import annotations

import numpy as np

from . import dna

# amino acid order matching the reference's enum (codon.go aaToByte)
AA_SHORT = "ARNDCQEGHILKMFPSTWYV*"
AA_LONG = ["Ala", "Arg", "Asn", "Asp", "Cys", "Gln", "Glu", "Gly", "His",
           "Ile", "Leu", "Lys", "Met", "Phe", "Pro", "Ser", "Thr", "Trp",
           "Tyr", "Val", "Ter"]

(ALA, ARG, ASN, ASP, CYS, GLN, GLU, GLY, HIS, ILE, LEU, LYS, MET, PHE,
 PRO, SER, THR, TRP, TYR, VAL, STOP) = range(21)

_CODE = {
    "TGA": STOP, "TAA": STOP, "TAG": STOP,
    "GTA": VAL, "GTC": VAL, "GTG": VAL, "GTT": VAL,
    "TAT": TYR, "TAC": TYR,
    "TGG": TRP,
    "ACA": THR, "ACG": THR, "ACT": THR, "ACC": THR,
    "TCA": SER, "TCC": SER, "TCG": SER, "TCT": SER, "AGT": SER, "AGC": SER,
    "CCC": PRO, "CCT": PRO, "CCA": PRO, "CCG": PRO,
    "TTT": PHE, "TTC": PHE,
    "ATG": MET,
    "AAA": LYS, "AAG": LYS,
    "TTA": LEU, "TTG": LEU, "CTC": LEU, "CTG": LEU, "CTA": LEU, "CTT": LEU,
    "ATT": ILE, "ATC": ILE, "ATA": ILE,
    "CAT": HIS, "CAC": HIS,
    "GGG": GLY, "GGA": GLY, "GGT": GLY, "GGC": GLY,
    "GAA": GLU, "GAG": GLU,
    "CAA": GLN, "CAG": GLN,
    "TGT": CYS, "TGC": CYS,
    "GAT": ASP, "GAC": ASP,
    "AAT": ASN, "AAC": ASN,
    "AGA": ARG, "AGG": ARG, "CGC": ARG, "CGG": ARG, "CGA": ARG, "CGT": ARG,
    "GCA": ALA, "GCG": ALA, "GCT": ALA, "GCC": ALA,
}

# flat 64-entry table
_TABLE = np.full(64, -1, np.int8)
for _codon, _aa in _CODE.items():
    _b = dna.from_string(_codon)
    _TABLE[16 * _b[0] + 4 * _b[1] + _b[2]] = _aa


def translate_seq(seq: np.ndarray) -> np.ndarray:
    """dna.TranslateSeq (codon.go:343): AA codes for each full codon
    (lowercase folded to upper; trailing partial codon ignored)."""
    s = dna.to_upper(np.asarray(seq)).astype(np.int64)
    n = len(s) // 3
    s = s[:n * 3]
    if (s > 3).any():
        raise ValueError("cannot translate non-ACGT bases")
    idx = 16 * s[0::3] + 4 * s[1::3] + s[2::3]
    return _TABLE[idx]


def translate_seq_to_ter(seq: np.ndarray) -> np.ndarray:
    """TranslateSeqToTer: stop at (and include) the first stop codon."""
    aas = translate_seq(seq)
    stops = np.nonzero(aas == STOP)[0]
    if len(stops):
        return aas[:stops[0] + 1]
    return aas


def to_short_string(aas: np.ndarray) -> str:
    return "".join(AA_SHORT[a] for a in aas)


def to_string(aas: np.ndarray) -> str:
    return "".join(AA_LONG[a] for a in aas)


def translate_to_short_string(seq: np.ndarray) -> str:
    """dna.TranslateToShortString (codon.go:391)."""
    return to_short_string(translate_seq(seq))


def one_letter_to_aa(b: str) -> int:
    i = AA_SHORT.find(b)
    if i < 0:
        raise ValueError(f"unknown amino acid letter {b!r}")
    return i


def is_synonymous(codon_a: np.ndarray, codon_b: np.ndarray) -> bool:
    return translate_seq(codon_a)[0] == translate_seq(codon_b)[0]
