"""Protein alphabet + codon translation.

The port's copy of the JAX package's ``ops/aa.py`` (NumPy only, as
there). Counterpart of the reference's ``sequence/aa.hpp`` (``aa::translate``)
used by the biosyntheticSPAdes domain matcher
(projects/spades/domain_matcher.cpp:42 translates contigs in 3 frames).

Amino acids are coded 0..19 in HMMER's canonical order
"ACDEFGHIKLMNPQRSTVWY"; stop codons get code 20 (``STOP``).
"""

from __future__ import annotations

import numpy as np

AA_ORDER = "ACDEFGHIKLMNPQRSTVWY"
STOP = 20
NUM_AA = 20

_CODON_TABLE_STR = {
    # standard genetic code, DNA codons
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}

_BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
AA_CODE = {a: i for i, a in enumerate(AA_ORDER)}
AA_CODE["*"] = STOP

# codon index = 16*b0 + 4*b1 + b2 (2-bit base codes) -> aa code
CODON_LUT = np.zeros(64, np.uint8)
for codon, aa in _CODON_TABLE_STR.items():
    idx = (_BASE_CODE[codon[0]] << 4) | (_BASE_CODE[codon[1]] << 2) | \
        _BASE_CODE[codon[2]]
    CODON_LUT[idx] = AA_CODE[aa]


def translate_codes(codes: np.ndarray, frame: int = 0) -> np.ndarray:
    """Translate 2-bit DNA codes (1-D uint8) to AA codes from ``frame``."""
    codes = np.asarray(codes)
    usable = (len(codes) - frame) // 3
    if usable <= 0:
        return np.zeros(0, np.uint8)
    c = codes[frame:frame + 3 * usable].reshape(usable, 3).astype(np.int32)
    idx = (c[:, 0] << 4) | (c[:, 1] << 2) | c[:, 2]
    return CODON_LUT[idx]


def translate_str(seq: str, frame: int = 0) -> str:
    codes = np.asarray([_BASE_CODE[c] for c in seq], np.uint8)
    aa = translate_codes(codes, frame)
    return "".join((AA_ORDER + "*")[a] for a in aa)


def encode_aa(seq: str) -> np.ndarray:
    return np.asarray([AA_CODE[c] for c in seq], np.uint8)
