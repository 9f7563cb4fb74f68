"""HMMER3 ASCII profile reader/writer.

The port's copy of the JAX package's ``io/hmmfile.py`` (host code, as
there). Counterpart of the reference's ``hmm/hmmfile.cpp`` (a thin
wrapper over ext/hmmer's ``p7_hmmfile_Read``) feeding
biosyntheticSPAdes' domain matcher (projects/spades/domain_matcher.cpp;
custom sets via ``--custom-hmms``, config ``hm.hmm_set``). Parses the
HMMER3/f text format into log-odds :class:`~..ops.hmm.HMMProfile`
arrays (values in the file are negative natural logs of probabilities;
``*`` = prob 0).
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..ops.aa import AA_ORDER, NUM_AA, STOP
from ..ops.hmm import HMMProfile, NEG

# HMMER null-model amino acid background (easel p7_AminoFrequencies)
P7_BG = {
    "A": 0.0787945, "C": 0.0151600, "D": 0.0535222, "E": 0.0668298,
    "F": 0.0397062, "G": 0.0695071, "H": 0.0229198, "I": 0.0590092,
    "K": 0.0594422, "L": 0.0963728, "M": 0.0237718, "N": 0.0414386,
    "P": 0.0482904, "Q": 0.0395639, "R": 0.0540978, "S": 0.0683364,
    "T": 0.0540687, "V": 0.0673417, "W": 0.0114135, "Y": 0.0304133,
}
BG = np.asarray([P7_BG[a] for a in AA_ORDER], np.float64)


def _val(tok: str) -> float:
    return math.inf if tok == "*" else float(tok)


def read_hmm_file(path: str) -> list[HMMProfile]:
    """Parse one .hmm file (possibly multi-model)."""
    profiles = []
    with open(path) as f:
        lines = iter(f.read().splitlines())
    cur = None
    for line in lines:
        if line.startswith("HMMER"):
            cur = {"name": "", "desc": "", "leng": 0}
            continue
        if cur is None:
            continue
        toks = line.split()
        if not toks:
            continue
        if toks[0] == "NAME":
            cur["name"] = toks[1]
        elif toks[0] == "DESC":
            cur["desc"] = " ".join(toks[1:])
        elif toks[0] == "LENG":
            cur["leng"] = int(toks[1])
        elif toks[0] == "ALPH":
            if toks[1].lower() != "amino":
                raise ValueError(f"{path}: only amino models supported")
        elif toks[0] == "HMM":
            # header row with symbols; next line = transition header
            next(lines)
            m = cur["leng"]
            match = np.zeros((m, NUM_AA + 1), np.float32)
            trans = np.zeros((m + 1, 7), np.float64)
            node = 0
            node0_done = False
            for row in lines:
                rt = row.split()
                if not rt:
                    continue
                if rt[0] == "//":
                    break
                if rt[0] == "COMPO":
                    next(lines)                      # node-0 insert emis
                    t0 = next(lines).split()         # node-0 transitions
                    trans[0] = [-_val(x) if _val(x) != math.inf else NEG
                                for x in t0[:7]]
                    node0_done = True
                    continue
                if not node0_done and not rt[0].isdigit():
                    # COMPO is optional (hmmbuild --nocompo): this row is
                    # the node-0 insert-emission line; the next holds the
                    # node-0 transitions.
                    t0 = next(lines).split()
                    trans[0] = [-_val(x) if _val(x) != math.inf else NEG
                                for x in t0[:7]]
                    node0_done = True
                    continue
                node0_done = True
                node = int(rt[0])
                emis = [_val(x) for x in rt[1:1 + NUM_AA]]
                # log-odds: log(p/bg) = -val - log(bg)
                match[node - 1, :NUM_AA] = [
                    (NEG if e == math.inf else -e - math.log(BG[i]))
                    for i, e in enumerate(emis)]
                match[node - 1, STOP] = NEG
                next(lines)                          # insert emissions
                tr = next(lines).split()
                trans[node] = [(-_val(x) if _val(x) != math.inf else NEG)
                               for x in tr[:7]]
            # transitions out of node j live at trans[j]
            # order: m->m m->i m->d i->m i->i d->m d->d
            t = trans[1:m + 1].astype(np.float32)
            profiles.append(HMMProfile(
                name=cur["name"] or os.path.basename(path),
                desc=cur["desc"], match=match,
                tMM=t[:, 0], tMI=t[:, 1], tMD=t[:, 2],
                tIM=t[:, 3], tII=t[:, 4], tDM=t[:, 5], tDD=t[:, 6]))
            cur = None
    return profiles


def load_hmm_set(path: str) -> list[HMMProfile]:
    """Load models from a .hmm file or every *.hmm under a directory
    (the ``--custom-hmms`` surface, options_parser.py)."""
    if os.path.isdir(path):
        out = []
        for fn in sorted(os.listdir(path)):
            if fn.endswith((".hmm", ".HMM")):
                out.extend(read_hmm_file(os.path.join(path, fn)))
        return out
    return read_hmm_file(path)


def write_hmm_file(path: str, profiles: list[HMMProfile]) -> None:
    """Write profiles back in HMMER3/f text form (match emissions from
    log-odds + background; inserts = background; round-trip partner of
    :func:`read_hmm_file`, used by tests and tool output)."""
    with open(path, "w") as f:
        for p in profiles:
            m = p.length
            f.write("HMMER3/f [spades_for_blackbird_tpu]\n")
            f.write(f"NAME  {p.name}\n")
            if p.desc:
                f.write(f"DESC  {p.desc}\n")
            f.write(f"LENG  {m}\nALPH  amino\n")
            f.write("HMM" + "".join(f"{a:>9}" for a in AA_ORDER) + "\n")
            f.write(" " * 12 + "m->m     m->i     m->d     i->m     "
                    "i->i     d->m     d->d\n")
            bg_line = "".join(f"  {-math.log(b):.5f}" for b in BG)
            f.write(f"  COMPO {bg_line}\n")
            f.write(" " * 8 + bg_line + "\n")
            f.write(" " * 8 + "  0.00000  0.00000  0.00000  0.00000"
                    "  0.00000  0.00000  0.00000\n")
            for j in range(m):
                emis = []
                for i in range(NUM_AA):
                    lo = float(p.match[j, i])
                    if lo <= NEG / 2:
                        emis.append("*")
                    else:
                        emis.append(f"{-(lo + math.log(BG[i])):.5f}")
                f.write(f"{j + 1:>7} " + "".join(
                    f"{e:>9}" for e in emis) + "\n")
                f.write(" " * 8 + bg_line + "\n")
                tr = []
                for arr in (p.tMM, p.tMI, p.tMD, p.tIM, p.tII,
                            p.tDM, p.tDD):
                    v = float(arr[j])
                    tr.append("*" if v <= NEG / 2 else f"{-v:.5f}")
                f.write(" " * 8 + "".join(f"{t:>9}" for t in tr) + "\n")
            f.write("//\n")
