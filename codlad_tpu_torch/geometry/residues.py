"""Residue topology tables for the atom14 layout (numpy).

A copy of the tables that the decode path reads from
codlad_tpu/geometry/residues.py: slot 0=O, 1=N, 2=C, 3=CA, slots 4..13 hold
up to ten side-chain heavy atoms in canonical order, and `SC_PARENTS` gives
each side-chain slot's Z-matrix parent triplet (a, b, c). The port keeps
its own copy so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

MAX_ATOMS = 14  # O, N, C, CA + up to 10 side-chain heavy atoms
NUM_BB = 4      # backbone slots
MAX_SC = 10     # side-chain slots
NUM_IC = 13     # 3 backbone (N, C, O) + 10 side-chain rows
NUM_RESTYPES = 22

# (one-letter code, side-chain atoms beyond [O, N, C, CA], Z-matrix parent
# triplets per side-chain atom); placement reads a triplet right to left.
_RESIDUE_SPEC = {
    "ALA": ("A", ["CB"], [(1, 2, 3)]),
    "ARG": ("R", ["CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (4, 5, 6), (5, 6, 7), (6, 7, 8), (7, 8, 9)]),
    "ASP": ("D", ["CB", "CG", "OD1", "OD2"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (4, 5, 6)]),
    "ASN": ("N", ["CB", "CG", "OD1", "ND2"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (4, 5, 6)]),
    "CYS": ("C", ["CB", "SG"], [(1, 2, 3), (2, 3, 4)]),
    "GLU": ("E", ["CB", "CG", "CD", "OE1", "OE2"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (4, 5, 6), (5, 6, 7)]),
    "GLN": ("Q", ["CB", "CG", "CD", "OE1", "NE2"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (4, 5, 6), (5, 6, 7)]),
    "GLY": ("G", [], []),
    "HIS": ("H", ["CB", "CG", "CD2", "ND1", "NE2", "CE1"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (3, 4, 5), (7, 5, 6), (5, 6, 8)]),
    "ILE": ("I", ["CB", "CG2", "CG1", "CD1"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (3, 4, 6)]),
    "LEU": ("L", ["CB", "CG", "CD1", "CD2"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (4, 5, 6)]),
    "LYS": ("K", ["CB", "CG", "CD", "CE", "NZ"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (4, 5, 6), (5, 6, 7)]),
    "MET": ("M", ["CB", "CG", "SD", "CE"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (4, 5, 6)]),
    "PHE": ("F", ["CB", "CG", "CD1", "CE1", "CZ", "CD2", "CE2"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (4, 5, 6), (5, 6, 7), (3, 4, 5), (4, 5, 9)]),
    "PRO": ("P", ["CB", "CG", "CD"], [(1, 2, 3), (1, 3, 4), (4, 3, 1)]),
    "SER": ("S", ["CB", "OG"], [(1, 2, 3), (2, 3, 4)]),
    "THR": ("T", ["CB", "OG1", "CG2"], [(1, 2, 3), (2, 3, 4), (3, 4, 5)]),
    "TRP": ("W", ["CB", "CG", "CD1", "CD2", "NE1", "CE2", "CZ2", "CH2", "CE3", "CZ3"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (3, 4, 5), (7, 5, 6), (6, 5, 7), (5, 7, 9),
             (7, 9, 10), (10, 9, 7), (9, 7, 12)]),
    "TYR": ("Y", ["CB", "CG", "CD1", "CD2", "CE2", "CZ", "CE1", "OH"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (3, 4, 5), (6, 5, 7), (5, 7, 8), (7, 8, 9), (7, 8, 9)]),
    "VAL": ("V", ["CB", "CG1", "CG2"], [(1, 2, 3), (2, 3, 4), (3, 4, 5)]),
    "TPO": ("O", ["CB", "OG1", "CG2", "P", "OE1", "OE2", "OE3"],
            [(1, 2, 3), (2, 3, 4), (2, 3, 4), (6, 4, 5), (4, 5, 7), (4, 5, 7), (4, 5, 7)]),
    "SEP": ("B", ["CB", "OG", "P", "OE1", "OE2", "OE3"],
            [(1, 2, 3), (2, 3, 4), (3, 4, 5), (4, 5, 6), (4, 5, 6), (4, 5, 6)]),
}

# residue-type ids, keyed by one-letter code (the reference vocabulary)
ONE_TO_IDX = {
    "N": 0, "H": 1, "A": 2, "G": 3, "R": 4, "M": 5, "S": 6, "I": 7, "E": 8,
    "L": 9, "Y": 10, "D": 11, "V": 12, "W": 13, "Q": 14, "K": 15, "P": 16,
    "F": 17, "C": 18, "T": 19, "O": 20, "B": 21,
}
_ONE_TO_THREE = {one: name for name, (one, _, _) in _RESIDUE_SPEC.items()}
IDX_TO_THREE = {idx: _ONE_TO_THREE[one] for one, idx in ONE_TO_IDX.items()}


def _build_tables():
    exists = np.zeros((NUM_RESTYPES, MAX_ATOMS), dtype=bool)
    # absent slots keep the (0, 1, 2) filler, masked out downstream
    parents = np.tile(np.array([0, 1, 2], dtype=np.int32), (NUM_RESTYPES, MAX_SC, 1))
    for res_idx in range(NUM_RESTYPES):
        _, sc_names, sc_parents = _RESIDUE_SPEC[IDX_TO_THREE[res_idx]]
        exists[res_idx, :NUM_BB + len(sc_names)] = True
        for k, trip in enumerate(sc_parents):
            parents[res_idx, k] = np.array(trip, dtype=np.int32)
    return exists, parents


ATOM14_EXISTS, SC_PARENTS = _build_tables()
