"""Residue topology tables for the atom14 layout (numpy).

A copy of codlad_tpu/geometry/residues.py: slot 0=O, 1=N, 2=C, 3=CA, slots
4..13 hold up to ten side-chain heavy atoms in canonical order. Atom
existence, names, atomic numbers, Z-matrix parent triplets, ic masks and
the intra-residue bond adjacency are static tables indexed by residue-type
id. The port keeps its own copy so that it never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

MAX_ATOMS = 14  # O, N, C, CA + up to 10 side-chain heavy atoms
NUM_BB = 4  # backbone slots
MAX_SC = 10  # side-chain slots
NUM_IC = 13  # 3 backbone (N, C, O) + 10 side-chain internal-coordinate rows
NUM_RESTYPES = 22

# One entry per residue type: (three-letter, one-letter, side-chain atom
# names beyond [O, N, C, CA], Z-matrix parent triplets for each side-chain
# atom).  A parent triplet (a, b, c) indexes into the residue's atom list in
# canonical order; the atom is placed at distance from atom c, angle w.r.t.
# (c, b) and torsion w.r.t. (c, b, a) — matching reference
# utils/utils_ic.py:33-83 ordering where placement reads the triplet
# right-to-left.
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

# Residue-type index assignment (reference: utils/protein_module.py:72-93
# RES2IDX keyed by one-letter code) — kept so residue-id embeddings line up
# with the reference vocabulary.
ONE_TO_IDX = {
    "N": 0, "H": 1, "A": 2, "G": 3, "R": 4, "M": 5, "S": 6, "I": 7, "E": 8,
    "L": 9, "Y": 10, "D": 11, "V": 12, "W": 13, "Q": 14, "K": 15, "P": 16,
    "F": 17, "C": 18, "T": 19, "O": 20, "B": 21,
}
THREE_TO_ONE = {name: spec[0] for name, spec in _RESIDUE_SPEC.items()}
THREE_TO_ONE["HID"] = "H"  # alternate protonation naming
ONE_TO_THREE = {one: name for name, (one, _, _) in _RESIDUE_SPEC.items()}
IDX_TO_THREE = {idx: ONE_TO_THREE[one] for one, idx in ONE_TO_IDX.items()}
RESTYPE_ORDER = [IDX_TO_THREE[i] for i in range(NUM_RESTYPES)]


def _element_of(atom_name: str) -> str:
    if atom_name == "P":
        return "P"
    if atom_name.startswith("SE"):
        return "SE"
    return atom_name[0]


_ATOMIC_NUMBER = {"C": 6, "N": 7, "O": 8, "S": 16, "P": 15, "SE": 34, "H": 1}

# Covalent radii (Å) used for bond-graph validity checks, standard values
# for the elements occurring in proteins (cf. Cordero et al. 2008 /
# OpenBabel); keyed by atomic number.  Same constants the reference uses
# (utils/protein_module.py:128-234).
COVALENT_CUTOFF = {1: 0.23, 6: 0.68, 7: 0.68, 8: 0.68, 15: 0.75, 16: 1.02, 34: 1.22}


def _build_tables():
    names = np.zeros((NUM_RESTYPES, MAX_ATOMS), dtype=object)
    exists = np.zeros((NUM_RESTYPES, MAX_ATOMS), dtype=bool)
    atomic_num = np.zeros((NUM_RESTYPES, MAX_ATOMS), dtype=np.int32)
    natoms = np.zeros((NUM_RESTYPES,), dtype=np.int32)
    # parents[r, k] = (a, b, c) triplet for side-chain slot k (atom 4+k),
    # filled with (0, 1, 2) for absent slots (masked out downstream;
    # reference utils/protein_module.py:482-485 uses the same filler).
    parents = np.tile(np.array([0, 1, 2], dtype=np.int32), (NUM_RESTYPES, MAX_SC, 1))
    ic_mask = np.zeros((NUM_RESTYPES, NUM_IC), dtype=bool)

    for res_idx in range(NUM_RESTYPES):
        three = IDX_TO_THREE[res_idx]
        _, sc_names, sc_parents = _RESIDUE_SPEC[three]
        atom_names = ["O", "N", "C", "CA"] + list(sc_names)
        n = len(atom_names)
        natoms[res_idx] = n
        for a, nm in enumerate(atom_names):
            names[res_idx, a] = nm
            exists[res_idx, a] = True
            atomic_num[res_idx, a] = _ATOMIC_NUMBER[_element_of(nm)]
        for k, trip in enumerate(sc_parents):
            parents[res_idx, k] = np.array(trip, dtype=np.int32)
        # ic rows: 3 backbone (N, C, O) + one per existing side-chain atom.
        # The reference masks (natoms - 1) leading rows of the 13
        # (utils/protein_module.py:754-758): 3 backbone + (natoms - 4) sc.
        ic_mask[res_idx, : n - 1] = True

    return names, exists, atomic_num, natoms, parents, ic_mask


(ATOM14_NAMES, ATOM14_EXISTS, ATOM14_ATOMIC_NUM, RES_NATOMS, SC_PARENTS,
 IC_MASK) = _build_tables()

# Number of side-chain torsion slots actually used per residue type.
SC_COUNT = RES_NATOMS - NUM_BB

# Aromatic-ring and ion-pair bookkeeping for interaction metrics
# (reference: utils/protein_module.py:118-124).
BACKBONE_NAMES = ("CA", "C", "N", "O", "H")
HBOND_ELEMENT_PAIRS = ("NO", "ON", "SN", "NS", "SO", "OS", "SS", "NN", "OO")
RING_RESIDUES = ("PHE", "TYR", "TRP", "HIS")
ION_RESIDUES = ("ASP", "GLU", "ARG", "LYS")


def restype_index(resname: str) -> int:
    """Map a 3-letter residue name to its type id."""
    return ONE_TO_IDX[THREE_TO_ONE[resname]]


# Ring-closing bonds not implied by the Z-matrix parent chain, as (slot, slot)
# pairs in canonical atom order.  The bonded parent of every side-chain atom
# is the first reference of its Z-matrix triplet; rings additionally close.
_RING_CLOSURES = {
    "HIS": [(7, 9)],            # ND1-CE1
    "PHE": [(8, 10)],           # CZ-CE2
    "TYR": [(6, 10)],           # CD1-CE1
    "TRP": [(8, 9), (11, 13)],  # NE1-CE2, CH2-CZ3
    "PRO": [(5, 6)],            # CG-CD (CD's Z-matrix parent is N)
}


def _build_bond_adjacency():
    """Intra-residue heavy-atom bond adjacency [22, 14, 14] (symmetric)."""
    adj = np.zeros((NUM_RESTYPES, MAX_ATOMS, MAX_ATOMS), dtype=bool)

    def bond(r, i, j):
        adj[r, i, j] = True
        adj[r, j, i] = True

    for r in range(NUM_RESTYPES):
        three = IDX_TO_THREE[r]
        # backbone: O-C, N-CA, C-CA
        bond(r, 0, 2)
        bond(r, 1, 3)
        bond(r, 2, 3)
        # each side-chain atom bonds its placement parent (first triplet ref)
        for k in range(RES_NATOMS[r] - NUM_BB):
            bond(r, NUM_BB + k, SC_PARENTS[r, k, 2])
        for i, j in _RING_CLOSURES.get(three, []):
            bond(r, i, j)
    return adj


INTRA_BOND_ADJ = _build_bond_adjacency()

# Peptide bond between consecutive residues links C (slot 2) to N (slot 1).
PEPTIDE_BOND = (2, 1)
