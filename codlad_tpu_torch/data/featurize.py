"""Host-side featurization: atom14 structures -> examples.

A copy of codlad_tpu/data/featurize.py: per-frame internal coordinates,
atom and CG radius graphs as undirected edge lists over flat `res*14+slot`
indices, the order-2 covalent bond pairs, the interaction lists and the
clash pairs. The radius graph is the port's native cell list
(codlad_tpu_torch/native.py, as the JAX featurizer uses its own), or its
dense numpy form where the library is not loaded; the bond reachability
expands adjacency lists instead of scipy's sparse products. Each gives the
same pairs in the same sorted order as the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from codlad_tpu_torch import native
from codlad_tpu_torch.data.np_geometry import np_extract_ic
from codlad_tpu_torch.geometry import residues as R

@dataclasses.dataclass
class FeaturizeConfig:
    atom_cutoff: float = 9.0    # Å, atom radius graph (reference default)
    cg_cutoff: float = 21.0     # Å, CG radius graph
    bond_order: int = 2         # adjacency power for bond pairs
    inter_cutoff: float = 3.3   # Å, HB/ion interaction list
    bb_no_cutoff: float = 4.0   # Å, backbone N-O list


def flat_index(L: int):
    """Flat atom index of (res, slot) in the [L*14] space."""
    return np.arange(L * R.MAX_ATOMS, dtype=np.int32).reshape(L, R.MAX_ATOMS)


def _radius_edges(xyz_flat, valid, cutoff):
    """Undirected (i<j) edges among valid flat atoms within cutoff, sorted:
    the native cell list when the library is loaded, else its dense form."""
    return native.radius_graph(xyz_flat, valid, cutoff)


def _compose(pairs, adj_ptr, adj_dst):
    """Pairs (i, k) with (i, j) in `pairs` and (j, k) in the CSR adjacency."""
    counts = adj_ptr[pairs[:, 1] + 1] - adj_ptr[pairs[:, 1]]
    src = np.repeat(pairs[:, 0], counts)
    starts = np.repeat(adj_ptr[pairs[:, 1]] - np.cumsum(counts) + counts, counts)
    return np.stack([src, adj_dst[np.arange(counts.sum()) + starts]], axis=-1)


_BOND_CACHE: dict = {}


def bond_pairs(res_type, chain_id, order=2):
    """Order-`order` covalent pairs (i<j) in flat atom14 index space.

    Builds the covalent adjacency from the static per-restype bond tables
    plus peptide bonds between consecutive residues of the same chain, then
    expands to pairs with graph distance <= order (reference:
    utils/protein_module.py:536-564).

    Memoized on the sequence: every frame of one protein shares this
    result, so the per-frame cost is a dict lookup.
    """
    key = (np.asarray(res_type).tobytes(), np.asarray(chain_id).tobytes(),
           int(order))
    hit = _BOND_CACHE.get(key)
    if hit is not None:
        return hit
    L = len(res_type)
    N = L * R.MAX_ATOMS
    blk = R.INTRA_BOND_ADJ[res_type]  # [L, 14, 14] bool
    ri, ii, jj = np.nonzero(blk)
    rows = ri * R.MAX_ATOMS + ii
    cols = ri * R.MAX_ATOMS + jj
    pep = np.where((chain_id[:-1] == chain_id[1:]))[0] if L > 1 else np.array([], int)
    ci = pep * R.MAX_ATOMS + R.PEPTIDE_BOND[0]
    nj = (pep + 1) * R.MAX_ATOMS + R.PEPTIDE_BOND[1]
    adj = np.unique(np.concatenate([rows, ci, nj]).astype(np.int64) * N
                    + np.concatenate([cols, nj, ci]))
    adj = np.stack([adj // N, adj % N], axis=-1)
    adj_ptr = np.concatenate([[0], np.cumsum(np.bincount(adj[:, 0], minlength=N))])
    reach, frontier = adj, adj
    for _ in range(order - 1):
        frontier = _compose(frontier, adj_ptr, adj[:, 1])
        reach = np.concatenate([reach, frontier])
    exists = R.ATOM14_EXISTS[res_type].reshape(-1)
    keep = (reach[:, 0] < reach[:, 1]) & exists[reach[:, 0]] & exists[reach[:, 1]]
    flat = np.unique(reach[keep, 0] * N + reach[keep, 1])
    out = np.stack([flat // N, flat % N], axis=-1).astype(np.int32)
    if len(_BOND_CACHE) > 256:  # bound: entries are per-protein, ~50 KB
        _BOND_CACHE.clear()
    _BOND_CACHE[key] = out
    return out


_Z_TO_ELEM = {0: "", 1: "H", 6: "C", 7: "N", 8: "O", 15: "P", 16: "S", 34: "SE"}


def _names_elements(res_type):
    names = R.ATOM14_NAMES[res_type].reshape(-1)
    z = R.ATOM14_ATOMIC_NUM[res_type].reshape(-1)
    elem = np.array([_Z_TO_ELEM[int(zz)] for zz in z], dtype=object)
    return names, elem


def interaction_lists(res_type, chain_id, xyz_flat, valid, cfg: FeaturizeConfig):
    """HB/ion, pi-pi, and backbone N-O lists (reference
    utils/protein_module.py:808-865)."""
    L = len(res_type)
    names, elem = _names_elements(res_type)
    res_seq = (np.arange(L, dtype=np.int64) + 5000 * chain_id.astype(np.int64))
    seq_flat = np.repeat(res_seq, R.MAX_ATOMS)
    res_flat = np.repeat(res_type, R.MAX_ATOMS)

    # --- HB / ion-ion interactions: cell-list radius graph (i<j pairs;
    # HBOND_ELEMENT_PAIRS holds both orderings so i<j loses nothing)
    pairs = _radius_edges(xyz_flat, valid, cfg.inter_cutoff)
    src, dst = pairs[:, 0], pairs[:, 1]
    d01 = np.linalg.norm(xyz_flat[src] - xyz_flat[dst], axis=-1)
    m = d01 > 0.93
    src, dst = src[m], dst[m]
    not_adjacent = (
        (seq_flat[src] != seq_flat[dst])
        & (seq_flat[src] != seq_flat[dst] + 1)
        & (seq_flat[dst] != seq_flat[src] + 1)
    )
    not_both_bb = ~np.isin(names[src], R.BACKBONE_NAMES) | ~np.isin(names[dst], R.BACKBONE_NAMES)
    pair_elem = np.char.add(elem[src].astype(str), elem[dst].astype(str))
    allowed = np.isin(pair_elem, R.HBOND_ELEMENT_PAIRS)
    keep = not_adjacent & not_both_bb & allowed
    inter = np.stack([src[keep], dst[keep]], axis=-1).astype(np.int32)

    # --- pi-pi ring-center pairs: anchors are within-residue CD1-CD2 pairs
    # of PHE/TYR/TRP (the reference's HIS branch keys on a CD1 atom HIS does
    # not have, so it never fires; reproduced as aromatics-only).  CD1/CD2
    # slots come straight from the name tables — no pairwise scan needed.
    arom_types = np.array([R.restype_index(x) for x in ("PHE", "TYR", "TRP")])
    ridx = np.where(np.isin(res_type, arom_types))[0]
    slot_of = {int(t): (list(R.ATOM14_NAMES[t]).index("CD1"),
                        list(R.ATOM14_NAMES[t]).index("CD2"))
               for t in arom_types}
    if len(ridx):
        s1 = np.array([slot_of[int(res_type[r])][0] for r in ridx])
        s2 = np.array([slot_of[int(res_type[r])][1] for r in ridx])
        e1 = (ridx * R.MAX_ATOMS + s1).astype(np.int64)
        e2 = (ridx * R.MAX_ATOMS + s2).astype(np.int64)
        dd = np.linalg.norm(xyz_flat[e1] - xyz_flat[e2], axis=-1)
        ok = (dd <= 8.0) & (dd > 1.5) & valid[e1] & valid[e2]
        e1, e2 = e1[ok], e2[ok]
    else:
        e1 = e2 = np.zeros(0, dtype=np.int64)
    if len(e1):
        centers = (xyz_flat[e1] + xyz_flat[e2]) / 2.0
        cd = np.linalg.norm(centers[:, None] - centers[None, :], axis=-1)
        a, b = np.where((cd <= 5.5) & (cd >= 2.0))
        pipi = np.stack([e1[a], e2[a], e1[b], e2[b]], axis=-1).astype(np.int32)
        pipi = pipi[(pipi[:, 1] > pipi[:, 0]) & (pipi[:, 3] > pipi[:, 2]) & (pipi[:, 0] > pipi[:, 2])]
    else:
        pipi = np.zeros((0, 4), dtype=np.int32)

    # --- backbone N(i+1)-O(i) hydrogen-bond partners.  seq+1 pairs are
    # exactly consecutive same-chain residues, and N/O ride fixed atom14
    # slots, so this is a single vectorized pass over residues.
    if L > 1:
        i = np.arange(L - 1)
        nsrc = ((i + 1) * R.MAX_ATOMS + 1).astype(np.int64)  # N slot = 1
        odst = (i * R.MAX_ATOMS + 0).astype(np.int64)        # O slot = 0
        dno = np.linalg.norm(xyz_flat[nsrc] - xyz_flat[odst], axis=-1)
        ok = ((res_seq[i + 1] == res_seq[i] + 1)
              & (dno <= cfg.bb_no_cutoff) & (dno > 1.5)
              & valid[nsrc] & valid[odst])
        bb_no = np.stack([nsrc[ok], odst[ok]], axis=-1).astype(np.int32)
    else:
        bb_no = np.zeros((0, 2), dtype=np.int32)
    return inter, pipi, bb_no


def featurize_frame(res_type_og, chain_id_og, cg_xyz_og, xyz14, cfg: FeaturizeConfig | None = None,
                    prot_idx: int = 0):
    """Build one training example from a single frame.

    Args:
      res_type_og: [L+2] residue-type ids including the two global-terminal
        residues (which only contribute their C-alpha as reference frames).
      chain_id_og: [L+2] chain ids.
      cg_xyz_og: [L+2, 3] C-alpha trace in Å.
      xyz14: [L, 14, 3] heavy-atom positions of the modeled residues, Å.
      cfg: cutoffs.
      prot_idx: integer id of the protein this frame belongs to.

    Returns a dict of unpadded numpy arrays (see data/batch.py for padding).
    """
    cfg = cfg or FeaturizeConfig()
    res_type = np.asarray(res_type_og[1:-1], dtype=np.int32)
    chain_id = np.asarray(chain_id_og[1:-1], dtype=np.int32)
    L = len(res_type)

    atom_mask = R.ATOM14_EXISTS[res_type]
    ic = np_extract_ic(xyz14.astype(np.float64), cg_xyz_og.astype(np.float64), res_type, wrap=True)

    # interior chain endpoints: residues whose prev/next CG belongs to a
    # different chain — their ic rows reference a foreign frame, so they are
    # masked from the ic loss and zeroed in the xyz loss (reference:
    # utils/protein_module.py:754-765).
    endpoint = np.zeros(L, dtype=bool)
    endpoint |= chain_id_og[1:-1] != chain_id_og[:-2]
    endpoint |= chain_id_og[1:-1] != chain_id_og[2:]
    ic_mask = R.IC_MASK[res_type] & ~endpoint[:, None]

    valid = atom_mask.reshape(-1)
    xyz_flat = xyz14.reshape(-1, 3).astype(np.float64)

    atom_edges = _radius_edges(xyz_flat, valid, cfg.atom_cutoff)
    cg_here = cg_xyz_og[1:-1].astype(np.float64)
    dcg = np.linalg.norm(cg_here[:, None] - cg_here[None, :], axis=-1)
    ci, cj = np.where((dcg <= cfg.cg_cutoff) & np.triu(np.ones((L, L), dtype=bool), k=1))
    cg_edges = np.stack([ci, cj], axis=-1).astype(np.int32)

    bonds = bond_pairs(res_type, chain_id, order=cfg.bond_order)
    inter, pipi, bb_no = interaction_lists(res_type, chain_id, xyz_flat, valid, cfg)

    # non-bonded pairs for the steric-clash loss: radius-graph pairs that are
    # not order-2 covalent pairs (the reference recomputes this set
    # difference every training step, utils/train_module.py:330-333; here it
    # is a one-time host-side set op).
    N = L * R.MAX_ATOMS
    ek = atom_edges[:, 0].astype(np.int64) * N + atom_edges[:, 1]
    bk = bonds[:, 0].astype(np.int64) * N + bonds[:, 1]
    clash = atom_edges[~np.isin(ek, bk)].reshape(-1, 2).astype(np.int32)

    return {
        "clash_edges": clash,
        "res_type": res_type,
        "chain_id": chain_id,
        "cg_xyz_og": cg_xyz_og.astype(np.float32),
        "xyz14": xyz14.astype(np.float32),
        "ic": ic.astype(np.float32),
        "ic_mask": ic_mask,
        "atom_mask": atom_mask,
        "endpoint_mask": endpoint,
        "atom_edges": atom_edges,
        "cg_edges": cg_edges,
        "bond_edges": bonds,
        "inter_edges": inter,
        "pipi_pairs": pipi,
        "bb_no_edges": bb_no,
        "prot_idx": np.int32(prot_idx),
    }
