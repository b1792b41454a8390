"""Evaluation metrics: RMSD, GED, clash ratio, interaction scores and
covalent-graph validity, on padded [B, L, 14, 3] frames with masks.

Torch twin of codlad_tpu/eval/metrics.py, with `diversity` (DIV) over an
ensemble. Runs on whatever device the frames lie on.
"""

from __future__ import annotations

import numpy as np
import torch

from codlad_tpu_torch.geometry import residues as R

EPS = 1e-7


def _masked_center(x, m):
    w = m[..., None]
    return (x * w).sum(-2) / torch.clamp(w.sum(-2), min=1.0)


def kabsch_rmsd(x, y, mask):
    """Aligned RMSD between point sets x, y: [..., N, 3] with mask [..., N]."""
    mf = mask.to(x.dtype)
    xc = (x - _masked_center(x, mf)[..., None, :]) * mf[..., None]
    yc = (y - _masked_center(y, mf)[..., None, :]) * mf[..., None]
    # C = sum_n x_n y_n^T; the rotation mapping y onto x is U diag(1, 1, d) V^T
    C = torch.einsum("...ni,...nj->...ij", xc, yc)
    U, _, Vt = torch.linalg.svd(C)
    det = torch.linalg.det(U @ Vt)
    one = torch.ones_like(det)
    D = torch.stack([one, one, det], dim=-1)
    Rm = torch.einsum("...ij,...j,...jk->...ik", U, D, Vt)
    y_rot = torch.einsum("...ij,...nj->...ni", Rm, yc)
    n = torch.clamp(mf.sum(-1), min=1.0)
    return torch.sqrt((((y_rot - xc) ** 2).sum(-1) * mf).sum(-1) / n)


def unaligned_rmsd(x, y, mask):
    """Per-frame sqrt(mean |x - y|^2) over masked atoms."""
    mf = mask.to(x.dtype)
    n = torch.clamp(mf.sum(-1), min=1.0)
    return torch.sqrt((((x - y) ** 2).sum(-1) * mf).sum(-1) / n)


def _flat(xyz14):
    return xyz14.reshape(xyz14.shape[0], -1, 3)


def _take(flat, col):
    """flat [B, N, 3], col [B, E] -> [B, E, 3]."""
    return torch.gather(flat, 1, col.long()[..., None].expand(-1, -1, 3))


def _edge_dist(flat, edges, mask):
    d = torch.sqrt(((_take(flat, edges[..., 0]) - _take(flat, edges[..., 1])) ** 2).sum(-1)
                   + EPS)
    return d, mask.to(d.dtype)


def ged_score(xyz14_gen, xyz14_ref, bond_edges, bond_mask):
    """Mean squared bonded-distance error."""
    g, m = _edge_dist(_flat(xyz14_gen), bond_edges, bond_mask)
    r, _ = _edge_dist(_flat(xyz14_ref), bond_edges, bond_mask)
    return ((g - r) ** 2 * m).sum() / torch.clamp(m.sum(), min=1.0)


def clash_ratio(xyz14_gen, clash_edges, clash_mask, bb_no_edges, bb_no_mask, cutoff=1.2):
    """Fraction of non-bonded pairs closer than cutoff, plus the backbone
    N-O fraction."""
    d, m = _edge_dist(_flat(xyz14_gen), clash_edges, clash_mask)
    nbr = ((d < cutoff) * m).sum() / torch.clamp(m.sum(), min=1.0)
    d2, m2 = _edge_dist(_flat(xyz14_gen), bb_no_edges, bb_no_mask)
    bb = ((d2 < cutoff) * m2).sum() / torch.clamp(m2.sum(), min=1.0)
    return nbr + bb


def interaction_scores(xyz14_gen, inter_edges, inter_mask, pipi_pairs, pipi_mask):
    """(weighted interaction + pi-pi hinge score, pi-pi score)."""
    flat = _flat(xyz14_gen)
    d, m = _edge_dist(flat, inter_edges, inter_mask)
    n_inter = m.sum()
    c0 = 0.5 * (_take(flat, pipi_pairs[..., 0]) + _take(flat, pipi_pairs[..., 1]))
    c1 = 0.5 * (_take(flat, pipi_pairs[..., 2]) + _take(flat, pipi_pairs[..., 3]))
    pd = torch.sqrt(((c0 - c1) ** 2).sum(-1) + EPS)
    pm = pipi_mask.to(pd.dtype)
    n_pipi = pm.sum()
    n_tot = torch.clamp(n_inter + n_pipi, min=1.0)
    inter = (torch.relu(d - 4.0) * m).sum() / torch.clamp(n_inter, min=1.0)
    pipi = (torch.relu(pd - 6.0) * pm).sum() / torch.clamp(n_pipi, min=1.0)
    return inter * n_inter / n_tot + pipi * n_pipi / n_tot, pipi


_CUTOFF = np.array([R.COVALENT_CUTOFF.get(i, 1.5) for i in range(120)], np.float32)


def graph_validity(xyz14_gen, xyz14_ref, res_type, atom_mask, scale=1.3, chunk=1024):
    """Covalent bond-graph match against the reference structure: bonds are
    pairwise distances below the summed covalent cutoffs * scale. Returns
    per frame (valid = 1.0 if the graphs match exactly, |sum(ref - gen)| /
    sum(ref)). Rows go in chunks of `chunk` atoms, as the JAX scan does."""
    B = xyz14_gen.shape[0]
    dev = xyz14_gen.device
    z = torch.as_tensor(R.ATOM14_ATOMIC_NUM, device=dev)[res_type.long()].reshape(B, -1)
    mask = atom_mask.reshape(B, -1).bool()
    cut = torch.as_tensor(_CUTOFF, device=dev)[z]
    N = mask.shape[1]
    xg, xr = _flat(xyz14_gen), _flat(xyz14_ref)
    diff = torch.zeros(B, dtype=torch.int64, device=dev)
    net, nref = torch.zeros_like(diff), torch.zeros_like(diff)
    cols = torch.arange(N, device=dev)
    for s in range(0, N, chunk):
        e = min(s + chunk, N)
        rows = torch.arange(s, e, device=dev)
        cutoff = (cut[:, s:e, None] + cut[:, None, :]) * scale
        pm = mask[:, s:e, None] & mask[:, None, :] & (rows[:, None] != cols[None, :])[None]

        def bonds(x):
            d = torch.sqrt(((x[:, s:e, None] - x[:, None, :]) ** 2).sum(-1) + EPS)
            return (d < cutoff) & pm

        bg, br = bonds(xg), bonds(xr)
        diff += (bg != br).sum((1, 2))
        net += (br.long() - bg.long()).sum((1, 2))
        nref += br.sum((1, 2))
    valid = (diff == 0).to(torch.float32)
    ratio = net.abs().to(torch.float32) / torch.clamp(nref, min=1).to(torch.float32)
    return valid, ratio


def diversity(gen_ensemble, ref, mask):
    """DIV = 1 - rmsd_gen / rmsd_ref over an ensemble (reference
    test.py:81-95): rmsd_ref = mean aligned RMSD of the samples against the
    reference, rmsd_gen = mean aligned RMSD against the ensemble mean.
    gen_ensemble [G, B, N, 3] flat atoms, ref [B, N, 3], mask [B, N] ->
    (div, rmsd_ref, rmsd_gen), 0-d tensors."""
    G = gen_ensemble.shape[0]
    rmsd_ref = torch.stack([kabsch_rmsd(ref, gen_ensemble[g], mask) for g in range(G)]).mean()
    mean_gen = gen_ensemble.mean(0)
    rmsd_gen = torch.stack([kabsch_rmsd(mean_gen, gen_ensemble[g], mask)
                            for g in range(G)]).mean()
    return 1.0 - rmsd_gen / torch.clamp(rmsd_ref, min=1e-8), rmsd_ref, rmsd_gen
