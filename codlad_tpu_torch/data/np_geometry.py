"""Numpy geometry for host-side featurization.

A copy of codlad_tpu/data/np_geometry.py: numpy mirrors of the internal
coordinate routines (bond angles, dihedrals, NeRF placement, ic <-> xyz14)
that the featurizer and the synthetic generator run on the host.
"""

from __future__ import annotations

import numpy as np

from codlad_tpu_torch.geometry import residues as R

EPS = 1e-8
TWO_PI = 2.0 * np.pi


def np_unit(v):
    # tiny eps only guards all-zero vectors (absent atom slots, masked out)
    return v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-30)


def np_bond_angle(v1, v2):
    cos = np.sum(np_unit(v1) * np_unit(v2), axis=-1)
    return np.arccos(np.clip(cos, -1.0, 1.0))


def np_dihedral(p0, p1, p2, p3):
    b0 = p0 - p1
    b1 = np_unit(p2 - p1)
    b2 = p3 - p2
    v = b0 - np.sum(b0 * b1, axis=-1, keepdims=True) * b1
    w = b2 - np.sum(b2 * b1, axis=-1, keepdims=True) * b1
    x = np.sum(v * w, axis=-1)
    y = np.sum(np.cross(b1, v) * w, axis=-1)
    return np.arctan2(y, x)


def np_rotation_matrix(axis, angle):
    axis = axis / np.sqrt(np.sum(axis * axis, axis=-1, keepdims=True))
    a = np.cos(angle / 2.0)
    res = -axis * np.sin(angle / 2.0)[..., None]
    b, c, d = res[..., 0], res[..., 1], res[..., 2]
    rx = np.stack([a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)], axis=-1)
    ry = np.stack([2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)], axis=-1)
    rz = np.stack([2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c], axis=-1)
    return np.stack([rx, ry, rz], axis=-2)


def np_place_atom(ic, atom1, atom2, atom3):
    dist, ang, tor = ic[..., 0], ic[..., 1], ic[..., 2]
    a = atom2 - atom1
    b = atom2 - atom3
    a = np.where(a == 0.0, a + EPS, a)
    b = np.where(b == 0.0, b + EPS, b)
    d = np.abs(dist)[..., None] * a / np.linalg.norm(a, axis=-1, keepdims=True)
    normal = np.cross(a, b)
    d = np.einsum("...ij,...j->...i", np_rotation_matrix(normal, ang), d)
    d = np.einsum("...ij,...j->...i", np_rotation_matrix(a, tor), d)
    return atom1 + d


def np_ic_to_xyz14(cg_xyz_full, ic, res_type):
    """Numpy twin of internal.ic_to_xyz14; unbatched or batched inputs."""
    squeeze = cg_xyz_full.ndim == 2
    if squeeze:
        cg_xyz_full, ic, res_type = cg_xyz_full[None], ic[None], res_type[None]
    ca_prev, ca_here, ca_next = cg_xyz_full[:, :-2], cg_xyz_full[:, 1:-1], cg_xyz_full[:, 2:]
    n = np_place_atom(ic[:, :, 0], ca_here, ca_prev, ca_next)
    c = np_place_atom(ic[:, :, 1], ca_here, ca_next, ca_prev)
    o = np_place_atom(ic[:, :, 2], c, ca_here, n)

    B, L = res_type.shape
    xyz14 = np.zeros((B, L, R.MAX_ATOMS, 3), dtype=cg_xyz_full.dtype)
    xyz14[:, :, 0], xyz14[:, :, 1], xyz14[:, :, 2], xyz14[:, :, 3] = o, n, c, ca_here
    parents = R.SC_PARENTS[res_type]  # [B, L, 10, 3]
    for k in range(R.MAX_SC):
        trip = parents[:, :, k]
        take = lambda slot: np.take_along_axis(xyz14, slot[..., None, None], axis=2)[:, :, 0]
        atom1, atom2, atom3 = take(trip[..., 2]), take(trip[..., 1]), take(trip[..., 0])
        xyz14[:, :, R.NUM_BB + k] = np_place_atom(ic[:, :, 3 + k], atom1, atom2, atom3)
    return xyz14[0] if squeeze else xyz14


def np_extract_ic(xyz14, cg_xyz_full, res_type, wrap=True):
    """Numpy twin of internal.extract_ic; unbatched or batched inputs."""
    squeeze = cg_xyz_full.ndim == 2
    if squeeze:
        cg_xyz_full, xyz14, res_type = cg_xyz_full[None], xyz14[None], res_type[None]
    ca_prev, ca_here, ca_next = cg_xyz_full[:, :-2], cg_xyz_full[:, 1:-1], cg_xyz_full[:, 2:]
    o, n, c = xyz14[:, :, 0], xyz14[:, :, 1], xyz14[:, :, 2]

    n_ic = np.stack([
        np.linalg.norm(n - ca_here, axis=-1),
        np_bond_angle(n - ca_here, ca_prev - ca_here),
        np_dihedral(n, ca_here, ca_prev, ca_next),
    ], axis=-1)
    c_ic = np.stack([
        np.linalg.norm(c - ca_here, axis=-1),
        np_bond_angle(c - ca_here, ca_next - ca_here),
        np_dihedral(c, ca_here, ca_next, ca_prev),
    ], axis=-1)
    o_ic = np.stack([
        np.linalg.norm(o - c, axis=-1),
        np_bond_angle(o - c, ca_here - c),
        np_dihedral(o, c, ca_here, n),
    ], axis=-1)

    parents = R.SC_PARENTS[res_type]
    take = lambda slot: np.take_along_axis(xyz14, slot[..., None], axis=2)
    a4, a3, a2 = take(parents[..., 0]), take(parents[..., 1]), take(parents[..., 2])
    a1 = xyz14[:, :, R.NUM_BB:]
    tor = np_dihedral(a1, a2, a3, a4)
    tor = (tor + np.pi) % TWO_PI - np.pi
    sc_ic = np.stack([
        np.linalg.norm(a1 - a2, axis=-1),
        np_bond_angle(a1 - a2, a3 - a2),
        tor,
    ], axis=-1)
    ic = np.concatenate([np.stack([n_ic, c_ic, o_ic], axis=2), sc_ic], axis=2)
    if wrap:
        ic[..., 1:] = ic[..., 1:] % TWO_PI
    return (ic[0] if squeeze else ic).astype(np.float32)
