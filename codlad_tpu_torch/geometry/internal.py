"""NeRF-style reconstruction of atom14 coordinates from internal coordinates.

Counterpart of `ic_to_xyz14` and the helpers it calls in
codlad_tpu/geometry/internal.py. Each of the 10 side-chain levels places
one atom slot for every residue of the batch at once; the levels run in
order because a parent may be placed at an earlier level. The output
tensor is filled in place.
"""

from __future__ import annotations

import torch

from codlad_tpu_torch.geometry import residues as R

EPS = 1e-8


def rotation_matrix(axis, angle):
    """Euler-Rodrigues rotations (the reference's -sin convention).
    axis [..., 3] (unnormalised), angle [...] -> [..., 3, 3]; near-zero axes
    fall back to x."""
    n2 = torch.sum(axis * axis, dim=-1, keepdim=True)
    fallback = torch.zeros_like(axis)
    fallback[..., 0] = 1.0
    axis = torch.where(n2 > 1e-16, axis, fallback)
    axis = axis / torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
    a = torch.cos(angle / 2.0)
    b, c, d = (-axis * torch.sin(angle / 2.0)[..., None]).unbind(-1)
    rx = torch.stack([a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)], dim=-1)
    ry = torch.stack([2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)], dim=-1)
    rz = torch.stack([2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c], dim=-1)
    return torch.stack([rx, ry, rz], dim=-2)


def place_atom(ic, atom1, atom2, atom3):
    """Place an atom at (dist, angle, torsion) = ic[..., :3] from atom1,
    relative to the (atom1, atom2, atom3) frame."""
    dist, ang, tor = ic.unbind(-1)
    a = atom2 - atom1
    b = atom2 - atom3
    a = torch.where(a == 0.0, a + EPS, a)
    b = torch.where(b == 0.0, b + EPS, b)
    d = torch.abs(dist)[..., None] * a / torch.linalg.norm(a, dim=-1, keepdim=True)
    normal = torch.cross(a, b, dim=-1)
    d = torch.einsum("...ij,...j->...i", rotation_matrix(normal, ang), d)
    d = torch.einsum("...ij,...j->...i", rotation_matrix(a, tor), d)
    return atom1 + d


def ic_to_xyz14(cg_xyz_full, ic, res_type):
    """cg_xyz_full [B, L+2, 3] C-alpha trace (the two ends are reference
    frames only), ic [B, L, 13, 3], res_type [B, L] -> xyz14 [B, L, 14, 3]
    in slot order O, N, C, CA, side chain. Slots a residue type lacks hold
    garbage; mask with `residues.ATOM14_EXISTS[res_type]`."""
    ca_prev, ca_here, ca_next = cg_xyz_full[:, :-2], cg_xyz_full[:, 1:-1], cg_xyz_full[:, 2:]
    n = place_atom(ic[:, :, 0], ca_here, ca_prev, ca_next)
    c = place_atom(ic[:, :, 1], ca_here, ca_next, ca_prev)
    o = place_atom(ic[:, :, 2], c, ca_here, n)

    B, L = res_type.shape
    xyz14 = torch.zeros((B, L, R.MAX_ATOMS, 3), dtype=cg_xyz_full.dtype,
                        device=cg_xyz_full.device)
    for slot, v in enumerate((o, n, c, ca_here)):
        xyz14[:, :, slot] = v
    parents = torch.as_tensor(R.SC_PARENTS, device=res_type.device)[res_type.long()]

    def take(slot):
        return torch.gather(xyz14, 2, slot.long()[..., None, None].expand(B, L, 1, 3))[:, :, 0]

    for k in range(R.MAX_SC):
        trip = parents[:, :, k]  # (a, b, c), read right to left
        xyz14[:, :, R.NUM_BB + k] = place_atom(ic[:, :, 3 + k], take(trip[..., 2]),
                                               take(trip[..., 1]), take(trip[..., 0]))
    return xyz14
