"""e3nn basis conventions, reconstructed from first principles (numpy).

Counterpart of codlad_tpu/convert/e3nn_basis.py. The reference's
equivariant stack runs on e3nn (reference models/gcn_nn.py:181-219:
o3.FullyConnectedTensorProduct on o3.spherical_harmonics); importing its
trained weights needs the relation between e3nn's basis and this
package's (nn/irreps.py):

  * e3nn's real spherical harmonics take y as the polar axis and order the
    components m = -l..l: Y1 = sqrt(3) (x, y, z), as here, and Y2 =
    (√15 xz, √15 xy, √5/2 (3y²−1), √15 yz, √15/2 (z²−x²)), a signed
    permutation and a 2 x 2 mix of this package's z-polar l = 2 basis;
  * its Wigner-3j tensors are SU(2) Clebsch-Gordan coefficients (Racah's
    formula) conjugated into the real basis by its change of basis (the
    (-i)^l phase makes them real), at unit Frobenius norm.

Per tensor-product path (l1, l2, l3) this gives `basis_change(l)` (P_l
with ours = P_l e3nn), `path_ratio` (the ±1 between e3nn's w3j in this
basis and this package's coupling constant, `nn/irreps.coupling_tensor`,
which the port commits rather than solves) and `path_weight_multiplier` =
ratio x sqrt(2 l3 + 1) (e3nn's 'component' irrep normalisation; both
share the 'element' path fan). Multiplying an imported weight generator's
per-path outputs by it makes FullyConnectedTP reproduce e3nn's tensor
product for the l <= 1 node features of every model here.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from math import factorial

import numpy as np

from codlad_tpu_torch.nn.irreps import Irreps, _sh_np, coupling_tensor, tp_paths


def _f(n):
    return factorial(round(n))


def su2_cg_coeff(j1, m1, j2, m2, j3, m3):
    """<j1 m1 j2 m2 | j3 m3> by Racah's formula (exact rationals)."""
    if m3 != m1 + m2:
        return 0.0
    vmin = int(max(-j1 + j2 + m3, -j1 + m1, 0))
    vmax = int(min(j2 + j3 + m1, j3 - j1 + j2, j3 + m3))
    C = (2.0 * j3 + 1.0) * float(Fraction(
        _f(j3 + j1 - j2) * _f(j3 - j1 + j2) * _f(j1 + j2 - j3) * _f(j3 + m3) * _f(j3 - m3),
        _f(j1 + j2 + j3 + 1) * _f(j1 - m1) * _f(j1 + m1) * _f(j2 - m2) * _f(j2 + m2)))
    S = 0.0
    for v in range(vmin, vmax + 1):
        S += (-1.0) ** int(v + j2 + m2) * float(Fraction(
            _f(j2 + j3 + m1 - v) * _f(j1 - m1 + v),
            _f(v) * _f(j3 - j1 + j2 - v) * _f(j3 + m3 - v) * _f(v + j1 - j2 - m3)))
    return np.sqrt(C) * S


def su2_cg(j1, j2, j3):
    """[2j1+1, 2j2+1, 2j3+1] tensor of CG coefficients, m-major order."""
    out = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1))
    for i1, m1 in enumerate(range(-j1, j1 + 1)):
        for i2, m2 in enumerate(range(-j2, j2 + 1)):
            for i3, m3 in enumerate(range(-j3, j3 + 1)):
                out[i1, i2, i3] = su2_cg_coeff(j1, m1, j2, m2, j3, m3)
    return out


def change_basis_real_to_complex(l):
    """e3nn's q (complex SH = q @ real SH), with the (-i)^l phase that makes
    the conjugated CG tensors real."""
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = 1 / np.sqrt(2)
        q[l + m, l - abs(m)] = -1j / np.sqrt(2)
    q[l, l] = 1
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = (-1) ** m / np.sqrt(2)
        q[l + m, l - abs(m)] = 1j * (-1) ** m / np.sqrt(2)
    return (-1j) ** l * q


@functools.lru_cache(maxsize=None)
def e3nn_w3j(l1, l2, l3):
    """e3nn's real Wigner-3j tensor (unit Frobenius norm) in its SH basis,
    or None where the triple is not allowed."""
    if not abs(l1 - l2) <= l3 <= l1 + l2:
        return None
    Q1, Q2, Q3 = (change_basis_real_to_complex(l) for l in (l1, l2, l3))
    C = su2_cg(l1, l2, l3).astype(np.complex128)
    # of every conj / transpose placement, only this one and its conjugate
    # give real tensors invariant in e3nn's basis, and they agree
    C = np.einsum("ai,bj,ck,abc->ijk", Q1, Q2, Q3.conj(), C)
    assert np.abs(C.imag).max() < 1e-10, (l1, l2, l3, np.abs(C.imag).max())
    C = C.real
    return C / np.linalg.norm(C)


def e3nn_sh_np(vec):
    """e3nn's component-normalised real SH, l = 0..2, of vec [..., 3]
    (normalised here): 1 | (x, y, z) | (xz, xy, 3y²-1, yz, z²-x²)."""
    v = vec / np.linalg.norm(vec, axis=-1, keepdims=True)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    s3, s15, s5 = np.sqrt(3.0), np.sqrt(15.0), np.sqrt(5.0)
    return np.stack([np.ones_like(x), s3 * x, s3 * y, s3 * z, s15 * x * z, s15 * x * y,
                     (s5 / 2.0) * (3.0 * y * y - 1.0), s15 * y * z,
                     (s15 / 2.0) * (z * z - x * x)], axis=-1)


_L_SLICE = {0: slice(0, 1), 1: slice(1, 4), 2: slice(4, 9)}


@functools.lru_cache(maxsize=None)
def basis_change(l):
    """Orthogonal P_l with this package's SH(u) = P_l @ e3nn's SH(u)."""
    if l == 0:
        return np.ones((1, 1))
    u = np.random.default_rng(7).normal(size=(256, 3))
    A = e3nn_sh_np(u)[:, _L_SLICE[l]]
    B = _sh_np(u)[:, _L_SLICE[l]]
    P, *_ = np.linalg.lstsq(A, B, rcond=None)
    P = P.T
    assert np.abs(A @ P.T - B).max() < 1e-9, l
    assert np.abs(P @ P.T - np.eye(2 * l + 1)).max() < 1e-9, l
    return P


@functools.lru_cache(maxsize=None)
def path_ratio(l1, l2, l3):
    """The sign between e3nn's w3j in this basis and this package's coupling
    constant: both are unit tensors of one invariant line, so their inner
    product is ±1."""
    W = e3nn_w3j(l1, l2, l3)
    C_ref = np.einsum("ia,jb,kc,abc->ijk", basis_change(l1), basis_change(l2),
                      basis_change(l3), W)
    r = float(np.sum(C_ref * coupling_tensor(l1, l2, l3)))
    assert abs(abs(r) - 1.0) < 1e-6, (l1, l2, l3, r)
    return float(np.sign(r))


def path_weight_multiplier(l1, l2, l3):
    """The scale of an imported e3nn per-path weight: sign x sqrt(2 l3 + 1)."""
    return path_ratio(l1, l2, l3) * np.sqrt(2 * l3 + 1)


def tp_weight_corrections(in_irreps, sh_irreps, out_irreps):
    """Multiplier of each scalar TP weight (length weight_numel), in the path
    order of tp_paths (e3nn's instruction order for a fully connected TP:
    input outer, harmonic, output inner)."""
    in_ir, sh_ir, out_ir = Irreps(in_irreps), Irreps(sh_irreps), Irreps(out_irreps)
    mults = []
    for i, j, k in tp_paths(in_ir, sh_ir, out_ir):
        mul1, l1, _ = in_ir[i]
        mul3, l3, _ = out_ir[k]
        mults.append(np.full(mul1 * mul3, path_weight_multiplier(l1, sh_ir[j][1], l3)))
    return np.concatenate(mults)


def correct_weight_dense(dense, in_irreps, sh_irreps, out_irreps):
    """The per-path correction applied to an imported weight generator's
    final Dense {kernel [in, numel], bias [numel]}."""
    m = tp_weight_corrections(in_irreps, sh_irreps, out_irreps)
    assert dense["kernel"].shape[-1] == m.size, (dense["kernel"].shape, m.size)
    return {"kernel": dense["kernel"] * m[None, :], "bias": dense["bias"] * m}
