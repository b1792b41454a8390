"""Minimal real-irreps algebra for the encoder's fixed ladders.

Counterpart of codlad_tpu/nn/irreps.py: `Irreps` (tuples of (mul, l, p)
over flat mul-major features), real spherical harmonics up to l = 2
('component' normalisation), `wigner_d_np`, `tp_paths`, and the coupling
tensors ("Wigner 3j") of the ladder's (l1, l2, l3) triples.

The JAX package solves each coupling tensor at import from an SVD null
space and fixes its sign by "the first element with the largest magnitude
positive". Entries of equal magnitude tie there, so a LAPACK that rounds
differently could pick another element, flip a path's sign and give wrong
structures from trained weights with no error. The port therefore solves
nothing: `coupling_tensor` returns constants printed from the JAX package
(float64 reprs, bit-exact), and a test holds them equal to it.
"""

from __future__ import annotations

import numpy as np
import torch


class Irreps(tuple):
    """Tuple of (mul, l, p) with p in {+1, -1}."""

    def __new__(cls, spec):
        if isinstance(spec, str):
            parts = []
            for tok in spec.replace(" ", "").split("+"):
                mul, lp = tok.split("x")
                parts.append((int(mul), int(lp[:-1]), {"e": 1, "o": -1}[lp[-1]]))
            spec = parts
        return super().__new__(cls, tuple(tuple(x) for x in spec))

    @property
    def dim(self):
        return sum(mul * (2 * l + 1) for mul, l, p in self)

    @property
    def num_irreps(self):
        return sum(mul for mul, _, _ in self)

    def slices(self):
        out, i = [], 0
        for mul, l, p in self:
            d = mul * (2 * l + 1)
            out.append(slice(i, i + d))
            i += d
        return out

    def split(self, x):
        """[..., dim] -> a list of [..., mul, 2l+1] blocks."""
        return [x[..., sl].reshape(tuple(x.shape[:-1]) + (mul, 2 * l + 1))
                for (mul, l, p), sl in zip(self, self.slices())]

    @staticmethod
    def merge(blocks):
        return torch.cat([b.reshape(tuple(b.shape[:-2]) + (-1,)) for b in blocks], dim=-1)


SH_IRREPS = Irreps("1x0e + 1x1o + 1x2e")


def sh_l2(vec, normalize=True, eps=1e-12):
    """Real spherical harmonics (l = 0, 1, 2), component normalisation.

    vec [..., 3] -> [..., 9] ordered l=0 | l=1 (x, y, z) | l=2. Zero vectors
    (padded edges) are redirected to x-hat BEFORE the norm, as in the JAX
    package, so that they stay finite."""
    if normalize:
        n2 = torch.sum(vec * vec, dim=-1, keepdim=True)
        fallback = torch.zeros_like(vec)
        fallback[..., 0] = 1.0
        vec = torch.where(n2 > eps, vec, fallback)
        vec = vec / torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True))
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    s3, s15, s5 = float(np.sqrt(3.0)), float(np.sqrt(15.0)), float(np.sqrt(5.0))
    return torch.stack([torch.ones_like(x), s3 * x, s3 * y, s3 * z, s15 * x * y, s15 * y * z,
                        (s5 / 2.0) * (3.0 * z * z - 1.0), s15 * x * z,
                        (s15 / 2.0) * (x * x - y * y)], dim=-1)


def _sh_np(vec):
    v = vec / np.linalg.norm(vec, axis=-1, keepdims=True)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    s3, s15, s5 = np.sqrt(3.0), np.sqrt(15.0), np.sqrt(5.0)
    return np.stack([np.ones_like(x), s3 * x, s3 * y, s3 * z, s15 * x * y, s15 * y * z,
                     (s5 / 2.0) * (3 * z * z - 1), s15 * x * z, (s15 / 2.0) * (x * x - y * y)],
                    axis=-1)


_L_SLICE = {0: slice(0, 1), 1: slice(1, 4), 2: slice(4, 9)}


def wigner_d_np(l, rot):
    """Rotation matrix of degree l in this module's real SH basis (numpy),
    solved from Y_l(R u) = D_l(R) Y_l(u) over sample directions."""
    if l == 0:
        return np.ones((1, 1))
    u = np.random.default_rng(12345).normal(size=(64, 3))
    A = _sh_np(u)[:, _L_SLICE[l]]
    B = _sh_np(u @ rot.T)[:, _L_SLICE[l]]
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T


# codlad_tpu.nn.irreps.coupling_tensor(l1, l2, l3).reshape(-1) for the
# encoder ladder's triples: l1, l3 in {0, 1} (0e, 1o, 1e, 0o features),
# l2 in {0, 1, 2} (the edge harmonics)
_COUPLING = {
    (0, 0, 0): (1.0,),
    (0, 1, 1): (0.5773502691896258, -8.084587564292151e-17, 1.0762344461427932e-17, 3.3811986967298563e-17, 0.5773502691896257, 1.2637589505562036e-16, 8.031739669625103e-17, 7.086474382436253e-17, 0.5773502691896258),
    (1, 0, 1): (0.5773502691896258, -8.084587564292151e-17, 1.0762344461427932e-17, 3.3811986967298563e-17, 0.5773502691896257, 1.2637589505562036e-16, 8.031739669625103e-17, 7.086474382436253e-17, 0.5773502691896258),
    (1, 1, 0): (0.5773502691896258, -8.084587564292151e-17, 1.0762344461427932e-17, 3.3811986967298563e-17, 0.5773502691896257, 1.2637589505562036e-16, 8.031739669625103e-17, 7.086474382436253e-17, 0.5773502691896258),
    (1, 1, 1): (1.7690453871708658e-17, -2.29352986518218e-17, 9.71499985484106e-17, 1.7148515804129977e-16, 3.949003802682486e-17, -0.408248290463863, -1.085516474858433e-16, 0.40824829046386296, -5.0106800392691913e-17, -1.4938136030537487e-17, -3.3138856817947235e-17, 0.40824829046386313, 4.7698365340058827e-17, -6.353361898738518e-17, 8.83518651015662e-17, -0.4082482904638631, -7.185648393164452e-17, -1.0449024487159621e-16, -3.199814818563616e-17, -0.4082482904638629, 4.2596448474643075e-17, 0.4082482904638631, -3.8935089115881626e-17, 5.994616624016664e-17, 5.804936373096165e-18, 6.78773244289617e-18, -5.2129687832738186e-17),
    (1, 2, 1): (2.1466187035787238e-16, 0.31622776601683794, 7.352262105454486e-17, 1.348579370606026e-17, -1.3433287936863573e-17, 2.0192500782444796e-16, -0.18257418583505508, 2.934572632231502e-17, -1.3340955724430687e-16, -2.104050498036188e-16, 1.7185891830858176e-16, 0.31622776601683783, 0.31622776601683805, -1.977885160385825e-16, 1.4359969324089322e-16, 0.3162277660168379, 1.1812122231413704e-16, -2.1310159570594913e-17, -3.092703426742789e-17, -1.7962019379255238e-16, 0.316227766016838, 4.5193125263397956e-17, -0.18257418583505536, -1.531571093907335e-16, -1.110223024625156e-16, -7.285838599102586e-17, -2.081956162374234e-16, -1.0542182649438858e-16, -0.3162277660168377, -7.485507094955331e-17, 6.234782153468026e-18, -9.774660918621842e-17, -1.2787578409967457e-16, 3.365172162380996e-17, 0.31622776601683783, 3.042639549401624e-16, -1.168009192254321e-16, -1.1520372081213787e-16, 0.3651483716701109, 0.31622776601683805, -3.1462940454048784e-16, -1.988012454884868e-17, 5.993911860885334e-17, -4.153031155566174e-19, 1.2996376096727156e-17),
}


def coupling_tensor(l1, l2, l3):
    """Invariant coupling C [(2l1+1), (2l2+1), (2l3+1)], Frobenius norm 1,
    or None where the triple is not allowed. Raises KeyError for an allowed
    triple outside the ladder's (no constant committed)."""
    if not abs(l1 - l2) <= l3 <= l1 + l2:
        return None
    return np.array(_COUPLING[(l1, l2, l3)], np.float64).reshape(2 * l1 + 1, 2 * l2 + 1,
                                                                 2 * l3 + 1)


def tp_paths(in_irreps, sh_irreps, out_irreps):
    """Allowed fully-connected TP paths (i_in, i_sh, i_out)."""
    paths = []
    for i_in, (_, l1, p1) in enumerate(in_irreps):
        for i_sh, (_, l2, p2) in enumerate(sh_irreps):
            for i_out, (_, l3, p3) in enumerate(out_irreps):
                if p1 * p2 == p3 and abs(l1 - l2) <= l3 <= l1 + l2:
                    paths.append((i_in, i_sh, i_out))
    return paths
