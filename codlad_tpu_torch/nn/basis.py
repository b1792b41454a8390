"""Radial bases and the invariant message block of the IC decoder.

Counterpart of codlad_tpu/nn/basis.py: Gaussian smearing, the PaiNN sinc
radial basis with a cosine cutoff envelope, and phi(s_j) * W(d_ij).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from codlad_tpu_torch.nn.layers import linear


def swish(x):
    return x * torch.sigmoid(x)


class GaussianSmearing(nn.Module):
    """RBF embedding of edge distances on [start, stop]."""

    def __init__(self, start=0.0, stop=5.0, num_gaussians=50):
        super().__init__()
        self.offset = np.linspace(start, stop, num_gaussians)
        self.coeff = -0.5 / float(self.offset[1] - self.offset[0]) ** 2

    def forward(self, dist):
        diff = dist[..., None] - torch.as_tensor(self.offset, dtype=dist.dtype,
                                                 device=dist.device)
        return torch.exp(self.coeff * diff ** 2)


def painn_radial_basis(dist, n_rbf, cutoff):
    """sin(n pi d / cutoff) / d, with the sinc limit at d = 0."""
    d = dist[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=dist.dtype, device=dist.device)
    coef = n * math.pi / cutoff
    denom = torch.where(d == 0, torch.ones_like(d), d)
    num = torch.where(d == 0, coef, torch.sin(coef * d))
    return torch.where(d >= cutoff, torch.zeros_like(num), num / denom)


def cosine_envelope(d, cutoff):
    out = 0.5 * (torch.cos(math.pi * d / cutoff) + 1.0)
    return torch.where(d >= cutoff, torch.zeros_like(out), out)


class DistanceEmbed(nn.Module):
    def __init__(self, n_rbf, cutoff, feat_dim, gen):
        super().__init__()
        self.n_rbf, self.cutoff = n_rbf, cutoff
        self.Dense_0 = linear(n_rbf, feat_dim, gen, init="lecun")

    def forward(self, dist):
        feats = self.Dense_0(painn_radial_basis(dist, self.n_rbf, self.cutoff))
        return feats * cosine_envelope(dist, self.cutoff)[..., None]


class InvariantMessage(nn.Module):
    """phi(s_j) * W(d_ij) over a padded edge list: node scalars [B, N, in],
    distances [B, E] and an EdgeOps -> per-edge messages [B, E, out]."""

    def __init__(self, in_feat_dim, out_feat_dim, n_rbf, cutoff, gen):
        super().__init__()
        self.Dense_0 = linear(in_feat_dim, in_feat_dim, gen, init="lecun")
        self.Dense_1 = linear(in_feat_dim, out_feat_dim, gen, init="lecun")
        self.DistanceEmbed_0 = DistanceEmbed(n_rbf, cutoff, out_feat_dim, gen)

    def forward(self, s, dist, ops):
        phi = self.Dense_1(swish(self.Dense_0(s)))
        return ops.gather_dst(phi) * self.DistanceEmbed_0(dist)
