"""Stage-1 (VQ-VAE) multi-term reconstruction loss on the padded layout.

Counterpart of codlad_tpu/train/losses.py (the reference's 7-term objective):

  loss = 5*bond + angle + delta*torsion + eta*xyz + omega*graph
         + zeta*clash + theta*interaction + vq_commit + beta*KL

with the same normalisations on masked padded tensors: ic terms divide by
the count of valid ic rows, the xyz term averages squared residuals over
existing atoms with interior-endpoint residues zeroed (but counted), and
edge terms are masked means over their padded lists. `ic_to_xyz14` runs
inside the autograd graph. The KL terms serve the fgvae/GenZProt modes;
eval/harness.py reads its bond/angle/torsion and xyz metrics from here.
Under Stage-1 data parallelism every count is the global batch's
(train/mesh.data_sum), so the ranks' losses sum to the global batch's.
"""

from __future__ import annotations

import dataclasses

import torch

from codlad_tpu_torch.geometry.internal import ic_to_xyz14
from codlad_tpu_torch.train.mesh import data_sum

EPS = 1e-7


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """(reference train_vqvae.py:349-356 defaults)."""

    beta: float = 1e-4    # KL
    delta: float = 1.0    # torsion
    eta: float = 1.0      # xyz
    zeta: float = 5.0     # clash
    omega: float = 3.0    # graph (GED)
    theta: float = 0.0    # interaction

    def dynamic(self, epoch, dynamic_loss=True):
        """Reference schedule: epoch 0 disables xyz+clash; epoch > 20
        doubles clash."""
        eta, zeta = self.eta, self.zeta
        if dynamic_loss and epoch == 0:
            eta, zeta = 0.0, 0.0
        if dynamic_loss and epoch > 20:
            zeta = zeta * 2
        return dataclasses.replace(self, eta=eta, zeta=zeta)


def _take(xyz_flat, idx):
    """xyz_flat [B, N, 3] at per-sample indices idx [B, E] -> [B, E, 3]."""
    return torch.gather(xyz_flat, 1, idx.long()[..., None].expand(*idx.shape, 3))


def _masked_edge_dist(xyz_flat, edges, mask, eps=EPS):
    """edges [B, E, 2] into per-sample flat atom space; xyz_flat [B, N, 3]."""
    d = torch.sqrt(((_take(xyz_flat, edges[..., 0]) - _take(xyz_flat, edges[..., 1])) ** 2)
                   .sum(-1) + eps)
    return d, mask.to(d.dtype)


def _count(m):
    """A mask's count, over the global batch under Stage-1 data parallelism
    (train/mesh.data_sum): each rank's mean is then its part of the global
    one."""
    return data_sum(m.sum())


def _mean(x, m):
    return (x * m).sum() / torch.clamp(_count(m), min=1.0)


def _cos(x):
    """cos in float64, rounded to x's dtype. The chord sqrt(2 (1 - cos d))
    and its gradient sin(d) / chord turn on the last ulp of cos(d) where the
    error d is below ~3e-4 rad (a trained model hits many angles that
    closely); torch's f32 cos is off by an ulp there ~8% of the time, the
    rounded f64 one agrees with XLA's f32 cos but for a few in 1e5."""
    return torch.cos(x.double()).to(x.dtype)


def ic_terms(batch, ic_recon):
    """(bond, angle, torsion): squared bond error and chord lengths of the
    angle and torsion errors, each summed over valid ic rows / their count."""
    ic = batch["ic"]
    ic_mask = batch["ic_mask"].to(ic.dtype)
    natom = torch.clamp(_count(ic_mask), min=1.0)
    d_bond = (ic_recon[..., 0] - ic[..., 0]) * ic_mask
    bond = (d_bond ** 2).sum() / natom
    angle = (torch.sqrt(2 * (1 - _cos(ic[..., 1] - ic_recon[..., 1])) + EPS)
             * ic_mask).sum() / natom
    torsion = (torch.sqrt(2 * (1 - _cos(ic[..., 2] - ic_recon[..., 2])) + EPS)
               * ic_mask).sum() / natom
    return bond, angle, torsion


def xyz_term(atom_mask, xyz_gen, xyz_ref):
    """Mean squared coordinate error over existing atoms."""
    m = atom_mask.to(xyz_gen.dtype)
    sq = ((xyz_gen - xyz_ref) ** 2).sum(-1)
    return (sq * m).sum() / torch.clamp(_count(m), min=1.0)


def vqvae_loss_terms(batch, ic_recon, weights: LossWeights):
    """Geometric losses shared by VQ-VAE and GenZProt training.

    Returns (recon_loss, metrics dict). VQ/KL terms are added by callers."""
    B, L = batch["res_type"].shape
    ic = batch["ic"]
    loss_bond, loss_angle, loss_torsion = ic_terms(batch, ic_recon)

    # Cartesian rebuild + xyz loss; interior-endpoint residues are zeroed
    # on both sides but still counted
    xyz_recon = ic_to_xyz14(batch["cg_xyz_og"], ic_recon, batch["res_type"])
    atom_mask = batch["atom_mask"].to(ic.dtype)
    keep = (1.0 - batch["endpoint_mask"].to(ic.dtype))[..., None] * atom_mask
    xyz_ref = batch["xyz14"] * keep[..., None]
    xyz_gen = xyz_recon * keep[..., None]
    loss_xyz = xyz_term(atom_mask, xyz_gen, xyz_ref)

    # flat per-sample atom space for edge terms
    N = L * batch["xyz14"].shape[2]
    gen_flat = xyz_gen.reshape(B, N, 3)
    ref_flat = xyz_ref.reshape(B, N, 3)

    gen_d, bmask = _masked_edge_dist(gen_flat, batch["bond_edges"], batch["bond_edges_mask"])
    ref_d, _ = _masked_edge_dist(ref_flat, batch["bond_edges"], batch["bond_edges_mask"])
    loss_graph = _mean((gen_d - ref_d) ** 2, bmask)

    clash_d, cmask = _masked_edge_dist(gen_flat, batch["clash_edges"],
                                       batch["clash_edges_mask"])
    loss_nbr = _mean(torch.relu(2.0 - clash_d), cmask)
    no_d, nmask = _masked_edge_dist(gen_flat, batch["bb_no_edges"], batch["bb_no_edges_mask"])
    loss_bb_no = _mean(torch.relu(2.2 - no_d), nmask)
    loss_clash = loss_nbr + loss_bb_no

    # interaction score: contacts and pi-pi pairs, two means weighted by counts
    int_d, imask = _masked_edge_dist(gen_flat, batch["inter_edges"], batch["inter_edges_mask"])
    n_inter = _count(imask)
    pp = batch["pipi_pairs"]
    ppm = batch["pipi_pairs_mask"].to(ic.dtype)
    c0 = 0.5 * (_take(gen_flat, pp[..., 0]) + _take(gen_flat, pp[..., 1]))
    c1 = 0.5 * (_take(gen_flat, pp[..., 2]) + _take(gen_flat, pp[..., 3]))
    pp_d = torch.sqrt(((c0 - c1) ** 2).sum(-1) + EPS)
    n_pipi = _count(ppm)
    n_tot = torch.clamp(n_inter + n_pipi, min=1.0)
    loss_inter = (_mean(torch.relu(int_d - 4.0), imask) * n_inter / n_tot
                  + _mean(torch.relu(pp_d - 6.0), ppm) * n_pipi / n_tot)

    w = weights
    recon = (5.0 * loss_bond + loss_angle + w.delta * loss_torsion
             + w.eta * loss_xyz + w.omega * loss_graph + w.zeta * loss_clash
             + w.theta * loss_inter)
    metrics = {"bond": loss_bond, "angle": loss_angle, "torsion": loss_torsion,
               "xyz": loss_xyz, "graph": loss_graph, "clash": loss_clash,
               "inter": loss_inter, "recon": recon}
    return recon, metrics


def _mask_gaussian_inputs(mask, mu, sigma):
    """Replace padded positions with the standard normal before any ratio:
    a masked-out `0 * term` cannot rescue an overflowed `term` (inf * 0 =
    NaN), so the inputs themselves must be neutral there."""
    m = mask.bool()[..., None]
    return (torch.where(m, mu, torch.zeros_like(mu)),
            torch.where(m, sigma, torch.ones_like(sigma)))


def kl_standard_normal(mu, sigma, mask=None):
    """KL(N(mu, sigma) || N(0, 1)) summed over channels, masked mean over
    residues."""
    if mask is not None:
        mu, sigma = _mask_gaussian_inputs(mask, mu, sigma)
    kl = -0.5 * torch.sum(1 + torch.log(sigma ** 2 + 1e-20) - mu ** 2 - sigma ** 2, dim=-1)
    if mask is None:
        return kl.mean()
    m = mask.to(kl.dtype)
    return (kl * m).sum() / torch.clamp(_count(m), min=1.0)


def kl_gaussians(mu1, sigma1, mu2, sigma2, mask=None):
    """KL between diagonal Gaussians, the GenZProt prior term (with the
    reference's sigma2-not-squared quirk in the mean term)."""
    if mask is not None:
        mu1, sigma1 = _mask_gaussian_inputs(mask, mu1, sigma1)
        mu2, sigma2 = _mask_gaussian_inputs(mask, mu2, sigma2)
    term = (
        (sigma1 ** 2 / (sigma2 ** 2 + 1e-20)).sum(-1)
        + ((mu1 - mu2) ** 2 / (sigma2 + 1e-20)).sum(-1)
        + torch.log(sigma2 ** 2 + 1e-20).sum(-1)
        - torch.log(sigma1 ** 2 + 1e-20).sum(-1)
        - mu1.shape[-1]
    ) * 0.5
    if mask is None:
        return term.mean()
    m = mask.to(term.dtype)
    return (term * m).sum() / torch.clamp(_count(m), min=1.0)
