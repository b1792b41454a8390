"""CG-only tensor-product prior network: C-alpha trace and residue types ->
per-residue (mu, sigma).

Counterpart of `CGPrior` in codlad_tpu/models/prior.py: the CG half of the
E3Encoder alone. Over the CG radius graph (nn/graph.EdgeOps: K8 gathers, K9
mean aggregates) one gather a side of the [xyz | res_type] payload (4
lanes) gives the edge harmonics and attributes (the two types, zero
`in_edge_features` lanes and the smeared distance), then three TPConv
layers (K10) climb the irreps ladder with no residual, and two tanh heads
read mu and log variance: sigma = 1e-9 + exp(logvar / 2), both masked. It
runs in f32 in every mode, as the JAX module does (it has no compute
dtype). It is GenZProt's CG-conditioned prior and the cgvae mode's latent
source.

Submodule names follow flax's auto-names (EdgeEmbed_0, Embed_0, TPConv_i,
Dense_0..3: the mu head's two, then the log variance head's) so converted
parameters load by name.
"""

from __future__ import annotations

import torch
from torch import nn

from codlad_tpu_torch.models.encoder import EdgeEmbed, _pad_to, irrep_ladder
from codlad_tpu_torch.nn.basis import GaussianSmearing
from codlad_tpu_torch.nn.graph import EdgeOps, make_directed_batched
from codlad_tpu_torch.nn.irreps import SH_IRREPS, sh_l2
from codlad_tpu_torch.nn.layers import embedding, linear
from codlad_tpu_torch.nn.tensor_product import TPConv


class CGPrior(nn.Module):
    def __init__(self, gen, n_atom_basis=36, ns=12, nv=4, num_conv_layers=3,
                 cg_max_radius=26.0, distance_embed_dim=8, in_edge_features=4):
        super().__init__()
        self.ns, self.n_layers = ns, num_conv_layers
        self.in_edge_features = in_edge_features
        self.ladder = irrep_ladder(ns, nv)
        self.smear = GaussianSmearing(0.0, cg_max_radius, distance_embed_dim)
        self.EdgeEmbed_0 = EdgeEmbed(2 + in_edge_features + distance_embed_dim, ns, gen)
        self.Embed_0 = embedding(30, ns, gen)
        for l in range(num_conv_layers):
            in_ir, out_ir = self.ladder[min(l, 3)], self.ladder[min(l + 1, 3)]
            setattr(self, f"TPConv_{l}",
                    TPConv(in_ir, SH_IRREPS, out_ir, 3 * ns, gen, hidden_features=3 * ns))
        width = self.ladder[min(num_conv_layers, 3)].dim
        for i in range(2):   # the mu head, then the log variance head
            setattr(self, f"Dense_{2 * i}", linear(width, n_atom_basis, gen, init="lecun"))
            setattr(self, f"Dense_{2 * i + 1}",
                    linear(n_atom_basis, n_atom_basis, gen, init="lecun"))

    def _head(self, i, x):
        return getattr(self, f"Dense_{2 * i + 1}")(torch.tanh(getattr(self, f"Dense_{2 * i}")(x)))

    def forward(self, batch):
        """batch: res_type [B, L], res_mask [B, L], cg_xyz_og [B, L+2, 3],
        cg_edges [B, E, 2], cg_edges_mask [B, E] -> (mu, sigma), each
        [B, L, n_atom_basis], zero on padded residues."""
        res_type = batch["res_type"].long()
        L = res_type.shape[1]
        ns = self.ns
        res_mask = batch["res_mask"][..., None].to(torch.float32)
        cg_xyz = batch["cg_xyz_og"][:, 1:-1]
        ops = EdgeOps(*make_directed_batched(batch["cg_edges"], batch["cg_edges_mask"]), L)
        # one gather a side of the [xyz | res_type] payload
        cgxz = torch.cat([cg_xyz, res_type[..., None].to(cg_xyz.dtype)], dim=-1)
        g_src, g_dst = ops.gather_src(cgxz), ops.gather_dst(cgxz)
        r = g_dst[..., :3] - g_src[..., :3]
        sh = sh_l2(r)
        attr = self.EdgeEmbed_0(torch.cat(
            [g_src[..., 3:], g_dst[..., 3:], r.new_zeros(r.shape[:2] + (self.in_edge_features,)),
             self.smear(torch.sqrt((r * r).sum(-1) + 1e-12))], dim=-1))
        feat = self.Embed_0(res_type) * res_mask
        for l in range(self.n_layers):
            gd_full = ops.gather_dst(feat)
            attr_full = torch.cat([attr, ops.gather_src(feat[..., :ns]), gd_full[..., :ns]],
                                  dim=-1)
            update = getattr(self, f"TPConv_{l}")(feat, ops, attr_full, sh, x_dst=gd_full)
            feat = _pad_to(feat, update.shape[-1]) + update
        mu = self._head(0, feat)
        sigma = 1e-9 + torch.exp(self._head(1, feat) / 2.0)
        return mu * res_mask, sigma * res_mask
