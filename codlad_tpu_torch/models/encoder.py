"""E(3) tensor-product graph encoder over atom14 proteins.

Counterpart of codlad_tpu/models/encoder.py: three interleaved graphs, the
atom radius graph, the CG radius graph (both padded edge lists through
nn/graph.EdgeOps: K8 gathers, K9 mean aggregates) and the dense atom <-> CG
cross graph (each atom couples to its own residue, so the cross
convolutions are per-slot tensor products and the atom -> CG direction is a
masked mean over the 14 slots). The irreps ladder is ns x0e -> +nv x1o ->
+nv x1e -> +ns x0o with l <= 2 edge harmonics; every tensor product is K10.
The readout concatenates atom and CG features, averages over each residue
and projects to the latent width.

Submodule names follow flax's auto-names (EdgeEmbed_i, Embed_i, TPConv_i,
Dense_i) so converted parameters load by name. With compute_dtype bf16 the
feature path runs in bf16 while geometry, the Dense layers (f32 params, as
flax promotes) and the readout stay in f32, as in the JAX module.
"""

from __future__ import annotations

import torch
from torch import nn

from codlad_tpu_torch.geometry import residues as R
from codlad_tpu_torch.nn.basis import GaussianSmearing
from codlad_tpu_torch.nn.graph import EdgeOps, make_directed_batched
from codlad_tpu_torch.nn.irreps import SH_IRREPS, Irreps, sh_l2
from codlad_tpu_torch.nn.layers import embedding, linear
from codlad_tpu_torch.nn.tensor_product import FullyConnectedTP, TPConv, dense


def irrep_ladder(ns, nv):
    return [Irreps(f"{ns}x0e"),
            Irreps(f"{ns}x0e + {nv}x1o"),
            Irreps(f"{ns}x0e + {nv}x1o + {nv}x1e"),
            Irreps(f"{ns}x0e + {nv}x1o + {nv}x1e + {ns}x0o")]


class EdgeEmbed(nn.Module):
    def __init__(self, in_dim, ns, gen):
        super().__init__()
        self.Dense_0 = linear(in_dim, ns, gen, init="lecun")
        self.Dense_1 = linear(ns, ns, gen, init="lecun")

    def forward(self, x):
        return dense(self.Dense_1, dense(self.Dense_0, x).relu())


def _pad_to(x, width):
    return nn.functional.pad(x, (0, width - x.shape[-1]))


class E3Encoder(nn.Module):
    def __init__(self, gen, n_atom_basis=36, ns=12, nv=4, num_conv_layers=3,
                 atom_max_radius=14.0, cg_max_radius=26.0, cross_max_distance=26.0,
                 distance_embed_dim=8, cross_distance_embed_dim=8, in_edge_features=4,
                 compute_dtype=torch.float32):
        super().__init__()
        self.ns, self.n_layers = ns, num_conv_layers
        self.in_edge_features = in_edge_features
        self.compute_dtype = compute_dtype
        self.ladder = irrep_ladder(ns, nv)
        edge_in = 2 + in_edge_features + distance_embed_dim
        self.smear_atom = GaussianSmearing(0.0, atom_max_radius, distance_embed_dim)
        self.smear_cg = GaussianSmearing(0.0, cg_max_radius, distance_embed_dim)
        self.smear_cross = GaussianSmearing(0.0, cross_max_distance, cross_distance_embed_dim)
        self.EdgeEmbed_0 = EdgeEmbed(edge_in, ns, gen)
        self.Embed_0 = embedding(30, ns, gen)
        self.EdgeEmbed_1 = EdgeEmbed(edge_in, ns, gen)
        self.Embed_1 = embedding(30, ns, gen)
        self.EdgeEmbed_2 = EdgeEmbed(cross_distance_embed_dim, ns, gen)
        # flax numbers the modules in order of creation: per layer the atom
        # TPConv and the CG -> atom weight MLP, then (all but the last layer)
        # the CG TPConv and the atom -> CG weight MLP; each MLP is two Dense,
        # the outer (numel-wide) one created first
        self._n_tp = self._n_dense = 0
        self.c2a, self.a2c = [], []   # (FullyConnectedTP, index of its first Dense)
        for l in range(num_conv_layers):
            in_ir, out_ir = self.ladder[min(l, 3)], self.ladder[min(l + 1, 3)]
            self._add_conv(in_ir, out_ir, gen)
            self.c2a.append(self._add_cross(in_ir, out_ir, gen))
            if l != num_conv_layers - 1:
                self._add_conv(in_ir, out_ir, gen)
                self.a2c.append(self._add_cross(in_ir, out_ir, gen))
        self._readout = self._n_dense
        width = (self.ladder[min(num_conv_layers, 3)].dim
                 + self.ladder[min(num_conv_layers - 1, 3)].dim)
        setattr(self, f"Dense_{self._readout}", linear(width, n_atom_basis, gen, init="lecun"))
        setattr(self, f"Dense_{self._readout + 1}",
                linear(n_atom_basis, n_atom_basis, gen, init="lecun"))

    def _add_conv(self, in_ir, out_ir, gen):
        ns = self.ns
        setattr(self, f"TPConv_{self._n_tp}",
                TPConv(in_ir, SH_IRREPS, out_ir, 3 * ns, gen, hidden_features=3 * ns))
        self._n_tp += 1

    def _add_cross(self, in_ir, out_ir, gen):
        ns, i = self.ns, self._n_dense
        tp = FullyConnectedTP(in_ir, SH_IRREPS, out_ir)
        setattr(self, f"Dense_{i}", linear(3 * ns, tp.weight_numel, gen, init="lecun"))
        setattr(self, f"Dense_{i + 1}", linear(3 * ns, 3 * ns, gen, init="lecun"))
        self._n_dense += 2
        return tp, i

    def _dense(self, i):
        return getattr(self, f"Dense_{i}")

    def _weights(self, i, x):
        """The cross-graph weight MLP starting at Dense_i (numel, hidden)."""
        return dense(self._dense(i), dense(self._dense(i + 1), x).relu())

    def _edge_attr(self, ops, pos_z, smear, embed):
        """Edge geometry of a graph whose nodes carry [xyz | z]: (attr, sh)."""
        src, dst = ops.gather_src(pos_z), ops.gather_dst(pos_z)
        r = dst[..., :3] - src[..., :3]
        attr = torch.cat([src[..., 3:], dst[..., 3:],
                          r.new_zeros(r.shape[:2] + (self.in_edge_features,)),
                          smear(torch.sqrt((r * r).sum(-1) + 1e-12))], dim=-1)
        return embed(attr), sh_l2(r)

    def forward(self, batch):
        """batch: the padded dict of data/batch.py (torch tensors). Returns
        per-residue invariant latents [B, L, n_atom_basis] in f32."""
        res_type = batch["res_type"].long()
        B, L = res_type.shape
        A = R.MAX_ATOMS
        NA = L * A
        ns, cdt = self.ns, self.compute_dtype
        atom_mask = batch["atom_mask"].bool()
        xyz = batch["xyz14"]
        cg_xyz = batch["cg_xyz_og"][:, 1:-1]
        res_mask = batch["res_mask"]
        atom_z = torch.as_tensor(R.ATOM14_ATOMIC_NUM, device=xyz.device)[res_type]
        zf = (atom_z * atom_mask).reshape(B, NA)

        # atom graph: one gather a side of [xyz | z]
        a_ops = EdgeOps(*make_directed_batched(batch["atom_edges"],
                                               batch["atom_edges_mask"]), NA)
        xyzz = torch.cat([xyz.reshape(B, NA, 3), zf[..., None].to(xyz.dtype)], dim=-1)
        a_attr, atom_sh = self._edge_attr(a_ops, xyzz, self.smear_atom, self.EdgeEmbed_0)
        atom_feat = self.Embed_0(zf.long()) * atom_mask.reshape(B, NA, 1)

        # CG graph
        c_ops = EdgeOps(*make_directed_batched(batch["cg_edges"], batch["cg_edges_mask"]), L)
        cgxz = torch.cat([cg_xyz, res_type[..., None].to(xyz.dtype)], dim=-1)
        c_attr, cg_sh = self._edge_attr(c_ops, cgxz, self.smear_cg, self.EdgeEmbed_1)
        cg_feat = self.Embed_1(res_type) * res_mask[..., None]

        # cross graph: each atom and its own residue's site; the norm has no
        # eps here, unlike the two radius graphs
        r_iI = xyz - cg_xyz[:, :, None, :]
        cross_sh = sh_l2(r_iI)
        cross_attr = self.EdgeEmbed_2(self.smear_cross(torch.sqrt((r_iI * r_iI).sum(-1))))

        cast = lambda v: v.to(cdt)
        atom_feat, a_attr, atom_sh, cg_feat, c_attr, cg_sh, cross_attr, cross_sh = map(
            cast, (atom_feat, a_attr, atom_sh, cg_feat, c_attr, cg_sh, cross_attr, cross_sh))
        amask = atom_mask.to(cdt)
        denom = torch.clamp(amask.sum(-1, keepdim=True), min=1.0)

        n_tp = 0
        for l in range(self.n_layers):
            last = l == self.n_layers - 1
            gd_full = a_ops.gather_dst(atom_feat)
            a_attr_full = torch.cat([a_attr, a_ops.gather_src(atom_feat[..., :ns]),
                                     gd_full[..., :ns]], dim=-1)
            atom_intra = getattr(self, f"TPConv_{n_tp}")(atom_feat, a_ops, a_attr_full,
                                                         atom_sh, x_dst=gd_full)
            n_tp += 1

            af4 = atom_feat.reshape(B, L, A, -1)
            cg_b = cg_feat[:, :, None, :].expand(B, L, A, cg_feat.shape[-1])
            cross_full = torch.cat([cross_attr, af4[..., :ns], cg_b[..., :ns]], dim=-1)
            tp, i = self.c2a[l]
            atom_inter = tp(cg_b, cross_sh, self._weights(i, cross_full))
            atom_inter = (atom_inter * amask[..., None]).reshape(B, NA, -1)

            if not last:
                cgd_full = c_ops.gather_dst(cg_feat)
                c_attr_full = torch.cat([c_attr, c_ops.gather_src(cg_feat[..., :ns]),
                                         cgd_full[..., :ns]], dim=-1)
                cg_intra = getattr(self, f"TPConv_{n_tp}")(cg_feat, c_ops, c_attr_full,
                                                           cg_sh, x_dst=cgd_full)
                n_tp += 1
                tp, i = self.a2c[l]
                msg = tp(af4, cross_sh, self._weights(i, cross_full)) * amask[..., None]
                cg_inter = msg.sum(2) / denom

            atom_feat = _pad_to(atom_feat, atom_intra.shape[-1]) + atom_intra + atom_inter
            if not last:
                cg_feat = _pad_to(cg_feat, cg_intra.shape[-1]) + cg_intra + cg_inter

        af4 = atom_feat.reshape(B, L, A, -1)
        node = torch.cat([af4, cg_feat[:, :, None, :].expand(B, L, A, cg_feat.shape[-1])],
                         dim=-1) * amask[..., None]
        per_res = (node.sum(2) / denom).to(torch.promote_types(cdt, torch.float32))
        h = dense(self._dense(self._readout + 1),
                  torch.tanh(dense(self._dense(self._readout), per_res)))
        return h * res_mask[..., None].to(h.dtype)
