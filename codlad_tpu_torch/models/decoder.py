"""Internal-coordinate decoder: latent -> [B, L, 13, 3] ic tensors.

Counterpart of `ICDecoder` and `ICDecoderAngle` in
codlad_tpu/models/decoder.py: bond lengths (and, in `ICDecoder`, side-chain
angles) are residue-type embedding lookups; backbone angles/torsions and
side-chain torsions are predicted by invariant message passing over the CG
radius graph. `ICDecoderAngle` (the PDB and Atlas recipes) predicts the
side-chain angles with an MLP too, and its side-chain torsion blocks run at
width F + 10 on [s | sc_angle]. Submodule names follow flax's auto-names
(Embed_i, InvariantMessage_i, _MLP2_i) so converted parameters load by
name.
"""

from __future__ import annotations

import torch
from torch import nn

from codlad_tpu_torch.nn.basis import InvariantMessage, swish
from codlad_tpu_torch.nn.graph import EdgeOps, make_directed_batched
from codlad_tpu_torch.nn.layers import embedding, linear


class _MLP2(nn.Module):
    """swish -> Dense -> swish -> Dense."""

    def __init__(self, in_dim, mid, out, gen):
        super().__init__()
        self.Dense_0 = linear(in_dim, mid, gen, init="lecun")
        self.Dense_1 = linear(mid, out, gen, init="lecun")

    def forward(self, x):
        return self.Dense_1(swish(self.Dense_0(swish(x))))


class _ICDecoderBase(nn.Module):
    predict_sc_angle = False

    def __init__(self, gen, n_atom_basis=36, n_rbf=15, cutoff=21.0, num_conv=4,
                 res_embed_dim=4):
        super().__init__()
        F = n_atom_basis + res_embed_dim
        self.num_conv = num_conv
        self.Embed_0 = embedding(25, 3, gen)    # backbone bond lengths
        self.Embed_1 = embedding(25, 10, gen)   # side-chain bond lengths
        self.Embed_2 = embedding(25, res_embed_dim, gen)
        if not self.predict_sc_angle:
            self.Embed_3 = embedding(25, 10, gen)   # side-chain angles
        for i in range(num_conv):
            setattr(self, f"InvariantMessage_{i}", InvariantMessage(F, F, n_rbf, cutoff, gen))
        mlps = [(F, F, F)] * num_conv + [(F, 3, 3), (F + 3, 3, 3)]
        if self.predict_sc_angle:   # the angle head, then the blocks on [s | sc_angle]
            mlps += [(F, 10, 10)] + [(F + 10, F + 10, F + 10)] * num_conv + [(F + 10, 10, 10)]
        else:
            mlps += [(F, F, F)] * num_conv + [(F, 10, 10)]
        for i, dims in enumerate(mlps):
            setattr(self, f"_MLP2_{i}", _MLP2(*dims, gen))

    def _mlp(self, i):
        return getattr(self, f"_MLP2_{i}")

    def forward(self, batch, latents):
        """batch: res_type [B, L], res_mask [B, L], cg_xyz_og [B, L+2, 3],
        cg_edges [B, E, 2], cg_edges_mask [B, E]; latents [B, L, n_atom_basis]."""
        res_type = batch["res_type"].long()
        B, L = res_type.shape
        nc = self.num_conv
        cg_xyz = batch["cg_xyz_og"][:, 1:-1]
        ops = EdgeOps(*make_directed_batched(batch["cg_edges"], batch["cg_edges_mask"]), L)
        r_ij = ops.gather_dst(cg_xyz) - ops.gather_src(cg_xyz)
        dist = torch.sqrt(torch.sum(r_ij * r_ij, dim=-1) + 1e-8)

        bb_dist = self.Embed_0(res_type)[..., None]
        sc_dist = self.Embed_1(res_type)[..., None]
        s = torch.cat([latents, self.Embed_2(res_type)], dim=-1)
        s = s * batch["res_mask"][..., None].to(s.dtype)
        for i in range(nc):
            msg = getattr(self, f"InvariantMessage_{i}")(s, dist, ops)
            s = s + self._mlp(i)(ops.aggregate_to_src(msg))

        bb_angle = self._mlp(nc)(s)
        bb_torsion = self._mlp(nc + 1)(torch.cat([s, bb_angle], dim=-1))
        if self.predict_sc_angle:
            sc_angle = self._mlp(nc + 2)(s)
            s = torch.cat([s, sc_angle], dim=-1)
            for i in range(nc):
                s = s + self._mlp(nc + 3 + i)(s)
            sc_torsion = self._mlp(2 * nc + 3)(s)
        else:
            sc_angle = self.Embed_3(res_type)
            for i in range(nc):
                s = s + self._mlp(nc + 2 + i)(s)
            sc_torsion = self._mlp(2 * nc + 2)(s)

        ic_bb = torch.cat([bb_dist, bb_angle[..., None], bb_torsion[..., None]], dim=-1)
        ic_sc = torch.cat([sc_dist, sc_angle[..., None], sc_torsion[..., None]], dim=-1)
        return torch.cat([ic_bb, ic_sc], dim=-2)


class ICDecoder(_ICDecoderBase):
    predict_sc_angle = False


class ICDecoderAngle(_ICDecoderBase):
    predict_sc_angle = True
