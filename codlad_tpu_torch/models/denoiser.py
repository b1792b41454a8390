"""Latent denoiser: ProteinMPNN-style kNN graph network with adaLN timestep
conditioning over per-residue latents.

Counterpart of codlad_tpu/models/denoiser.py on its production branch:
trunk adaLN, no decoder mask, no self-conditioning, no sequence sharding.
`compute_condition` holds everything that does not depend on the noisy
latent (kNN graph, edge features, sequence embedding) and runs once per
batch; `denoise` runs at every sampling step. `forward` runs both, the
training path: the featurizer is then inside the graph and gets gradients,
and dropout is on when it is called with deterministic=False and an
integer dropout seed.
"""

from __future__ import annotations

import torch
from torch import nn

from codlad_tpu_torch.nn.layers import FinalLayer, TimestepEmbedder, embedding, linear
from codlad_tpu_torch.nn.mpnn import (CAProteinFeatures, DecLayerDiffusion,
                                      EncLayerDiffusion, gather_nodes)


class MPNNDenoiser(nn.Module):
    """Defaults are the production Stage-2 configuration (`mpnn_diffusion`)."""

    def __init__(self, gen, hidden_dim=128, edge_features=128,
                 num_encoder_layers=3, num_decoder_layers=3, vocab=30,
                 k_neighbors=64, input_size=3, learn_sigma=True, dropout=0.6):
        super().__init__()
        h = hidden_dim
        self.input_size = input_size
        self.t_embedder = TimestepEmbedder(h, gen)
        self.features = CAProteinFeatures(edge_features, gen, top_k=k_neighbors)
        self.x_in = linear(input_size, h, gen)
        self.w_e = linear(edge_features, h, gen)
        self.w_s = embedding(vocab, h, gen, std=1.0)
        # each layer owns four dropout seed sites (nn/mpnn.py: _DropoutLayer)
        self.enc_layers = nn.ModuleList(
            EncLayerDiffusion(h, gen, dropout=dropout, site=4 * i)
            for i in range(num_encoder_layers))
        self.dec_layers = nn.ModuleList(
            DecLayerDiffusion(h, gen, dropout=dropout, site=4 * (num_encoder_layers + i))
            for i in range(num_decoder_layers))
        self.w_out = FinalLayer(h, input_size * (2 if learn_sigma else 1), gen)

    def compute_condition(self, res_type, cg_xyz, mask):
        """x-independent conditioning: kNN indices, edge features, masks and
        the sequence embedding. res_type [B, L], cg_xyz [B, L, 3] (Å),
        mask [B, L]."""
        B, L = res_type.shape
        maskf = mask.to(cg_xyz.dtype)
        residue_idx = torch.arange(L, dtype=torch.int32,
                                   device=cg_xyz.device).expand(B, L)
        chain_labels = torch.ones((B, L), dtype=cg_xyz.dtype, device=cg_xyz.device)
        E, E_idx = self.features(cg_xyz, maskf, residue_idx, chain_labels)
        mask_attend = maskf[..., None] * gather_nodes(maskf[..., None], E_idx)[..., 0]
        return {"idx": E_idx.to(torch.int32), "h_E0": self.w_e(E),
                "h_S": self.w_s(res_type.long()), "maskf": maskf,
                "mask_attend": mask_attend}

    def denoise(self, x, t, cond, deterministic=True, dropout_seed=None):
        """One denoiser evaluation. x [B, L, input_size] in the weights'
        dtype, t [B] or scalar base timesteps -> [B, L, out]. With
        deterministic=False the layers drop at rate `dropout`, with masks
        keyed by the integer `dropout_seed`."""
        B = x.shape[0]
        dt = x.dtype
        idx = cond["idx"]
        maskf = cond["maskf"].to(dt)
        mask_attend = cond["mask_attend"].to(dt)
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(B)
        c = self.t_embedder(t).to(dt)

        h_V = self.x_in(x)
        h_E = cond["h_E0"].to(dt)
        for layer in self.enc_layers:
            h_V, h_E = layer(h_V, h_E, idx, maskf, mask_attend, c, deterministic,
                             dropout_seed)

        # decoder message input in split form: edge block 2*h_E (folded into
        # W_e), sequence block 2*h_S, node block h_V + h_V_encoder
        h_V_enc = h_V
        s_node = 2.0 * cond["h_S"].to(dt)
        for layer in self.dec_layers:
            h_V = layer(h_V, idx, h_E, s_node, h_V + h_V_enc, maskf, c, 2.0,
                        deterministic, dropout_seed)
        return self.w_out(h_V, c)

    def forward(self, x, t, res_type, cg_xyz, mask, deterministic=True,
                dropout_seed=None):
        """The training forward (JAX `__call__`): conditioning, then one
        denoiser evaluation. x [B, L, input_size], t [B], res_type [B, L],
        cg_xyz [B, L, 3] (Å), mask [B, L] -> [B, L, out]."""
        cond = self.compute_condition(res_type, cg_xyz, mask)
        return self.denoise(x, t, cond, deterministic, dropout_seed)
