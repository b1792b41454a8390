"""Latent denoiser: ProteinMPNN-style kNN graph network with adaLN timestep
conditioning over per-residue latents.

Counterpart of codlad_tpu/models/denoiser.py on its production branch
(trunk adaLN) and in adaLN `residual` mode: no decoder mask, no
self-conditioning, no sequence sharding. `compute_condition` holds
everything that does not depend on the noisy latent (kNN graph, edge
features, sequence embedding) and runs once per batch; `denoise` runs at
every sampling step, with `fuse_pairs=True` through the layer-pair kernel
K7. `forward` runs both, the training path: the featurizer is then inside
the graph and gets gradients, and dropout is on when it is called with
deterministic=False and an integer dropout seed.
"""

from __future__ import annotations

import torch
from torch import nn

from codlad_tpu_torch.kernels.mpnn_kernels import fused_edge_then_sum
from codlad_tpu_torch.nn.layers import FinalLayer, TimestepEmbedder, embedding, linear
from codlad_tpu_torch.nn.mpnn import (CAProteinFeatures, DecLayerDiffusion,
                                      EncLayerDiffusion, _node_epilogue, gather_nodes)


class MPNNDenoiser(nn.Module):
    """Defaults are the production Stage-2 configuration (`mpnn_diffusion`).
    adaln_mode: 'trunk' (the reference) or 'residual' (DiT-style branch
    gates), passed to every layer."""

    def __init__(self, gen, hidden_dim=128, edge_features=128,
                 num_encoder_layers=3, num_decoder_layers=3, vocab=30,
                 k_neighbors=64, input_size=3, learn_sigma=True, dropout=0.6,
                 adaln_mode="trunk"):
        super().__init__()
        h = hidden_dim
        self.input_size = input_size
        self.adaln_mode = adaln_mode
        self.t_embedder = TimestepEmbedder(h, gen)
        self.features = CAProteinFeatures(edge_features, gen, top_k=k_neighbors)
        self.x_in = linear(input_size, h, gen)
        self.w_e = linear(edge_features, h, gen)
        self.w_s = embedding(vocab, h, gen, std=1.0)
        # each layer owns four dropout seed sites (nn/mpnn.py: _DropoutLayer)
        self.enc_layers = nn.ModuleList(
            EncLayerDiffusion(h, gen, dropout=dropout, site=4 * i, gate_mode=adaln_mode)
            for i in range(num_encoder_layers))
        self.dec_layers = nn.ModuleList(
            DecLayerDiffusion(h, gen, dropout=dropout, site=4 * (num_encoder_layers + i),
                              gate_mode=adaln_mode)
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

    def denoise(self, x, t, cond, deterministic=True, dropout_seed=None, fuse_pairs=False):
        """One denoiser evaluation. x [B, L, input_size] in the weights'
        dtype, t [B] or scalar base timesteps -> [B, L, out]. With
        deterministic=False the layers drop at rate `dropout`, with masks
        keyed by the integer `dropout_seed`.

        fuse_pairs=True (sampling only: K7 has no backward) runs each encoder
        layer's edge update and the next layer's node sum as one kernel
        (`_denoise_fused`). As in the JAX package, that path is taken only
        where it exists: deterministic, trunk adaLN, decoder layers present;
        in any other mode the unfused path runs."""
        B = x.shape[0]
        dt = x.dtype
        idx = cond["idx"]
        maskf = cond["maskf"].to(dt)
        mask_attend = cond["mask_attend"].to(dt)
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(B)
        c = self.t_embedder(t).to(dt)

        h_V = self.x_in(x)
        h_E = cond["h_E0"].to(dt)
        if (fuse_pairs and deterministic and self.adaln_mode == "trunk"
                and len(self.dec_layers) > 0):
            return self._denoise_fused(h_V, h_E, idx, maskf, mask_attend,
                                       2.0 * cond["h_S"].to(dt), c)
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

    def _denoise_fused(self, h_V, h_E, idx, maskf, mask_attend, s_node, c):
        """`denoise` with each encoder layer's edge update (K2) chained into
        the next layer's node sum (K1) by K7 (codlad_tpu/models/denoiser.py
        `_denoise_fused`). The last pair folds in the first decoder layer's
        node chain: its edge block is 2*h_E (W_e * 2), its mask all ones and
        its node block [2*h_S, h_V + h_V_enc] = [s_node, 2*h_V]."""
        enc = self.enc_layers
        m = [layer.mods(c) for layer in enc]
        dh = enc[0].SplitMessageChain_0(h_V, h_E, h_V, idx, mask_attend=mask_attend)
        h_V = _node_epilogue(enc[0], h_V, dh, *m[0][:6], maskf)
        h_V_enc = None
        for i, layer in enumerate(enc):
            edge = layer.SplitMessageChain_1.components(h_V, h_V)
            sh3, sc3, g3 = m[i][6:9]
            if i + 1 < len(enc):
                nxt, mods, mask = enc[i + 1], m[i + 1][:6], mask_attend
                node = nxt.SplitMessageChain_0.components(h_V, h_V)
            else:
                h_V_enc = h_V
                nxt, mask = self.dec_layers[0], torch.ones_like(mask_attend)
                mods = nxt.mods(c)
                node = nxt.chain_operands(h_V, s_node, h_V + h_V_enc, edge_scale=2.0)
            h_E, dh = fused_edge_then_sum(edge[0], h_E, edge[1], idx, *edge[2:], sh3, sc3, g3,
                                          *node, mask, nxt.SplitMessageChain_0.scale)
            h_V = _node_epilogue(nxt, h_V, dh, *mods, maskf)
        for layer in self.dec_layers[1:]:
            h_V = layer(h_V, idx, h_E, s_node, h_V + h_V_enc, maskf, c, 2.0)
        return self.w_out(h_V, c)

    def forward(self, x, t, res_type, cg_xyz, mask, deterministic=True,
                dropout_seed=None):
        """The training forward (JAX `__call__`): conditioning, then one
        denoiser evaluation. x [B, L, input_size], t [B], res_type [B, L],
        cg_xyz [B, L, 3] (Å), mask [B, L] -> [B, L, out]."""
        cond = self.compute_condition(res_type, cg_xyz, mask)
        return self.denoise(x, t, cond, deterministic, dropout_seed)
