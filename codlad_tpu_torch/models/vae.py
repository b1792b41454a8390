"""The Stage-1 VQ-VAE shell (mode "vqvae").

Counterpart of `VAE` in codlad_tpu/models/vae.py for its production mode:
`encode` runs the E3Encoder and `map_in` (embed_dim -> vqdim) to the pre-VQ
latents; `decode` takes post-quantization latents [B, L, vqdim] through
`map_out` and the IC decoder. The quantizer stays outside (models/vq.py).
The other modes (fgae, fgvae, cgvae) and GenZProt are not ported yet.
`encoder=False` builds the decode half alone, for weights that hold no
encoder.
"""

from __future__ import annotations

import torch
from torch import nn

from codlad_tpu_torch.models.decoder import ICDecoder
from codlad_tpu_torch.models.encoder import E3Encoder
from codlad_tpu_torch.nn.layers import linear


class VAE(nn.Module):
    def __init__(self, gen, embed_dim=36, vqdim=3, n_rbf=15, dec_cutoff=21.0,
                 dec_nconv=4, enc_nconv=3, atom_cutoff=9.0, cg_cutoff=21.0,
                 compute_dtype=torch.float32, encoder=True):
        super().__init__()
        self.decoder = ICDecoder(gen, n_atom_basis=embed_dim, n_rbf=n_rbf,
                                 cutoff=dec_cutoff, num_conv=dec_nconv)
        self.map_out = (linear(vqdim, embed_dim, gen, init="lecun")
                        if embed_dim != vqdim else None)
        self.encoder = self.map_in = None
        if encoder:
            self.encoder = E3Encoder(gen, n_atom_basis=embed_dim, num_conv_layers=enc_nconv,
                                     atom_max_radius=atom_cutoff + 5,
                                     cg_max_radius=cg_cutoff + 5,
                                     cross_max_distance=cg_cutoff + 5,
                                     compute_dtype=compute_dtype)
            if embed_dim != vqdim:
                self.map_in = linear(embed_dim, vqdim, gen, init="lecun")

    def encode(self, batch):
        """-> pre-quantization per-residue latents [B, L, vqdim] (f32)."""
        h = self.encoder(batch)
        return h if self.map_in is None else self.map_in(h)

    def decode(self, batch, latents):
        """latents [B, L, vqdim] -> ic [B, L, 13, 3]."""
        if self.map_out is not None:
            latents = self.map_out(latents)
        return self.decoder(batch, latents)
