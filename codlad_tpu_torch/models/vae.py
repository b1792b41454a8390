"""The decode half of the Stage-1 VQ-VAE.

Counterpart of `VAE.decode` in codlad_tpu/models/vae.py: post-quantization
latents [B, L, vqdim] go through `map_out` (when vqdim != embed_dim) and the
IC decoder.
"""

from __future__ import annotations

from torch import nn

from codlad_tpu_torch.models.decoder import ICDecoder
from codlad_tpu_torch.nn.layers import linear


class VAE(nn.Module):
    def __init__(self, gen, embed_dim=36, vqdim=3, n_rbf=15, dec_cutoff=21.0,
                 dec_nconv=4):
        super().__init__()
        self.decoder = ICDecoder(gen, n_atom_basis=embed_dim, n_rbf=n_rbf,
                                 cutoff=dec_cutoff, num_conv=dec_nconv)
        self.map_out = (linear(vqdim, embed_dim, gen, init="lecun")
                        if embed_dim != vqdim else None)

    def decode(self, batch, latents):
        """latents [B, L, vqdim] -> ic [B, L, 13, 3]."""
        if self.map_out is not None:
            latents = self.map_out(latents)
        return self.decoder(batch, latents)
