"""Stage-1 composition shells: the VQ-VAE, FG(V)AE and CG-VAE modes, and GenZProt.

Counterpart of `reparametrize`, `MuSigmaHead`, `VAE` and `GenZProt` in
codlad_tpu/models/vae.py. The quantizer stays outside (models/vq.py).
`VAE(mode=...)` picks the latent path:
* vqvae: E3Encoder -> map_in (embed_dim -> vqdim) -> [external VQ] ->
  map_out -> IC decoder;
* fgae: the encoder's latents as they are; fgvae: a MuSigmaHead on them
  (mu, sigma), reparametrised in training;
* cgvae: the CG prior (models/prior.py) gives (mu, sigma); no encoder.
`predict_angle` takes ICDecoderAngle (the PDB and Atlas recipes).
`encoder=False` builds the decode half alone, for weights that hold no
encoder. Randomness is explicit: `eps` is the reparametrisation's
standard-normal draw.
"""

from __future__ import annotations

import torch
from torch import nn

from codlad_tpu_torch.models.decoder import ICDecoder, ICDecoderAngle
from codlad_tpu_torch.models.encoder import E3Encoder
from codlad_tpu_torch.models.prior import CGPrior
from codlad_tpu_torch.nn.layers import linear

MODES = ("vqvae", "fgae", "fgvae", "cgvae")


def reparametrize(mu, sigma, eps):
    """mu + sigma * eps, eps a standard-normal draw of sigma's shape."""
    return mu + sigma * eps


class MuSigmaHead(nn.Module):
    """Two relu MLPs (Dense_0-1 the mean, Dense_2-3 the log variance):
    (mu, sigma = 1e-12 + exp(logvar / 2))."""

    def __init__(self, in_dim, dim, gen):
        super().__init__()
        for i in range(2):
            setattr(self, f"Dense_{2 * i}", linear(in_dim, dim, gen, init="lecun"))
            setattr(self, f"Dense_{2 * i + 1}", linear(dim, dim, gen, init="lecun"))

    def _head(self, i, x):
        return getattr(self, f"Dense_{2 * i + 1}")(getattr(self, f"Dense_{2 * i}")(x).relu())

    def forward(self, h):
        return self._head(0, h), 1e-12 + torch.exp(self._head(1, h) / 2.0)


class VAE(nn.Module):
    def __init__(self, gen, embed_dim=36, vqdim=3, mode="vqvae", predict_angle=False, n_rbf=15,
                 dec_cutoff=21.0, dec_nconv=4, enc_nconv=3, atom_cutoff=9.0, cg_cutoff=21.0,
                 compute_dtype=torch.float32, encoder=True):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown VAE mode {mode!r}")
        self.mode = mode
        dec_cls = ICDecoderAngle if predict_angle else ICDecoder
        self.decoder = dec_cls(gen, n_atom_basis=embed_dim, n_rbf=n_rbf, cutoff=dec_cutoff,
                               num_conv=dec_nconv)
        vq_maps = mode == "vqvae" and embed_dim != vqdim
        self.map_out = linear(vqdim, embed_dim, gen, init="lecun") if vq_maps else None
        self.encoder = self.map_in = self.head = self.prior = None
        if encoder and mode != "cgvae":
            self.encoder = E3Encoder(gen, n_atom_basis=embed_dim, num_conv_layers=enc_nconv,
                                     atom_max_radius=atom_cutoff + 5,
                                     cg_max_radius=cg_cutoff + 5,
                                     cross_max_distance=cg_cutoff + 5,
                                     compute_dtype=compute_dtype)
            if vq_maps:
                self.map_in = linear(embed_dim, vqdim, gen, init="lecun")
            if mode == "fgvae":
                self.head = MuSigmaHead(embed_dim, embed_dim, gen)
        if encoder and mode == "cgvae":
            self.prior = CGPrior(gen, n_atom_basis=embed_dim, num_conv_layers=enc_nconv,
                                 cg_max_radius=cg_cutoff + 5)

    def encode_full(self, batch):
        """-> (pre-quantization latents [B, L, vqdim or embed_dim] in f32,
        mu, sigma); mu and sigma are None but in fgvae and cgvae, where the
        latents are mu."""
        if self.mode == "cgvae":
            mu, sigma = self.prior(batch)
            return mu, mu, sigma
        h = self.encoder(batch)
        if self.mode == "fgvae":
            mu, sigma = self.head(h)
            return mu, mu, sigma
        if self.map_in is not None:
            h = self.map_in(h)
        return h, None, None

    def encode(self, batch):
        """-> pre-quantization per-residue latents [B, L, vqdim] (f32)."""
        return self.encode_full(batch)[0]

    def decode(self, batch, latents):
        """latents [B, L, vqdim] -> ic [B, L, 13, 3]."""
        if self.map_out is not None:
            latents = self.map_out(latents)
        return self.decoder(batch, latents)

    def forward(self, batch, latents=None):
        """encode_full(batch) without latents, else decode(batch, latents):
        one entry point for torch.func.functional_call."""
        return self.encode_full(batch) if latents is None else self.decode(batch, latents)


class GenZProt(nn.Module):
    """The prior-VAE baseline: the encoder's posterior (mu, sigma) through a
    MuSigmaHead, the CG prior's (mu, sigma), and the IC decoder of a draw
    from the posterior."""

    def __init__(self, gen, embed_dim=36, n_rbf=15, dec_cutoff=21.0, dec_nconv=4, enc_nconv=3,
                 atom_cutoff=9.0, cg_cutoff=21.0):
        super().__init__()
        self.mode, self.embed_dim = "ivae", embed_dim
        self.encoder = E3Encoder(gen, n_atom_basis=embed_dim, num_conv_layers=enc_nconv,
                                 atom_max_radius=atom_cutoff + 5, cg_max_radius=cg_cutoff + 5,
                                 cross_max_distance=cg_cutoff + 5)
        self.prior_net = CGPrior(gen, n_atom_basis=embed_dim, num_conv_layers=enc_nconv,
                                 cg_max_radius=cg_cutoff + 5)
        self.head = MuSigmaHead(embed_dim, embed_dim, gen)
        self.decoder = ICDecoder(gen, n_atom_basis=embed_dim, n_rbf=n_rbf, cutoff=dec_cutoff,
                                 num_conv=dec_nconv)

    def forward(self, batch, eps=None):
        """-> (mu, sigma, prior_mu, prior_sigma, ic_recon); the decoder reads
        mu + sigma * eps, or mu when eps is None (JAX: rng=None)."""
        mu, sigma = self.head(self.encoder(batch))
        prior_mu, prior_sigma = self.prior_net(batch)
        z = mu if eps is None else reparametrize(mu, sigma, eps)
        return mu, sigma, prior_mu, prior_sigma, self.decoder(batch, z)

    def get_latent_cg(self, batch, eps):
        """The CG prior's sample (the test-time latent source): (prior_mu +
        prior_sigma * eps, prior_mu, prior_sigma)."""
        prior_mu, prior_sigma = self.prior_net(batch)
        return reparametrize(prior_mu, prior_sigma, eps), prior_mu, prior_sigma

    def decode(self, batch, latents):
        return self.decoder(batch, latents)
