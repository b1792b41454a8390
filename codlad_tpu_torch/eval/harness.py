"""Inference pipeline: latent sampling -> VQ snap -> IC decode -> xyz14.

Counterpart of `SamplingPipeline.sample_and_decode` in
codlad_tpu/eval/harness.py for ancestral diffusion sampling with the plain
EMA-VQ snap (no guidance, no sequence sharding, no flows, no DDIM). With `compute_dtype`
set, the denoiser runs on a copy of its weights in that dtype while the
conditioning is computed in f32 and then cast, and the sampler's schedule
arithmetic and the decode stay in f32, as in the JAX pipeline.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch

from codlad_tpu_torch.geometry.internal import ic_to_xyz14
from codlad_tpu_torch.models.vq import vq_quantize


@dataclasses.dataclass(eq=False)
class SamplingPipeline:
    denoiser: Any               # models.denoiser.MPNNDenoiser (f32)
    process: Any                # gen.diffusion.GaussianDiffusion
    vae: Any                    # models.vae.VAE
    codebook: Any               # [n_codes, vqdim] tensor, or None (no snap)
    norm_mean: Any              # [latent_size]
    norm_std: Any
    latent_size: int = 3
    compute_dtype: Any = None   # e.g. torch.bfloat16 for the denoiser

    def __post_init__(self):
        self._denoise_model = self.denoiser
        if self.compute_dtype is not None:
            self._denoise_model = copy.deepcopy(self.denoiser).to(self.compute_dtype)

    @torch.no_grad()
    def sample_latents(self, extras, generator=None, noise=None, noises=None):
        """Normalised latents [B, L, latent_size] given the CG conditioning
        (res_type, cg_xyz [B, L, 3], mask). `noise` is x_T; `noises` the
        per-step z of the ancestral sampler (both drawn from `generator`
        when not given)."""
        res_type = extras["res_type"]
        B, L = res_type.shape
        dev = res_type.device
        if noise is None:
            noise = torch.randn((B, L, self.latent_size), generator=generator, device=dev)
        cond = self.denoiser.compute_condition(res_type, extras["cg_xyz"], extras["mask"])
        if self.compute_dtype is not None:
            cond = {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                    for k, v in cond.items()}
        model = self._denoise_model
        cd = self.compute_dtype

        def model_fn(x, t):
            return model.denoise(x if cd is None else x.to(cd), t, cond).to(torch.float32)

        return self.process.p_sample_loop(model_fn, noise.shape, noise=noise,
                                          noises=noises, generator=generator)

    @torch.no_grad()
    def decode(self, batch, latents_norm):
        """De-normalise, snap to the codebook, decode -> (ic, xyz14)."""
        dev = latents_norm.device
        mean = torch.as_tensor(self.norm_mean, dtype=torch.float32, device=dev)
        std = torch.as_tensor(self.norm_std, dtype=torch.float32, device=dev)
        latents = latents_norm * std + mean
        if self.codebook is not None:
            latents = vq_quantize(self.codebook, latents, batch["res_mask"])[0]
        ic = self.vae.decode(batch, latents)
        return ic, ic_to_xyz14(batch["cg_xyz_og"], ic, batch["res_type"])

    def sample_and_decode(self, batch, generator=None, noise=None, noises=None):
        """Conditioning -> latents -> structure: (ic [B, L, 13, 3],
        xyz14 [B, L, 14, 3])."""
        extras = {"res_type": batch["res_type"],
                  "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
                  "mask": batch["res_mask"]}
        lat = self.sample_latents(extras, generator=generator, noise=noise, noises=noises)
        return self.decode(batch, lat)
