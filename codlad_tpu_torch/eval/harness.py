"""Inference pipeline: latent sampling or encoding -> VQ snap -> IC decode
-> xyz14 -> metrics.

Counterpart of codlad_tpu/eval/harness.py:

* `SamplingPipeline.sample_and_decode`: ancestral diffusion sampling with
  the plain EMA-VQ snap (no guidance, no sequence sharding, no flows, no
  DDIM). With `compute_dtype` set, the weights are rounded to that dtype
  first, as the JAX pipeline's `_cast` does: the denoiser runs on a copy of
  them in that dtype, the conditioning is computed in f32 arithmetic from
  the rounded weights and then cast, and the sampler's schedule arithmetic
  and the decode stay in f32.
* `SamplingPipeline.encode_latents` + `decode`: the `--experiment recon`
  path (pre-VQ encoder latents, de-normalise, snap, decode); the pipeline
  then needs no denoiser.
* `evaluate_structures`: the per-batch metric set.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch

from codlad_tpu_torch.eval import metrics as M
from codlad_tpu_torch.geometry.internal import ic_to_xyz14
from codlad_tpu_torch.models.vq import vq_quantize
from codlad_tpu_torch.train.losses import ic_terms, xyz_term


def rounded_copy(module, dtype):
    """A copy of `module` whose floating parameters are rounded to `dtype`
    and kept in their own dtype (f32 arithmetic on rounded weights)."""
    out = copy.deepcopy(module)
    with torch.no_grad():
        for p in out.parameters():
            if p.is_floating_point():
                p.copy_(p.to(dtype).to(p.dtype))
    return out


@dataclasses.dataclass(eq=False)
class SamplingPipeline:
    denoiser: Any               # models.denoiser.MPNNDenoiser (f32), or None (recon)
    process: Any                # gen.diffusion.GaussianDiffusion, or None (recon)
    vae: Any                    # models.vae.VAE
    codebook: Any               # [n_codes, vqdim] tensor, or None (no snap)
    norm_mean: Any              # [latent_size]
    norm_std: Any
    latent_size: int = 3
    compute_dtype: Any = None   # e.g. torch.bfloat16 for the denoiser

    def __post_init__(self):
        self._denoise_model = self._cond_model = self.denoiser
        if self.compute_dtype is not None and self.denoiser is not None:
            self._denoise_model = copy.deepcopy(self.denoiser).to(self.compute_dtype)
            self._cond_model = rounded_copy(self.denoiser, self.compute_dtype)

    def condition(self, extras):
        """The denoiser's conditioning in the compute dtype (JAX
        `_compute_condition` on the cast params)."""
        cond = self._cond_model.compute_condition(extras["res_type"], extras["cg_xyz"],
                                                  extras["mask"])
        if self.compute_dtype is not None:
            cond = {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                    for k, v in cond.items()}
        return cond

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
        cond = self.condition(extras)
        model = self._denoise_model
        cd = self.compute_dtype

        def model_fn(x, t):
            return model.denoise(x if cd is None else x.to(cd), t, cond).to(torch.float32)

        return self.process.p_sample_loop(model_fn, noise.shape, noise=noise,
                                          noises=noises, generator=generator)

    @torch.no_grad()
    def encode_latents(self, batch):
        """The recon path's pre-VQ encoder latents [B, L, vqdim]."""
        return self.vae.encode(batch)

    def _norm(self, dev):
        return (torch.as_tensor(self.norm_mean, dtype=torch.float32, device=dev),
                torch.as_tensor(self.norm_std, dtype=torch.float32, device=dev))

    def normalise(self, latents):
        mean, std = self._norm(latents.device)
        return (latents - mean) / std

    @torch.no_grad()
    def decode(self, batch, latents_norm, return_codes=False):
        """De-normalise, snap to the codebook, decode -> (ic, xyz14), and the
        VQ codes [B, L] (None without a codebook) with return_codes."""
        mean, std = self._norm(latents_norm.device)
        latents = latents_norm * std + mean
        codes = None
        if self.codebook is not None:
            latents, codes, _ = vq_quantize(self.codebook, latents, batch["res_mask"])
        ic = self.vae.decode(batch, latents)
        xyz = ic_to_xyz14(batch["cg_xyz_og"], ic, batch["res_type"])
        return (ic, xyz, codes) if return_codes else (ic, xyz)

    def sample_and_decode(self, batch, generator=None, noise=None, noises=None):
        """Conditioning -> latents -> structure: (ic [B, L, 13, 3],
        xyz14 [B, L, 14, 3])."""
        extras = {"res_type": batch["res_type"],
                  "cg_xyz": batch["cg_xyz_og"][:, 1:-1],
                  "mask": batch["res_mask"]}
        lat = self.sample_latents(extras, generator=generator, noise=noise, noises=noises)
        return self.decode(batch, lat)


@torch.no_grad()
def evaluate_structures(batch, ic_recon, xyz14_gen, per_frame=False):
    """The full per-batch metric set (JAX `evaluate_structures`): batch
    means as 0-d tensors, or with per_frame=True the per-frame rmsd,
    rmsd_aligned, graph_valid_ratio and graph_diff_ratio as [B] tensors."""
    keep = (~batch["endpoint_mask"].bool())[..., None] & batch["atom_mask"].bool()
    zero = torch.zeros((), dtype=xyz14_gen.dtype, device=xyz14_gen.device)
    xyz_gen = torch.where(keep[..., None], xyz14_gen, zero)
    xyz_ref = torch.where(keep[..., None], batch["xyz14"], zero)
    B = xyz_gen.shape[0]
    flat_gen, flat_ref = xyz_gen.reshape(B, -1, 3), xyz_ref.reshape(B, -1, 3)
    flat_mask = keep.reshape(B, -1)
    frames = {"rmsd": M.unaligned_rmsd(flat_gen, flat_ref, flat_mask),
              "rmsd_aligned": M.kabsch_rmsd(flat_ref, flat_gen, flat_mask)}
    valid, ratio = M.graph_validity(xyz_gen, xyz_ref, batch["res_type"], keep)
    frames["graph_valid_ratio"], frames["graph_diff_ratio"] = valid, ratio
    if per_frame:
        return frames
    bond, angle, torsion = ic_terms(batch, ic_recon)
    return {
        "rmsd": frames["rmsd"].mean(),
        "rmsd_aligned": frames["rmsd_aligned"].mean(),
        "ged": M.ged_score(xyz_gen, xyz_ref, batch["bond_edges"], batch["bond_edges_mask"]),
        "clash": M.clash_ratio(xyz_gen, batch["clash_edges"], batch["clash_edges_mask"],
                               batch["bb_no_edges"], batch["bb_no_edges_mask"]),
        "inter": M.interaction_scores(xyz_gen, batch["inter_edges"],
                                      batch["inter_edges_mask"], batch["pipi_pairs"],
                                      batch["pipi_pairs_mask"])[0],
        "xyz": xyz_term(batch["atom_mask"], xyz_gen, xyz_ref),
        "bond": bond, "angle": angle, "torsion": torsion,
        "graph_valid_ratio": valid.mean(), "graph_diff_ratio": ratio.mean(),
    }
