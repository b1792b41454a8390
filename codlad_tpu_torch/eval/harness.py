"""Inference pipeline: latent sampling or encoding -> VQ snap -> IC decode
-> xyz14 -> metrics.

Counterpart of codlad_tpu/eval/harness.py:

* `SamplingPipeline.sample_and_decode`: ancestral or DDIM diffusion
  sampling, or for a flow `process_kind` the ODE from noise at t = 0 to
  t = 1 (gen/solvers.py `odeint`: `ode_method` euler, midpoint, rk4 or
  dopri5, `ode_steps` steps or, for dopri5, its budget of 4 x ode_steps
  attempts at `ode_rtol` / `ode_atol`; t enters the denoiser as the
  continuous f32 time, the state stays f32 and only the denoiser's input is
  cast), with the VQ snap, with sequence sharding (`seq`, a
  parallel/sequence.SeqGroup: each seq rank runs the conditioning and every
  denoise on its block of the residues, the ring-kNN and all-gathered node
  tables of the seq-mode denoiser; the draws are the whole batch's, sliced,
  so a sharded draw is the dense draw, and the latents are all-gathered at
  the end; JAX `_sample_sharded`), with classifier-free guidance at `cfg_scale` != 0 (JAX
  `_sample_from_cond_cfg`): the conditioning is computed for the batch and
  for its null-token copy (res_type vocab - 1, the CG trace kept), every
  step runs one denoise over cat(x, x) on cat(cond, uncond), and the mean
  channels become u + cfg_scale * (c - u) while the variance channels come
  from c (the flows' velocity channels are the mean); guidance takes
  precedence over `doubled_batch`. An sbcfm denoiser emits 2C channels
  (velocity and score) for a C-channel state, which the ODE cannot take:
  the draw raises, as the JAX pipeline's does. A self-conditioned
  process's x_self_cond is doubled with x, and cast with x to the compute
  dtype (the JAX pipeline passes it in f32, which promotes its bf16
  network's activations to f32). With `compute_dtype` set, the weights
  are rounded to that dtype first, as the JAX pipeline's `_cast` does: the
  denoiser runs on a copy of them in that dtype, the conditioning is
  computed in f32 arithmetic from the rounded weights and then cast, and
  the sampler's schedule arithmetic and the decode stay in f32. `doubled_batch`
  reproduces the reference's doubled batch (test.py:504-535): every
  denoise runs on the batch concatenated with itself and the first half of
  its output is kept, so the samples are those of the undoubled batch for
  the same noise.
* `SamplingPipeline.encode_latents` + `decode`: the `--experiment recon`
  path (pre-VQ encoder latents, de-normalise, snap, decode); the pipeline
  then needs no denoiser. The snap is the run's `quantizer` with its
  `vq_state` (`codebook=` builds a plain EMA VQ's); with no state (FSQ,
  the modes without VQ) nothing is snapped, as in JAX.
* `evaluate_structures`: the per-batch metric set.
* `run_ensemble`: an ensemble of draws per batch, the mean of the members'
  metrics and DIV, as `--experiment latent` / `prior` report them.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch

from codlad_tpu_torch.eval import metrics as M
from codlad_tpu_torch.gen.solvers import odeint
from codlad_tpu_torch.geometry.internal import ic_to_xyz14
from codlad_tpu_torch.models.vq import Quantizer, VQState
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
    codebook: Any               # a plain EMA VQ's [n_codes, vqdim] tensor (sets quantizer
                                # and vq_state), or None
    norm_mean: Any              # [latent_size]
    norm_std: Any
    latent_size: int = 3
    compute_dtype: Any = None   # e.g. torch.bfloat16 for the denoiser
    sampler: str = "ancestral"  # 'ancestral' | 'ddim'
    ddim_eta: float = 0.0       # DDIM only: 0 deterministic given x_T
    doubled_batch: bool = False
    cfg_scale: float = 0.0      # != 0: classifier-free guidance
    quantizer: Any = None       # models.vq.Quantizer of the run
    vq_state: Any = None        # its state (a list for rvq / multihead); None: no snap
    process_kind: str = "diffusion"  # 'diffusion' | a flow name (gen/flow.py)
    ode_steps: int = 100        # flows: the solver's steps (dopri5: a quarter of its budget)
    ode_method: str = "euler"   # flows: euler | midpoint | rk4 | dopri5
    ode_rtol: float = 1e-5      # dopri5's tolerances
    ode_atol: float = 1e-5
    seq: Any = None             # parallel/sequence.SeqGroup: sequence-sharded sampling

    def __post_init__(self):
        if self.sampler not in ("ancestral", "ddim"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        self.last_ode = {}      # a flow draw's nfe (and dopri5's attempts, host reads)
        if self.codebook is not None:
            self.quantizer = Quantizer("vqvae", *self.codebook.shape)
            self.vq_state = VQState.of_codebook(self.codebook)
        self._denoise_model = self._cond_model = self.denoiser
        if self.compute_dtype is not None and self.denoiser is not None:
            self._denoise_model = copy.deepcopy(self.denoiser).to(self.compute_dtype)
            self._cond_model = rounded_copy(self.denoiser, self.compute_dtype)

    def condition(self, extras):
        """The denoiser's conditioning in the compute dtype (JAX
        `_compute_condition` on the cast params)."""
        cond = self._cond_model.compute_condition(extras["res_type"], extras["cg_xyz"],
                                                  extras["mask"], seq=self.seq)
        if self.compute_dtype is not None:
            cond = {k: v.to(self.compute_dtype) if v.is_floating_point() else v
                    for k, v in cond.items()}
        return cond

    @torch.no_grad()
    def sample_latents(self, extras, generator=None, noise=None, noises=None,
                       step_hook=None):
        """Normalised latents [B, L, latent_size] given the CG conditioning
        (res_type, cg_xyz [B, L, 3], mask). `noise` is x_T; `noises` the
        per-step z of the ancestral sampler or of DDIM at eta > 0 (both
        drawn from `generator` when not given); `step_hook(i)` runs on the
        host before step i."""
        res_type = extras["res_type"]
        B, L = res_type.shape
        dev = res_type.device
        if noise is None:
            noise = torch.randn((B, L, self.latent_size), generator=generator, device=dev)
        seq = self.seq
        if seq is not None:
            if L % seq.size:
                raise ValueError(f"sequence length {L} must divide by the {seq.size} seq "
                                 "shards (pick a compatible padding bucket)")
            n = L // seq.size
            cols = slice(seq.rank * n, (seq.rank + 1) * n)
            if noises is None and (self.process_kind == "diffusion"
                                   and (self.sampler == "ancestral" or self.ddim_eta != 0.0)):
                # every step's z of the whole batch, in the order a dense draw takes them
                noises = [torch.randn(noise.shape, generator=generator, device=dev)
                          for _ in range(self.process.num_timesteps)]
            noise = noise[:, cols]
            noises = None if noises is None else [z[:, cols] for z in noises]
            extras = {k: v[:, cols] for k, v in extras.items()}
            res_type = extras["res_type"]
        cfg = float(self.cfg_scale or 0.0)
        if cfg != 0.0:
            null = torch.full_like(res_type, self._denoise_model.vocab - 1)
            uncond = self.condition(dict(extras, res_type=null))
            cond = {k: torch.cat([v, uncond[k]], 0) for k, v in self.condition(extras).items()}
        else:
            if self.doubled_batch:
                extras = {k: torch.cat([v, v], 0) for k, v in extras.items()}
            cond = self.condition(extras)
        doubled = cfg != 0.0 or self.doubled_batch
        model = self._denoise_model
        cd = self.compute_dtype
        C = self.latent_size

        def model_fn(x, t, x_self_cond=None):
            x = x if cd is None else x.to(cd)
            if x_self_cond is not None and cd is not None:
                x_self_cond = x_self_cond.to(cd)
            if doubled:
                x, t = torch.cat([x, x], 0), torch.cat([t, t], 0)
                if x_self_cond is not None:
                    x_self_cond = torch.cat([x_self_cond, x_self_cond], 0)
            out = model.denoise(x, t, cond, x_self_cond=x_self_cond,
                                seq=seq).to(torch.float32)
            if cfg == 0.0:
                return out[:B]
            c, u = out[:B], out[B:]
            return torch.cat([u[..., :C] + cfg * (c[..., :C] - u[..., :C]), c[..., C:]], -1)

        if self.process_kind != "diffusion":
            out = self._integrate(model_fn, noise, step_hook)
        else:
            kw = dict(noise=noise, noises=noises, generator=generator, step_hook=step_hook)
            if self.sampler == "ddim":
                out = self.process.ddim_sample_loop(model_fn, noise.shape, eta=self.ddim_eta,
                                                    **kw)
            else:
                out = self.process.p_sample_loop(model_fn, noise.shape, **kw)
        if seq is not None:
            from codlad_tpu_torch.parallel.sequence import seq_all_gather
            out = seq_all_gather(out, seq)
        return out

    def _integrate(self, model_fn, noise, step_hook=None):
        """A flow draw: the ODE dx/dt = model_fn(x, t) from the noise at t = 0
        to t = 1 (JAX `_run_process`'s flow branch)."""
        B, C = noise.shape[0], noise.shape[-1]

        def velocity(t, x):
            out = model_fn(x, t.expand(B))
            if out.shape[-1] != C:
                raise ValueError(
                    f"the denoiser emits {out.shape[-1]} channels for a {C}-channel ODE state "
                    f"(sbcfm's velocity and score): x + dt f cannot broadcast, and the JAX "
                    f"pipeline fails at the same point")
            return out

        stats = {}
        x, nfe = odeint(velocity, noise.to(torch.float32), 0.0, 1.0, steps=self.ode_steps,
                        method=self.ode_method, rtol=self.ode_rtol, atol=self.ode_atol,
                        stats=stats, step_hook=step_hook)
        self.last_ode = dict(stats, nfe=nfe)
        return x

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
        """De-normalise, snap with the quantizer, decode -> (ic, xyz14), and
        the VQ codes [B, L] (None without a VQ state) with return_codes."""
        mean, std = self._norm(latents_norm.device)
        latents = latents_norm * std + mean
        codes = None
        if self.vq_state is not None:
            latents, codes, _, _ = self.quantizer.quantize(self.vq_state, latents,
                                                           batch["res_mask"])
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


def _flat_atoms(batch, xyz14):
    """xyz14 [B, L, 14, 3] -> [B, L * 14, 3] with the endpoint and missing
    atoms zeroed, and that mask [B, L * 14]."""
    keep = (~batch["endpoint_mask"].bool())[..., None] & batch["atom_mask"].bool()
    zero = torch.zeros((), dtype=xyz14.dtype, device=xyz14.device)
    B = xyz14.shape[0]
    return torch.where(keep[..., None], xyz14, zero).reshape(B, -1, 3), keep.reshape(B, -1)


@torch.no_grad()
def run_ensemble(pipeline, batch, num_ensemble, seed=0, sample_fn=None,
                 return_structures=False, log_fn=None, fold=1):
    """Draw an ensemble of num_ensemble structures per frame of `batch` and
    score it (codlad_tpu/eval/harness.py `run_ensemble`; reference
    test.py:455-710). sample_fn(generator, batch) -> (ic, xyz14) replaces
    the pipeline's sample_and_decode (the prior experiment). Member s draws
    from torch.Generator(device).manual_seed(seed + s); with fold > 1, f
    members come from one call on the batch tiled f times, drawn from one
    generator seeded from seed and s (JAX: fold_in(PRNGKey(seed), s); other
    noise than the unfolded members', so equal in distribution only). log_fn(s, metrics) is called
    per member. Returns the members' mean per metric, `div`,
    `rmsd_ref_ens`, `rmsd_gen_ens` and `per_ensemble` (the members' metric
    dicts), and with return_structures also the xyz14 stack [S, B, L, 14,
    3] as a numpy array."""
    if sample_fn is None:
        sample_fn = lambda g, b: pipeline.sample_and_decode(b, generator=g)
    dev = batch["res_type"].device
    B = batch["res_type"].shape[0]
    gens, structures, per_sample = [], [], []
    s = 0
    while s < num_ensemble:
        f = min(max(int(fold), 1), num_ensemble - s)
        if f == 1:
            chunks = [sample_fn(torch.Generator(dev).manual_seed(seed + s), batch)]
        else:
            big = {k: torch.cat([v] * f, 0) for k, v in batch.items()}
            g = torch.Generator(dev).manual_seed((seed * 1_000_003 + s) % 2 ** 63)
            ic_f, xyz_f = sample_fn(g, big)
            chunks = [(ic_f[i * B:(i + 1) * B], xyz_f[i * B:(i + 1) * B]) for i in range(f)]
        for ic, xyz14 in chunks:
            m = {k: float(v) for k, v in evaluate_structures(batch, ic, xyz14).items()}
            per_sample.append(m)
            if log_fn is not None:
                log_fn(len(per_sample) - 1, m)
            gens.append(_flat_atoms(batch, xyz14)[0])
            if return_structures:
                structures.append(xyz14.cpu().numpy())
        s += f
    ref, flat_mask = _flat_atoms(batch, batch["xyz14"])
    div, rmsd_ref, rmsd_gen = M.diversity(torch.stack(gens), ref, flat_mask)
    agg = {k: float(np.mean([m[k] for m in per_sample])) for k in per_sample[0]}
    agg.update(div=float(div), rmsd_ref_ens=float(rmsd_ref), rmsd_gen_ens=float(rmsd_gen))
    agg["per_ensemble"] = per_sample
    if return_structures:
        return agg, np.stack(structures)
    return agg
