"""`SamplingPipeline.sample_and_decode` end to end (CG batch -> ancestral
sampling over a respaced grid -> de-normalise -> VQ snap -> IC decode ->
xyz14) against the JAX pipeline, in f32 on the CPU, with the JAX run's
x_T and per-step noise injected into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import (denoiser_pair, exact_gathers, random_params,
                           replay_ancestral_noises, t)
from codlad_tpu.eval.harness import SamplingPipeline as JaxPipeline
from codlad_tpu.gen.diffusion import create_diffusion as jax_create_diffusion
from codlad_tpu.models.vae import VAE as JaxVAE
from codlad_tpu.models.vq import VQState
from codlad_tpu_torch.convert.from_flax import codebook_from_flax, load_flax
from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch
from codlad_tpu_torch.eval.harness import SamplingPipeline
from codlad_tpu_torch.gen.diffusion import create_diffusion
from codlad_tpu_torch.models.vae import VAE


def test_sample_and_decode_matches_jax(monkeypatch):
    exact_gathers(monkeypatch)
    batch = synthetic_cg_batch(2, 14, seed=7, L=16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    B, L = batch["res_type"].shape
    mask = batch["res_mask"].astype(np.float32)
    model, params, port = denoiser_pair(1, batch["res_type"],
                                        batch["cg_xyz_og"][:, 1:-1], mask)
    rng = np.random.default_rng(8)
    codebook = rng.normal(size=(64, 3)).astype(np.float32)
    norm_mean = np.array([0.1, -0.2, 0.05], np.float32)
    norm_std = np.array([1.5, 0.7, 1.1], np.float32)
    vae = JaxVAE(embed_dim=8, vqdim=3, dec_nconv=2)
    vae_params = random_params(vae, 9, jb, jnp.zeros((B, L, 3)), method=JaxVAE.decode)

    jax_pipe = JaxPipeline(
        denoiser=model, denoiser_params=params,
        process=jax_create_diffusion("ddim10", diffusion_steps=1000),
        process_kind="diffusion", vae=vae, vae_params=vae_params,
        vq_state=VQState(codebook=jnp.asarray(codebook), cluster_size=jnp.zeros(64),
                         embed_avg=jnp.asarray(codebook)),
        norm_mean=norm_mean, norm_std=norm_std)
    key = jax.random.PRNGKey(11)
    ic_want, xyz_want = jax_pipe.sample_and_decode(key, jb)

    # the JAX pipeline's randomness: x_T from the first split, then the chain
    key, sub = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(sub, (B, L, 3)))
    process = create_diffusion("ddim10", diffusion_steps=1000)
    zs = [t(z) for z in replay_ancestral_noises(key, process.num_timesteps, (B, L, 3))]
    gen = torch.Generator().manual_seed(0)
    pipe = SamplingPipeline(
        denoiser=port, process=process,
        vae=load_flax(VAE(gen, embed_dim=8, vqdim=3, dec_nconv=2), vae_params),
        codebook=codebook_from_flax(codebook, device="cpu"),
        norm_mean=norm_mean, norm_std=norm_std)
    ic, xyz = pipe.sample_and_decode({k: t(v) for k, v in batch.items()},
                                     noise=t(x_T), noises=zs)
    assert xyz.shape == (B, L, 14, 3) and torch.isfinite(xyz).all()
    np.testing.assert_allclose(ic.numpy(), np.asarray(ic_want), atol=1e-4)
    np.testing.assert_allclose(xyz.numpy(), np.asarray(xyz_want), atol=1e-4)
