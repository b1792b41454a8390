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
        vae=load_flax(VAE(gen, embed_dim=8, vqdim=3, dec_nconv=2, encoder=False), vae_params),
        codebook=codebook_from_flax(codebook, device="cpu"),
        norm_mean=norm_mean, norm_std=norm_std)
    ic, xyz = pipe.sample_and_decode({k: t(v) for k, v in batch.items()},
                                     noise=t(x_T), noises=zs)
    assert xyz.shape == (B, L, 14, 3) and torch.isfinite(xyz).all()
    np.testing.assert_allclose(ic.numpy(), np.asarray(ic_want), atol=1e-4)
    np.testing.assert_allclose(xyz.numpy(), np.asarray(xyz_want), atol=1e-4)


def test_bf16_condition_matches_jax_harness(monkeypatch):
    """With compute_dtype bf16 the conditioning comes from the weights
    rounded to bf16 (f32 arithmetic), then is cast, as the JAX harness does
    (`_cast` of the params, then `_compute_condition`). Both sides then
    differ only by f32 summation order, which moves an element to the
    neighbouring bf16 value only where it lies within rounding noise of a
    rounding boundary: at most 0.5% of the h_E0 / h_S / mask_attend
    elements may differ, each by one bf16 ulp (|d| <= 2^-7 |ref|, + 1e-6
    max|ref| for values near zero, where the f32 order noise itself is
    larger than an ulp). The
    self-edge column of h_E0 (k = 0) is held at 2e-3 + one ulp instead: its
    quaternion features amplify f32 rounding to ~3e-4 in either package
    (tests/test_torch_mpnn.py holds it at 2e-3 in f32). The trace is
    jittered off the exact 3.8 Å ties so that the kNN order is the same on
    both sides. The order this replaced (condition from the f32 weights,
    then cast) moves about half of the h_E0 elements; the test checks that
    it would fail."""
    exact_gathers(monkeypatch)
    batch = synthetic_cg_batch(2, 30, seed=3, L=32)
    mask = batch["res_mask"].astype(np.float32)
    cg = batch["cg_xyz_og"][:, 1:-1]
    cg = (cg + 0.1 * np.random.default_rng(4).standard_normal(cg.shape)).astype(np.float32)
    model, params, port = denoiser_pair(2, batch["res_type"], cg, mask)
    jax_pipe = JaxPipeline(denoiser=model, denoiser_params=params, process=None,
                           process_kind="diffusion", vae=None, vae_params=None, vq_state=None,
                           norm_mean=np.zeros(3), norm_std=np.ones(3),
                           compute_dtype=jnp.bfloat16)
    extras = {"res_type": batch["res_type"], "cg_xyz": cg, "mask": mask}
    want = jax_pipe._compute_condition(jax_pipe._cast(params),
                                       {k: jnp.asarray(v) for k, v in extras.items()})
    textras = {k: t(v) for k, v in extras.items()}
    pipe = SamplingPipeline(denoiser=port, process=None, vae=None, codebook=None,
                            norm_mean=np.zeros(3), norm_std=np.ones(3),
                            compute_dtype=torch.bfloat16)
    with torch.no_grad():
        got = pipe.condition(textras)
        old = {k: v.to(torch.bfloat16) for k, v in port.compute_condition(
            textras["res_type"], textras["cg_xyz"], textras["mask"]).items()
               if v.is_floating_point()}
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["nbr"]["idx"]))

    def differing(a, key, sl=np.s_[...]):
        """(share of elements that differ, all within one ulp)."""
        ref = np.asarray(want[key].astype(jnp.float32))[sl]
        d = np.abs(a[key].float().numpy()[sl] - ref)
        return (d > 0).mean(), bool(np.all(d <= 2.0 ** -7 * np.abs(ref)
                                           + 1e-6 * np.abs(ref).max()))

    for key in ("h_S", "mask_attend", "maskf"):
        assert got[key].dtype == torch.bfloat16
        share, ulp = differing(got, key)
        assert share <= 5e-3 and ulp, (key, share)
    assert got["h_E0"].dtype == torch.bfloat16
    share, ulp = differing(got, "h_E0", np.s_[:, :, 1:])
    assert share <= 5e-3 and ulp, share
    self_ref = np.asarray(want["h_E0"].astype(jnp.float32))[:, :, :1]
    self_d = np.abs(got["h_E0"].float().numpy()[:, :, :1] - self_ref)
    assert np.all(self_d <= 2e-3 + 2.0 ** -7 * np.abs(self_ref))
    assert differing(old, "h_E0", np.s_[:, :, 1:])[0] > 0.1
