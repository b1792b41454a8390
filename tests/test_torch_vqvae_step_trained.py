"""One f32 Stage-1 train step of the port against the JAX package's from the
trained VQ-VAE of the convergence study (weights/convergence_vqvae.npz:
params, codebook and its EMA statistics cluster_size / embed_avg, exported
by scripts/export_flax_npz.py) on the four fixture frames of its val
protein (weights/convergence_vqvae_fixture.npz), at the trained config (3
encoder and 4 decoder layers), with optax.chain(clip_by_global_norm(5),
adamw(1e-3)).

Tolerances as tests/test_torch_vqvae_step.py: loss and metrics rtol 1e-5,
each parameter's grad max|d| <= 1e-3 max|g|, params after the step within
1e-6 (2 lr where the step's |g| < 1e-3 max|g|), the VQ state within 1e-6 +
1e-6 relative (the trained codebook reaches |8|, where 1e-6 is two f32
ulps of the EMA of latents that the packages round differently). The
trained model hits many angles to within ~3e-4 rad, where the angle loss's
chord turns on the last ulp of cos; the port rounds cos from float64 for
that (codlad_tpu_torch/train/losses.py `_cos`)."""

import jax
import jax.numpy as jnp
import numpy as np

from _torch_parity import check_vqvae_step, vqvae_step_pair
from codlad_tpu_torch.convert.from_flax import read_flax_npz

WEIGHTS = "weights/convergence_vqvae.npz"
FIXTURE = "weights/convergence_vqvae_fixture.npz"


def test_vqvae_step_matches_jax_trained_weights():
    w = read_flax_npz(WEIGHTS)
    assert w["cluster_size"] is not None and w["embed_avg"] is not None
    with np.load(FIXTURE) as fx:
        nb = {k[len("batch/"):]: fx[k] for k in fx.files if k.startswith("batch/")}
    params = {"params": jax.tree.map(jnp.asarray, w["params"])}
    vq = (w["codebook"], w["cluster_size"], w["embed_avg"])
    check_vqvae_step(*vqvae_step_pair(nb, params, vq, dict(zeta=5.0, omega=3.0), 3, 4))
