"""One f32 Stage-1 train step of the port (`make_vqvae_step`, on the CPU with
the plain versions of the kernels) against the JAX package's, from the same
converted random weights, batch (2 synthetic frames of 26 residues; 2
encoder and 2 decoder layers) and VQ state, with the JAX chain
optax.chain(clip_by_global_norm(5), adamw(1e-3)) (weight decay 1e-4).

Tolerances: loss and every metric rtol 1e-5; each parameter's grad max|d|
<= 1e-3 max|g| of that parameter; params after the step within 1e-6 where
the step's |g| >= 1e-3 max|g| of the parameter, else within 2 lr (Adam's
first step is lr * sign(g), which a near-zero gradient may take either way
in two packages); the VQ state within 1e-6 + 1e-6 relative. The random
weights are scaled by 0.5, so that the loss stays under the skip threshold,
and get physical bond-length and side-chain-angle tables (N(1.5, 0.05) Å,
N(1.95, 0.1) rad): random tables of ~0.1 Å place atoms on top of each
other, where every NeRF frame is ill-conditioned in f32 in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np

from _torch_parity import (JaxVAE, check_vqvae_step, random_params, stage1_batch,
                           stage1_vq_state, vqvae_step_pair)


def test_vqvae_step_matches_jax_random_weights():
    nb = stage1_batch(seed=3)
    params = random_params(JaxVAE(embed_dim=36, vqdim=3, enc_nconv=2, dec_nconv=2), 4,
                           {k: jnp.asarray(v) for k, v in nb.items()})
    params = jax.tree.map(lambda p: p * 0.5, params)
    rng = np.random.default_rng(9)
    dec = params["params"]["decoder"]
    for name, mean, std in (("Embed_0", 1.5, 0.05), ("Embed_1", 1.5, 0.05),
                            ("Embed_3", 1.95, 0.1)):
        shape = dec[name]["embedding"].shape
        dec[name]["embedding"] = jnp.asarray(mean + std * rng.normal(size=shape), jnp.float32)
    check_vqvae_step(*vqvae_step_pair(nb, params, stage1_vq_state(6, 64, 3, 0.5),
                                      dict(zeta=5.0, omega=3.0), 2, 2))
