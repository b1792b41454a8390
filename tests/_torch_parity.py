"""Shared helpers for the torch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and go through the JAX reference and
the port on the CPU, in f32. Parameters are drawn with numpy at the shapes
of the JAX module's init (no zero-initialised adaLN gates, so every weight
reaches the output) and reach the port through
`codlad_tpu_torch.convert.from_flax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from codlad_tpu.models import denoiser as jax_denoiser_mod
from codlad_tpu.nn import mpnn as jax_mpnn
from codlad_tpu_torch.convert.from_flax import load_flax
from codlad_tpu_torch.data.cg_batch import random_ca_trace
from codlad_tpu_torch.models.denoiser import MPNNDenoiser

SMALL = dict(hidden_dim=32, edge_features=32, num_encoder_layers=2,
             num_decoder_layers=1, k_neighbors=16)


def random_params(module, seed, *args, **kwargs):
    """Parameters of module.init(key, *args, **kwargs), drawn from
    N(0, 1/fan_in) for matrices and N(0, 0.01) for vectors."""
    shapes = jax.eval_shape(
        lambda k: module.init(k, *args, **kwargs), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(s):
        std = 1.0 / np.sqrt(s.shape[0]) if len(s.shape) > 1 else 0.1
        return jnp.asarray(std * rng.normal(size=s.shape), jnp.float32)

    return jax.tree.map(draw, shapes)


def jax_apply(module, params, *args, **kwargs):
    """module.apply under jit (arguments are baked in as constants)."""
    return jax.jit(lambda p: module.apply(p, *args, **kwargs))(params)


def exact_gathers(monkeypatch):
    """Run the JAX featurizer's neighbour gathers in 'idx' mode.

    At L <= 256 its 'auto' mode gathers through a bf16 one-hot matmul (a TPU
    device), which rounds the C-alpha coordinates to bf16; the port gathers
    exactly, so parity is checked against the JAX package's exact mode."""
    orig = jax_mpnn.make_neighbor_gather

    def idx_only(E_idx, mode="auto", dtype=jnp.bfloat16, n_nodes=None):
        return orig(E_idx, mode="idx", dtype=dtype, n_nodes=n_nodes)

    monkeypatch.setattr(jax_mpnn, "make_neighbor_gather", idx_only)
    monkeypatch.setattr(jax_denoiser_mod, "make_neighbor_gather", idx_only)


def ca_inputs(seed, B, L, n_valid=None):
    """(res_type [B, L] int32, cg [B, L, 3] f32, mask [B, L] f32) from
    random C-alpha walks; frames hold n_valid[b] valid residues."""
    rng = np.random.default_rng(seed)
    n_valid = n_valid or [L] * B
    cg = np.zeros((B, L, 3), np.float32)
    mask = np.zeros((B, L), np.float32)
    for b, n in enumerate(n_valid):
        cg[b, :n] = random_ca_trace(rng, n)
        mask[b, :n] = 1.0
    res_type = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    return res_type, cg, mask


def denoiser_pair(seed, res_type, cg, mask, **overrides):
    """(jax model, jittered params, torch model with the same weights)."""
    cfg = dict(SMALL, **overrides)
    model = jax_denoiser_mod.mpnn_diffusion(input_size=3, learn_sigma=True,
                                            dropout=0.0, **cfg)
    params = random_params(model, seed, jnp.zeros(cg.shape),
                           jnp.zeros((cg.shape[0],), jnp.int32), res_type, cg, mask)
    port = MPNNDenoiser(torch.Generator().manual_seed(seed), **cfg)
    return model, params, load_flax(port, params)


def t(x, dtype=None):
    """numpy / jax array -> torch CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def replay_ancestral_noises(rng, n_steps, shape):
    """The per-step z that JAX's `p_sample_loop` draws from `rng` (its
    split chain, codlad_tpu/gen/diffusion.py:250-259 with p_sample's
    split at :203), as numpy arrays."""
    zs = []
    for _ in range(n_steps):
        rng, sub = jax.random.split(rng)
        _, k_noise = jax.random.split(sub)
        zs.append(np.asarray(jax.random.normal(k_noise, shape)))
    return zs
