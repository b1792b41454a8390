"""Shared helpers for the torch port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and go through the JAX reference and
the port on the CPU, in f32. Parameters are drawn with numpy at the shapes
of the JAX module's init (no zero-initialised adaLN gates, so every weight
reaches the output) and reach the port through
`codlad_tpu_torch.convert.from_flax`. The Stage-1 helpers at the end run one
`make_vqvae_step` in both packages and compare them
(tests/test_torch_vqvae_step*.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from codlad_tpu.data.batch import collate, quantize_spec, spec_for
from codlad_tpu.data.synthetic import synthetic_examples
from codlad_tpu.gen import diffusion as JD
from codlad_tpu.models import denoiser as jax_denoiser_mod
from codlad_tpu.models import vq as JVQ
from codlad_tpu.models.vae import VAE as JaxVAE
from codlad_tpu.train import losses as JL
from codlad_tpu.train.state import create_train_state
from codlad_tpu.train.steps import make_latent_step as jax_make_latent_step
from codlad_tpu.train.steps import make_vqvae_step as jax_make_vqvae_step
from codlad_tpu.train.steps import weights_to_array as jax_weights_to_array
from codlad_tpu_torch.convert.from_flax import flax_to_state_dict, load_flax
from codlad_tpu_torch.data.cg_batch import random_ca_trace
from codlad_tpu_torch.gen import diffusion as TD
from codlad_tpu_torch.models.denoiser import MPNNDenoiser
from codlad_tpu_torch.models.vae import VAE
from codlad_tpu_torch.models.vq import VQState
from codlad_tpu_torch.train import losses as TL
from codlad_tpu_torch.train.state import TrainState
from codlad_tpu_torch.train.steps import make_latent_step, make_vqvae_step, weights_to_array

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    device), which rounds the C-alpha coordinates; the port gathers
    exactly, so parity is checked against the JAX package's exact mode. The
    rule is scripts/export_flax_npz.py `idx_gather_patches`, which also
    writes the Stage-2 fixture."""
    for module, name, fn in export_script().idx_gather_patches():
        monkeypatch.setattr(module, name, fn)


def export_script():
    """scripts/export_flax_npz.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "export_flax_npz", os.path.join(REPO, "scripts", "export_flax_npz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def latent_step_pair(cfg, lr, clip, ema):
    """One f32 Stage-2 `make_latent_step` at dropout 0 in both packages, from
    the same `random_params` of the denoiser of config `cfg`, batch (B2 L16,
    one frame of 11 valid residues), t and noise: (JAX's loss, mse,
    grad_norm, grads, updated params and EMA; the port's state and metrics).

    The JAX optimizer chain starts with a link that records the incoming
    grads in its state, so one run gives all of them. The t and the noise are
    JAX's own draws (the split chain of codlad_tpu/train/steps.py:301-306 and
    gen/diffusion.py:339-341), replayed here and handed to the port."""
    B, L = 2, 16
    res_type, cg, mask = ca_inputs(4, B, L, n_valid=[16, 11])
    x1 = np.random.default_rng(5).normal(size=(B, L, 3)).astype(np.float32)
    model = jax_denoiser_mod.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.0,
                                            **cfg)
    params = random_params(model, 6, jnp.zeros((B, L, 3)), jnp.zeros((B,), jnp.int32),
                           res_type, cg, mask)
    process = JD.create_diffusion(None, diffusion_steps=1000, learn_sigma=True)
    tx = optax.chain(record_grads(), optax.clip_by_global_norm(clip),
                     optax.adamw(lr, weight_decay=0.0))
    # the port's copy first: the JAX step donates (deletes) the state's arrays
    port = load_flax(MPNNDenoiser(torch.Generator().manual_seed(0), **cfg), params)
    state = create_train_state(params, tx, with_ema=True)
    extras = {"res_type": jnp.asarray(res_type), "cg_xyz": jnp.asarray(cg),
              "mask": jnp.asarray(mask)}
    rng = jax.random.PRNGKey(3)
    k_t, k_loss = jax.random.split(rng)
    t_j = jax.random.randint(k_t, (B,), 0, process.num_timesteps)
    noise = jax.random.normal(jax.random.split(k_loss)[1], (B, L, 3))
    with pytest.MonkeyPatch.context() as mp:
        exact_gathers(mp)
        step, _ = jax_make_latent_step(model, process, process_kind="diffusion",
                                       ema_decay=ema, dropout=False)
        new, metrics = step(state, jnp.asarray(x1), extras, rng)
        jax_out = {"loss": float(metrics["loss"]), "mse": float(metrics["mse"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "grads": flax_to_state_dict(jax.device_get(new.opt_state[0])),
                   "params": flax_to_state_dict(jax.device_get(new.params)),
                   "ema": flax_to_state_dict(jax.device_get(new.ema_params))}

    tstate = TrainState(dict(port.named_parameters()), lambda s: lr, grad_clip=clip)
    tstep, _ = make_latent_step(port, TD.create_diffusion(None, diffusion_steps=1000),
                                ema_decay=ema, dropout=False)
    tstate, tm = tstep(tstate, t(x1), {"res_type": t(res_type), "cg_xyz": t(cg),
                                       "mask": t(mask)}, 0,
                       t=t(t_j).long(), noise=t(noise))
    return jax_out, tstate, tm


# ---------------------------------------------------------------------------
# Stage 1: one VQ-VAE train step in both packages

LR, CLIP = 1e-3, 5.0


def stage1_batch(seed=0, n_frames=2, n_res=26):
    ex = synthetic_examples(n_frames, n_res, seed=seed)
    return collate(ex, quantize_spec(spec_for(ex)))


def stage1_vq_state(seed, n_codes, dim, scale=1.0):
    rng = np.random.default_rng(seed)
    cb = (rng.normal(size=(n_codes, dim)) * scale).astype(np.float32)
    cs = rng.uniform(0, 2, size=n_codes).astype(np.float32)
    cs[::5] = 0.0                       # never assigned: frozen unless hit now
    return cb, cs, (cb * np.maximum(cs, 1e-3)[:, None]).astype(np.float32)


def jax_vq_state(cb, cs, ea):
    return JVQ.VQState(codebook=jnp.asarray(cb), cluster_size=jnp.asarray(cs),
                       embed_avg=jnp.asarray(ea))


def port_vq_state(cb, cs, ea):
    return VQState(codebook=t(cb), cluster_size=t(cs), embed_avg=t(ea))


def assert_params_after_step(got, want, g0, lr, err=""):
    """Elementwise within 1e-6 where the first step's |g| >= 1e-3 max|g| of
    the parameter; elsewhere within 2 lr (Adam's first step is lr sign(g))."""
    big = np.abs(g0) >= 1e-3 * np.abs(g0).max()
    d = np.abs(got - want)
    assert np.all(d[big] <= 1e-6 + 1e-6 * np.abs(want[big])), (err, d[big].max())
    assert np.all(d[~big] <= 2 * lr + 1e-6), (err, d[~big].max() if (~big).any() else 0)


def record_grads():
    """An optax link that records the incoming gradients in its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def vqvae_step_pair(nb, params, vq, weights, enc_nconv, dec_nconv):
    """(JAX new state, JAX metrics, JAX grads; port state, metrics) of one
    f32 train step from `params` (flax) and the numpy VQ state `vq`."""
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    vae_j = JaxVAE(embed_dim=36, vqdim=3, enc_nconv=enc_nconv, dec_nconv=dec_nconv)
    port = load_flax(VAE(torch.Generator().manual_seed(0), embed_dim=36, vqdim=3,
                         enc_nconv=enc_nconv, dec_nconv=dec_nconv), params)
    state_p = TrainState(dict(port.named_parameters()), lambda s: np.float32(LR),
                         grad_clip=CLIP, weight_decay=1e-4, ema=False,
                         vq_state=port_vq_state(*vq))
    step_p, _ = make_vqvae_step(port)
    state_p, m_p = step_p(state_p, {k: t(v) for k, v in nb.items()},
                          weights_to_array(TL.LossWeights(**weights)), return_grads=True)
    tx = optax.chain(record_grads(), optax.clip_by_global_norm(CLIP), optax.adamw(LR))
    state_j = create_train_state(params, tx, vq_state=jax_vq_state(*vq))
    step_j, _ = jax_make_vqvae_step(vae_j)
    state_j, m_j = step_j(state_j, jb, jax.random.PRNGKey(0),
                          jax_weights_to_array(JL.LossWeights(**weights)))
    return state_j, m_j, state_p, m_p


def check_vqvae_step(state_j, m_j, state_p, m_p):
    assert float(m_j["skipped"]) == float(m_p["skipped"]) == 0.0
    for k in m_j:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    g_j = flax_to_state_dict(state_j.opt_state[0])
    assert g_j.keys() == m_p["grads"].keys()
    p_j = flax_to_state_dict(state_j.params)
    for k, gj in g_j.items():
        gj, gp = gj.numpy(), m_p["grads"][k].numpy()
        assert np.abs(gp - gj).max() <= 1e-3 * np.abs(gj).max() + 1e-12, k
        assert_params_after_step(state_p.params[k].numpy(), p_j[k].numpy(), gj, LR, k)
    for k in ("codebook", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(state_p.vq_state, k).numpy(),
                                   np.asarray(getattr(state_j.vq_state, k)), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
