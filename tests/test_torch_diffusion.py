"""The port's diffusion schedules and samplers against the JAX package,
in f32 on the CPU, with the JAX chain's noise injected.

The first steps predict x_0 as sqrt(1/acp) x - sqrt(1/acp - 1) eps with
sqrt(1/acp) ~ 70 at t=900, so samples reach tens and are compared at
rtol 1e-5 (atol 1e-5): a few f32 ulps of their magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import replay_ancestral_noises, t
from codlad_tpu.gen import diffusion as JD
from codlad_tpu_torch.gen import diffusion as TD

SHAPE = (2, 7, 3)


def _jax_model(x, tb, rng, learn_sigma=True):
    s = jnp.tanh(0.7 * x + tb[:, None, None] / 1000.0)
    return jnp.concatenate([s, jnp.sin(x)], axis=-1) if learn_sigma else s


def _torch_model(x, tb, learn_sigma=True):
    s = torch.tanh(0.7 * x + tb[:, None, None] / 1000.0)
    return torch.cat([s, torch.sin(x)], dim=-1) if learn_sigma else s


@pytest.mark.parametrize("respacing", ["ddim100", "ddim10", "250,100", "100"])
def test_respaced_schedule_matches_jax(respacing):
    assert TD.space_timesteps(1000, respacing) == JD.space_timesteps(1000, respacing)
    jd = JD.create_diffusion(respacing, diffusion_steps=1000)
    td = TD.create_diffusion(respacing, diffusion_steps=1000)
    np.testing.assert_array_equal(td.timestep_map.numpy(), np.asarray(jd.timestep_map))
    for key, val in td._sched.items():
        if key in jd._sched:
            np.testing.assert_array_equal(val.numpy(), np.asarray(jd._sched[key]))


# the production process (learned range, epsilon, 3 latent channels), the
# other variance and mean types, and 2-channel angle data (wrapped to [-1, 1))
@pytest.mark.parametrize("kw,channels", [
    (dict(), 3),
    (dict(learn_sigma=False, sigma_small=True), 3),
    (dict(learn_sigma=False, predict_xstart=True), 3),
    (dict(), 2),
])
def test_p_sample_loop_with_injected_noise_matches_jax(kw, channels):
    shape = SHAPE[:2] + (channels,)
    learn = kw.get("learn_sigma", True)
    jd = JD.create_diffusion("ddim10", diffusion_steps=1000, **kw)
    td = TD.create_diffusion("ddim10", diffusion_steps=1000, **kw)
    rng = jax.random.PRNGKey(3)
    x_T = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jm = lambda x, tb, r: _jax_model(x, tb, r, learn)
    want = jax.jit(lambda r: jd.p_sample_loop(r, jm, shape, noise=jnp.asarray(x_T)))(rng)
    zs = [t(z) for z in replay_ancestral_noises(rng, td.num_timesteps, shape)]
    got = td.p_sample_loop(lambda x, tb: _torch_model(x, tb, learn), shape,
                           noise=t(x_T), noises=zs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ddim_sample_loop_eta0_matches_jax():
    jd = JD.create_diffusion("ddim10", diffusion_steps=1000)
    td = TD.create_diffusion("ddim10", diffusion_steps=1000)
    x_T = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)
    want = jax.jit(lambda r: jd.ddim_sample_loop(r, _jax_model, SHAPE,
                                                 noise=jnp.asarray(x_T), eta=0.0))(
        jax.random.PRNGKey(0))
    got = td.ddim_sample_loop(_torch_model, SHAPE, noise=t(x_T), eta=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sampler_draws_from_the_given_generator():
    td = TD.create_diffusion("ddim10", diffusion_steps=1000)
    run = lambda seed: td.p_sample_loop(_torch_model, SHAPE, device="cpu",
                                        generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_ddim_sample_loop_eta_matches_jax_with_injected_noise():
    """DDIM at eta 0.5 adds z at every step: with JAX's z replayed (the same
    split chain as the ancestral sampler's) the loops agree."""
    jd = JD.create_diffusion("ddim10", diffusion_steps=1000)
    td = TD.create_diffusion("ddim10", diffusion_steps=1000)
    rng = jax.random.PRNGKey(4)
    x_T = np.random.default_rng(2).normal(size=SHAPE).astype(np.float32)
    want = jax.jit(lambda r: jd.ddim_sample_loop(r, _jax_model, SHAPE,
                                                 noise=jnp.asarray(x_T), eta=0.5))(rng)
    zs = [t(z) for z in replay_ancestral_noises(rng, td.num_timesteps, SHAPE)]
    got = td.ddim_sample_loop(_torch_model, SHAPE, noise=t(x_T), noises=zs, eta=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_ddim_sample_loop_eta_draws_from_the_given_generator():
    td = TD.create_diffusion("ddim10", diffusion_steps=1000)
    x_T = torch.zeros(SHAPE)
    run = lambda seed, eta: td.ddim_sample_loop(
        _torch_model, SHAPE, noise=x_T, eta=eta, generator=torch.Generator().manual_seed(seed))
    a, b, c = run(0, 0.5), run(0, 0.5), run(1, 0.5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(run(0, 0.0), run(1, 0.0))     # eta 0 draws nothing
