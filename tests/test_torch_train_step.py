"""One Stage-2 training step of the port (`make_latent_step`, dropout 0,
f32, on the CPU with the plain versions of the kernels) against the JAX
package's `train_step`, from the same weights, batch, t and noise.

The JAX step is compiled once for the module. Its optimizer chain starts
with a link that records the incoming gradients in its state and passes
them on, so one run gives the loss, the grads and the updated params and
EMA. The t and the noise are JAX's own draws (the split chain of
codlad_tpu/train/steps.py:301-306 and gen/diffusion.py:339-341), replayed
here and handed to the port.

Tolerances: the forward includes the featurizer, whose self-edge
quaternions carry ~3e-4 of f32 rounding noise in both packages (see
tests/test_torch_mpnn.py), so loss and mse are held at rtol 1e-4, the grad
norm at rtol 1e-4, each parameter's grad at 1e-3 * max|grad of that
parameter|, and the updated params and EMA at atol 2e-5 + rtol 1e-5: the
first AdamW step moves a weight by lr * g / (|g| + 1e-8) with g the clipped
grad, so where g is within a few 1e-8 of zero a grad difference far inside
the grad tolerance moves the weight by up to a few percent of lr (1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import ca_inputs, exact_gathers, random_params, t
from codlad_tpu.gen import diffusion as JD
from codlad_tpu.models import denoiser as JDN
from codlad_tpu.train.state import create_train_state
from codlad_tpu.train.steps import make_latent_step as jax_make_latent_step
from codlad_tpu_torch.convert.from_flax import flax_to_state_dict, load_flax
from codlad_tpu_torch.gen import diffusion as TD
from codlad_tpu_torch.models.denoiser import MPNNDenoiser
from codlad_tpu_torch.train.state import TrainState
from codlad_tpu_torch.train.steps import make_latent_step

CFG = dict(hidden_dim=32, edge_features=32, num_encoder_layers=1,
           num_decoder_layers=1, k_neighbors=8)
LR, CLIP, EMA = 1e-3, 1.0, 0.99


@pytest.fixture(scope="module")
def runs():
    B, L = 2, 16
    res_type, cg, mask = ca_inputs(4, B, L, n_valid=[16, 11])
    x1 = np.random.default_rng(5).normal(size=(B, L, 3)).astype(np.float32)
    model = JDN.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.0, **CFG)
    params = random_params(model, 6, jnp.zeros((B, L, 3)), jnp.zeros((B,), jnp.int32),
                           res_type, cg, mask)
    process = JD.create_diffusion(None, diffusion_steps=1000, learn_sigma=True)
    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
    tx = optax.chain(record, optax.clip_by_global_norm(CLIP),
                     optax.adamw(LR, weight_decay=0.0))
    # the port's copy first: the JAX step donates (deletes) the state's arrays
    port = load_flax(MPNNDenoiser(torch.Generator().manual_seed(0), **CFG), params)
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
                                       ema_decay=EMA, dropout=False)
        new, metrics = step(state, jnp.asarray(x1), extras, rng)
        jax_out = {"loss": float(metrics["loss"]), "mse": float(metrics["mse"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "grads": flax_to_state_dict(jax.device_get(new.opt_state[0])),
                   "params": flax_to_state_dict(jax.device_get(new.params)),
                   "ema": flax_to_state_dict(jax.device_get(new.ema_params))}

    tstate = TrainState(dict(port.named_parameters()), lambda s: LR, grad_clip=CLIP)
    tstep, _ = make_latent_step(port, TD.create_diffusion(None, diffusion_steps=1000),
                                ema_decay=EMA, dropout=False)
    tstate, tm = tstep(tstate, t(x1), {"res_type": t(res_type), "cg_xyz": t(cg),
                                       "mask": t(mask)}, 0,
                       t=t(t_j).long(), noise=t(noise))
    return jax_out, tstate, tm


def test_loss_mse_and_grad_norm(runs):
    jax_out, _, tm = runs
    for key in ("loss", "mse", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), jax_out[key], rtol=1e-4, err_msg=key)
    assert jax_out["grad_norm"] > CLIP  # the step took the clipping branch


def test_every_parameter_grad(runs):
    jax_out, tstate, tm = runs
    assert set(tm["grads"]) == set(jax_out["grads"]) == set(tstate.params)
    for name, want in jax_out["grads"].items():
        got = tm["grads"][name]
        atol = 1e-3 * float(want.abs().max()) + 1e-8
        torch.testing.assert_close(got, want, atol=atol, rtol=0, msg=name)


@pytest.mark.parametrize("which", ["params", "ema"])
def test_updated_params_and_ema(runs, which):
    jax_out, tstate, _ = runs
    got = tstate.params if which == "params" else tstate.ema_params
    assert tstate.step == 1
    for name, want in jax_out[which].items():
        torch.testing.assert_close(got[name], want, atol=2e-5, rtol=1e-5, msg=name)
