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

import numpy as np
import pytest
import torch

from _torch_parity import latent_step_pair

CFG = dict(hidden_dim=32, edge_features=32, num_encoder_layers=1,
           num_decoder_layers=1, k_neighbors=8)
LR, CLIP, EMA = 1e-3, 1.0, 0.99


@pytest.fixture(scope="module")
def runs():
    return latent_step_pair(CFG, LR, CLIP, EMA)


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
