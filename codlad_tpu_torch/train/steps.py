"""Stage-2 train and eval steps (diffusion).

Counterpart of `make_latent_step` in codlad_tpu/train/steps.py for
process_kind="diffusion" (flows, the backbone objective, sequence sharding
and distillation are not ported). With `compute_dtype` the network runs on
a copy of the f32 master params cast to that dtype (`functional_call`), so
the grads flow back through the cast into the f32 masters, while the
diffusion math stays in f32, as in the JAX package.

Randomness: t and the q-sample noise come from a generator seeded with the
step's integer `seed` on the batch's device, unless the caller passes them
(as the parity tests and the card-vs-CPU check do); dropout masks are keyed
by the same integer seed (nn/mpnn.py), so they do not depend on the device.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from codlad_tpu_torch.gen.timestep_sampler import UniformSampler
from codlad_tpu_torch.train.state import global_norm


def make_latent_step(model, process, *, process_kind="diffusion", ema_decay=0.9999,
                     dropout=True, compute_dtype=None):
    """(train_step, eval_step) for the denoiser `model` (an MPNNDenoiser)
    and the GaussianDiffusion `process`."""
    if process_kind != "diffusion":
        raise NotImplementedError(f"process_kind {process_kind!r} is not ported")
    sampler = UniformSampler(process.num_timesteps)

    def model_apply(params, x, t, seed, extras, train=True):
        use_dropout = dropout and train
        res_type, cg = extras["res_type"], extras["cg_xyz"]
        if compute_dtype is not None:
            params = {k: v.to(compute_dtype) if v.is_floating_point() else v
                      for k, v in params.items()}
            x, cg = x.to(compute_dtype), cg.to(compute_dtype)
        out = functional_call(model, params, (x, t, res_type, cg, extras["mask"]),
                              {"deterministic": not use_dropout, "dropout_seed": seed})
        return out.to(torch.float32)

    def loss_fn(params, x1, extras, seed, train=True, t=None, noise=None):
        mask = extras["mask"]
        B, dev = x1.shape[0], x1.device
        maskf = mask.to(torch.float32)
        # batch-padding rows carry all-zero masks: normalise by the valid count
        valid = (mask.reshape(B, -1) != 0).any(dim=1).to(torch.float32)
        n_valid = torch.clamp(valid.sum(), min=1.0)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        if t is None:
            t = sampler.sample(B, gen, dev)[0]
        if noise is None:
            noise = torch.randn(x1.shape, generator=gen, device=dev)
        terms = process.training_losses(
            lambda x, tt: model_apply(params, x, tt, seed, extras, train),
            x1, t, noise, mask=maskf[..., None])
        loss = (terms["loss"] * valid).sum() / n_valid
        return loss, {"mse": ((terms["mse"] * valid).sum() / n_valid).detach()}

    def train_step(state, x1, extras, seed, t=None, noise=None):
        """One step: loss, grads of the f32 masters, clip + AdamW, EMA.
        Returns (state, metrics: loss, mse, the unclipped grad_norm and the
        grads)."""
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, aux = loss_fn(params, x1, extras, seed, t=t, noise=noise)
        gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), gs)}
        gnorm = global_norm(grads)
        state.apply_gradients(grads, gnorm)
        state.update_ema(ema_decay)
        return state, dict(aux, loss=loss.detach(), grad_norm=gnorm, grads=grads)

    @torch.no_grad()
    def eval_step(state, x1, extras, seed, t=None, noise=None):
        """The loss without dropout and without an update."""
        loss, aux = loss_fn(state.params, x1, extras, seed, train=False, t=t, noise=noise)
        return dict(aux, loss=loss)

    return train_step, eval_step
