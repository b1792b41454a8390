"""Train and eval steps: Stage 2 (diffusion) and Stage 1 (VQ-VAE).

Counterparts of `make_latent_step` (process_kind="diffusion"; flows, the
backbone objective, sequence sharding and distillation are not ported) and
`make_vqvae_step` (mode "vqvae" with the plain EMA VQ) in
codlad_tpu/train/steps.py. With `compute_dtype` the network runs on
a copy of the f32 master params cast to that dtype (`functional_call`), so
the grads flow back through the cast into the f32 masters, while the
diffusion math stays in f32, as in the JAX package.

Stage-2 randomness: t and the q-sample noise come from a generator seeded with the
step's integer `seed` on the batch's device, unless the caller passes them
(as the parity tests and the card-vs-CPU check do); dropout masks are keyed
by the same integer seed (nn/mpnn.py), so they do not depend on the device.
"""

from __future__ import annotations

import math
import time

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


def weights_to_array(w):
    """LossWeights -> f32 [beta, delta, eta, zeta, omega, theta]."""
    return torch.tensor([w.beta, w.delta, w.eta, w.zeta, w.omega, w.theta],
                        dtype=torch.float32)


def _weights_from_array(a):
    from codlad_tpu_torch.train.losses import LossWeights
    v = [float(x) for x in torch.as_tensor(a, dtype=torch.float32).tolist()]
    return LossWeights(beta=v[0], delta=v[1], eta=v[2], zeta=v[3], omega=v[4], theta=v[5])


def vq_codebook_metrics(idx, mask, n_codes):
    """Codebook health: perplexity exp(H(p)) of the batch's code distribution
    (near 1 = collapse, near n_codes = uniform use) and the fraction of codes
    hit at least once, over the unmasked positions."""
    idx = idx.reshape(-1)
    w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    if mask is not None:
        m = mask.reshape(-1).to(torch.float32)
        if m.numel() == idx.numel():
            w = m
    counts = torch.zeros(n_codes, dtype=torch.float32, device=idx.device).index_add_(0, idx, w)
    p = counts / torch.clamp(counts.sum(), min=1.0)
    ent = torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)), torch.zeros_like(p))
    return torch.exp(-ent.sum()), (counts > 0).to(torch.float32).mean()


def make_vqvae_step(vae, *, vq_decay=0.99, commitment_weight=0.25, skip_loss_threshold=50.0):
    """(train_step, eval_step) of the Stage-1 VQ-VAE (mode "vqvae", plain EMA
    VQ), counterpart of `make_vqvae_step` in codlad_tpu/train/steps.py.

    train_step(state, batch, weights_arr, return_grads=False) -> (state,
    metrics): encode -> vq_train -> decode -> vqvae_loss_terms, loss =
    recon + commit, grads of the f32 master params, clip + AdamW, and the
    VQ state's EMA update. A batch whose loss is not finite or is >= 50 is
    skipped as if the step never happened: params, moments, count, step
    and VQ state stay as they were and `skipped` is 1. The decision is one
    host read of the loss a step (`sync_ms` times it), taken after the
    backward is enqueued. Plain EMA VQ draws no randomness, so the step
    takes no seed. eval_step(state, batch, weights_arr) -> the same metric
    keys with the codebook left as it is."""
    from codlad_tpu_torch.models.vq import vq_quantize, vq_train
    from codlad_tpu_torch.train.losses import vqvae_loss_terms

    def forward(params, vq_state, batch, w, train):
        h = functional_call(vae, params, (batch,))
        mask = batch["res_mask"]
        if train:
            zq, idx, vq_loss, new_vq = vq_train(vq_state, h, mask, decay=vq_decay,
                                                commitment_weight=commitment_weight)
        else:
            zq, idx, vq_loss = vq_quantize(vq_state.codebook, h, mask, commitment_weight)
            new_vq = vq_state
        perpl, usage = vq_codebook_metrics(idx, mask, vq_state.codebook.shape[0])
        ic_recon = functional_call(vae, params, (batch, zq))
        recon, metrics = vqvae_loss_terms(batch, ic_recon, w)
        loss = recon + vq_loss
        metrics = dict(metrics, vq=vq_loss, kl=torch.zeros_like(loss), loss=loss,
                       vq_perplexity=perpl, vq_usage=usage)
        return loss, {k: v.detach() for k, v in metrics.items()}, new_vq

    def train_step(state, batch, weights_arr, return_grads=False):
        w = _weights_from_array(weights_arr)
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, metrics, new_vq = forward(params, state.vq_state, batch, w, True)
        gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), gs)}
        t0 = time.perf_counter()
        value = float(loss.detach())
        sync_ms = (time.perf_counter() - t0) * 1e3
        good = math.isfinite(value) and value < skip_loss_threshold
        if good:
            state.apply_gradients(grads)
            state.vq_state = new_vq
        metrics["skipped"] = torch.tensor(0.0 if good else 1.0)
        metrics["sync_ms"] = torch.tensor(sync_ms)
        if return_grads:
            metrics["grads"] = grads
        return state, metrics

    @torch.no_grad()
    def eval_step(state, batch, weights_arr):
        _, metrics, _ = forward(state.params, state.vq_state, batch,
                                _weights_from_array(weights_arr), False)
        return metrics

    return train_step, eval_step
