"""Train and eval steps: Stage 2 (diffusion) and Stage 1 (the VAE modes, GenZProt).

Counterparts of `make_latent_step` (process_kind "diffusion", with
self-conditioning, classifier-free-guidance class dropout, importance
weights for t and the per-sample aux the trainer's validation and
loss-second-moment sampler read; the flow matchers of gen/flow.py, sbcfm's
velocity-and-score loss and the `backbone` regression; sequence sharding
and distillation are not ported), `make_vqvae_step` (every mode
and quantizer) and `make_genzprot_step` in codlad_tpu/train/steps.py. With
`compute_dtype` the network runs on a copy of the f32 master params cast
to that dtype (`functional_call`), so the grads flow back through the cast
into the f32 masters, while the diffusion math stays in f32, as in the JAX
package.

Stage-2 randomness: t and the q-sample noise come from a generator seeded
with the step's integer `seed` on the batch's device, unless the caller
passes them (as the parity tests and the card-vs-CPU check do); dropout
masks are keyed by the same integer seed (nn/mpnn.py), so they do not
depend on the device. A self-conditioned process's coin is drawn on the
host from the seed; its no-grad first pass keys its dropout masks and its
class-dropout draw by `pass_seed(seed, 1)`, the main pass by the seed itself
(JAX's k_sc and k_model differ too). The coin and the class-dropout vectors
can be passed in instead.

Flow randomness: x0 ~ N(0, I), then the matcher's draws (an OT matcher's
plan pick, t, eps; gen/flow.py) come from one generator seeded with the
step's seed on the batch's device, unless `draws` holds them ({"x0", "t",
"eps", "pick"}), which is how the tests replay JAX's split chain (k_x0,
k_fm, k_drop).
"""

from __future__ import annotations

import math
import time

import torch
from torch.func import functional_call

from codlad_tpu_torch.data.batch import decompress_indices
from codlad_tpu_torch.gen.timestep_sampler import UniformSampler
from codlad_tpu_torch.kernels.mpnn_kernels import _lowbias32
from codlad_tpu_torch.train.state import global_norm

_CLASS_DROP_SITE = 0xC1A55


def pass_seed(seed, site):
    """An integer seed for one use `site` of a step's seed (a pure function
    of both, in [0, 2^31))."""
    return _lowbias32((_lowbias32(int(seed) & 0xFFFFFFFF) + site) & 0xFFFFFFFF) & 0x7FFFFFFF


def apply_class_dropout(res_type, drop, null_id):
    """Classifier-free-guidance training: where drop[b] (bool [B]) holds,
    sample b's whole residue-type sequence becomes the null token."""
    return torch.where(drop[:, None], torch.full_like(res_type, null_id), res_type)


def class_drop_draw(seed, batch, p, device):
    """The per-sample class-dropout vector (bool [batch], True with
    probability p) of one pass seeded with `seed`."""
    g = torch.Generator(device=device).manual_seed(pass_seed(seed, _CLASS_DROP_SITE))
    return torch.rand((batch,), generator=g, device=device) < p


def self_cond_coin(seed):
    """The self-conditioning coin of a step (one for the batch), drawn on
    the host: True runs the first pass."""
    return bool(torch.rand((), generator=torch.Generator().manual_seed(int(seed))) < 0.5)


def masked_l2(pred, target, mask):
    """The reference's 'l2' loss: the mean squared error over the unmasked
    tokens' channels (train_module.py:27-56)."""
    m = torch.broadcast_to(mask[..., None], pred.shape).to(pred.dtype)
    return ((pred - target) ** 2 * m).sum() / torch.clamp(m.sum(), min=1.0)


FLOW_KINDS = ("fm", "icfm", "vpfm", "otcfm", "sbcfm")


def make_latent_step(model, process, *, process_kind="diffusion", ema_decay=0.9999,
                     dropout=True, compute_dtype=None, class_dropout_prob=0.0):
    """(train_step, eval_step) for the denoiser `model` (an MPNNDenoiser)
    and `process`: the GaussianDiffusion of process_kind "diffusion", a flow
    matcher (gen/flow.py) of a flow kind, or None for "backbone" (x1
    regressed from noise at t = 1). class_dropout_prob > 0 replaces a
    training sample's sequence by the null token (vocab - 1) with that
    probability, in every pass."""
    if process_kind not in ("diffusion", "backbone") + FLOW_KINDS:
        raise ValueError(f"unknown process_kind {process_kind!r}")
    sampler = UniformSampler(process.num_timesteps) if process_kind == "diffusion" else None
    null_id = model.vocab - 1

    def model_apply(params, x, t, seed, extras, x_self_cond=None, train=True, drop=None):
        use_dropout = dropout and train
        res_type, cg = extras["res_type"], extras["cg_xyz"]
        if class_dropout_prob > 0 and train:
            if drop is None:
                drop = class_drop_draw(seed, x.shape[0], class_dropout_prob, x.device)
            res_type = apply_class_dropout(res_type, drop, null_id)
        if compute_dtype is not None:
            params = {k: v.to(compute_dtype) if v.is_floating_point() else v
                      for k, v in params.items()}
            x, cg = x.to(compute_dtype), cg.to(compute_dtype)
            if x_self_cond is not None:
                x_self_cond = x_self_cond.to(compute_dtype)
        out = functional_call(model, params, (x, t, res_type, cg, extras["mask"]),
                              {"deterministic": not use_dropout, "dropout_seed": seed,
                               "x_self_cond": x_self_cond})
        return out.to(torch.float32)

    def flow_loss_fn(params, x1, extras, seed, train, draws, class_drop):
        # masked-token means (masked_l2): padded samples add nothing to either
        # side, and `weight`, the token count, weighs validation batches
        draws = draws or {}
        mask = extras["mask"]
        token_w = mask.to(torch.float32).sum()
        gen = torch.Generator(device=x1.device).manual_seed(int(seed))
        x0 = draws.get("x0")
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=gen, device=x1.device)
        drop = class_drop[0] if isinstance(class_drop, (tuple, list)) else class_drop
        apply = lambda x, t: model_apply(params, x, t, seed, extras, train=train, drop=drop)
        if process_kind == "backbone":
            vt = apply(x0, torch.ones((x1.shape[0],), dtype=x1.dtype, device=x1.device))
            return masked_l2(vt, x1, mask), {"weight": token_w}
        t, xt, ut, eps = process.sample_location_and_conditional_flow(
            x0, x1, t=draws.get("t"), eps=draws.get("eps"), generator=gen,
            pick=draws.get("pick"), return_noise=True)
        out = apply(xt, t)
        if process_kind != "sbcfm":
            return masked_l2(out, ut, mask), {"weight": token_w}
        # sbcfm: a denoiser of 2C channels, velocity then score
        vt, st = out.chunk(2, dim=-1)
        score = torch.mean((process.compute_lambda(t)[:, None, None] * st + eps) ** 2)
        return masked_l2(vt, ut, mask) + score, {"score": score.detach(), "weight": token_w}

    def loss_fn(params, x1, extras, seed, train=True, t=None, noise=None, t_weights=None,
                self_cond=None, class_drop=None, draws=None):
        if process_kind != "diffusion":
            return flow_loss_fn(params, x1, extras, seed, train, draws, class_drop)
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
        drops = (class_drop if isinstance(class_drop, (tuple, list))
                 else (class_drop, class_drop))
        sc_seed = pass_seed(seed, 1)
        if process.self_condition and self_cond is None:
            self_cond = self_cond_coin(seed)
        terms = process.training_losses(
            lambda x, tt, **kw: model_apply(params, x, tt, seed, extras, train=train,
                                            drop=drops[0], **kw),
            x1, t, noise, mask=maskf[..., None], self_cond=self_cond,
            sc_model_fn=lambda x, tt, **kw: model_apply(params, x, tt, sc_seed, extras,
                                                        train=train, drop=drops[1], **kw))
        per_sample = terms["loss"] * valid
        if t_weights is not None:
            loss = (per_sample * t_weights).sum() / n_valid
        else:
            loss = per_sample.sum() / n_valid
        aux = {"mse": ((terms["mse"] * valid).sum() / n_valid).detach(),
               "loss_per_sample": per_sample.detach(), "t": t, "valid_mask": valid,
               "weight": n_valid}
        if process.self_condition:
            aux["self_cond"] = bool(self_cond)
        return loss, aux

    def train_step(state, x1, extras, seed, t=None, noise=None, t_weights=None,
                   self_cond=None, class_drop=None, draws=None):
        """One (micro-)step: loss, grads of the f32 masters, the optimizer
        (clip + AdamW, on every N-th micro-step under gradient accumulation)
        and the EMA. t_weights [B] weigh the per-sample losses (the
        loss-second-moment sampler's). self_cond: the self-conditioning
        coin; class_drop: the class-dropout vector (bool [B]) of both
        passes, or (main pass, first pass); draws: a flow step's injected
        draws (x0, t, eps, pick). Returns (state, metrics: loss, the
        unclipped grad_norm of this micro-step's grads, the grads, and the
        aux: diffusion's mse, loss_per_sample, t, valid_mask, weight,
        self_cond; a flow's weight (the token count) and sbcfm's score)."""
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, aux = loss_fn(params, x1, extras, seed, t=t, noise=noise, t_weights=t_weights,
                            self_cond=self_cond, class_drop=class_drop, draws=draws)
        gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), gs)}
        gnorm = global_norm(grads)
        state.apply_gradients(grads, gnorm)
        state.update_ema(ema_decay)
        return state, dict(aux, loss=loss.detach(), grad_norm=gnorm, grads=grads)

    @torch.no_grad()
    def eval_step(state, x1, extras, seed, t=None, noise=None, self_cond=None, draws=None):
        """The loss without dropout and without an update, with the aux
        (`weight`: the validation's weight, the batch's valid samples for
        diffusion and its tokens for the flows)."""
        loss, aux = loss_fn(state.params, x1, extras, seed, train=False, t=t, noise=noise,
                            self_cond=self_cond, draws=draws)
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
    hit at least once, over the unmasked positions. Multi-head and residual
    indices [..., n] repeat each position's mask over their n codes; an
    index >= n_codes (an FSQ code past the configured codebook size) is
    dropped, as JAX's scatter drops it."""
    idx = idx.reshape(-1).long()
    w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    if mask is not None:
        m = mask.reshape(-1).to(torch.float32)
        if m.numel() == idx.numel():
            w = m
        elif idx.numel() % m.numel() == 0:
            w = torch.repeat_interleave(m, idx.numel() // m.numel())
    inside = (idx >= 0) & (idx < n_codes)
    counts = torch.zeros(n_codes, dtype=torch.float32, device=idx.device).index_add_(
        0, torch.where(inside, idx, torch.zeros_like(idx)), w * inside.to(w.dtype))
    p = counts / torch.clamp(counts.sum(), min=1.0)
    ent = torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)), torch.zeros_like(p))
    return torch.exp(-ent.sum()), (counts > 0).to(torch.float32).mean()


def _grads(loss, params):
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), gs)}


def _skip_or_apply(state, loss, grads, skip_loss_threshold, new_vq=None):
    """The reference's skip rule: a batch whose loss is not finite or is >=
    the threshold leaves the whole state (params, moments, count, step, VQ
    state) as it was. One host read of the loss, timed. -> (good, ms)."""
    t0 = time.perf_counter()
    value = float(loss.detach())
    sync_ms = (time.perf_counter() - t0) * 1e3
    good = math.isfinite(value) and value < skip_loss_threshold
    if good:
        state.apply_gradients(grads)
        if new_vq is not None:
            state.vq_state = new_vq
    return good, sync_ms


def _step_generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def make_vqvae_step(vae, *, vq_decay=0.99, commitment_weight=0.25, skip_loss_threshold=50.0,
                    quantizer=None):
    """(train_step, eval_step) of the Stage-1 VAE, counterpart of
    `make_vqvae_step` in codlad_tpu/train/steps.py, for each `vae.mode`:
    vqvae (the plain EMA VQ, or `quantizer`, a models/vq.Quantizer), fgvae
    and cgvae (the latents reparametrised from (mu, sigma) in training, mu
    at eval, plus beta * KL(N(mu, sigma) || N(0, I))) and fgae (the latents
    as they are).

    train_step(state, batch, weights_arr, return_grads=False, seed=0,
    draws=None) -> (state, metrics): encode -> quantize or draw -> decode ->
    vqvae_loss_terms, loss = recon + vq + beta * kl, grads of the f32 master
    params, clip + AdamW, and the VQ state's update. The step's draws (the
    reparametrisation's eps; the Gumbel noise or the expiry rows of the
    quantizers that draw) come from a generator seeded with `seed` on the
    batch's device, unless `draws` holds them ({"eps": ..., "quantizer":
    ...}). A batch whose loss is not finite or is >= 50 is skipped as if
    the step never happened: params, moments, count, step and VQ state stay
    as they were and `skipped` is 1. The decision is one host read of the
    loss a step (`sync_ms` times it), taken after the backward is enqueued.
    The metrics are JAX's: the loss terms, vq, kl, loss and, in vqvae mode,
    vq_perplexity and vq_usage. eval_step(state, batch, weights_arr) -> the
    same keys with no draw and the state left as it is."""
    from codlad_tpu_torch.models.vq import build_quantize
    from codlad_tpu_torch.train.losses import kl_standard_normal, vqvae_loss_terms

    mode = vae.mode
    plain = quantizer is None
    if plain:   # the codebook's size comes with the state
        quantizer = build_quantize("vqvae", decay=vq_decay, commitment_weight=commitment_weight)

    def forward(params, vq_state, batch, w, train, seed=0, draws=None):
        draws = draws or {}
        batch = decompress_indices(batch)
        h, mu, sigma = functional_call(vae, params, (batch,))
        mask = batch["res_mask"]
        new_vq, zero = vq_state, torch.zeros((), dtype=torch.float32, device=h.device)
        vq_loss, kl, health = zero, zero, {}
        draws_here = mode in ("fgvae", "cgvae") or quantizer.kind in ("gumbel", "expire")
        gen = _step_generator(seed, h.device) if train and draws_here else None
        if mode == "vqvae":
            zq, idx, vq_loss, new_vq = quantizer.quantize(
                vq_state, h, mask, train=train, generator=gen, noise=draws.get("quantizer"))
            n_codes = vq_state.codebook.shape[0] if plain else quantizer.codebook_size
            perpl, usage = vq_codebook_metrics(idx, mask, n_codes)
            health = {"vq_perplexity": perpl, "vq_usage": usage}
        elif mode in ("fgvae", "cgvae"):
            if train:
                eps = draws.get("eps")
                if eps is None:
                    eps = torch.randn(sigma.shape, generator=gen, device=sigma.device)
                zq = mu + sigma * eps.to(sigma.dtype)
            else:
                zq = mu
            kl = kl_standard_normal(mu, sigma, mask)
        else:   # fgae
            zq = h
        ic_recon = functional_call(vae, params, (batch, zq))
        recon, metrics = vqvae_loss_terms(batch, ic_recon, w)
        loss = recon + vq_loss + w.beta * kl
        metrics = dict(metrics, vq=vq_loss, kl=kl, loss=loss, **health)
        return loss, {k: v.detach() for k, v in metrics.items()}, new_vq

    def train_step(state, batch, weights_arr, return_grads=False, seed=0, draws=None):
        w = _weights_from_array(weights_arr)
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, metrics, new_vq = forward(params, state.vq_state, batch, w, True, seed, draws)
        grads = _grads(loss, params)
        good, sync_ms = _skip_or_apply(state, loss, grads, skip_loss_threshold, new_vq)
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


def make_genzprot_step(model, *, beta=0.05, max_kl_free=0.01, skip_loss_threshold=50.0):
    """(train_step, eval_step) of GenZProt (models/vae.GenZProt), the
    counterpart of `make_genzprot_step` in codlad_tpu/train/steps.py: loss =
    recon + beta * max(KL(posterior || CG prior) - max_kl_free, 0), the
    decoder reading a posterior draw in training (eps from a generator
    seeded with `seed`, or `draws["eps"]`) and mu at eval; the skip rule of
    make_vqvae_step (the whole state kept). Metrics: the loss terms, kl,
    loss (and skipped, sync_ms in training)."""
    from codlad_tpu_torch.train.losses import kl_gaussians, vqvae_loss_terms

    def forward(params, batch, w, train, seed=0, draws=None):
        batch = decompress_indices(batch)
        eps = None
        if train:
            eps = (draws or {}).get("eps")
            if eps is None:
                dev = batch["res_type"].device
                eps = torch.randn(tuple(batch["res_type"].shape) + (model.embed_dim,),
                                  generator=_step_generator(seed, dev), device=dev)
        mu, sigma, pmu, psigma, ic_recon = functional_call(model, params, (batch,),
                                                           {"eps": eps})
        recon, metrics = vqvae_loss_terms(batch, ic_recon, w)
        kl = kl_gaussians(mu, sigma, pmu, psigma, batch["res_mask"])
        kl = torch.clamp(kl - max_kl_free, min=0.0)
        loss = recon + beta * kl
        return loss, {k: v.detach() for k, v in dict(metrics, kl=kl, loss=loss).items()}

    def train_step(state, batch, weights_arr, return_grads=False, seed=0, draws=None):
        w = _weights_from_array(weights_arr)
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, metrics = forward(params, batch, w, True, seed, draws)
        grads = _grads(loss, params)
        good, sync_ms = _skip_or_apply(state, loss, grads, skip_loss_threshold)
        metrics["skipped"] = torch.tensor(0.0 if good else 1.0)
        metrics["sync_ms"] = torch.tensor(sync_ms)
        if return_grads:
            metrics["grads"] = grads
        return state, metrics

    @torch.no_grad()
    def eval_step(state, batch, weights_arr):
        return forward(state.params, batch, _weights_from_array(weights_arr), False)[1]

    return train_step, eval_step
