"""Gaussian diffusion (iDDPM lineage): schedules, respacing and samplers.

Counterpart of codlad_tpu/gen/diffusion.py for sampling and training: the
schedules are computed in float64 numpy and kept as float32 tensors, as the
JAX package keeps them; the sampling loops are Python loops over the
respaced steps; `training_losses` gives the learned-range objective (MSE +
VB, the VB rescaled by T/1000 with loss_type 'rescaled_mse'). Noise comes
from an explicit `torch.Generator`, or is injected: `noise` is x_T
(sampling) or the q-sample noise (training) and `noises[i]` the z of the
i-th ancestral step, so a test can replay another implementation's random
stream.

Model signature: model_fn(x, t_base) -> [B, ..., C or 2C], where t_base is
the base-model timestep (`timestep_map` applied). With self_condition the
process calls model_fn(x, t_base, x_self_cond=...): in sampling each step
feeds back the previous step's pred_xstart (zeros at the first); in
training a coin decides whether a no-grad first pass with zeros gives it.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def mean_flat(x, mask=None, mask_sum=None):
    """Mean over the non-batch axes, only where mask is nonzero when given.
    The divisor is the mask's own sum, unbroadcast (a [B, L, 1] mask counts
    residues, not residues x channels), as in the JAX package. mask_sum, if
    given, maps the per-sample divisors to the global ones (a sum over the
    seq ranks of a sequence-sharded batch, whose ranks each hold a block of
    residues: each rank's result is then its part of the global mean)."""
    axes = tuple(range(1, x.dim()))
    if mask is None:
        return x.mean(dim=axes)
    x = x * mask
    denom = mask.sum(dim=axes)
    if mask_sum is not None:
        denom = mask_sum(denom)
    return x.sum(dim=axes) / torch.clamp(denom, min=1.0)


def normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Discretized Gaussian log-likelihood (1/255 bins, iDDPM convention)."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus, log_delta))


def get_named_beta_schedule(name, num_steps):
    if name == "linear":
        scale = 1000 / num_steps
        return np.linspace(scale * 1e-4, scale * 0.02, num_steps, dtype=np.float64)
    if name == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.array([min(1 - alpha_bar((i + 1) / num_steps) / alpha_bar(i / num_steps),
                             0.999) for i in range(num_steps)])
    raise ValueError(name)


def space_timesteps(num_timesteps, section_counts):
    """Subset of base timesteps to keep ("ddimN" or strided sections)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} ddim steps")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx, all_steps = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += stride
        start_idx += size
    return set(all_steps)


def _wrap_pm1(x):
    """Angle wrap into [-1, 1) for 2-channel angle data."""
    return torch.remainder(x + 1, 2) - 1


class GaussianDiffusion:
    """mean_type: 'epsilon' | 'xstart'; var_type: 'learned_range' |
    'fixed_small' | 'fixed_large'; loss_type: 'mse' | 'rescaled_mse' |
    'kl'. As in the JAX package, 'kl' trains mse + vb like 'mse' (its
    `training_losses` special-cases 'rescaled_mse' only)."""

    def __init__(self, betas, mean_type="epsilon", var_type="learned_range",
                 timestep_map=None, loss_type="mse", self_condition=False):
        self.betas = np.asarray(betas, dtype=np.float64)
        self.mean_type = mean_type
        self.var_type = var_type
        self.loss_type = loss_type
        self.self_condition = self_condition
        betas = self.betas
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        sched = {
            "betas": betas,
            "alphas_cumprod": acp,
            "sqrt_acp": np.sqrt(acp),
            "sqrt_om_acp": np.sqrt(1.0 - acp),
            "sqrt_recip_acp": np.sqrt(1.0 / acp),
            "sqrt_recipm1_acp": np.sqrt(1.0 / acp - 1.0),
            "posterior_variance": post_var,
            "posterior_log_var_clipped": np.log(np.append(post_var[1], post_var[1:])),
            "posterior_mean_c1": betas * np.sqrt(acp_prev) / (1.0 - acp),
            "posterior_mean_c2": (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp),
            "log_betas": np.log(betas),
            "alphas_cumprod_prev": acp_prev,
        }
        if var_type == "fixed_large":
            sched["fixed_large_log_var"] = np.log(np.append(post_var[1], betas[1:]))
        self._sched = {k: torch.tensor(v, dtype=torch.float32) for k, v in sched.items()}
        self.timestep_map = (None if timestep_map is None
                             else torch.as_tensor(np.asarray(timestep_map), dtype=torch.int64))
        self._on = {}  # device -> (schedule, timestep map) on that device

    @property
    def num_timesteps(self):
        return len(self.betas)

    def _tables(self, device):
        key = str(device)
        if key not in self._on:
            tmap = None if self.timestep_map is None else self.timestep_map.to(device)
            self._on[key] = ({k: v.to(device) for k, v in self._sched.items()}, tmap)
        return self._on[key]

    def _extract(self, key, t, ndim):
        v = self._tables(t.device)[0][key][t]
        return v.reshape(v.shape + (1,) * (ndim - 1))

    def map_t(self, t):
        """Respaced index -> base-model timestep."""
        tmap = self._tables(t.device)[1]
        return t if tmap is None else tmap[t]

    def q_sample(self, x_start, t, noise):
        nd = x_start.dim()
        return (self._extract("sqrt_acp", t, nd) * x_start
                + self._extract("sqrt_om_acp", t, nd) * noise)

    def q_posterior_mean(self, x_start, x_t, t):
        nd = x_t.dim()
        return (self._extract("posterior_mean_c1", t, nd) * x_start
                + self._extract("posterior_mean_c2", t, nd) * x_t)

    def q_posterior(self, x_start, x_t, t):
        """(mean, variance, clipped log-variance) of q(x_{t-1} | x_t, x_0)."""
        nd = x_t.dim()
        return (self.q_posterior_mean(x_start, x_t, t),
                self._extract("posterior_variance", t, nd),
                self._extract("posterior_log_var_clipped", t, nd))

    def _predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.dim()
        return (self._extract("sqrt_recip_acp", t, nd) * x_t
                - self._extract("sqrt_recipm1_acp", t, nd) * eps)

    def _predict_eps_from_xstart(self, x_t, t, x_start):
        nd = x_t.dim()
        return ((self._extract("sqrt_recip_acp", t, nd) * x_t - x_start)
                / self._extract("sqrt_recipm1_acp", t, nd))

    def p_mean_variance(self, model_output, x, t):
        """-> dict of mean, log_variance, pred_xstart."""
        C, nd = x.shape[-1], x.dim()
        if self.var_type == "learned_range":
            model_output, var_values = model_output.chunk(2, dim=-1)
            min_log = self._extract("posterior_log_var_clipped", t, nd)
            max_log = self._extract("log_betas", t, nd)
            frac = (var_values + 1) / 2
            model_log_var = frac * max_log + (1 - frac) * min_log
        else:
            key = ("posterior_log_var_clipped" if self.var_type == "fixed_small"
                   else "fixed_large_log_var")
            model_log_var = self._extract(key, t, nd).expand(x.shape)
        if self.mean_type == "xstart":
            pred_xstart = model_output
        else:
            pred_xstart = self._predict_xstart_from_eps(x, t, model_output)
        if C == 2:
            pred_xstart = _wrap_pm1(pred_xstart)
        mean = self.q_posterior_mean(pred_xstart, x, t)
        return {"mean": mean, "log_variance": model_log_var, "pred_xstart": pred_xstart}

    def _vb_terms(self, frozen_out, x_start, x_t, t, mask=None, mask_sum=None):
        """Variational bound term in bits: the KL to the posterior, or the
        decoder NLL at t = 0."""
        true_mean, _, true_log_var = self.q_posterior(x_start, x_t, t)
        out = self.p_mean_variance(frozen_out, x_t, t)
        kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
        kl = mean_flat(kl, mask, mask_sum) / math.log(2.0)
        nll = -discretized_gaussian_log_likelihood(
            x_start, means=out["mean"], log_scales=0.5 * out["log_variance"])
        nll = mean_flat(nll, mask, mask_sum) / math.log(2.0)
        return torch.where(t == 0, nll, kl)

    def training_losses(self, model_fn, x_start, t, noise, mask=None, self_cond=None,
                        sc_model_fn=None, mask_sum=None):
        """The MSE objective (+ the VB term with a learned variance). t: [B]
        respaced indices; noise: the q-sample noise; mask: [B, L,
        1]-broadcastable or None. With self_condition, `self_cond` is the
        step's coin (one for the whole batch): on True a first pass of
        `sc_model_fn` (default model_fn) with zeros as x_self_cond gives, as
        a constant, the pred_xstart the main pass is conditioned on; on
        False the main pass gets zeros. mask_sum: see mean_flat. Returns
        {'loss', 'mse'} (and 'vb' with a learned variance), each [B]."""
        if x_start.shape[-1] == 2:
            noise = _wrap_pm1(noise)
        x_t = self.q_sample(x_start, t, noise)
        if x_t.shape[-1] == 2:
            x_t = _wrap_pm1(x_t)
        t_base = self.map_t(t)
        if self.self_condition:
            if self_cond is None:
                raise ValueError("a self-conditioned process needs the step's coin (self_cond)")
            x_self_cond = torch.zeros_like(x_t)
            if self_cond:
                with torch.no_grad():
                    out0 = (sc_model_fn or model_fn)(x_t, t_base, x_self_cond=x_self_cond)
                    x_self_cond = self.p_mean_variance(out0, x_t, t)["pred_xstart"]
            model_output = model_fn(x_t, t_base, x_self_cond=x_self_cond)
        else:
            model_output = model_fn(x_t, t_base)
        terms = {}
        if self.var_type == "learned_range":
            mean_out, var_values = model_output.chunk(2, dim=-1)
            frozen = torch.cat([mean_out.detach(), var_values], dim=-1)
            terms["vb"] = self._vb_terms(frozen, x_start, x_t, t, mask, mask_sum)
            if self.loss_type == "rescaled_mse":
                terms["vb"] = terms["vb"] * (self.num_timesteps / 1000.0)
            model_output = mean_out
        target = noise if self.mean_type == "epsilon" else x_start
        diff = target - model_output
        if target.shape[-1] == 2:
            diff = _wrap_pm1(diff)
        terms["mse"] = mean_flat(diff ** 2, mask, mask_sum)
        terms["loss"] = terms["mse"] + terms.get("vb", 0.0)
        return terms

    def _t(self, x, t_idx):
        return torch.full((x.shape[0],), t_idx, dtype=torch.int64, device=x.device)

    def _model(self, model_fn, x, t, x_self_cond):
        if self.self_condition:
            return model_fn(x, self.map_t(t), x_self_cond=x_self_cond)
        return model_fn(x, self.map_t(t))

    def p_sample(self, model_fn, x, t_idx, z, x_self_cond=None):
        """One ancestral step x_t -> x_{t-1} with noise z (x_self_cond: the
        self-conditioning input, used with self_condition).
        Returns (sample, pred_xstart)."""
        t = self._t(x, t_idx)
        out = self.p_mean_variance(self._model(model_fn, x, t, x_self_cond), x, t)
        nonzero = float(t_idx != 0)
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * z
        if x.shape[-1] == 2:
            sample = _wrap_pm1(sample)
        return sample, out["pred_xstart"]

    def p_sample_loop(self, model_fn, shape, noise=None, noises=None,
                      generator=None, device="cuda", step_hook=None):
        """Ancestral sampling over every (respaced) step; `step_hook(i)`, if
        given, runs on the host before step i (i = 0 first). With
        self_condition each step's pred_xstart is the next step's
        x_self_cond, zeros at the first."""
        x = noise if noise is not None else torch.randn(
            shape, generator=generator, device=device)
        x_start = torch.zeros_like(x)
        for i in range(self.num_timesteps):
            if step_hook is not None:
                step_hook(i)
            z = noises[i] if noises is not None else torch.randn(
                x.shape, generator=generator, device=x.device)
            x, x_start = self.p_sample(model_fn, x, self.num_timesteps - 1 - i, z, x_start)
        return x

    # JAX's host loop over a jitted step is the same math as its scanned
    # loop; in eager torch both are this Python loop.
    p_sample_loop_host = p_sample_loop

    def ddim_sample(self, model_fn, x, t_idx, eta=0.0, z=None, x_self_cond=None):
        """One DDIM step x_t -> x_{t-1}; z is needed only when eta != 0.
        Returns (sample, pred_xstart)."""
        nd = x.dim()
        t = self._t(x, t_idx)
        out = self.p_mean_variance(self._model(model_fn, x, t, x_self_cond), x, t)
        pred_xstart = out["pred_xstart"]
        eps = self._predict_eps_from_xstart(x, t, pred_xstart)
        acp = self._extract("alphas_cumprod", t, nd)
        acp_prev = self._extract("alphas_cumprod_prev", t, nd)
        sigma = (eta * torch.sqrt((1.0 - acp_prev) / (1.0 - acp))
                 * torch.sqrt(1.0 - acp / acp_prev))
        mean = (torch.sqrt(acp_prev) * pred_xstart
                + torch.sqrt(torch.clamp(1.0 - acp_prev - sigma ** 2, min=0.0)) * eps)
        sample = mean if eta == 0.0 else mean + float(t_idx != 0) * sigma * z
        if x.shape[-1] == 2:
            sample = _wrap_pm1(sample)
        return sample, pred_xstart

    def ddim_sample_loop(self, model_fn, shape, noise=None, noises=None, eta=0.0,
                         generator=None, device="cuda", step_hook=None):
        """DDIM over every (respaced) step; at eta != 0 step i adds
        `noises[i]`, or a z drawn from `generator`. `step_hook` and
        self-conditioning as in `p_sample_loop`."""
        x = noise if noise is not None else torch.randn(
            shape, generator=generator, device=device)
        x_start = torch.zeros_like(x)
        for i in range(self.num_timesteps):
            if step_hook is not None:
                step_hook(i)
            z = None
            if eta != 0.0:
                z = noises[i] if noises is not None else torch.randn(
                    x.shape, generator=generator, device=x.device)
            x, x_start = self.ddim_sample(model_fn, x, self.num_timesteps - 1 - i, eta, z,
                                          x_start)
        return x


def _respaced_betas(acp, steps):
    """Betas of the process that keeps the base steps `steps` (ascending)
    of a schedule with cumulative alphas `acp`."""
    last, out = 1.0, []
    for i in steps:
        out.append(1.0 - acp[i] / last)
        last = acp[i]
    return np.array(out)


def diffusion_from_tmap(tmap, noise_schedule="linear", diffusion_steps=1000,
                        learn_sigma=True, predict_xstart=False, self_condition=False):
    """The respaced process of an explicit base-timestep list (a distilled
    student's grid, which no respacing string gives); fixed_small variance
    without learn_sigma, loss 'mse', as in the JAX package."""
    tmap = np.asarray(sorted(int(t) for t in tmap))
    acp = np.cumprod(1.0 - get_named_beta_schedule(noise_schedule, diffusion_steps))
    return GaussianDiffusion(
        betas=_respaced_betas(acp, tmap),
        mean_type="xstart" if predict_xstart else "epsilon",
        var_type="learned_range" if learn_sigma else "fixed_small",
        timestep_map=tmap, loss_type="mse", self_condition=self_condition)


def create_diffusion(timestep_respacing=None, noise_schedule="linear",
                     use_kl=False, rescale_learned_sigmas=False, sigma_small=False,
                     predict_xstart=False, learn_sigma=True, diffusion_steps=1000,
                     self_condition=False):
    """Respaced diffusion with the reference defaults (the trainer's
    process is create_diffusion(None): all 1000 steps, learned range)."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    use_steps = space_timesteps(diffusion_steps, timestep_respacing)
    tmap = sorted(use_steps)
    if use_kl:
        loss_type = "kl"
    elif rescale_learned_sigmas:
        loss_type = "rescaled_mse"
    else:
        loss_type = "mse"
    return GaussianDiffusion(
        betas=_respaced_betas(np.cumprod(1.0 - betas), tmap),
        mean_type="xstart" if predict_xstart else "epsilon",
        var_type=("learned_range" if learn_sigma
                  else ("fixed_small" if sigma_small else "fixed_large")),
        timestep_map=np.array(tmap), loss_type=loss_type, self_condition=self_condition,
    )
