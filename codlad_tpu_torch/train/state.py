"""Train state: f32 master params, AdamW with clipping, an optional EMA and
the VQ state.

Counterpart of codlad_tpu/train/state.py and of the optimizers the JAX
trainers build: Stage 2 `optax.chain(optax.clip_by_global_norm(clip),
optax.adamw(schedule, weight_decay=0.0))` (cli/train_latent.py), Stage 1
`optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(lr))` at optax's
default weight decay 1e-4 (1e-3 with the exponential schedule), its
learning rate settable between steps as `inject_hyperparams` +
`set_learning_rate` make it (cli/train_vqvae.py). The update
is written out to optax's formulas, not taken from torch.optim, because the
two differ: torch's AdamW defaults to weight_decay 0.01, torch's
clip_grad_norm_ scales by max/(norm + 1e-6) where optax scales by max/norm
only when norm >= max, and optax evaluates the schedule at the count before
the update (with warmup, the first step has lr 0). The state is a dict of
named tensors and is updated in place, with multi-tensor (`_foreach`) ops:
one launch for each operation over all parameters, not one a parameter.
"""

from __future__ import annotations

import numpy as np
import torch


def warmup_linear_schedule(lr, warmup, schedule_steps=None, final_lr=None):
    """Linear warmup, then linear decay to final_lr at schedule_steps
    (f32 arithmetic, as the JAX schedule). Returns a function of the step,
    or the constant lr when warmup is 0."""
    if warmup == 0:
        return lambda step: np.float32(lr)
    f = np.float32

    def fn(step):
        step = f(step)
        if schedule_steps is None or final_lr is None:
            return f(lr) * np.minimum(step, f(warmup)) / f(warmup)
        final_ratio = f(final_lr / lr)
        warm = step / f(warmup)
        decay_ratio = (step - f(warmup)) / f(schedule_steps - warmup)
        decay = (f(1) - decay_ratio) + decay_ratio * final_ratio
        scale = warm if step < warmup else (decay if step < schedule_steps else final_ratio)
        return f(lr) * f(scale)

    return fn


def exp_decay_schedule(lr, total_steps=600000, final_div=5.0):
    """Stage-1 'scheduler_flag' LR: exponential decay to lr/5 over 600k
    steps, lr * exp(log(1/final_div) / total_steps * (step + 1)) in f32."""
    f = np.float32
    log_alpha = f(np.log(1.0 / final_div) / total_steps)

    def fn(step):
        return f(lr) * np.exp(log_alpha * (f(step) + f(1)), dtype=f)

    return fn


def global_norm(tree):
    """sqrt of the sum of squares of every leaf (f32)."""
    norms = torch._foreach_norm([g.to(torch.float32) for g in tree.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm, norm=None):
    """optax.clip_by_global_norm: g unchanged when norm < max_norm, else
    g / norm * max_norm. `norm` is the grads' global norm where the caller
    has it. The branch is taken on the device (g / 1 * 1 is g), so the host
    does not wait for the norm."""
    if norm is None:
        norm = global_norm(grads)
    under = norm < max_norm
    one = torch.ones_like(norm)
    clipped = torch._foreach_div(list(grads.values()), torch.where(under, one, norm))
    torch._foreach_mul_(clipped, torch.where(under, one, torch.full_like(norm, max_norm)))
    return dict(zip(grads, clipped))


def update_ema(ema_params, params, decay=0.9999):
    """ema <- ema * decay + p * (1 - decay), in place."""
    with torch.no_grad():
        ema = list(ema_params.values())
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul([params[k] for k in ema_params],
                                                    1 - decay))


B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, as the JAX trainer uses


class TrainState:
    """step, f32 `params`, optional `ema_params`, the AdamW `opt_state`
    ({count, mu, nu}; one count serves Adam's bias correction and the
    schedule, as optax's two counts are always equal here) and the VQ state
    (models/vq.VQState, or None). AdamW's decoupled weight decay follows
    optax: u = mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p, then
    p += -lr * u; the Stage-2 trainer runs it at 0, the Stage-1 trainer at
    optax's default 1e-4."""

    def __init__(self, params, lr_fn, grad_clip=None, weight_decay=0.0, ema=True,
                 vq_state=None):
        self.params = {k: v.detach().to(torch.float32).clone() for k, v in params.items()}
        self.ema_params = ({k: v.clone() for k, v in self.params.items()} if ema else None)
        self.opt_state = {"count": 0,
                          "mu": {k: torch.zeros_like(v) for k, v in self.params.items()},
                          "nu": {k: torch.zeros_like(v) for k, v in self.params.items()}}
        self.step = 0
        self.lr_fn = lr_fn
        self.learning_rate = None   # set by set_learning_rate
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.vq_state = vq_state

    def set_learning_rate(self, lr):
        """A constant learning rate from now on (the plateau schedule's drops)."""
        self.learning_rate = float(lr)
        self.lr_fn = lambda step: np.float32(lr)

    def apply_gradients(self, grads, norm=None):
        """One optimizer step: clip (by `norm`, the grads' global norm, where
        the caller has it), Adam moments with bias correction, decoupled
        weight decay, -lr(count) scaling, params += update."""
        if self.grad_clip is not None:
            grads = clip_by_global_norm(grads, self.grad_clip, norm)
        st = self.opt_state
        count = st["count"] + 1
        f32 = torch.float32
        # bias corrections 1 - b^count and the step size in f32, as optax
        bc1 = float(1 - torch.tensor(B1, dtype=f32) ** count)
        bc2 = float(1 - torch.tensor(B2, dtype=f32) ** count)
        lr = float(np.float32(self.lr_fn(st["count"])))
        keys = list(self.params)
        ps = [self.params[k] for k in keys]
        gs = [grads[k].to(f32) for k in keys]
        mus = [st["mu"][k] for k in keys]
        nus = [st["nu"][k] for k in keys]
        with torch.no_grad():
            torch._foreach_mul_(mus, B1)               # mu = (1-b1) g + b1 mu
            torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - B1))
            sq = torch._foreach_mul(gs, gs)            # nu = (1-b2) g^2 + b2 nu
            torch._foreach_mul_(sq, 1 - B2)
            torch._foreach_mul_(nus, B2)
            torch._foreach_add_(nus, sq)
            den = torch._foreach_div(nus, bc2)         # u = mu_hat / (sqrt(nu_hat) + eps)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            u = torch._foreach_div(mus, bc1)
            torch._foreach_div_(u, den)
            if self.weight_decay:                      # + wd * p
                torch._foreach_add_(u, torch._foreach_mul(ps, self.weight_decay))
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(ps, u)
        st["count"] = count
        self.step += 1

    def update_ema(self, decay):
        update_ema(self.ema_params, self.params, decay)

    def state_dict(self):
        return {"step": self.step, "params": self.params, "ema_params": self.ema_params,
                "opt_state": self.opt_state, "learning_rate": self.learning_rate,
                "vq_state": None if self.vq_state is None else self.vq_state.tensors()}

    def load_state_dict(self, sd):
        """Copy a saved state into this one's tensors (on their device)."""
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(sd["params"][k])
            if self.ema_params is not None:
                for k, v in self.ema_params.items():
                    v.copy_(sd["ema_params"][k])
            self.step = int(sd["step"])
            self.opt_state["count"] = int(sd["opt_state"]["count"])
            for m in ("mu", "nu"):
                for k, v in self.opt_state[m].items():
                    v.copy_(sd["opt_state"][m][k])
            if self.vq_state is not None:
                for k, v in self.vq_state.tensors().items():
                    v.copy_(sd["vq_state"][k])
        if sd.get("learning_rate") is not None:
            self.set_learning_rate(sd["learning_rate"])
