"""Diffusion timestep samplers.

Counterpart of codlad_tpu/gen/timestep_sampler.py: `UniformSampler`, and
`LossSecondMomentResampler`, which samples t in proportion to
sqrt(E[loss^2]) from a host-side float64 history of per-timestep losses.
Both draw from an explicit generator.
"""

from __future__ import annotations

import numpy as np
import torch


class UniformSampler:
    def __init__(self, num_timesteps):
        self.num_timesteps = num_timesteps

    def sample(self, batch, generator=None, device="cpu"):
        """(t int64 [batch] uniform in [0, num_timesteps), weights ones)."""
        t = torch.randint(0, self.num_timesteps, (batch,), generator=generator,
                          device=device)
        return t, torch.ones((batch,), device=device)


class LossSecondMomentResampler:
    """Importance-sample t in proportion to sqrt(E[loss^2]) with uniform
    mixing; the weights 1 / (T p[t]) de-bias the objective. Uniform until
    every timestep holds `history_per_term` losses."""

    def __init__(self, num_timesteps, history_per_term=10, uniform_prob=0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._loss_history = np.zeros((num_timesteps, history_per_term), np.float64)
        self._loss_counts = np.zeros(num_timesteps, np.int64)

    def _warmed_up(self):
        return (self._loss_counts == self.history_per_term).all()

    def weights(self):
        if not self._warmed_up():
            return np.ones(self.num_timesteps, np.float64)
        w = np.sqrt((self._loss_history ** 2).mean(-1))
        w /= w.sum()
        w *= 1 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def _p(self, device):
        w = self.weights()
        return torch.as_tensor(w / w.sum(), dtype=torch.float32, device=device)

    def importance_weights(self, t):
        """The f32 weights 1 / (T p[t]) of timesteps t, with p in f32 as the
        JAX sampler computes them."""
        return 1.0 / (self.num_timesteps * self._p(t.device)[t])

    def sample(self, batch, generator=None, device="cpu"):
        """(t int64 [batch] drawn from `weights()`, their importance_weights)."""
        t = torch.multinomial(self._p(device), batch, replacement=True, generator=generator)
        return t, self.importance_weights(t)

    def update_with_losses(self, ts, losses):
        """ts, losses: host arrays [B] of the valid samples' timesteps and
        per-sample losses."""
        for t, loss in zip(np.asarray(ts), np.asarray(losses)):
            t = int(t)
            if self._loss_counts[t] == self.history_per_term:
                self._loss_history[t, :-1] = self._loss_history[t, 1:]
                self._loss_history[t, -1] = loss
            else:
                self._loss_history[t, self._loss_counts[t]] = loss
                self._loss_counts[t] += 1
