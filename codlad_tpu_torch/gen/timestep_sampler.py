"""Diffusion timestep samplers.

Counterpart of `UniformSampler` in codlad_tpu/gen/timestep_sampler.py, with
an explicit generator (the loss-second-moment resampler is not ported).
"""

from __future__ import annotations

import torch


class UniformSampler:
    def __init__(self, num_timesteps):
        self.num_timesteps = num_timesteps

    def sample(self, batch, generator=None, device="cpu"):
        """(t int64 [batch] uniform in [0, num_timesteps), weights ones)."""
        t = torch.randint(0, self.num_timesteps, (batch,), generator=generator,
                          device=device)
        return t, torch.ones((batch,), device=device)
