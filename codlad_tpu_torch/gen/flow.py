"""Conditional flow matching: the five matchers of codlad_tpu/gen/flow.py.

(Reference: diffusion_and_flow/flow.py.) I-CFM, exact-OT CFM, Lipman's
target CFM, Schrödinger-bridge CFM (with its score weighting lambda) and
the variance-preserving trigonometric interpolant, as frozen dataclasses
whose methods take torch tensors. t is drawn as sigmoid(N(0, 1)), the
reference's quirk (flow.py:187-190), kept by the JAX package too.

Randomness: the OT matchers first re-pair (x0, x1) by their plan
(gen/ot.py `sample_plan`), then t and eps are drawn, all from one
`generator` in that order. Each draw can be passed in instead (`t`, `eps`,
`pick`), which is how the tests replay JAX's key-split chain (k_plan, then
the matcher's k_t and k_eps).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from codlad_tpu_torch.gen import ot as ot_mod


def pad_t_like_x(t, x):
    return t.reshape((-1,) + (1,) * (x.dim() - 1))


def sample_t_sigmoid(generator, batch, device=None):
    """t = sigmoid(N(0, 1)) [batch]: the reference's non-uniform time density."""
    return torch.sigmoid(torch.randn((batch,), generator=generator, device=device))


@dataclasses.dataclass(frozen=True)
class ConditionalFlowMatcher:
    """I-CFM: x_t ~ N(t x1 + (1 - t) x0, sigma), u = x1 - x0."""

    sigma: float = 0.0

    def compute_mu_t(self, x0, x1, t):
        t = pad_t_like_x(t, x0)
        return t * x1 + (1 - t) * x0

    def compute_sigma_t(self, t):
        return torch.full_like(t, self.sigma)

    def compute_conditional_flow(self, x0, x1, t, xt):
        return x1 - x0

    def compute_lambda(self, t):
        return 2 * self.compute_sigma_t(t) / (self.sigma ** 2 + 1e-8)

    def couple(self, x0, x1, generator=None, pick=None):
        """The coupling of (x0, x1) before the path is sampled: independent
        here; the OT matchers re-pair by their plan."""
        return x0, x1

    def sample_location_and_conditional_flow(self, x0, x1, t=None, eps=None,
                                             generator=None, pick=None,
                                             return_noise=False):
        """(t, x_t, u_t[, eps]) for a batch of (x0, x1): the coupling's draw,
        then t [B] and eps like x0, each from `generator` unless given."""
        x0, x1 = self.couple(x0, x1, generator, pick)
        if t is None:
            t = sample_t_sigmoid(generator, x0.shape[0], x0.device)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, device=x0.device)
        mu_t = self.compute_mu_t(x0, x1, t)
        xt = mu_t + pad_t_like_x(self.compute_sigma_t(t), x0) * eps
        ut = self.compute_conditional_flow(x0, x1, t, xt)
        return (t, xt, ut, eps) if return_noise else (t, xt, ut)


@dataclasses.dataclass(frozen=True)
class ExactOptimalTransportConditionalFlowMatcher(ConditionalFlowMatcher):
    """OT-CFM: the minibatch exact-OT coupling of (x0, x1), then I-CFM."""

    ot_method: str = "exact"

    def couple(self, x0, x1, generator=None, pick=None):
        return ot_mod.sample_plan(x0, x1, method=self.ot_method, generator=generator, pick=pick)


@dataclasses.dataclass(frozen=True)
class TargetConditionalFlowMatcher(ConditionalFlowMatcher):
    """Lipman's target OT path: mu = t x1, sigma = 1 - (1 - sigma) t."""

    def compute_mu_t(self, x0, x1, t):
        return pad_t_like_x(t, x1) * x1

    def compute_sigma_t(self, t):
        return 1 - (1 - self.sigma) * t

    def compute_conditional_flow(self, x0, x1, t, xt):
        t = pad_t_like_x(t, x1)
        return (x1 - (1 - self.sigma) * xt) / (1 - (1 - self.sigma) * t)


@dataclasses.dataclass(frozen=True)
class SchrodingerBridgeConditionalFlowMatcher(ConditionalFlowMatcher):
    """SB-CFM: the Brownian-bridge sigma sqrt(t (1 - t)) with the OT coupling
    at reg 2 sigma^2 (the exact method ignores it)."""

    sigma: float = 1.0
    ot_method: str = "exact"

    def compute_sigma_t(self, t):
        return self.sigma * torch.sqrt(t * (1 - t))

    def compute_conditional_flow(self, x0, x1, t, xt):
        t = pad_t_like_x(t, x0)
        mu_t = t * x1 + (1 - t) * x0
        ratio = (1 - 2 * t) / (2 * t * (1 - t) + 1e-8)
        return ratio * (xt - mu_t) + x1 - x0

    def couple(self, x0, x1, generator=None, pick=None):
        return ot_mod.sample_plan(x0, x1, method=self.ot_method, reg=2 * self.sigma ** 2,
                                  generator=generator, pick=pick)


@dataclasses.dataclass(frozen=True)
class VariancePreservingConditionalFlowMatcher(ConditionalFlowMatcher):
    """Albergo's trigonometric interpolant."""

    def compute_mu_t(self, x0, x1, t):
        t = pad_t_like_x(t, x0)
        return torch.cos(math.pi / 2 * t) * x0 + torch.sin(math.pi / 2 * t) * x1

    def compute_conditional_flow(self, x0, x1, t, xt):
        t = pad_t_like_x(t, x0)
        return math.pi / 2 * (torch.cos(math.pi / 2 * t) * x1 - torch.sin(math.pi / 2 * t) * x0)


FLOW_MATCHERS = {
    "icfm": ConditionalFlowMatcher,
    "otcfm": ExactOptimalTransportConditionalFlowMatcher,
    "fm": TargetConditionalFlowMatcher,
    "sbcfm": SchrodingerBridgeConditionalFlowMatcher,
    "vpfm": VariancePreservingConditionalFlowMatcher,
}
