"""Minibatch optimal-transport couplings for OT and SB flow matching.

Counterpart of codlad_tpu/gen/ot.py (reference:
diffusion_and_flow/optimal_transport.py:11-263 `OTPlanSampler`):

* the squared-distance cost |a|^2 - 2ab + |b|^2 in f32 over the samples
  flattened to [B, L * C], padded tokens included (the JAX formula, so that
  near-ties resolve as they do there);
* `sinkhorn_plan`, `unbalanced_plan` and `partial_plan`: the log-domain
  iterations on the device;
* `exact_assignment`: the exact plan of uniform equal-size marginals, an
  assignment problem, solved on the host in float64 by the port's native LAP
  (codlad_tpu_torch/native.py; scipy where the library is missing). Its host
  time (the copy to the host included) is added to `LAP_STATS`.

`sample_plan` re-pairs (x0, x1) by any of the four methods. The draws of
the sampling methods come from `generator`, or are passed in as `pick`
(sinkhorn: a column a row [B]; unbalanced / partial: a flat pair index a
row [B] into the plan), so that tests can replay JAX's.
"""

from __future__ import annotations

import math
import time

import torch

from codlad_tpu_torch import native

LAP_STATS = {"calls": 0, "ms": 0.0}


def reset_lap_stats():
    LAP_STATS.update(calls=0, ms=0.0)


def _pairwise_sq_dists(x0, x1):
    a = x0.reshape(x0.shape[0], -1)
    b = x1.reshape(x1.shape[0], -1)
    return (a ** 2).sum(1)[:, None] - 2 * a @ b.T + (b ** 2).sum(1)[None, :]


def _log_uniform(n, like):
    return torch.full((n,), -math.log(n), dtype=like.dtype, device=like.device)


def sinkhorn_plan(cost, reg=0.05, n_iters=100):
    """Log-domain Sinkhorn with uniform marginals -> the plan [B, B]."""
    B = cost.shape[0]
    log_mu = _log_uniform(B, cost)
    f = torch.zeros_like(log_mu)
    g = torch.zeros_like(log_mu)
    for _ in range(n_iters):
        f = -reg * torch.logsumexp((-cost + g[None, :]) / reg, dim=1) + reg * log_mu
        g = -reg * torch.logsumexp((-cost + f[:, None]) / reg, dim=0) + reg * log_mu
    return torch.exp((-cost + f[:, None] + g[None, :]) / reg)


def unbalanced_plan(cost, reg=0.05, reg_m=1.0, n_iters=200):
    """Unbalanced entropic OT (Sinkhorn-Knopp with KL-relaxed marginals,
    each scaling damped by reg_m / (reg_m + reg); reference method
    'unbalanced')."""
    B0, B1 = cost.shape
    log_a, log_b = _log_uniform(B0, cost), _log_uniform(B1, cost)
    fi = reg_m / (reg_m + reg)
    mk = -cost / reg
    log_u, log_v = torch.zeros_like(log_a), torch.zeros_like(log_b)
    for _ in range(n_iters):
        log_u = fi * (log_a - torch.logsumexp(mk + log_v[None, :], dim=1))
        log_v = fi * (log_b - torch.logsumexp(mk + log_u[:, None], dim=0))
    return torch.exp(log_u[:, None] + mk + log_v[None, :])


def partial_plan(cost, reg=0.05, m=None, n_iters=200):
    """Entropic partial OT (reference method 'partial'): transport mass m
    (default 1) under {P 1 <= a}, {P^T 1 <= b}, {sum P = m} by cyclic
    projections in the log domain."""
    B0, B1 = cost.shape
    log_a, log_b = _log_uniform(B0, cost), _log_uniform(B1, cost)
    log_m = math.log(1.0 if m is None else m)
    lk = -cost / reg
    lk = lk + (log_m - torch.logsumexp(lk.reshape(-1), dim=0))
    for _ in range(n_iters):
        lk = lk + torch.clamp(log_a - torch.logsumexp(lk, dim=1), max=0.0)[:, None]
        lk = lk + torch.clamp(log_b - torch.logsumexp(lk, dim=0), max=0.0)[None, :]
        lk = lk + (log_m - torch.logsumexp(lk.reshape(-1), dim=0))
    return torch.exp(lk)


def exact_assignment(cost):
    """The exact OT assignment (uniform, equal-size marginals): col [B]
    int64 on cost's device, from the host LAP in float64."""
    t0 = time.perf_counter()
    col = native.lap_solve(cost.detach().to("cpu", torch.float64).numpy())
    out = torch.as_tensor(col, dtype=torch.int64).to(cost.device)
    LAP_STATS["calls"] += 1
    LAP_STATS["ms"] += (time.perf_counter() - t0) * 1e3
    return out


def plan_of(cost, method, reg=0.05, reg_m=1.0, partial_mass=None):
    """The entropic plan of a sampling method."""
    if method == "sinkhorn":
        return sinkhorn_plan(cost, reg=reg)
    if method == "unbalanced":
        return unbalanced_plan(cost, reg=reg, reg_m=reg_m)
    if method == "partial":
        return partial_plan(cost, reg=reg, m=partial_mass)
    raise ValueError(method)


def sample_plan(x0, x1, method="exact", reg=0.05, reg_m=1.0, partial_mass=None,
                generator=None, pick=None):
    """Re-pair (x0, x1) by the minibatch OT plan (every reference
    OTPlanSampler method). exact: x1 permuted by the assignment. sinkhorn:
    for each row i a column j ~ plan[i, :]. unbalanced / partial: B pairs
    (i, j) drawn jointly from the flattened plan (rows of x0 may repeat or
    drop). The draws come from `generator` unless `pick` holds them."""
    cost = _pairwise_sq_dists(x0, x1)
    if method == "exact":
        return x0, x1[exact_assignment(cost)]
    plan = plan_of(cost, method, reg, reg_m, partial_mass)
    probs = torch.clamp(plan, min=1e-30)
    if method == "sinkhorn":
        if pick is None:
            pick = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return x0, x1[pick]
    B1 = cost.shape[1]
    if pick is None:
        pick = torch.multinomial(probs.reshape(-1), x0.shape[0], replacement=True,
                                 generator=generator)
    return x0[pick // B1], x1[pick % B1]


def wasserstein(x0, x1, reg=0.05, method="exact"):
    """Minibatch 2-Wasserstein distance (a diagnostic; reference
    optimal_transport.py:214-263)."""
    cost = _pairwise_sq_dists(x0, x1)
    if method == "exact":
        col = exact_assignment(cost)
        total = cost.gather(1, col[:, None]).mean()
    else:
        total = (sinkhorn_plan(cost, reg=reg) * cost).sum()
    return torch.sqrt(total)
