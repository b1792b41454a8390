"""ODE integrators for flow sampling.

Counterpart of codlad_tpu/gen/solvers.py (reference: torchdiffeq's `odeint`
in test.py:214-250 `run_sampling`): fixed-step euler, midpoint and rk4, and
an adaptive Dormand-Prince 5(4) with a step budget of 4 x steps, each
returning (x1, nfe).

The arithmetic is the JAX package's f32: the state, the times t0 + i dt (i
and dt in f32, as JAX's weak typing makes them), the stages' coefficients
and dopri5's step sizes. dopri5 decides accept or reject on the host, one
read of the error ratio an attempt (JAX decides inside a while_loop on the
device): the same sequence of attempts, each costing 7 evaluations (no
FSAL), the error norm a mean over the whole state, padded tokens included.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32

# Dormand-Prince 5(4) Butcher tableau
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
NFE_PER_STEP = {"euler": 1, "midpoint": 2, "rk4": 4}


def _f32(v, dev):
    return torch.tensor(v, dtype=F32, device=dev)


def odeint(f, x0, t0=0.0, t1=1.0, steps=100, method="euler", rtol=1e-5, atol=1e-5,
           stats=None, step_hook=None):
    """Integrate dx/dt = f(t, x) from t0 to t1 -> (x1, nfe). f(t, x) takes t
    as a 0-d f32 tensor on x's device. Fixed-step methods take `steps`
    intervals; rtol/atol apply to dopri5 only. `stats` (a dict), when given,
    receives dopri5's accepted and rejected attempts, host reads, each
    attempt's start time (`times`: a time repeats after a rejection) and the
    time reached (`t`: below t1 when the budget ran out, as in JAX);
    `step_hook(i)` runs on the host before step (or attempt) i."""
    if method == "dopri5":
        return _dopri5(f, x0, t0, t1, rtol=rtol, atol=atol, max_steps=steps * 4, stats=stats,
                       step_hook=step_hook)
    if method not in NFE_PER_STEP:
        raise ValueError(method)
    dev = x0.device
    dt = _f32((t1 - t0) / steps, dev)
    half, sixth = _f32((t1 - t0) / steps / 2, dev), _f32((t1 - t0) / steps / 6, dev)
    ts = _f32(t0, dev) + torch.arange(steps, dtype=F32, device=dev) * dt
    x = x0
    for i in range(steps):
        if step_hook is not None:
            step_hook(i)
        t = ts[i]
        if method == "euler":
            x = x + dt * f(t, x)
        elif method == "midpoint":
            k1 = f(t, x)
            x = x + dt * f(t + half, x + half * k1)
        else:
            k1 = f(t, x)
            k2 = f(t + half, x + half * k1)
            k3 = f(t + half, x + half * k2)
            k4 = f(t + dt, x + dt * k3)
            x = x + sixth * (k1 + 2 * k2 + 2 * k3 + k4)
    return x, steps * NFE_PER_STEP[method]


def _dopri5(f, x0, t0, t1, rtol=1e-5, atol=1e-5, max_steps=400, stats=None, step_hook=None):
    """Adaptive Dormand-Prince within max_steps attempts -> (x1, nfe). The
    step size and time live on the host in float32; the error ratio of each
    attempt is read from the device."""
    dev = x0.device
    c = [_f32(v, dev) for v in _DP_C]
    b5, b4 = _f32(_DP_B5, dev), _f32(_DP_B4, dev)
    a = [[np.float32(v) for v in row] for row in _DP_A]
    t1_32 = np.float32(t1)
    t, dt = np.float32(t0), np.float32((t1 - t0) / 50.0)
    x, nfe, i, accepted, syncs, times = x0, 0, 0, 0, 0, []
    while t < t1_32 and i < max_steps:
        times.append(float(t))
        if step_hook is not None:
            step_hook(i)
        dt = min(dt, np.float32(t1_32 - t))
        t_dev, dt_dev = _f32(t, dev), _f32(dt, dev)
        ks = []
        for s in range(7):
            xi = x
            for j, aj in enumerate(a[s]):
                xi = xi + _f32(dt * aj, dev) * ks[j]
            ks.append(f(t_dev + c[s] * dt_dev, xi))
        k = torch.stack(ks)
        x5 = x + dt_dev * torch.tensordot(b5, k, dims=1)
        err = x5 - (x + dt_dev * torch.tensordot(b4, k, dims=1))
        tol = atol + rtol * torch.maximum(x.abs(), x5.abs())
        ratio = np.float32(torch.sqrt(torch.mean((err / tol) ** 2)).item())
        syncs += 1
        if ratio <= 1.0:
            t, x = np.float32(t + dt), x5
            accepted += 1
        with np.errstate(divide="ignore"):     # ratio 0: the largest step, as in JAX
            factor = np.clip(np.float32(0.9) * ratio ** np.float32(-0.2), np.float32(0.2),
                             np.float32(5.0))
        dt = np.float32(dt * factor)
        nfe += 7
        i += 1
    if stats is not None:
        stats.update(accepted=accepted, rejected=i - accepted, host_syncs=syncs, nfe=nfe,
                     times=times, t=float(t))
    return x, nfe
