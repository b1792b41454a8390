"""Progressive distillation of the DDIM sampler (Salimans & Ho, ICLR 2022).

Counterpart of codlad_tpu/gen/distill.py: a student whose sampling grid is
every second teacher step learns to make in ONE deterministic DDIM step the
two teacher steps it spans; then the student is the next round's teacher,
100 -> 50 -> 25 -> 13 -> ... steps.

`halve(teacher)` keeps the teacher's alpha-bar at its even respaced indices,
so `student.q_sample(x, i)` equals `teacher.q_sample(x, 2i)` and one student
step i -> i-1 spans teacher steps 2i -> 2i-1 -> 2i-2 (the last step, 0 ->
clean, is shared; an odd teacher length works too).

The functions take `model_fn(x, t_base) -> output` callables, as
GaussianDiffusion.training_losses does. Randomness is injected: the
student indices `i_s` [B] and the q-sample `noise` are arguments (the
trainer draws them, train/steps.py `make_distill_step`).
"""

from __future__ import annotations

import numpy as np
import torch

from codlad_tpu_torch.gen.diffusion import GaussianDiffusion, _wrap_pm1, mean_flat


def halve(teacher: GaussianDiffusion) -> GaussianDiffusion:
    """The student process with every second respaced step of `teacher`:
    its alpha-bar grid is the teacher's at even indices (student index i ==
    teacher index 2i); everything else is the teacher's."""
    acp = np.cumprod(1.0 - np.asarray(teacher.betas, np.float64))
    keep = np.arange(0, len(acp), 2)
    last, betas = 1.0, []
    for a in acp[keep]:
        betas.append(1.0 - a / last)
        last = a
    tmap = (teacher.timestep_map.numpy()[keep] if teacher.timestep_map is not None
            else keep)
    return GaussianDiffusion(np.asarray(betas), mean_type=teacher.mean_type,
                             var_type=teacher.var_type, timestep_map=np.asarray(tmap),
                             loss_type=teacher.loss_type,
                             self_condition=teacher.self_condition)


def ddim_mean(d: GaussianDiffusion, x, t, pred_xstart):
    """The deterministic (eta = 0) DDIM map x_t -> x_{t-1} given the model's
    pred_xstart, at per-sample respaced indices t [B]. At t == 0 it returns
    pred_xstart (alpha_bar_prev == 1)."""
    nd = x.dim()
    eps = d._predict_eps_from_xstart(x, t, pred_xstart)
    acp_prev = d._extract("alphas_cumprod_prev", t, nd)
    out = torch.sqrt(acp_prev) * pred_xstart + torch.sqrt(1.0 - acp_prev) * eps
    return _wrap_pm1(out) if x.shape[-1] == 2 else out


@torch.no_grad()
def two_step_target(teacher: GaussianDiffusion, model_fn, x_t, i_s):
    """The result of TWO deterministic teacher DDIM steps from x_t at
    teacher index 2 * i_s (one step where that index is 0). The teacher is
    frozen: no gradient."""
    t1 = 2 * i_s
    x0_1 = teacher.p_mean_variance(model_fn(x_t, teacher.map_t(t1)), x_t, t1)["pred_xstart"]
    x_mid = ddim_mean(teacher, x_t, t1, x0_1)
    t2 = torch.clamp(t1 - 1, min=0)
    x0_2 = teacher.p_mean_variance(model_fn(x_mid, teacher.map_t(t2)), x_mid,
                                   t2)["pred_xstart"]
    x_low = ddim_mean(teacher, x_mid, t2, x0_2)
    first = (t1 > 0).reshape((-1,) + (1,) * (x_t.dim() - 1))
    return torch.where(first, x_low, x_mid)


def distill_targets(teacher: GaussianDiffusion, student: GaussianDiffusion, model_fn,
                    x_start, i_s, noise):
    """(x_t, x_tilde, snr_weight) of one distillation batch. x_tilde is the
    x-prediction that makes ONE student DDIM step from x_t land on the
    two-teacher-step point (Salimans & Ho eq. 8; at i_s == 0 it is that
    point), snr_weight the truncated SNR max(a_t / (1 - a_t), 1)."""
    nd = x_start.dim()
    x_t = student.q_sample(x_start, i_s, noise)
    if x_t.shape[-1] == 2:
        x_t = _wrap_pm1(x_t)
    x_target = two_step_target(teacher, model_fn, x_t, i_s)
    a_t = student._extract("alphas_cumprod", i_s, nd)
    a_prev = student._extract("alphas_cumprod_prev", i_s, nd)
    c1 = torch.sqrt((1.0 - a_prev) / (1.0 - a_t))
    denom = torch.sqrt(a_prev) - c1 * torch.sqrt(a_t)
    x_tilde = (x_target - c1 * x_t) / denom
    snr_w = torch.clamp(a_t / (1.0 - a_t), min=1.0)
    return x_t, x_tilde.detach(), snr_w


def distill_loss_terms(teacher: GaussianDiffusion, student: GaussianDiffusion, teacher_fn,
                       student_fn, x_start, i_s, noise, mask=None):
    """Per-sample distillation losses {'loss' [B], 'mse' [B]}, as
    training_losses returns them: the squared x-space error of the student's
    pred_xstart against x_tilde, masked-mean over residues, `loss` weighted
    by the truncated SNR. Both models are read through p_mean_variance, so
    epsilon- and x-predicting teachers distill alike."""
    if x_start.shape[-1] == 2:
        noise = _wrap_pm1(noise)
    x_t, x_tilde, snr_w = distill_targets(teacher, student, teacher_fn, x_start, i_s, noise)
    x_hat = student.p_mean_variance(student_fn(x_t, student.map_t(i_s)), x_t,
                                    i_s)["pred_xstart"]
    diff = x_tilde - x_hat
    if diff.shape[-1] == 2:
        diff = _wrap_pm1(diff)
    return {"loss": mean_flat(snr_w * diff ** 2, mask), "mse": mean_flat(diff ** 2, mask)}
