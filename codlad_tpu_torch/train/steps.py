"""Train and eval steps: Stage 2 (diffusion) and Stage 1 (the VAE modes, GenZProt).

Counterparts of `make_latent_step` (process_kind "diffusion", with
self-conditioning, classifier-free-guidance class dropout, importance
weights for t and the per-sample aux the trainer's validation and
loss-second-moment sampler read; the flow matchers of gen/flow.py, sbcfm's
velocity-and-score loss and the `backbone` regression; data and sequence
parallelism over a train/mesh.Mesh), `make_distill_step` (progressive
distillation), `make_vqvae_step` (every mode and quantizer) and
`make_genzprot_step` in codlad_tpu/train/steps.py, the last two also
data-parallel. With
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
can be passed in instead. Under a mesh each rank takes its block of the
global batch's draws, and its dropout seed is (seed, row0), the masks of
its global rows (`_Layout`).

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
from codlad_tpu_torch.train.mesh import data_size, data_sum, summing_over
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


def _grads(loss, params):
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), gs)}


def masked_l2(pred, target, mask, count=None):
    """The reference's 'l2' loss: the mean squared error over the unmasked
    tokens' channels (train_module.py:27-56). `count`, if given, is the
    divisor (the global batch's, where pred holds a rank's part of it)."""
    m = torch.broadcast_to(mask[..., None], pred.shape).to(pred.dtype)
    return ((pred - target) ** 2 * m).sum() / torch.clamp(
        m.sum() if count is None else count, min=1.0)


FLOW_KINDS = ("fm", "icfm", "vpfm", "otcfm", "sbcfm")

_SEQ_SITE = 0x5E90


class _Layout:
    """Where one rank's block [B, L] sits in the global batch of a mesh
    (train/mesh.Mesh; None: one rank): rows row0 .. row0 + B of Bg, residues
    l0 .. l0 + L of Lg. `draw` slices a global draw to the block; `seed`
    gives the dropout seed of the block's rows."""

    def __init__(self, mesh, x1):
        B, L = x1.shape[:2]
        self.mesh = mesh
        self.seq = None if mesh is None else mesh.seq_ctx()
        d, dr = (1, 0) if mesh is None else (mesh.data, mesh.data_rank)
        s, sr = (1, 0) if self.seq is None else (mesh.seq, mesh.seq_rank)
        self.row0, self.Bg, self.l0, self.Lg = dr * B, d * B, sr * L, s * L
        self.rows = slice(self.row0, self.row0 + B)
        self.cols = slice(self.l0, self.l0 + L)

    def draw(self, v, seq_dim=True):
        return v[self.rows, self.cols] if seq_dim else v[self.rows]

    def seed(self, seed):
        if self.mesh is None or self.mesh.world == 1:
            return seed
        if self.seq is not None and self.mesh.seq > 1:
            seed = pass_seed(seed, _SEQ_SITE + self.mesh.seq_rank)
        return (seed, self.row0)

    def world_sum(self, x):
        return x if self.mesh is None else self.mesh.world_sum(x)

    def data_sum(self, x):
        return x if self.mesh is None else self.mesh.data_sum(x)

    def seq_sum(self, x):
        return x if self.seq is None else self.mesh.seq_sum(x)

    def gather(self, x):
        """The global [Bg, Lg, ...] tensor of each rank's block, no gradient."""
        if self.mesh is None:
            return x
        if self.seq is not None:
            from codlad_tpu_torch.parallel.sequence import seq_all_gather
            x = seq_all_gather(x.detach(), self.seq)
        return self.mesh.data_gather(x)

    def valid(self, mask):
        """Per-sample validity [B] (any unmasked residue, over every seq rank)
        and the global count of valid samples (at least 1)."""
        valid = (mask.reshape(mask.shape[0], -1) != 0).any(dim=1).to(torch.float32)
        if self.seq is not None:
            valid = self.mesh.seq_max(valid)
        return valid, torch.clamp(self.data_sum(valid.sum()), min=1.0)


def _cast_params(params, dtype):
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in params.items()}


def make_latent_step(model, process, *, process_kind="diffusion", ema_decay=0.9999,
                     dropout=True, compute_dtype=None, class_dropout_prob=0.0, mesh=None):
    """(train_step, eval_step) for the denoiser `model` (an MPNNDenoiser)
    and `process`: the GaussianDiffusion of process_kind "diffusion", a flow
    matcher (gen/flow.py) of a flow kind, or None for "backbone" (x1
    regressed from noise at t = 1). class_dropout_prob > 0 replaces a
    training sample's sequence by the null token (vocab - 1) with that
    probability, in every pass.

    mesh (train/mesh.Mesh): data and / or sequence parallelism. Each rank
    passes its block of the global batch (its rows; under seq sharding its
    residues of them, the network then in its seq mode). Every draw is the
    global batch's, sliced to the block (t, the noise, the class-dropout
    vector, a flow's matcher run on the gathered global x1), the dropout
    masks are those of the block's global rows (kernels/mpnn_kernels.
    site_seeds' row0; the seq ranks of a row fold their index into the
    seed, drawing masks of their own, as JAX folds in its mesh axes), the
    losses divide by global counts, and the gradients are summed over every
    rank: a step of a mesh is the step of one rank on the global batch
    (without seq sharding also at dropout > 0). The metrics are the global
    batch's; diffusion's t, loss_per_sample and valid_mask cover its rows."""
    if process_kind not in ("diffusion", "backbone") + FLOW_KINDS:
        raise ValueError(f"unknown process_kind {process_kind!r}")
    sampler = UniformSampler(process.num_timesteps) if process_kind == "diffusion" else None
    null_id = model.vocab - 1

    def model_apply(params, x, t, seed, extras, lay, x_self_cond=None, train=True,
                    drop=None):
        use_dropout = dropout and train
        res_type, cg = extras["res_type"], extras["cg_xyz"]
        if class_dropout_prob > 0 and train:
            if drop is None:
                drop = lay.draw(class_drop_draw(seed, lay.Bg, class_dropout_prob, x.device),
                                seq_dim=False)
            res_type = apply_class_dropout(res_type, drop, null_id)
        if compute_dtype is not None:
            params = _cast_params(params, compute_dtype)
            x, cg = x.to(compute_dtype), cg.to(compute_dtype)
            if x_self_cond is not None:
                x_self_cond = x_self_cond.to(compute_dtype)
        out = functional_call(model, params, (x, t, res_type, cg, extras["mask"]),
                              {"deterministic": not use_dropout,
                               "dropout_seed": lay.seed(seed), "x_self_cond": x_self_cond,
                               "seq": lay.seq})
        return out.to(torch.float32)

    def flow_loss_fn(params, x1, extras, seed, train, draws, class_drop, lay):
        # masked-token means (masked_l2) over the global batch's tokens:
        # padded samples add nothing to either side, and `weight`, the token
        # count, weighs validation batches. The matcher runs on the gathered
        # global x1 (an OT coupling pairs the global batch, as in JAX).
        draws = draws or {}
        mask = extras["mask"]
        maskf = mask.to(torch.float32)
        token_w = lay.world_sum(maskf.sum())
        count = token_w * x1.shape[-1]
        x1g = lay.gather(x1)
        gen = torch.Generator(device=x1.device).manual_seed(int(seed))
        x0 = draws.get("x0")
        if x0 is None:
            x0 = torch.randn(x1g.shape, generator=gen, device=x1.device)
        drop = class_drop[0] if isinstance(class_drop, (tuple, list)) else class_drop
        apply = lambda x, t: model_apply(params, x, t, seed, extras, lay, train=train,
                                         drop=drop)
        if process_kind == "backbone":
            vt = apply(lay.draw(x0), torch.ones((x1.shape[0],), dtype=x1.dtype,
                                                device=x1.device))
            return masked_l2(vt, x1, mask, count), {"weight": token_w}
        t, xt, ut, eps = process.sample_location_and_conditional_flow(
            x0, x1g, t=draws.get("t"), eps=draws.get("eps"), generator=gen,
            pick=draws.get("pick"), return_noise=True)
        t, xt, ut, eps = lay.draw(t, seq_dim=False), lay.draw(xt), lay.draw(ut), lay.draw(eps)
        out = apply(xt, t)
        if process_kind != "sbcfm":
            return masked_l2(out, ut, mask, count), {"weight": token_w}
        # sbcfm: a denoiser of 2C channels, velocity then score
        vt, st = out.chunk(2, dim=-1)
        sq = (process.compute_lambda(t)[:, None, None] * st + eps) ** 2
        score = sq.sum() / (lay.Bg * lay.Lg * sq.shape[-1])
        return (masked_l2(vt, ut, mask, count) + score,
                {"score": lay.world_sum(score.detach()), "weight": token_w})

    def loss_fn(params, x1, extras, seed, train=True, t=None, noise=None, t_weights=None,
                self_cond=None, class_drop=None, draws=None):
        lay = _Layout(mesh, x1)
        if process_kind != "diffusion":
            return flow_loss_fn(params, x1, extras, seed, train, draws, class_drop, lay)
        mask = extras["mask"]
        B, dev = x1.shape[0], x1.device
        maskf = mask.to(torch.float32)
        # batch-padding rows carry all-zero masks: normalise by the valid count
        valid, n_valid = lay.valid(mask)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        if t is None:
            t = lay.draw(sampler.sample(lay.Bg, gen, dev)[0], seq_dim=False)
        if noise is None:
            noise = lay.draw(torch.randn((lay.Bg, lay.Lg) + tuple(x1.shape[2:]), generator=gen,
                                         device=dev))
        drops = (class_drop if isinstance(class_drop, (tuple, list))
                 else (class_drop, class_drop))
        sc_seed = pass_seed(seed, 1)
        if process.self_condition and self_cond is None:
            self_cond = self_cond_coin(seed)
        terms = process.training_losses(
            lambda x, tt, **kw: model_apply(params, x, tt, seed, extras, lay, train=train,
                                            drop=drops[0], **kw),
            x1, t, noise, mask=maskf[..., None], self_cond=self_cond,
            sc_model_fn=lambda x, tt, **kw: model_apply(params, x, tt, sc_seed, extras, lay,
                                                        train=train, drop=drops[1], **kw),
            mask_sum=None if lay.seq is None else lay.seq_sum)
        per_sample = terms["loss"] * valid
        if t_weights is not None:
            loss = (per_sample * t_weights).sum() / n_valid
        else:
            loss = per_sample.sum() / n_valid
        aux = {"mse": lay.world_sum(((terms["mse"] * valid).sum() / n_valid).detach()),
               "weight": n_valid}
        if lay.mesh is None:
            aux.update(loss_per_sample=per_sample.detach(), t=t, valid_mask=valid)
        else:
            aux.update(loss_per_sample=lay.mesh.data_gather(lay.seq_sum(per_sample.detach())),
                       t=lay.mesh.data_gather(t), valid_mask=lay.mesh.data_gather(valid))
        if process.self_condition:
            aux["self_cond"] = bool(self_cond)
        return loss, aux

    def train_step(state, x1, extras, seed, t=None, noise=None, t_weights=None,
                   self_cond=None, class_drop=None, draws=None):
        """One (micro-)step: loss, grads of the f32 masters (summed over the
        mesh's ranks), the optimizer (clip + AdamW, on every N-th micro-step
        under gradient accumulation) and the EMA. t_weights [B] weigh the
        per-sample losses (the loss-second-moment sampler's). self_cond: the
        self-conditioning coin; class_drop: the class-dropout vector (bool
        [B]) of both passes, or (main pass, first pass); draws: a flow
        step's injected draws (x0, t, eps, pick; of the global batch).
        Returns (state, metrics: loss, the unclipped grad_norm of this
        micro-step's grads, the grads, and the aux: diffusion's mse,
        loss_per_sample, t, valid_mask, weight, self_cond; a flow's weight
        (the token count) and sbcfm's score)."""
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, aux = loss_fn(params, x1, extras, seed, t=t, noise=noise, t_weights=t_weights,
                            self_cond=self_cond, class_drop=class_drop, draws=draws)
        grads = _grads(loss, params)
        if mesh is not None:
            grads = mesh.sum_grads(grads)
            loss = mesh.world_sum(loss.detach())
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
        if mesh is not None:
            loss = mesh.world_sum(loss)
        return dict(aux, loss=loss)

    return train_step, eval_step


def make_distill_step(model, teacher_process, student_process, *, ema_decay=0.9999,
                      compute_dtype=None, mesh=None):
    """(train_step, eval_step) of progressive distillation (gen/distill.py),
    the counterpart of JAX's `make_distill_step`: the student (the trained
    state) learns to make in one DDIM step of `student_process` the two
    frozen-teacher steps of `teacher_process`. Dropout is off on both
    branches; the teacher runs under no_grad on its own params (its weights
    cast to compute_dtype once per teacher); the loss and its mse are
    weighted by the valid samples; the update is the state's clip + AdamW,
    then the EMA. A step runs two teacher evaluations and the student's
    forward and backward: 18 K1, 9 K2, 6 K3 and 3 K4 at 3 + 3 layers.

    train_step(state, teacher_params, x1, extras, seed, i_s=None,
    noise=None) -> (state, metrics: loss, mse, grad_norm, weight, grads).
    The student indices i_s [B] and the q-sample noise are drawn from a
    generator seeded with `seed` on the batch's device (i_s, then the
    noise), unless given. `mesh`: data parallelism as in make_latent_step
    (the draws the global batch's, global counts, gradients summed)."""
    from codlad_tpu_torch.gen.distill import distill_loss_terms

    cast_cache = {}

    def teacher_weights(teacher_params):
        if compute_dtype is None:
            return teacher_params
        key = id(teacher_params)
        if key not in cast_cache:
            cast_cache.clear()
            cast_cache[key] = (teacher_params, _cast_params(teacher_params, compute_dtype))
        return cast_cache[key][1]

    def model_apply(params, x, t, extras):
        cg = extras["cg_xyz"]
        if compute_dtype is not None:
            x, cg = x.to(compute_dtype), cg.to(compute_dtype)
        out = functional_call(model, params, (x, t, extras["res_type"], cg, extras["mask"]),
                              {"deterministic": True})
        return out.to(torch.float32)

    def loss_fn(params, teacher_params, x1, extras, seed, i_s=None, noise=None):
        lay = _Layout(mesh, x1)
        if lay.seq is not None:
            raise ValueError("distillation runs data-parallel only (no seq mesh)")
        dev = x1.device
        valid, n_valid = lay.valid(extras["mask"])
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        if i_s is None:
            i_s = lay.draw(torch.randint(0, student_process.num_timesteps, (lay.Bg,),
                                         generator=gen, device=dev), seq_dim=False)
        if noise is None:
            noise = lay.draw(torch.randn((lay.Bg,) + tuple(x1.shape[1:]), generator=gen,
                                         device=dev), seq_dim=False)
        tp = teacher_weights(teacher_params)
        sp = params if compute_dtype is None else _cast_params(params, compute_dtype)
        terms = distill_loss_terms(
            teacher_process, student_process, lambda x, t: model_apply(tp, x, t, extras),
            lambda x, t: model_apply(sp, x, t, extras), x1, i_s, noise,
            mask=extras["mask"].to(torch.float32)[..., None])
        loss = (terms["loss"] * valid).sum() / n_valid
        return loss, {"mse": lay.world_sum(((terms["mse"] * valid).sum() / n_valid).detach()),
                      "weight": n_valid}

    def train_step(state, teacher_params, x1, extras, seed, i_s=None, noise=None):
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        loss, aux = loss_fn(params, teacher_params, x1, extras, seed, i_s, noise)
        grads = _grads(loss, params)
        if mesh is not None:
            grads = mesh.sum_grads(grads)
            loss = mesh.world_sum(loss.detach())
        gnorm = global_norm(grads)
        state.apply_gradients(grads, gnorm)
        state.update_ema(ema_decay)
        return state, dict(aux, loss=loss.detach(), grad_norm=gnorm, grads=grads)

    @torch.no_grad()
    def eval_step(state, teacher_params, x1, extras, seed, i_s=None, noise=None):
        loss, aux = loss_fn(state.params, teacher_params, x1, extras, seed, i_s, noise)
        return dict(aux, loss=loss if mesh is None else mesh.world_sum(loss))

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
    counts = data_sum(torch.zeros(n_codes, dtype=torch.float32, device=idx.device).index_add_(
        0, torch.where(inside, idx, torch.zeros_like(idx)), w * inside.to(w.dtype)))
    p = counts / torch.clamp(counts.sum(), min=1.0)
    ent = torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)), torch.zeros_like(p))
    return torch.exp(-ent.sum()), (counts > 0).to(torch.float32).mean()


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


def _rows_randn(shape, generator, mesh):
    """A standard-normal draw of this rank's rows of the global batch (the
    whole draw without a mesh)."""
    if mesh is None or mesh.data == 1:
        return torch.randn(shape, generator=generator, device=generator.device)
    B = shape[0]
    full = torch.randn((B * mesh.data,) + tuple(shape[1:]), generator=generator,
                       device=generator.device)
    return full[mesh.data_rank * B:(mesh.data_rank + 1) * B]


# Stage-1 metrics that are not a sum of the ranks' parts (computed from
# global counts already)
_GLOBAL_METRICS = ("vq_perplexity", "vq_usage")


def _stage1_step(forward, mesh, skip_loss_threshold):
    """The Stage-1 train step around `forward(params, state, batch, w, seed,
    draws) -> (loss, metrics, new VQ state)`: grads, the skip rule and the
    update. Under a data mesh the forward runs under summing_over (global
    counts), the grads and the loss terms are summed over the ranks, and the
    skip rule reads the global loss, so every rank decides alike."""

    def train_step(state, batch, weights_arr, return_grads=False, seed=0, draws=None):
        w = _weights_from_array(weights_arr)
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        with summing_over(mesh):
            loss, metrics, new_vq = forward(params, state, batch, w, seed, draws)
        grads = _grads(loss, params)
        if mesh is not None:
            grads = mesh.sum_grads(grads)
            metrics = {k: v if k in _GLOBAL_METRICS else mesh.data_sum(v)
                       for k, v in metrics.items()}
            loss = metrics["loss"]
        good, sync_ms = _skip_or_apply(state, loss, grads, skip_loss_threshold, new_vq)
        metrics["skipped"] = torch.tensor(0.0 if good else 1.0)
        metrics["sync_ms"] = torch.tensor(sync_ms)
        if return_grads:
            metrics["grads"] = grads
        return state, metrics

    return train_step


def _stage1_eval(forward, mesh):
    @torch.no_grad()
    def eval_step(state, batch, weights_arr):
        with summing_over(mesh):
            metrics = forward(state.params, state, batch, _weights_from_array(weights_arr))
        if mesh is not None:
            metrics = {k: v if k in _GLOBAL_METRICS else mesh.data_sum(v)
                       for k, v in metrics.items()}
        return metrics

    return eval_step


def make_vqvae_step(vae, *, vq_decay=0.99, commitment_weight=0.25, skip_loss_threshold=50.0,
                    quantizer=None, mesh=None):
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
    same keys with no draw and the state left as it is.

    mesh (train/mesh.Mesh): data parallelism, each rank passing its rows of
    the global batch: the masked means' counts, the EMA codebook's counts
    and sums and the codebook metrics are the global batch's, the
    reparametrisation's eps is the global draw's rows, and the grads, loss
    terms and skip decision are summed / taken over the ranks, so the step
    is that of one rank on the global batch (the Gumbel and expiry draws
    excepted)."""
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
                    eps = _rows_randn(sigma.shape, gen, mesh)
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

    train_step = _stage1_step(
        lambda p, st, b, w, seed, draws: forward(p, st.vq_state, b, w, True, seed, draws),
        mesh, skip_loss_threshold)
    eval_step = _stage1_eval(lambda p, st, b, w: forward(p, st.vq_state, b, w, False)[1], mesh)
    return train_step, eval_step


def make_genzprot_step(model, *, beta=0.05, max_kl_free=0.01, skip_loss_threshold=50.0,
                       mesh=None):
    """(train_step, eval_step) of GenZProt (models/vae.GenZProt), the
    counterpart of `make_genzprot_step` in codlad_tpu/train/steps.py: loss =
    recon + beta * max(KL(posterior || CG prior) - max_kl_free, 0), the
    decoder reading a posterior draw in training (eps from a generator
    seeded with `seed`, or `draws["eps"]`) and mu at eval; the skip rule of
    make_vqvae_step (the whole state kept). Metrics: the loss terms, kl,
    loss (and skipped, sync_ms in training). mesh: data parallelism as in
    make_vqvae_step; each rank's KL is its part of the global batch's, and
    the clamp acts on the global KL (each rank subtracting its share of
    max_kl_free where the global KL exceeds it)."""
    from codlad_tpu_torch.train.losses import kl_gaussians, vqvae_loss_terms

    def forward(params, batch, w, train, seed=0, draws=None):
        batch = decompress_indices(batch)
        eps = None
        if train:
            eps = (draws or {}).get("eps")
            if eps is None:
                eps = _rows_randn(tuple(batch["res_type"].shape) + (model.embed_dim,),
                                  _step_generator(seed, batch["res_type"].device), mesh)
        mu, sigma, pmu, psigma, ic_recon = functional_call(model, params, (batch,),
                                                           {"eps": eps})
        recon, metrics = vqvae_loss_terms(batch, ic_recon, w)
        kl = kl_gaussians(mu, sigma, pmu, psigma, batch["res_mask"])
        if data_size() > 1:
            active = (data_sum(kl.detach()) > max_kl_free).to(kl.dtype)
            kl = (kl - max_kl_free / data_size()) * active
        else:
            kl = torch.clamp(kl - max_kl_free, min=0.0)
        loss = recon + beta * kl
        return loss, {k: v.detach() for k, v in dict(metrics, kl=kl, loss=loss).items()}, None

    train_step = _stage1_step(lambda p, st, b, w, seed, draws: forward(p, b, w, True, seed, draws),
                              mesh, skip_loss_threshold)
    eval_step = _stage1_eval(lambda p, st, b, w: forward(p, b, w, False)[1], mesh)
    return train_step, eval_step
