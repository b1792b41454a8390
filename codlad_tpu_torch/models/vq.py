"""Vector quantization: EMA codebooks, their variants and FSQ, as explicit state.

Counterpart of codlad_tpu/models/vq.py. At inference the plain codebook is
a [n_codes, dim] tensor (`vq_quantize`); in training a `VQState` carries the
codebook with its EMA statistics and `vq_train` returns the updated state
(JAX `vq_quantize(train=True)`). The variants: the cosine codebook on the
sphere, the Gumbel / ReinMax one, stochastic code sampling, the
orthogonality regulariser, multi-head and residual VQ, dead-code expiry and
FSQ, and `Quantizer` / `build_quantize`, one interface over all of them
under the reference's method strings.

Randomness: JAX draws from a key, which does not port. Each random draw
here comes from an explicit `torch.Generator`, or is handed in as the drawn
tensor itself (the Gumbel noise, the expiry picks, the subsample rows), so
that a test can pass JAX's draw.

Under Stage-1 data parallelism (train/mesh.summing_over) the EMA update's
per-code counts and sums and the commitment loss's count are summed over
the ranks, so the codebook moves as one rank's on the global batch would;
an expiring codebook's or Gumbel quantizer's draws are each rank's own.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from codlad_tpu_torch.train.mesh import data_sum, data_size


@dataclasses.dataclass
class VQState:
    codebook: torch.Tensor      # [n_codes, dim]
    cluster_size: torch.Tensor  # [n_codes] EMA of assignment counts
    embed_avg: torch.Tensor     # [n_codes, dim] EMA of assigned-vector sums

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def to(self, device):
        return VQState(**{k: v.to(device) for k, v in self.tensors().items()})

    @classmethod
    def of_codebook(cls, codebook):
        """The state of a plain EMA VQ that snaps to `codebook` [n_codes,
        dim] (its EMA statistics zero: a snap reads only the codes)."""
        return cls(codebook=codebook, cluster_size=codebook.new_zeros(codebook.shape[0]),
                   embed_avg=torch.zeros_like(codebook))


def state_tree(state):
    """A quantizer's state as plain tensors: None (FSQ), {field: tensor} or,
    for the multi-stage kinds, a list of such dicts."""
    if state is None:
        return None
    if isinstance(state, (list, tuple)):
        return [s.tensors() for s in state]
    return state.tensors()


def load_state_tree(state, tree):
    """Copy a `state_tree` into `state`'s tensors (in place, on their device)."""
    if state is None:
        return
    states = state if isinstance(state, (list, tuple)) else [state]
    trees = tree if isinstance(tree, (list, tuple)) else [tree]
    if len(states) != len(trees):
        raise ValueError(f"a VQ state of {len(states)} codebooks, a saved one of {len(trees)}")
    with torch.no_grad():
        for s, t in zip(states, trees):
            for k, v in s.tensors().items():
                v.copy_(torch.as_tensor(t[k]))


def vq_init(gen, n_codes, dim, scale=1.0, device="cpu"):
    """Codes uniform in [-1, 1] * scale / sqrt(dim) (drawn from the torch
    Generator `gen`; JAX's draw from its key does not port), no counts, and
    embed_avg a copy of the codebook."""
    init = (torch.rand((n_codes, dim), generator=gen) * 2.0 - 1.0) * scale / math.sqrt(dim)
    init = init.to(device)
    return VQState(codebook=init, cluster_size=torch.zeros(n_codes, device=device),
                   embed_avg=init.clone())


def nearest_code(codebook, z_flat):
    """argmin_k |z - e_k|^2 via the matmul expansion (first index on ties)."""
    dist = (torch.sum(z_flat ** 2, dim=-1, keepdim=True)
            - 2.0 * z_flat @ codebook.T
            + torch.sum(codebook ** 2, dim=-1)[None, :])
    return torch.argmin(dist, dim=-1)


def _mask_of(z, mask):
    if mask is None:
        return torch.ones(z.shape[:-1], dtype=z.dtype, device=z.device)
    return torch.broadcast_to(mask, z.shape[:-1]).to(z.dtype)


def _commit(z, quantized, maskf, weight):
    """weight * the masked mean of (z - sg(quantized))^2."""
    denom = torch.clamp(data_sum(maskf.sum()) * z.shape[-1], min=1.0)
    return weight * torch.sum((z - quantized.detach()) ** 2 * maskf[..., None]) / denom


def _snap(codebook, z, mask, commitment_weight):
    """(z_q straight-through, idx [N], mask [...], commit_loss)."""
    D = z.shape[-1]
    idx = nearest_code(codebook, z.reshape(-1, D))
    quantized = codebook[idx].reshape(z.shape)
    maskf = _mask_of(z, mask)
    commit_loss = _commit(z, quantized, maskf, commitment_weight)
    # straight-through: the value of the code, the gradient of z (identity)
    z_q = z + (quantized - z).detach()
    return z_q, idx, maskf, commit_loss


def vq_quantize(codebook, z, mask=None, commitment_weight=0.25):
    """Snap z [..., D] to its nearest codewords.

    Returns (z_q, indices [...], commit_loss); `mask` (broadcastable to
    z[..., 0]) excludes padded positions from the loss."""
    z_q, idx, _, commit_loss = _snap(codebook, z, mask, commitment_weight)
    return z_q, idx.reshape(z.shape[:-1]), commit_loss


def _ema_update(state, hard, z_flat, decay, epsilon):
    """(cluster_size, embed_avg, codebook) after one EMA step on the masked
    one-hot assignments `hard` [N, K] of the rows z_flat [N, D]; codes never
    assigned yet (cluster_size <= 1e-3) are left to the caller."""
    n_codes = state.codebook.shape[0]
    cluster_size = state.cluster_size * decay + data_sum(hard.sum(0)) * (1 - decay)
    embed_avg = state.embed_avg * decay + data_sum(hard.T @ z_flat) * (1 - decay)
    n = cluster_size.sum()
    smoothed = (cluster_size + epsilon) / (n + n_codes * epsilon) * n
    return cluster_size, embed_avg, embed_avg / smoothed[:, None]


def vq_train(state: VQState, z, mask=None, decay=0.99, commitment_weight=0.25,
             epsilon=1e-5):
    """vq_quantize(train=True): the snap against state.codebook and the EMA
    update of the codebook from this batch's assignments, padded positions
    excluded. Returns (z_q, indices [...], commit_loss, new VQState).

    The per-code counts and sums are one-hot products (onehot^T 1 and
    onehot^T z), which the card sums in a fixed order, unlike index_add_;
    codes never assigned yet (cluster_size <= 1e-3) keep their value."""
    D = z.shape[-1]
    z_q, idx, maskf, commit_loss = _snap(state.codebook, z, mask, commitment_weight)
    n_codes = state.codebook.shape[0]
    with torch.no_grad():
        onehot = (torch.nn.functional.one_hot(idx, n_codes).to(z.dtype)
                  * maskf.reshape(-1)[:, None])
        cluster_size, embed_avg, codebook = _ema_update(
            state, onehot, z.detach().reshape(-1, D), decay, epsilon)
        codebook = torch.where(cluster_size[:, None] > 1e-3, codebook, state.codebook)
    new_state = VQState(codebook=codebook, cluster_size=cluster_size, embed_avg=embed_avg)
    return z_q, idx.reshape(z.shape[:-1]), commit_loss, new_state


def _vq(state, z, mask, train, decay, commitment_weight, epsilon=1e-5):
    """JAX `vq_quantize(state, ...)`: (z_q, idx, loss, new_state), the state
    returned as it was at eval."""
    if train:
        return vq_train(state, z, mask, decay, commitment_weight, epsilon)
    z_q, idx, loss = vq_quantize(state.codebook, z, mask, commitment_weight)
    return z_q, idx, loss, state


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-8)


def vq_quantize_cosine(state: VQState, z, mask=None, *, train=False, decay=0.99,
                       commitment_weight=0.25, epsilon=1e-5):
    """Cosine-similarity VQ (reference 'low_cosvq_3'): codes and inputs are
    L2-normalised for the search and the codebook lives on the sphere; the
    straight-through runs against the unnormalised input. At eval the
    returned state is the normalised one, as in JAX."""
    sphere = VQState(codebook=_unit(state.codebook), cluster_size=state.cluster_size,
                     embed_avg=state.embed_avg)
    zq, idx, loss, new_state = _vq(sphere, _unit(z), mask, train, decay,
                                   commitment_weight, epsilon)
    if train:
        new_state = dataclasses.replace(new_state, codebook=_unit(new_state.codebook))
    return z + (zq - z).detach(), idx, loss, new_state


def gumbel_noise(shape, generator=None, device="cpu"):
    """Standard Gumbel draws -log(-log U), U uniform in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp(min=tiny)
    return -torch.log(-torch.log(u))


def _gumbel_onehot_st(logits, gumbel, temperature=1.0, reinmax=True):
    """Sample D ~ Categorical(softmax(logits / T)) as argmax(logits / T +
    gumbel) and return (hard one-hot whose backward is the plain ST softmax
    or the second-order ReinMax estimator, idx)."""
    t = max(temperature, 1e-6)
    idx = torch.argmax(logits / t + gumbel, dim=-1)
    hard = torch.nn.functional.one_hot(idx, logits.shape[-1]).to(logits.dtype)
    if reinmax:
        # pi2 = 2 softmax(sg[log((D + softmax(logits/T)) / 2) - logits] + logits)
        #       - 0.5 softmax(logits); the gradient flows through the logits
        pi0 = torch.softmax(logits, dim=-1)
        pi1 = (hard + torch.softmax(logits / t, dim=-1)) / 2
        shift = (torch.log(torch.clamp(pi1, min=1e-20)) - logits).detach()
        soft = 2.0 * torch.softmax(shift + logits, dim=-1) - 0.5 * pi0
    else:
        soft = torch.softmax(logits / t, dim=-1)
    return hard + soft - soft.detach(), idx


def vq_quantize_gumbel(state: VQState, z, mask=None, *, train=False, decay=0.99,
                       commitment_weight=0.25, epsilon=1e-5, temperature=1.0, reinmax=True,
                       generator=None, gumbel=None):
    """Gumbel / cosine VQ (reference 'low3_num16_gumble_cos'): cosine logits
    over the L2-normalised codebook. In training the code is sampled with
    Gumbel noise ([N, n_codes]: `gumbel`, else drawn from `generator`) and
    the gradient flows through the ReinMax one-hot selection; the EMA update
    uses the sampled (masked) assignments. At eval the argmax code is taken
    and nothing is drawn."""
    D = z.shape[-1]
    cb = _unit(state.codebook)
    z_flat = z.reshape(-1, D)
    zn = _unit(z_flat)
    logits = zn @ cb.T
    maskf = _mask_of(z, mask)
    if train:
        if gumbel is None:
            gumbel = gumbel_noise(logits.shape, generator, logits.device)
        onehot_st, idx = _gumbel_onehot_st(logits, gumbel.to(logits.dtype), temperature,
                                           reinmax)
        quantized = (onehot_st @ cb).reshape(z.shape)
        n_codes = cb.shape[0]
        with torch.no_grad():
            hard = (torch.nn.functional.one_hot(idx, n_codes).to(z.dtype)
                    * maskf.reshape(-1)[:, None])
            cluster_size, embed_avg, codebook = _ema_update(state, hard, zn.detach(), decay,
                                                            epsilon)
            codebook = torch.where(cluster_size[:, None] > 1e-3, _unit(codebook),
                                   state.codebook)
        new_state = VQState(codebook=codebook, cluster_size=cluster_size, embed_avg=embed_avg)
    else:
        idx = torch.argmax(logits, dim=-1)
        quantized = cb[idx].reshape(z.shape)
        new_state = state
    loss = _commit(_unit(z_flat).reshape(z.shape), quantized, maskf, commitment_weight)
    # training: the gradient through the ReinMax selection, not the identity
    z_q = quantized if train else z + (quantized - z).detach()
    return z_q, idx.reshape(z.shape[:-1]), loss, new_state


def vq_sample_stochastic(state: VQState, z, temperature=1.0, generator=None, gumbel=None):
    """Stochastic code sampling: idx ~ softmax(-d^2 / T) (Gumbel `gumbel`
    [N, n_codes], else drawn from `generator`). Returns (z_q, idx)."""
    D = z.shape[-1]
    z_flat = z.reshape(-1, D)
    cb = state.codebook
    dist = (torch.sum(z_flat ** 2, -1, keepdim=True) - 2 * z_flat @ cb.T
            + torch.sum(cb ** 2, -1)[None])
    if gumbel is None:
        gumbel = gumbel_noise(dist.shape, generator, dist.device)
    idx = torch.argmax(-dist / max(temperature, 1e-6) + gumbel.to(dist.dtype), dim=-1)
    zq = cb[idx].reshape(z.shape)
    return z + (zq - z).detach(), idx.reshape(z.shape[:-1])


def orthogonal_reg_loss(codebook, weight=10.0, max_codes=None, generator=None, pick=None):
    """Orthogonality regulariser (reference 'orthogonal_vq'): weight *
    ||C C^T - I||^2 / K^2 over the L2-normalised codes, on `max_codes` of
    them drawn without replacement when the codebook is larger (the rows
    `pick`, else a permutation from `generator`)."""
    if max_codes is not None and codebook.shape[0] > max_codes:
        if pick is None:
            pick = torch.randperm(codebook.shape[0], generator=generator)[:max_codes]
        codebook = codebook[torch.as_tensor(pick, device=codebook.device).long()]
    n = codebook.shape[0]
    cb = _unit(codebook)
    gram = cb @ cb.T
    eye = torch.eye(n, dtype=gram.dtype, device=gram.device)
    return weight * ((gram - eye) ** 2).sum() / (n * n)


def multihead_vq_quantize(states, z, mask=None, *, train=False, decay=0.99,
                          commitment_weight=0.25):
    """Multi-head VQ (reference 'headvq'): the channels split into
    len(states) heads, each quantized against its own codebook. Returns
    (z_q, indices [..., H], mean commit loss, states)."""
    H = len(states)
    outs, idxs, losses, new_states = [], [], 0.0, []
    for st, part in zip(states, torch.chunk(z, H, dim=-1)):
        zq, idx, loss, ns = _vq(st, part, mask, train, decay, commitment_weight)
        outs.append(zq)
        idxs.append(idx)
        losses = losses + loss
        new_states.append(ns)
    return torch.cat(outs, -1), torch.stack(idxs, -1), losses / H, new_states


def residual_vq_quantize(states, z, mask=None, *, train=False, decay=0.99,
                         commitment_weight=0.25):
    """Residual VQ: stage i quantizes the residual the stages before it
    left, against its own codebook, and the output is the sum of the stage
    codes, with one straight-through around that sum. Returns (z_q, indices
    [..., n_stages], mean commit loss, states)."""
    resid, total = z, torch.zeros_like(z)
    idxs, losses, new_states = [], 0.0, []
    for st in states:
        zq, idx, loss, ns = _vq(st, resid, mask, train, decay, commitment_weight)
        hard = zq.detach()
        total = total + hard
        resid = resid - hard
        idxs.append(idx)
        losses = losses + loss
        new_states.append(ns)
    return z + (total - z).detach(), torch.stack(idxs, -1), losses / len(states), new_states


def expire_dead_codes(state: VQState, z, mask=None, threshold=2.0, generator=None, pick=None):
    """Codes whose EMA cluster size is under `threshold` become rows of the
    batch (reference 'Expiring_stalevq'): row pick[k] (uniform over all of
    z's rows, masked or not, as in JAX; drawn from `generator` unless
    given) for code k."""
    D = z.shape[-1]
    z_flat = z.detach().reshape(-1, D)
    n_codes = state.codebook.shape[0]
    if pick is None:
        pick = torch.randint(0, z_flat.shape[0], (n_codes,), generator=generator,
                             device=z_flat.device)
    replacements = z_flat[torch.as_tensor(pick, device=z_flat.device).long()]
    dead = state.cluster_size < threshold
    return VQState(codebook=torch.where(dead[:, None], replacements, state.codebook),
                   cluster_size=torch.where(dead, torch.full_like(state.cluster_size,
                                                                  threshold),
                                            state.cluster_size),
                   embed_avg=torch.where(dead[:, None], replacements * threshold,
                                         state.embed_avg))


# ---------------------------------------------------------------------------
# FSQ (finite scalar quantization), levels like [7, 5, 5, 5, 5]


def _round_ste(z):
    return z + (torch.round(z) - z).detach()


def fsq_tables(levels):
    """f32 constants of FSQ over `levels`: (half_l, offset, shift,
    half_width, basis), computed in float64 as numpy does and rounded to f32
    as JAX rounds a float64 numpy constant on entry."""
    levels = np.asarray(levels)
    half_l = (levels - 1) * (1 + 1e-3) / 2
    offset = np.where(levels % 2 == 0, 0.5, 0.0)
    shift = np.arctanh(offset / half_l)
    basis = np.concatenate([[1], np.cumprod(levels[:-1])])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return f32(half_l), f32(offset), f32(shift), f32(levels // 2), f32(basis)


def fsq_quantize(z, levels):
    """FSQ: bound each channel, round to `levels` integers, renormalise.

    z: [..., len(levels)]. Returns (z_q in [-1, 1] with a straight-through
    round, the mixed-radix code index [...] int32)."""
    if z.shape[-1] != len(levels):
        raise ValueError(f"fsq over {len(levels)} levels takes z [..., {len(levels)}], "
                         f"not {tuple(z.shape)}")
    half_l, offset, shift, half_width, basis = (c.to(z.device) for c in fsq_tables(levels))
    bounded = torch.tanh(z + shift) * half_l - offset
    z_q = _round_ste(bounded) / half_width
    digits = torch.round(bounded.detach()) + half_width      # in [0, levels)
    idx = torch.sum(digits * basis, dim=-1).to(torch.int32)
    return z_q, idx


# ---------------------------------------------------------------------------
# the reference's build_quantize: one name -> (init, quantize)


class Quantizer:
    """One interface over the VQ variants.

    quantize(state, z, mask, train, generator=None, noise=None) -> (z_q,
    idx, commit_loss, new_state); state is None for the stateless FSQ. The
    kinds that draw at train time (gumbel: Gumbel noise [N, n_codes];
    expire: the replacement rows [n_codes]) take their draw as `noise`, or
    draw it from `generator`."""

    KINDS = ("vqvae", "cosine", "orthogonal", "expire", "fsq", "rvq", "multihead", "gumbel")

    # the reference's build_quantize method strings mapped onto the kinds
    REFERENCE_ALIASES = {
        "vqema": "vqvae",                  # local VectorQuantizerEMA
        "vq_3": "vqvae",                   # dim=3 VectorQuantize
        "fsq_5": "fsq",                    # levels [7,5,5,5,5]
        "Expiring_stalevq": "expire",      # dead-code expiry
        "orthogonal_vq": "orthogonal",     # ortho reg weight 10
        "headvq": "multihead",             # 8 heads, separate books
        "low_cosvq_3": "cosine",           # cosine sim, 16x codes
        "low3_num16_gumble_cos": "gumbel", # gumbel+reinmax+cosine
    }

    def __init__(self, kind, codebook_size=4096, dim=3, levels=None, decay=0.99,
                 commitment_weight=0.25, ortho_weight=10.0, expire_threshold=2.0,
                 n_stages=2, n_heads=None, gumbel_temperature=1.0, reinmax=True):
        if kind in self.REFERENCE_ALIASES:
            # the reference's own defaults ride along with the alias
            if kind == "headvq" and not n_heads:
                n_heads = 8
            if kind in ("low_cosvq_3", "low3_num16_gumble_cos"):
                codebook_size = codebook_size * 16
            kind = self.REFERENCE_ALIASES[kind]
        if kind not in self.KINDS:
            raise ValueError(f"unknown quantize_type {kind!r}")
        self.kind = kind
        self.codebook_size = codebook_size
        self.dim = dim
        self.levels = levels or [7, 5, 5, 5, 5]
        self.decay = decay
        self.commitment_weight = commitment_weight
        self.ortho_weight = ortho_weight
        self.expire_threshold = expire_threshold
        self.n_stages = n_stages
        self.n_heads = n_heads
        self.gumbel_temperature = gumbel_temperature
        self.reinmax = reinmax
        if kind == "fsq" and dim != len(self.levels):
            raise ValueError(
                f"fsq needs vqdim == len(levels) ({len(self.levels)}), got {dim}")
        if kind == "multihead":
            if not n_heads:
                raise ValueError("multihead needs n_heads (-vq_heads)")
            if dim % n_heads:
                raise ValueError(f"vqdim {dim} must divide by n_heads {n_heads}")

    def init(self, gen, device="cpu"):
        """The initial state from the torch Generator `gen`: None (fsq), one
        VQState, or a list (rvq: a codebook a stage; multihead: one a head)."""
        if self.kind == "fsq":
            return None
        if self.kind == "rvq":
            return [vq_init(gen, self.codebook_size, self.dim, device=device)
                    for _ in range(self.n_stages)]
        if self.kind == "multihead":
            return [vq_init(gen, self.codebook_size, self.dim // self.n_heads, device=device)
                    for _ in range(self.n_heads)]
        return vq_init(gen, self.codebook_size, self.dim, device=device)

    def quantize(self, state, z, mask=None, *, train=False, generator=None, noise=None):
        kw = dict(train=train, decay=self.decay, commitment_weight=self.commitment_weight)
        if self.kind == "fsq":
            z_q, idx = fsq_quantize(z, self.levels)
            return z_q, idx, torch.zeros((), dtype=torch.float32, device=z.device), None
        if self.kind == "rvq":
            return residual_vq_quantize(state, z, mask, **kw)
        if self.kind == "multihead":
            return multihead_vq_quantize(state, z, mask, **kw)
        if self.kind == "cosine":
            return vq_quantize_cosine(state, z, mask, **kw)
        if self.kind == "gumbel":
            return vq_quantize_gumbel(state, z, mask, **kw, temperature=self.gumbel_temperature,
                                      reinmax=self.reinmax, generator=generator, gumbel=noise)
        z_q, idx, loss, new_state = _vq(state, z, mask, train, self.decay,
                                        self.commitment_weight)
        if self.kind == "orthogonal":
            # a term of the codebook alone: each data-parallel rank adds its share
            loss = loss + orthogonal_reg_loss(new_state.codebook,
                                              weight=self.ortho_weight) / data_size()
        if self.kind == "expire" and train:
            new_state = expire_dead_codes(new_state, z, mask, self.expire_threshold,
                                          generator=generator, pick=noise)
        return z_q, idx, loss, new_state

    def snap(self, state, z):
        """Inference-time quantization: (z_q, code indices [..., n]) with no
        state update and no draw; the multi-stage kinds' indices are
        flattened into the last axis, for usage histograms."""
        z_q, idx, _, _ = self.quantize(state, z, mask=None, train=False)
        return z_q, idx.reshape(tuple(idx.shape[:z.ndim - 1]) + (-1,))


def build_quantize(quantize_type, codebook_size=4096, dim=3, **kw):
    return Quantizer(quantize_type, codebook_size=codebook_size, dim=dim, **kw)


def quantizer_from_config(cfg):
    """The Quantizer a Stage-1 run config trained with (its
    `-quantize_type`, `-codebook_size`, `-vqdim`, `-fsq_levels`,
    `-vq_stages`, `-vq_heads`), or None for the modes without VQ, as the JAX
    CLIs rebuild it for evaluation (the EMA decay and commitment weight of
    the default, as there)."""
    if cfg.get("train_section", "vqvae") != "vqvae":
        return None
    return build_quantize(cfg.get("quantize_type", "vqvae"),
                          codebook_size=cfg.get("codebook_size", 4096), dim=cfg.get("vqdim", 3),
                          levels=cfg.get("fsq_levels"), n_stages=cfg.get("vq_stages", 2),
                          n_heads=cfg.get("vq_heads"))
