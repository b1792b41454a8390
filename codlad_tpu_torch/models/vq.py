"""Vector quantization: the plain EMA-VQ codebook, at inference and in training.

Counterpart of `VQState`, `vq_init`, `nearest_code` and `vq_quantize` in
codlad_tpu/models/vq.py. At inference the codebook is a plain
[n_codes, dim] tensor (`vq_quantize`); in training a `VQState` carries the
codebook with its EMA statistics and `vq_train` returns the updated state
(JAX `vq_quantize(train=True)`). The other quantizers (cosine, Gumbel,
residual, multi-head, FSQ, dead-code expiry) are not ported.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class VQState:
    codebook: torch.Tensor      # [n_codes, dim]
    cluster_size: torch.Tensor  # [n_codes] EMA of assignment counts
    embed_avg: torch.Tensor     # [n_codes, dim] EMA of assigned-vector sums

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def to(self, device):
        return VQState(**{k: v.to(device) for k, v in self.tensors().items()})


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


def _snap(codebook, z, mask, commitment_weight):
    """(z_q straight-through, idx [N], quantized, mask [...], commit_loss)."""
    D = z.shape[-1]
    idx = nearest_code(codebook, z.reshape(-1, D))
    quantized = codebook[idx].reshape(z.shape)
    if mask is None:
        maskf = torch.ones(z.shape[:-1], dtype=z.dtype, device=z.device)
    else:
        maskf = torch.broadcast_to(mask, z.shape[:-1]).to(z.dtype)
    denom = torch.clamp(maskf.sum() * D, min=1.0)
    diff = (z - quantized.detach()) ** 2
    commit_loss = commitment_weight * torch.sum(diff * maskf[..., None]) / denom
    # straight-through: the value of the code, the gradient of z (identity)
    z_q = z + (quantized - z).detach()
    return z_q, idx, maskf, commit_loss


def vq_quantize(codebook, z, mask=None, commitment_weight=0.25):
    """Snap z [..., D] to its nearest codewords.

    Returns (z_q, indices [...], commit_loss); `mask` (broadcastable to
    z[..., 0]) excludes padded positions from the loss."""
    z_q, idx, _, commit_loss = _snap(codebook, z, mask, commitment_weight)
    return z_q, idx.reshape(z.shape[:-1]), commit_loss


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
        bins = onehot.sum(0)
        dw = onehot.T @ z.detach().reshape(-1, D)
        cluster_size = state.cluster_size * decay + bins * (1 - decay)
        embed_avg = state.embed_avg * decay + dw * (1 - decay)
        n = cluster_size.sum()
        smoothed = (cluster_size + epsilon) / (n + n_codes * epsilon) * n
        codebook = embed_avg / smoothed[:, None]
        codebook = torch.where(cluster_size[:, None] > 1e-3, codebook, state.codebook)
    new_state = VQState(codebook=codebook, cluster_size=cluster_size, embed_avg=embed_avg)
    return z_q, idx.reshape(z.shape[:-1]), commit_loss, new_state
