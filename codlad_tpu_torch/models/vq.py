"""Vector quantization at inference: the EMA-VQ codebook snap.

Counterpart of `nearest_code` and `vq_quantize(train=False)` in
codlad_tpu/models/vq.py; the codebook is a plain [n_codes, dim] tensor.
"""

from __future__ import annotations

import torch


def nearest_code(codebook, z_flat):
    """argmin_k |z - e_k|^2 via the matmul expansion (first index on ties)."""
    dist = (torch.sum(z_flat ** 2, dim=-1, keepdim=True)
            - 2.0 * z_flat @ codebook.T
            + torch.sum(codebook ** 2, dim=-1)[None, :])
    return torch.argmin(dist, dim=-1)


def vq_quantize(codebook, z, mask=None, commitment_weight=0.25):
    """Snap z [..., D] to its nearest codewords.

    Returns (z_q, indices [...], commit_loss); `mask` (broadcastable to
    z[..., 0]) excludes padded positions from the loss."""
    D = z.shape[-1]
    idx = nearest_code(codebook, z.reshape(-1, D))
    quantized = codebook[idx].reshape(z.shape)
    if mask is None:
        maskf = torch.ones(z.shape[:-1], dtype=z.dtype, device=z.device)
    else:
        maskf = torch.broadcast_to(mask, z.shape[:-1]).to(z.dtype)
    denom = torch.clamp(maskf.sum() * D, min=1.0)
    commit_loss = commitment_weight * torch.sum((z - quantized) ** 2 * maskf[..., None]) / denom
    # the straight-through expression, kept for value parity
    z_q = z + (quantized - z)
    return z_q, idx.reshape(z.shape[:-1]), commit_loss
