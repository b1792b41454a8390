"""Sequence parallelism: the residues of a chain sharded over ranks.

Counterpart of codlad_tpu/parallel/sequence.py over torch.distributed. The
only O(L^2) object of the denoiser is the kNN distance matrix, so the top-k
is ring-streamed (`ring_knn`): each rank scores its own rows against every
rank's coordinate block in turn, passed one hop along the ring, and merges
a running top-k, never forming [L, L]. The per-node tables (coordinates,
frames, node states) are all-gathered where a neighbour gather needs them
(`seq_all_gather`, whose backward sums each rank's gradient of the table
back onto the rows' owner); the [B, L, K, H] edge tensors stay sharded.

The denoiser takes a `SeqGroup` as its `seq` argument (models/denoiser.py):
the same parameters as the dense model, so checkpoints are interchangeable.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class SeqGroup:
    """The seq ranks of one data row: their process group (None for one
    rank), their number, this rank's place among them and their global
    ranks in seq order."""

    group: Any
    size: int
    rank: int
    ranks: tuple = (0,)


class _AllGather(torch.autograd.Function):
    """cat over the seq ranks of each one's x along dim 1; the backward sums
    the ranks' gradients of the gathered table and keeps this rank's rows
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        parts = [torch.empty_like(x) for _ in range(seq.size)]
        dist.all_gather(parts, x.contiguous(), group=seq.group)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        seq = ctx.seq
        g = g.contiguous()
        n = g.shape[1] // seq.size
        if dist.get_backend(seq.group) == "nccl":
            chunks = [c.contiguous() for c in g.split(n, 1)]
            out = torch.empty_like(chunks[0])
            dist.reduce_scatter(out, chunks, group=seq.group)
            return out, None
        dist.all_reduce(g, group=seq.group)   # gloo has no reduce-scatter
        return g[:, seq.rank * n:(seq.rank + 1) * n].contiguous(), None


def seq_all_gather(x, seq: SeqGroup):
    """The full table [B, N, ...] of a per-node table x [B, N / size, ...]
    sharded on dim 1, with gradients."""
    if seq.size == 1:
        return x
    if not torch.is_floating_point(x):
        parts = [torch.empty_like(x) for _ in range(seq.size)]
        dist.all_gather(parts, x.contiguous(), group=seq.group)
        return torch.cat(parts, 1)
    return _AllGather.apply(x, seq)


def local_rows(table, seq: SeqGroup):
    """This rank's row block of a full per-node table [B, N, ...]."""
    n = table.shape[1] // seq.size
    return table[:, seq.rank * n:(seq.rank + 1) * n]


def _ring_pass(blocks, seq):
    """Each tensor of `blocks` sent to the next seq rank; the previous
    rank's received in its place."""
    nxt = seq.ranks[(seq.rank + 1) % seq.size]
    prv = seq.ranks[(seq.rank - 1) % seq.size]
    out = [torch.empty_like(b) for b in blocks]
    ops = [dist.P2POp(dist.isend, b.contiguous(), nxt, seq.group) for b in blocks]
    ops += [dist.P2POp(dist.irecv, o, prv, seq.group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _block_dist(Ca, blk, maskf, blk_mask, eps, big):
    d = torch.sqrt(torch.sum((Ca[:, :, None, :] - blk[:, None, :, :]) ** 2, dim=-1) + eps)
    valid = maskf[:, :, None] * blk_mask[:, None, :]
    return d * valid + (1.0 - valid) * big


def ring_knn(Ca, maskf, k, seq: SeqGroup, eps=1e-6, big=1e9):
    """kNN over sequence-sharded coordinates without the [L, L] matrix.

    Ca [B, L_loc, 3] and maskf [B, L_loc] are this rank's rows; returns
    (D_neighbors [B, L_loc, k], E_idx [B, L_loc, k] int64 of GLOBAL residue
    indices) for them. Valid pairs score the dense featurizer's masked
    distances; an invalid pair scores `big` (the dense path adds the row
    maximum instead), so where a row has fewer than k valid neighbours its
    fill indices may differ from the dense path's; both fill with masked
    nodes, whose messages the attention mask zeroes.

    Step s scores the block of seq rank (rank - s) mod size and merges it
    into the running top-k by a stable ascending sort of [running, block]:
    on ties the lower candidate position wins, as jax.lax.top_k keeps it.
    The ring passes no gradient; where Ca needs one, the selected distances
    are recomputed from the gathered coordinates (the same arithmetic, so
    the same values), and the gradient flows through seq_all_gather."""
    B, L_loc, _ = Ca.shape
    with torch.no_grad():
        top_d = torch.full((B, L_loc, k), big, dtype=Ca.dtype, device=Ca.device)
        top_i = torch.zeros((B, L_loc, k), dtype=torch.int64, device=Ca.device)
        blk, blk_mask = Ca.detach(), maskf.detach()
        ar = torch.arange(L_loc, device=Ca.device)
        for step in range(seq.size):
            d = _block_dist(Ca.detach(), blk, maskf.detach(), blk_mask, eps, big).to(Ca.dtype)
            src = (seq.rank - step) % seq.size
            gidx = (src * L_loc + ar).expand(B, L_loc, L_loc)
            cand_d = torch.cat([top_d, d], dim=-1)
            cand_i = torch.cat([top_i, gidx], dim=-1)
            top_d, sel = torch.sort(cand_d, dim=-1, stable=True)
            top_d = top_d[..., :k]
            top_i = torch.gather(cand_i, -1, sel[..., :k])
            if step < seq.size - 1:
                blk, blk_mask = _ring_pass([blk, blk_mask], seq)
    if torch.is_grad_enabled() and (Ca.requires_grad or maskf.requires_grad):
        Ca_full = seq_all_gather(Ca, seq)
        m_full = seq_all_gather(maskf, seq)
        nb = torch.gather(Ca_full, 1, top_i.reshape(B, -1, 1).expand(-1, -1, 3)).reshape(
            B, L_loc, k, 3)
        nm = torch.gather(m_full, 1, top_i.reshape(B, -1)).reshape(B, L_loc, k)
        d = torch.sqrt(torch.sum((Ca[:, :, None, :] - nb) ** 2, dim=-1) + eps)
        valid = maskf[:, :, None] * nm
        top_d = (d * valid + (1.0 - valid) * big).to(Ca.dtype)
    return top_d, top_i
