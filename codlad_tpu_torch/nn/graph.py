"""Edge gather/aggregate over per-sample padded edge lists.

Counterpart of codlad_tpu/nn/graph.py for the decoder's CG graph: where
the JAX package contracts with one-hot selection matrices (a TPU device),
the port indexes: `index_select` gathers node rows per edge and
`index_add_` sums per-edge messages into their source nodes. Padded edges
carry mask 0 and contribute nothing.
"""

from __future__ import annotations

import torch


def make_directed_batched(edges, mask):
    """[B, E, 2] one-way edges -> [B, 2E, 2] both directions (+ mask)."""
    return (torch.cat([edges, edges.flip(-1)], dim=1),
            torch.cat([mask, mask], dim=1))


class EdgeOps:
    """edges [B, E, 2] (src, dst) node indices, mask [B, E], n_nodes per
    sample."""

    def __init__(self, edges, mask, n_nodes):
        B, E, _ = edges.shape
        offs = (torch.arange(B, device=edges.device) * n_nodes)[:, None]
        self.src = (edges[..., 0].long() + offs).reshape(-1)
        self.dst = (edges[..., 1].long() + offs).reshape(-1)
        self.mask = mask.to(torch.float32)
        self.B, self.E, self.n_nodes = B, E, n_nodes

    def _gather(self, nodes, flat_idx):
        F = nodes.shape[-1]
        out = nodes.reshape(-1, F).index_select(0, flat_idx).reshape(self.B, self.E, F)
        return out * self.mask[..., None].to(nodes.dtype)

    def gather_src(self, nodes):
        """nodes [B, N, F] -> [B, E, F] (0 where masked)."""
        return self._gather(nodes, self.src)

    def gather_dst(self, nodes):
        return self._gather(nodes, self.dst)

    def aggregate_to_src(self, msgs):
        """msgs [B, E, F] -> [B, N, F], summed over each node's edges."""
        F = msgs.shape[-1]
        msgs = msgs * self.mask[..., None].to(msgs.dtype)
        out = torch.zeros((self.B * self.n_nodes, F), dtype=msgs.dtype, device=msgs.device)
        out.index_add_(0, self.src, msgs.reshape(-1, F))
        return out.reshape(self.B, self.n_nodes, F)
