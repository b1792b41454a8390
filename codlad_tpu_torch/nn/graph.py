"""Edge gather/aggregate over per-sample padded edge lists.

Counterpart of codlad_tpu/nn/graph.py. The JAX package picks between dense
one-hot contractions and its Pallas kernels by a memory budget, a choice
about how a TPU's matrix unit should gather. Here every gather is K8
(`kernels.edge_kernels.edge_gather`) and every aggregate K9
(`edge_aggregate`): on CUDA tensors the kernels, on CPU tensors their plain
versions (`index_select`, `index_add_` in f32). Padded edges carry mask 0
and contribute nothing, and the mean divides by the count of valid edges.
"""

from __future__ import annotations

import torch

from codlad_tpu_torch.kernels.edge_kernels import build_csr, edge_aggregate, edge_gather


def make_directed_batched(edges, mask):
    """[B, E, 2] one-way edges -> [B, 2E, 2] both directions (+ mask)."""
    return (torch.cat([edges, edges.flip(-1)], dim=1),
            torch.cat([mask, mask], dim=1))


class EdgeOps:
    """edges [B, E, 2] (src, dst) node indices, mask [B, E], n_nodes per
    sample. Messages aggregate to the src nodes; on the card the CSR of the
    src index is built once, at the first aggregate, and shared by all."""

    def __init__(self, edges, mask, n_nodes):
        self.src = edges[..., 0].to(torch.int32).contiguous()
        self.dst = edges[..., 1].to(torch.int32).contiguous()
        self.mask = mask.to(torch.float32)
        self.n_nodes = n_nodes
        self._csr = None

    def gather_src(self, nodes):
        """nodes [B, N, F] -> [B, E, F] (0 where masked)."""
        return edge_gather(self.src, self.mask, nodes)

    def gather_dst(self, nodes):
        return edge_gather(self.dst, self.mask, nodes)

    def aggregate_to_src(self, msgs, reduce="sum"):
        """msgs [B, E, F] -> [B, N, F], summed (or averaged over the valid
        degree, reduce="mean") over each node's edges."""
        if msgs.device.type == "cuda" and self._csr is None:
            self._csr = build_csr(self.src, self.mask, self.n_nodes)
        return edge_aggregate(self.src, self.mask, msgs, self.n_nodes, reduce, self._csr)
