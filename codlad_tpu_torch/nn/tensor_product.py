"""Fully-connected tensor-product graph convolution (fixed small irreps).

Counterpart of codlad_tpu/nn/tensor_product.py: `fused_tp_tables` (a copy:
the per-path TP as three tables, CBIG_R [dsh*din, R], EXPW [numel, R],
SUMR [R, dout]), `FullyConnectedTP` (per-edge weights from outside, the
product through K10, kernels/tp_kernels.py) and `TPConv` (per-edge weights
from an MLP over edge features, messages dst -> src, aggregated by an
EdgeOps). `IrrepsLayerNorm` is dormant in the reference and not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from codlad_tpu_torch.kernels.tp_kernels import fused_tp
from codlad_tpu_torch.nn.irreps import Irreps, coupling_tensor, tp_paths
from codlad_tpu_torch.nn.layers import linear


@functools.lru_cache(maxsize=None)
def fused_tp_tables(in_irreps, sh_irreps, out_irreps):
    """Static tables of the TP x (in) (x) y (sh) -> out with per-edge weights:

        TR = concat_b(x * y[b]) @ CBIG_R;  wR = w @ EXPW;  out = (wR * TR) @ SUMR

    over an expansion index r = (path, u, v, c); the weight layout is the
    concatenation of the paths' [mul_in, mul_out] blocks."""
    in_ir, sh_ir, out_ir = Irreps(in_irreps), Irreps(sh_irreps), Irreps(out_irreps)
    paths = tp_paths(in_ir, sh_ir, out_ir)
    din, dout, dsh = in_ir.dim, out_ir.dim, sh_ir.dim
    in_off = [sl.start for sl in in_ir.slices()]
    sh_off = [sl.start for sl in sh_ir.slices()]
    out_off = [sl.start for sl in out_ir.slices()]

    fan_in = {k: 0 for k in range(len(out_ir))}
    for (i, j, k) in paths:
        fan_in[k] += in_ir[i][0] * sh_ir[j][0]
    numel = sum(in_ir[i][0] * out_ir[k][0] for (i, j, k) in paths)
    KT = sum(in_ir[i][0] * (2 * out_ir[k][1] + 1) for (i, j, k) in paths)

    CBIG = np.zeros((dsh * din, KT), np.float32)
    widx, tidx, sum_rows, sum_cols = [], [], [], []
    qt = ow = r = 0
    for (i, j, k) in paths:
        mul1, l1, _ = in_ir[i]
        _, l2, _ = sh_ir[j]
        mul3, l3, _ = out_ir[k]
        d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
        C = coupling_tensor(l1, l2, l3)
        alpha = 1.0 / np.sqrt(fan_in[k])
        for u in range(mul1):
            for c in range(d3):
                col = qt + u * d3 + c
                for a in range(d1):
                    for b in range(d2):
                        row = (sh_off[j] + b) * din + in_off[i] + u * d1 + a
                        CBIG[row, col] = alpha * C[a, b, c]
            for v in range(mul3):
                for c in range(d3):
                    widx.append(ow + u * mul3 + v)
                    tidx.append(qt + u * d3 + c)
                    sum_rows.append(r)
                    sum_cols.append(out_off[k] + v * d3 + c)
                    r += 1
        qt += mul1 * d3
        ow += mul1 * mul3
    R = r
    SUMR = np.zeros((R, dout), np.float32)
    SUMR[np.array(sum_rows), np.array(sum_cols)] = 1.0
    EXPW = np.zeros((numel, R), np.float32)
    EXPW[np.array(widx), np.arange(R)] = 1.0
    return dict(CBIG=CBIG, widx=np.array(widx, np.int32), tidx=np.array(tidx, np.int32),
                SUMR=SUMR, CBIG_R=CBIG[:, np.array(tidx)], EXPW=EXPW, numel=numel, KT=KT,
                R=R, din=din, dsh=dsh, sig=(tuple(in_ir), tuple(sh_ir), tuple(out_ir)))


class FullyConnectedTP(nn.Module):
    """x (in_irreps) (x) y (sh_irreps) -> out_irreps with external per-edge
    weights [..., numel]; each path is scaled by 1/sqrt(fan_in) of its
    output irrep. No parameters."""

    def __init__(self, in_irreps, sh_irreps, out_irreps):
        super().__init__()
        self.tables = fused_tp_tables(tuple(in_irreps), tuple(sh_irreps), tuple(out_irreps))

    @property
    def weight_numel(self):
        return self.tables["numel"]

    def forward(self, x, y, weights):
        """x [..., din], y [..., dsh], weights [..., numel] -> [..., dout] in
        x's dtype (y and the weights are cast to it first)."""
        return fused_tp(x, y.to(x.dtype), weights.to(x.dtype), self.tables)


class IrrepsLayerNorm(nn.Module):
    """Irreps-aware LayerNorm with a learnable mean shift: per irrep,
    subtract a learnable fraction (`mean_shift`, 1 on even scalars, else 0
    at init) of the mean over the multiplicity, divide by the RMS component
    norm over the multiplicity, scale by a `weight` per irrep copy and add a
    `bias` on the even scalars only."""

    def __init__(self, irreps, eps=1e-5):
        super().__init__()
        self.irreps = Irreps(irreps)
        self.eps = eps
        ir = self.irreps
        num_scalar = sum(mul for mul, l, p in ir if l == 0 and p == 1)
        shifts = np.concatenate([np.ones(mul) if (l == 0 and p == 1) else np.zeros(mul)
                                 for mul, l, p in ir])
        self.mean_shift = nn.Parameter(torch.as_tensor(shifts, dtype=torch.float32))
        self.weight = nn.Parameter(torch.ones(ir.num_irreps))
        self.bias = nn.Parameter(torch.zeros(max(num_scalar, 1)))

    def forward(self, x):
        out, iw, ib = [], 0, 0
        for (mul, l, p), blk in zip(self.irreps, self.irreps.split(x)):
            ms = self.mean_shift[iw:iw + mul][:, None]
            blk = blk - blk.mean(dim=-2, keepdim=True) * ms
            norm = (blk ** 2).mean(dim=-1).mean(dim=-1, keepdim=True)
            blk = blk * torch.rsqrt(norm + self.eps)[..., None] * self.weight[iw:iw + mul][:, None]
            iw += mul
            if l == 0 and p == 1:
                blk = blk + self.bias[ib:ib + mul][:, None]
                ib += mul
            out.append(blk)
        return Irreps.merge(out)


def dense(lin, x):
    """A flax Dense with f32 params on x: the input is promoted to the
    params' dtype (bf16 features meet f32 weights in f32)."""
    return lin(x.to(lin.weight.dtype))


class TPConv(nn.Module):
    """Tensor-product message passing over padded edge lists: node i
    aggregates TP(node[dst], sh(edge)) over its edges (src = i, dst = j),
    with the `reduce` of the EdgeOps ("mean" in the encoder)."""

    def __init__(self, in_irreps, sh_irreps, out_irreps, n_edge_features, gen,
                 hidden_features=None, reduce="mean"):
        super().__init__()
        self.tp = FullyConnectedTP(in_irreps, sh_irreps, out_irreps)
        hidden = hidden_features or n_edge_features
        self.reduce = reduce
        self.Dense_0 = linear(n_edge_features, hidden, gen, init="lecun")
        self.Dense_1 = linear(hidden, self.tp.weight_numel, gen, init="lecun")

    def forward(self, node_attr, ops, edge_attr, edge_sh, x_dst=None):
        """node_attr [B, N, din] (gathered by edge dst unless `x_dst` holds
        that gather already), ops: EdgeOps, edge_attr [B, E, F], edge_sh
        [B, E, dsh] -> [B, N, dout]."""
        w = dense(self.Dense_1, dense(self.Dense_0, edge_attr).relu())
        if x_dst is None:
            x_dst = ops.gather_dst(node_attr)
        return ops.aggregate_to_src(self.tp(x_dst, edge_sh, w), reduce=self.reduce)
