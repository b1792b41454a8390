"""K8 edge gather and K9 edge aggregate: CUDA kernels and plain versions.

Counterparts of `edge_gather` / `edge_aggregate` in
codlad_tpu/kernels/edge_kernels.py (Pallas `_pallas_gather`,
`_pallas_aggregate`):

* K8 `edge_gather(idx, mask, nodes)`: out[b, e] = mask[b, e] * nodes[b,
  idx[b, e]], idx [B, E] int, mask [B, E] f32, nodes [B, N, F] -> [B, E, F]
  in the nodes' dtype. An index gather is exact, so the kernel equals the
  plain version (`index_select`, then the mask in the nodes' dtype) bit for
  bit in both dtypes; the TPU's one-hot and hi/lo split are not carried
  over. The kernel moves 4-element vectors where F % 4 == 0 and the nodes'
  storage is aligned to them, single elements otherwise; it takes B*E*F and
  B*N*F below 2^31 (int32 offsets) and raises beyond.
* K9 `edge_aggregate(idx, mask, msgs, n_nodes, reduce, csr)`: out[b, n] =
  sum_e mask[b, e] * msgs[b, e] [idx[b, e] == n], summed in f32 and cast to
  the msgs' dtype; reduce="mean" then divides by max(valid degree, 1) in
  that dtype, as DenseEdgeOps does (codlad_tpu/nn/graph.py). The kernel
  reads a CSR of the valid edges by node (`build_csr`: a stable sort of the
  flat node index, built once per batch and shared by every aggregate); a
  group of lanes sums each node's edges in sub-slots, then a fixed tree
  (tests/_torch_aggregate_order.py repeats the order in torch), so a run
  repeats bit for bit (no f32 atomics). The kernel loads 16-byte-aligned
  rows; an offset view of msgs is copied first. The plain version is
  `index_add_` in f32.

On a CUDA tensor each wrapper launches its kernel (`csrc/edge_ops.cu`) or
raises; the plain versions run only for tensors on the CPU, where autograd
differentiates them (`index_select`, `index_add_`). On the card each
wrapper is a torch.autograd.Function whose backward is the other kernel,
as the JAX custom VJPs define them (codlad_tpu/kernels/edge_kernels.py
`_gather_bwd`, `_aggregate_bwd`):

* d nodes of K8 = K9 sum of the cotangent by the same index, summed in f32
  and cast to the nodes' dtype; it needs a CSR of that index (`csr`, or a
  function that returns it, built at the first backward if not given);
* d msgs of K9 = K8 gather of the cotangent by the same index (0 for masked
  edges); for reduce="mean" the cotangent is first divided by max(valid
  degree, 1) in the payload dtype (the VJP of the forward's division).

A backward launches nothing when its input needs no grad.
"""

from __future__ import annotations

import ctypes

import torch

from codlad_tpu_torch.kernels import build

LAUNCHES = {"edge_gather": 0, "edge_aggregate": 0}   # K8, K9
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_GATHER_ARGS = [_P] * 4 + [_I] * 4       # idx, mask, nodes, out; B, E, N, F
_AGGREGATE_ARGS = [_P] * 5 + [_I] * 3    # ptr, edges, mask, msgs, out; n_nodes, F, mean


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _flat_index(idx, n_nodes):
    B = idx.shape[0]
    offs = (torch.arange(B, device=idx.device) * n_nodes)[:, None]
    return (idx.long() + offs).reshape(-1)


def ref_gather(idx, mask, nodes):
    """Plain K8: index_select, then the mask in the nodes' dtype."""
    B, E = idx.shape
    N, F = nodes.shape[1:]
    out = nodes.reshape(B * N, F).index_select(0, _flat_index(idx, N)).reshape(B, E, F)
    return out * mask[..., None].to(nodes.dtype)


def ref_aggregate(idx, mask, msgs, n_nodes, reduce="sum"):
    """Plain K9: index_add_ of mask * msgs in f32 (float64 for float64
    msgs), cast, then the mean."""
    B, E, F = msgs.shape
    dt = msgs.dtype
    f32 = torch.float64 if dt == torch.float64 else torch.float32
    flat = _flat_index(idx, n_nodes)
    maskf = mask.to(f32).reshape(-1)
    out = torch.zeros((B * n_nodes, F), dtype=f32, device=msgs.device)
    out.index_add_(0, flat, msgs.reshape(-1, F).to(f32) * maskf[:, None])
    out = out.reshape(B, n_nodes, F).to(dt)
    if reduce == "mean":
        deg = torch.zeros(B * n_nodes, dtype=f32, device=msgs.device)
        deg.index_add_(0, flat, maskf)
        out = out / torch.clamp(deg.reshape(B, n_nodes, 1), min=1.0).to(dt)
    return out


def build_csr(idx, mask, n_nodes):
    """(ptr int32 [B*n_nodes + 1], edges int32 [n_valid]): the flat edge
    indices b*E + e of the edges with mask != 0, grouped by flat node
    b*n_nodes + idx[b, e] in a stable order (by edge index within a node)."""
    B, E = idx.shape
    total = B * n_nodes
    key = torch.where(mask.reshape(-1) != 0, _flat_index(idx, n_nodes),
                      torch.full((), total, device=idx.device))
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=total + 1)[:total]
    ptr = torch.zeros(total + 1, dtype=torch.int32, device=idx.device)
    ptr[1:] = torch.cumsum(counts, 0)
    return ptr, order[:int(counts.sum())].to(torch.int32).contiguous()


def _check(dtype, *tensors):
    if dtype not in _SUFFIX:
        raise ValueError(f"the payload must be bfloat16 or float32, not {dtype}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
    return dev


def _launch_gather(idx, mask, nodes):
    dev = nodes.device
    B, E = idx.shape
    N, F = nodes.shape[1:]
    if max(B * E * F, B * N * F) >= 2 ** 31 or B > 65535:
        raise ValueError(f"edge_gather takes B*E*F and B*N*F below 2^31 and B <= 65535 "
                         f"(int32 offsets, the sample on the grid's y axis), not B {B} "
                         f"E {E} N {N} F {F}")
    nodes = nodes.contiguous()   # a view keeps its offset; the kernel checks the alignment
    out = torch.empty((B, E, F), dtype=nodes.dtype, device=dev)
    fn = build.entry("edge_ops", f"edge_gather_{_SUFFIX[nodes.dtype]}", _GATHER_ARGS)
    build.launch(fn, dev, idx.data_ptr(), mask.data_ptr(), nodes.data_ptr(), out.data_ptr(),
                 B, E, N, F)
    LAUNCHES["edge_gather"] += 1
    return out


def _launch_aggregate(mask, msgs, n_nodes, mean, csr):
    dev = msgs.device
    B, E, F = msgs.shape
    ptr, edges = csr
    if ptr.numel() != B * n_nodes + 1:
        raise ValueError(f"the CSR has {ptr.numel() - 1} nodes, not {B * n_nodes}")
    msgs = msgs.contiguous()
    if msgs.data_ptr() % 16:     # a view with a storage offset: the kernel loads vectors
        msgs = msgs.clone()
    out = torch.empty((B, n_nodes, F), dtype=msgs.dtype, device=dev)
    fn = build.entry("edge_ops", f"edge_aggregate_{_SUFFIX[msgs.dtype]}", _AGGREGATE_ARGS)
    build.launch(fn, dev, ptr.data_ptr(), edges.data_ptr(), mask.data_ptr(), msgs.data_ptr(),
                 out.data_ptr(), B * n_nodes, F, int(mean))
    LAUNCHES["edge_aggregate"] += 1
    return out


def _resolve_csr(csr, idx, mask, n_nodes):
    if callable(csr):
        return csr()
    return csr if csr is not None else build_csr(idx, mask, n_nodes)


def _valid_degree(csr, B, n_nodes, dtype):
    """max(valid degree, 1) [B, n_nodes, 1] in `dtype`, from the CSR (masks
    are 0 or 1, so the count of a node's listed edges is its degree)."""
    ptr = csr[0]
    deg = (ptr[1:] - ptr[:-1]).to(torch.float32).reshape(B, n_nodes, 1)
    return torch.clamp(deg, min=1.0).to(dtype)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nodes, idx, mask, csr):
        ctx.save_for_backward(idx, mask)
        ctx.csr, ctx.n_nodes = csr, nodes.shape[1]
        return _launch_gather(idx, mask, nodes)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        idx, mask = ctx.saved_tensors
        csr = _resolve_csr(ctx.csr, idx, mask, ctx.n_nodes)
        return _launch_aggregate(mask, g, ctx.n_nodes, False, csr), None, None, None


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msgs, idx, mask, n_nodes, mean, csr):
        ctx.save_for_backward(idx, mask)
        ctx.mean, ctx.csr = mean, csr
        return _launch_aggregate(mask, msgs, n_nodes, mean, csr)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 6
        idx, mask = ctx.saved_tensors
        if ctx.mean:
            g = g / _valid_degree(ctx.csr, g.shape[0], g.shape[1], g.dtype)
        return _launch_gather(idx, mask, g), None, None, None, None, None


def edge_gather(idx, mask, nodes, csr=None):
    """K8: nodes [B, N, F] -> per-edge rows [B, E, F] (0 where masked).
    `csr` (build_csr(idx, mask, N), or a function returning it) serves the
    backward on the card; it is built there when not given."""
    if nodes.device.type == "cpu":
        return ref_gather(idx, mask, nodes)
    _check(nodes.dtype, nodes, idx, mask)
    idx = idx.to(torch.int32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    if not (nodes.requires_grad and torch.is_grad_enabled()):
        return _launch_gather(idx, mask, nodes)   # no graph to record
    return _Gather.apply(nodes, idx, mask, csr)


def edge_aggregate(idx, mask, msgs, n_nodes, reduce="sum", csr=None):
    """K9: msgs [B, E, F] -> per-node [B, n_nodes, F] in msgs' dtype, summed
    (or averaged over the valid degree, reduce="mean") over each node's
    edges; masked edges drop. `csr` is build_csr(idx, mask, n_nodes) (or a
    function returning it), made here when not given."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"reduce must be 'sum' or 'mean', not {reduce!r}")
    if msgs.device.type == "cpu":
        return ref_aggregate(idx, mask, msgs, n_nodes, reduce)
    _check(msgs.dtype, msgs, idx, mask)
    idx = idx.to(torch.int32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    csr = _resolve_csr(csr, idx, mask, n_nodes)
    if not (msgs.requires_grad and torch.is_grad_enabled()):
        return _launch_aggregate(mask, msgs, n_nodes, reduce == "mean", csr)
    return _Aggregate.apply(msgs, idx, mask, n_nodes, reduce == "mean", csr)
