"""K8 edge gather and K9 edge aggregate: CUDA kernels and plain versions.

Counterparts of `edge_gather` / `edge_aggregate` in
codlad_tpu/kernels/edge_kernels.py (Pallas `_pallas_gather`,
`_pallas_aggregate`):

* K8 `edge_gather(idx, mask, nodes)`: out[b, e] = mask[b, e] * nodes[b,
  idx[b, e]], idx [B, E] int, mask [B, E] f32, nodes [B, N, F] -> [B, E, F]
  in the nodes' dtype. An index gather is exact, so the kernel equals the
  plain version (`index_select`, then the mask in the nodes' dtype) bit for
  bit in both dtypes; the TPU's one-hot and hi/lo split are not carried
  over.
* K9 `edge_aggregate(idx, mask, msgs, n_nodes, reduce, csr)`: out[b, n] =
  sum_e mask[b, e] * msgs[b, e] [idx[b, e] == n], summed in f32 and cast to
  the msgs' dtype; reduce="mean" then divides by max(valid degree, 1) in
  that dtype, as DenseEdgeOps does (codlad_tpu/nn/graph.py). The kernel
  reads a CSR of the valid edges by node (`build_csr`: a stable sort of the
  flat node index, built once per batch and shared by every aggregate); a
  warp sums each node's edges in a fixed order, so a run repeats bit for
  bit (no f32 atomics). The plain version is `index_add_` in f32.

On a CUDA tensor each wrapper launches its kernel (`csrc/edge_ops.cu`) or
raises; the plain versions run only for tensors on the CPU. Forward only:
the VJP of each is the other, which Stage-1 training will wire up.
"""

from __future__ import annotations

import ctypes

import torch

from codlad_tpu_torch.kernels import build

LAUNCHES = {"edge_gather": 0, "edge_aggregate": 0}   # K8, K9
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


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
    """Plain K9: index_add_ of mask * msgs in f32, cast, then the mean."""
    B, E, F = msgs.shape
    dt, f32 = msgs.dtype, torch.float32
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


def _lib_fn(name, nargs_ptr, nargs_int):
    fn = getattr(build.load("edge_ops"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * nargs_ptr + [ctypes.c_int] * nargs_int + [
        ctypes.c_void_p]
    return fn


def _check(dtype, *tensors):
    if dtype not in _SUFFIX:
        raise ValueError(f"the payload must be bfloat16 or float32, not {dtype}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
    return dev


def _run(fn, dev, *args):
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")


def _no_grad_needed(*tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the edge kernels have no autograd yet; call them under "
                           "torch.no_grad()")


def edge_gather(idx, mask, nodes):
    """K8: nodes [B, N, F] -> per-edge rows [B, E, F] (0 where masked)."""
    if nodes.device.type == "cpu":
        return ref_gather(idx, mask, nodes)
    _no_grad_needed(nodes)
    dev = _check(nodes.dtype, nodes, idx, mask)
    B, E = idx.shape
    N, F = nodes.shape[1:]
    nodes = nodes.contiguous()
    idx = idx.to(torch.int32).contiguous()
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty((B, E, F), dtype=nodes.dtype, device=dev)
    fn = _lib_fn(f"edge_gather_{_SUFFIX[nodes.dtype]}", 4, 4)
    _run(fn, dev, idx.data_ptr(), mask.data_ptr(), nodes.data_ptr(), out.data_ptr(), B, E,
         N, F)
    LAUNCHES["edge_gather"] += 1
    return out


def edge_aggregate(idx, mask, msgs, n_nodes, reduce="sum", csr=None):
    """K9: msgs [B, E, F] -> per-node [B, n_nodes, F] in msgs' dtype, summed
    (or averaged over the valid degree, reduce="mean") over each node's
    edges; masked edges drop. `csr` is build_csr(idx, mask, n_nodes), made
    here when not given."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"reduce must be 'sum' or 'mean', not {reduce!r}")
    if msgs.device.type == "cpu":
        return ref_aggregate(idx, mask, msgs, n_nodes, reduce)
    _no_grad_needed(msgs)
    dev = _check(msgs.dtype, msgs, idx, mask)
    B, E, F = msgs.shape
    ptr, edges = csr if csr is not None else build_csr(idx, mask, n_nodes)
    if ptr.numel() != B * n_nodes + 1:
        raise ValueError(f"the CSR has {ptr.numel() - 1} nodes, not {B * n_nodes}")
    msgs = msgs.contiguous()
    mask = mask.to(torch.float32).contiguous()
    out = torch.empty((B, n_nodes, F), dtype=msgs.dtype, device=dev)
    fn = _lib_fn(f"edge_aggregate_{_SUFFIX[msgs.dtype]}", 5, 3)
    _run(fn, dev, ptr.data_ptr(), edges.data_ptr(), mask.data_ptr(), msgs.data_ptr(),
         out.data_ptr(), B * n_nodes, F, int(reduce == "mean"))
    LAUNCHES["edge_aggregate"] += 1
    return out
