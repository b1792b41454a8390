"""The MPNN message chains: CUDA kernels K1/K2 and their plain versions.

Counterpart of codlad_tpu/kernels/mpnn_kernels.py (forward only):

* `fused_message_sum` (K1): masked, K-summed chain -> f32 [B, L, H];
* `fused_message_edge_lnmod` (K2): per-edge chain + residual LayerNorm +
  adaLN modulate/gate -> [B, L, K, H] in the dtype of E.

On a CUDA tensor each wrapper launches its kernel from
`csrc/message_chain.cu` or raises; the plain version runs only for tensors
that lie on the CPU. The plain versions cast where the kernels cast (A and
Gn to E's dtype, gelu(pre) before W2, h2 (K2) or the K-sum (K1) before W3)
and accumulate in f32; in f32 they equal the JAX package's
`_ref_message_sum` / `_ref_message_edge_lnmod`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from codlad_tpu_torch.kernels import build

HIDDEN = 128  # the width the kernels are compiled for
# edge rows per block (16 row groups x rows per thread); K must divide it
_BLOCK_ROWS = {torch.bfloat16: 128, torch.float32: 64}

# kernel launches since the last reset, by wrapper name
LAUNCHES = {"fused_message_sum": 0, "fused_message_edge_lnmod": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def gather_rows(table, idx):
    """table [B, N, C], idx [B, M, K] -> [B, M, K, C]."""
    B, M, K = idx.shape
    flat = idx.reshape(B, M * K, 1).expand(-1, -1, table.shape[-1])
    return torch.gather(table, 1, flat).reshape(B, M, K, table.shape[-1])


def _chain_h2(A, E, Gn, idx, W_e, W2, b2):
    dt, f32 = E.dtype, torch.float32
    g = gather_rows(Gn.to(dt), idx.long()).to(f32)
    pre = A.to(dt).to(f32)[:, :, None] + E.to(f32) @ W_e.to(dt).to(f32) + g
    x2 = gelu_tanh(pre).to(dt).to(f32) @ W2.to(dt).to(f32) + b2.to(f32)
    return gelu_tanh(x2)


def ref_message_sum(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale):
    """Plain version of K1 -> f32 [B, L, H]."""
    dt, f32 = E.dtype, torch.float32
    h2 = _chain_h2(A, E, Gn, idx, W_e, W2, b2)
    maskf = mask.to(f32)
    s = (h2 * maskf[..., None]).sum(dim=2)
    out = s.to(dt).to(f32) @ W3.to(dt).to(f32) + maskf.sum(dim=2)[..., None] * b3.to(f32)
    return out / scale


def ref_message_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g,
                           eps=1e-6):
    """Plain version of K2 -> [B, L, K, H] in the dtype of E."""
    dt, f32 = E.dtype, torch.float32
    h2 = _chain_h2(A, E, Gn, idx, W_e, W2, b2)
    msg = h2.to(dt).to(f32) @ W3.to(dt).to(f32) + b3.to(f32)
    resid = E.to(f32) + msg
    mean = resid.mean(dim=-1, keepdim=True)
    var = ((resid - mean) ** 2).mean(dim=-1, keepdim=True)
    ln = (resid - mean) * torch.rsqrt(var + eps)
    sh, sc, g = (v.to(f32)[:, None, None, :] for v in (sh, sc, g))
    return (g * (ln * (1.0 + sc) + sh)).to(dt)


# ---------------------------------------------------------------------------
# kernel launch

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _fn(name, n_ptr, n_int, has_scale):
    lib = build.load("message_chain")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + ([ctypes.c_float] if has_scale else []) + [ctypes.c_void_p])
    return fn


def _operand(t, dtype, shape, name, device):
    """Contiguous, 16-byte aligned `dtype` copy of t, checked against shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, E on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    t = t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


def _check_edge(E, Gn):
    if E.device.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, not {E.device}")
    if E.dtype not in _SUFFIX:
        raise ValueError(f"E must be bfloat16 or float32, not {E.dtype}")
    if E.dim() != 4 or E.shape[-1] != HIDDEN:
        raise ValueError(f"E must be [B, L, K, {HIDDEN}], got {tuple(E.shape)}")
    B, L, K, H = E.shape
    rows = _BLOCK_ROWS[E.dtype]
    if rows % K or K % (rows // 16):
        raise ValueError(f"K={K} must divide {rows} and be a multiple of "
                         f"{rows // 16} for {E.dtype}")
    if Gn.dim() != 3 or Gn.shape[0] != B or Gn.shape[2] != H:
        raise ValueError(f"Gn must be [{B}, N, {H}], got {tuple(Gn.shape)}")
    return B, L, K, H, Gn.shape[1]


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")


def fused_message_sum(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale):
    """K1: masked, K-summed message chain -> f32 [B, L, H].

    A [B, L, H], E [B, L, K, H], Gn [B, N, H], idx [B, L, K] (into Gn),
    mask [B, L, K], W_e/W2/W3 [H, H] (in, out), b2/b3 [H]."""
    if E.device.type == "cpu":
        return ref_message_sum(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale)
    B, L, K, H, N = _check_edge(E, Gn)
    dt, dev, f32 = E.dtype, E.device, torch.float32
    ops = [_operand(A, dt, (B, L, H), "A", dev),
           _operand(E, dt, (B, L, K, H), "E", dev),
           _operand(Gn, dt, (B, N, H), "Gn", dev),
           _operand(idx, torch.int32, (B, L, K), "idx", dev),
           _operand(mask, f32, (B, L, K), "mask", dev),
           _operand(W_e, dt, (H, H), "W_e", dev),
           _operand(W2, dt, (H, H), "W2", dev),
           _operand(b2, f32, (H,), "b2", dev),
           _operand(W3, dt, (H, H), "W3", dev),
           _operand(b3, f32, (H,), "b3", dev)]
    out = torch.empty((B, L, H), dtype=f32, device=dev)
    fn = _fn(f"message_sum_{_SUFFIX[dt]}", 11, 4, True)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(fn, *[t.data_ptr() for t in ops], out.data_ptr(),
                B, L, K, N, float(scale), stream)
    LAUNCHES["fused_message_sum"] += 1
    return out


def fused_message_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g):
    """K2: edge chain + residual + LayerNorm (eps 1e-6, no affine) +
    g * (ln * (1 + sc) + sh) -> [B, L, K, H] in the dtype of E.
    sh, sc, g: [B, H]."""
    if E.device.type == "cpu":
        return ref_message_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3,
                                      sh, sc, g)
    B, L, K, H, N = _check_edge(E, Gn)
    dt, dev, f32 = E.dtype, E.device, torch.float32
    ops = [_operand(A, dt, (B, L, H), "A", dev),
           _operand(E, dt, (B, L, K, H), "E", dev),
           _operand(Gn, dt, (B, N, H), "Gn", dev),
           _operand(idx, torch.int32, (B, L, K), "idx", dev),
           _operand(W_e, dt, (H, H), "W_e", dev),
           _operand(W2, dt, (H, H), "W2", dev),
           _operand(b2, f32, (H,), "b2", dev),
           _operand(W3, dt, (H, H), "W3", dev),
           _operand(b3, f32, (H,), "b3", dev),
           _operand(sh, f32, (B, H), "sh", dev),
           _operand(sc, f32, (B, H), "sc", dev),
           _operand(g, f32, (B, H), "g", dev)]
    out = torch.empty((B, L, K, H), dtype=dt, device=dev)
    fn = _fn(f"message_edge_lnmod_{_SUFFIX[dt]}", 13, 4, False)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch(fn, *[t.data_ptr() for t in ops], out.data_ptr(),
                B, L, K, N, stream)
    LAUNCHES["fused_message_edge_lnmod"] += 1
    return out
