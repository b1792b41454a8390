"""K10, the fused tensor product: CUDA kernel and its plain version.

Counterpart of `fused_tp` in codlad_tpu/kernels/tp_kernels.py (Pallas
`_pallas_fused_tp`). With the tables of nn/tensor_product.fused_tp_tables:

    TR = concat_b(x * sh[b]) @ CBIG_R;  wR = w @ EXPW;  out = (wR * TR) @ SUMR

over rows of x [..., din], sh [..., dsh], w [..., numel] (edge operands
[B, E, *] and the cross graph's [B, L, 14, *] alike: every leading dim is a
row) -> [..., dout] in x's dtype.

On a CUDA tensor `fused_tp` launches `csrc/fused_tp.cu` or raises; the plain
version `ref_fused_tp` (the dense-table form of the JAX `ref_fused_tp`:
TR and wR cast to x's dtype before their product) runs only for tensors on
the CPU. The kernel computes the same function from the tables' nonzeros
(CBIG_R at layer 2 alone is 871 KB in f32, more than a block's shared
memory; EXPW and SUMR are 0/1 selections) and rounds as the Pallas kernel
does: x * sh[b] and CBIG_R in x's dtype, TR and wR in f32, their product
cast to x's dtype, the output summed in f32 and cast. So in bf16 it differs
from the plain version by the rounding of TR. Forward only: the backward
(K11) comes with Stage-1 training, and the kernel raises if autograd would
need it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from codlad_tpu_torch.kernels import build

LAUNCHES = {"fused_tp": 0}   # K10 launches since the last reset
_TE = 32                     # edge rows per block (one a lane)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def reset_launches():
    LAUNCHES["fused_tp"] = 0


def ref_fused_tp(x, sh, w, cbig_r, expw, sumr):
    """Plain version: x [..., din], sh [..., dsh], w [..., numel] and the
    dense tables (numpy or tensors) -> [..., dout] in x's dtype."""
    dt, f32, dev = x.dtype, torch.float32, x.device
    tab = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dt).to(f32)
    sh, w = sh.to(dt), w.to(dt)
    t = torch.cat([x * sh[..., b:b + 1] for b in range(sh.shape[-1])], dim=-1)
    TR = (t.to(f32) @ tab(cbig_r)).to(dt)
    wR = (w.to(f32) @ tab(expw)).to(dt)
    return ((wR * TR).to(f32) @ tab(sumr)).to(dt)


def sparse_tables(tb):
    """The kernel's lists, from fused_tp_tables' dense ones. The R expansion
    columns are reordered by output column: positions q of column c are
    cptr[c] .. cptr[c+1]-1; position q reads weight widx[q] and the
    nonzeros rptr[q] .. rptr[q+1]-1 of its CBIG_R column (row into
    concat_b(x * sh[b]), coefficient). Every nonzero is kept, however
    small, so the kernel computes exactly the dense form's sum."""
    cbig_r, expw, sumr = tb["CBIG_R"], tb["EXPW"], tb["SUMR"]
    col = sumr.argmax(axis=1)                 # output column of each r
    order = np.argsort(col, kind="stable")
    cptr = np.concatenate([[0], np.cumsum(np.bincount(col, minlength=sumr.shape[1]))])
    widx = expw.argmax(axis=0)[order]
    nz = [np.nonzero(cbig_r[:, r])[0] for r in order]
    rptr = np.concatenate([[0], np.cumsum([len(z) for z in nz])])
    rows = np.concatenate(nz)
    coef = np.concatenate([cbig_r[z, r] for z, r in zip(nz, order)])
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return {"cptr": i32(cptr), "widx": i32(widx), "rptr": i32(rptr), "rows": i32(rows),
            "coef": np.ascontiguousarray(coef, np.float32), "nnz": int(rows.size)}


_DEVICE_TABLES: dict = {}


def _device_tables(tb, device, dtype):
    """The sparse lists on `device`, coefficients rounded to `dtype` (as the
    Pallas kernel casts CBIG_R to x's dtype), cached by signature."""
    key = (tb["sig"], str(device), dtype)
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        sp = sparse_tables(tb)
        hit = {k: torch.as_tensor(v, device=device) for k, v in sp.items() if k != "nnz"}
        hit["coef"] = hit["coef"].to(dtype).to(torch.float32)
        _DEVICE_TABLES[key] = hit
    return hit


def _launch_fused_tp(x, sh, w, tb):
    if x.dtype not in _SUFFIX:
        raise ValueError(f"x must be bfloat16 or float32, not {x.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, sh, w)):
        raise RuntimeError("fused_tp has no backward kernel yet (K11); call it under "
                           "torch.no_grad()")
    din, dsh, numel = x.shape[-1], sh.shape[-1], w.shape[-1]
    dout = tb["SUMR"].shape[1]
    if (din * dsh, numel) != (tb["CBIG_R"].shape[0], tb["numel"]):
        raise ValueError(f"operands (din {din}, dsh {dsh}, numel {numel}) do not match "
                         f"the tables {tb['sig']}")
    lead = x.shape[:-1]
    if sh.shape[:-1] != lead or w.shape[:-1] != lead:
        raise ValueError(f"row shapes differ: {tuple(x.shape)}, {tuple(sh.shape)}, "
                         f"{tuple(w.shape)}")
    dev, dt = x.device, x.dtype
    for name, t in (("sh", sh), ("w", w)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    x, sh, w = (t.to(dt).contiguous() for t in (x, sh, w))
    M = x.numel() // din
    out = torch.empty(lead + (dout,), dtype=dt, device=dev)
    tabs = _device_tables(tb, dev, dt)
    fn = getattr(build.load("fused_tp"), f"fused_tp_{_SUFFIX[dt]}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), sh.data_ptr(), w.data_ptr(), tabs["cptr"].data_ptr(),
                tabs["widx"].data_ptr(), tabs["rptr"].data_ptr(), tabs["rows"].data_ptr(),
                tabs["coef"].data_ptr(), out.data_ptr(), M, din, dsh, numel, dout,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_tp_{_SUFFIX[dt]} failed: cudaError {rc}")
    LAUNCHES["fused_tp"] += 1
    return out


def fused_tp(x, sh, w, tb):
    """K10: x [..., din] (x) sh [..., dsh] with per-row weights w [..., numel]
    and the tables `tb` of fused_tp_tables -> [..., dout] in x's dtype."""
    if x.device.type == "cpu":
        return ref_fused_tp(x, sh, w, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
    return _launch_fused_tp(x, sh, w, tb)
