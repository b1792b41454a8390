"""K10, the fused tensor product, and K11, its backward: CUDA kernels and the
plain version.

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
from the plain version by the rounding of TR.

On a CUDA tensor `fused_tp` is a torch.autograd.Function whose backward is
K11 (`csrc/fused_tp_bwd.cu`, counterpart of `_pallas_fused_tp_bwd`): dx,
dsh and dw of every row from the same lists and two transposed ones (the q
of each weight, the nonzeros of each CBIG_R row), rounded as the Pallas
backward rounds (module docstring of the .cu file). The dsh store is
skipped when sh needs no grad (the encoder's sh come from coordinates). On
the CPU autograd differentiates the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from codlad_tpu_torch.kernels import build

LAUNCHES = {"fused_tp": 0, "fused_tp_bwd": 0}   # K10, K11 launches since the last reset
_TE = 32                     # edge rows per block (one a lane)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ref_fused_tp(x, sh, w, cbig_r, expw, sumr):
    """Plain version: x [..., din], sh [..., dsh], w [..., numel] and the
    dense tables (numpy or tensors) -> [..., dout] in x's dtype. Products
    accumulate in f32 (float64 for float64 operands: the card's checks hold
    the f32 kernels against this version run in float64)."""
    dt, dev = x.dtype, x.device
    f32 = torch.float64 if dt == torch.float64 else torch.float32
    tab = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dt).to(f32)
    sh, w = sh.to(dt), w.to(dt)
    t = torch.cat([x * sh[..., b:b + 1] for b in range(sh.shape[-1])], dim=-1)
    TR = (t.to(f32) @ tab(cbig_r)).to(dt)
    wR = (w.to(f32) @ tab(expw)).to(dt)
    return ((wR * TR).to(f32) @ tab(sumr)).to(dt)


def sparse_tables(tb):
    """The kernels' lists, from fused_tp_tables' dense ones. The R expansion
    columns are reordered by output column: positions q of column c are
    cptr[c] .. cptr[c+1]-1 (qcol[q] = c); position q reads weight widx[q]
    and the nonzeros rptr[q] .. rptr[q+1]-1 of its CBIG_R column (row into
    concat_b(x * sh[b]), split as row = rb * din + rf, and coefficient).
    Every nonzero is kept, however small, so the kernels compute exactly the
    dense form's sums. K11 also reads two transposed lists: the positions q
    of weight k, wq[wptr[k] .. wptr[k+1]-1] (EXPW^T), and the nonzeros of
    CBIG_R row j, (tq, tcoef)[tptr[j] .. tptr[j+1]-1] (CBIG_R^T), each in
    increasing q."""
    cbig_r, expw, sumr = tb["CBIG_R"], tb["EXPW"], tb["SUMR"]
    col = sumr.argmax(axis=1)                 # output column of each r
    order = np.argsort(col, kind="stable")
    cptr = np.concatenate([[0], np.cumsum(np.bincount(col, minlength=sumr.shape[1]))])
    widx = expw.argmax(axis=0)[order]
    nz = [np.nonzero(cbig_r[:, r])[0] for r in order]
    rptr = np.concatenate([[0], np.cumsum([len(z) for z in nz])])
    rows = np.concatenate(nz)
    coef = np.concatenate([cbig_r[z, r] for z, r in zip(nz, order)])
    qz = np.repeat(np.arange(len(order)), np.diff(rptr))   # the q of each nonzero
    tord = np.argsort(rows, kind="stable")
    wq = np.argsort(widx, kind="stable")
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    din = tb["din"]
    return {"cptr": i32(cptr), "qcol": i32(col[order]), "widx": i32(widx), "rptr": i32(rptr),
            "rows": i32(rows), "rb": i32(rows // din), "rf": i32(rows % din),
            "coef": f32(coef),
            "wptr": i32(np.concatenate([[0], np.cumsum(np.bincount(widx,
                                                                   minlength=tb["numel"]))])),
            "wq": i32(wq),
            "tptr": i32(np.concatenate([[0], np.cumsum(np.bincount(
                rows, minlength=cbig_r.shape[0]))])),
            "tq": i32(qz[tord]), "tcoef": f32(coef[tord]), "nnz": int(rows.size)}


_DEVICE_TABLES: dict = {}


def _device_tables(tb, device, dtype):
    """The sparse lists on `device`, coefficients rounded to `dtype` (as the
    Pallas kernel casts CBIG_R to x's dtype), cached by signature."""
    key = (tb["sig"], str(device), dtype)
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        sp = sparse_tables(tb)
        hit = {k: torch.as_tensor(v, device=device) for k, v in sp.items() if k != "nnz"}
        for k in ("coef", "tcoef"):
            hit[k] = hit[k].to(dtype).to(torch.float32)
        _DEVICE_TABLES[key] = hit
    return hit


def _check_operands(x, sh, w, tb):
    if x.dtype not in _SUFFIX:
        raise ValueError(f"x must be bfloat16 or float32, not {x.dtype}")
    din, dsh, numel = x.shape[-1], sh.shape[-1], w.shape[-1]
    if (din * dsh, numel) != (tb["CBIG_R"].shape[0], tb["numel"]):
        raise ValueError(f"operands (din {din}, dsh {dsh}, numel {numel}) do not match "
                         f"the tables {tb['sig']}")
    lead = x.shape[:-1]
    if sh.shape[:-1] != lead or w.shape[:-1] != lead:
        raise ValueError(f"row shapes differ: {tuple(x.shape)}, {tuple(sh.shape)}, "
                         f"{tuple(w.shape)}")
    for name, t in (("sh", sh), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch_fused_tp(x, sh, w, tb):
    din, dsh, numel = x.shape[-1], sh.shape[-1], w.shape[-1]
    dout = tb["SUMR"].shape[1]
    dev, dt = x.device, x.dtype
    M = x.numel() // din
    out = torch.empty(x.shape[:-1] + (dout,), dtype=dt, device=dev)
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


_BWD_TABLES = ("qcol", "widx", "rptr", "rb", "rf", "coef", "wptr", "wq", "tptr", "tq",
               "tcoef")


def fused_tp_bwd(x, sh, w, dct, tb, want_dsh=True):
    """K11: (dx, dsh, dw) of K10 at x, sh, w for the output cotangent dct
    [..., dout], each in x's dtype (dsh None when not `want_dsh`). CUDA
    tensors only: the plain backward is autograd of `ref_fused_tp`."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_tp_bwd runs on CUDA tensors, not {x.device}")
    _check_operands(x, sh, w, tb)
    din, dsh, numel = x.shape[-1], sh.shape[-1], w.shape[-1]
    dout = tb["SUMR"].shape[1]
    if dct.shape != x.shape[:-1] + (dout,) or dct.device != x.device:
        raise ValueError(f"dct {tuple(dct.shape)} on {dct.device} does not match the "
                         f"output {tuple(x.shape[:-1]) + (dout,)} on {x.device}")
    dev, dt = x.device, x.dtype
    x, sh, w, dct = (t.to(dt).contiguous() for t in (x, sh, w, dct))
    M = x.numel() // din
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    dsh_out = torch.empty_like(sh) if want_dsh else None
    tabs = _device_tables(tb, dev, dt)
    fn = getattr(build.load("fused_tp_bwd"), f"fused_tp_bwd_{_SUFFIX[dt]}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), sh.data_ptr(), w.data_ptr(), dct.data_ptr(),
                *(tabs[k].data_ptr() for k in _BWD_TABLES), dx.data_ptr(),
                None if dsh_out is None else dsh_out.data_ptr(), dw.data_ptr(), M, din, dsh,
                numel, dout, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_tp_bwd_{_SUFFIX[dt]} failed: cudaError {rc}")
    LAUNCHES["fused_tp_bwd"] += 1
    return dx, dsh_out, dw


class _FusedTP(torch.autograd.Function):
    """K10 forward, K11 backward."""

    @staticmethod
    def forward(ctx, x, sh, w, tb):
        ctx.save_for_backward(x, sh, w)
        ctx.tb = tb
        return _launch_fused_tp(x, sh, w, tb)

    @staticmethod
    def backward(ctx, dct):
        need = ctx.needs_input_grad
        if not any(need[:3]):
            return None, None, None, None
        x, sh, w = ctx.saved_tensors
        dx, dsh, dw = fused_tp_bwd(x, sh, w, dct, ctx.tb, want_dsh=need[1])
        return dx if need[0] else None, dsh, dw if need[2] else None, None


def fused_tp(x, sh, w, tb):
    """K10: x [..., din] (x) sh [..., dsh] with per-row weights w [..., numel]
    and the tables `tb` of fused_tp_tables -> [..., dout] in x's dtype; its
    backward on the card is K11."""
    if x.device.type == "cpu":
        return ref_fused_tp(x, sh, w, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
    _check_operands(x, sh, w, tb)
    dt = x.dtype
    return _FusedTP.apply(x.contiguous(), sh.to(dt).contiguous(), w.to(dt).contiguous(), tb)
