"""The MPNN message chains: CUDA kernels K1-K7 and their plain versions.

Counterpart of codlad_tpu/kernels/mpnn_kernels.py:

* `fused_message_sum` (K1): masked, K-summed chain -> f32 [B, L, H];
  backward K3;
* `fused_message_edge_lnmod` (K2): per-edge chain + residual LayerNorm +
  adaLN modulate/gate -> [B, L, K, H] in the dtype of E; backward K4;
* `fused_message_edge_lnmod_drop` / `fused_message_edge_lnmod_pdrop` (K5):
  K2 with dropout on the message, from an explicit keep mask or from
  per-sample int32 seeds (the mask is then a counter hash made inside the
  kernel, forward and backward, see `keep_bits`);
* `fused_message_edge` (K6): the raw per-edge messages h2 W3 + b3 ->
  [B, L, K, H] in the dtype of E (the adaLN `residual` encoder's edge
  chain); backward K6's own;
* `fused_edge_then_sum` (K7, forward only): K2 of one encoder layer chained
  into K1 of the next inside one kernel (`denoise(fuse_pairs=True)`).

On a CUDA tensor each wrapper is a `torch.autograd.Function` whose forward
launches K1, K2, K5's forward or K6 (`csrc/message_chain.cu`; in bf16 on
the tensor cores, K a multiple of 16, K5's forward on K2's kernel; in f32
on the tensor cores too, in 3xTF32 (`message_sum_f32_mma_kernel`,
`message_edge_lnmod_f32_mma_kernel`, K5's forward on K2's kernel, and K6
on K2's kernel with a raw epilogue, `message_edge_f32_mma_kernel`; K a
multiple of 4 up to 64)) and whose backward launches K3,
K4, K5's or K6's backward (`csrc/message_chain_bwd.cu`; in bf16 on the
tensor cores, main pass and weight grads, K a multiple of 16:
`message_sum_bwd_mma_kernel`, `message_edge_lnmod_bwd_mma_kernel`,
`message_edge_bwd_mma_kernel`; in f32 on the tensor cores in 3xTF32, two
passes each (`message_sum_bwd_f32_mma_kernel`,
`message_edge_lnmod_bwd_f32_mma_kernel` or `message_edge_bwd_f32_mma_kernel`,
then `data_grads_f32_mma_kernel`) and the weight-grad pass,
`wgrad_f32_mma_kernel`), or raises; K7 (on K2's and K1's tensor-core bodies
in either dtype, so its outputs are K2's kernel then K1's, bit for bit)
launches or raises. The
plain version
runs only for tensors that lie on the CPU, and autograd differentiates it. The plain versions cast where
the kernels cast (A and Gn to E's dtype, gelu(pre) before W2, h2 (K2, K6) or
the K-sum (K1) before W3) and accumulate in f32; in f32 they equal the JAX
package's `_ref_message_sum` / `_ref_message_edge_lnmod` / `_ref_message`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from codlad_tpu_torch.kernels import build

HIDDEN = 128  # the width the kernels are compiled for
# every kernel in f32 runs on the tensor cores in 3xTF32 on 16-row slabs of
# one residue (padded past K), with its staged weights and a slab's 64
# accumulators a lane sized for K <= 64, a multiple of 4
_F32_KMAX, _F32_KSTEP = 64, 4
# every kernel in bf16 (K1, K2 and K5's forward, K6, K7 and the backwards)
# runs on the tensor cores: 128 rows a block, a warp a 16-row slab of one
# residue, so K is a multiple of 16
_MMA_ROWS, _MMA_SLAB = 128, 16
_WGRAD_CHUNKS = 264  # row chunks of the weight-grad pass (two blocks an SM)

# kernel launches since the last reset, by kernel
LAUNCHES = {"fused_message_sum": 0,                  # K1
            "fused_message_edge_lnmod": 0,           # K2
            "fused_message_sum_bwd": 0,              # K3
            "fused_message_edge_lnmod_bwd": 0,       # K4
            "fused_message_edge_lnmod_drop": 0,      # K5 forward
            "fused_message_edge_lnmod_drop_bwd": 0,  # K5 backward
            "fused_message_edge": 0,                 # K6 forward
            "fused_message_edge_bwd": 0,             # K6 backward
            "fused_edge_then_sum": 0}                # K7


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


def _acc(E):
    """The plain versions' accumulation dtype: f32, or f64 for an f64 E (a
    reference without f32 rounding, for checking the f32 kernels)."""
    return torch.float64 if E.dtype == torch.float64 else torch.float32


def _chain_h2(A, E, Gn, idx, W_e, W2, b2):
    dt, f32 = E.dtype, _acc(E)
    # gathered after the upcast, so that autograd scatter-adds dGn in f32
    # as the kernel does (the values are those of Gn.to(dt))
    g = gather_rows(Gn.to(dt).to(f32), idx.long())
    pre = A.to(dt).to(f32)[:, :, None] + E.to(f32) @ W_e.to(dt).to(f32) + g
    x2 = gelu_tanh(pre).to(dt).to(f32) @ W2.to(dt).to(f32) + b2.to(f32)
    return gelu_tanh(x2)


def ref_message_sum(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale):
    """Plain version of K1 -> f32 [B, L, H]."""
    dt, f32 = E.dtype, _acc(E)
    h2 = _chain_h2(A, E, Gn, idx, W_e, W2, b2)
    maskf = mask.to(f32)
    s = (h2 * maskf[..., None]).sum(dim=2)
    out = s.to(dt).to(f32) @ W3.to(dt).to(f32) + maskf.sum(dim=2)[..., None] * b3.to(f32)
    return out / scale


def ref_message_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g,
                           eps=1e-6, keep=None):
    """Plain version of K2 (and, with `keep` [B, L, K, H] scales, of K5's
    forward) -> [B, L, K, H] in the dtype of E."""
    dt, f32 = E.dtype, _acc(E)
    h2 = _chain_h2(A, E, Gn, idx, W_e, W2, b2)
    msg = h2.to(dt).to(f32) @ W3.to(dt).to(f32) + b3.to(f32)
    if keep is not None:
        msg = msg * keep.to(f32)
    resid = E.to(f32) + msg
    mean = resid.mean(dim=-1, keepdim=True)
    var = ((resid - mean) ** 2).mean(dim=-1, keepdim=True)
    ln = (resid - mean) * torch.rsqrt(var + eps)
    sh, sc, g = (v.to(f32)[:, None, None, :] for v in (sh, sc, g))
    return (g * (ln * (1.0 + sc) + sh)).to(dt)


def ref_message_edge(A, E, Gn, idx, W_e, W2, b2, W3, b3):
    """Plain version of K6: gelu(gelu(A + E W_e + Gn[idx]) W2 + b2) W3 + b3
    -> [B, L, K, H] in the dtype of E."""
    dt, f32 = E.dtype, _acc(E)
    h2 = _chain_h2(A, E, Gn, idx, W_e, W2, b2)
    return (h2.to(dt).to(f32) @ W3.to(dt).to(f32) + b3.to(f32)).to(dt)


def ref_edge_then_sum(A_e, E, G_e, idx, W_e_e, W2_e, b2_e, W3_e, b3_e, sh, sc, gmod,
                      A_n, G_n, W_e_n, W2_n, b2_n, W3_n, b3_n, mask, scale):
    """Plain version of K7: K2's plain version, then K1's on its output ->
    (e2 [B, L, K, H] in the dtype of E, f32 [B, L, H])."""
    e2 = ref_message_edge_lnmod(A_e, E, G_e, idx, W_e_e, W2_e, b2_e, W3_e, b3_e, sh,
                                sc, gmod)
    return e2, ref_message_sum(A_n, e2, G_n, idx, mask, W_e_n, W2_n, b2_n, W3_n, b3_n,
                               scale)



# ---------------------------------------------------------------------------
# dropout bits: the counter hash of csrc/chain_common.cuh in int64 torch ops
# (every value stays in [0, 2^32); a 32 x 32-bit product is taken as two
# 32 x 16-bit ones so that nothing overflows int64)

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _lowbias32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keep_bits(seeds, n):
    """uint32 bits (as int64) [B, n] of element i < n of sample b, from the
    int32 seeds [B]: a pure function of (seeds[b], b, i), as in the kernels."""
    dev = seeds.device
    b = torch.arange(seeds.shape[0], dtype=torch.int64, device=dev)
    key = _lowbias32((seeds.to(torch.int64) & _M32)
                     ^ _lowbias32((b + 0x9E3779B9) & _M32))[:, None]
    i = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    return _lowbias32((_lowbias32(i ^ key) + key) & _M32)


def drop_threshold(p):
    """Keep iff bits >= floor(p * 2^32), as `_inkernel_keep` does."""
    return min(int(p * 2.0 ** 32), 2 ** 32 - 1)


def keep_scale(p):
    """1 / (1 - p) rounded to f32, the scale of a kept element."""
    return float(torch.tensor(1.0 / (1.0 - p), dtype=torch.float32))


def keep_scales(seeds, shape, p):
    """f32 keep scales [B, *shape] (0 or 1/(1-p)) for per-sample seeds."""
    n = 1
    for d in shape:
        n *= int(d)
    kept = keep_bits(seeds, n) >= drop_threshold(p)
    return (kept.to(torch.float32) * keep_scale(p)).reshape(seeds.shape[0], *shape)


def site_seeds(seed, site, batch, device):
    """Per-sample int32 dropout seeds [batch] for one dropout site of one
    forward pass: a pure function of (seed, site, sample), in [0, 2^31).

    `seed` may be (seed, row0): the rows are rows row0 .. row0 + batch - 1
    of a larger batch (a data-parallel rank's), and the seeds are rebased
    so that `keep_bits`, which hashes each seed with its LOCAL row b, gives
    the bits that row row0 + b of the whole batch gets: seed' = seed ^
    h(row0 + b) ^ h(b), h the row hash of keep_bits (any int32 then)."""
    seed, row0 = seed if isinstance(seed, tuple) else (seed, 0)
    key = _lowbias32((_lowbias32(int(seed) & _M32) + site) & _M32)  # Python ints
    b = torch.arange(batch, dtype=torch.int64)
    s = _lowbias32(key ^ (b + row0)) & 0x7FFFFFFF
    if row0:
        s = (s ^ _lowbias32((b + row0 + 0x9E3779B9) & _M32)
             ^ _lowbias32((b + 0x9E3779B9) & _M32))
        s = torch.where(s >= 2 ** 31, s - 2 ** 32, s)   # the same 32 bits as int32
    return s.to(torch.int32).to(device)


def plain_message_edge_lnmod_pdrop(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc,
                                   g, seeds, p):
    """Plain version of K5's seeded forward: K2's plain version with the
    generator's mask."""
    keep = keep_scales(seeds, E.shape[1:], p)
    return ref_message_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g,
                                  keep=keep)

# ---------------------------------------------------------------------------
# kernel launch

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_CTYPE = {"p": ctypes.c_void_p, "i": ctypes.c_int, "u": ctypes.c_uint,
          "f": ctypes.c_float}


def _fn(source, name, spec):
    """C entry `name` of csrc/<source>.cu; spec: one letter an argument
    (p pointer, i int, u unsigned, f float), the stream last."""
    fn = getattr(build.load(source), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [_CTYPE[c] for c in spec]
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


def check_neighbours(K, rows, per_thread):
    """Raise unless the kernels can take K neighbours a residue: K <= rows
    (the bf16 kernels' 128-row block owns floor(rows / K) whole residues;
    the f32 slab kernels are sized for K <= 64) and K a multiple of
    per_thread (16: a bf16 warp's slab holds rows of one residue; 4: the
    f32 slabs' step). The featurizer's K = min(64, L), L a multiple of 16,
    gives K in {16, 32, 48, 64}."""
    if K < 1 or K > rows or K % per_thread:
        raise ValueError(f"K={K} must be at most {rows} and a multiple of {per_thread}")


def _check_edge(E, Gn, rows=_F32_KMAX, per_thread=_F32_KSTEP):
    """(B, L, K, H, N) of an edge operand the kernels take; `rows` and
    `per_thread` give the K limits (default: the f32 slab kernels', K <=
    64, a multiple of 4)."""
    if E.device.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, not {E.device}")
    if E.dtype not in _SUFFIX:
        raise ValueError(f"E must be bfloat16 or float32, not {E.dtype}")
    if E.dim() != 4 or E.shape[-1] != HIDDEN:
        raise ValueError(f"E must be [B, L, K, {HIDDEN}], got {tuple(E.shape)}")
    B, L, K, H = E.shape
    check_neighbours(K, rows, per_thread)
    if Gn.dim() != 3 or Gn.shape[0] != B or Gn.shape[2] != H:
        raise ValueError(f"Gn must be [{B}, N, {H}], got {tuple(Gn.shape)}")
    return B, L, K, H, Gn.shape[1]


def _check_mma_edge(E, Gn):
    """_check_edge for the kernels, which run on the tensor cores in either
    dtype (K1, K2 and K5's forward, K6, K7 and the backwards K3, K4, K5's,
    K6's): K a multiple of 16 in bf16; in f32 the f32 slabs' K."""
    if E.dtype == torch.bfloat16:
        return _check_edge(E, Gn, _MMA_ROWS, _MMA_SLAB)
    return _check_edge(E, Gn)


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError {rc}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _chain_ops(A, E, Gn, idx, W_e, W2, b2, dims):
    """The chain's common operands in the kernels' dtypes."""
    B, L, K, H, N = dims
    dt, dev = E.dtype, E.device
    return [_operand(A, dt, (B, L, H), "A", dev),
            _operand(E, dt, (B, L, K, H), "E", dev),
            _operand(Gn, dt, (B, N, H), "Gn", dev),
            _operand(idx, torch.int32, (B, L, K), "idx", dev),
            _operand(W_e, dt, (H, H), "W_e", dev),
            _operand(W2, dt, (H, H), "W2", dev),
            _operand(b2, torch.float32, (H,), "b2", dev)]


def _message_sum_fwd(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale):
    dims = _check_mma_edge(E, Gn)
    B, L, K, H, N = dims
    dt, dev, f32 = E.dtype, E.device, torch.float32
    a, e, gn, ix, we, w2, bb2 = _chain_ops(A, E, Gn, idx, W_e, W2, b2, dims)
    ops = [a, e, gn, ix, _operand(mask, f32, (B, L, K), "mask", dev), we, w2, bb2,
           _operand(W3, dt, (H, H), "W3", dev), _operand(b3, f32, (H,), "b3", dev)]
    out = torch.empty((B, L, H), dtype=f32, device=dev)
    fn = _fn("message_chain", f"message_sum_{_SUFFIX[dt]}", "p" * 11 + "iiii" + "f" + "p")
    with torch.cuda.device(dev):
        _launch(fn, *[t.data_ptr() for t in ops], out.data_ptr(), B, L, K, N,
                float(scale), _stream(dev))
    LAUNCHES["fused_message_sum"] += 1
    return out


def _edge_lnmod_fwd(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, keep=None,
                    seeds=None, p=0.0, mask_out=False):
    """K2, or K5's forward when `keep` or `seeds` (with p > 0) is given.
    Returns (out, f32 keep scales or None).

    sh, sc and g go to the kernel in f32, as given; the Pallas wrapper
    rounds them to E's dtype first. The bf16 callers (`nn/mpnn.py`: the
    adaLN heads of a model cast to bf16, for sampling and for training)
    hand over bf16 tensors, so the two agree there."""
    drop = keep is not None or seeds is not None
    dims = _check_mma_edge(E, Gn)
    B, L, K, H, N = dims
    dt, dev, f32 = E.dtype, E.device, torch.float32
    ops = _chain_ops(A, E, Gn, idx, W_e, W2, b2, dims) + [
        _operand(W3, dt, (H, H), "W3", dev), _operand(b3, f32, (H,), "b3", dev),
        _operand(sh, f32, (B, H), "sh", dev), _operand(sc, f32, (B, H), "sc", dev),
        _operand(g, f32, (B, H), "g", dev)]
    out = torch.empty((B, L, K, H), dtype=dt, device=dev)
    with torch.cuda.device(dev):
        if not drop:
            fn = _fn("message_chain", f"message_edge_lnmod_{_SUFFIX[dt]}",
                     "p" * 13 + "iiii" + "p")
            _launch(fn, *[t.data_ptr() for t in ops], out.data_ptr(), B, L, K, N,
                    _stream(dev))
            LAUNCHES["fused_message_edge_lnmod"] += 1
            return out, None
        if keep is not None:
            keep = _operand(keep, dt, (B, L, K, H), "keep", dev)
        if seeds is not None:
            seeds = _operand(seeds, torch.int32, (B,), "seeds", dev)
        mo = (torch.empty((B, L, K, H), dtype=f32, device=dev)
              if mask_out and seeds is not None else None)
        fn = _fn("message_chain", f"message_edge_lnmod_drop_{_SUFFIX[dt]}",
                 "p" * 16 + "iiii" + "uf" + "p")
        _launch(fn, *[t.data_ptr() for t in ops], _ptr(keep), _ptr(seeds), _ptr(mo),
                out.data_ptr(), B, L, K, N, drop_threshold(p) if seeds is not None else 0,
                keep_scale(p) if seeds is not None else 1.0, _stream(dev))
    LAUNCHES["fused_message_edge_lnmod_drop"] += 1
    return out, mo


def _message_edge_fwd(A, E, Gn, idx, W_e, W2, b2, W3, b3):
    """K6 -> [B, L, K, H] in the dtype of E."""
    dims = _check_mma_edge(E, Gn)
    B, L, K, H, N = dims
    dt, dev = E.dtype, E.device
    ops = _chain_ops(A, E, Gn, idx, W_e, W2, b2, dims) + [
        _operand(W3, dt, (H, H), "W3", dev),
        _operand(b3, torch.float32, (H,), "b3", dev)]
    out = torch.empty((B, L, K, H), dtype=dt, device=dev)
    fn = _fn("message_chain", f"message_edge_{_SUFFIX[dt]}", "p" * 10 + "iiii" + "p")
    with torch.cuda.device(dev):
        _launch(fn, *[t.data_ptr() for t in ops], out.data_ptr(), B, L, K, N, _stream(dev))
    LAUNCHES["fused_message_edge"] += 1
    return out


def _edge_then_sum_fwd(A_e, E, G_e, idx, W_e_e, W2_e, b2_e, W3_e, b3_e, sh, sc, gmod,
                       A_n, G_n, W_e_n, W2_n, b2_n, W3_n, b3_n, mask, scale):
    """K7 -> (e2 [B, L, K, H] in the dtype of E, f32 [B, L, H] / scale)."""
    dims = _check_mma_edge(E, G_e)
    B, L, K, H, N = dims
    dt, dev, f32 = E.dtype, E.device, torch.float32
    ops = _chain_ops(A_e, E, G_e, idx, W_e_e, W2_e, b2_e, dims) + [
        _operand(W3_e, dt, (H, H), "W3_e", dev), _operand(b3_e, f32, (H,), "b3_e", dev),
        _operand(sh, f32, (B, H), "sh", dev), _operand(sc, f32, (B, H), "sc", dev),
        _operand(gmod, f32, (B, H), "gmod", dev),
        _operand(A_n, dt, (B, L, H), "A_n", dev), _operand(G_n, dt, (B, N, H), "G_n", dev),
        _operand(W_e_n, dt, (H, H), "W_e_n", dev), _operand(W2_n, dt, (H, H), "W2_n", dev),
        _operand(b2_n, f32, (H,), "b2_n", dev), _operand(W3_n, dt, (H, H), "W3_n", dev),
        _operand(b3_n, f32, (H,), "b3_n", dev), _operand(mask, f32, (B, L, K), "mask", dev)]
    e2 = torch.empty((B, L, K, H), dtype=dt, device=dev)
    ns = torch.empty((B, L, H), dtype=f32, device=dev)
    fn = _fn("message_chain", f"edge_then_sum_{_SUFFIX[dt]}", "p" * 22 + "iiii" + "f" + "p")
    with torch.cuda.device(dev):
        _launch(fn, *[t.data_ptr() for t in ops], e2.data_ptr(), ns.data_ptr(), B, L, K, N,
                float(scale), _stream(dev))
    LAUNCHES["fused_edge_then_sum"] += 1
    return e2, ns


def _bwd_scratch(B, L, K, H, dt, dev, edge_rows, tile_rows):
    """Scratch of the backward kernels (see csrc/message_chain_bwd.cu):
    `tile_rows` edge rows a block of the main pass, or a residue's K for the
    f32 tensor-core passes, whose column sums have a part a residue."""
    f32 = torch.float32
    rows = B * L * K
    TL = tile_rows // K
    n_tiles = B * (-(-L // TL))
    e = lambda m: torch.empty((m, H), dtype=dt, device=dev)
    return dict(s_h1=e(rows), s_dx2=e(rows), s_dpre=e(rows), s_h2=e(edge_rows),
                wpart=torch.empty((3, _WGRAD_CHUNKS, H, H), dtype=f32, device=dev),
                p_db=torch.empty((2, n_tiles, H), dtype=f32, device=dev),
                p_mod=torch.empty((3, n_tiles, H), dtype=f32, device=dev),
                n_tiles=n_tiles)


def _f32_rows(dims, dev):
    """An f32 [B L K, H] array: scratch of the values that the backwards
    park between their phases (gelu'(pre), gelu'(x2), dresid)."""
    B, L, K, H, _ = dims
    return torch.empty((B * L * K, H), dtype=torch.float32, device=dev)


def message_sum_bwd(A, E, Gn, idx, mask, W_e, W2, b2, W3, dout):
    """K3: the backward of K1 given dout (f32 [B, L, H], already divided by
    scale). Returns the kernel's outputs, as `_pallas_sum_bwd` does:
    dA f32 [B, L, H], dE [B, L, K, H] in E's dtype, dGn f32 [B, N, H],
    dW_e, dW2 f32 [H, H], db2 f32 [H], dW3 f32 [H, H], db3 f32 [H]. On the
    tensor cores, main pass and weight grads: in bf16
    (`message_sum_bwd_mma_kernel`, K a multiple of 16) with W_e, W2 and W3
    as they are; in f32 in 3xTF32 (`message_sum_bwd_f32_mma_kernel` then
    `data_grads_f32_mma_kernel`, K a multiple of 4 up to 64) with their
    transposes beside them."""
    bf = E.dtype == torch.bfloat16
    dims = _check_mma_edge(E, Gn)
    B, L, K, H, N = dims
    dt, dev, f32 = E.dtype, E.device, torch.float32
    a, e, gn, ix, we, w2, bb2 = _chain_ops(A, E, Gn, idx, W_e, W2, b2, dims)
    w3 = _operand(W3, dt, (H, H), "W3", dev)
    mk = _operand(mask, f32, (B, L, K), "mask", dev)
    ops = ([a, e, gn, ix, mk, we, w2, bb2, w3] if bf else
           [a, e, gn, ix, mk, we, we.t().contiguous(), w2, w2.t().contiguous(), bb2,
            w3.t().contiguous()])
    ops.append(_operand(dout, f32, (B, L, H), "dout", dev))
    dA = torch.empty((B, L, H), dtype=f32, device=dev)
    dE = torch.empty((B, L, K, H), dtype=dt, device=dev)
    dGn = torch.zeros((B, N, H), dtype=f32, device=dev)
    dW = torch.empty((3, H, H), dtype=f32, device=dev)
    db = torch.empty((2, H), dtype=f32, device=dev)
    s = _bwd_scratch(B, L, K, H, dt, dev, B * L, _MMA_ROWS if bf else K)
    # gelu'(pre) parked in f32 between the phases (bf16) or passes (f32); s
    # in s_h2; the bf16 kernel's cast(dout) beside it (f32: dout itself)
    scratch = ([s["s_h1"], s["s_dx2"], s["s_dpre"], _f32_rows(dims, dev), s["s_h2"]]
               + ([torch.empty_like(s["s_h2"])] if bf else []) + [s["wpart"], s["p_db"]])
    fn = _fn("message_chain_bwd", f"message_sum_bwd_{_SUFFIX[dt]}",
             "p" * (len(ops) + len(scratch) + 5) + "i" * 6 + "p")
    with torch.cuda.device(dev):
        _launch(fn, *[t.data_ptr() for t in ops], dA.data_ptr(), dE.data_ptr(),
                dGn.data_ptr(), *[t.data_ptr() for t in scratch],
                dW.data_ptr(), db.data_ptr(), B, L, K, N, s["n_tiles"], _WGRAD_CHUNKS,
                _stream(dev))
    LAUNCHES["fused_message_sum_bwd"] += 1
    return dA, dE, dGn, dW[0], dW[1], db[0], dW[2], db[1]


def _edge_bwd_setup(A, E, Gn, idx, W_e, W2, b2, W3):
    """(dims, the chain's operands and W3 in the kernels' dtypes, whether
    bf16, the outputs dA, dE, dGn, dW, db, the scratch) of K4's, K5's and
    K6's backwards, on the tensor cores: in bf16 blocks of 128 edge rows (K
    a multiple of 16); in f32 a column-sum part a residue."""
    bf = E.dtype == torch.bfloat16
    dims = _check_mma_edge(E, Gn)
    B, L, K, H, N = dims
    dt, dev, f32 = E.dtype, E.device, torch.float32
    ops = _chain_ops(A, E, Gn, idx, W_e, W2, b2, dims) + [_operand(W3, dt, (H, H), "W3", dev)]
    outs = (torch.empty((B, L, H), dtype=f32, device=dev),
            torch.empty((B, L, K, H), dtype=dt, device=dev),
            torch.zeros((B, N, H), dtype=f32, device=dev),
            torch.empty((3, H, H), dtype=f32, device=dev),
            torch.empty((2, H), dtype=f32, device=dev))
    s = _bwd_scratch(B, L, K, H, dt, dev, B * L * K, _MMA_ROWS if bf else K)
    return dims, ops, bf, outs, s


def message_edge_lnmod_bwd(A, E, Gn, idx, W_e, W2, b2, W3, b3, sc, g, dout,
                           keep=None, seeds=None, p=0.0):
    """K4 (or K5's backward with `keep` or `seeds`): the backward of K2
    given dout [B, L, K, H]. Returns the kernel's outputs, as
    `_pallas_edge_lnmod_bwd` does: K3's eight, then dsh, dsc and dgate f32
    [B, H] (dgate without its sh * sum(dout) term). On the tensor cores: in
    bf16 (`message_edge_lnmod_bwd_mma_kernel`, K a multiple of 16) with W_e,
    W2 and W3 as they are; in f32 in 3xTF32
    (`message_edge_lnmod_bwd_f32_mma_kernel` then
    `data_grads_f32_mma_kernel`, K a multiple of 4 up to 64) with their
    transposes beside them."""
    dims, ops, bf, (dA, dE, dGn, dW, db), s = _edge_bwd_setup(A, E, Gn, idx, W_e, W2, b2, W3)
    B, L, K, H, N = dims
    dt, dev, f32 = E.dtype, E.device, torch.float32
    a, e, gn, ix, we, w2, bb2, w3 = ops
    mod = [_operand(b3, f32, (H,), "b3", dev), _operand(sc, f32, (B, H), "sc", dev),
           _operand(g, f32, (B, H), "g", dev)]
    ops = ([a, e, gn, ix, we, w2, bb2, w3] if bf else
           [a, e, gn, ix, we, we.t().contiguous(), w2, w2.t().contiguous(), bb2, w3,
            w3.t().contiguous()]) + mod
    if keep is not None:
        keep = _operand(keep, dt, (B, L, K, H), "keep", dev)
    if seeds is not None:
        seeds = _operand(seeds, torch.int32, (B,), "seeds", dev)
    dout = _operand(dout, dt, (B, L, K, H), "dout", dev)
    dmod = torch.empty((3, B, H), dtype=f32, device=dev)
    # gelu'(pre), gelu'(x2) and dresid parked in f32
    parked = [_f32_rows(dims, dev) for _ in range(3)]
    scratch = ([s[k] for k in ("s_h1", "s_dx2", "s_dpre", "s_h2")]
               + [torch.empty_like(s["s_h2"])] + parked                  # dmsg
               + [s[k] for k in ("wpart", "p_db", "p_mod")])
    fn = _fn("message_chain_bwd", f"message_edge_lnmod_bwd_{_SUFFIX[dt]}",
             "p" * (len(ops) + len(scratch) + 9) + "i" * 6 + "uf" + "p")
    with torch.cuda.device(dev):
        _launch(fn, *[t.data_ptr() for t in ops], _ptr(keep), _ptr(seeds), dout.data_ptr(),
                dA.data_ptr(), dE.data_ptr(), dGn.data_ptr(),
                *[t.data_ptr() for t in scratch],
                dW.data_ptr(), db.data_ptr(), dmod.data_ptr(), B, L, K, N, s["n_tiles"],
                _WGRAD_CHUNKS, drop_threshold(p) if seeds is not None else 0,
                keep_scale(p) if seeds is not None else 1.0, _stream(dev))
    drop = keep is not None or seeds is not None
    LAUNCHES["fused_message_edge_lnmod_drop_bwd" if drop
             else "fused_message_edge_lnmod_bwd"] += 1
    return dA, dE, dGn, dW[0], dW[1], db[0], dW[2], db[1], dmod[0], dmod[1], dmod[2]


def message_edge_bwd(A, E, Gn, idx, W_e, W2, b2, W3, dout):
    """K6's backward given dout [B, L, K, H] (E's dtype). Returns the
    kernel's outputs, as `_pallas_edge_bwd` does: K3's eight. On the tensor
    cores: in bf16 (`message_edge_bwd_mma_kernel`, K a multiple of 16) with
    W_e, W2 and W3 as they are; in f32 in 3xTF32
    (`message_edge_bwd_f32_mma_kernel` then `data_grads_f32_mma_kernel`, K a
    multiple of 4 up to 64) with their transposes beside them. dout itself
    is dW3's Y."""
    dims, ops, bf, (dA, dE, dGn, dW, db), s = _edge_bwd_setup(A, E, Gn, idx, W_e, W2, b2, W3)
    B, L, K, H, N = dims
    dt, dev = E.dtype, E.device
    a, e, gn, ix, we, w2, bb2, w3 = ops
    ops = ([a, e, gn, ix, we, w2, bb2, w3] if bf else
           [a, e, gn, ix, we, we.t().contiguous(), w2, w2.t().contiguous(), bb2,
            w3.t().contiguous()])
    ops.append(_operand(dout, dt, (B, L, K, H), "dout", dev))
    # gelu'(pre) parked in f32
    scratch = ([s[k] for k in ("s_h1", "s_dx2", "s_dpre", "s_h2")] + [_f32_rows(dims, dev)]
               + [s["wpart"], s["p_db"]])
    fn = _fn("message_chain_bwd", f"message_edge_bwd_{_SUFFIX[dt]}",
             "p" * (len(ops) + len(scratch) + 5) + "i" * 6 + "p")
    with torch.cuda.device(dev):
        _launch(fn, *[t.data_ptr() for t in ops], dA.data_ptr(), dE.data_ptr(),
                dGn.data_ptr(), *[t.data_ptr() for t in scratch],
                dW.data_ptr(), db.data_ptr(), B, L, K, N, s["n_tiles"], _WGRAD_CHUNKS,
                _stream(dev))
    LAUNCHES["fused_message_edge_bwd"] += 1
    return dA, dE, dGn, dW[0], dW[1], db[0], dW[2], db[1]


# ---------------------------------------------------------------------------
# autograd: forward kernel, backward kernel; grads in the JAX VJP's dtypes


def _cast_like(d, x):
    return None if x is None else d.to(x.dtype)


class _MessageSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale):
        ctx.save_for_backward(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3)
        ctx.scale = scale
        return _message_sum_fwd(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale)

    @staticmethod
    def backward(ctx, g):
        A, E, Gn, idx, mask, W_e, W2, b2, W3, b3 = ctx.saved_tensors
        dA, dE, dGn, dWe, dW2, db2, dW3, db3 = message_sum_bwd(
            A, E, Gn, idx, mask, W_e, W2, b2, W3, g.to(torch.float32) / ctx.scale)
        return (_cast_like(dA, A), _cast_like(dE, E), _cast_like(dGn, Gn), None, None,
                _cast_like(dWe, W_e), _cast_like(dW2, W2), _cast_like(db2, b2),
                _cast_like(dW3, W3), _cast_like(db3, b3), None)


class _EdgeLnmod(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, keep, seeds, p):
        ctx.save_for_backward(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, keep, seeds)
        ctx.p = p
        return _edge_lnmod_fwd(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, keep,
                               seeds, p)[0]

    @staticmethod
    def backward(ctx, ct):
        A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, keep, seeds = ctx.saved_tensors
        (dA, dE, dGn, dWe, dW2, db2, dW3, db3, dsh, dsc, dg) = message_edge_lnmod_bwd(
            A, E, Gn, idx, W_e, W2, b2, W3, b3, sc, g, ct, keep, seeds, ctx.p)
        # the kernel's dgate lacks sh * sum(dct) (`_edge_lnmod_bwd`, :1186-1187)
        dg = dg + sh.to(torch.float32) * ct.to(torch.float32).sum(dim=(1, 2))
        return (_cast_like(dA, A), _cast_like(dE, E), _cast_like(dGn, Gn), None,
                _cast_like(dWe, W_e), _cast_like(dW2, W2), _cast_like(db2, b2),
                _cast_like(dW3, W3), _cast_like(db3, b3), _cast_like(dsh, sh),
                _cast_like(dsc, sc), _cast_like(dg, g), None, None, None)


class _MessageEdge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, E, Gn, idx, W_e, W2, b2, W3, b3):
        ctx.save_for_backward(A, E, Gn, idx, W_e, W2, b2, W3, b3)
        return _message_edge_fwd(A, E, Gn, idx, W_e, W2, b2, W3, b3)

    @staticmethod
    def backward(ctx, ct):
        A, E, Gn, idx, W_e, W2, b2, W3, b3 = ctx.saved_tensors
        dA, dE, dGn, dWe, dW2, db2, dW3, db3 = message_edge_bwd(A, E, Gn, idx, W_e, W2, b2,
                                                                W3, ct)
        return (_cast_like(dA, A), _cast_like(dE, E), _cast_like(dGn, Gn), None,
                _cast_like(dWe, W_e), _cast_like(dW2, W2), _cast_like(db2, b2),
                _cast_like(dW3, W3), _cast_like(db3, b3))


def fused_message_sum(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale):
    """K1: masked, K-summed message chain -> f32 [B, L, H]; backward K3.

    A [B, L, H], E [B, L, K, H], Gn [B, N, H], idx [B, L, K] (into Gn),
    mask [B, L, K], W_e/W2/W3 [H, H] (in, out), b2/b3 [H]."""
    if E.device.type == "cpu":
        return ref_message_sum(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale)
    return _MessageSum.apply(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale)


def fused_message_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g):
    """K2: edge chain + residual + LayerNorm (eps 1e-6, no affine) +
    g * (ln * (1 + sc) + sh) -> [B, L, K, H] in the dtype of E; backward K4.
    sh, sc, g: [B, H]."""
    if E.device.type == "cpu":
        return ref_message_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g)
    return _EdgeLnmod.apply(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, None, None,
                            0.0)


def fused_message_edge_lnmod_drop(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g,
                                  keep):
    """K5 with an explicit mask: g * modulate(LN(E + keep * msg), sh, sc),
    keep [B, L, K, H] holding 0 / 1/(1-p) scales (used in E's dtype, as on
    the TPU). keep gets no gradient."""
    if E.device.type == "cpu":
        return ref_message_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g,
                                      keep=keep.to(E.dtype))
    return _EdgeLnmod.apply(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, keep, None,
                            0.0)


def fused_message_edge_lnmod_pdrop(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g,
                                   seeds, p):
    """K5 with the mask made from int32 `seeds` [B] and a static rate p
    (`keep_bits`): no mask exists outside the kernels, and the backward
    regenerates it. p <= 0 falls through to K2."""
    p = float(p)
    if p <= 0.0:
        return fused_message_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g)
    if E.device.type == "cpu":
        return plain_message_edge_lnmod_pdrop(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh,
                                              sc, g, seeds, p)
    return _EdgeLnmod.apply(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, None, seeds, p)


def edge_lnmod_pdrop_debug(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, seeds, p):
    """(out, f32 keep scales) of K5's seeded forward, for validation: on the
    card the mask the kernel generated, on the CPU the plain generator's."""
    if E.device.type == "cpu":
        keep = keep_scales(seeds, E.shape[1:], float(p))
        return ref_message_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g,
                                      keep=keep), keep
    return _edge_lnmod_fwd(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, seeds=seeds,
                           p=float(p), mask_out=True)


def fused_message_edge(A, E, Gn, idx, W_e, W2, b2, W3, b3):
    """K6: the raw per-edge messages gelu(gelu(A + E W_e + Gn[idx]) W2 + b2)
    W3 + b3 -> [B, L, K, H] in the dtype of E, with no sum, residual or
    LayerNorm; backward K6's own. Grads in the dtypes of their operands, as
    the JAX VJP's `_cast_like`."""
    if E.device.type == "cpu":
        return ref_message_edge(A, E, Gn, idx, W_e, W2, b2, W3, b3)
    return _MessageEdge.apply(A, E, Gn, idx, W_e, W2, b2, W3, b3)


def fused_edge_then_sum(A_e, E, G_e, idx, W_e_e, W2_e, b2_e, W3_e, b3_e, sh, sc, gmod,
                        A_n, G_n, W_e_n, W2_n, b2_n, W3_n, b3_n, mask, scale):
    """K7, forward only: e2 = K2 of (A_e, E, G_e, the edge weights, sh, sc,
    gmod), then the masked node sum K1 of (A_n, e2, G_n, the node weights,
    mask, scale) in one kernel -> (e2 [B, L, K, H] in the dtype of E, f32
    [B, L, H]). e2 is cast to E's dtype before the node chain reads it, as
    where it would pass through device memory. There is no backward: raises
    if any input requires grad (sampling only, as the JAX kernel)."""
    args = (A_e, E, G_e, idx, W_e_e, W2_e, b2_e, W3_e, b3_e, sh, sc, gmod, A_n, G_n,
            W_e_n, W2_n, b2_n, W3_n, b3_n, mask)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise RuntimeError("fused_edge_then_sum has no backward; call it under "
                           "torch.no_grad() or with inputs that need no grad")
    if E.device.type == "cpu":
        return ref_edge_then_sum(*args, scale)
    return _edge_then_sum_fwd(*args, scale)
