"""The f32 tensor-core backwards K3, K4 / K5's and K6's (3xTF32), on the CPU.

csrc/message_chain_bwd.cu runs the f32 K3, K4 / K5's and K6's backward in two
passes, each a persistent block of 8 warps, a warp a residue's 16-row slabs
in order (K a multiple of 4 up to 64: rows past K in a residue's last slab
are padding), every product on mma.sync m16n8k8 in 3xTF32 (the split and
`mma3` of tests/test_torch_chain_tiles_f32.py):

* pass 1 (`message_sum_bwd_f32_mma_kernel`,
  `message_edge_lnmod_bwd_f32_mma_kernel<DROP>`) with the forward's weights:
  pre = A + Gn[idx] + E W_e (unit order), h1 = gelu(pre) and gelu'(pre)
  parked, x2 = h1 W2, h2 = gelu(x2 + b2), gelu'(x2) from the same exp;
  K3: ds = dout W3^T per residue (CUDA cores, j in order), s = mask h2
  summed, dx2 = (ds mask) gelu'(x2); K4: msg = h2 W3, resid = E + (msg +
  b3) x keep, the LayerNorm and its backward with K2's row sums (a lane's
  columns in order, then the quad), dresid = rstd ((dln - m1) - ln m2),
  dmsg = dresid x keep; K6 (`message_edge_bwd_f32_mma_kernel`): dmsg is
  the cotangent, with no W3 product and no LayerNorm;
* pass 2 (`data_grads_f32_mma_kernel`) with the transposed weights: K4's
  and K6's dh2 = dmsg W3^T and dx2 = dh2 gelu'(x2) (K6's, in one of its
  forms, in pass 1: the same operands and order); dh1 = dx2 W2^T in pre's unit
  order (W2^T's columns through unit()), dpre = dh1 gelu'(pre), dE = dpre
  W_e^T (W_e^T's rows through unit()) [+ dresid];
* the column sums (s, db2, db3, dsh, dsc, dgate, dA): rows g and g + 8 of a
  slab, the butterfly over g, the residue's slabs in order, then
  `sum_partials` over the residues (dsh, dsc, dgate: each sample's);
* the weight grads (`wgrad_f32_mma_kernel`): dW_e = E^T dpre, dW2 = h1^T
  dx2, dW3 = s^T dout (K3) or h2^T dmsg, each chunk of rows in 32-row
  stages, a stage's 4 k8 steps from a fresh accumulator in mma3's order,
  folded into the chunk's sum with Kahan compensation, then `sum_partials`
  over every chunk (the empty ones' zeros too).

`emulate_*` below repeat those loops in torch and are held against the
JAX package's Pallas `_pallas_sum_bwd`, `_pallas_edge_lnmod_bwd`
(without and with `keep=`, filled with the port's counter-hash keep
scales, which the kernel at DROP 2 regenerates) and `_pallas_edge_bwd` in
interpret mode in f32
at atol 2e-4 + rtol 2e-4 (as tests/test_kernels.py holds them) at B 2, L 6
with K 16, 32, 48, 64 and 20; the same loops with one TF32 product (hi_a
hi_b) miss that limit; and the transposed weights' fragment order and the
weight-grad pass's fragment reads are permutations.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codlad_tpu.kernels import mpnn_kernels as JK
from codlad_tpu_torch.kernels.mpnn_kernels import keep_scales
from test_torch_chain_bwd_tiles import _gelu_grad, _in_order, _kahan, sum_partials
from test_torch_chain_tiles_f32 import (F32, H, SLAB, UNIT, _quad_sum, _slabs,  # noqa: F401
                                        _within, gelu_exp, interpret, k_row, mma3)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the suite runs this file beside its other
    workers on the same cores; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P_DROP = 0.6
WGRAD_CHUNKS = 264   # row chunks of the weight-grad pass (kernels/mpnn_kernels.py)
WGRAD_ROWS = 32      # a stage's rows; a chunk is a multiple of it
SUM_NAMES = ("dA", "dE", "dGn", "dW_e", "dW2", "db2", "dW3", "db3")
EDGE_NAMES = SUM_NAMES + ("dsh", "dsc", "dgate")
NAT = torch.argsort(UNIT)   # pre's unit-order columns back to hidden order


def wgrad(X, Y, single=False):
    """X^T Y [H, H] as `wgrad_f32_mma_kernel` sums it, then sum_partials
    over all WGRAD_CHUNKS chunks."""
    M = X.shape[0]
    per = -(-(-(-M // WGRAD_CHUNKS)) // WGRAD_ROWS) * WGRAD_ROWS
    zero = torch.zeros(X.shape[1], Y.shape[1], dtype=F32)
    parts = []
    for chunk in range(WGRAD_CHUNKS):
        acc, comp = zero, zero
        for r in range(min(M, chunk * per), min(M, chunk * per + per), WGRAD_ROWS):
            x, y = X[r:r + WGRAD_ROWS], Y[r:r + WGRAD_ROWS]
            pad = WGRAD_ROWS - x.shape[0]            # rows past the chunk load zeros
            if pad:
                x = torch.cat([x, torch.zeros(pad, x.shape[1], dtype=F32)])
                y = torch.cat([y, torch.zeros(pad, y.shape[1], dtype=F32)])
            acc, comp = _kahan(acc, comp, mma3(x.T, y, single=single))
        parts.append(acc)
    return sum_partials(torch.stack(parts))


def _res_sums(v, B, L, K):
    """Each residue's column sums of v [B L K, C]: the slab sums (rows g and
    g + 8, then the butterfly over g as a pairwise tree; padding rows zero),
    then the residue's slabs in order -> [B L, C]."""
    p = _slabs(v.reshape(B, L, K, -1), K).reshape(-1, SLAB, v.shape[-1])
    p = p[:, :8] + p[:, 8:]
    p = p[:, 0::2] + p[:, 1::2]
    p = p[:, 0::2] + p[:, 1::2]
    p = (p[:, 0] + p[:, 1]).reshape(B * L, -1, v.shape[-1])
    return _in_order(p.transpose(0, 1))


def _per_sample(parts, B):
    """sum_partials over each sample's residue parts [B L, C] -> [B, C]."""
    return torch.stack([sum_partials(p) for p in parts.reshape(B, -1, parts.shape[-1])])


def _pass1(A, E, Gn, idx, W_e, W2, b2, single):
    """pre (unit order), h1, gelu'(pre), x2 + b2 (natural order), each edge
    row's sample and Gn row."""
    B, L, K, _ = E.shape
    a = A[:, :, None].expand(B, L, K, H).reshape(-1, H)
    bi = torch.arange(B)[:, None, None].expand(B, L, K).reshape(-1)
    j = idx.long().clamp(0, Gn.shape[1] - 1).reshape(-1)
    pre = mma3(E.reshape(-1, H), W_e[:, UNIT], (a + Gn[bi, j])[:, UNIT], single)
    h1 = gelu_exp(pre)
    return pre, h1, _gelu_grad(pre), mma3(h1, W2[UNIT], single=single) + b2, bi, j


def _pass2(dx2, g1, W_e, W2, bi, j, N, single):
    """dh1 = dx2 W2^T (unit order), dpre = dh1 gelu'(pre), dE = dpre W_e^T
    (natural order), dGn."""
    dpre = mma3(dx2, W2.T[:, UNIT], single=single) * g1
    dE = mma3(dpre, W_e.T[UNIT], single=single)
    B = int(bi.max()) + 1
    dGn = torch.zeros(B * N, H, dtype=F32)
    dGn[:, UNIT] = dGn[:, UNIT].index_add(0, bi * N + j, dpre)
    return dpre, dE, dGn.reshape(B, N, H)


def emulate_sum_bwd(A, E, Gn, idx, mask, W_e, W2, b2, W3, dout, single=False):
    """K3's two passes and weight grads -> `_pallas_sum_bwd`'s eight
    outputs (dout already / scale)."""
    B, L, K, _ = E.shape
    pre, h1, g1, x2, bi, j = _pass1(A, E, Gn, idx, W_e, W2, b2, single)
    d = dout.reshape(B * L, H)
    ds = torch.zeros(B * L, H, dtype=F32)
    for jj in range(H):                            # ds = dout W3^T, j in order
        ds = ds + d[:, jj:jj + 1] * W3[:, jj][None, :]
    m = mask.reshape(-1, 1).to(F32)
    h2 = gelu_exp(x2)
    s = _res_sums(m * h2, B, L, K)
    dx2 = (ds[:, None, :].expand(B * L, K, H).reshape(-1, H) * m) * _gelu_grad(x2)
    db2 = sum_partials(_res_sums(dx2, B, L, K))
    mcount = _in_order(mask.reshape(B * L, K).T.to(F32))   # 0 / 1: exact in any order
    db3 = sum_partials(mcount[:, None] * d)
    dpre, dE, dGn = _pass2(dx2, g1, W_e, W2, bi, j, Gn.shape[1], single)
    dA = torch.zeros(B * L, H, dtype=F32)
    dA[:, UNIT] = _res_sums(dpre, B, L, K)
    return (dA.reshape(B, L, H), dE.reshape(B, L, K, H), dGn,
            wgrad(E.reshape(-1, H), dpre[:, NAT], single), wgrad(h1[:, NAT], dx2, single),
            db2, wgrad(s, d, single), db3)


def emulate_edge_lnmod_bwd(A, E, Gn, idx, W_e, W2, b2, W3, b3, sc, g, dout, keep=None,
                           single=False):
    """K4's (K5's with `keep`) two passes and weight grads ->
    `_pallas_edge_lnmod_bwd`'s eleven outputs."""
    B, L, K, _ = E.shape
    pre, h1, g1, x2, bi, j = _pass1(A, E, Gn, idx, W_e, W2, b2, single)
    h2 = gelu_exp(x2)
    x = mma3(h2, W3, single=single) + b3
    kp = None if keep is None else keep.reshape(-1, H)
    if kp is not None:
        x = x * kp
    resid = E.reshape(-1, H) + x
    d = resid - (_quad_sum(resid) / H)[:, None]
    rstd = torch.rsqrt(_quad_sum(d * d) / H + 1e-6)[:, None]
    ln = d * rstd
    per_row = lambda v: v[:, None, :].expand(B, L * K, H).reshape(-1, H)
    gv, sc1 = per_row(g), 1.0 + per_row(sc)
    dct = dout.reshape(-1, H)
    dgo = dct * gv
    dln = dgo * sc1
    m1 = (_quad_sum(dln) / H)[:, None]
    m2 = (_quad_sum(dln * ln) / H)[:, None]
    dres = rstd * ((dln - m1) - ln * m2)
    dmsg = dres if kp is None else dres * kp
    dx2 = mma3(dmsg, W3.T, single=single) * _gelu_grad(x2)
    dpre, dE, dGn = _pass2(dx2, g1, W_e, W2, bi, j, Gn.shape[1], single)
    dA = torch.zeros(B * L, H, dtype=F32)
    dA[:, UNIT] = _res_sums(dpre, B, L, K)
    return (dA.reshape(B, L, H), (dE + dres).reshape(B, L, K, H), dGn,
            wgrad(E.reshape(-1, H), dpre[:, NAT], single), wgrad(h1[:, NAT], dx2, single),
            sum_partials(_res_sums(dx2, B, L, K)), wgrad(h2, dmsg, single),
            sum_partials(_res_sums(dmsg, B, L, K)),
            _per_sample(_res_sums(dgo, B, L, K), B), _per_sample(_res_sums(dgo * ln, B, L, K), B),
            _per_sample(_res_sums(dct * (ln * sc1), B, L, K), B))


def emulate_edge_bwd(A, E, Gn, idx, W_e, W2, b2, W3, dout, single=False):
    """K6's two passes and weight grads (dmsg = dout) -> `_pallas_edge_bwd`'s
    eight outputs."""
    B, L, K, _ = E.shape
    pre, h1, g1, x2, bi, j = _pass1(A, E, Gn, idx, W_e, W2, b2, single)
    dmsg = dout.reshape(-1, H)
    dx2 = mma3(dmsg, W3.T, single=single) * _gelu_grad(x2)
    dpre, dE, dGn = _pass2(dx2, g1, W_e, W2, bi, j, Gn.shape[1], single)
    dA = torch.zeros(B * L, H, dtype=F32)
    dA[:, UNIT] = _res_sums(dpre, B, L, K)
    return (dA.reshape(B, L, H), dE.reshape(B, L, K, H), dGn,
            wgrad(E.reshape(-1, H), dpre[:, NAT], single), wgrad(h1[:, NAT], dx2, single),
            sum_partials(_res_sums(dx2, B, L, K)), wgrad(gelu_exp(x2), dmsg, single),
            sum_partials(_res_sums(dmsg, B, L, K)))


KS = [16, 32, 48, 64, 20]   # 20: a multiple of 4, not of 16
_KIND_SEED = {"sum": 0, "lnmod": 100, "keep": 200, "edge": 300}


def _inputs(kind, K, B=2, L=6, seed=0):
    """Numpy f32 operands of K3 ("sum"), K4 ("lnmod", "keep") or K6's
    backward ("edge"), the keep scales for "keep"."""
    rng = np.random.default_rng(seed + K + _KIND_SEED[kind])
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    b = lambda: (rng.normal(size=H) * 0.1).astype(np.float32)
    x = [f(B, L, H), f(B, L, K, H), f(B, L, H),
         rng.integers(0, L, size=(B, L, K)).astype(np.int32)]
    if kind == "sum":
        x += [(rng.random((B, L, K)) > 0.2).astype(np.float32), f(H, H, sc=H ** -0.5),
              f(H, H, sc=H ** -0.5), b(), f(H, H, sc=H ** -0.5), f(B, L, H, sc=1 / 30)]
        return x, None
    if kind == "edge":
        x += [f(H, H, sc=H ** -0.5), f(H, H, sc=H ** -0.5), b(), f(H, H, sc=H ** -0.5),
              f(B, L, K, H)]
        return x, None
    x += [f(H, H, sc=H ** -0.5), f(H, H, sc=H ** -0.5), b(), f(H, H, sc=H ** -0.5), b(),
          f(B, H, sc=0.3), f(B, H), f(B, L, K, H, sc=0.05)]
    if kind == "lnmod":
        return x, None
    seeds = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, size=B).astype(np.int32))
    return x, keep_scales(seeds, (L, K, H), P_DROP).numpy()


def _pallas(kind, x, keep):
    jx = [jnp.asarray(v) for v in x]
    if kind in ("sum", "edge"):
        return (JK._pallas_sum_bwd if kind == "sum" else JK._pallas_edge_bwd)(*jx[:4], None,
                                                                              *jx[4:])
    kw = {} if keep is None else {"keep": jnp.asarray(keep)}
    return JK._pallas_edge_lnmod_bwd(*jx[:4], None, *jx[4:], **kw)


def _emulate(kind, x, keep, single=False):
    tx = [torch.from_numpy(v) for v in x]
    if kind == "sum":
        return emulate_sum_bwd(*tx, single=single)
    if kind == "edge":
        return emulate_edge_bwd(*tx, single=single)
    kp = None if keep is None else torch.from_numpy(keep)
    return emulate_edge_lnmod_bwd(*tx, keep=kp, single=single)


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("kind", ["sum", "lnmod", "keep", "edge"])
def test_backward_emulation_matches_pallas(interpret, kind, K):
    x, keep = _inputs(kind, K)
    want = _pallas(kind, x, keep)
    got = _emulate(kind, x, keep)
    names = SUM_NAMES if kind in ("sum", "edge") else EDGE_NAMES
    assert len(got) == len(want) == len(names)
    for n, gt, w in zip(names, got, want):
        assert gt.dtype == F32 and gt.numel() == np.asarray(w).size, n
        ok, worst = _within(gt.reshape(np.asarray(w).shape), w)
        assert ok, (n, worst)


@pytest.mark.parametrize("kind", ["sum", "lnmod", "edge"])
def test_a_single_tf32_product_shows(interpret, kind):
    """The same passes with one TF32 product (hi_a hi_b) in every product
    and in the weight-grad pass miss the f32 limit by several times at K
    64, while the split meets it."""
    x, keep = _inputs(kind, 64, seed=7)
    want = _pallas(kind, x, keep)
    worst = {}
    for single in (False, True):
        got = _emulate(kind, x, keep, single=single)
        worst[single] = max(_within(gt.reshape(np.asarray(w).shape), w)[1]
                            for gt, w in zip(got, want))
    assert worst[False] <= 1.0 and worst[True] > 3.0, worst


def test_fragment_orders_are_permutations():
    """The transposed weights staged in fragment order (stage_frag on W^T:
    W2^T with its columns through unit(), W_e^T with its rows through
    unit(), W3^T as it is) hold each element of W once, at the B fragment
    that the products x W^T read (dh1 in pre's unit order, dE and dh2 in
    natural order); the reduced column of a lane's quarter j covers every
    column (and, through unit(), every hidden unit) once; the weight-grad
    pass's A fragments (X^T) and B fragments (Y) cover their 16 x 8 and
    8 x 8 tiles once, with no two lanes on one shared-memory bank at row
    stride 136 floats."""
    for row_unit, col_unit in ((False, True), (True, False), (False, False)):
        seen = {}
        for kk in range(16):
            for np_ in range(8):
                for lane in range(32):
                    g, t4 = lane >> 2, lane & 3
                    for p in (t4, t4 + 4):
                        for c in (16 * np_ + g, 16 * np_ + 8 + g):
                            k = k_row(kk, p)
                            r_t = int(UNIT[k]) if row_unit else k      # W^T's row
                            c_t = int(UNIT[c]) if col_unit else c      # W^T's column
                            seen[(c_t, r_t)] = seen.get((c_t, r_t), 0) + 1  # W[c_t][r_t]
        assert len(seen) == H * H and set(seen.values()) == {1}
    # pass 2's reduced columns: quarter_col(j, lane) = 8 (4 j + (ri >> 1)) + 2 t4 + (ri & 1)
    cols = []
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        ri = 4 * (g & 1) + 2 * ((g >> 1) & 1) + (g >> 2)
        cols += [8 * (4 * j + (ri >> 1)) + 2 * t4 + (ri & 1) for j in range(4)]
    assert sorted(cols) == list(range(H))
    assert sorted(int(UNIT[c]) for c in cols) == list(range(H))
    # the weight-grad pass: a0 (m g, k t4), a1 (m g + 8, k t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4)
    a_tile, b_tile, banks = [], [], []
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        a_tile += [(g, t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4)]
        b_tile += [(t4, g), (t4 + 4, g)]
        banks.append((t4 * (H + 8) + g) % 32)
    assert sorted(a_tile) == [(m, k) for m in range(16) for k in range(8)]
    assert sorted(b_tile) == [(k, n) for k in range(8) for n in range(8)]
    assert sorted(banks) == list(range(32))
