"""The bf16 tensor-core K3 (the backward of the masked message sum) on the CPU.

csrc/message_chain_bwd.cu runs K3 in bf16 as `message_sum_bwd_mma_kernel`
on K1's blocks (128 edge rows of whole residues) and 16-row slabs of one
residue, then `wgrad_mma_kernel` over row chunks and `sum_partials` over the
chunks and tiles. `emulate_sum_bwd` below repeats that loop in torch with
the kernel's rounding points and orders:

* pre and y = cast(gelu(pre)) as K1 computes them (tests/test_torch_chain_
  tiles.py: unit order, eight k16 steps), x2 = y W2 in W2's column order;
* ds = cast(dout) W3^T per residue: four products a lane in order, then a
  butterfly over the warp's 32 lanes;
* h2 = gelu(x2 + b2), gelu'(x2) from one sigmoid sg = 1 / (1 + exp(-2u)):
  gelu' = sg + 2 x sg (1 - sg) u' (JAX's tanh form with tanh u = 2 sg - 1);
  s = cast(mask h2 summed over the slab's rows g and g + 8, then the
  butterfly over g, then the residue's slabs in order);
* gelu'(pre) in f32 (the kernel parks it in f32 scratch between phases);
  dx2 = (ds mask) gelu'(x2), cast ("dx2"), dh1 = cast(dx2) W2^T over k16
  steps with pre's unit column order; dpre = dh1 gelu'(pre), cast ("dpre");
  dE = cast(cast(dpre) W_e^T); dA the slab sums of dpre (f32), then the
  residue's slabs in order; dGn the scatter-add of cast(dpre);
* db2's and db3's tile parts (slabs in order; residues in order), then
  `sum_partials` (Kahan sums over 32 strided splits, then the splits in
  order); dW_e = E^T cast(dpre), dW2 = h1^T cast(dx2), dW3 = s^T cast(dout)
  by 16-row steps over the weight-grad pass's row chunks, then
  `sum_partials` over the chunks.

The emulation is held against the JAX package's Pallas `_pallas_sum_bwd` in
interpret mode (through tests/test_torch_chain_tiles.py's `interpret`
fixture) at small B and L with K = 16, 32 and 48: every output in bf16
within 2e-2 of its max|ref|, in f32 within atol 2e-4 + rtol 2e-4.

That limit would not see one rounding point left out, so bf16 K3 is also
held closer, as the forward tiles' K7 is: at most 2% of its dE values differ
from Pallas's in any bit (0.2-0.4% do), and the mean |d| of dE, dW_e and dW2
lies within 3e-5 of their max|ref| (at most 1.2e-5). Without the cast of dx2
or of dpre, 34-43% of the dE values differ and dW_e's mean |d| rises to
2.7e-4 of its max|ref| and beyond.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codlad_tpu.kernels import mpnn_kernels as JK
from test_torch_chain_tiles import (DTYPES, F32, H, SLAB, UNIT, _cast, _k16, _round,  # noqa: F401
                                    gelu_exp, interpret)

MMA_ROWS = 128       # edge rows of a block of the main pass
WGRAD_CHUNKS = 264   # row chunks of the weight-grad pass (kernels/mpnn_kernels.py)
WGRAD_ROWS = 32      # a chunk is a multiple of a stage's rows
RT = 32              # sum_partials' strided splits


def _sigmoid_2u(x):
    u = 0.7978845608028654 * (x + 0.044715 * x * x * x)
    return 1.0 / (1.0 + torch.exp(-2.0 * u))


def _gelu_grad(x):
    sg = _sigmoid_2u(x)
    return sg + 2.0 * x * sg * (1.0 - sg) * (0.7978845608028654 * (1.0 + 3.0 * 0.044715 * x * x))


def _slab_sum(v):
    """[rows, C] -> [rows / 16, C]: rows g and g + 8 of each slab, then the
    butterfly over g as a pairwise tree."""
    p = v.reshape(-1, SLAB, v.shape[-1])
    p = p[:, :8] + p[:, 8:]
    p = p[:, 0::2] + p[:, 1::2]
    p = p[:, 0::2] + p[:, 1::2]
    return p[:, 0] + p[:, 1]


def _in_order(parts):
    """Sum of parts [n, ...] over its first dimension, in order."""
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out + p
    return out


def _kahan(s, comp, v):
    y = v - comp
    u = s + y
    return u, (u - s) - y


def sum_partials(part):
    """`sum_partials` of part [T, C]: split ty sums t = ty, ty + 32, ...
    (Kahan), then the splits and their compensations in order (Kahan)."""
    zero = torch.zeros(part.shape[1:], dtype=F32)
    total, tcomp = zero, zero
    for ty in range(RT):
        s, comp = zero, zero
        for t in range(ty, part.shape[0], RT):
            s, comp = _kahan(s, comp, part[t])
        total, tcomp = _kahan(total, tcomp, s)
        total, tcomp = _kahan(total, tcomp, -comp)
    return total


def wgrad(X, Y):
    """X^T Y [H, H] as the weight-grad pass sums it: 16-row steps in order
    within each row chunk, then sum_partials over the chunks."""
    M = X.shape[0]
    per = -(-(-(-M // WGRAD_CHUNKS)) // WGRAD_ROWS) * WGRAD_ROWS
    parts = []
    for m0 in range(0, M, per):
        acc = torch.zeros(X.shape[1], Y.shape[1], dtype=F32)
        for r in range(m0, min(M, m0 + per), 16):
            acc = acc + X[r:r + 16].T @ Y[r:r + 16]
        parts.append(acc)
    return sum_partials(torch.stack(parts))


def emulate_sum_bwd(A, E, Gn, idx, mask, W_e, W2, b2, W3, dout, skip=()):
    """K3's slab loop -> (dA, dE, dGn, dW_e, dW2, db2, dW3, db3), as
    `_pallas_sum_bwd` returns them; `skip` leaves out the rounding points it
    names ("dx2", "dpre")."""
    dt = E.dtype
    B, L, K, _ = E.shape
    N = Gn.shape[1]
    TL = MMA_ROWS // K
    spr = K // SLAB
    maskf = mask.to(F32).reshape(-1)

    # products 1 and 2 (K1's)
    a = _cast(A, dt)[:, :, None].expand(B, L, K, H).reshape(-1, H)
    bi = torch.arange(B)[:, None, None].expand(B, L, K).reshape(-1)
    j = idx.long().reshape(-1)
    g = _cast(Gn, dt)[bi, j]
    pre = (a + g)[:, UNIT] + _k16(_cast(E, dt).reshape(-1, H), _cast(W_e, dt)[:, UNIT])
    h1 = _cast(gelu_exp(pre), dt)                                  # unit order
    w2u = _cast(W2, dt)[UNIT]
    x2 = torch.cat([_k16(h1, w2u[:, 64 * hf:64 * hf + 64]) for hf in range(2)], dim=1)
    x2 = x2 + b2.to(F32)

    # ds = cast(dout) W3^T: four j a lane in order, then the warp's butterfly
    d = _cast(dout.reshape(B * L, H), dt)
    w3 = _cast(W3, dt)
    prod = d[:, None, :] * w3[None, :, :]                          # [B L, c, j]
    lanes = prod.reshape(B * L, H, 32, 4)
    p = ((lanes[..., 0] + lanes[..., 1]) + lanes[..., 2]) + lanes[..., 3]
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    ds = p[..., 0]                                                 # [B L, H]

    # s, dx2 and db2's slab parts
    sg = _sigmoid_2u(x2)
    h2 = x2 * sg
    dg2 = _gelu_grad(x2)
    m = maskf[:, None]
    s_slab = _slab_sum(m * h2).reshape(B * L, spr, H)
    s = _cast(_in_order(s_slab.transpose(0, 1)), dt)              # [B L, H]
    ds_rows = ds[:, None, :].expand(B * L, K, H).reshape(-1, H)
    dx2 = (ds_rows * m) * dg2
    db2_slab = _slab_sum(dx2)                                      # [B L K / 16, H]
    dx2c = _round(dx2, dt, "dx2", skip)

    # dh1 (unit order), dpre, dE, dA, dGn
    dh1 = _k16(dx2c, w2u.T)
    dpre = dh1 * _gelu_grad(pre)
    dpre_c = _round(dpre, dt, "dpre", skip)
    dE = _k16(dpre_c, _cast(W_e, dt)[:, UNIT].T).to(dt).reshape(B, L, K, H)
    dA_slab = _slab_sum(dpre).reshape(B * L, spr, H)
    dA = torch.zeros(B * L, H, dtype=F32)
    dA[:, UNIT] = _in_order(dA_slab.transpose(0, 1))
    dGn = torch.zeros(B * N, H, dtype=F32)
    dGn[:, UNIT] = dGn[:, UNIT].index_add(0, bi * N + j, dpre_c)

    # tile parts of db2 and db3, then sum_partials
    mcount = _in_order(mask.to(F32).reshape(B * L, K).T)           # 0/1: exact in any order
    dfull = dout.to(F32).reshape(B, L, H)
    db2_parts, db3_parts = [], []
    slabs = db2_slab.reshape(B, L * spr, H)
    for b in range(B):
        for l0 in range(0, L, TL):
            n = min(TL, L - l0)
            db2_parts.append(_in_order(slabs[b, l0 * spr:(l0 + n) * spr]))
            db3_parts.append(_in_order(mcount.reshape(B, L)[b, l0:l0 + n, None]
                                       * dfull[b, l0:l0 + n]))
    db2 = sum_partials(torch.stack(db2_parts))
    db3 = sum_partials(torch.stack(db3_parts))

    # the weight-grad pass on the scratch (natural column order)
    nat = torch.argsort(UNIT)
    dW_e = wgrad(_cast(E, dt).reshape(-1, H), dpre_c[:, nat])
    dW2 = wgrad(h1[:, nat], dx2c)
    dW3 = wgrad(s, d)
    return (dA.reshape(B, L, H), dE, dGn.reshape(B, N, H), dW_e, dW2, db2, dW3, db3)


NAMES = ("dA", "dE", "dGn", "dW_e", "dW2", "db2", "dW3", "db3")
CLOSE = ("dE", "dW_e", "dW2")   # held to the closer mean limit in bf16


def _case(dname, K, L=6, B=2, seed=0):
    """K3's operands (numpy; the edge dtype's values already rounded), the
    interpreted Pallas K3's outputs and the emulation's torch operands."""
    tdt, jdt = DTYPES[dname]
    rng = np.random.default_rng(seed + K)
    f = lambda *s, sc=1.0: _cast(torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32)), tdt).numpy()
    x = [f(B, L, H), f(B, L, K, H), f(B, L, H),
         rng.integers(0, L, size=(B, L, K)).astype(np.int32),
         (rng.random((B, L, K)) > 0.2).astype(np.float32),
         f(H, H, sc=H ** -0.5), f(H, H, sc=H ** -0.5),
         (rng.normal(size=H) * 0.1).astype(np.float32), f(H, H, sc=H ** -0.5),
         (rng.normal(size=(B, L, H)) / 30.0).astype(np.float32)]
    jx = [jnp.asarray(v) for v in x]
    jx[1] = jx[1].astype(jdt)
    want = JK._pallas_sum_bwd(*jx[:4], None, *jx[4:])
    want = [np.asarray(w, dtype=np.float32).reshape(-1) for w in want]
    tx = [torch.from_numpy(v) for v in x]
    tx[1] = tx[1].to(tdt)
    return tx, want


def _gaps(got, want):
    """{name: (max|d|, max|ref|, mean|d|)} and the share of dE values not
    equal to Pallas's."""
    out = {}
    for n, gt, w in zip(NAMES, got, want):
        d = np.abs(gt.to(F32).numpy().reshape(-1) - w)
        out[n] = (d.max(), np.abs(w).max(), d.mean())
    return out, float(np.mean(got[1].to(F32).numpy().reshape(-1) != want[1]))


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [16, 32, 48])
def test_sum_bwd_emulation_matches_pallas(interpret, dname, K):
    tx, want = _case(dname, K)
    got = emulate_sum_bwd(*tx)
    assert got[1].dtype == tx[1].dtype
    for n, gt, w in zip(NAMES, got, want):
        gt = gt.to(F32).numpy().reshape(-1)
        d = np.abs(gt - w)
        if dname == "bfloat16":
            assert d.max() <= 2e-2 * np.abs(w).max(), (n, d.max(), np.abs(w).max())
        else:
            assert np.all(d <= 2e-4 + 2e-4 * np.abs(w)), (n, d.max())
    if dname == "bfloat16":
        gaps, unequal = _gaps(got, want)
        assert unequal <= 2e-2, unequal
        for n in CLOSE:
            assert gaps[n][2] <= 3e-5 * gaps[n][1], (n, gaps[n])


@pytest.mark.parametrize("point", ["dx2", "dpre"])
@pytest.mark.parametrize("K", [16, 32, 48])
def test_a_missing_rounding_point_shows(interpret, K, point):
    """The bf16 emulation with the cast of dx2 or of dpre left out fails the
    closer limits that the whole emulation meets: the test above would see
    a kernel that lost that rounding point."""
    tx, want = _case("bfloat16", K)
    gaps, unequal = _gaps(emulate_sum_bwd(*tx, skip=(point,)), want)
    assert unequal > 2e-2, unequal
    assert gaps["dW_e"][2] > 3e-5 * gaps["dW_e"][1], gaps["dW_e"]
