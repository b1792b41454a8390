"""The bf16 tensor-core message chains' slab loop, on the CPU.

csrc/message_chain.cu runs K1 (`message_sum_mma_kernel`), K2
(`message_edge_lnmod_mma_kernel`) and K7 (`edge_then_sum_mma_kernel`) on
16-row slabs of one residue each (K a multiple of 16). `emulate_*` below
repeat that loop in torch with the kernels' rounding points:

* pre = A[l] + Gn[idx] (the accumulators' preset) + E W_e over eight k16
  steps, f32 sums, with the first product's columns in K1's unit order
  (`UNIT`: W_e's columns and W2's rows permuted alike);
* y = cast(gelu(pre)) (the A fragments of the W2 product), x2 = y W2 in two
  halves of 64 columns;
* K2: h2 = cast(gelu(x2 + b2)) reused as the A operand of msg = h2 W3;
  resid = E + (msg + b3) (K5's forward, the same kernel: E + (msg + b3) x
  keep); the LayerNorm's two passes summed as the kernel
  sums them: a lane's 32 columns (8 nt + 2 t4 + e) in order, then the quad
  (t4 0-3) pairwise; out = g (LN (1 + sc) + sh), cast;
* K1: mask * gelu(x2 + b2) of a slab's rows g and g + 8, then the 8 lanes'
  butterfly as a pairwise tree, the residue's K / 16 slabs in slab order,
  rounded to bf16, then (s W3 + msum b3) / scale summed over j in order;
* K7: the K2 loop, then the K1 loop on the slabs of its output;
* K6 (`message_edge_mma_kernel`, K2's chain with its own epilogue): h2 =
  cast(gelu(x2 + b2)) as K2's, out = cast(h2 W3 + b3), no LayerNorm.

The gelu is the kernels' x / (1 + exp(-2u)). The emulation is held against
the JAX package's Pallas `_pallas_message_edge_lnmod` (also with `keep=`),
`_pallas_edge_then_sum` and `_pallas_message_edge` in interpret mode (run as
tests/test_torch_fuse_pairs.py runs them) at small B and L with K = 32 and
48 (K6 also 16): bf16 within 2e-2 max|ref| (the two differ in the order of their f32
sums, so a value may round to the neighbouring bf16 one), f32 at atol 2e-4
+ rtol 2e-4 (as tests/test_kernels.py holds the Pallas kernels).

That limit would not see one rounding point left out, so bf16 K7 is also
held closer: at most 1% of its e2 values differ from Pallas's in any bit
(about 0.05% do), and its node sums lie within 1e-4 max|ref| of Pallas's
on average (3e-6 to 4e-5). An emulation without the cast of y, of h2 or
of the K-sum s breaks one of the two (30-40% of e2 values differ, the
mean rises to 3e-4 max|ref| and beyond).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from codlad_tpu.kernels import mpnn_kernels as JK
from codlad_tpu_torch.kernels.mpnn_kernels import (drop_threshold, keep_bits, keep_scale,
                                                   keep_scales)

H = 128
SLAB = 16
F32 = torch.float32
# the first product's column n is hidden unit UNIT[n] (lane t4's columns
# 8 nt + 2 t4 + e are units 32 t4 + 2 nt + e)
UNIT = torch.tensor([32 * ((n >> 1) & 3) + 2 * (n >> 3) + (n & 1) for n in range(H)])
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}


def gelu_exp(x):
    u = 0.7978845608028654 * (x + 0.044715 * x * x * x)
    return x / (1.0 + torch.exp(-2.0 * u))


def _cast(x, dt):
    return x.to(dt).to(F32)


def _round(x, dt, point, skip):
    """_cast at the rounding point `point`, unless `skip` names it (an
    emulation with one rounding point left out)."""
    return x if point in skip else _cast(x, dt)


def _k16(x, w):
    """x [rows, 128] w [128, n]: the sum over eight k16 steps in order."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=F32)
    for kk in range(H // 16):
        acc = acc + x[:, 16 * kk:16 * kk + 16] @ w[16 * kk:16 * kk + 16]
    return acc


def _x2(A, E, Gn, idx, W_e, W2, dt, skip=()):
    """Products 1 and 2 of every edge row: (x2 [rows, H] in two halves of
    columns, in W2's own column order)."""
    B, L, K, _ = E.shape
    a = _cast(A, dt)[:, :, None].expand(B, L, K, H).reshape(-1, H)
    g = _cast(Gn, dt)[torch.arange(B)[:, None, None], idx.long()].reshape(-1, H)
    pre = (a + g)[:, UNIT] + _k16(_cast(E, dt).reshape(-1, H), _cast(W_e, dt)[:, UNIT])
    y = _round(gelu_exp(pre), dt, "y", skip)
    w2 = _cast(W2, dt)[UNIT]
    return torch.cat([_k16(y, w2[:, 64 * hf:64 * hf + 64]) for hf in range(2)], dim=1)


def _quad_sum(v):
    """Row sums of v [rows, 128] in the kernel's order: lane t4 sums its
    columns 8 nt + 2 t4 + e (nt, then e), then the quad pairwise."""
    cols = v.reshape(-1, 16, 4, 2)
    lane = torch.zeros(cols.shape[0], 4, dtype=F32)
    for nt in range(16):
        for e in range(2):
            lane = lane + cols[:, nt, :, e]
    return (lane[:, 0] + lane[:, 1]) + (lane[:, 2] + lane[:, 3])


def emulate_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, skip=(), keep=None):
    """K2's slab loop -> [B, L, K, H] in E's dtype; `skip` leaves out the
    rounding points it names ("y", "h2"). With `keep` ([B, L, K, H] scales
    in E's dtype), K5's forward on the same kernel: msg + b3 times keep at
    the natural columns, before the residual."""
    dt = E.dtype
    B, L, K, _ = E.shape
    x2 = _x2(A, E, Gn, idx, W_e, W2, dt, skip)
    h2 = _round(gelu_exp(x2 + b2.to(F32)), dt, "h2", skip)  # packed as W3's A operand
    msg = _k16(h2, _cast(W3, dt)) + b3.to(F32)
    if keep is not None:
        msg = msg * keep.reshape(-1, H).to(F32)
    resid = E.reshape(-1, H).to(F32) + msg
    mean = _quad_sum(resid) / H
    d = resid - mean[:, None]
    rstd = torch.rsqrt(_quad_sum(d * d) / H + 1e-6)
    per_row = lambda v: v.to(F32)[:, None, :].expand(B, L * K, H).reshape(-1, H)
    out = per_row(g) * (((d * rstd[:, None]) * (1.0 + per_row(sc))) + per_row(sh))
    return out.to(dt).reshape(B, L, K, H)


def emulate_message_edge(A, E, Gn, idx, W_e, W2, b2, W3, b3, skip=()):
    """K6's slab loop -> [B, L, K, H] in E's dtype: K2's chain, then msg +
    b3 cast; `skip` leaves out the rounding points it names ("y", "h2")."""
    dt = E.dtype
    B, L, K, _ = E.shape
    x2 = _x2(A, E, Gn, idx, W_e, W2, dt, skip)
    h2 = _round(gelu_exp(x2 + b2.to(F32)), dt, "h2", skip)
    return (_k16(h2, _cast(W3, dt)) + b3.to(F32)).to(dt).reshape(B, L, K, H)


def emulate_message_sum(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale, skip=()):
    """K1's slab loop -> f32 [B, L, H]; `skip` leaves out the rounding
    points it names ("y", "s")."""
    dt = E.dtype
    B, L, K, _ = E.shape
    h2 = gelu_exp(_x2(A, E, Gn, idx, W_e, W2, dt, skip) + b2.to(F32)).reshape(-1, SLAB, H)
    m = mask.to(F32).reshape(-1, SLAB, 1)
    p = m[:, :8] * h2[:, :8] + m[:, 8:] * h2[:, 8:]     # lane g: rows g and g + 8
    p = p[:, 0::2] + p[:, 1::2]                         # the butterfly, as a tree
    p = p[:, 0::2] + p[:, 1::2]
    slab = (p[:, 0] + p[:, 1]).reshape(B * L, K // SLAB, H)
    s = torch.zeros(B * L, H, dtype=F32)
    for q in range(K // SLAB):                          # slab order
        s = s + slab[:, q]
    s = _round(s, dt, "s", skip)
    msum = torch.zeros(B * L, dtype=F32)
    for k in range(K):
        msum = msum + mask.to(F32).reshape(B * L, K)[:, k]
    w3 = _cast(W3, dt)
    out = torch.zeros(B * L, H, dtype=F32)
    for j in range(H):
        out = out + s[:, j:j + 1] * w3[j]
    out = out + msum[:, None] * b3.to(F32)
    return (out / scale).reshape(B, L, H)


def emulate_edge_then_sum(A_e, E, G_e, idx, W_e_e, W2_e, b2_e, W3_e, b3_e, sh, sc, gmod,
                          A_n, G_n, W_e_n, W2_n, b2_n, W3_n, b3_n, mask, scale, skip=()):
    """K7: K2's loop, then K1's on its output -> (e2, f32 [B, L, H])."""
    e2 = emulate_edge_lnmod(A_e, E, G_e, idx, W_e_e, W2_e, b2_e, W3_e, b3_e, sh, sc, gmod,
                            skip)
    return e2, emulate_message_sum(A_n, e2, G_n, idx, mask, W_e_n, W2_n, b2_n, W3_n, b3_n,
                                   scale, skip)


def _inputs(dt, B, L, K, seed):
    """fused_edge_then_sum's operands (numpy), the edge dtype's values
    already rounded (as the port's bf16 callers hand them over): K2's
    first 12, then the node chain's A, Gn, weights and the mask."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: _cast(torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32)), dt).numpy()
    b = lambda: (rng.normal(size=H) * 0.1).astype(np.float32)
    w = lambda: [f(H, H, sc=H ** -0.5), f(H, H, sc=H ** -0.5), b(), f(H, H, sc=H ** -0.5),
                 b()]
    idx = rng.integers(0, L, size=(B, L, K)).astype(np.int32)
    edge = [f(B, L, H), f(B, L, K, H), f(B, L, H), idx, *w(), f(B, H, sc=0.3),
            f(B, H, sc=0.3), f(B, H)]
    node = [f(B, L, H), f(B, L, H), *w(), (rng.random((B, L, K)) > 0.2).astype(np.float32)]
    return edge + node


def _close(got, want, dname):
    got, want = got.to(F32).numpy(), np.asarray(want, dtype=np.float32)
    d = np.abs(got - want)
    if dname == "bfloat16":
        assert d.max() <= 2e-2 * np.abs(want).max(), (d.max(), np.abs(want).max())
    else:
        assert np.all(d <= 2e-4 + 2e-4 * np.abs(want)), d.max()


def _k7_gaps(e2, ns, e2_j, ns_j):
    """(share of bf16 e2 values not equal to Pallas's, mean |d| of the
    node sums over their max |ref|)."""
    e2_j = torch.from_numpy(np.asarray(e2_j, dtype=np.float32)).to(e2.dtype)
    ns_j = torch.from_numpy(np.asarray(ns_j, dtype=np.float32))
    return ((e2 != e2_j).to(F32).mean().item(),
            ((ns - ns_j).abs().mean() / ns_j.abs().max()).item())


def _k7_case(K, dname="bfloat16"):
    """K7's operands as torch tensors and the interpreted Pallas K7's
    outputs (the node sums divided by the scale, 30)."""
    tdt, jdt = DTYPES[dname]
    x = _inputs(tdt, 2, 4, K, seed=100 + K)
    j = [jnp.asarray(a) for a in x]
    j[1] = j[1].astype(jdt)
    e2_j, ns_j = JK._pallas_edge_then_sum(*j[:4], None, *j[4:])
    t = [torch.from_numpy(a) for a in x]
    t[1] = t[1].to(tdt)
    return t, e2_j, np.asarray(ns_j) / 30.0


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JK.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [32, 48])
def test_edge_lnmod_emulation_matches_pallas(interpret, dname, K):
    tdt, jdt = DTYPES[dname]
    x = _inputs(tdt, 2, 4, K, seed=K)[:12]
    j = [jnp.asarray(a) for a in x]
    j[1] = j[1].astype(jdt)
    want = JK._pallas_message_edge_lnmod(*j[:4], None, *j[4:])
    t = [torch.from_numpy(a) for a in x]
    t[1] = t[1].to(tdt)
    got = emulate_edge_lnmod(*t)
    assert got.dtype == tdt and want.dtype == jdt
    _close(got, want, dname)


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [32, 48])
def test_edge_then_sum_emulation_matches_pallas(interpret, dname, K):
    t, e2_j, ns_j = _k7_case(K, dname)
    e2, ns = emulate_edge_then_sum(*t, 30.0)
    _close(e2, e2_j, dname)
    _close(ns, ns_j, dname)
    if dname == "bfloat16":
        unequal, mean_d = _k7_gaps(e2, ns, e2_j, ns_j)
        assert unequal <= 1e-2 and mean_d <= 1e-4, (unequal, mean_d)


@pytest.mark.parametrize("point", ["y", "h2", "s"])
@pytest.mark.parametrize("K", [32, 48])
def test_a_missing_rounding_point_shows(interpret, K, point):
    """The bf16 K7 emulation with the cast at `point` left out fails the
    closer limits that the whole emulation meets: the test above would
    see a kernel that lost that rounding point."""
    t, e2_j, ns_j = _k7_case(K)
    e2, ns = emulate_edge_then_sum(*t, 30.0, skip=(point,))
    unequal, mean_d = _k7_gaps(e2, ns, e2_j, ns_j)
    assert mean_d > 1e-4, mean_d
    if point != "s":    # the K-sum's cast acts after e2
        assert unequal > 1e-2, unequal


def test_unit_order_is_a_permutation_of_lane_columns():
    """UNIT sends lane t4's accumulator columns 8 nt + 2 t4 + e to the 32
    consecutive units 32 t4 + 2 nt + e (16-byte loads of A and Gn)."""
    assert sorted(UNIT.tolist()) == list(range(H))
    for t4 in range(4):
        cols = [8 * nt + 2 * t4 + e for nt in range(16) for e in range(2)]
        assert UNIT[cols].tolist() == list(range(32 * t4, 32 * t4 + 32))


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [16, 32, 48])
def test_message_edge_emulation_matches_pallas(interpret, dname, K):
    """K6's raw epilogue on K2's chain against the interpreted Pallas K6; in
    bf16 also closer: at most 1% of its values differ from Pallas's in any
    bit (0.03-0.3% do), and without the cast of y or of h2 more than that do
    (41-54%)."""
    tdt, jdt = DTYPES[dname]
    x = _inputs(tdt, 2, 4, K, seed=200 + K)[:9]
    j = [jnp.asarray(a) for a in x]
    j[1] = j[1].astype(jdt)
    want = JK._pallas_message_edge(*j[:4], None, *j[4:])
    t = [torch.from_numpy(a) for a in x]
    t[1] = t[1].to(tdt)
    got = emulate_message_edge(*t)
    assert got.dtype == tdt and want.dtype == jdt and got.shape == t[1].shape
    _close(got, want, dname)
    if dname == "bfloat16":
        ref = torch.from_numpy(np.asarray(want, dtype=np.float32)).to(tdt)
        assert (got != ref).to(F32).mean().item() <= 1e-2
        for point in ("y", "h2"):
            assert (emulate_message_edge(*t, skip=(point,)) != ref).to(F32).mean().item() > 1e-2


P_DROP = 0.6


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [32, 48])
def test_edge_lnmod_keep_emulation_matches_pallas(interpret, dname, K):
    """K5's forward on K2's kernel: the emulation with a keep operand filled
    with keep_scales (the mask the seeded kernel makes) against the
    interpreted Pallas K2 given the same keep, at the K2 test's limits."""
    tdt, jdt = DTYPES[dname]
    B, L = 2, 4
    x = _inputs(tdt, B, L, K, seed=300 + K)[:12]
    seeds = torch.from_numpy(np.random.default_rng(K).integers(0, 2 ** 31 - 1, size=B)
                             .astype(np.int32))
    keep = keep_scales(seeds, (L, K, H), P_DROP).to(tdt)
    j = [jnp.asarray(a) for a in x]
    j[1] = j[1].astype(jdt)
    want = JK._pallas_message_edge_lnmod(*j[:4], None, *j[4:],
                                         keep=jnp.asarray(keep.to(F32).numpy()).astype(jdt))
    t = [torch.from_numpy(a) for a in x]
    t[1] = t[1].to(tdt)
    got = emulate_edge_lnmod(*t, keep=keep)
    assert got.dtype == tdt and want.dtype == jdt
    _close(got, want, dname)
    # a keep of ones is K2 itself, bit for bit (as on the card)
    assert torch.equal(emulate_edge_lnmod(*t, keep=torch.ones_like(keep)), emulate_edge_lnmod(*t))


def _fragment_elements(L, K):
    """(element index, l, k, column) of every accumulator position K5's
    forward hashes, over every block, active warp, lane, n tile nt, row half
    h and column e of a sample: ((l0 K) + r0 + g + 8 h) H + 8 nt + 2 t4 + e
    (csrc/chain_mma.cuh keep_pair; a block of 128 rows holds TL = 128 // K
    whole residues, a warp the 16-row slab r0 = 16 warp)."""
    TL = 128 // K
    out = []
    for bx in range(-(-L // TL)):
        l0 = bx * TL
        nrows = min(TL, L - l0) * K
        for warp in range(8):
            r0 = SLAB * warp
            if r0 >= nrows:
                continue
            for lane in range(32):
                g, t4 = lane >> 2, lane & 3
                for nt in range(16):
                    for h in range(2):
                        for e in range(2):
                            row = l0 * K + r0 + g + 8 * h
                            c = 8 * nt + 2 * t4 + e
                            out.append((row * H + c, row // K, row % K, c))
    return np.array(out)


@pytest.mark.parametrize("L,K", [(4, 32), (5, 48), (3, 64), (7, 16)])
def test_keep_fragment_map_covers_a_sample_once(L, K):
    """The forward's fragment map hashes each element of a sample exactly
    once, at keep_bits' flat index ((l K) + k) H + c of the element it
    scales, so its mask is keep_scales' (and the backward's, which reads
    the same keep_pair)."""
    el = _fragment_elements(L, K)
    idx, l, k, c = el.T
    assert sorted(idx.tolist()) == list(range(L * K * H))
    assert np.array_equal(idx, (l * K + k) * H + c)
    seeds = torch.tensor([7, -3], dtype=torch.int32)
    bits = keep_bits(seeds, L * K * H)
    scales = keep_scales(seeds, (L, K, H), P_DROP)
    for b in range(2):
        frag = torch.zeros(L, K, H)
        frag[l, k, c] = (bits[b, idx] >= drop_threshold(P_DROP)).float() * keep_scale(P_DROP)
        assert torch.equal(frag, scales[b])
