"""The f32 tensor-core message chains' slab loop (3xTF32), on the CPU.

csrc/message_chain.cu runs the f32 K1 (`message_sum_f32_mma_kernel`), K2
(`message_edge_lnmod_f32_mma_kernel`), K6 (`message_edge_f32_mma_kernel`) and
K7 (`edge_then_sum_f32_mma_kernel`)
on mma.sync m16n8k8 in TF32, on 16-row slabs of one residue each (K a
multiple of 4 up to 64: rows past K in a residue's last slab are padding).
`emulate_*` below repeat that loop in torch with the kernels' arithmetic
(csrc/chain_tf32.cuh):

* every product over 16 k8 steps in order, each step's three TF32
  products lo_a hi_b, hi_a lo_b, hi_a hi_b added to the f32 accumulator in
  that order (`mma3`), with `split`: hi = x rounded to TF32 as
  cvt.rna.tf32.f32 rounds it (`tf32_rna`, 13 low bits, nearest, ties away
  from zero), lo = x - hi, which the tensor core reads truncated to TF32;
* pre = A[l] + Gn[idx] (the accumulators' preset) + E W_e with the first
  product's columns in K1's unit order (W_e's columns and W2's rows
  permuted alike); x2 = gelu(pre) W2;
* K2: h2 = gelu(x2 + b2) as the A operand of msg = h2 W3; resid = E + (msg
  + b3); the LayerNorm's two passes summed as the bf16 kernel sums them;
  out = g (LN (1 + sc) + sh), f32; K5's forward (K2's kernel at DROP 1 or
  2): resid = E + (msg + b3) x keep; K6's forward
  (`message_edge_f32_mma_kernel`, twenty-first slice): K2's loop with the
  raw epilogue, out = msg + b3;
* K1: mask * gelu(x2 + b2) of a slab's rows g and g + 8, the 8 lanes'
  butterfly as a pairwise tree, the residue's slabs in slab order, then
  out = (s W3 + msum b3) / scale with s W3 taken as W3^T s^T (W3 the A
  operand);
* K7: the K2 loop, then the K1 loop on its output.

The gelu is the kernels' x / (1 + exp(-2u)). The emulation is held against
the JAX package's Pallas kernels in interpret mode in f32 at atol 2e-4 +
rtol 2e-4 (as tests/test_kernels.py holds them) at K 16, 32, 48, 64 and 20
(K5's forward with the port's counter-hash keep scales, `keep_scales`, as
the Pallas kernel's `keep`; K6's forward against `_pallas_message_edge`);
the same loop with one TF32 product (hi_a hi_b) misses that limit; and a
5-step f32 DDIM draw of the port's denoiser (hidden 128) with K1 and K2
swapped for the emulation stays within 1e-5 of max|latent| of the JAX
package's draw from the same x_T.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_parity import ca_inputs, denoiser_pair, exact_gathers, t
from codlad_tpu.eval.harness import SamplingPipeline as JaxPipeline
from codlad_tpu.gen.diffusion import create_diffusion as jax_create_diffusion
from codlad_tpu.kernels import mpnn_kernels as JK
from codlad_tpu_torch.eval.harness import SamplingPipeline
from codlad_tpu_torch.gen.diffusion import create_diffusion
from codlad_tpu_torch.kernels.mpnn_kernels import keep_scales
from codlad_tpu_torch.nn import mpnn as TM

H = 128
SLAB = 16
F32 = torch.float32
# the first product's column n is hidden unit UNIT[n] (chain_mma.cuh unit())
UNIT = torch.tensor([32 * ((n >> 1) & 3) + 2 * (n >> 3) + (n & 1) for n in range(H)])
_MASK13 = -0x2000  # 0xffffe000 as int32


def k_row(kk, p):
    """chain_tf32.cuh k_row: the k row of k8 step kk at fragment position p
    (t4 or t4 + 4) of an operand in the accumulator layout."""
    return 8 * kk + 2 * (p & 3) + (p >> 2)


def tf32_rna(x):
    """x (f32) rounded to TF32 bit for bit as cvt.rna.tf32.f32: the 13 low
    bits cleared after adding half their weight to the magnitude (nearest,
    ties away from zero; subnormals alike, a carry may reach the exponent
    and past the largest float to inf); inf stays inf, NaN stays NaN."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    r = ((b + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(F32)
    return torch.where(torch.isnan(x), x, r)


def tf32_trunc(x):
    """x with its 13 low bits cleared: lo as the tensor core reads it."""
    return (x.contiguous().view(torch.int32) & _MASK13).view(F32)


def split(x):
    """(hi, lo) as the kernels' `split` hands them to the mma: hi = rna(x),
    lo = x - hi (exact in f32), read truncated to TF32."""
    hi = tf32_rna(x)
    return hi, tf32_trunc(x - hi)


def mma3(a, b, acc=None, single=False):
    """acc + a b over k8 steps in order [m, 128] x [128, n], each step's
    lo_a hi_b, hi_a lo_b, hi_a hi_b added in that order (`single`: hi_a hi_b
    only, one TF32 product)."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=F32) if acc is None else acc
    for kk in range(a.shape[1] // 8):
        s = slice(8 * kk, 8 * kk + 8)
        if not single:
            acc = acc + al[:, s] @ bh[s]
            acc = acc + ah[:, s] @ bl[s]
        acc = acc + ah[:, s] @ bh[s]
    return acc


def gelu_exp(x):
    u = 0.7978845608028654 * (x + 0.044715 * x * x * x)
    return x / (1.0 + torch.exp(-2.0 * u))


def _slabs(v, K):
    """[B, L, K, ...] -> [B, L, Kp, ...], Kp = 16 ceil(K / 16): each residue's
    rows padded with zeros to whole slabs."""
    Kp = -(-K // SLAB) * SLAB
    pad = torch.zeros(v.shape[:2] + (Kp - K,) + v.shape[3:], dtype=v.dtype)
    return torch.cat([v.to(F32), pad], dim=2)


def _x2(A, E, Gn, idx, W_e, W2, single=False):
    """x2 of every edge row [B L K, H] (W2's own column order)."""
    B, L, K, _ = E.shape
    a = A[:, :, None].expand(B, L, K, H).reshape(-1, H)
    g = Gn[torch.arange(B)[:, None, None], idx.long().clamp(0, Gn.shape[1] - 1)].reshape(-1, H)
    pre = mma3(E.reshape(-1, H), W_e[:, UNIT], (a + g)[:, UNIT], single)
    return mma3(gelu_exp(pre), W2[UNIT], single=single)


def _quad_sum(v):
    """Row sums of v [rows, 128] in the kernel's order: lane t4 sums its
    columns 8 nt + 2 t4 + e (nt, then e), then the quad pairwise."""
    cols = v.reshape(-1, 16, 4, 2)
    lane = torch.zeros(cols.shape[0], 4, dtype=F32)
    for nt in range(16):
        for e in range(2):
            lane = lane + cols[:, nt, :, e]
    return (lane[:, 0] + lane[:, 1]) + (lane[:, 2] + lane[:, 3])


def emulate_edge_lnmod(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g, single=False,
                       keep=None):
    """K2's slab loop (K5's forward with `keep` [B, L, K, H]) -> f32 [B, L,
    K, H]."""
    B, L, K, _ = E.shape
    h2 = gelu_exp(_x2(A, E, Gn, idx, W_e, W2, single) + b2)
    msg = mma3(h2, W3, single=single) + b3
    resid = E.reshape(-1, H) + (msg if keep is None else msg * keep.reshape(-1, H))
    mean = _quad_sum(resid) / H
    d = resid - mean[:, None]
    rstd = torch.rsqrt(_quad_sum(d * d) / H + 1e-6)
    per_row = lambda v: v[:, None, :].expand(B, L * K, H).reshape(-1, H)
    out = per_row(g) * (((d * rstd[:, None]) * (1.0 + per_row(sc))) + per_row(sh))
    return out.reshape(B, L, K, H)


def emulate_message_edge(A, E, Gn, idx, W_e, W2, b2, W3, b3, single=False):
    """K6's forward: K2's slab loop with the raw epilogue, out = msg + b3
    (lnmod_out's first sum, no LayerNorm) -> f32 [B, L, K, H]."""
    B, L, K, _ = E.shape
    h2 = gelu_exp(_x2(A, E, Gn, idx, W_e, W2, single) + b2)
    return (mma3(h2, W3, single=single) + b3).reshape(B, L, K, H)


def emulate_message_sum(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale, single=False):
    """K1's slab loop -> f32 [B, L, H]."""
    B, L, K, _ = E.shape
    h2 = gelu_exp(_x2(A, E, Gn, idx, W_e, W2, single) + b2).reshape(B, L, K, H)
    m = _slabs(mask[..., None], K)                   # padding rows: mask 0
    p = (m * _slabs(h2, K)).reshape(-1, SLAB, H)
    p = p[:, :8] + p[:, 8:]                          # lane g: rows g and g + 8
    p = p[:, 0::2] + p[:, 1::2]                      # the butterfly, as a tree
    p = p[:, 0::2] + p[:, 1::2]
    slab = (p[:, 0] + p[:, 1]).reshape(B * L, -1, H)
    s = torch.zeros(B * L, H, dtype=F32)
    for q in range(slab.shape[1]):                   # slab order
        s = s + slab[:, q]
    ms = m.reshape(B * L, -1, SLAB)
    ms = ms[..., :8] + ms[..., 8:]
    ms = ms[..., 0::2] + ms[..., 1::2]
    ms = ms[..., 0::2] + ms[..., 1::2]
    ms = ms[..., 0] + ms[..., 1]
    msum = torch.zeros(B * L, dtype=F32)
    for q in range(ms.shape[1]):
        msum = msum + ms[:, q]
    out = mma3(W3.t(), s.t(), single=single).t()     # W3^T s^T: W3 the A operand
    return ((out + msum[:, None] * b3) / scale).reshape(B, L, H)


def emulate_edge_then_sum(A_e, E, G_e, idx, W_e_e, W2_e, b2_e, W3_e, b3_e, sh, sc, gmod,
                          A_n, G_n, W_e_n, W2_n, b2_n, W3_n, b3_n, mask, scale, single=False):
    """K7: K2's loop, then K1's on its output -> (e2, f32 [B, L, H])."""
    e2 = emulate_edge_lnmod(A_e, E, G_e, idx, W_e_e, W2_e, b2_e, W3_e, b3_e, sh, sc, gmod,
                            single)
    return e2, emulate_message_sum(A_n, e2, G_n, idx, mask, W_e_n, W2_n, b2_n, W3_n, b3_n,
                                   scale, single)


def _inputs(B, L, K, seed):
    """fused_edge_then_sum's operands (numpy f32): K2's first 12, then the
    node chain's A, Gn, weights and the mask."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    b = lambda: (rng.normal(size=H) * 0.1).astype(np.float32)
    w = lambda: [f(H, H, sc=H ** -0.5), f(H, H, sc=H ** -0.5), b(), f(H, H, sc=H ** -0.5),
                 b()]
    idx = rng.integers(0, L, size=(B, L, K)).astype(np.int32)
    edge = [f(B, L, H), f(B, L, K, H), f(B, L, H), idx, *w(), f(B, H, sc=0.3),
            f(B, H, sc=0.3), f(B, H)]
    node = [f(B, L, H), f(B, L, H), *w(), (rng.random((B, L, K)) > 0.2).astype(np.float32)]
    return edge + node


def _within(got, want):
    """Whether |got - want| <= 2e-4 + 2e-4 |want| everywhere, and the worst
    ratio of |d| to that limit."""
    got, want = got.numpy(), np.asarray(want, dtype=np.float32)
    ratio = np.abs(got - want) / (2e-4 + 2e-4 * np.abs(want))
    return bool(np.all(ratio <= 1.0)), float(ratio.max())


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(JK.pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


KS = [16, 32, 48, 64, 20]   # 20: a multiple of 4, not of 16


def _case(K, seed):
    x = _inputs(2, 12, K, seed)
    return [torch.from_numpy(a) for a in x], [jnp.asarray(a) for a in x]


@pytest.mark.parametrize("K", KS)
def test_message_sum_emulation_matches_pallas(interpret, K):
    tx, jx = _case(K, 400 + K)
    node = [jx[12], jx[1], jx[13], jx[3], None, jx[19], *jx[14:19], 30.0]
    want = JK._pallas_message_sum(*node)
    got = emulate_message_sum(tx[12], tx[1], tx[13], tx[3], tx[19], *tx[14:19], 30.0)
    ok, worst = _within(got, want)
    assert got.shape == want.shape and ok, worst


@pytest.mark.parametrize("K", KS)
def test_edge_lnmod_emulation_matches_pallas(interpret, K):
    tx, jx = _case(K, 500 + K)
    want = JK._pallas_message_edge_lnmod(*jx[:4], None, *jx[4:12])
    got = emulate_edge_lnmod(*tx[:12])
    ok, worst = _within(got, want)
    assert got.shape == want.shape and ok, worst


@pytest.mark.parametrize("K", KS)
def test_message_edge_emulation_matches_pallas(interpret, K):
    """K6's forward (K2's loop, the raw epilogue) against the Pallas K6."""
    tx, jx = _case(K, 900 + K)
    want = JK._pallas_message_edge(*jx[:4], None, *jx[4:9])
    got = emulate_message_edge(*tx[:9])
    ok, worst = _within(got, want)
    assert got.shape == want.shape and ok, worst


@pytest.mark.parametrize("K", KS)
def test_dropout_forward_emulation_matches_pallas(interpret, K):
    """K5's forward, K2's loop with the keep scales that the kernel at DROP
    2 makes from per-sample seeds (rate 0.6), against the Pallas kernel
    given them as `keep`."""
    tx, jx = _case(K, 800 + K)
    seeds = torch.from_numpy(np.random.default_rng(K).integers(0, 2 ** 31 - 1, size=2)
                             .astype(np.int32))
    keep = keep_scales(seeds, (12, K, H), 0.6)
    assert 0.3 < float((keep > 0).float().mean()) < 0.5
    want = JK._pallas_message_edge_lnmod(*jx[:4], None, *jx[4:12],
                                         keep=jnp.asarray(keep.numpy()))
    got = emulate_edge_lnmod(*tx[:12], keep=keep)
    ok, worst = _within(got, want)
    assert got.shape == want.shape and ok, worst


@pytest.mark.parametrize("K", KS)
def test_edge_then_sum_emulation_matches_pallas(interpret, K):
    tx, jx = _case(K, 600 + K)
    e2_j, ns_j = JK._pallas_edge_then_sum(*jx[:4], None, *jx[4:])
    e2, ns = emulate_edge_then_sum(*tx, 30.0)
    for got, want in ((e2, e2_j), (ns, np.asarray(ns_j) / 30.0)):
        ok, worst = _within(got, want)
        assert ok, worst


def test_a_single_tf32_product_shows(interpret):
    """The same slab loop with one TF32 product (hi_a hi_b) misses the f32
    limit by several times (K2 and K1 at K 64), while the split meets it:
    the split is what keeps the tensor-core chain at f32's accuracy."""
    tx, jx = _case(64, 700)
    want_e = JK._pallas_message_edge_lnmod(*jx[:4], None, *jx[4:12])
    want_s = JK._pallas_message_sum(jx[12], jx[1], jx[13], jx[3], None, jx[19], *jx[14:19],
                                    30.0)
    one_e = _within(emulate_edge_lnmod(*tx[:12], single=True), want_e)
    one_s = _within(emulate_message_sum(tx[12], tx[1], tx[13], tx[3], tx[19], *tx[14:19],
                                        30.0, single=True), want_s)
    assert not one_e[0] and one_e[1] > 3.0, one_e
    assert not one_s[0] and one_s[1] > 3.0, one_s
    assert _within(emulate_edge_lnmod(*tx[:12]), want_e)[0]


def test_tf32_rna_ties_subnormals_inf_nan():
    """tf32_rna is cvt.rna.tf32.f32's rounding: ties away from zero (not to
    even), the subnormals' 13 low bits alike with a carry into the exponent,
    the largest float up to inf, inf and NaN kept."""
    bits = lambda *v: torch.tensor(v, dtype=torch.int64).to(torch.int32).view(F32)
    one = 1.0
    ulp = 2.0 ** -10                                  # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + 3 * ulp / 2, one + ulp / 2 - 2 ** -23,
                      one + ulp / 2 + 2 ** -23, 3.0], dtype=F32)
    want = torch.tensor([one + ulp, -(one + ulp), one + 2 * ulp, one, one + ulp, 3.0],
                        dtype=F32)
    assert torch.equal(tf32_rna(x), want)
    # subnormals: bit 12 (half the subnormal TF32 ulp 2^-136) rounds up, 0xfff down
    sub = bits(0x1000, 0xFFF, 0x2000, 0x3000, 0x7FFFFF, -0x80000000 | 0x1000)
    assert tf32_rna(sub).view(torch.int32).tolist() == [
        0x2000, 0, 0x2000, 0x4000, 0x800000, -0x80000000 | 0x2000]
    special = bits(0x7F800000, -0x800000, 0x7F7FFFFF, 0x7FC00000, 0x7FFFFFFF)
    r = tf32_rna(special)
    assert r[0] == float("inf") and r[1] == float("-inf") and r[2] == float("inf")
    assert torch.isnan(r[3]) and torch.isnan(r[4])
    assert torch.equal(tf32_rna(torch.tensor([0.0, -0.0])).view(torch.int32),
                       torch.tensor([0, -0x80000000], dtype=torch.int32))


def test_split_is_exact_and_keeps_non_finite_values():
    """hi + lo is x (lo exact in f32, then read truncated: |x - hi - lo_t| <=
    2^-21 |x|); every hi and lo_t is a TF32 value; a NaN or infinite x gives
    a NaN lo, as the kernel's integer rounding of hi may carry a NaN's bits
    to 0 or inf."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=10000).astype(np.float32) * 7)
    hi, lo = split(x)
    assert torch.equal(tf32_trunc(hi), hi) and torch.equal(tf32_trunc(lo), lo)
    assert torch.all((x.double() - hi.double() - lo.double()).abs() <= 2.0 ** -21 * x.abs())
    assert torch.equal(hi, tf32_rna(x))
    for v in (float("nan"), float("inf"), float("-inf")):
        # the kernel adds to the raw bits with no NaN test: emulate that hi
        b = torch.tensor([v], dtype=F32).view(torch.int32).to(torch.int64)
        hi_k = ((b + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
        hi_k = torch.where(hi_k >= 2 ** 31, hi_k - 2 ** 32, hi_k).to(torch.int32).view(F32)
        assert torch.isnan(torch.tensor([v], dtype=F32) - hi_k).all()
    canon = torch.tensor([0x7FFFFFFF], dtype=torch.int32).view(F32)   # the card's NaN
    b = canon.view(torch.int32).to(torch.int64)
    hi_k = torch.tensor([(int(b) + 0x1000) & 0xFFFFE000], dtype=torch.int64)
    hi_k = torch.where(hi_k >= 2 ** 31, hi_k - 2 ** 32, hi_k).to(torch.int32).view(F32)
    assert hi_k.item() == 0.0 and torch.isnan(canon - hi_k).all()


def test_fragment_order_is_a_permutation():
    """k_row covers each k row of a k8 step once; the staged weight's float4
    slots (kk, np, lane) hold each W element once, whatever rows or columns
    go through unit(); W3's slots give W3^T's A fragments (v.x, v.z, v.y,
    v.w) of m tile np."""
    assert sorted(UNIT.tolist()) == list(range(H))
    for kk in range(16):
        assert sorted(k_row(kk, p) for p in range(8)) == list(range(8 * kk, 8 * kk + 8))
    for row_unit in (False, True):
        for col_unit in (False, True):
            seen = set()
            for kk in range(16):
                for np_ in range(8):
                    for lane in range(32):
                        g, t4 = lane >> 2, lane & 3
                        r = [k_row(kk, t4), k_row(kk, t4 + 4)]
                        c = [16 * np_ + g, 16 * np_ + 8 + g]
                        r = [int(UNIT[v]) if row_unit else v for v in r]
                        c = [int(UNIT[v]) if col_unit else v for v in c]
                        slot = [(r[0], c[0]), (r[1], c[0]), (r[0], c[1]), (r[1], c[1])]
                        # W3^T's A fragment: a0 (m g, k t4), a1 (m g + 8, k t4),
                        # a2 (m g, k t4 + 4), a3 (m g + 8, k t4 + 4)
                        a = [slot[0], slot[2], slot[1], slot[3]]
                        assert a == [(r[0], c[0]), (r[0], c[1]), (r[1], c[0]), (r[1], c[1])]
                        seen.update(slot)
            assert seen == {(i, j) for i in range(H) for j in range(H)}


def _emulated_sum(A, E, Gn, idx, mask, W_e, W2, b2, W3, b3, scale):
    f = lambda v: v.to(F32)
    return emulate_message_sum(*(f(v) if v.is_floating_point() else v
                                 for v in (A, E, Gn, idx, mask, W_e, W2, b2, W3, b3)), scale)


def _emulated_edge(A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g):
    f = lambda v: v.to(F32)
    return emulate_edge_lnmod(*(f(v) if v.is_floating_point() else v
                                for v in (A, E, Gn, idx, W_e, W2, b2, W3, b3, sh, sc, g)))


def test_f32_draw_with_emulated_kernels_matches_jax(monkeypatch):
    """Five f32 DDIM steps (eta 0) of the port's denoiser at hidden 128 (2
    encoder layers, 1 decoder layer, K 16) with K1 and K2 swapped for the
    emulation stay within 1e-5 of max|latent| of the JAX package's draw
    from the same x_T, as chip_smoke.py holds the card's f32 draws."""
    exact_gathers(monkeypatch)
    calls = {"sum": 0, "edge": 0}

    def k1(*a):
        calls["sum"] += 1
        return _emulated_sum(*a)

    def k2(*a):
        calls["edge"] += 1
        return _emulated_edge(*a)

    monkeypatch.setattr(TM, "fused_message_sum", k1)
    monkeypatch.setattr(TM, "fused_message_edge_lnmod", k2)
    B, L = 2, 16
    res_type, cg, mask = ca_inputs(21, B, L, n_valid=[L, 13])
    model, params, port = denoiser_pair(22, res_type, cg, mask, hidden_dim=H,
                                        edge_features=H, k_neighbors=16)
    jax_pipe = JaxPipeline(denoiser=model, denoiser_params=params,
                           process=jax_create_diffusion("ddim5", diffusion_steps=1000),
                           process_kind="diffusion", vae=None, vae_params=None, vq_state=None,
                           norm_mean=np.zeros(3, np.float32),
                           norm_std=np.ones(3, np.float32), sampler="ddim")
    extras = dict(res_type=res_type, cg_xyz=cg, mask=mask)
    key = jax.random.PRNGKey(23)
    want = np.asarray(jax_pipe.sample_latents(key, {k: jnp.asarray(v)
                                                    for k, v in extras.items()}))
    x_T = np.asarray(jax.random.normal(jax.random.split(key)[1], (B, L, 3)))
    pipe = SamplingPipeline(denoiser=port, process=create_diffusion("ddim5"), vae=None,
                            codebook=None, norm_mean=np.zeros(3), norm_std=np.ones(3),
                            sampler="ddim")
    got = pipe.sample_latents({k: t(v) for k, v in extras.items()}, noise=t(x_T)).numpy()
    assert calls["sum"] == 5 * 3 and calls["edge"] == 5 * 2, calls
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale, (np.abs(got - want).max(), scale)
