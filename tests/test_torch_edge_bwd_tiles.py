"""The bf16 tensor-core edge-chain backwards (K4, K5's and K6's) on the CPU.

csrc/message_chain_bwd.cu runs them in bf16 as `message_edge_bwd_mma_kernel`
(K6's backward) and `message_edge_lnmod_bwd_mma_kernel<DROP>` (K4 at DROP 0,
K5's backward with a keep tensor or seeds) on K3's blocks (128 edge rows of
whole residues) and 16-row slabs of one residue, then `wgrad_mma_kernel`
over row chunks and `sum_partials` over the chunks and tiles.
`emulate_edge_bwd` and `emulate_edge_lnmod_bwd` below repeat that loop in
torch with the kernels' rounding points, column orders and sum orders:

* pre, y = cast(gelu(pre)) and x2 as K3 recomputes them
  (tests/test_torch_chain_bwd_tiles.py: unit order, eight k16 steps);
* K6: dmsg is the cotangent (already in E's dtype); h2 = cast(gelu(x2));
* K4 / K5: h2 = cast(gelu(x2)), msg = h2 W3 over k16 steps; resid = E +
  (msg + b3) x keep; the LayerNorm's mean and variance, and the backward's
  row means m1 of dln = dct g (1 + sc) and m2 of dln ln, summed as K2's
  lnmod_out sums (a lane's 32 columns in order, then the quad pairwise);
  dresid = rstd ((dln - m1) - ln m2) in f32; dmsg = dresid x keep, cast
  ("dmsg");
* dh2 = cast(dmsg) W3^T in natural column order, dx2 = dh2 gelu'(x2), cast
  ("dx2"); dh1, dpre, cast ("dpre"), dA and dGn as K3's; dE = cast(f32(
  cast(dpre) W_e^T) + dresid) with dresid added before the cast (the
  "dres_late" emulation adds it to the cast product and casts again);
* column sums (db2, db3, dsh, dsc, dgate): rows g and g + 8 of a slab, the
  butterfly over g, the tile's slabs in order, then `sum_partials` over the
  tiles (dsh, dsc, dgate: each sample's tiles); the weight grads dW_e = E^T
  cast(dpre), dW2 = h1^T cast(dx2), dW3 = h2^T cast(dmsg) by the
  weight-grad pass's row chunks.

The emulations are held against the JAX package's Pallas `_pallas_edge_bwd`
and `_pallas_edge_lnmod_bwd` (without and with `keep=`) in interpret mode
(through tests/test_torch_chain_tiles.py's `interpret` fixture) at B 2, L 6
with K = 16, 32 and 48 (partial tiles of residues at K 16 and 32): every
output in bf16 within 2e-2 of its max|ref|, in f32 within atol 2e-4 + rtol
2e-4. Dropout is held through `keep=`, filled with the port's counter-hash
keep scales (`keep_scales`), which the kernel at DROP 2 regenerates:
interpret mode stubs the TPU's own generator of the `drop_p` path.

In bf16 they are also held closer, as K3's emulation is: at most 2% of
the dE values differ from Pallas's in any bit (0.1-0.7% do), and the mean
|d| of dE, dW_e and dW2 lies within 6e-5 of their max|ref| (K3's file: 3e-5;
here up to 3.5e-5, dW_e of K4 at K 32: the LayerNorm backward's f32 sums,
in another order than Pallas's, flip a few more casts of dmsg). An
emulation that leaves out the cast of dmsg, dx2 or dpre (24-53% of dE
values differ; dW_e's mean |d| 2.6e-4 of its max|ref| and beyond), or adds
dresid after dE's cast (24-26% differ), fails them.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codlad_tpu.kernels import mpnn_kernels as JK
from codlad_tpu_torch.kernels.mpnn_kernels import keep_scales
from test_torch_chain_bwd_tiles import (MMA_ROWS, _gelu_grad, _in_order, _slab_sum,
                                        sum_partials, wgrad)
from test_torch_chain_tiles import (DTYPES, F32, H, SLAB, UNIT, _cast, _k16, _quad_sum,  # noqa: F401
                                    _round, gelu_exp, interpret)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the suite runs this file beside its other
    workers on the same cores, where torch's thread pools oversubscribe
    them; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


P_DROP = 0.6
NAMES = ("dA", "dE", "dGn", "dW_e", "dW2", "db2", "dW3", "db3", "dsh", "dsc", "dgate")
CLOSE = ("dE", "dW_e", "dW2")   # held to the closer mean limit in bf16
CLOSE_MEAN, CLOSE_UNEQUAL = 6e-5, 2e-2


def _chain(A, E, Gn, idx, W_e, W2, b2, dt):
    """pre (unit order), h1 = cast(gelu(pre)), x2 (natural order, + b2),
    W2's rows in unit order, and each edge row's sample and Gn row."""
    B, L, K, _ = E.shape
    a = _cast(A, dt)[:, :, None].expand(B, L, K, H).reshape(-1, H)
    bi = torch.arange(B)[:, None, None].expand(B, L, K).reshape(-1)
    j = idx.long().reshape(-1)
    pre = (a + _cast(Gn, dt)[bi, j])[:, UNIT] + _k16(_cast(E, dt).reshape(-1, H),
                                                     _cast(W_e, dt)[:, UNIT])
    h1 = _cast(gelu_exp(pre), dt)
    w2u = _cast(W2, dt)[UNIT]
    return pre, h1, _k16(h1, w2u) + b2.to(F32), w2u, bi, j


def _tile_parts(slab_parts, B, L, K):
    """Slab parts [B L K / 16, H] -> the tiles' parts [B, n_tiles, H]: each
    tile's slabs in order."""
    TL, spr = MMA_ROWS // K, K // SLAB
    slabs = slab_parts.reshape(B, L * spr, -1)
    return torch.stack([torch.stack([_in_order(slabs[b, l0 * spr:min(L, l0 + TL) * spr])
                                     for l0 in range(0, L, TL)]) for b in range(B)])


def _column_sum(v, B, L, K):
    """db's column sum of v [rows, H]: slab sums, tile parts, sum_partials."""
    return sum_partials(_tile_parts(_slab_sum(v), B, L, K).reshape(-1, v.shape[-1]))


def _sample_sums(v, B, L, K):
    """dsh's, dsc's or dgate's [B, H]: each sample's tile parts summed."""
    return torch.stack([sum_partials(p) for p in _tile_parts(_slab_sum(v), B, L, K)])


def _backward(E, W_e, W3, pre, h1, x2, w2u, bi, j, N, h2c, dmsg, dres, skip):
    """From dmsg (f32, natural order): the outputs K3's eight in
    `_pallas_edge_bwd`'s order; dres (K4) is dE's extra term."""
    dt = E.dtype
    B, L, K, _ = E.shape
    spr = K // SLAB
    dmsg_c = _round(dmsg, dt, "dmsg", skip)
    dx2 = _k16(dmsg_c, _cast(W3, dt).T) * _gelu_grad(x2)
    dx2c = _round(dx2, dt, "dx2", skip)
    dpre = _k16(dx2c, w2u.T) * _gelu_grad(pre)                 # unit order
    dpre_c = _round(dpre, dt, "dpre", skip)
    de = _k16(dpre_c, _cast(W_e, dt)[:, UNIT].T)
    if dres is not None:
        de = _cast(de, dt) + dres if "dres_late" in skip else de + dres
    dA = torch.zeros(B * L, H, dtype=F32)
    dA[:, UNIT] = _in_order(_slab_sum(dpre).reshape(B * L, spr, H).transpose(0, 1))
    dGn = torch.zeros(B * N, H, dtype=F32)
    dGn[:, UNIT] = dGn[:, UNIT].index_add(0, bi * N + j, dpre_c)
    nat = torch.argsort(UNIT)
    return (dA.reshape(B, L, H), de.to(dt).reshape(B, L, K, H), dGn.reshape(B, N, H),
            wgrad(_cast(E, dt).reshape(-1, H), dpre_c[:, nat]), wgrad(h1[:, nat], dx2c),
            _column_sum(dx2, B, L, K), wgrad(h2c, dmsg_c), _column_sum(dmsg, B, L, K))


def emulate_edge_bwd(A, E, Gn, idx, W_e, W2, b2, W3, dout, skip=()):
    """K6's backward -> `_pallas_edge_bwd`'s eight outputs; `skip` leaves out
    the rounding points it names ("dx2", "dpre")."""
    pre, h1, x2, w2u, bi, j = _chain(A, E, Gn, idx, W_e, W2, b2, E.dtype)
    h2c = _cast(gelu_exp(x2), E.dtype)
    return _backward(E, W_e, W3, pre, h1, x2, w2u, bi, j, Gn.shape[1], h2c,
                     dout.reshape(-1, H).to(F32), None, skip)


def emulate_edge_lnmod_bwd(A, E, Gn, idx, W_e, W2, b2, W3, b3, sc, g, dout, keep=None,
                           skip=()):
    """K4's (K5's with `keep`) backward -> `_pallas_edge_lnmod_bwd`'s eleven
    outputs; `skip` leaves out the rounding points it names ("dmsg", "dx2",
    "dpre") or adds dresid after dE's cast ("dres_late")."""
    dt = E.dtype
    B, L, K, _ = E.shape
    pre, h1, x2, w2u, bi, j = _chain(A, E, Gn, idx, W_e, W2, b2, dt)
    h2c = _cast(gelu_exp(x2), dt)
    x = _k16(h2c, _cast(W3, dt)) + b3.to(F32)
    kp = None if keep is None else keep.reshape(-1, H).to(F32)
    if kp is not None:
        x = x * kp
    resid = E.reshape(-1, H).to(F32) + x
    d = resid - (_quad_sum(resid) / H)[:, None]
    rstd = torch.rsqrt(_quad_sum(d * d) / H + 1e-6)[:, None]
    ln = d * rstd
    per_row = lambda v: v.to(F32)[:, None, :].expand(B, L * K, H).reshape(-1, H)
    gv, sc1 = per_row(g), 1.0 + per_row(sc)
    dct = dout.reshape(-1, H).to(F32)
    dgo = dct * gv
    dln = dgo * sc1
    m1 = (_quad_sum(dln) / H)[:, None]
    m2 = (_quad_sum(dln * ln) / H)[:, None]
    dres = rstd * ((dln - m1) - ln * m2)
    dmsg = dres if kp is None else dres * kp
    out = _backward(E, W_e, W3, pre, h1, x2, w2u, bi, j, Gn.shape[1], h2c, dmsg, dres, skip)
    return out + (_sample_sums(dgo, B, L, K), _sample_sums(dgo * ln, B, L, K),
                  _sample_sums(dct * (ln * sc1), B, L, K))


@functools.lru_cache(maxsize=None)
def _case(kind, dname, K, L=6, B=2, seed=0):
    """(torch operands, the interpreted Pallas kernel's outputs as flat f32
    numpy arrays) of K6's backward ("edge"), K4 ("lnmod") or K5's backward
    with the keep tensor ("keep"); the edge dtype's values already rounded."""
    tdt, jdt = DTYPES[dname]
    rng = np.random.default_rng(seed + K + {"edge": 0, "lnmod": 100, "keep": 200}[kind])
    f = lambda *s, sc=1.0: _cast(torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32)), tdt).numpy()
    b = lambda: (rng.normal(size=H) * 0.1).astype(np.float32)
    x = [f(B, L, H), f(B, L, K, H), f(B, L, H),
         rng.integers(0, L, size=(B, L, K)).astype(np.int32),
         f(H, H, sc=H ** -0.5), f(H, H, sc=H ** -0.5), b(), f(H, H, sc=H ** -0.5)]
    if kind != "edge":
        x += [b(), f(B, H, sc=0.3), f(B, H)]          # b3, sc, g
    x.append(f(B, L, K, H, sc=0.05))                  # dout, E's dtype
    jx = [jnp.asarray(v) for v in x]
    jx[1], jx[-1] = jx[1].astype(jdt), jx[-1].astype(jdt)
    tx = [torch.from_numpy(v) for v in x]
    tx[1], tx[-1] = tx[1].to(tdt), tx[-1].to(tdt)
    kw, tkw = {}, {}
    if kind == "keep":
        seeds = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, size=B).astype(np.int32))
        keep = keep_scales(seeds, (L, K, H), P_DROP).to(tdt)
        kw, tkw = {"keep": jnp.asarray(keep.to(F32).numpy()).astype(jdt)}, {"keep": keep}
    fn = JK._pallas_edge_bwd if kind == "edge" else JK._pallas_edge_lnmod_bwd
    want = fn(*jx[:4], None, *jx[4:], **kw)
    return tx, tkw, tuple(np.asarray(w, dtype=np.float32).reshape(-1) for w in want)


def _emulate(kind, tx, tkw, skip=()):
    if kind == "edge":
        return emulate_edge_bwd(*tx, skip=skip)
    return emulate_edge_lnmod_bwd(*tx, **tkw, skip=skip)


def _closer_gaps(got, want):
    """(share of dE values not equal to Pallas's, {name: (mean|d|, max|ref|)}
    of the CLOSE outputs)."""
    gaps = {}
    for n, gt, w in zip(NAMES, got, want):
        if n in CLOSE:
            gaps[n] = (np.abs(gt.to(F32).numpy().reshape(-1) - w).mean(), np.abs(w).max())
    return float(np.mean(got[1].to(F32).numpy().reshape(-1) != want[1])), gaps


def _closer_ok(got, want):
    unequal, gaps = _closer_gaps(got, want)
    return (unequal <= CLOSE_UNEQUAL and all(m <= CLOSE_MEAN * r for m, r in gaps.values()),
            (unequal, gaps))


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [16, 32, 48])
@pytest.mark.parametrize("kind", ["edge", "lnmod", "keep"])
def test_edge_bwd_emulation_matches_pallas(interpret, kind, dname, K):
    tx, tkw, want = _case(kind, dname, K)
    got = _emulate(kind, tx, tkw)
    assert len(got) == len(want) and got[1].dtype == tx[1].dtype
    for n, gt, w in zip(NAMES, got, want):
        d = np.abs(gt.to(F32).numpy().reshape(-1) - w)
        if dname == "bfloat16":
            assert d.max() <= 2e-2 * np.abs(w).max(), (n, d.max(), np.abs(w).max())
        else:
            assert np.all(d <= 2e-4 + 2e-4 * np.abs(w)), (n, d.max())
    if dname == "bfloat16":
        ok, gaps = _closer_ok(got, want)
        assert ok, gaps


@pytest.mark.parametrize("kind,point", [("edge", "dx2"), ("edge", "dpre"),
                                        ("lnmod", "dmsg"), ("lnmod", "dx2"),
                                        ("lnmod", "dpre"), ("lnmod", "dres_late"),
                                        ("keep", "dmsg"), ("keep", "dres_late")])
@pytest.mark.parametrize("K", [16, 48])
def test_a_missing_rounding_point_shows(interpret, kind, point, K):
    """The bf16 emulation with one rounding point left out (or dresid added
    after dE's cast) fails the closer limits that the whole emulation meets:
    the test above would see a kernel that lost it."""
    tx, tkw, want = _case(kind, "bfloat16", K)
    ok, gaps = _closer_ok(_emulate(kind, tx, tkw, skip=(point,)), want)
    assert not ok, gaps
