"""The Stage-1 backwards on the CPU against the JAX package: K11 (the fused
tensor product's backward), the K8/K9 VJPs and the CSR of each edge index.

* K11's plain version (autograd of the port's `ref_fused_tp`: dx, dsh, dw)
  against jax.vjp of the JAX `ref_fused_tp` and against the Pallas
  `_pallas_fused_tp_bwd` in interpret mode, on 3-d edge and 4-d cross-graph
  operands at the encoder's three layer signatures: f32 atol 2e-4 + rtol
  2e-4 (as tests/test_kernels.py holds the Pallas kernel), bf16 (against
  the JAX vjp, the same rounding steps) 2e-2 max|ref|, ~3 bf16 ulps of the
  largest element for sums taken in another order.
* The kernel's lists: the f32 K11 reads `f32_bwd_tables`' words, packed
  from the forward's lists and two transposed ones (`sparse_tables`: the
  positions of each weight, the nonzeros of each CBIG_R row); walking them
  in numpy, in the kernel's order, gives autograd's dx, dsh and dw of the
  dense form (float64, atol 1e-9).
* K8/K9 VJPs (gather; aggregate, sum and mean) against jax.vjp of the JAX
  `edge_gather` / `edge_aggregate` (and the mean over the valid degree, as
  its DenseEdgeOps divides): f32 atol 1e-5 + rtol 1e-5, bf16 within one
  bf16 ulp (rtol 2^-7) + atol 1e-6. Padded edges (index 0, mask 0) give no
  gradient and node 0 collects none of their cotangent.
* EdgeOps keeps one CSR a side: on a graph whose src and dst degrees
  differ, the dst CSR summed over node by node in its order is the VJP of
  gather_dst, and the src one is not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from codlad_tpu.kernels import edge_kernels as JEK
from codlad_tpu.kernels import tp_kernels as JTK
from codlad_tpu.nn import irreps as JI
from codlad_tpu_torch.kernels import edge_kernels as EK
from codlad_tpu_torch.kernels import tp_kernels as TK
from codlad_tpu_torch.models.encoder import irrep_ladder
from codlad_tpu_torch.nn import irreps as PI
from codlad_tpu_torch.nn.graph import EdgeOps
from codlad_tpu_torch.nn.tensor_product import fused_tp_tables

LADDER = irrep_ladder(12, 4)


def _tables(layer):
    return fused_tp_tables(tuple(LADDER[layer]), tuple(PI.SH_IRREPS), tuple(LADDER[layer + 1]))


def _tp_inputs(tb, layer, lead, seed):
    rng = np.random.default_rng(seed)
    din = LADDER[layer].dim
    x = rng.normal(size=lead + (din,)).astype(np.float32)
    sh = np.array(JI.sh_l2(jnp.asarray(rng.normal(size=lead + (3,)).astype(np.float32))))
    w = (rng.normal(size=lead + (tb["numel"],)) * din ** -0.5).astype(np.float32)
    dct = rng.normal(size=lead + (tb["SUMR"].shape[1],)).astype(np.float32)
    return x, sh, w, dct


def _port_bwd(tb, x, sh, w, dct, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (x, sh, w)]
    out = TK.fused_tp(*leaves, tb)
    return torch.autograd.grad(out, leaves, torch.from_numpy(dct).to(dtype))


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("lead", [(2, 40), (2, 3, 14)], ids=["edges", "cross"])
def test_tp_backward_plain_matches_jax(layer, lead):
    tb = _tables(layer)
    x, sh, w, dct = _tp_inputs(tb, layer, lead, seed=10 + layer)
    jt = [jnp.asarray(tb[k]) for k in ("CBIG_R", "EXPW", "SUMR")]
    got = _port_bwd(tb, x, sh, w, dct, torch.float32)
    _, vjp = jax.vjp(lambda a, b, c: JTK.ref_fused_tp(a, b, c, *jt), *map(jnp.asarray, (x, sh, w)))
    want = vjp(jnp.asarray(dct))
    flat = lambda a: jnp.asarray(a.reshape(lead[0], -1, a.shape[-1]))
    call = pl.pallas_call
    try:
        JTK.pl.pallas_call = functools.partial(call, interpret=True)
        pallas = JTK._pallas_fused_tp_bwd(flat(x), flat(sh), flat(w), *jt, flat(dct))
    finally:
        JTK.pl.pallas_call = call
    for g, wj, wp, name in zip(got, want, pallas, ("dx", "dsh", "dw")):
        assert g.shape == wj.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), atol=2e-4, rtol=2e-4, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(wp).reshape(g.shape), atol=2e-4,
                                   rtol=2e-4, err_msg=name)
    # bf16: the same rounding steps as the JAX reference twin's vjp
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    got16 = _port_bwd(tb, x, sh, w, dct, torch.bfloat16)
    jt16 = [t.astype(jnp.bfloat16) for t in jt]
    _, vjp16 = jax.vjp(lambda a, b, c: JTK.ref_fused_tp(a, b, c, *jt16), bf(x), bf(sh), bf(w))
    for g, wj, name in zip(got16, vjp16(bf(dct)), ("dx", "dsh", "dw")):
        assert g.dtype == torch.bfloat16, name
        ref = np.asarray(wj.astype(jnp.float32))
        d = np.abs(g.float().numpy() - ref)
        assert d.max() <= 2e-2 * np.abs(ref).max(), (name, d.max(), np.abs(ref).max())


def _words(v):
    """(low 32 bits, f32 coefficient) of f32_bwd_tables' 64-bit words."""
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return lo, (v >> np.uint64(32)).astype(np.uint32).view(np.float32).astype(np.float64)


def _lists_bwd(fb, x, sh, w, dct, din, dsh, numel):
    """The f32 K11's loops over its packed words in numpy (float64), rows
    vectorised: dw by weight from the by-column words in dw order (TR from
    (rf, rb)), Db by CBIG_R row from the by-row words (qcol, widx), then dx
    and dsh from Db."""
    M = x.shape[0]
    dw = np.zeros((M, numel))
    lo, cf = _words(fb["etr"])
    qw = fb["qword"].astype(np.int64)
    for k in range(numel):
        for t in range(fb["kqptr"][k], fb["kqptr"][k + 1]):
            z = slice(qw[t] & 0xFFFF, qw[t + 1] & 0xFFFF)
            tr = (cf[z] * x[:, lo[z] & 0xFFFF] * sh[:, lo[z] >> 16]).sum(1)
            dw[:, k] += dct[:, qw[t] >> 16] * tr
    Db = np.zeros((M, dsh * din))
    lo, cf = _words(fb["edb"])
    for j in range(dsh * din):
        for t in range(fb["tptr"][j], fb["tptr"][j + 1]):
            Db[:, j] += cf[t] * (dct[:, lo[t] & 0xFFFF] * w[:, lo[t] >> 16])
    Db = Db.reshape(M, dsh, din)
    return (sh[:, :, None] * Db).sum(1), (x[:, None, :] * Db).sum(2), dw


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_tp_backward_lists_rebuild_autograd(layer):
    tb = _tables(layer)
    sp, fb = TK.sparse_tables(tb), TK.f32_bwd_tables(tb)
    x, sh, w, dct = (a.reshape(-1, a.shape[-1]).astype(np.float64)
                     for a in _tp_inputs(tb, layer, (1, 6), seed=20 + layer))
    assert sp["wptr"][-1] == tb["R"] and sp["tptr"][-1] == sp["nnz"]
    assert np.array_equal(np.sort(sp["wq"]), np.arange(tb["R"]))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, sh, w)]
    dense = [torch.from_numpy(tb[k]).double() for k in ("CBIG_R", "EXPW", "SUMR")]
    t = torch.cat([leaves[0] * leaves[1][:, b:b + 1] for b in range(9)], dim=-1)
    out = ((leaves[2] @ dense[1]) * (t @ dense[0])) @ dense[2]
    want = torch.autograd.grad(out, leaves, torch.from_numpy(dct))
    got = _lists_bwd(fb, x, sh, w, dct, LADDER[layer].dim, 9, tb["numel"])
    for g, wt, name in zip(got, want, ("dx", "dsh", "dw")):
        np.testing.assert_allclose(g, wt.numpy(), atol=1e-9, err_msg=name)


B, E, N, F = 2, 1100, 40, 7


def _edge_data(seed, dtype):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, (B, E)).astype(np.int32)
    mask = (rng.random((B, E)) > 0.25).astype(np.float32)
    idx[:, E // 2:] = 0                 # padding: index 0, mask 0
    mask[:, E // 2:] = 0.0
    nodes = rng.normal(size=(B, N, F)).astype(np.float32)
    msgs = rng.normal(size=(B, E, F)).astype(np.float32)
    ct_e = rng.normal(size=(B, E, F)).astype(np.float32)
    ct_n = rng.normal(size=(B, N, F)).astype(np.float32)
    return idx, mask, *(np.array(jnp.asarray(a).astype(dtype).astype(jnp.float32))
                        for a in (nodes, msgs, ct_e, ct_n))


def _jax_mean(idx, mask, msgs):
    dt = msgs.dtype
    deg = jnp.zeros((B, N)).at[jnp.arange(B)[:, None], idx].add(mask)
    return JEK.edge_aggregate(idx, mask, msgs, N) / jnp.maximum(deg, 1.0).astype(dt)[..., None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_vjps_match_jax(dtype):
    idx, mask, nodes, msgs, ct_e, ct_n = _edge_data(3, dtype)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    ji, jm = jnp.asarray(idx), jnp.asarray(mask)
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-6, rtol=2 ** -7)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    cases = [("gather", lambda n: JEK.edge_gather(ji, jm, n), nodes, ct_e,
              lambda n: EK.edge_gather(ti, tm, n)),
             ("sum", lambda m: JEK.edge_aggregate(ji, jm, m, N), msgs, ct_n,
              lambda m: EK.edge_aggregate(ti, tm, m, N)),
             ("mean", lambda m: _jax_mean(ji, jm, m), msgs, ct_n,
              lambda m: EK.edge_aggregate(ti, tm, m, N, "mean"))]
    for name, jfn, x, ct, tfn in cases:
        _, vjp = jax.vjp(jfn, jnp.asarray(x).astype(jdt))
        (want,) = vjp(jnp.asarray(ct).astype(jdt))
        leaf = torch.from_numpy(x).to(tdt).requires_grad_(True)
        (got,) = torch.autograd.grad(tfn(leaf), leaf, torch.from_numpy(ct).to(tdt))
        assert got.dtype == tdt, name
        np.testing.assert_allclose(got.float().numpy(), f32(want), err_msg=name, **tol)
        if name != "gather":   # padded edges get no gradient
            assert np.all(got.float().numpy()[mask == 0] == 0), name
    # node 0 collects only the cotangent of its valid edges
    leaf = torch.from_numpy(nodes).requires_grad_(True)
    (g,) = torch.autograd.grad(EK.edge_gather(ti, tm, leaf), leaf, torch.from_numpy(ct_e))
    want0 = [(ct_e[b] * (mask[b] * (idx[b] == 0))[:, None]).sum(0) for b in range(B)]
    np.testing.assert_allclose(g.numpy()[:, 0], np.stack(want0), **tol)


def test_edge_ops_keep_a_csr_per_index():
    rng = np.random.default_rng(4)
    src = rng.integers(0, 8, (B, 300))              # src crowded on 8 nodes
    dst = rng.integers(0, N, (B, 300))              # dst spread over all
    edges = np.stack([src, dst], -1).astype(np.int32)
    mask = rng.random((B, 300)) > 0.2
    ops = EdgeOps(torch.from_numpy(edges), torch.from_numpy(mask), N)
    nodes = torch.from_numpy(rng.normal(size=(B, N, F)).astype(np.float32)).requires_grad_(True)
    ct = rng.normal(size=(B, 300, F)).astype(np.float32)
    (g,) = torch.autograd.grad(ops.gather_dst(nodes), nodes, torch.from_numpy(ct))
    flat = (ct * mask[..., None]).reshape(B * 300, F)

    def csr_sum(which):
        ptr, order = (a.numpy() for a in ops.csr(which))
        return np.stack([flat[order[ptr[i]:ptr[i + 1]]].sum(0)
                         for i in range(B * N)]).reshape(B, N, F)

    np.testing.assert_allclose(csr_sum("dst"), g.numpy(), atol=1e-5, rtol=1e-5)
    assert not np.allclose(csr_sum("src"), g.numpy(), atol=1e-3)
    assert ops.csr("dst") is ops.csr("dst")         # built once
