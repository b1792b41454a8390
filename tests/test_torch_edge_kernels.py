"""K8 edge_gather and K9 edge_aggregate: the port's plain versions (the CPU
path of its wrappers) against the JAX package's Pallas kernels in interpret
mode and against its pure-JAX twins, on the same numpy inputs; the CSR the
card's aggregate reads; EdgeOps against the JAX DenseEdgeOps, mean included.

Tolerances: gathers are index reads, so f32 and bf16 are compared exactly
against `_ref_gather`; the Pallas gather splits f32 payloads hi/lo for the
TPU's matrix unit, so against it f32 is held at atol 5e-5 + rtol 2e-5, as
tests/test_edge_kernels.py holds it. Aggregates sum in f32 in another order:
f32 atol 1e-5 + rtol 1e-5 (atol 5e-5 + rtol 2e-5 against the Pallas kernel,
for its hi/lo split); bf16 outputs (sums cast to bf16) within one bf16 ulp,
rtol 2^-7, + atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codlad_tpu.kernels import edge_kernels as JEK
from codlad_tpu.nn.graph import make_edge_ops
from codlad_tpu_torch.kernels import edge_kernels as EK
from codlad_tpu_torch.nn.graph import EdgeOps

# E = 1100 is not a multiple of the JAX kernels' 1024-edge tile
B, E, N, F = 2, 1100, 40, 7


def _data(seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N, (B, E)).astype(np.int32)
    mask = (rng.random((B, E)) > 0.25).astype(np.float32)
    nodes = rng.normal(size=(B, N, F)).astype(np.float32)
    msgs = rng.normal(size=(B, E, F)).astype(np.float32)
    return idx, mask, nodes, msgs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_matches_jax(dtype):
    idx, mask, nodes, _ = _data(0)
    got = EK.edge_gather(torch.from_numpy(idx), torch.from_numpy(mask),
                         torch.from_numpy(nodes).to(getattr(torch, dtype)))
    jn = jnp.asarray(nodes).astype(dtype)
    want = np.asarray(JEK._ref_gather(jnp.asarray(idx), jnp.asarray(mask), jn).astype(jnp.float32))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, E, F)
    np.testing.assert_array_equal(got.float().numpy(), want)
    pallas = JEK._pallas_gather(jnp.asarray(idx), jnp.asarray(mask), jn, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas.astype(jnp.float32)),
                               atol=5e-5, rtol=2e-5)
    assert np.all(got.float().numpy()[mask == 0] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aggregate_matches_jax(dtype):
    idx, mask, _, msgs = _data(1)
    tdt = getattr(torch, dtype)
    got = EK.edge_aggregate(torch.from_numpy(idx), torch.from_numpy(mask),
                            torch.from_numpy(msgs).to(tdt), N)
    jm = jnp.asarray(msgs).astype(dtype)
    args = (jnp.asarray(idx), jnp.asarray(mask), jm, N)
    assert got.dtype == tdt and got.shape == (B, N, F)
    bf16 = dict(atol=1e-6, rtol=2 ** -7)
    for want, tol in ((JEK._ref_aggregate(*args), dict(atol=1e-5, rtol=1e-5)),
                      (JEK._pallas_aggregate(*args, interpret=True), dict(atol=5e-5, rtol=2e-5))):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   **(tol if dtype == "float32" else bf16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_edge_ops_match_dense_edge_ops(dtype):
    """gather_src / gather_dst / aggregate_to_src (sum and mean) against the
    JAX DenseEdgeOps that its encoder uses off the TPU. The mean divides by
    the count of VALID edges: half the edges here are padding that points at
    node 0 with mask 0, which a degree over all edges would count."""
    rng = np.random.default_rng(2)
    edges = rng.integers(0, N, (B, E, 2)).astype(np.int32)
    mask = rng.random((B, E)) > 0.25
    edges[:, E // 2:] = 0
    mask[:, E // 2:] = False
    nodes = rng.normal(size=(B, N, F)).astype(np.float32)
    msgs = rng.normal(size=(B, E, F)).astype(np.float32)
    tdt = getattr(torch, dtype)
    ops = EdgeOps(torch.from_numpy(edges), torch.from_numpy(mask), N)
    jops = make_edge_ops(jnp.asarray(edges), jnp.asarray(mask), N, dtype=jnp.float32)
    jn, jm = jnp.asarray(nodes).astype(dtype), jnp.asarray(msgs).astype(dtype)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    tn, tm = torch.from_numpy(nodes).to(tdt), torch.from_numpy(msgs).to(tdt)
    np.testing.assert_array_equal(ops.gather_src(tn).float().numpy(), f32(jops.gather_src(jn)))
    np.testing.assert_array_equal(ops.gather_dst(tn).float().numpy(), f32(jops.gather_dst(jn)))
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-6, rtol=2 ** -7)
    for reduce in ("sum", "mean"):
        got = ops.aggregate_to_src(tm, reduce=reduce)
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   f32(jops.aggregate_to_src(jm, reduce=reduce)), **tol)


def test_csr_lists_each_nodes_valid_edges_in_order():
    """build_csr (the card's aggregate input, built here on the CPU): node n
    of sample b lists exactly the flat ids b*E + e of its valid edges, in
    increasing order; masked edges appear nowhere."""
    idx, mask, _, msgs = _data(3)
    ptr, order = EK.build_csr(torch.from_numpy(idx), torch.from_numpy(mask), N)
    ptr, order = ptr.numpy(), order.numpy()
    assert ptr.shape == (B * N + 1,) and ptr[-1] == int(mask.sum()) == order.size
    for b in range(B):
        for n in range(N):
            want = [b * E + e for e in range(E) if idx[b, e] == n and mask[b, e]]
            assert order[ptr[b * N + n]:ptr[b * N + n + 1]].tolist() == want
    # the CSR sum in its order equals the plain aggregate
    flat = msgs.reshape(B * E, F) * mask.reshape(-1, 1)
    csr_sum = np.stack([flat[order[ptr[i]:ptr[i + 1]]].sum(0) for i in range(B * N)])
    plain = EK.ref_aggregate(torch.from_numpy(idx), torch.from_numpy(mask),
                             torch.from_numpy(msgs), N)
    np.testing.assert_allclose(csr_sum.reshape(B, N, F), plain.numpy(), atol=1e-5, rtol=1e-5)
