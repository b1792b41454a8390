"""K9 (edge aggregate) in the card's summation order, on the CPU.

csrc/edge_ops.cu's `aggregate_kernel` sums a node's listed edges (the CSR
of `build_csr`) in S sub-slots of a group of W lanes, U rows in flight a
sub-slot, then adds the sub-slots through a fixed tree of warp shuffles,
casts, and for "mean" divides by the cast degree (`aggregate_layout` picks
V, C, S and W from F and the dtype). `csr_order_aggregate`
(tests/_torch_aggregate_order.py) repeats that order in torch; here it is
held:

* bit for bit against `simulate_kernel` below, which walks the kernel's
  loops lane by lane (groups, W-id chunks, rounds, passes over C > W
  chunks, the shuffle trees) on numpy float32 scalars;
* against the JAX package's Pallas `_pallas_aggregate` in interpret mode
  (the mean as its FastEdgeOps takes it: the degree as one more payload
  lane, then s / max(deg, 1) in the payload dtype), at F 12, 36 and 48, in
  both dtypes, with sum and mean, on graphs with nodes of degree 0 and a
  node of more than 64 edges (more than one W-id chunk at every W): f32
  within atol 2e-4 + rtol 2e-4, bf16 within 2e-2 of max|ref|, as the other
  tile tests hold theirs (the orders of the f32 sums differ);
* as a function of each node's edge list alone: relabelling the nodes, or
  storing the edges in another order that keeps each node's list, gives
  the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_aggregate_order import aggregate_layout, csr_order_aggregate
from codlad_tpu.kernels import edge_kernels as JEK
from codlad_tpu_torch.kernels import edge_kernels as EK

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}
F32 = np.float32


def _graph(seed, B=2, E=1100, N=40):
    """idx [B, E], 0/1 mask [B, E]: node 3 of sample 0 takes 90 edges, nodes
    N - 4 .. N - 1 take none, a quarter of the edges are masked."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N - 4, (B, E)).astype(np.int32)
    idx[0, :90] = 3
    mask = (rng.random((B, E)) > 0.25).astype(np.float32)
    mask[0, :90] = 1.0
    return idx, mask, N


def simulate_kernel(csr, mask, msgs, n_nodes, reduce):
    """aggregate_kernel's loops, lane by lane, in numpy float32 (masks are 0
    or 1, so fmaf(m, v, acc) is acc + m v rounded once)."""
    B, E, F = msgs.shape
    V, C, S, W = aggregate_layout(F, msgs.element_size())
    CL = min(C, W)
    P = 1
    while P < S:
        P *= 2
    ptr, edges = csr[0].numpy(), csr[1].numpy()
    m_all = mask.reshape(-1).numpy().astype(F32)
    x = msgs.reshape(-1, F).float().numpy()
    rnd = lambda v: torch.tensor(v).to(msgs.dtype).float().numpy()
    out = np.zeros((ptr.size - 1, F), dtype=F32)
    for node in range(ptr.size - 1):
        begin, end = int(ptr[node]), int(ptr[node + 1])
        deg = [F32(0)] * W
        npass = -(-C // CL)
        for pss in range(npass):
            acc = np.zeros((W, V), dtype=F32)
            for base in range(begin, end, W):
                n = min(W, end - base)
                eid = [int(edges[base + gl]) if gl < n else 0 for gl in range(W)]
                m = [m_all[eid[gl]] if gl < n else F32(0) for gl in range(W)]
                if pss == 0:
                    deg = [deg[gl] + m[gl] for gl in range(W)]
                for t in range(-(-n // S)):
                    for gl in range(W):
                        sub, c0 = divmod(gl, CL)
                        chunk, j = c0 + pss * CL, t * S + sub
                        if sub < S and chunk < C and j < n:
                            row = x[eid[j], chunk * V:chunk * V + V]
                            acc[gl] = acc[gl] + m[j] * row
            off = P // 2
            while off:
                new = acc.copy()
                for gl in range(W):
                    if gl // CL + off < S:
                        new[gl] = acc[gl] + acc[gl + off * CL]
                acc, off = new, off // 2
            if pss == 0:
                off = W // 2
                while off:
                    deg = [deg[gl] + deg[gl + off] if gl + off < W else deg[gl] + deg[gl]
                           for gl in range(W)]
                    off //= 2
            denom = max(rnd(deg[0]), F32(1))
            for c0 in range(CL):
                chunk = c0 + pss * CL
                if chunk < C:
                    v = rnd(acc[c0])
                    out[node, chunk * V:chunk * V + V] = v / denom if reduce == "mean" else v
    return torch.from_numpy(out).to(msgs.dtype).reshape(B, n_nodes, F)


def _jax_aggregate(idx, mask, msgs, n_nodes, reduce, jdt):
    """The interpreted Pallas K9, the mean as FastEdgeOps.aggregate_to_src
    takes it (codlad_tpu/nn/graph.py)."""
    jm = jnp.asarray(msgs).astype(jdt)
    args = (jnp.asarray(idx), jnp.asarray(mask))
    if reduce == "sum":
        return JEK._pallas_aggregate(*args, jm, n_nodes, interpret=True)
    ones = jnp.ones(jm.shape[:2] + (1,), jdt)
    out = JEK._pallas_aggregate(*args, jnp.concatenate([jm, ones], axis=-1), n_nodes,
                                interpret=True)
    return (out[..., :-1] / jnp.maximum(out[..., -1:], 1.0)).astype(jdt)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("F", [12, 36, 48])
def test_aggregate_order_matches_pallas(F, dname, reduce):
    tdt, jdt = DTYPES[dname]
    idx, mask, N = _graph(F)
    msgs = np.random.default_rng(100 + F).normal(size=idx.shape + (F,)).astype(np.float32)
    tm = torch.from_numpy(msgs).to(tdt)
    csr = EK.build_csr(torch.from_numpy(idx), torch.from_numpy(mask), N)
    assert int((csr[0][1:] - csr[0][:-1]).max()) > 64
    assert int((csr[0][1:] - csr[0][:-1]).min()) == 0
    got = csr_order_aggregate(csr, torch.from_numpy(mask), tm, N, reduce)
    want = np.asarray(_jax_aggregate(idx, mask, msgs, N, reduce, jdt).astype(jnp.float32))
    assert got.dtype == tdt and got.shape == want.shape
    d = np.abs(got.float().numpy() - want)
    if dname == "float32":
        assert np.all(d <= 2e-4 + 2e-4 * np.abs(want)), d.max()
    else:
        assert d.max() <= 2e-2 * np.abs(want).max(), (d.max(), np.abs(want).max())


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
@pytest.mark.parametrize("F", [3, 12, 36, 48, 130])
def test_order_emulation_is_the_kernels_loop(F, dname):
    """csr_order_aggregate equals the lane-by-lane walk of the kernel bit
    for bit, sum and mean (F 3: two nodes a warp; F 130: more than one
    pass over the row's chunks)."""
    tdt = DTYPES[dname][0]
    idx, mask, N = _graph(7, B=1, E=300, N=12)
    msgs = torch.from_numpy(np.random.default_rng(F).normal(size=(1, 300, F))
                            .astype(np.float32)).to(tdt)
    csr = EK.build_csr(torch.from_numpy(idx), torch.from_numpy(mask), N)
    for reduce in ("sum", "mean"):
        got = csr_order_aggregate(csr, torch.from_numpy(mask), msgs, N, reduce)
        assert torch.equal(got, simulate_kernel(csr, torch.from_numpy(mask), msgs, N, reduce))


@pytest.mark.parametrize("dname", ["bfloat16", "float32"])
def test_order_depends_only_on_each_nodes_list(dname):
    """Relabelling the nodes, or storing the edges in another order that
    keeps each node's list (a stable sort by node), moves each node's output
    with it, bit for bit: the order is a function of the CSR alone."""
    tdt = DTYPES[dname][0]
    idx, mask, N = _graph(11)
    F = 48
    msgs = torch.from_numpy(np.random.default_rng(5).normal(size=idx.shape + (F,))
                            .astype(np.float32)).to(tdt)
    t_idx, t_mask = torch.from_numpy(idx), torch.from_numpy(mask)
    base = csr_order_aggregate(EK.build_csr(t_idx, t_mask, N), t_mask, msgs, N, "mean")
    perm = torch.from_numpy(np.random.default_rng(6).permutation(N))
    relab = csr_order_aggregate(EK.build_csr(perm[t_idx.long()].int(), t_mask, N), t_mask,
                                   msgs, N, "mean")
    assert torch.equal(relab[:, perm], base)
    order = torch.sort(t_idx, dim=1, stable=True).indices
    take = lambda a: torch.take_along_dim(a, order if a.dim() == 2 else order[..., None], 1)
    s_idx, s_mask, s_msgs = take(t_idx), take(t_mask), take(msgs)
    moved = csr_order_aggregate(EK.build_csr(s_idx, s_mask, N), s_mask, s_msgs, N, "mean")
    assert torch.equal(moved, base)


def test_layout_fits_a_group():
    """Every F and dtype: V divides F in 16-, 8- or 4-byte vectors (else
    single elements), the S sub-slots of min(C, W) lanes fit the group, W
    is a power of two, a group keeps at least 4 sub-slots where the row is
    narrow enough, and W depends on nothing but F and the element size."""
    for itemsize in (2, 4):
        for F in range(1, 200):
            V, C, S, W = aggregate_layout(F, itemsize)
            assert V * C == F and V * itemsize in ((16, 8, 4, itemsize))
            assert W in (4, 8, 16, 32) and S * min(C, W) <= W and S >= 1
            if 4 * C <= 32:
                assert S >= 4
