"""K1/K2 plain versions (torch port) against the JAX package's reference
message chains, in f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t
from codlad_tpu.kernels import mpnn_kernels as JK
from codlad_tpu_torch.kernels import mpnn_kernels as TK


def _inputs(B=2, L=12, N=12, K=8, H=32, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return dict(A=f(B, L, H), E=f(B, L, K, H), Gn=f(B, N, H),
                idx=rng.integers(0, N, size=(B, L, K)).astype(np.int32),
                mask=(rng.random((B, L, K)) > 0.2).astype(np.float32),
                W_e=f(H, H, sc=0.2), W2=f(H, H, sc=0.2), b2=f(H, sc=0.1),
                W3=f(H, H, sc=0.2), b3=f(H, sc=0.1),
                sh=f(B, H, sc=0.3), sc=f(B, H, sc=0.3), g=f(B, H))


_CHAIN = ("A", "E", "Gn", "idx")
_W = ("W_e", "W2", "b2", "W3", "b3")


@pytest.mark.parametrize("N", [12, 20])  # N != L: a gather table longer than the rows
def test_message_sum_plain_matches_jax(N):
    x = _inputs(N=N)
    want = JK._ref_message_sum(*(jnp.asarray(x[k]) for k in _CHAIN + ("mask",) + _W), 30.0)
    got = TK.fused_message_sum(*(t(x[k]) for k in _CHAIN + ("mask",) + _W), 30.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("N", [12, 20])
def test_message_edge_lnmod_plain_matches_jax(N):
    x = _inputs(N=N, seed=1)
    keys = _CHAIN + _W + ("sh", "sc", "g")
    want = JK._ref_message_edge_lnmod(*(jnp.asarray(x[k]) for k in keys))
    got = TK.fused_message_edge_lnmod(*(t(x[k]) for k in keys))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_plain_versions_keep_the_edge_dtype_and_count_no_launch():
    """K1 returns f32 and K2 the dtype of E (mpnn_kernels.py:128,142); the
    plain path on CPU tensors launches nothing."""
    x = _inputs(seed=2)
    TK.reset_launches()
    E = t(x["E"]).to(torch.bfloat16)
    s = TK.fused_message_sum(t(x["A"]), E, t(x["Gn"]), t(x["idx"]), t(x["mask"]),
                             *(t(x[k]) for k in _W), 30.0)
    e = TK.fused_message_edge_lnmod(t(x["A"]), E, t(x["Gn"]), t(x["idx"]),
                                    *(t(x[k]) for k in _W + ("sh", "sc", "g")))
    assert s.dtype == torch.float32 and e.dtype == torch.bfloat16
    assert {"fused_message_sum", "fused_message_edge_lnmod"} <= set(TK.LAUNCHES)
    assert TK.LAUNCHES == dict.fromkeys(TK.LAUNCHES, 0)


def test_kernel_wrapper_refuses_tensors_it_cannot_take():
    """Off the CPU the wrapper launches or raises; here there is no card,
    so a tensor on the meta device must raise, not fall back."""
    x = _inputs(seed=3)
    meta = {k: t(v).to("meta") for k, v in x.items()}
    with pytest.raises(ValueError):
        TK.fused_message_sum(*(meta[k] for k in _CHAIN + ("mask",) + _W), 30.0)


@pytest.mark.parametrize("K", [16, 32, 48, 64])
@pytest.mark.parametrize("rows,per_thread", [(128, 8), (64, 4), (128, 16)],
                         ids=["fwd-bf16", "fwd-f32-and-bwd", "k1-bf16-tensor-cores"])
def test_kernels_take_every_k_the_featurizer_gives(K, rows, per_thread):
    """K = min(64, L) with L a multiple of 16: every such K fits every row
    tile of the forward and backward kernels, 48 included (a block then
    owns a partial tile: floor(rows / K) residues, its other rows idle),
    and the 16-row warp slabs of the tensor-core K1."""
    TK.check_neighbours(K, rows, per_thread)


@pytest.mark.parametrize("K", [12, 65, 0])
def test_kernels_refuse_a_k_they_cannot_tile(K):
    with pytest.raises(ValueError):
        TK.check_neighbours(K, 64, 4 if K != 12 else 8)
