"""K6 of the port (`fused_message_edge`: the raw per-edge messages of the
adaLN `residual` encoder, and their backward) against the JAX package's
`fused_message_edge`, in f32 on the CPU at H 128.

JAX runs its plain path (`_ref_message`) and, with its Pallas kernels forced
into interpret mode as tests/test_kernels.py does, `_pallas_message_edge` and
`_pallas_edge_bwd` themselves. The port runs its plain version under
autograd (a CPU tensor never reaches the CUDA kernel).

Tolerance: atol 1e-5 + rtol 1e-5 on the messages; each grad atol 1e-5 *
max(1, max|grad|) + rtol 1e-5, since a weight grad sums every edge row and
an element near zero is the difference of terms as large as the largest.
Both sides compute the same f32 function; only the order of the sums
differs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_parity import t
from codlad_tpu.kernels import mpnn_kernels as JK
from codlad_tpu_torch.kernels import mpnn_kernels as TK

H = 128
KEYS = ("A", "E", "Gn", "idx", "W_e", "W2", "b2", "W3", "b3")
DIFF = ("A", "E", "Gn", "W_e", "W2", "b2", "W3", "b3")


def _inputs(B=2, L=16, N=16, K=8, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return dict(A=f(B, L, H), E=f(B, L, K, H), Gn=f(B, N, H),
                idx=rng.integers(0, N, size=(B, L, K)).astype(np.int32),
                W_e=f(H, H, sc=H ** -0.5), W2=f(H, H, sc=H ** -0.5), b2=f(H, sc=0.1),
                W3=f(H, H, sc=H ** -0.5), b3=f(H, sc=0.1))


def _force_interpret(monkeypatch):
    """Run JAX's Pallas kernels (forward and backward) interpreted on the CPU."""
    monkeypatch.setattr(JK.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(JK, "_use_pallas", lambda: True)


def _jax(x, ct):
    """(messages, grads of <messages, ct> in DIFF order) of JAX's K6."""
    idx = jnp.asarray(x["idx"])

    def f(A, E, Gn, W_e, W2, b2, W3, b3):
        return JK.fused_message_edge(A, E, Gn, idx, None, W_e, W2, b2, W3, b3)

    out, vjp = jax.vjp(f, *(jnp.asarray(x[k]) for k in DIFF))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _port(x, ct):
    leaves = {k: t(x[k]).requires_grad_(k in DIFF) for k in KEYS}
    out = TK.fused_message_edge(*(leaves[k] for k in KEYS))
    gs = torch.autograd.grad(out, [leaves[k] for k in DIFF], t(ct))
    return out.detach().numpy(), [g.numpy() for g in gs]


# N > L: a gather table longer than the rows; JAX's Pallas backward takes
# N == L only (its dGn block is [1, L, H]), so interpret mode runs at N = L
@pytest.mark.parametrize("jax_mode,N", [("plain", 16), ("plain", 24), ("interpret", 16)])
def test_message_edge_forward_and_grads_match_jax(monkeypatch, jax_mode, N):
    if jax_mode == "interpret":
        _force_interpret(monkeypatch)
    x = _inputs(N=N, seed=N)
    ct = np.random.default_rng(1).normal(size=x["E"].shape).astype(np.float32)
    got, want = _port(x, ct), _jax(x, ct)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=1e-5)
    for name, g, w in zip(DIFF, got[1], want[1]):
        atol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, err_msg=f"{jax_mode} d{name}", atol=atol,
                                   rtol=1e-5)


def test_message_edge_keeps_the_edge_dtype_and_counts_no_launch():
    """The messages come out in E's dtype (JAX: `.astype(E.dtype)`), and the
    grads in their operands' dtypes; the plain path on CPU tensors launches
    nothing."""
    x = _inputs(seed=3)
    TK.reset_launches()
    leaves = {k: t(x[k]) for k in KEYS}
    leaves["E"] = leaves["E"].to(torch.bfloat16).requires_grad_(True)
    leaves["W3"] = leaves["W3"].requires_grad_(True)
    out = TK.fused_message_edge(*(leaves[k] for k in KEYS))
    assert out.dtype == torch.bfloat16 and out.shape == leaves["E"].shape
    dE, dW3 = torch.autograd.grad(out.float().sum(), [leaves["E"], leaves["W3"]])
    assert dE.dtype == torch.bfloat16 and dW3.dtype == torch.float32
    assert {"fused_message_edge", "fused_message_edge_bwd"} <= set(TK.LAUNCHES)
    assert TK.LAUNCHES == dict.fromkeys(TK.LAUNCHES, 0)


def test_message_edge_refuses_a_tensor_off_the_cpu():
    """Off the CPU the wrapper launches or raises; a meta tensor must raise."""
    x = {k: t(v).to("meta") for k, v in _inputs(seed=4).items()}
    with pytest.raises(ValueError):
        TK.fused_message_edge(*(x[k] for k in KEYS))
