"""Pair-fused sampling: K7's plain version (`ref_edge_then_sum`, which
`fused_edge_then_sum` runs on CPU tensors) against the JAX package's
`fused_edge_then_sum`, and the port's `denoise(fuse_pairs=True)` against
JAX's and against the port's unfused `denoise`, in f32 on the CPU.

Tolerances: K7 at H 128 as the JAX package holds its own kernel against its
plain composition (tests/test_kernels.py:767-799): f32 atol 2e-4. The fused
`denoise` at atol 1e-5 (tests/test_kernels.py:802-833: the fused path casts
h_E where the unfused one does, so in f32 only the order of sums differs),
at small width (B2, L16, K8, H16)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from _torch_parity import ca_inputs, denoiser_pair, exact_gathers, jax_apply, t
from codlad_tpu.kernels import mpnn_kernels as JK
from codlad_tpu_torch.kernels import mpnn_kernels as TK

H = 128
SMALL = dict(hidden_dim=16, edge_features=16, num_encoder_layers=3, num_decoder_layers=2,
             k_neighbors=8)


def _pair_inputs(B=2, L=16, N=16, K=8, seed=0):
    """The operands of fused_edge_then_sum, in its argument order."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    w = lambda: [f(H, H, sc=H ** -0.5), f(H, H, sc=H ** -0.5), f(H, sc=0.1),
                 f(H, H, sc=H ** -0.5), f(H, sc=0.1)]
    idx = rng.integers(0, N, size=(B, L, K)).astype(np.int32)
    edge = [f(B, L, H), f(B, L, K, H), f(B, N, H), idx, *w(),
            f(B, H, sc=0.3), f(B, H, sc=0.3), f(B, H)]
    node = [f(B, L, H), f(B, N, H), *w(), (rng.random((B, L, K)) > 0.2).astype(np.float32)]
    return edge + node


@pytest.mark.parametrize("jax_mode,N", [("plain", 16), ("plain", 24), ("interpret", 16)])
def test_edge_then_sum_matches_jax(monkeypatch, jax_mode, N):
    """JAX on its plain path, and its Pallas kernel interpreted (which takes
    a table as long as the rows only)."""
    if jax_mode == "interpret":
        monkeypatch.setattr(JK.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
        monkeypatch.setattr(JK, "_use_pallas", lambda: True)
    x = _pair_inputs(N=N, seed=N)
    j = [jnp.asarray(a) for a in x]
    e2_j, ns_j = JK.fused_edge_then_sum(*j[:4], None, *j[4:], 30.0)
    TK.reset_launches()
    e2, ns = TK.fused_edge_then_sum(*(t(a) for a in x), 30.0)
    assert e2.dtype == torch.float32 and ns.dtype == torch.float32
    assert not any(TK.LAUNCHES.values())
    np.testing.assert_allclose(e2.numpy(), np.asarray(e2_j), atol=2e-4)
    np.testing.assert_allclose(ns.numpy(), np.asarray(ns_j), atol=2e-4)


def test_edge_then_sum_is_k2_then_k1():
    """K7's plain version is K2's plain version followed by K1's, bf16 too
    (e2 is cast to E's dtype before the node chain reads it)."""
    x = [t(a) for a in _pair_inputs(seed=3)]
    x[1] = x[1].to(torch.bfloat16)
    e2, ns = TK.fused_edge_then_sum(*x, 30.0)
    want_e2 = TK.fused_message_edge_lnmod(*x[:12])
    want_ns = TK.fused_message_sum(x[12], want_e2, x[13], x[3], x[19], *x[14:19], 30.0)
    assert e2.dtype == torch.bfloat16 and torch.equal(e2, want_e2)
    assert torch.equal(ns, want_ns)


def test_edge_then_sum_has_no_backward():
    x = [t(a) for a in _pair_inputs(seed=4)]
    x[4].requires_grad_(True)
    with pytest.raises(RuntimeError):
        TK.fused_edge_then_sum(*x, 30.0)
    with torch.no_grad():
        TK.fused_edge_then_sum(*x, 30.0)


@pytest.fixture(scope="module")
def denoisers():
    res_type, cg, mask = ca_inputs(7, 2, 16, n_valid=[16, 12])
    with pytest.MonkeyPatch.context() as mp:
        exact_gathers(mp)
        model, params, port = denoiser_pair(2, res_type, cg, mask, **SMALL)
        cond = jax_apply(model, params, res_type, cg, mask,
                         method=type(model).compute_condition)
    x = np.random.default_rng(8).normal(size=(2, 16, 3)).astype(np.float32)
    steps = np.array([0, 731], np.int32)
    jc = {"idx": t(cond["nbr"]["idx"]), "h_E0": t(cond["h_E0"]), "h_S": t(cond["h_S"]),
          "maskf": t(cond["maskf"]), "mask_attend": t(cond["mask_attend"])}
    return model, params, port, cond, jc, x, steps


def test_fused_denoise_matches_jax_and_the_unfused_path(denoisers):
    model, params, port, cond, jc, x, steps = denoisers
    want = jax_apply(model, params, x, steps, cond, deterministic=True, fuse_pairs=True,
                     method=type(model).denoise)
    with torch.no_grad():
        fused = port.denoise(t(x), t(steps), jc, fuse_pairs=True)
        unfused = port.denoise(t(x), t(steps), jc)
    np.testing.assert_allclose(fused.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), atol=1e-5)


def test_fused_denoise_takes_the_unfused_path_where_jax_does(denoisers):
    """Dropout on (deterministic=False): the unfused path runs, bit for bit;
    with grad enabled the fused path refuses to run (K7 has no backward)."""
    _, _, port, _, jc, x, steps = denoisers
    port.train()
    with torch.no_grad():
        a = port.denoise(t(x), t(steps), jc, deterministic=False, dropout_seed=3,
                         fuse_pairs=True)
        b = port.denoise(t(x), t(steps), jc, deterministic=False, dropout_seed=3)
    port.eval()
    assert torch.equal(a, b)
    with pytest.raises(RuntimeError):
        port.denoise(t(x), t(steps), jc, fuse_pairs=True)
