"""Gradients of the K1/K2/K5 wrappers (the plain versions under autograd on
the CPU) against jax.vjp of the JAX package's public kernels, in f32, and
the dropout generator that K5's kernels share with the plain version.

Tolerance (f32, the same function in both; only the order of the sums
differs): outputs atol 1e-5 + rtol 1e-5; each grad atol 1e-5 * max(1,
max|grad|) + rtol 1e-5, since a weight grad sums every edge row and an
element near zero is the difference of terms as large as the largest."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t
from codlad_tpu.kernels import mpnn_kernels as JK
from codlad_tpu_torch.kernels import mpnn_kernels as TK

_W = ("W_e", "W2", "b2", "W3", "b3")
_MOD = ("sh", "sc", "g")
_DIFF = ("A", "E", "Gn") + _W  # differentiable operands of K1
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(B=2, L=12, N=12, K=8, H=32, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return dict(A=f(B, L, H), E=f(B, L, K, H), Gn=f(B, N, H),
                idx=rng.integers(0, N, size=(B, L, K)).astype(np.int32),
                mask=(rng.random((B, L, K)) > 0.2).astype(np.float32),
                W_e=f(H, H, sc=0.2), W2=f(H, H, sc=0.2), b2=f(H, sc=0.1),
                W3=f(H, H, sc=0.2), b3=f(H, sc=0.1),
                sh=f(B, H, sc=0.3), sc=f(B, H, sc=0.3), g=f(B, H))


def _torch_grads(fn, x, keys, diff, ct):
    leaves = {k: t(x[k]).requires_grad_(k in diff) for k in keys}
    out = fn(*(leaves[k] for k in keys))
    gs = torch.autograd.grad(out, [leaves[k] for k in diff], t(ct))
    return out.detach().numpy(), [g.numpy() for g in gs]


def _jax_grads(fn, x, keys, diff, ct):
    const = {k: jnp.asarray(x[k]) for k in keys if k not in diff}

    def f(*d):
        args = dict(const, **dict(zip(diff, d)))
        return fn(*(args[k] for k in keys))

    out, vjp = jax.vjp(f, *(jnp.asarray(x[k]) for k in diff))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


def _check(got, want, names):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for name, g, w in zip(names, got[1], want[1]):
        atol = 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, err_msg=name, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("N", [12, 20])  # N > L: a gather table longer than the rows
def test_message_sum_grads_match_jax(N):
    x = _inputs(N=N)
    ct = np.random.default_rng(5).normal(size=(2, 12, 32)).astype(np.float32)
    keys = ("A", "E", "Gn", "idx", "mask") + _W
    got = _torch_grads(lambda *a: TK.fused_message_sum(*a, 30.0), x, keys, _DIFF, ct)
    want = _jax_grads(lambda A, E, Gn, idx, mask, *w: JK.fused_message_sum(
        A, E, Gn, idx, None, mask, *w, 30.0), x, keys, _DIFF, ct)
    _check(got, want, _DIFF)


@pytest.mark.parametrize("N", [12, 20])
def test_message_edge_lnmod_grads_match_jax(N):
    x = _inputs(N=N, seed=1)
    ct = np.random.default_rng(6).normal(size=(2, 12, 8, 32)).astype(np.float32)
    keys = ("A", "E", "Gn", "idx") + _W + _MOD
    diff = _DIFF + _MOD
    got = _torch_grads(TK.fused_message_edge_lnmod, x, keys, diff, ct)
    want = _jax_grads(lambda A, E, Gn, idx, *r: JK.fused_message_edge_lnmod(
        A, E, Gn, idx, None, *r), x, keys, diff, ct)
    _check(got, want, diff)


def test_keep_variant_matches_jax_forward_and_grads():
    """K5 with an explicit mask against fused_message_edge_lnmod_drop."""
    x = _inputs(N=15, seed=2)
    rng = np.random.default_rng(7)
    x["keep"] = ((rng.random((2, 12, 8, 32)) > 0.6) / 0.4).astype(np.float32)
    ct = rng.normal(size=(2, 12, 8, 32)).astype(np.float32)
    keys = ("A", "E", "Gn", "idx") + _W + _MOD + ("keep",)
    diff = _DIFF + _MOD
    got = _torch_grads(TK.fused_message_edge_lnmod_drop, x, keys, diff, ct)
    want = _jax_grads(lambda A, E, Gn, idx, *r: JK.fused_message_edge_lnmod_drop(
        A, E, Gn, idx, None, *r), x, keys, diff, ct)
    _check(got, want, diff)


def _python_bits(seed, b, i):
    """The counter hash of csrc/chain_common.cuh in plain Python integers."""
    m = 0xFFFFFFFF

    def lowbias32(v):
        v ^= v >> 16
        v = (v * 0x7FEB352D) & m
        v ^= v >> 15
        v = (v * 0x846CA68B) & m
        return v ^ (v >> 16)

    key = lowbias32((seed & m) ^ lowbias32((b + 0x9E3779B9) & m))
    return lowbias32((lowbias32(i ^ key) + key) & m)


def test_dropout_generator_is_the_kernels_hash():
    """keep_bits equals the hash in plain integers (the CUDA kernels' uint32
    arithmetic), for negative, large and small seeds and large indices."""
    seeds = torch.tensor([0, -1, 2 ** 31 - 1, 12345], dtype=torch.int32)
    bits = TK.keep_bits(seeds, 3000)
    for b in range(4):
        for i in (0, 1, 2, 17, 2047, 2999):
            assert int(bits[b, i]) == _python_bits(int(seeds[b]), b, i)


def test_dropout_generator_determinism_rate_and_samples():
    """Same seeds give the same mask; samples differ even with equal seeds;
    the keep fraction at p=0.6 over 2M elements is 0.4 +/- 0.002 (4.5
    standard deviations of a fair Bernoulli draw)."""
    p, shape = 0.6, (64, 32, 64)
    seeds = torch.tensor([7, 7, 99, -3], dtype=torch.int32)
    k1 = TK.keep_scales(seeds, shape, p)
    assert torch.equal(k1, TK.keep_scales(seeds, shape, p))
    assert set(k1.unique().tolist()) == {0.0, 2.5}
    assert not torch.equal(k1[0], k1[1]) and not torch.equal(k1[0], k1[2])
    frac = (k1 > 0).float().mean().item()
    assert abs(frac - (1 - p)) < 0.002, frac
    assert TK.drop_threshold(p) == int(0.6 * 2 ** 32)


def test_pdrop_uses_the_generator_and_p0_falls_through(monkeypatch):
    """fused_message_edge_lnmod_pdrop: with p > 0 the plain version is K2's
    with the generator's mask (seed-dependent); p = 0 calls K2 itself and
    counts no launch."""
    x = _inputs(seed=3)
    keys = ("A", "E", "Gn", "idx") + _W + _MOD
    args = [t(x[k]) for k in keys]
    seeds = torch.tensor([3, 4], dtype=torch.int32)
    out = TK.fused_message_edge_lnmod_pdrop(*args, seeds, 0.6)
    keep = TK.keep_scales(seeds, (12, 8, 32), 0.6)
    torch.testing.assert_close(out, TK.ref_message_edge_lnmod(*args, keep=keep),
                               rtol=0, atol=0)
    other = TK.fused_message_edge_lnmod_pdrop(*args, seeds + 1, 0.6)
    assert not torch.equal(out, other)
    dbg_out, dbg_keep = TK.edge_lnmod_pdrop_debug(*args, seeds, 0.6)
    assert torch.equal(dbg_keep, keep) and torch.equal(dbg_out, out)

    calls = []
    real = TK.fused_message_edge_lnmod
    monkeypatch.setattr(TK, "fused_message_edge_lnmod",
                        lambda *a: calls.append(1) or real(*a))
    TK.reset_launches()
    out0 = TK.fused_message_edge_lnmod_pdrop(*args, seeds, 0.0)
    assert calls == [1]
    torch.testing.assert_close(out0, real(*args), rtol=0, atol=0)
    assert TK.LAUNCHES == dict.fromkeys(TK.LAUNCHES, 0)
