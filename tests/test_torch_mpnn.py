"""The port's conditioning layers, featurizer, MPNN layers and denoiser
against the JAX package, in f32 on the CPU (small width).

The featurizer's quaternion of a self edge (each residue is its own first
neighbour) is that of a rotation equal to the identity up to rounding:
sqrt(|1 + Rxx - Ryy - Rzz|) turns an f32 rounding residual of ~1e-7 into
~3e-4 in both implementations. Self-edge features are therefore held at
atol 2e-3, every other edge at 1e-4, and the denoiser is compared on the
JAX package's own conditioning.
"""

import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import (ca_inputs, denoiser_pair, exact_gathers, jax_apply,
                           random_params, t)
from codlad_tpu.nn import layers as JL
from codlad_tpu.nn import mpnn as JM
from codlad_tpu_torch.convert.from_flax import load_flax
from codlad_tpu_torch.nn import layers as TL
from codlad_tpu_torch.nn import mpnn as TM

H, K = 32, 16


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_timestep_embedder_and_final_layer():
    rng = np.random.default_rng(0)
    steps = np.array([0, 7, 999, 500], np.int32)
    # cos/sin of t*freq: at t=999 one f32 ulp of the argument is 6e-5
    np.testing.assert_allclose(TL.timestep_embedding(t(steps), 256).numpy(),
                               np.asarray(JL.timestep_embedding(jnp.asarray(steps), 256)),
                               atol=1e-4)
    emb = JL.TimestepEmbedder(H)
    p = random_params(emb, 0, steps)
    port = load_flax(TL.TimestepEmbedder(H, _gen()), p)
    np.testing.assert_allclose(port(t(steps)).detach().numpy(),
                               np.asarray(jax_apply(emb, p, steps)), atol=1e-4)

    x = rng.normal(size=(2, 5, H)).astype(np.float32)
    c = rng.normal(size=(2, H)).astype(np.float32)
    fl = JL.FinalLayer(H, 6)
    p = random_params(fl, 1, x, c)
    port = load_flax(TL.FinalLayer(H, 6, _gen()), p)
    np.testing.assert_allclose(port(t(x), t(c)).detach().numpy(),
                               np.asarray(jax_apply(fl, p, x, c)), atol=1e-5)


def test_features_match_with_fewer_valid_residues_than_k():
    """Frames with 9 and 12 valid residues and K=16: every padded column
    ties at the row maximum, and the port must order the ties as
    jax.lax.top_k does (lower index first)."""
    res_type, cg, mask = ca_inputs(0, 3, 20, n_valid=[20, 9, 12])
    L = cg.shape[1]
    residue_idx = np.broadcast_to(np.arange(L, dtype=np.int32), (3, L))
    chains = np.ones((3, L), np.float32)
    feat = JM.CAProteinFeatures(H, top_k=K, gather_mode="idx")
    args = (cg, mask, residue_idx, chains)
    p = random_params(feat, 2, *args)
    E_want, idx_want = jax_apply(feat, p, *args)
    port = load_flax(TM.CAProteinFeatures(H, _gen(), top_k=K), p)
    with torch.no_grad():
        E_got, idx_got = port(*(t(a) for a in args))
    np.testing.assert_array_equal(idx_got.numpy(), np.asarray(idx_want))
    E_got, E_want = E_got.numpy(), np.asarray(E_want)
    np.testing.assert_allclose(E_got[:, :, 1:], E_want[:, :, 1:], atol=1e-4)
    np.testing.assert_allclose(E_got[:, :, :1], E_want[:, :, :1], atol=2e-3)


def _layer_inputs(seed, B=2, L=12):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    idx = rng.integers(0, L, size=(B, L, 8)).astype(np.int32)
    mask_V = (rng.random((B, L)) > 0.1).astype(np.float32)
    mask_attend = (rng.random((B, L, 8)) > 0.2).astype(np.float32)
    return f(B, L, H), f(B, L, 8, H), idx, mask_V, mask_attend, f(B, H), f(B, L, H)


def test_encoder_layer_matches_jax():
    h_V, h_E, idx, mask_V, mask_attend, c, _ = _layer_inputs(0)
    layer = JM.EncLayerDiffusion(H, 2 * H, dropout=0.0)
    args = (h_V, h_E, {"idx": jnp.asarray(idx)}, mask_V, mask_attend, c)
    p = random_params(layer, 3, *args)
    V_want, E_want = jax_apply(layer, p, *args)
    port = load_flax(TM.EncLayerDiffusion(H, _gen()), p)
    with torch.no_grad():
        V_got, E_got = port(t(h_V), t(h_E), t(idx), t(mask_V), t(mask_attend), t(c))
    np.testing.assert_allclose(V_got.numpy(), np.asarray(V_want), atol=1e-4)
    np.testing.assert_allclose(E_got.numpy(), np.asarray(E_want), atol=1e-4)


def test_decoder_layer_matches_jax():
    h_V, h_E, idx, mask_V, _, c, s_node = _layer_inputs(1)
    v_node = 2.0 * h_V
    layer = JM.DecLayerDiffusion(H, 3 * H, dropout=0.0)
    args = (h_V, {"idx": jnp.asarray(idx)}, h_E, s_node, v_node, mask_V, None, c,
            True, 2.0)
    p = random_params(layer, 4, *args)
    want = jax_apply(layer, p, *args)
    port = load_flax(TM.DecLayerDiffusion(H, _gen()), p)
    with torch.no_grad():
        got = port(t(h_V), t(idx), t(h_E), t(s_node), t(v_node), t(mask_V), t(c), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_denoiser_condition_and_denoise_match_jax(monkeypatch):
    exact_gathers(monkeypatch)
    res_type, cg, mask = ca_inputs(1, 2, 20, n_valid=[20, 11])
    model, params, port = denoiser_pair(0, res_type, cg, mask)
    x = np.random.default_rng(5).normal(size=(2, 20, 3)).astype(np.float32)
    steps = np.array([3, 871], np.int32)
    cond = jax_apply(model, params, res_type, cg, mask,
                     method=type(model).compute_condition)
    want = jax_apply(model, params, x, steps, cond, method=type(model).denoise)
    with torch.no_grad():
        tc = port.compute_condition(t(res_type), t(cg), t(mask))
        jc = {"idx": t(cond["nbr"]["idx"]), "h_E0": t(cond["h_E0"]),
              "h_S": t(cond["h_S"]), "maskf": t(cond["maskf"]),
              "mask_attend": t(cond["mask_attend"])}
        got = port.denoise(t(x), t(steps), jc)
    np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(cond["nbr"]["idx"]))
    np.testing.assert_array_equal(tc["mask_attend"].numpy(), np.asarray(cond["mask_attend"]))
    np.testing.assert_allclose(tc["h_S"].numpy(), np.asarray(cond["h_S"]), atol=1e-6)
    h_E0, h_E0_want = tc["h_E0"].numpy(), np.asarray(cond["h_E0"])
    np.testing.assert_allclose(h_E0[:, :, 1:], h_E0_want[:, :, 1:], atol=1e-4)
    np.testing.assert_allclose(h_E0[:, :, :1], h_E0_want[:, :, :1], atol=2e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
