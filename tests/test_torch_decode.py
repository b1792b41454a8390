"""The port's decode half (VQ snap, CG graph ops, IC decoder, ic_to_xyz14)
and its CG batch builder against the JAX package, in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import jax_apply, random_params, t
from codlad_tpu.data import batch as JB
from codlad_tpu.data.featurize import featurize_frame
from codlad_tpu.data.synthetic import random_protein
from codlad_tpu.geometry.internal import ic_to_xyz14 as jax_ic_to_xyz14
from codlad_tpu.models.vae import VAE as JaxVAE
from codlad_tpu.models.vq import VQState, vq_quantize as jax_vq_quantize
from codlad_tpu.nn import basis as JBS
from codlad_tpu.nn import graph as JG
from codlad_tpu_torch.convert.from_flax import load_flax
from codlad_tpu_torch.data.cg_batch import collate_cg, featurize_cg, synthetic_cg_batch
from codlad_tpu_torch.geometry.internal import ic_to_xyz14
from codlad_tpu_torch.models.vae import VAE
from codlad_tpu_torch.models.vq import vq_quantize
from codlad_tpu_torch.nn import basis as TBS
from codlad_tpu_torch.nn import graph as TG

BATCH_KEYS = ("res_type", "res_mask", "cg_xyz_og", "cg_edges", "cg_edges_mask")


def test_cg_batch_builder_matches_featurize_frame_and_padding():
    rng = np.random.default_rng(0)
    jax_ex, port_ex = [], []
    for n in (14, 22):
        res_type_og, chain_id_og, cg, xyz14 = random_protein(rng, n + 2)
        jax_ex.append(featurize_frame(res_type_og, chain_id_og, cg, xyz14))
        port_ex.append(featurize_cg(res_type_og, cg))
        np.testing.assert_array_equal(port_ex[-1]["cg_edges"], jax_ex[-1]["cg_edges"])
    want = JB.collate(jax_ex, JB.spec_for(jax_ex))
    got = collate_cg(port_ex)
    for k in BATCH_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_vq_snap_matches_jax():
    rng = np.random.default_rng(1)
    codebook = rng.normal(size=(64, 3)).astype(np.float32)
    z = rng.normal(size=(2, 9, 3)).astype(np.float32)
    mask = rng.random((2, 9)) > 0.3
    state = VQState(codebook=jnp.asarray(codebook), cluster_size=jnp.zeros(64),
                    embed_avg=jnp.asarray(codebook))
    zq_w, idx_w, loss_w, _ = jax_vq_quantize(state, jnp.asarray(z), jnp.asarray(mask))
    zq, idx, loss = vq_quantize(t(codebook), t(z), t(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_w))
    np.testing.assert_allclose(zq.numpy(), np.asarray(zq_w), atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-5)


def test_edge_ops_and_gaussian_smearing_match_jax():
    rng = np.random.default_rng(2)
    edges = rng.integers(0, 10, size=(2, 15, 2)).astype(np.int32)
    mask = rng.random((2, 15)) > 0.3
    nodes = rng.normal(size=(2, 10, 5)).astype(np.float32)
    msgs = rng.normal(size=(2, 30, 5)).astype(np.float32)
    e2, m2 = JG.make_directed_batched(jnp.asarray(edges), jnp.asarray(mask))
    te2, tm2 = TG.make_directed_batched(t(edges), t(mask))
    np.testing.assert_array_equal(te2.numpy(), np.asarray(e2))
    jops = JG.make_edge_ops(e2, m2, 10)
    tops = TG.EdgeOps(te2, tm2, 10)
    for name in ("gather_src", "gather_dst"):
        np.testing.assert_allclose(getattr(tops, name)(t(nodes)).numpy(),
                                   np.asarray(getattr(jops, name)(nodes)), atol=1e-6)
    np.testing.assert_allclose(tops.aggregate_to_src(t(msgs)).numpy(),
                               np.asarray(jops.aggregate_to_src(msgs)), atol=1e-5)
    d = rng.random((2, 30)).astype(np.float32) * 6
    gs = JBS.GaussianSmearing(0.0, 5.0, 12)
    np.testing.assert_allclose(TBS.GaussianSmearing(0.0, 5.0, 12)(t(d)).numpy(),
                               np.asarray(gs.apply({}, d)), atol=1e-6)


def test_vae_decode_icdecoder_matches_jax():
    batch = synthetic_cg_batch(2, 14, seed=3, L=16)
    lat = np.random.default_rng(3).normal(size=(2, 16, 3)).astype(np.float32)
    vae = JaxVAE(embed_dim=8, vqdim=3, dec_nconv=2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p = random_params(vae, 4, jb, lat, method=JaxVAE.decode)
    want = jax_apply(vae, p, jb, lat, method=JaxVAE.decode)
    port = load_flax(VAE(torch.Generator().manual_seed(0), embed_dim=8, vqdim=3, encoder=False,
                         dec_nconv=2), p)
    with torch.no_grad():
        got = port.decode({k: t(v) for k, v in batch.items()}, t(lat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_ic_to_xyz14_matches_jax():
    rng = np.random.default_rng(5)
    batch = synthetic_cg_batch(2, 12, seed=5)
    B, L = batch["res_type"].shape
    ic = np.zeros((B, L, 13, 3), np.float32)
    ic[..., 0] = 1.5 + 0.05 * rng.normal(size=(B, L, 13))
    ic[..., 1] = rng.uniform(1.2, 2.2, size=(B, L, 13))
    ic[..., 2] = rng.uniform(-np.pi, np.pi, size=(B, L, 13))
    args = (batch["cg_xyz_og"], ic, batch["res_type"])
    want = np.asarray(jax.jit(jax_ic_to_xyz14)(*args))
    got = ic_to_xyz14(*(t(a) for a in args)).numpy()
    # NeRF chains ten placements: f32 error grows with the distance (~20 A)
    np.testing.assert_allclose(got, want, atol=1e-4)
