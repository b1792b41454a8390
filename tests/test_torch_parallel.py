"""Data and sequence parallelism of the port over torch.distributed, on the
CPU with spawned gloo ranks (tests/_torch_dist_worker.py), against the
JAX package and against the port's own one-rank runs, in f32.

* ring_knn on 2 and 4 seq ranks against JAX's ring_knn under shard_map on
  the conftest's CPU devices: E_idx exact (fill indices of rows with
  fewer than K valid neighbours included), distances within 1e-5 x max.
* The seq-mode denoiser's forward on 2 and 4 ranks against the port's
  dense model and JAX's seq forward (within 1e-5 x max|out|), and its
  grads against the dense model's (within 1e-5 x max|grad|).
* A 2-rank data-parallel Stage-2 step (a padded row in the batch; dropout
  0 and 0.6, class dropout) and a 2 x 2 data x seq step (dropout 0)
  against one rank's step on the global batch: params within 1e-5 x
  max|param|; a flow step (otcfm: the coupling of the global batch) too.
* A 2-rank Stage-1 step with the EMA codebook against one rank: loss
  terms rtol 1e-5, codebook within 2e-5, params within 1e-5 x max|param|.

The entry points on several ranks are in tests/test_torch_parallel_cli.py.
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from _torch_dist_worker import latent_step_case, spawn
from _torch_parity import (ca_inputs, exact_gathers, load_flax, random_params, stage1_batch,
                           stage1_vq_state, t)
from codlad_tpu.models import denoiser as jax_denoiser_mod
from codlad_tpu.parallel.sequence import ring_knn as jax_ring_knn
from codlad_tpu_torch.models.denoiser import MPNNDenoiser
from codlad_tpu_torch.models.vae import VAE
from codlad_tpu_torch.models.vq import VQState
from codlad_tpu_torch.train import losses as TL
from codlad_tpu_torch.train.state import TrainState
from codlad_tpu_torch.train.steps import make_vqvae_step, weights_to_array

CFG = dict(hidden_dim=32, edge_features=32, num_encoder_layers=2, num_decoder_layers=1,
           k_neighbors=8)


def _close(got, want, scale):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    d = np.abs(got - want).max()
    assert d <= scale * max(np.abs(want).max(), 1e-12), d


@pytest.mark.parametrize("world", [2, 4])
def test_ring_knn_matches_jax(world, tmp_path):
    B, L, k = 2, 32, 8
    # frame 1 has 5 valid residues: its rows have fewer than k valid neighbours.
    # The traces' steps are all 3.8 A, so a residue's two chain neighbours
    # tie to the last ulp, where XLA's and torch's f32 sums round apart; a
    # 0.05 A jitter leaves no tie that rounding decides.
    _, cg, mask = ca_inputs(0, B, L, n_valid=[L, 5])
    cg = cg + 0.05 * np.random.default_rng(1).normal(size=cg.shape).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    fn = shard_map(functools.partial(jax_ring_knn, k=k, axis_name="seq", n_shards=world),
                   mesh=mesh, in_specs=(P(None, "seq", None), P(None, "seq")),
                   out_specs=(P(None, "seq", None), P(None, "seq", None)))
    d_j, i_j = jax.jit(fn)(jnp.asarray(cg), jnp.asarray(mask))
    res = spawn(world, "ring_knn_case", tmp_path, Ca=t(cg), mask=t(mask), k=k)
    d_p = torch.cat([r[0] for r in res], 1)
    i_p = torch.cat([r[1] for r in res], 1)
    np.testing.assert_array_equal(i_p.numpy(), np.asarray(i_j))
    _close(d_p.numpy(), np.asarray(d_j), 1e-5)


@pytest.fixture(scope="module")
def seq_inputs():
    B, L = 2, 32
    res_type, cg, mask = ca_inputs(1, B, L, n_valid=[L, 27])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, L, 3)).astype(np.float32)
    tt = np.array([3, 700], np.int32)
    model = jax_denoiser_mod.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.0,
                                            **CFG)
    params = random_params(model, 9, jnp.zeros((B, L, 3)), jnp.zeros((B,), jnp.int32),
                           res_type, cg, mask)
    port = load_flax(MPNNDenoiser(torch.Generator().manual_seed(0), dropout=0.0, **CFG),
                     params)
    return dict(x=x, t=tt, res=res_type, cg=cg, mask=mask, params=params, port=port)


@pytest.mark.parametrize("world", [2, 4])
def test_seq_forward_and_grads(world, seq_inputs, tmp_path, monkeypatch):
    s = seq_inputs
    port = s["port"]
    args = [t(s[k]) for k in ("x", "t", "res", "cg", "mask")]
    args[1] = args[1].long()
    dense = port(*args)
    params = list(port.parameters())
    gd = torch.autograd.grad((dense ** 2).sum(), params, allow_unused=True)
    names = [n for n, _ in port.named_parameters()]
    res = spawn(world, "seq_forward_case", tmp_path, sd=port.state_dict(), cfg=dict(
        CFG, dropout=0.0), x=args[0], t=args[1], res=args[2], cg=args[3], mask=args[4])
    out = torch.cat([r[0] for r in res], 1)
    _close(out.detach().numpy(), dense.detach().numpy(), 1e-5)
    gmax = max(float(g.abs().max()) for g in gd if g is not None)
    for n, g in zip(names, gd):
        want = np.zeros(params[names.index(n)].shape) if g is None else g.numpy()
        assert np.abs(res[0][1][n].numpy() - want).max() <= 1e-5 * gmax, n

    # JAX's seq forward under shard_map, its gathers exact as the port's
    exact_gathers(monkeypatch)
    jax_seq = jax_denoiser_mod.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.0,
                                              seq=("seq", world), **CFG)
    mesh = Mesh(np.array(jax.devices()[:world]), ("seq",))
    tt = jnp.asarray(s["t"])
    fn = shard_map(lambda p, x, r, c, m: jax_seq.apply(p, x, tt, r, c, m, deterministic=True),
                   mesh=mesh, in_specs=(P(), P(None, "seq", None), P(None, "seq"),
                                        P(None, "seq", None), P(None, "seq")),
                   out_specs=P(None, "seq", None))
    want = jax.jit(fn)(s["params"], *(jnp.asarray(s[k]) for k in ("x", "res", "cg", "mask")))
    _close(out.detach().numpy(), np.asarray(want), 1e-5)


def _step_inputs(learn_sigma, B=4, L=16, seed=0):
    res_type, cg, mask = ca_inputs(seed, B, L, n_valid=[L, 12, L, L])
    mask[3] = 0.0   # a padding row
    x1 = np.random.default_rng(seed + 1).normal(size=(B, L, 3)).astype(np.float32)
    model = jax_denoiser_mod.mpnn_diffusion(input_size=3, learn_sigma=learn_sigma,
                                            dropout=0.0, **CFG)
    params = random_params(model, 6, jnp.zeros((B, L, 3)), jnp.zeros((B,), jnp.int32),
                           res_type, cg, mask)
    port = load_flax(MPNNDenoiser(torch.Generator().manual_seed(0), dropout=0.0,
                                  learn_sigma=learn_sigma, **CFG), params)
    extras = {"res_type": t(res_type), "cg_xyz": t(cg), "mask": t(mask)}
    return port.state_dict(), t(x1), extras


def _assert_same_state(got, want):
    pmax = max(float(v.abs().max()) for v in want["params"].values())
    for tree in ("params", "ema"):
        for k, v in want[tree].items():
            assert float((got[tree][k] - v).abs().max()) <= 1e-5 * pmax, (tree, k)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("dropout,cdp,world,seq,kind", [
    (0.0, 0.0, 2, 1, "diffusion"), (0.6, 0.3, 2, 1, "diffusion"),
    (0.0, 0.0, 4, 2, "diffusion"), (0.0, 0.0, 2, 1, "otcfm")])
def test_parallel_latent_step_equals_one_rank(dropout, cdp, world, seq, kind, tmp_path):
    """The ranks' step against one rank's (this process, no group) on the
    global batch."""
    learn_sigma = kind == "diffusion"
    sd, x1, extras = _step_inputs(learn_sigma)
    kw = dict(sd=sd, cfg=dict(CFG, dropout=dropout, learn_sigma=learn_sigma), x1=x1,
              extras=extras, dropout=dropout, kind=kind, class_dropout_prob=cdp)
    one = latent_step_case(0, 1, **kw)
    for r in spawn(world, "latent_step_case", tmp_path, seq_shards=seq, **kw):
        _assert_same_state(r, one)


def test_parallel_stage1_step_equals_one_rank(tmp_path):
    nb = stage1_batch(0, n_frames=4, n_res=20)
    batch = {k: t(v) for k, v in nb.items()}
    vae = VAE(torch.Generator().manual_seed(3), embed_dim=36, vqdim=3, enc_nconv=1, dec_nconv=1)
    cb, cs, ea = stage1_vq_state(1, 16, 3, scale=2.0)
    vq = (t(cb), t(cs), t(ea))
    w = weights_to_array(TL.LossWeights(eta=1.0, zeta=5.0, omega=3.0, theta=1.0))
    state = TrainState(dict(vae.named_parameters()), lambda s: np.float32(1e-3), grad_clip=5.0,
                       weight_decay=1e-4, ema=False, vq_state=VQState(*[v.clone() for v in vq]))
    step, _ = make_vqvae_step(vae)
    state, m = step(state, batch, w)
    res = spawn(2, "stage1_step_case", tmp_path, batch=batch, sd=vae.state_dict(), vq=vq,
                weights=w)
    pmax = max(float(v.abs().max()) for v in state.params.values())
    for r in res:
        for k, v in m.items():
            if k != "sync_ms":
                np.testing.assert_allclose(r["metrics"][k], float(v), rtol=1e-5, atol=1e-7,
                                           err_msg=k)
        for k, v in state.vq_state.tensors().items():
            np.testing.assert_allclose(r["vq"][k].numpy(), v.numpy(), atol=2e-5, err_msg=k)
        for k, v in state.params.items():
            assert float((r["params"][k] - v).abs().max()) <= 1e-5 * pmax, k


@pytest.mark.parametrize("row0", [0, 3, 1000])
def test_rebased_dropout_seeds_draw_the_global_rows(row0):
    """site_seeds(seed, row0) rebases the seeds of rows row0.. so that the
    kernels' hash of each LOCAL row gives the masks of the global rows."""
    from codlad_tpu_torch.kernels.mpnn_kernels import keep_bits, site_seeds
    glob = keep_bits(site_seeds(7, 5, row0 + 4, "cpu"), 33)[row0:]
    local = keep_bits(site_seeds((7, row0), 5, 4, "cpu"), 33)
    assert torch.equal(local, glob)
