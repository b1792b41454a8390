"""Data x tensor parallelism of the port's Stage-2 step (parallel/tensor.py),
the counterpart of the data x tensor configuration of the JAX package's
`dryrun_multichip` (__graft_entry__.py:163-200), on 4 spawned gloo ranks
(2 data x 2 model; tests/_torch_dist_worker.py) in f32 at dropout 0.1:

* the loss within 1e-4 (and rtol 1e-5) of one rank's step on the global
  batch, the gathered updated params and EMA within 1e-6 of max|param| of
  one rank's, and bit for bit those of the unsharded step on the same data
  ranks;
* each rank holds half the bytes of the sharded params, moments and EMA;
* the sharded parameters' count equals JAX's `shard_param` count (a 2-d
  leaf whose trailing dim divides by the model axis and is >= 128) for the
  test's denoiser and for the dryrun's (the production widths, k 16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_dist_worker import latent_step_case, spawn
from _torch_parity import ca_inputs, load_flax, random_params, t
from codlad_tpu.models import denoiser as jax_denoiser_mod
from codlad_tpu_torch.models.denoiser import MPNNDenoiser
from codlad_tpu_torch.parallel.tensor import shard_plan

CFG = dict(hidden_dim=32, edge_features=32, num_encoder_layers=2, num_decoder_layers=1,
           k_neighbors=8)


def _jax_shard_count(params, tp):
    return sum(1 for p in jax.tree.leaves(params)
               if p.ndim == 2 and p.shape[1] % tp == 0 and p.shape[1] >= 128)


def _jax_shapes(model, B, L):
    return jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((B, L, 3)), jnp.zeros((B,), jnp.int32), jnp.zeros((B, L), jnp.int32),
        jnp.zeros((B, L, 3)), jnp.ones((B, L))), jax.random.PRNGKey(0))


def test_shard_count_equals_jax_at_the_dryrun_widths():
    model = jax_denoiser_mod.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.1,
                                            k_neighbors=16)
    port = MPNNDenoiser(torch.Generator().manual_seed(0), dropout=0.1, k_neighbors=16)
    want = _jax_shard_count(_jax_shapes(model, 2, 32), 2)
    assert len(shard_plan(port, 2)) == want > 0


def test_dp_x_tp_step_equals_one_rank(tmp_path):
    B, L, dropout = 4, 16, 0.1
    res_type, cg, mask = ca_inputs(0, B, L, n_valid=[L, 12, L, L])
    x1 = np.random.default_rng(1).normal(size=(B, L, 3)).astype(np.float32)
    model = jax_denoiser_mod.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.0, **CFG)
    params = random_params(model, 6, jnp.zeros((B, L, 3)), jnp.zeros((B,), jnp.int32),
                           res_type, cg, mask)
    cfg = dict(CFG, dropout=dropout)
    port = load_flax(MPNNDenoiser(torch.Generator().manual_seed(0), **cfg), params)
    n_jax = _jax_shard_count(params, 2)
    assert len(shard_plan(port, 2)) == n_jax > 0
    kw = dict(sd=port.state_dict(), cfg=cfg, x1=t(x1),
              extras={"res_type": t(res_type), "cg_xyz": t(cg), "mask": t(mask)},
              dropout=dropout)
    one = latent_step_case(0, 1, **kw)
    pmax = max(float(v.abs().max()) for v in one["params"].values())
    whole = sum(one["params"][k].numel() * 4 * 4 for k in shard_plan(port, 2))
    for r in spawn(4, "tensor_step_case", tmp_path, model_shards=2, **kw):
        assert r["equal"] and r["n_sharded"] == n_jax and 2 * r["bytes"] == whole
        assert abs(r["loss"] - one["loss"]) <= 1e-4
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], one["grad_norm"], rtol=1e-5)
        for tree in ("params", "ema"):
            for k, v in one[tree].items():
                assert float((r[tree][k] - v).abs().max()) <= 1e-6 * pmax, (tree, k)
