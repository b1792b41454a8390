"""Stage-1 training on the CPU: the port's two repairs, VQ training, the loss
and AdamW against the JAX package, on the same numpy inputs; the skip rule
of `make_vqvae_step` (one step against JAX's is in
tests/test_torch_vqvae_step.py and tests/test_torch_vqvae_step_trained.py).

* The straight-through VQ passes the identity gradient: the port's autograd
  of sum(z_q * c) equals JAX's jax.grad exactly (both are c).
* ic_to_xyz14 backpropagates: grads of a random scalar of xyz14 w.r.t. ic
  and the C-alpha trace match jax.grad within 1e-5 * max(1, max|grad|) (f32),
  with every atom slot's internal coordinates set. The ten chained
  placements give grads up to ~1e2 here (one f32 ulp is 7.6e-6 there), and
  an element is a sum of terms up to that size taken in another order
  (measured max|d| 1.7e-4 at a grad of 106, 3.6e-5 at a grad of 0.9); its
  forward equals the in-place fill it replaced bit for bit.
* vq_train from the same numpy VQState: codes equal; codebook,
  cluster_size, embed_avg and the commit loss within 1e-6.
* vqvae_loss_terms on the same ic_recon, every metric rtol 1e-5; the KL
  terms with masks, rtol 1e-5.
* TrainState against optax.chain(clip_by_global_norm(5), adamw(1e-3)) (its
  default weight decay 1e-4) for 3 steps on the same random params and
  grads, and again with a plateau drop of the learning rate between steps
  against inject_hyperparams: 1e-6, and within 2 lr where the first step's
  |g| < 1e-3 max|g| of the parameter (Adam's first step is lr * sign(g),
  which a near-zero gradient may take either way in two packages).
* A poisoned batch (a NaN coordinate) leaves the whole state as it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (LR, CLIP, assert_params_after_step, jax_vq_state, port_vq_state,
                           stage1_batch, stage1_vq_state, t)
from codlad_tpu.geometry.internal import ic_to_xyz14 as jax_ic_to_xyz14
from codlad_tpu.models import vq as JVQ
from codlad_tpu.train import losses as JL
from codlad_tpu.train.state import set_learning_rate
from codlad_tpu_torch.data.cg_batch import synthetic_cg_batch
from codlad_tpu_torch.geometry import residues as R
from codlad_tpu_torch.geometry.internal import ic_to_xyz14, place_atom
from codlad_tpu_torch.models.vae import VAE
from codlad_tpu_torch.models.vq import vq_quantize, vq_train
from codlad_tpu_torch.train import losses as TL
from codlad_tpu_torch.train.state import TrainState
from codlad_tpu_torch.train.steps import make_vqvae_step, weights_to_array


# --------------------------------------------------------------------------
# the repairs


def test_vq_straight_through_gradient_matches_jax():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(2, 8, 3)).astype(np.float32)
    c = rng.normal(size=(2, 8, 3)).astype(np.float32)
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    cb, cs, ea = stage1_vq_state(1, 16, 3)
    g_jax = jax.grad(lambda zz: jnp.sum(JVQ.vq_quantize(jax_vq_state(cb, cs, ea), zz,
                                                        jnp.asarray(mask))[0] * c))(
        jnp.asarray(z))
    zt = t(z).requires_grad_(True)
    zq, _, _ = vq_quantize(t(cb), zt, t(mask))
    (g_port,) = torch.autograd.grad((zq * t(c)).sum(), zt)
    np.testing.assert_array_equal(g_port.numpy(), np.asarray(g_jax))
    np.testing.assert_array_equal(g_port.numpy(), c)
    # the forward value is JAX's z + (code - z), bit for bit
    zq_j = JVQ.vq_quantize(jax_vq_state(cb, cs, ea), jnp.asarray(z), jnp.asarray(mask))[0]
    np.testing.assert_array_equal(zq.detach().numpy(), np.asarray(zq_j))


def _ic_inputs(seed, n_frames=2, n_res=32):
    """A trace with no padded residue and random internal coordinates in every
    row, with residue types cycling through all 20 (TRP fills all 14 slots)."""
    rng = np.random.default_rng(seed)
    batch = synthetic_cg_batch(n_frames, n_res, seed=seed)
    B, L = batch["res_type"].shape
    res_type = (np.arange(B * L).reshape(B, L) % 20).astype(np.int32)
    ic = np.zeros((B, L, 13, 3), np.float32)
    ic[..., 0] = 1.5 + 0.05 * rng.normal(size=(B, L, 13))
    ic[..., 1] = rng.uniform(1.2, 2.2, size=(B, L, 13))
    ic[..., 2] = rng.uniform(-np.pi, np.pi, size=(B, L, 13))
    return batch["cg_xyz_og"].astype(np.float32), ic, res_type


def test_ic_to_xyz14_gradient_matches_jax():
    cg, ic, res_type = _ic_inputs(7)
    c = np.random.default_rng(8).normal(size=res_type.shape + (14, 3)).astype(np.float32)
    gi_j, gc_j = jax.grad(lambda i, x: jnp.sum(jax_ic_to_xyz14(x, i, jnp.asarray(res_type))
                                               * c), argnums=(0, 1))(jnp.asarray(ic),
                                                                     jnp.asarray(cg))
    it, ct = t(ic).requires_grad_(True), t(cg).requires_grad_(True)
    gi, gc = torch.autograd.grad((ic_to_xyz14(ct, it, t(res_type)) * t(c)).sum(), [it, ct])
    assert np.all(np.abs(gi.numpy()).sum(axis=(0, 1, 3)) > 0)   # every ic row reaches xyz14
    for got, want in ((gi.numpy(), np.asarray(gi_j)), (gc.numpy(), np.asarray(gc_j))):
        np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()))


def test_ic_to_xyz14_forward_equals_in_place_fill():
    cg, ic, res_type = _ic_inputs(9, n_res=20)
    cg, ic, res_type = t(cg), t(ic), t(res_type)
    ca_prev, ca_here, ca_next = cg[:, :-2], cg[:, 1:-1], cg[:, 2:]
    n = place_atom(ic[:, :, 0], ca_here, ca_prev, ca_next)
    c = place_atom(ic[:, :, 1], ca_here, ca_next, ca_prev)
    o = place_atom(ic[:, :, 2], c, ca_here, n)
    B, L = res_type.shape
    want = torch.zeros((B, L, R.MAX_ATOMS, 3))
    for slot, v in enumerate((o, n, c, ca_here)):
        want[:, :, slot] = v
    parents = torch.as_tensor(R.SC_PARENTS)[res_type.long()]
    take = lambda s: torch.gather(want, 2, s.long()[..., None, None].expand(B, L, 1, 3))[:, :, 0]
    for k in range(R.MAX_SC):
        trip = parents[:, :, k]
        want[:, :, R.NUM_BB + k] = place_atom(ic[:, :, 3 + k], take(trip[..., 2]),
                                              take(trip[..., 1]), take(trip[..., 0]))
    assert torch.equal(ic_to_xyz14(cg, ic, res_type), want)


# --------------------------------------------------------------------------
# VQ training and the loss


def test_vq_train_matches_jax():
    rng = np.random.default_rng(2)
    cb, cs, ea = stage1_vq_state(3, 32, 3)
    z = (rng.normal(size=(3, 20, 3)) * 1.2).astype(np.float32)
    mask = rng.random((3, 20)) > 0.2
    zq_j, idx_j, loss_j, st_j = JVQ.vq_quantize(jax_vq_state(cb, cs, ea), jnp.asarray(z),
                                                jnp.asarray(mask), train=True)
    zq, idx, loss, st = vq_train(port_vq_state(cb, cs, ea), t(z), t(mask))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(zq.numpy(), np.asarray(zq_j))
    np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-6, rtol=1e-6)
    for k in ("codebook", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(st_j, k)),
                                   atol=1e-6, err_msg=k)
    # padded residues change no statistic; codes not hit and never assigned stay
    _, _, _, st_pad = vq_train(port_vq_state(cb, cs, ea), t(z), t(mask & False))
    np.testing.assert_array_equal(st_pad.codebook.numpy()[cs <= 1e-3], cb[cs <= 1e-3])
    np.testing.assert_allclose(st_pad.cluster_size.numpy(), cs * 0.99, rtol=1e-6)


def _ic_recon(nb, seed):
    rng = np.random.default_rng(seed)
    ic = nb["ic"].astype(np.float32)
    return (ic + rng.normal(size=ic.shape).astype(np.float32) * np.array([0.1, 0.2, 0.5],
                                                                          np.float32))


@pytest.mark.parametrize("epoch", [0, 1, 25])
def test_vqvae_loss_terms_match_jax(epoch):
    nb = stage1_batch(seed=1)
    nb["endpoint_mask"][0, 3] = True     # an interior endpoint: zeroed, still counted
    ic_recon = _ic_recon(nb, 2)
    w = JL.LossWeights(zeta=5.0, omega=3.0, theta=0.7).dynamic(epoch)
    pw = TL.LossWeights(zeta=5.0, omega=3.0, theta=0.7).dynamic(epoch)
    assert (pw.eta, pw.zeta) == (w.eta, w.zeta)
    rj, mj = JL.vqvae_loss_terms({k: jnp.asarray(v) for k, v in nb.items()},
                                 jnp.asarray(ic_recon), w)
    rp, mp = TL.vqvae_loss_terms({k: t(v) for k, v in nb.items()}, t(ic_recon), pw)
    assert mp.keys() == mj.keys()
    for k in mj:
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    assert float(mj["inter"]) > 0 and float(mj["clash"]) > 0


def test_kl_terms_match_jax():
    rng = np.random.default_rng(4)
    mu1, mu2 = (rng.normal(size=(2, 9, 3)).astype(np.float32) for _ in range(2))
    s1, s2 = (rng.uniform(0.2, 2.0, size=(2, 9, 3)).astype(np.float32) for _ in range(2))
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    s1[1, 7] = 0.0                      # a padded position that would overflow the ratio
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else t(m)
        if m is not None:
            np.testing.assert_allclose(
                float(TL.kl_standard_normal(t(mu1), t(s1), tm)),
                float(JL.kl_standard_normal(jnp.asarray(mu1), jnp.asarray(s1), jm)), rtol=1e-5)
        np.testing.assert_allclose(
            float(TL.kl_gaussians(t(mu1), t(s1 + (m is None)), t(mu2), t(s2), tm)),
            float(JL.kl_gaussians(*(jnp.asarray(a) for a in (mu1, s1 + (m is None), mu2, s2)),
                                  jm)), rtol=1e-5)


# --------------------------------------------------------------------------
# AdamW against optax


@pytest.mark.parametrize("plateau", [False, True])
def test_train_state_matches_optax_adamw(plateau):
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 3).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    grads[0]["b"][0] = 1e-9             # a near-zero first gradient
    if plateau:
        tx = optax.chain(optax.clip_by_global_norm(CLIP),
                         optax.inject_hyperparams(optax.adamw)(learning_rate=LR))
    else:
        tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jp)
    st = TrainState({k: t(v) for k, v in params.items()}, lambda s: np.float32(LR),
                    grad_clip=CLIP, weight_decay=1e-4, ema=False)
    for i, g in enumerate(grads):
        if plateau and i == 2:
            opt = set_learning_rate(opt, LR * 0.3)
            st.set_learning_rate(LR * 0.3)
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, jp)
        jp = optax.apply_updates(jp, upd)
        st.apply_gradients({k: t(v) for k, v in g.items()})
        for k in shapes:
            assert_params_after_step(st.params[k].numpy(), np.asarray(jp[k]), grads[0][k], LR,
                                      f"step {i} {k}")
    assert st.step == 3 and st.opt_state["count"] == 3


# --------------------------------------------------------------------------
# one make_vqvae_step


def test_vqvae_step_skips_poisoned_batch():
    nb = stage1_batch(seed=5)
    port = VAE(torch.Generator().manual_seed(1), embed_dim=36, vqdim=3, enc_nconv=2,
               dec_nconv=2)
    state = TrainState(dict(port.named_parameters()), lambda s: np.float32(LR),
                       grad_clip=CLIP, weight_decay=1e-4, ema=False,
                       vq_state=port_vq_state(*stage1_vq_state(7, 32, 3)))
    step, eval_step = make_vqvae_step(port)
    w = weights_to_array(TL.LossWeights(eta=1.0, zeta=0.0))
    batch = {k: t(v) for k, v in nb.items()}
    state, m0 = step(state, batch, w)
    assert float(m0["skipped"]) == 0.0 and state.step == 1
    snap = lambda s: ({k: v.clone() for k, v in s.params.items()},
                      {m: {k: v.clone() for k, v in s.opt_state[m].items()}
                       for m in ("mu", "nu")},
                      {k: v.clone() for k, v in s.vq_state.tensors().items()},
                      s.step, s.opt_state["count"])
    before = snap(state)
    poisoned = dict(batch, xyz14=batch["xyz14"].clone())
    poisoned["xyz14"][0, 0, 0, 0] = float("nan")
    state, m1 = step(state, poisoned, w)
    assert float(m1["skipped"]) == 1.0
    after = snap(state)
    assert after[3:] == before[3:]
    for a, b in zip(after[:3], before[:3]):
        flat = lambda d: {f"{k}/{j}": v for k, vs in d.items() for j, v in
                          (vs.items() if isinstance(vs, dict) else [("", vs)])}
        for k, v in flat(b).items():
            assert torch.equal(flat(a)[k], v), k
    state, m2 = step(state, batch, w)
    assert float(m2["skipped"]) == 0.0 and state.step == 2
    assert eval_step(state, batch, w).keys() == m0.keys() - {"skipped", "sync_ms"}
