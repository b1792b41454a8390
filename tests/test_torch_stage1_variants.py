"""The rest of Stage 1 in the port against the JAX package on the CPU: the
modules (ICDecoderAngle, CGPrior, MuSigmaHead, IrrepsLayerNorm, VAE in each
mode, GenZProt) and one f32 training step of each VAE mode, of the
quantizer kinds through make_vqvae_step, and of make_genzprot_step.

The same numpy inputs (JAX's synthetic frames, featurized and padded) and
the same random weights (`random_params`, converted by
convert/from_flax.load_flax by name) go through both packages; JAX's
random draws (the reparametrisation's normal, the quantizer's Gumbel noise
or expiry rows from fold_in(rng, 4096)) are replayed and handed to the
port. Tolerances: f32 forwards atol 1e-4 (as tests/test_torch_encoder.py);
a step's loss and metrics rtol 1e-5, grads max|d| <= 1e-3 max|g| a
parameter, the VQ state within 1e-6 + 1e-6 relative, params after the
step within 1e-6 where the step's |g| >= 1e-3 max|g| of the parameter and
>= 1e-6 (below it Adam's eps 1e-8 sets the step's size), else within 2 lr;
eval_step's metrics rtol 2e-5. The quantizer kinds' steps
(tests/test_torch_quantizers.py) use these helpers. The steps
run at 1 encoder and 1 decoder layer on 2 frames of 20 residues, with the
weights scaled and the bond tables set as in tests/test_torch_vqvae_step.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (CLIP, LR, jax_apply, random_params, record_grads, stage1_batch,
                           t)
from codlad_tpu.models import vq as JVQ
from codlad_tpu.models.decoder import ICDecoderAngle as JaxDecoderAngle
from codlad_tpu.models.encoder import irrep_ladder as jax_ladder
from codlad_tpu.models.prior import CGPrior as JaxCGPrior
from codlad_tpu.models.vae import VAE as JaxVAE
from codlad_tpu.models.vae import GenZProt as JaxGenZProt
from codlad_tpu.models.vae import MuSigmaHead as JaxMuSigmaHead
from codlad_tpu.nn.tensor_product import IrrepsLayerNorm as JaxIrrepsLayerNorm
from codlad_tpu.train import losses as JL
from codlad_tpu.train.state import create_train_state
from codlad_tpu.train.steps import make_genzprot_step as jax_genzprot_step
from codlad_tpu.train.steps import make_vqvae_step as jax_vqvae_step
from codlad_tpu.train.steps import weights_to_array as jax_weights
from codlad_tpu_torch.convert.from_flax import flax_to_state_dict, load_flax
from codlad_tpu_torch.models import vq as TVQ
from codlad_tpu_torch.models.decoder import ICDecoderAngle
from codlad_tpu_torch.models.encoder import irrep_ladder
from codlad_tpu_torch.models.prior import CGPrior
from codlad_tpu_torch.models.vae import VAE, GenZProt, MuSigmaHead
from codlad_tpu_torch.nn.tensor_product import IrrepsLayerNorm
from codlad_tpu_torch.train import losses as TL
from codlad_tpu_torch.train.state import TrainState
from codlad_tpu_torch.train.steps import make_genzprot_step, make_vqvae_step, weights_to_array

GEN = torch.Generator


def _batch(seed=0, n_frames=2, n_res=26):
    nb = stage1_batch(seed=seed, n_frames=n_frames, n_res=n_res)
    return nb, {k: jnp.asarray(v) for k, v in nb.items()}, {k: t(v) for k, v in nb.items()}


def _close(got, want, atol=1e-4, err=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0, err_msg=err)


def test_cgprior_matches_jax():
    nb, jb, tb = _batch(1)
    prior = JaxCGPrior(num_conv_layers=3)
    params = random_params(prior, 2, jb)
    mu_j, sg_j = jax_apply(prior, params, jb)
    port = load_flax(CGPrior(GEN().manual_seed(0), num_conv_layers=3), params)
    with torch.no_grad():
        mu, sg = port(tb)
    assert mu.shape == nb["res_type"].shape + (36,) and np.isfinite(np.asarray(sg_j)).all()
    _close(mu, mu_j, err="mu")
    _close(sg, sg_j, err="sigma")
    # the padded residues are zero, the valid ones at least 1e-9
    pad = ~nb["res_mask"].astype(bool)
    assert (sg.numpy()[pad] == 0).all() and (sg.numpy()[~pad] >= 1e-9).all()


def test_mu_sigma_head_and_irreps_layer_norm_match_jax():
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 5, 36)).astype(np.float32)
    head = JaxMuSigmaHead(36)
    params = random_params(head, 4, jnp.asarray(h))
    mu_j, sg_j = jax_apply(head, params, jnp.asarray(h))
    port = load_flax(MuSigmaHead(36, 36, GEN().manual_seed(0)), params)
    mu, sg = port(t(h))
    _close(mu, mu_j, 1e-5, "mu")
    _close(sg, sg_j, 1e-5, "sigma")

    ir = jax_ladder(12, 4)[3]
    x = rng.normal(size=(3, 4, ir.dim)).astype(np.float32)
    ln = JaxIrrepsLayerNorm(tuple(ir))
    params = random_params(ln, 5, jnp.asarray(x))
    want = jax_apply(ln, params, jnp.asarray(x))
    port = load_flax(IrrepsLayerNorm(irrep_ladder(12, 4)[3]), params)
    _close(port(t(x)), want, 1e-5, "IrrepsLayerNorm")
    # at init: unit weight, zero bias, the whole mean taken off the even scalars
    fresh = IrrepsLayerNorm(irrep_ladder(12, 4)[3])
    want0 = jax_apply(ln, ln.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x))
    _close(fresh(t(x)), want0, 1e-5, "IrrepsLayerNorm at init")


def test_angle_decoder_matches_jax():
    nb, jb, tb = _batch(2)
    lat = np.random.default_rng(6).normal(size=nb["res_type"].shape + (36,)).astype(np.float32)
    dec = JaxDecoderAngle(num_conv=2)
    params = random_params(dec, 7, jb, jnp.asarray(lat))
    want = jax_apply(dec, params, jb, jnp.asarray(lat))
    port = load_flax(ICDecoderAngle(GEN().manual_seed(0), num_conv=2), params)
    assert not hasattr(port, "Embed_3") and port._MLP2_7.Dense_1.out_features == 10
    with torch.no_grad():
        _close(port(tb, t(lat)), want, err="ic")


def _vae_pair(mode, jb, seed, predict_angle=False, vqdim=3, scale=1.0, enc=2, dec=2):
    vae = JaxVAE(embed_dim=36, vqdim=vqdim, mode=mode, predict_angle=predict_angle,
                 enc_nconv=enc, dec_nconv=dec)
    params = random_params(vae, seed, jb)
    if scale != 1.0:
        params = _physical(jax.tree.map(lambda p: p * scale, params), predict_angle)
    port = load_flax(VAE(GEN().manual_seed(0), embed_dim=36, vqdim=vqdim, mode=mode,
                         predict_angle=predict_angle, enc_nconv=enc, dec_nconv=dec), params)
    return vae, params, port


@pytest.mark.parametrize("mode,angle", [("vqvae", True), ("fgae", False), ("fgvae", False),
                                        ("cgvae", True)])
def test_vae_modes_match_jax(mode, angle):
    nb, jb, tb = _batch(3)
    vqdim = 3 if mode == "vqvae" else 36
    vae, params, port = _vae_pair(mode, jb, 8, predict_angle=angle, vqdim=vqdim)
    h_j, (mu_j, sg_j) = jax_apply(vae, params, jb, method=JaxVAE.encode)
    with torch.no_grad():
        h, mu, sg = port.encode_full(tb)
    _close(h, h_j, err="latents")
    assert (mu is None) == (mu_j is None)
    if mu is not None:
        _close(mu, mu_j, err="mu")
        _close(sg, sg_j, err="sigma")
    assert (port.encoder is None) == (mode == "cgvae") and (port.prior is None) == (
        mode != "cgvae")
    lat = np.asarray(h_j)
    want = jax_apply(vae, params, jb, jnp.asarray(lat), method=JaxVAE.decode)
    with torch.no_grad():
        _close(port.decode(tb, t(lat)), want, err="decode")


def test_genzprot_matches_jax():
    nb, jb, tb = _batch(4)
    model = JaxGenZProt(enc_nconv=2, dec_nconv=2)
    rng = jax.random.PRNGKey(9)
    params = random_params(model, 10, jb, rng=rng)
    port = load_flax(GenZProt(GEN().manual_seed(0), enc_nconv=2, dec_nconv=2), params)
    eps = t(jax.random.normal(rng, nb["res_type"].shape + (36,)))
    for key, arg in ((rng, eps), (None, None)):
        want = jax_apply(model, params, jb, rng=key)
        with torch.no_grad():
            got = port(tb, eps=arg)
        for name, a, b in zip(("mu", "sigma", "prior_mu", "prior_sigma", "ic"), got, want):
            _close(a, b, err=name)
    want = jax_apply(model, params, jb, rng, method=JaxGenZProt.get_latent_cg)
    with torch.no_grad():
        got = port.get_latent_cg(tb, eps)
    for name, a, b in zip(("z", "prior_mu", "prior_sigma"), got, want):
        _close(a, b, err=name)


# ---------------------------------------------------------------------------
# one training step of each mode and quantizer kind

STEP_BATCH = dict(seed=5, n_frames=2, n_res=20)
WEIGHTS = dict(zeta=5.0, omega=3.0, beta=0.05)


def _physical(params, angle):
    """Physical bond-length and side-chain-angle tables (N(1.5, 0.05) Å,
    N(1.95, 0.1) rad), as tests/test_torch_vqvae_step.py sets them."""
    rng = np.random.default_rng(9)
    tree = params["params"]
    for dec in [v["decoder"] for v in [tree] if "decoder" in v]:
        names = [("Embed_0", 1.5, 0.05), ("Embed_1", 1.5, 0.05)]
        if not angle:
            names.append(("Embed_3", 1.95, 0.1))
        for name, mean, std in names:
            shape = dec[name]["embedding"].shape
            dec[name]["embedding"] = jnp.asarray(mean + std * rng.normal(size=shape),
                                                 jnp.float32)
    return params


def _after_step(got, want, g0, err):
    """assert_params_after_step, with the elements held within 1e-6 those
    whose |g| is also >= 1e-6: below it Adam's eps (1e-8) moves the first
    step's size by over 1% of lr, so a grad within its limit may move the
    param by more than 1e-6."""
    big = (np.abs(g0) >= 1e-3 * np.abs(g0).max()) & (np.abs(g0) >= 1e-6)
    d = np.abs(got - want)
    assert np.all(d[big] <= 1e-6 + 1e-6 * np.abs(want[big])), (err, d[big].max())
    assert np.all(d <= 2 * LR + 1e-6), (err, d.max())


def _check_step(state_j, m_j, state_p, m_p, vq=True):
    assert float(m_j["skipped"]) == float(m_p["skipped"]) == 0.0
    assert set(m_j) == set(m_p) - {"sync_ms", "grads"}, set(m_j) ^ set(m_p)
    for k in m_j:
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    g_j = flax_to_state_dict(state_j.opt_state[0])
    assert g_j.keys() == m_p["grads"].keys()
    p_j = flax_to_state_dict(state_j.params)
    for k, gj in g_j.items():
        gj, gp = gj.numpy(), m_p["grads"][k].numpy()
        assert np.abs(gp - gj).max() <= 1e-3 * np.abs(gj).max() + 1e-12, k
        _after_step(state_p.params[k].numpy(), p_j[k].numpy(), gj, k)
    if vq:
        want = state_j.vq_state
        got = state_p.vq_state
        if want is None:
            assert got is None
            return
        for g, w in zip(got if isinstance(got, list) else [got],
                        want if isinstance(want, list) else [want]):
            for k in ("codebook", "cluster_size", "embed_avg"):
                np.testing.assert_allclose(getattr(g, k).numpy(), np.asarray(getattr(w, k)),
                                           atol=1e-6, rtol=1e-6, err_msg=k)


def _np_vq(q, seed):
    if q.kind == "fsq":
        return None
    rng = np.random.default_rng(seed)
    n = q.n_stages if q.kind == "rvq" else (q.n_heads if q.kind == "multihead" else 1)
    d = q.dim // q.n_heads if q.kind == "multihead" else q.dim
    out = []
    for _ in range(n):
        cb = (0.5 * rng.normal(size=(q.codebook_size, d))).astype(np.float32)
        cs = rng.uniform(0, 4, size=q.codebook_size).astype(np.float32)
        cs[::5] = 0.0
        out.append((cb, cs, (cb * np.maximum(cs, 1e-3)[:, None]).astype(np.float32)))
    return out if q.kind in ("rvq", "multihead") else out[0]


def _vq_states(arrs):
    if arrs is None:
        return None, None
    many = isinstance(arrs, list)
    arrs = arrs if many else [arrs]
    js = [JVQ.VQState(codebook=jnp.asarray(a), cluster_size=jnp.asarray(b),
                      embed_avg=jnp.asarray(c)) for a, b, c in arrs]
    ts = [TVQ.VQState(codebook=t(a), cluster_size=t(b), embed_avg=t(c)) for a, b, c in arrs]
    return (js, ts) if many else (js[0], ts[0])


def _port_state(port, vq):
    return TrainState(dict(port.named_parameters()), lambda s: np.float32(LR), grad_clip=CLIP,
                      weight_decay=1e-4, ema=False, vq_state=vq)


# (mode, quantize_type, predict_angle, hold eval_step too)
STEPS = [("fgvae", None, False, True), ("fgae", None, True, False),
         ("cgvae", None, False, False)]


@pytest.mark.parametrize("mode,qtype,angle,with_eval", STEPS)
def test_vqvae_step_matches_jax(mode, qtype, angle, with_eval):
    vqvae_step_pair(mode, qtype, angle, with_eval)


def vqvae_step_pair(mode, qtype, angle, with_eval):
    """One f32 make_vqvae_step in both packages (JAX's draws replayed), held
    by `_check_step`; with_eval: eval_step's metrics too (rtol 2e-5)."""
    nb, jb, tb = _batch(**STEP_BATCH)
    vqdim = {"fsq_5": 5, "headvq": 8}.get(qtype, 3) if mode == "vqvae" else 36
    vae, params, port = _vae_pair(mode, jb, 11, predict_angle=angle, vqdim=vqdim, scale=0.5,
                                  enc=1, dec=1)
    qj = qt = None
    if qtype is not None:
        qj = JVQ.build_quantize(qtype, codebook_size=8, dim=vqdim)
        qt = TVQ.build_quantize(qtype, codebook_size=8, dim=vqdim)
    vq_j, vq_t = _vq_states(_np_vq(qj, 12) if qj is not None else None)
    rng = jax.random.PRNGKey(13)
    draws = {}
    n_rows = nb["res_type"].size
    if mode in ("fgvae", "cgvae"):
        draws["eps"] = t(jax.random.normal(rng, nb["res_type"].shape + (36,)))
    if qt is not None and qt.kind == "gumbel":
        draws["quantizer"] = t(jax.random.gumbel(jax.random.fold_in(rng, 4096),
                                                 (n_rows, qt.codebook_size), jnp.float32))
    if qt is not None and qt.kind == "expire":
        draws["quantizer"] = t(jax.random.randint(jax.random.fold_in(rng, 4096),
                                                  (qt.codebook_size,), 0, n_rows))
    step_p, eval_p = make_vqvae_step(port, quantizer=qt)
    state_p = _port_state(port, vq_t)
    w = JL.LossWeights(**WEIGHTS)
    state_p, m_p = step_p(state_p, tb, weights_to_array(TL.LossWeights(**WEIGHTS)),
                          return_grads=True, draws=draws)
    tx = optax.chain(record_grads(), optax.clip_by_global_norm(CLIP), optax.adamw(LR))
    state_j = create_train_state(params, tx, vq_state=vq_j)
    step_j, eval_j = jax_vqvae_step(vae, quantizer=qj)
    state_j, m_j = step_j(state_j, jb, rng, jax_weights(w))
    _check_step(state_j, m_j, state_p, m_p)
    if not with_eval:
        return
    # eval: no draw, the same metric keys and values
    e_j = eval_j(state_j, jb, rng, jax_weights(w))
    e_p = eval_p(state_p, tb, weights_to_array(TL.LossWeights(**WEIGHTS)))
    assert set(e_j) == set(e_p)
    for k in e_j:
        np.testing.assert_allclose(float(e_p[k]), float(e_j[k]), rtol=2e-5, atol=1e-6,
                                   err_msg=k)


def test_genzprot_step_matches_jax():
    nb, jb, tb = _batch(**STEP_BATCH)
    model = JaxGenZProt(enc_nconv=1, dec_nconv=1)
    rng = jax.random.PRNGKey(14)
    params = _physical(jax.tree.map(lambda p: p * 0.5,
                                    random_params(model, 15, jb, rng=rng)), False)
    port = load_flax(GenZProt(GEN().manual_seed(0), enc_nconv=1, dec_nconv=1), params)
    eps = t(jax.random.normal(rng, nb["res_type"].shape + (36,)))
    w = JL.LossWeights(**WEIGHTS)
    step_p, eval_p = make_genzprot_step(port, beta=0.05)
    state_p, m_p = step_p(_port_state(port, None), tb,
                          weights_to_array(TL.LossWeights(**WEIGHTS)), return_grads=True,
                          draws={"eps": eps})
    tx = optax.chain(record_grads(), optax.clip_by_global_norm(CLIP), optax.adamw(LR))
    step_j, eval_j = jax_genzprot_step(model, beta=0.05)
    state_j, m_j = step_j(create_train_state(params, tx), jb, rng, jax_weights(w))
    assert float(m_j["kl"]) > 0      # the hinge is open: the KL term reaches the grads
    _check_step(state_j, m_j, state_p, m_p, vq=False)
    e_j, e_p = eval_j(state_j, jb, rng, jax_weights(w)), eval_p(
        state_p, tb, weights_to_array(TL.LossWeights(**WEIGHTS)))
    assert set(e_j) == set(e_p)
    for k in e_j:
        np.testing.assert_allclose(float(e_p[k]), float(e_j[k]), rtol=2e-5, atol=1e-6,
                                   err_msg=k)


def test_genzprot_skip_keeps_the_whole_state():
    """A loss at or over the threshold (here 0) leaves params, moments, count
    and step as they were, and `skipped` is 1, as in JAX."""
    nb, jb, tb = _batch(**STEP_BATCH)
    port = GenZProt(GEN().manual_seed(1), enc_nconv=1, dec_nconv=1)
    state = _port_state(port, None)
    before = {k: v.clone() for k, v in state.params.items()}
    step, _ = make_genzprot_step(port, skip_loss_threshold=0.0)
    state, m = step(state, tb, weights_to_array(TL.LossWeights(**WEIGHTS)), seed=3)
    assert float(m["skipped"]) == 1.0 and state.step == 0 and state.opt_state["count"] == 0
    assert all(torch.equal(v, before[k]) for k, v in state.params.items())
    assert all(float(v.abs().max()) == 0 for v in state.opt_state["mu"].values())
