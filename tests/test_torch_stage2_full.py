"""The rest of the Stage-2 diffusion stack against the JAX package, in f32 on
the CPU at small width: the loss-second-moment sampler, the process's loss
types, self-conditioning in training and sampling, `diffusion_from_tmap`,
the denoiser's other modes (self_condition, decoder_mask,
use_seq_in_encoder=False, final_adln=False, augment_eps, forward_with_cfg),
the training step's aux, t weights and class dropout, remat, gradient
accumulation against optax.MultiSteps and the guided pipeline.

JAX's randomness is replayed in test code and handed to the port: the
self-conditioning coin and keys of `training_losses`
(codlad_tpu/gen/diffusion.py:339-364), the per-step z of the samplers, the
featurizer's augmentation noise, the decoding order's normal draw and the
class-dropout vectors of both passes (codlad_tpu/train/steps.py:255-258).
Tolerances: f32 at atol 1e-5 of max|ref| unless stated; anything that goes
through the featurizer is compared on JAX's own conditioning or at 1e-4 (its
self-edge quaternions carry ~3e-4 of f32 rounding noise, tests/
test_torch_mpnn.py), and the steps' grads at 1e-3 of max|grad|, as
tests/test_torch_train_step.py holds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (SMALL, ca_inputs, denoiser_pair, exact_gathers, jax_apply,
                           random_params, record_grads, replay_ancestral_noises, t)
from codlad_tpu.eval.harness import SamplingPipeline as JaxPipeline
from codlad_tpu.gen import diffusion as JD
from codlad_tpu.gen import timestep_sampler as JTS
from codlad_tpu.models import denoiser as JDN
from codlad_tpu.train.state import create_train_state, update_ema
from codlad_tpu.train.steps import make_latent_step as jax_make_latent_step
from codlad_tpu_torch.convert.from_flax import flax_to_state_dict, load_flax
from codlad_tpu_torch.eval.harness import SamplingPipeline
from codlad_tpu_torch.gen import diffusion as TD
from codlad_tpu_torch.gen import timestep_sampler as TTS
from codlad_tpu_torch.models.denoiser import MPNNDenoiser
from codlad_tpu_torch.train.state import TrainState, warmup_linear_schedule
from codlad_tpu_torch.train.steps import make_latent_step


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one thread: the suite runs this file beside its other
    workers on the same cores, where torch's thread pools oversubscribe
    them; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE = (2, 7, 3)


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale + 1e-30, (what, np.abs(got - want).max(),
                                                              scale)


# ---------------------------------------------------------------------------
# timestep sampler


def test_loss_second_moment_resampler_matches_jax():
    """One loss stream through both samplers: the history, the counts and
    weights() equal at every update, uniform until warm, then importance
    weights; sample()'s weights exactly 1 / (T p[t]) in f32 given JAX's t."""
    T, hist = 12, 3
    ours, theirs = TTS.LossSecondMomentResampler(T, hist), JTS.LossSecondMomentResampler(T, hist)
    rng = np.random.default_rng(0)
    for i in range(20):
        ts = rng.integers(0, T, size=8)
        losses = rng.gamma(2.0, 1.0 + ts / T)
        ours.update_with_losses(ts, losses)
        theirs.update_with_losses(ts, losses)
        np.testing.assert_array_equal(ours._loss_history, theirs._loss_history)
        np.testing.assert_array_equal(ours._loss_counts, theirs._loss_counts)
        np.testing.assert_array_equal(ours.weights(), theirs.weights())
    assert ours._warmed_up() and not np.allclose(ours.weights(), ours.weights()[0])
    t_j, w_j = theirs.sample(jax.random.PRNGKey(1), 64)
    w_p = ours.importance_weights(torch.as_tensor(np.array(t_j)).long())
    np.testing.assert_array_equal(w_p.numpy(), np.asarray(w_j))
    drawn, _ = ours.sample(4096, torch.Generator().manual_seed(0))
    counts = np.bincount(drawn.numpy(), minlength=T) / 4096
    p = ours.weights() / ours.weights().sum()
    assert np.abs(counts - p).max() < 0.05


# ---------------------------------------------------------------------------
# the process: loss types, self-conditioning, the tmap constructor


def _jax_model(x, tb, rng, x_self_cond=None, learn_sigma=True):
    s = jnp.tanh(0.7 * x + tb[:, None, None] / 1000.0)
    if x_self_cond is not None:
        s = s + 0.3 * jnp.sin(x_self_cond)
    return jnp.concatenate([s, jnp.cos(x)], axis=-1) if learn_sigma else s


def _torch_model(x, tb, x_self_cond=None, learn_sigma=True):
    s = torch.tanh(0.7 * x + tb[:, None, None] / 1000.0)
    if x_self_cond is not None:
        s = s + 0.3 * torch.sin(x_self_cond)
    return torch.cat([s, torch.cos(x)], dim=-1) if learn_sigma else s


def _jax_coin(rng):
    """JAX training_losses' coin with the noise passed in: after `rng,
    k_model = split(rng)`, `rng, k_sc, k_flag = split(rng, 3)`."""
    rng, _ = jax.random.split(rng)
    _, _, k_flag = jax.random.split(rng, 3)
    return bool(jax.random.bernoulli(k_flag))


def _losses(kw, rng, x0, t_idx, noise, mask, self_cond=None):
    jd = JD.create_diffusion(None, diffusion_steps=1000, **kw)
    td = TD.create_diffusion(None, diffusion_steps=1000, **kw)
    want = jd.training_losses(rng, _jax_model, jnp.asarray(x0), jnp.asarray(t_idx),
                              mask=jnp.asarray(mask), noise=jnp.asarray(noise))
    got = td.training_losses(_torch_model, t(x0), t(t_idx).long(), t(noise), mask=t(mask),
                             self_cond=self_cond)
    return got, want


def _loss_inputs(seed):
    r = np.random.default_rng(seed)
    x0 = r.normal(size=SHAPE).astype(np.float32)
    noise = r.normal(size=SHAPE).astype(np.float32)
    mask = np.ones(SHAPE[:2] + (1,), np.float32)
    mask[1, 5:] = 0
    return x0, np.array([0, 617], np.int32), noise, mask


@pytest.mark.parametrize("kw", [dict(), dict(rescale_learned_sigmas=True), dict(use_kl=True),
                                dict(predict_xstart=True)],
                         ids=["mse", "rescaled_mse", "kl", "predict_xstart"])
def test_training_losses_loss_types_match_jax(kw):
    """rescaled_mse scales the VB by T/1000 (1 here); 'kl' is mse + vb, as
    JAX's training_losses computes it; predict_xstart targets x_0."""
    got, want = _losses(kw, jax.random.PRNGKey(0), *_loss_inputs(1))
    assert TD.create_diffusion(None, **kw).loss_type == JD.create_diffusion(None, **kw).loss_type
    for k in ("loss", "mse", "vb"):
        _close(got[k].numpy(), want[k], what=k)
    respaced = (TD.create_diffusion("100", rescale_learned_sigmas=True),
                JD.create_diffusion("100", rescale_learned_sigmas=True))
    g2 = respaced[0].training_losses(_torch_model, *(t(a) for a in _loss_inputs(1)[:1]),
                                     t(np.array([3, 61])).long(), t(_loss_inputs(1)[2]))
    w2 = respaced[1].training_losses(jax.random.PRNGKey(0), _jax_model,
                                     jnp.asarray(_loss_inputs(1)[0]), jnp.array([3, 61]),
                                     noise=jnp.asarray(_loss_inputs(1)[2]))
    _close(g2["vb"].numpy(), w2["vb"], what="rescaled vb at T 100")


@pytest.mark.parametrize("heads", [True, False])
def test_self_conditioned_training_losses_match_jax(heads):
    """JAX's coin (replayed from its split chain) on both faces: heads runs
    the no-grad first pass with zeros and feeds its pred_xstart back,
    tails feeds zeros."""
    rng = next(jax.random.PRNGKey(i) for i in range(50)
               if _jax_coin(jax.random.PRNGKey(i)) == heads)
    got, want = _losses(dict(self_condition=True), rng, *_loss_inputs(2), self_cond=heads)
    for k in ("loss", "mse", "vb"):
        _close(got[k].numpy(), want[k], what=k)
    other, _ = _losses(dict(self_condition=True), rng, *_loss_inputs(2), self_cond=not heads)
    assert not np.allclose(other["mse"].numpy(), np.asarray(want["mse"]))


def test_first_pass_gets_no_gradient():
    td = TD.create_diffusion(None, self_condition=True)
    w = torch.tensor(0.5, requires_grad=True)
    seen = []

    def model(x, tb, x_self_cond=None):
        seen.append(x_self_cond.requires_grad)
        return torch.cat([w * torch.tanh(x + x_self_cond), x], dim=-1)

    x0, t_idx, noise, mask = _loss_inputs(3)
    out = td.training_losses(model, t(x0), t(t_idx).long(), t(noise), self_cond=True)
    out["mse"].sum().backward()
    assert seen == [False, False] and w.grad is not None


def test_diffusion_from_tmap_tables_match_jax():
    tmap = [999, 749, 499, 249, 124, 0]
    for kw in (dict(), dict(learn_sigma=False, predict_xstart=True, self_condition=True)):
        jd, td = JD.diffusion_from_tmap(tmap, **kw), TD.diffusion_from_tmap(tmap, **kw)
        assert (td.var_type, td.mean_type, td.loss_type, td.self_condition) == (
            jd.var_type, jd.mean_type, jd.loss_type, jd.self_condition)
        np.testing.assert_array_equal(td.timestep_map.numpy(), np.asarray(jd.timestep_map))
        np.testing.assert_array_equal(td.betas, np.asarray(jd.betas))
        for key, val in td._sched.items():
            np.testing.assert_array_equal(val.numpy(), np.asarray(jd._sched[key]), key)


@pytest.mark.parametrize("sampler", ["ancestral", "ddim"])
def test_self_conditioned_sampling_matches_jax(sampler):
    """Each step's pred_xstart is the next step's x_self_cond (zeros at the
    first); ancestral with JAX's per-step z replayed, DDIM at eta 0.
    `p_sample_loop_host` is the same loop and matches JAX's host loop."""
    jd = JD.create_diffusion("ddim10", self_condition=True)
    td = TD.create_diffusion("ddim10", self_condition=True)
    rng = jax.random.PRNGKey(5)
    x_T = np.random.default_rng(6).normal(size=SHAPE).astype(np.float32)
    if sampler == "ddim":
        want = jd.ddim_sample_loop(rng, _jax_model, SHAPE, noise=jnp.asarray(x_T))
        got = td.ddim_sample_loop(_torch_model, SHAPE, noise=t(x_T))
    else:
        want = jax.jit(lambda r: jd.p_sample_loop(r, _jax_model, SHAPE,
                                                  noise=jnp.asarray(x_T)))(rng)
        zs = [t(z) for z in replay_ancestral_noises(rng, td.num_timesteps, SHAPE)]
        got = td.p_sample_loop(_torch_model, SHAPE, noise=t(x_T), noises=zs)
        host = td.p_sample_loop_host(_torch_model, SHAPE, noise=t(x_T), noises=zs)
        assert torch.equal(host, got)
        want_host = jd.p_sample_loop_host(rng, _jax_model, SHAPE, noise=jnp.asarray(x_T))
        _close(host.numpy(), want_host, what="host loop")
    _close(got.numpy(), want)
    plain = TD.create_diffusion("ddim10").ddim_sample_loop(_torch_model, SHAPE, noise=t(x_T))
    assert not torch.allclose(plain, td.ddim_sample_loop(_torch_model, SHAPE, noise=t(x_T)))


# ---------------------------------------------------------------------------
# the denoiser's modes


def _pair(seed, res_type, cg, mask, **over):
    """denoiser_pair, with a decoding key for the init of a masked decoder
    (its __call__ draws the decoding order)."""
    if not over.get("decoder_mask"):
        return denoiser_pair(seed, res_type, cg, mask, **over)
    cfg = dict(SMALL, **over)
    model = JDN.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.0, **cfg)
    params = random_params(model, seed, jnp.zeros(cg.shape), jnp.zeros((cg.shape[0],),
                                                                       jnp.int32),
                           res_type, cg, mask, decoding_rng=jax.random.PRNGKey(0))
    port = MPNNDenoiser(torch.Generator().manual_seed(seed), **cfg)
    return model, params, load_flax(port, params)


def _jax_cond_to_port(cond):
    return {"idx": t(cond["nbr"]["idx"]), "h_E0": t(cond["h_E0"]), "h_S": t(cond["h_S"]),
            "maskf": t(cond["maskf"]), "mask_attend": t(cond["mask_attend"])}


MODES = {
    "self_condition": dict(self_condition=True),
    "decoder_mask": dict(decoder_mask=True),
    "decoder_mask_no_seq": dict(decoder_mask=True, use_seq_in_encoder=False),
    "no_seq_in_encoder": dict(use_seq_in_encoder=False),
    "plain_head": dict(final_adln=False),
    "residual_decoder_mask": dict(decoder_mask=True, adaln_mode="residual"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_denoiser_modes_match_jax(monkeypatch, mode):
    """`denoise` on JAX's conditioning from converted flax params. The
    decoder mask's order comes from JAX's own normal draw, handed to the port
    as decoding_randn: a continuous draw has no ties, so the argsort
    (`(mask + 1e-4) |randn|`) is the same on both sides; the test checks it."""
    exact_gathers(monkeypatch)
    over = MODES[mode]
    res_type, cg, mask = ca_inputs(1, 2, 20, n_valid=[20, 11])
    model, params, port = _pair(0, res_type, cg, mask, **over)
    r = np.random.default_rng(5)
    x = r.normal(size=(2, 20, 3)).astype(np.float32)
    sc = r.normal(size=(2, 20, 3)).astype(np.float32)
    steps = np.array([3, 871], np.int32)
    key = jax.random.PRNGKey(7)
    randn = np.asarray(jax.random.normal(key, (2, 20)))
    assert len(np.unique(np.abs(randn))) == randn.size
    cond = jax_apply(model, params, res_type, cg, mask, method=type(model).compute_condition)
    kw = {}
    if over.get("self_condition"):
        kw["x_self_cond"] = sc
    want = jax_apply(model, params, x, steps, cond, decoding_rng=key,
                     method=type(model).denoise, **kw)
    with torch.no_grad():
        got = port.denoise(t(x), t(steps), _jax_cond_to_port(cond), decoding_randn=t(randn),
                           **{k: t(v) for k, v in kw.items()})
    _close(got.numpy(), want, what=mode)
    if over.get("self_condition"):  # no x_self_cond: zeros
        want0 = jax_apply(model, params, x, steps, cond, method=type(model).denoise)
        with torch.no_grad():
            got0 = port.denoise(t(x), t(steps), _jax_cond_to_port(cond))
        _close(got0.numpy(), want0, what="zeros")


def test_masked_decoder_names_and_init():
    """The masked decoder carries Dense_1-Dense_6 under their flax names
    (Dense_1, 2, 4 without bias) and no message chain; the plain head is
    one Dense."""
    port = MPNNDenoiser(torch.Generator().manual_seed(0), decoder_mask=True, final_adln=False,
                        **SMALL)
    names = dict(port.named_parameters())
    for i in range(1, 7):
        assert f"dec_layers.0.Dense_{i}.weight" in names
    assert {f"dec_layers.0.Dense_{i}.bias" for i in (1, 2, 4)}.isdisjoint(names)
    assert not any("dec_layers.0.SplitMessageChain" in n for n in names)
    assert set(k for k in names if k.startswith("w_out")) == {"w_out.weight", "w_out.bias"}
    assert float(names["w_out.bias"].abs().max()) == 0.0


def test_augment_eps_with_injected_noise_matches_jax(monkeypatch):
    """The featurizer adds augment_eps * noise to the C-alpha trace: JAX's
    draw, handed to the port, gives the same graph and edge features."""
    exact_gathers(monkeypatch)
    res_type, cg, mask = ca_inputs(2, 2, 20, n_valid=[20, 14])
    model, params, port = denoiser_pair(1, res_type, cg, mask, augment_eps=0.2)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, cg.shape))
    want = jax_apply(model, params, res_type, cg, mask, key,
                     method=type(model).compute_condition)
    with torch.no_grad():
        got = port.compute_condition(t(res_type), t(cg), t(mask), augment_noise=t(noise))
        plain = port.compute_condition(t(res_type), t(cg), t(mask))
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["nbr"]["idx"]))
    h, hw = got["h_E0"].numpy(), np.asarray(want["h_E0"])
    np.testing.assert_allclose(h[:, :, 1:], hw[:, :, 1:], atol=1e-4)
    np.testing.assert_allclose(h[:, :, :1], hw[:, :, :1], atol=2e-3)
    assert not torch.allclose(plain["h_E0"], got["h_E0"])


def test_forward_with_cfg_matches_jax(monkeypatch):
    exact_gathers(monkeypatch)
    res_type, cg, mask = ca_inputs(3, 4, 16, n_valid=[16, 12, 16, 12])
    model, params, port = denoiser_pair(2, res_type, cg, mask)
    x = np.random.default_rng(4).normal(size=(4, 16, 3)).astype(np.float32)
    steps = np.array([10, 400, 10, 400], np.int32)
    want = jax_apply(model, params, x, steps, res_type, cg, mask, 1.7,
                     method=type(model).forward_with_cfg)
    with torch.no_grad():
        got = port.forward_with_cfg(t(x), t(steps), t(res_type), t(cg), t(mask), 1.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(got[:2, ..., :3].numpy(), got[2:, ..., :3].numpy())


# ---------------------------------------------------------------------------
# the training step


STEP_CFG = dict(hidden_dim=32, edge_features=32, num_encoder_layers=1, num_decoder_layers=1,
                k_neighbors=8)


def _step_inputs():
    B, L = 3, 16
    res_type, cg, mask = ca_inputs(4, B, L, n_valid=[16, 11, 16])
    mask[2] = 0.0                                   # a batch-padding row
    x1 = np.random.default_rng(5).normal(size=(B, L, 3)).astype(np.float32)
    return res_type, cg, mask, x1


def _jax_step(over, step_kw, rng, class_dropout_prob=0.0, t_weights=None):
    """One f32 JAX step at dropout 0 (t given) -> (metrics, grads, the
    port's model with the same weights)."""
    res_type, cg, mask, x1 = _step_inputs()
    B, L = res_type.shape
    cfg = dict(STEP_CFG, **over)
    model = JDN.mpnn_diffusion(input_size=3, learn_sigma=True, dropout=0.0, **cfg)
    params = random_params(model, 6, jnp.zeros((B, L, 3)), jnp.zeros((B,), jnp.int32),
                           res_type, cg, mask)
    port = load_flax(MPNNDenoiser(torch.Generator().manual_seed(0), **cfg), params)
    tx = optax.chain(record_grads(), optax.adamw(1e-3, weight_decay=0.0))
    state = create_train_state(params, tx, with_ema=True)
    extras = {"res_type": jnp.asarray(res_type), "cg_xyz": jnp.asarray(cg),
              "mask": jnp.asarray(mask)}
    process = JD.create_diffusion(None, self_condition=over.get("self_condition", False),
                                  **step_kw)
    t_j = jnp.array([5, 500, 999], jnp.int32)
    with pytest.MonkeyPatch.context() as mp:
        exact_gathers(mp)
        step, _ = jax_make_latent_step(model, process, process_kind="diffusion",
                                       dropout=False, class_dropout_prob=class_dropout_prob)
        new, m = step(state, jnp.asarray(x1), extras, rng, t=t_j,
                      t_weights=None if t_weights is None else jnp.asarray(t_weights))
    m = jax.tree.map(np.asarray, m)
    return m, flax_to_state_dict(jax.device_get(new.opt_state[0])), port


def _step_keys(rng):
    """(t's key, noise, the main pass's key, the first pass's key, the coin)
    of JAX's loss_fn -> training_losses chain for one step key."""
    k_t, k_loss = jax.random.split(rng)
    r, sub = jax.random.split(k_loss)
    noise = np.asarray(jax.random.normal(sub, _step_inputs()[3].shape))
    r, k_model = jax.random.split(r)
    r, k_sc, k_flag = jax.random.split(r, 3)
    return k_t, noise, k_model, k_sc, bool(jax.random.bernoulli(k_flag))


def _port_step(port, step_kw, x_self, noise, t_idx, **kw):
    res_type, cg, mask, x1 = _step_inputs()
    process = TD.create_diffusion(None, self_condition=x_self, **step_kw)
    state = TrainState(dict(port.named_parameters()), lambda s: 1e-3)
    step, _ = make_latent_step(port, process, dropout=False,
                               class_dropout_prob=kw.pop("class_dropout_prob", 0.0))
    extras = {"res_type": t(res_type), "cg_xyz": t(cg), "mask": t(mask)}
    return step(state, t(x1), extras, 0, t=t(t_idx).long(), noise=t(noise), **kw)[1]


STEP_CASES = {  # (denoiser overrides, process kwargs, t weights, class dropout, coin)
    "t_weights": ({}, {}, np.array([0.5, 2.0, 1.5], np.float32), 0.0, None),
    "self_cond_heads_class_dropout": (dict(self_condition=True), {}, None, 0.5, True),
    "self_cond_tails_predict_xstart": (dict(self_condition=True), dict(predict_xstart=True),
                                       None, 0.0, False),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_training_step_aux_and_grads_match_jax(case):
    """The step's loss, mse and aux (loss_per_sample, t, valid_mask, weight)
    and every grad, with JAX's noise, coin (both faces) and class-dropout
    vectors (both passes') handed to the port; a batch-padding row
    (all-zero mask) counts in no loss and in no weight. eval_step returns
    the same weight and valid mask as JAX's step."""
    over, step_kw, t_weights, p_cls, want_coin = STEP_CASES[case]
    for i in range(100):
        rng = jax.random.PRNGKey(i)
        _, noise, k_model, k_sc, coin = _step_keys(rng)
        if want_coin is None or coin == want_coin:
            break
    kw = {}
    if over:
        kw["self_cond"] = coin
    if p_cls:
        drop = lambda k: torch.as_tensor(np.asarray(jax.random.bernoulli(
            jax.random.fold_in(k, 0xC1A55), p_cls, (3,))))
        kw["class_drop"] = (drop(k_model), drop(k_sc))
        kw["class_dropout_prob"] = p_cls
        assert any(bool(d[:2].any()) for d in kw["class_drop"])
    m_j, g_j, port = _jax_step(over, step_kw, rng, p_cls, t_weights)
    m_p = _port_step(port, step_kw, bool(over), noise, np.array([5, 500, 999]),
                     t_weights=None if t_weights is None else t(t_weights), **kw)
    for k in ("loss", "mse", "loss_per_sample", "weight"):
        np.testing.assert_allclose(np.asarray(m_p[k]), m_j[k], rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("t", "valid_mask"):
        np.testing.assert_array_equal(np.asarray(m_p[k]), m_j[k], err_msg=k)
    assert float(m_p["weight"]) == 2.0 and float(m_p["loss_per_sample"][2]) == 0.0
    if over:
        assert m_p["self_cond"] == coin
    for name, want in g_j.items():
        torch.testing.assert_close(m_p["grads"][name], want, rtol=0,
                                   atol=1e-3 * float(want.abs().max()) + 1e-8, msg=name)
    res_type, cg, mask, x1 = _step_inputs()
    _, ev = make_latent_step(port, TD.create_diffusion(None, **step_kw), dropout=True)
    state = TrainState(dict(port.named_parameters()), lambda s: 1e-3)
    m = ev(state, t(x1), {"res_type": t(res_type), "cg_xyz": t(cg), "mask": t(mask)}, 0)
    assert float(m["weight"]) == float(m_j["weight"]) == 2.0
    np.testing.assert_array_equal(m["valid_mask"].numpy(), m_j["valid_mask"])


def test_class_dropout_replaces_whole_sequences():
    """Where the drop vector holds, the whole sequence becomes vocab - 1:
    the loss equals that of the batch with those rows' res_type replaced by
    hand; the default draw comes from the pass's seed."""
    from codlad_tpu_torch.train.steps import class_drop_draw
    res_type, cg, mask, x1 = _step_inputs()
    port = MPNNDenoiser(torch.Generator().manual_seed(0), **STEP_CFG)
    process = TD.create_diffusion(None)
    state = TrainState(dict(port.named_parameters()), lambda s: 0.0)
    drop = torch.tensor([True, False, True])
    extras = {"res_type": t(res_type), "cg_xyz": t(cg), "mask": t(mask)}
    kw = dict(t=torch.tensor([5, 500, 999]), noise=torch.ones(x1.shape))
    step, _ = make_latent_step(port, process, dropout=False, class_dropout_prob=0.3)
    plain, _ = make_latent_step(port, process, dropout=False)
    a = step(state, t(x1), extras, 0, class_drop=drop, **kw)[1]
    by_hand = dict(extras, res_type=torch.where(drop[:, None], 29, extras["res_type"]))
    b = plain(state, t(x1), by_hand, 0, **kw)[1]
    assert float(a["loss"]) == float(b["loss"])
    d1, d2 = class_drop_draw(3, 1000, 0.3, "cpu"), class_drop_draw(3, 1000, 0.3, "cpu")
    assert torch.equal(d1, d2) and abs(float(d1.float().mean()) - 0.3) < 0.05
    assert not torch.equal(d1, class_drop_draw(4, 1000, 0.3, "cpu"))


def test_remat_grads_equal_the_plain_step_bit_for_bit():
    """--remat recomputes each layer in the backward, with the dropout masks
    keyed by the seed: at dropout 0.6 with self-conditioning (heads) and
    bf16 compute, its loss, grads and updated state are the plain step's
    bit for bit on the CPU."""
    res_type, cg, mask, x1 = _step_inputs()
    extras = {"res_type": t(res_type), "cg_xyz": t(cg), "mask": t(mask)}
    out = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(0)
        port = MPNNDenoiser(gen, dropout=0.6, remat=remat, self_condition=True, **STEP_CFG)
        with torch.no_grad():   # open the zero-initialised adaLN gates
            for name, p in port.named_parameters():
                if "Dense_0" in name and ("layers" in name or "w_out" in name):
                    p.normal_(0.0, 0.05, generator=gen)
        process = TD.create_diffusion(None, self_condition=True)
        state = TrainState(dict(port.named_parameters()), lambda s: 1e-3, grad_clip=1.0)
        step, _ = make_latent_step(port, process, compute_dtype=torch.bfloat16)
        state, m = step(state, t(x1), extras, 11, self_cond=True)
        out[remat] = (m, state)
    (m0, s0), (m1, s1) = out[False], out[True]
    assert float(m0["loss"]) == float(m1["loss"])
    for k, g in m0["grads"].items():
        assert torch.equal(g, m1["grads"][k]), k
        assert torch.equal(s0.params[k], s1.params[k]) and torch.equal(s0.ema_params[k],
                                                                        s1.ema_params[k])
    assert float(m0["grads"]["enc_layers.0.SplitMessageChain_1.W3"].abs().max()) > 0


def test_grad_accumulation_matches_optax_multisteps():
    """Six micro-steps at N = 3 with the same grads into TrainState and
    optax.MultiSteps(clip + adamw(warmup schedule)): params, moments, the
    optimizer count after each micro-step, and the EMA at decay ** (1/3)
    every micro-step."""
    N, decay, lr, warmup = 3, 0.9, 1e-2, 4
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    sched_j = lambda s: lr * jnp.minimum(jnp.asarray(s, jnp.float32), warmup) / warmup
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0),
                                      optax.adamw(sched_j, weight_decay=0.0)),
                          every_k_schedule=N)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(pj)
    ej = dict(pj)
    state = TrainState({k: t(v) for k, v in p0.items()}, warmup_linear_schedule(lr, warmup),
                       grad_clip=1.0, accum_steps=N)
    for i in range(6):
        g = {k: (rng.normal(size=v.shape) * (3.0 if i % 2 else 0.2)).astype(np.float32)
             for k, v in p0.items()}
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, pj)
        pj = optax.apply_updates(pj, upd)
        ej = update_ema(ej, pj, decay ** (1.0 / N))
        state.apply_gradients({k: t(v) for k, v in g.items()})
        state.update_ema(decay ** (1.0 / N))
        inner = opt.inner_opt_state[1][0]
        assert state.step == i + 1
        assert state.opt_state["count"] == int(inner.count) == (i + 1) // N
        assert state.opt_state["mini_step"] == int(opt.mini_step)
        for k in p0:
            np.testing.assert_allclose(state.params[k].numpy(), np.asarray(pj[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"params {k} at {i}")
            np.testing.assert_allclose(state.opt_state["mu"][k].numpy(), np.asarray(inner.mu[k]),
                                       rtol=1e-6, atol=1e-8, err_msg=f"mu {k}")
            np.testing.assert_allclose(state.opt_state["nu"][k].numpy(), np.asarray(inner.nu[k]),
                                       rtol=1e-6, atol=1e-9, err_msg=f"nu {k}")
            np.testing.assert_allclose(state.opt_state["acc"][k].numpy(),
                                       np.asarray(opt.acc_grads[k]), rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(state.ema_params[k].numpy(), np.asarray(ej[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"ema {k}")
    assert not np.allclose(state.params["a"].numpy(), p0["a"])


# ---------------------------------------------------------------------------
# guided sampling


@pytest.mark.parametrize("sampler,self_cond", [("ddim", False), ("ancestral", False),
                                               ("ancestral", True)])
def test_guided_sampling_matches_jax(monkeypatch, sampler, self_cond):
    """`_sample_from_cond_cfg` at cfg 1.5: one denoise a step over the batch
    and its null-token copy, the mean u + s (c - u), the variance from c;
    with a self-conditioned process the pred_xstart rides along doubled.
    JAX's x_T and (ancestral) per-step z are replayed."""
    exact_gathers(monkeypatch)
    res_type, cg, mask = ca_inputs(6, 2, 16, n_valid=[16, 10])
    model, params, port = denoiser_pair(3, res_type, cg, mask, self_condition=self_cond)
    jproc = JD.create_diffusion("ddim10", self_condition=self_cond)
    jpipe = JaxPipeline(denoiser=model, denoiser_params=params, process=jproc,
                        process_kind="diffusion", vae=None, vae_params=None, vq_state=None,
                        norm_mean=np.zeros(3), norm_std=np.ones(3), cfg_scale=1.5,
                        sampler=sampler)
    extras = {"res_type": res_type, "cg_xyz": cg, "mask": mask}
    key = jax.random.PRNGKey(2)
    want = jpipe.sample_latents(key, {k: jnp.asarray(v) for k, v in extras.items()})
    key, sub = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(sub, (2, 16, 3)))
    proc = TD.create_diffusion("ddim10", self_condition=self_cond)
    zs = (None if sampler == "ddim" else
          [t(z) for z in replay_ancestral_noises(key, proc.num_timesteps, (2, 16, 3))])
    pipe = SamplingPipeline(denoiser=port, process=proc, vae=None, codebook=None,
                            norm_mean=np.zeros(3), norm_std=np.ones(3), cfg_scale=1.5,
                            sampler=sampler, doubled_batch=True)
    got = pipe.sample_latents({k: t(v) for k, v in extras.items()}, noise=t(x_T), noises=zs)
    _close(got.numpy(), want, rel=1e-4)
    pipe.cfg_scale = 0.0
    unguided = pipe.sample_latents({k: t(v) for k, v in extras.items()}, noise=t(x_T),
                                   noises=zs)
    assert not torch.allclose(unguided, got)
