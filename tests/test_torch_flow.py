"""Flow matching in the port (gen/flow.py, gen/ot.py, gen/solvers.py, the flow
branches of SamplingPipeline and make_latent_step) against the JAX package,
in f32 on the CPU, with JAX's draws replayed into the port.

* Each matcher's mu_t, sigma_t, u_t and lambda, and its whole
  sample_location_and_conditional_flow with JAX's t and eps (and, for the OT
  matchers, the plan JAX's split chain k_plan -> k_t, k_eps leads to):
  atol 1e-6.
* sample_plan, all four methods: the exact method's permutation equal to
  JAX's (native LAP against JAX's host LAP); the sinkhorn, unbalanced and
  partial plans within 1e-6; their re-pairings equal given JAX's
  categorical picks; wasserstein within 1e-6.
* odeint on an analytic field: nfe equal for every method; the final state
  within 1e-6 of max|x0| (the field decays the state from ~1); dopri5 at
  rtol = atol = 1e-4: its attempts (accept / reject) equal, their start
  times within 1e-3 relative (the error ratio is a difference of two nearly
  equal fifth- and fourth-order states, whose f32 rounding differs between
  XLA and torch).
* SamplingPipeline.sample_latents with a flow kind and each solver (and one
  guided draw) against JAX's pipeline with the same weights and x0: within
  1e-5 of max|latent|; the pipeline's nfe (dopri5: 7 an attempt). An sbcfm
  denoiser (2C channels) cannot be integrated in either package: both
  raise.
* make_latent_step for icfm, otcfm, fm, vpfm, sbcfm and backbone at dropout
  0 against JAX's train step with the replayed draws (k_x0, k_fm, k_drop):
  loss within rtol 1e-5, each parameter's grad within 1e-5 of its max|grad|
  (the edge featurizer's and w_e's within 1e-4: EDGE_FEATURE_TOL), the aux
  `weight` (token count) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (SMALL, ca_inputs, exact_gathers, random_params, record_grads, t)
from codlad_tpu.eval.harness import SamplingPipeline as JaxPipeline
from codlad_tpu.gen import flow as JF
from codlad_tpu.gen import ot as JOT
from codlad_tpu.gen.solvers import odeint as jax_odeint
from codlad_tpu.models import denoiser as JDEN
from codlad_tpu.train.state import create_train_state
from codlad_tpu.train.steps import make_latent_step as jax_make_latent_step
from codlad_tpu_torch.convert.from_flax import flax_to_state_dict, load_flax
from codlad_tpu_torch.eval.harness import SamplingPipeline
from codlad_tpu_torch.gen import flow as TF
from codlad_tpu_torch.gen import ot as TOT
from codlad_tpu_torch.gen.solvers import NFE_PER_STEP, odeint
from codlad_tpu_torch.models.denoiser import MPNNDenoiser
from codlad_tpu_torch.train.state import TrainState
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


KINDS = ("icfm", "otcfm", "fm", "vpfm", "sbcfm")
# The grads of the edge featurizer's weights and of w_e (the edge embedding
# it feeds) carry the self-edge quaternions' f32 rounding (see
# tests/test_torch_mpnn.py): up to 3e-5 of their max|grad| here, so they are
# held at 1e-4 (the diffusion step's test holds every grad at 1e-3).
EDGE_FEATURES = ("features.", "w_e.")
EDGE_FEATURE_TOL = 1e-4


def _x(seed, shape=(6, 5, 3)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_matcher_terms(kind):
    jm, tm = JF.FLOW_MATCHERS[kind](), TF.FLOW_MATCHERS[kind]()
    x0, x1, xt = _x(1), _x(2), _x(3)
    tt = np.random.default_rng(4).uniform(0.05, 0.95, 6).astype(np.float32)
    _close(tm.compute_mu_t(t(x0), t(x1), t(tt)), jm.compute_mu_t(x0, x1, jnp.asarray(tt)))
    _close(tm.compute_sigma_t(t(tt)), jm.compute_sigma_t(jnp.asarray(tt)))
    _close(tm.compute_conditional_flow(t(x0), t(x1), t(tt), t(xt)),
           jm.compute_conditional_flow(x0, x1, jnp.asarray(tt), xt))
    _close(tm.compute_lambda(t(tt)), jm.compute_lambda(jnp.asarray(tt)), atol=1e-6 * 2e8)


def _matcher_draws(kind, rng, shape):
    """t and eps of JAX's matcher from `rng` (after k_plan for the OT ones)."""
    if kind in ("otcfm", "sbcfm"):
        _, rng = jax.random.split(rng)
    k_t, k_eps = jax.random.split(rng)
    return (np.asarray(JF.sample_t_sigmoid(k_t, shape[0])),
            np.asarray(jax.random.normal(k_eps, shape)))


@pytest.mark.parametrize("kind", KINDS)
def test_sample_location_with_replayed_draws(kind):
    x0, x1 = _x(5), _x(6)
    rng = jax.random.PRNGKey(7)
    want = JF.FLOW_MATCHERS[kind]().sample_location_and_conditional_flow(
        rng, jnp.asarray(x0), jnp.asarray(x1), return_noise=True)
    tt, eps = _matcher_draws(kind, rng, x0.shape)
    got = TF.FLOW_MATCHERS[kind]().sample_location_and_conditional_flow(
        t(x0), t(x1), t=t(tt), eps=t(eps), return_noise=True)
    for g, w in zip(got, want):
        _close(g, w)


def test_exact_plan_permutation_equal_jax():
    x0, x1 = _x(8, (24, 7, 3)), _x(9, (24, 7, 3))
    cost_t = TOT._pairwise_sq_dists(t(x0), t(x1))
    cost_j = JOT._pairwise_sq_dists(jnp.asarray(x0), jnp.asarray(x1))
    _close(cost_t, cost_j, atol=1e-4)
    col_t = TOT.exact_assignment(cost_t)
    np.testing.assert_array_equal(col_t.numpy(), np.asarray(JOT.exact_assignment(cost_j)))
    got = TOT.sample_plan(t(x0), t(x1), "exact")
    want = JOT.sample_plan(jax.random.PRNGKey(0), jnp.asarray(x0), jnp.asarray(x1), "exact")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert TOT.LAP_STATS["calls"] >= 2
    _close(TOT.wasserstein(t(x0), t(x1)), JOT.wasserstein(jnp.asarray(x0), jnp.asarray(x1)),
           atol=1e-5)


@pytest.mark.parametrize("method", ["sinkhorn", "unbalanced", "partial"])
def test_entropic_plans_and_picks_equal_jax(method):
    x0, x1 = _x(10, (8, 4, 3)), _x(11, (8, 4, 3))
    # a cost of order one, so that reg 0.05 gives plans that are not one-hot
    x0, x1 = x0 * 0.2, x1 * 0.2
    cost_j = JOT._pairwise_sq_dists(jnp.asarray(x0), jnp.asarray(x1))
    jplan = {"sinkhorn": JOT.sinkhorn_plan, "unbalanced": JOT.unbalanced_plan,
             "partial": JOT.partial_plan}[method](cost_j)
    tplan = TOT.plan_of(t(np.asarray(cost_j)), method)
    _close(tplan, jplan)
    assert 0.01 < float(tplan.max()) < 0.125     # not a permutation matrix
    rng = jax.random.PRNGKey(12)
    want = JOT.sample_plan(rng, jnp.asarray(x0), jnp.asarray(x1), method)
    logits = jnp.log(jnp.maximum(jplan, 1e-30))      # JAX sample_plan's categorical
    if method == "sinkhorn":
        pick = jax.random.categorical(rng, logits, axis=1)
    else:
        pick = jax.random.categorical(rng, logits.reshape(-1), shape=(8,))
    got = TOT.sample_plan(t(x0), t(x1), method, pick=t(np.asarray(pick)).long())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    drawn = TOT.sample_plan(t(x0), t(x1), method, generator=torch.Generator().manual_seed(0))
    assert drawn[0].shape == drawn[1].shape == x0.shape


# dopri5's tolerances: well above f32 rounding of the O(1) state, so that
# the error estimate is truncation, not rounding noise
TOL_ODE = 1e-4


def _field(mod):
    return lambda tt, x: -8.0 * x * tt + mod.cos(12.0 * tt) * mod.tanh(x)


@pytest.mark.parametrize("method,steps", [("euler", 7), ("midpoint", 5), ("rk4", 3),
                                          ("dopri5", 6)])
def test_solvers_match_jax(method, steps):
    x0 = _x(13, (2, 5, 3))
    times = []
    jf = _field(jnp)

    def recorded(tt, x):
        jax.debug.callback(lambda v: times.append(float(v)), tt, ordered=True)
        return jf(tt, x)

    xj, nfe_j = jax.jit(lambda x: jax_odeint(recorded, x, 0.0, 1.0, steps=steps, method=method,
                                             rtol=TOL_ODE, atol=TOL_ODE))(jnp.asarray(x0))
    stats = {}
    xt, nfe_t = odeint(_field(torch), t(x0), 0.0, 1.0, steps=steps, method=method,
                       rtol=TOL_ODE, atol=TOL_ODE, stats=stats)
    assert nfe_t == int(nfe_j)
    _close(xt, xj, atol=1e-6 * float(np.abs(x0).max()))
    if method == "dopri5":
        starts = times[0::7]
        accept_j = [b > a for a, b in zip(starts, starts[1:])]
        accept_t = [b > a for a, b in zip(stats["times"], stats["times"][1:])]
        assert accept_t == accept_j and stats["rejected"] > 0
        np.testing.assert_allclose(stats["times"], starts, rtol=1e-3, atol=1e-6)
        assert stats["accepted"] + stats["rejected"] == stats["host_syncs"] == nfe_t // 7


def _flow_denoisers(seed, res_type, cg, mask, learn_sigma=False):
    model = JDEN.mpnn_diffusion(input_size=3, learn_sigma=learn_sigma, dropout=0.0, **SMALL)
    params = random_params(model, seed, jnp.zeros(cg.shape),
                           jnp.zeros((cg.shape[0],), jnp.int32), res_type, cg, mask)
    port = MPNNDenoiser(torch.Generator().manual_seed(seed), learn_sigma=learn_sigma, **SMALL)
    return model, params, load_flax(port, params)


def _pipelines(kind, method, steps, cfg, learn_sigma=False):
    res_type, cg, mask = ca_inputs(20, 2, 16, n_valid=[16, 12])
    model, params, port = _flow_denoisers(21, res_type, cg, mask, learn_sigma)
    common = dict(norm_mean=np.zeros(3, np.float32), norm_std=np.ones(3, np.float32),
                  cfg_scale=cfg)
    jp = JaxPipeline(denoiser=model, denoiser_params=params, process=None, process_kind=kind,
                     vae=None, vae_params=None, vq_state=None, ode_steps=steps,
                     ode_method=method, **common)
    tp = SamplingPipeline(denoiser=port, process=None, vae=None, codebook=None,
                          process_kind=kind, ode_steps=steps, ode_method=method, **common)
    extras = {"res_type": res_type, "cg_xyz": cg, "mask": mask}
    return jp, tp, extras


@pytest.mark.parametrize("kind,method,steps,cfg", [
    ("icfm", "euler", 4, 0.0), ("otcfm", "midpoint", 3, 0.0), ("fm", "rk4", 2, 0.0),
    ("vpfm", "dopri5", 3, 0.0), ("icfm", "euler", 3, 1.5)])
def test_flow_sampling_matches_jax(monkeypatch, kind, method, steps, cfg):
    exact_gathers(monkeypatch)
    jp, tp, extras = _pipelines(kind, method, steps, cfg)
    key = jax.random.PRNGKey(22)
    want = np.asarray(jp.sample_latents(key, {k: jnp.asarray(v) for k, v in extras.items()}))
    x0 = np.asarray(jax.random.normal(jax.random.split(key)[1], want.shape))
    got = tp.sample_latents({k: t(v) for k, v in extras.items()}, noise=t(x0)).numpy()
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-5 * scale, (np.abs(got - want).max(), scale)
    assert np.abs(want - x0).max() > 1e-3 * scale       # the draws moved the noise
    ode = tp.last_ode
    assert ode["nfe"] == (7 * ode["host_syncs"] if method == "dopri5"
                          else steps * NFE_PER_STEP[method])


def test_sbcfm_sampling_fails_in_both(monkeypatch):
    """An sbcfm denoiser emits 2C channels (velocity, score); JAX's odeint
    cannot add them to the C-channel state, nor can the port's."""
    exact_gathers(monkeypatch)
    jp, tp, extras = _pipelines("sbcfm", "euler", 2, 0.0, learn_sigma=True)
    with pytest.raises(TypeError, match="broadcast|shapes"):
        jp.sample_latents(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in extras.items()})
    with pytest.raises(ValueError, match="6 channels for a 3-channel"):
        tp.sample_latents({k: t(v) for k, v in extras.items()},
                          generator=torch.Generator().manual_seed(0))


def _jax_flow_draws(kind, rng, shape):
    if kind == "backbone":
        k_x0, _ = jax.random.split(rng)
        return {"x0": np.asarray(jax.random.normal(k_x0, shape))}
    k_x0, k_fm, _ = jax.random.split(rng, 3)
    tt, eps = _matcher_draws(kind, k_fm, shape)
    return {"x0": np.asarray(jax.random.normal(k_x0, shape)), "t": tt, "eps": eps}


@pytest.mark.parametrize("kind", KINDS + ("backbone",))
def test_flow_train_step_matches_jax(monkeypatch, kind):
    exact_gathers(monkeypatch)
    B, L = 3, 16
    cfg = dict(SMALL, num_encoder_layers=1, k_neighbors=8)
    res_type, cg, mask = ca_inputs(30, B, L, n_valid=[16, 11, 14])
    x1 = np.random.default_rng(31).normal(size=(B, L, 3)).astype(np.float32)
    learn_sigma = kind == "sbcfm"
    model = JDEN.mpnn_diffusion(input_size=3, learn_sigma=learn_sigma, dropout=0.0, **cfg)
    params = random_params(model, 32, jnp.zeros((B, L, 3)), jnp.zeros((B,), jnp.int32),
                           res_type, cg, mask)
    port = load_flax(MPNNDenoiser(torch.Generator().manual_seed(0), learn_sigma=learn_sigma,
                                  **cfg), params)
    jproc = None if kind == "backbone" else JF.FLOW_MATCHERS[kind]()
    tx = optax.chain(record_grads(), optax.adamw(1e-3, weight_decay=0.0))
    state = create_train_state(params, tx, with_ema=True)
    extras = {"res_type": jnp.asarray(res_type), "cg_xyz": jnp.asarray(cg),
              "mask": jnp.asarray(mask)}
    rng = jax.random.PRNGKey(33)
    step, _ = jax_make_latent_step(model, jproc, process_kind=kind, dropout=False)
    new, m = step(state, jnp.asarray(x1), extras, rng)
    grads = flax_to_state_dict(jax.device_get(new.opt_state[0]))

    tproc = None if kind == "backbone" else TF.FLOW_MATCHERS[kind]()
    tstate = TrainState(dict(port.named_parameters()), lambda s: 1e-3)
    tstep, teval = make_latent_step(port, tproc, process_kind=kind, dropout=False)
    draws = {k: t(v) for k, v in _jax_flow_draws(kind, rng, x1.shape).items()}
    textras = {"res_type": t(res_type), "cg_xyz": t(cg), "mask": t(mask)}
    tstate, tm = tstep(tstate, t(x1), textras, 0, draws=draws)
    np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]), rtol=1e-5)
    assert float(tm["weight"]) == float(m["weight"]) == float(mask.sum())
    if kind == "sbcfm":
        np.testing.assert_allclose(float(tm["score"]), float(m["score"]), rtol=1e-5)
    assert set(grads) == set(tm["grads"])
    for name, want in grads.items():
        atol = (EDGE_FEATURE_TOL if name.startswith(EDGE_FEATURES) else 1e-5) * float(
            want.abs().max()) + 1e-12
        torch.testing.assert_close(tm["grads"][name], want, atol=atol, rtol=0, msg=name)
    ev = teval(tstate, t(x1), textras, 1, draws=draws)
    assert torch.isfinite(ev["loss"]) and float(ev["weight"]) == float(mask.sum())
