"""The adaLN `residual` mode of the port (DiT-style branch gates; the encoder's
edge update runs K6) against the JAX package, in f32 on the CPU at small
width (B2, L16, K8, H16): the encoder and decoder layers, the denoiser's
`denoise`, one training step at dropout 0, the identity at init with zero
gates, and the trainer's `--adaln_mode`.

Parameters are `random_params` (no zero gates, so every branch reaches the
output). Tolerances as the trunk tests (tests/test_torch_mpnn.py,
tests/test_torch_train_step.py): layers and `denoise` atol 1e-4 (f32, the
same function; the residual stream adds the branches to h_V and h_E, whose
scale is ~1); the training step's loss, mse and grad norm rtol 1e-4 and each
grad 1e-3 max|grad| (the featurizer's self-edge quaternions carry ~3e-4 of
rounding noise in both packages)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (ca_inputs, denoiser_pair, exact_gathers, jax_apply,
                           latent_step_pair, random_params, t)
from codlad_tpu.nn import mpnn as JM
from codlad_tpu_torch.cli import train_latent as CLI
from codlad_tpu_torch.convert.from_flax import load_flax
from codlad_tpu_torch.data.cg_batch import write_synthetic_features
from codlad_tpu_torch.nn import mpnn as TM

H, K = 16, 8
SMALL = dict(hidden_dim=H, edge_features=H, num_encoder_layers=2, num_decoder_layers=2,
             k_neighbors=K, adaln_mode="residual")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _layer_inputs(seed, B=2, L=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    idx = rng.integers(0, L, size=(B, L, K)).astype(np.int32)
    mask_V = (rng.random((B, L)) > 0.1).astype(np.float32)
    mask_attend = (rng.random((B, L, K)) > 0.2).astype(np.float32)
    return f(B, L, H), f(B, L, K, H), idx, mask_V, mask_attend, f(B, H), f(B, L, H)


def test_residual_encoder_layer_matches_jax():
    h_V, h_E, idx, mask_V, mask_attend, c, _ = _layer_inputs(0)
    layer = JM.EncLayerDiffusion(H, 2 * H, dropout=0.0, gate_mode="residual")
    args = (h_V, h_E, {"idx": jnp.asarray(idx)}, mask_V, mask_attend, c)
    p = random_params(layer, 3, *args)
    V_want, E_want = jax_apply(layer, p, *args)
    port = load_flax(TM.EncLayerDiffusion(H, _gen(), gate_mode="residual"), p)
    with torch.no_grad():
        V_got, E_got = port(t(h_V), t(h_E), t(idx), t(mask_V), t(mask_attend), t(c))
    np.testing.assert_allclose(V_got.numpy(), np.asarray(V_want), atol=1e-4)
    np.testing.assert_allclose(E_got.numpy(), np.asarray(E_want), atol=1e-4)
    assert np.abs(E_got.numpy() - h_E).max() > 1e-2  # the edge branch reached h_E


def test_residual_decoder_layer_matches_jax():
    """The chain's self input is modulate(LN(h_V)); s_node and v_node enter
    as given (unmodulated)."""
    h_V, h_E, idx, mask_V, _, c, s_node = _layer_inputs(1)
    v_node = 2.0 * h_V
    layer = JM.DecLayerDiffusion(H, 3 * H, dropout=0.0, gate_mode="residual")
    args = (h_V, {"idx": jnp.asarray(idx)}, h_E, s_node, v_node, mask_V, None, c,
            True, 2.0)
    p = random_params(layer, 4, *args)
    want = jax_apply(layer, p, *args)
    port = load_flax(TM.DecLayerDiffusion(H, _gen(), gate_mode="residual"), p)
    with torch.no_grad():
        got = port(t(h_V), t(idx), t(h_E), t(s_node), t(v_node), t(mask_V), t(c), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_residual_denoise_matches_jax(monkeypatch):
    exact_gathers(monkeypatch)
    res_type, cg, mask = ca_inputs(2, 2, 16, n_valid=[16, 11])
    model, params, port = denoiser_pair(1, res_type, cg, mask, **SMALL)
    assert port.adaln_mode == "residual"
    assert all(layer.gate_mode == "residual" for layer in [*port.enc_layers,
                                                           *port.dec_layers])
    x = np.random.default_rng(6).normal(size=(2, 16, 3)).astype(np.float32)
    steps = np.array([12, 640], np.int32)
    cond = jax_apply(model, params, res_type, cg, mask,
                     method=type(model).compute_condition)
    want = jax_apply(model, params, x, steps, cond, method=type(model).denoise)
    jc = {"idx": t(cond["nbr"]["idx"]), "h_E0": t(cond["h_E0"]), "h_S": t(cond["h_S"]),
          "maskf": t(cond["maskf"]), "mask_attend": t(cond["mask_attend"])}
    with torch.no_grad():
        got = port.denoise(t(x), t(steps), jc)
        # residual mode never takes the pair-fused path (JAX: trunk only)
        fused = port.denoise(t(x), t(steps), jc, fuse_pairs=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert torch.equal(fused, got)


@pytest.mark.parametrize("mode", ["trunk", "residual"])
def test_gate_modes_at_init(mode):
    """With the adaLN heads at their zero init, trunk mode zeroes the layer's
    outputs and residual mode is the identity (JAX `test_adaln_gate_modes`,
    tests/test_models.py:376-403), in both the encoder and the decoder."""
    h_V, h_E, idx, _, _, c, s_node = _layer_inputs(2)
    enc = TM.EncLayerDiffusion(H, _gen(5), dropout=0.0, gate_mode=mode)
    dec = TM.DecLayerDiffusion(H, _gen(6), dropout=0.0, gate_mode=mode)
    assert not enc.Dense_0.weight.any() and not dec.Dense_0.weight.any()
    with torch.no_grad():
        v, e = enc(t(h_V), t(h_E), t(idx), None, None, t(c))
        d = dec(t(h_V), t(idx), t(h_E), t(s_node), 2.0 * t(h_V), None, t(c), 2.0)
    want_v, want_e = (h_V, h_E) if mode == "residual" else (0.0 * h_V, 0.0 * h_E)
    np.testing.assert_allclose(v.numpy(), want_v, atol=1e-6)
    np.testing.assert_allclose(e.numpy(), want_e, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), want_v, atol=1e-6)


def test_gate_mode_is_checked():
    with pytest.raises(ValueError):
        TM.EncLayerDiffusion(H, _gen(), gate_mode="branch")


@pytest.fixture(scope="module")
def step_runs():
    return latent_step_pair(dict(SMALL, num_encoder_layers=1, num_decoder_layers=1),
                            1e-3, 1.0, 0.99)


def test_residual_training_step_loss_matches_jax(step_runs):
    jax_out, _, tm = step_runs
    for key in ("loss", "mse", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), jax_out[key], rtol=1e-4, err_msg=key)


def test_residual_training_step_grads_match_jax(step_runs):
    jax_out, tstate, tm = step_runs
    assert set(tm["grads"]) == set(jax_out["grads"]) == set(tstate.params)
    for name, want in jax_out["grads"].items():
        got = tm["grads"][name]
        atol = 1e-3 * float(want.abs().max()) + 1e-8
        torch.testing.assert_close(got, want, atol=atol, rtol=0, msg=name)
    # every edge-chain weight of the residual encoder gets a gradient through K6
    assert float(tm["grads"]["enc_layers.0.SplitMessageChain_1.W3"].abs().max()) > 0


def test_trainer_takes_adaln_mode(tmp_path):
    """`train_latent.main --adaln_mode residual` trains two steps on the CPU
    and records the mode in its config."""
    write_synthetic_features(str(tmp_path / "f"), 3, 12)
    state = CLI.main(["--feature_dir", str(tmp_path / "f"), "--exp", str(tmp_path / "e"),
                      "--batch_size", "2", "--max_steps", "2", "--log_step", "1",
                      "--warmup", "2", "--adaln_mode", "residual", "--device", "cpu"])
    assert state.step == 2
    cfg = json.loads((tmp_path / "e" / "config.json").read_text())
    assert cfg["adaln_mode"] == "residual"
    rows = [json.loads(r) for r in (tmp_path / "e" / "metrics.jsonl").read_text().splitlines()]
    rows = [r for r in rows if r["split"] == "train"]    # the run ends with a val row
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    with pytest.raises(SystemExit):
        CLI.build_parser().parse_args(["--feature_dir", "f", "--adaln_mode", "dit"])
