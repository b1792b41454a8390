"""The port's autoregressive ProteinMPNN (codlad_tpu_torch/models/
protein_mpnn.py, nn/mpnn.ProteinFeatures) against the JAX package's, on
the CPU in f32 at small widths (hidden 32, 2 + 2 layers, K 6, 21 letters,
two chains of 12 residues, one with a masked tail), JAX's featurizer in its
exact `idx` gather mode, the weights carried over by
convert/from_flax.load_flax.

* The full-backbone featurizer: E_idx equal, E within 1e-4 (the C-alpha
  featurizer of the default ca_only model is tests/test_torch_mpnn.py's).
* The teacher-forced log-probs, `unconditional_probs` and both
  `conditional_probs` modes within 1e-5 of JAX's.
* `sample` (plain, and with every probability adjustment) and
  `tied_sample` with JAX's Gumbel draws replayed (its key-split chain run
  here, one split a step or group, the noise passed in): S and the
  decoding order equal, the probs within 1e-5.
* The properties JAX's tests/test_protein_mpnn.py holds, on the port:
  normalisation, the sampler against the teacher-forced forward,
  causality, omitted letters never drawn, tied positions equal; training
  dropout seeded by a torch Generator.
* class_shuffle_order: bit for bit JAX's for one Generator seed, empty
  labels too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import export_script, load_flax, random_params, t
from codlad_tpu.data.shards import class_shuffle_order as jax_class_shuffle_order
from codlad_tpu.models import protein_mpnn as JPM
from codlad_tpu.nn import mpnn as jax_mpnn
from codlad_tpu_torch.data.shards import class_shuffle_order
from codlad_tpu_torch.data.synthetic import random_ca_trace
from codlad_tpu_torch.models import protein_mpnn as PM
from codlad_tpu_torch.nn.mpnn import ProteinFeatures

B, L, K, V = 2, 12, 6, 21
CFG = dict(hidden_dim=32, node_features=32, edge_features=32, num_encoder_layers=2,
           num_decoder_layers=2, k_neighbors=K, dropout=0.0, num_letters=V, vocab=V)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _backbone(rng, ca):
    """N, CA, C, O [B, L, 4, 3] around C-alpha traces."""
    off = rng.normal(size=(3,) + ca.shape) * 1.2
    return np.stack([ca + off[0], ca, ca + off[1], ca + off[1] + off[2] * 0.8],
                    axis=2).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    ca = np.stack([random_ca_trace(rng, L) for _ in range(B)]).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[1, -3:] = 0.0
    s = dict(X=ca, Xbb=_backbone(rng, ca), mask=mask,
             S_true=rng.integers(0, V, (B, L)).astype(np.int32),
             chain_M=np.ones((B, L), np.float32),
             residue_idx=np.broadcast_to(np.arange(L), (B, L)).astype(np.int32),
             chains=np.zeros((B, L), np.int32),
             randn=rng.normal(size=(B, L)).astype(np.float32))
    s["chain_M"][0, :2] = 0.0          # two fixed positions in chain 0
    model = JPM.ProteinMPNN(**CFG)
    args = [jnp.asarray(s[k]) for k in ("X", "S_true", "mask", "chain_M", "residue_idx",
                                        "chains", "randn")]
    params = random_params(model, 1, *args)
    port = load_flax(PM.ProteinMPNN(torch.Generator().manual_seed(0), **CFG), params).eval()
    s.update(model=model, params=params, port=port,
             T={k: t(v) for k, v in s.items() if isinstance(v, np.ndarray)})
    return s


def _jx(s, *keys):
    return [jnp.asarray(s[k]) for k in keys]


def _pt(s, *keys):
    return [s["T"][k] for k in keys]


def test_backbone_features_match_jax(setup):
    s = setup
    jf = jax_mpnn.ProteinFeatures(32, top_k=K)
    args = _jx(s, "Xbb", "mask", "residue_idx", "chains")
    p = random_params(jf, 2, *args)
    with export_script().exact_gathers():
        E_j, idx_j = jax.jit(jf.apply)(p, *args)
    pf = load_flax(ProteinFeatures(32, torch.Generator().manual_seed(0), top_k=K), p)
    E_p, idx_p = pf(*_pt(s, "Xbb", "mask", "residue_idx", "chains"))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    _close(E_p.detach(), E_j, atol=1e-4)


def test_forward_and_unconditional_match_jax(setup):
    s = setup
    keys = ("X", "S_true", "mask", "chain_M", "residue_idx", "chains", "randn")
    with export_script().exact_gathers():
        lp_j = jax.jit(s["model"].apply)(s["params"], *_jx(s, *keys))
        un_j = jax.jit(lambda p, *a: s["model"].apply(
            p, *a, method=JPM.ProteinMPNN.unconditional_probs))(
                s["params"], *_jx(s, "X", "mask", "residue_idx", "chains"))
    with torch.no_grad():
        lp_p = s["port"](*_pt(s, *keys))
        un_p = s["port"].unconditional_probs(*_pt(s, "X", "mask", "residue_idx", "chains"))
    _close(lp_p, lp_j)
    _close(un_p, un_j)
    _close(torch.logsumexp(lp_p, -1), np.zeros((B, L)))


@pytest.mark.parametrize("backbone_only", [False, True])
def test_conditional_probs_match_jax(backbone_only, setup):
    s = setup
    keys = ("X", "S_true", "mask", "chain_M", "residue_idx", "chains", "randn")
    with export_script().exact_gathers():
        want = JPM.conditional_probs(s["model"], s["params"], *_jx(s, *keys),
                                     backbone_only=backbone_only)
    got = PM.conditional_probs(s["port"], *_pt(s, *keys), backbone_only=backbone_only)
    _close(got, want)
    assert np.all(got.numpy()[s["chain_M"] * s["mask"] == 0] == 0)


def _gumbels(seed, n):
    """The Gumbel draws of JAX's sampler: key, sub = split(key) a step,
    categorical(sub, logits [B, V]) = argmax(logits + gumbel(sub, [B, V]))."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (B, V), jnp.float32)))
    return torch.as_tensor(np.stack(out))


def _adjustments(s):
    rng = np.random.default_rng(5)
    omit = np.zeros(V, np.float32)
    omit[[0, 5]] = 1.0
    omit_mask = np.zeros((B, L, V), np.float32)
    omit_mask[:, 3, [1, 2, 3]] = 1.0
    pssm_bias = rng.dirichlet(np.ones(V), size=(B, L)).astype(np.float32)
    return dict(temperature=0.7, omit_AAs=omit, bias_AAs=rng.normal(size=V).astype(np.float32),
                bias_by_res=rng.normal(size=(B, L, V)).astype(np.float32) * 0.3,
                omit_AA_mask=omit_mask, pssm_coef=rng.uniform(0, 1, (B, L)).astype(np.float32),
                pssm_bias=pssm_bias, pssm_multi=0.5, pssm_bias_flag=True,
                pssm_log_odds_flag=True,
                pssm_log_odds_mask=(rng.uniform(size=(B, L, V)) > 0.2).astype(np.float32))


@pytest.mark.parametrize("adjusted", [False, True])
def test_sample_matches_jax(adjusted, setup):
    s = setup
    keys = ("X", "randn", "S_true", "chain_M", "chains", "residue_idx", "mask")
    kw = _adjustments(s) if adjusted else {}
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) and v.ndim > 1 else v)
           for k, v in kw.items()}
    pkw = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    with export_script().exact_gathers():
        want = JPM.sample(s["model"], s["params"], jax.random.PRNGKey(7), *_jx(s, *keys), **jkw)
    got = PM.sample(s["port"], *_pt(s, *keys), noise=_gumbels(7, L), **pkw)
    np.testing.assert_array_equal(got["decoding_order"].numpy(),
                                  np.asarray(want["decoding_order"]))
    np.testing.assert_array_equal(got["S"].numpy(), np.asarray(want["S"]))
    _close(got["probs"], want["probs"])


def test_tied_sample_matches_jax(setup):
    s = setup
    keys = ("X", "randn", "S_true", "chain_M", "chains", "residue_idx", "mask")
    tied, beta = [[1, 7], [2, 9], [4, 5, 6]], np.linspace(0.5, 1.5, L).astype(np.float32)
    with export_script().exact_gathers():
        want = JPM.tied_sample(s["model"], s["params"], jax.random.PRNGKey(11),
                               *[jnp.asarray(s[k]) if k != "randn" else s[k] for k in keys],
                               tied_pos=tied, tied_beta=beta, temperature=0.9)
    n_groups = L - 4
    got = PM.tied_sample(s["port"], *_pt(s, *keys), tied_pos=tied, tied_beta=beta,
                         temperature=0.9, noise=_gumbels(11, n_groups))
    np.testing.assert_array_equal(got["decoding_order"].numpy(),
                                  np.asarray(want["decoding_order"]))
    np.testing.assert_array_equal(got["S"].numpy(), np.asarray(want["S"]))
    _close(got["probs"], want["probs"])
    S = got["S"].numpy()
    # ties hold where chain_mask is 1: chain 0 fixes position 1, chain 1
    # masks position 9, and S_true is kept there
    assert S[1, 1] == S[1, 7] and S[0, 1] == s["S_true"][0, 1]
    assert (S[:, 4] == S[:, 5]).all() and (S[:, 5] == S[:, 6]).all()
    assert S[0, 2] == S[0, 9] and S[1, 9] == s["S_true"][1, 9]
    # the default draw comes from a torch Generator
    drawn = PM.tied_sample(s["port"], *_pt(s, *keys), tied_pos=tied,
                           generator=torch.Generator().manual_seed(0))
    assert (drawn["S"][:, 4] == drawn["S"][:, 6]).all()


def test_port_properties(setup):
    """JAX's own ProteinMPNN properties, held by the port."""
    s, port = setup, setup["port"]
    keys = ("X", "randn", "S_true", "chain_M", "chains", "residue_idx", "mask")
    out = PM.sample(port, *_pt(s, *keys), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        lp = port(*_pt(s, "X"), out["S"], *_pt(s, "mask", "chain_M", "residue_idx", "chains",
                                               "randn"),
                  use_input_decoding_order=True, decoding_order=out["decoding_order"])
    cm = (s["chain_M"] * s["mask"]) > 0
    np.testing.assert_allclose(out["probs"].numpy()[cm], lp.exp().numpy()[cm], rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_array_equal(out["S"].numpy()[~cm], s["S_true"][~cm])
    assert np.all(out["probs"].numpy()[~cm] == 0.0)

    order = torch.arange(L).expand(B, L)
    fwd = lambda S: port(*_pt(s, "X"), S, *_pt(s, "mask", "chain_M", "residue_idx", "chains",
                                                "randn"),
                         use_input_decoding_order=True, decoding_order=order)
    with torch.no_grad():
        base = fwd(s["T"]["S_true"])
        last = s["T"]["S_true"].clone()
        last[:, -1] = (last[:, -1] + 3) % V
        first = s["T"]["S_true"].clone()
        first[:, 0] = (first[:, 0] + 3) % V
        _close(fwd(last), base)
        pert = fwd(first)
    _close(pert[:, 0], base[:, 0])
    assert (base[:, 1:] - pert[:, 1:]).abs().max() > 1e-4

    omit = torch.zeros(V)
    omit[[0, 5, 20]] = 1.0
    out = PM.sample(port, *_pt(s, *keys), omit_AAs=omit, temperature=2.0,
                    generator=torch.Generator().manual_seed(4))
    assert not np.isin(out["S"].numpy()[cm], [0, 5, 20]).any()

    # training dropout, its masks from a torch Generator: seeded and
    # normalised; at rate 0 the deterministic forward
    args = _pt(s, "X", "S_true", "mask", "chain_M", "residue_idx", "chains", "randn")
    dropping = load_flax(PM.ProteinMPNN(torch.Generator().manual_seed(0),
                                        **dict(CFG, dropout=0.3)), s["params"])
    run = lambda m, seed: m(*args, deterministic=False,
                            generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        d1, d1b, d2 = run(dropping, 1), run(dropping, 1), run(dropping, 2)
        assert torch.equal(run(port, 1), port(*args))
    assert torch.equal(d1, d1b) and (d1 - d2).abs().max() > 1e-3
    _close(torch.logsumexp(d1, -1), np.zeros((B, L)))
    with pytest.raises(ValueError):
        dropping(*args, deterministic=False)

    groups, flat = PM.build_tied_groups(np.array([3, 1, 0, 2, 4]), [[1, 4]], 5)
    assert flat.tolist() == [3, 1, 4, 0, 2] and groups.tolist() == [[3, -1], [1, 4], [0, -1],
                                                                   [2, -1]]


@pytest.mark.parametrize("labels", [[0, 0, 1, 1, 1, 2, 2], [5, 3, 5, 9, 3, 3, 0, 9], []])
def test_class_shuffle_order_equals_jax(labels):
    got = class_shuffle_order(np.asarray(labels, np.int64), np.random.default_rng(4))
    want = jax_class_shuffle_order(np.asarray(labels, np.int64), np.random.default_rng(4))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and sorted(got.tolist()) == list(range(len(labels)))
