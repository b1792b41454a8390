"""The port's quantizers (codlad_tpu_torch/models/vq.py) against the JAX
package's (codlad_tpu/models/vq.py) on the same numpy inputs and states.

Every kind and reference alias (the table of tests/test_models.py
`test_build_quantize_reference_aliases`), in training and at eval: codes
equal; z_q, the commit loss and the new state within 1e-6; the gradient of
sum(z_q * c) + loss through each straight-through (the identity, the
ReinMax one-hot, FSQ's round) against jax.grad within 1e-6 + 1e-5 |ref|.
JAX's random draws are replayed and handed to the port: the Gumbel noise
of `jax.random.categorical` (jax.random.gumbel of the same key and
shape), the expiry rows (jax.random.randint) and the orthogonal loss's
subsample (jax.random.choice without replacement). FSQ bit for bit (z_q and
the mixed-radix index), odd and even levels. `snap` of every kind, and a
quantizer state carried through the npz format (read_flax_npz's
`vq_state`) to the same codes. One f32 make_vqvae_step of FSQ, rvq, the
Gumbel and the expiring kinds against JAX's, at the limits of
tests/test_torch_stage1_variants.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import t
from codlad_tpu.models import vq as JVQ
from codlad_tpu_torch.models import vq as TVQ

# (reference method string, kind, codebook size) as tests/test_models.py's table
ALIASES = [("vqema", "vqvae", 16), ("vqvae", "vqvae", 16), ("vq_3", "vqvae", 16),
           ("fsq_5", "fsq", 16), ("Expiring_stalevq", "expire", 16),
           ("orthogonal_vq", "orthogonal", 16), ("headvq", "multihead", 16),
           ("low_cosvq_3", "cosine", 16 * 16), ("low3_num16_gumble_cos", "gumbel", 16 * 16),
           ("rvq", "rvq", 16), ("cosine", "cosine", 16), ("gumbel", "gumbel", 16),
           ("expire", "expire", 16), ("orthogonal", "orthogonal", 16), ("fsq", "fsq", 16),
           ("multihead", "multihead", 16)]


def _dim(kind):
    return 5 if kind == "fsq" else (8 if kind == "multihead" else 3)


def _np_state(rng, n_codes, dim):
    cb = rng.normal(size=(n_codes, dim)).astype(np.float32)
    cs = rng.uniform(0, 4, size=n_codes).astype(np.float32)
    cs[::5] = 0.0        # never assigned: frozen unless hit now (and dead for expiry)
    return cb, cs, (cb * np.maximum(cs, 1e-3)[:, None]).astype(np.float32)


def _states(q, seed):
    """(JAX state, port state) of quantizer kind q from numpy draws."""
    if q.kind == "fsq":
        return None, None
    rng = np.random.default_rng(seed)
    n = q.n_stages if q.kind == "rvq" else (q.n_heads if q.kind == "multihead" else 1)
    d = q.dim // q.n_heads if q.kind == "multihead" else q.dim
    arrs = [_np_state(rng, q.codebook_size, d) for _ in range(n)]
    js = [JVQ.VQState(codebook=jnp.asarray(a), cluster_size=jnp.asarray(b),
                      embed_avg=jnp.asarray(c)) for a, b, c in arrs]
    ts = [TVQ.VQState(codebook=t(a), cluster_size=t(b), embed_avg=t(c)) for a, b, c in arrs]
    return (js, ts) if q.kind in ("rvq", "multihead") else (js[0], ts[0])


def _inputs(seed, dim, B=2, L=7):
    rng = np.random.default_rng(seed)
    z = (1.3 * rng.normal(size=(B, L, dim))).astype(np.float32)
    mask = np.ones((B, L), np.float32)
    mask[1, 5:] = 0.0
    c = rng.normal(size=(B, L, dim)).astype(np.float32)
    return z, mask, c


def _jax_draw(kind, q, rng, n_rows, state_j):
    if kind == "gumbel":
        return np.asarray(jax.random.gumbel(rng, (n_rows, q.codebook_size), jnp.float32))
    if kind == "expire":
        return np.asarray(jax.random.randint(rng, (q.codebook_size,), 0, n_rows))
    return None


def _close(got, want, err):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=1e-6, rtol=1e-6, err_msg=err)


def _check_states(got, want):
    if want is None:
        assert got is None
        return
    gl = got if isinstance(got, list) else [got]
    wl = want if isinstance(want, list) else [want]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        for k in ("codebook", "cluster_size", "embed_avg"):
            _close(getattr(g, k).detach().numpy(), getattr(w, k), k)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name,kind,size", ALIASES)
def test_quantizer_matches_jax(name, kind, size, train):
    dim = _dim(kind)
    heads = 4 if name == "multihead" else None
    qj = JVQ.build_quantize(name, codebook_size=16, dim=dim, n_heads=heads)
    qt = TVQ.build_quantize(name, codebook_size=16, dim=dim, n_heads=heads)
    assert (qj.kind, qj.codebook_size, qj.n_heads) == (qt.kind, qt.codebook_size, qt.n_heads)
    assert qt.kind == kind and qt.codebook_size == size
    sj, st = _states(qj, 1)
    z, mask, c = _inputs(2, dim)
    rng = jax.random.PRNGKey(3)
    noise = _jax_draw(kind, qj, rng, z.shape[0] * z.shape[1], sj) if train else None

    def jfn(zz):
        zq, idx, loss, new = qj.quantize(sj, zz, jnp.asarray(mask), train=train, rng=rng)
        return jnp.sum(zq * c) + loss, (zq, idx, loss, new)

    (_, (zq_j, idx_j, loss_j, new_j)), g_j = jax.value_and_grad(jfn, has_aux=True)(
        jnp.asarray(z))
    zt = t(z).requires_grad_(True)
    zq_t, idx_t, loss_t, new_t = qt.quantize(st, zt, t(mask), train=train,
                                             noise=None if noise is None else t(noise))
    (torch.sum(zq_t * t(c)) + loss_t).backward()
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(zq_t.detach().numpy(), zq_j, "z_q")
    _close(float(loss_t.detach()), float(loss_j), "loss")
    _check_states(new_t, new_j)
    g = zt.grad.numpy()
    assert np.all(np.abs(g - np.asarray(g_j)) <= 1e-6 + 1e-5 * np.abs(np.asarray(g_j))), \
        np.abs(g - np.asarray(g_j)).max()


@pytest.mark.parametrize("name", ["vqvae", "cosine", "gumbel", "expire", "fsq", "rvq",
                                  "multihead", "orthogonal"])
def test_snap_matches_jax(name):
    dim = _dim(name)
    qj = JVQ.build_quantize(name, codebook_size=16, dim=dim, n_heads=4 if name == "multihead"
                            else None)
    qt = TVQ.build_quantize(name, codebook_size=16, dim=dim, n_heads=4 if name == "multihead"
                            else None)
    sj, st = _states(qj, 4)
    z = _inputs(5, dim)[0].reshape(-1, dim)
    zq_j, idx_j = qj.snap(sj, jnp.asarray(z))
    zq_t, idx_t = qt.snap(st, t(z))
    assert idx_t.shape == idx_j.shape and np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(zq_t.numpy(), zq_j, "z_q")


@pytest.mark.parametrize("levels", [[7, 5, 5, 5, 5], [8, 5, 5], [8, 6, 4, 3]])
def test_fsq_bit_for_bit(levels):
    rng = np.random.default_rng(len(levels))
    z = (3.0 * rng.normal(size=(64, 9, len(levels)))).astype(np.float32)
    z[0, 0] = 0.0                                    # the offset's zero point
    zq_j, idx_j = JVQ.fsq_quantize(jnp.asarray(z), levels)
    zq_t, idx_t = TVQ.fsq_quantize(t(z), levels)
    assert np.array_equal(zq_t.numpy(), np.asarray(zq_j))
    assert idx_t.dtype == torch.int32 and np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert int(idx_t.max()) < np.prod(levels)


@pytest.mark.parametrize("reinmax", [True, False])
@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_gumbel_onehot_straight_through(reinmax, temperature):
    """The sampled one-hot and the ReinMax (or plain softmax) gradient."""
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(10, 12)).astype(np.float32)
    c = rng.normal(size=(10, 12)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def jfn(lg):
        oh, idx = JVQ._gumbel_onehot_st(key, lg, temperature=temperature, reinmax=reinmax)
        return jnp.sum(oh * c), (oh, idx)

    (_, (oh_j, idx_j)), g_j = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(logits))
    lt = t(logits).requires_grad_(True)
    noise = t(jax.random.gumbel(key, logits.shape, jnp.float32))
    oh_t, idx_t = TVQ._gumbel_onehot_st(lt, noise, temperature, reinmax)
    torch.sum(oh_t * t(c)).backward()
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(oh_t.detach().numpy(), oh_j, "one-hot")
    _close(lt.grad.numpy(), g_j, "grad")


def test_gumbel_eval_draws_nothing():
    q = TVQ.build_quantize("gumbel", codebook_size=16, dim=3)
    st = _states(JVQ.build_quantize("gumbel", codebook_size=16, dim=3), 8)[1]
    z = t(_inputs(9, 3)[0])
    state = torch.random.get_rng_state()
    a = q.quantize(st, z, train=False)
    b = q.quantize(st, z, train=False)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a[1], b[1]) and a[3] is st


def test_stochastic_sample_and_orthogonal_subsample_match_jax():
    qj = JVQ.build_quantize("vqvae", codebook_size=40, dim=3)
    sj, st = _states(qj, 10)
    z = _inputs(11, 3)[0]
    key = jax.random.PRNGKey(12)
    zq_j, idx_j = JVQ.vq_sample_stochastic(key, sj, jnp.asarray(z), temperature=0.7)
    noise = t(jax.random.gumbel(key, (z.shape[0] * z.shape[1], 40), jnp.float32))
    zq_t, idx_t = TVQ.vq_sample_stochastic(st, t(z), temperature=0.7, gumbel=noise)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    _close(zq_t.numpy(), zq_j, "z_q")
    want = JVQ.orthogonal_reg_loss(sj.codebook, weight=10.0, max_codes=25, rng=key)
    pick = t(jax.random.choice(key, 40, (25,), replace=False))
    got = TVQ.orthogonal_reg_loss(st.codebook, weight=10.0, max_codes=25, pick=pick)
    _close(float(got), float(want), "orthogonal loss on a subsample")
    drawn = TVQ.orthogonal_reg_loss(st.codebook, 10.0, 25, torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn) and float(drawn) != float(TVQ.orthogonal_reg_loss(st.codebook))


@pytest.mark.parametrize("name", ["rvq", "headvq", "vqvae"])
def test_state_tree_through_npz(tmp_path, name):
    """A quantizer state written as `vq_state/...` keys (scripts/
    export_flax_npz.py vq_state_arrays) comes back through read_flax_npz and
    snaps to JAX's codes."""
    from _torch_parity import export_script
    from codlad_tpu_torch.cli.test import _snap_of
    from codlad_tpu_torch.convert.from_flax import read_flax_npz

    qj = JVQ.build_quantize(name, codebook_size=16, dim=8)
    sj, _ = _states(qj, 13)
    np.savez(tmp_path / "w.npz", **export_script().vq_state_arrays(sj))
    cfg = {"train_section": "vqvae", "quantize_type": name, "codebook_size": 16, "vqdim": 8}
    snap = _snap_of(cfg, read_flax_npz(tmp_path / "w.npz")["vq_state"], "cpu")
    z = _inputs(14, 8)[0]
    want = np.asarray(qj.snap(sj, jnp.asarray(z))[1])
    got = snap["quantizer"].snap(snap["vq_state"], t(z))[1]
    assert np.array_equal(got.numpy(), want)


# (quantize_type, predict_angle, hold eval_step too): one f32 make_vqvae_step
# each of the kinds whose step differs from the plain EMA VQ's: FSQ's
# stateless codes past the codebook size (the angle decoder's recipe), the
# stage list and the repeated mask of rvq's metrics, and the replayed draws
# of the Gumbel and expiring kinds; the other kinds' quantize is held above
@pytest.mark.parametrize("qtype,angle,with_eval", [
    ("fsq_5", True, True), ("rvq", False, False), ("low3_num16_gumble_cos", False, True),
    ("Expiring_stalevq", False, False)])
def test_vqvae_step_with_quantizer_matches_jax(qtype, angle, with_eval):
    from test_torch_stage1_variants import vqvae_step_pair
    vqvae_step_pair("vqvae", qtype, angle, with_eval)
