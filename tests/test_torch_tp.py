"""The tensor product (K10) and its tables against the JAX package.

* The port's committed coupling constants equal
  codlad_tpu.nn.irreps.coupling_tensor bit for bit, and its
  fused_tp_tables equal the JAX tables exactly, for the encoder ladder's
  three layer signatures.
* The kernel's nonzero lists (`sparse_tables`) rebuild the dense tables
  exactly.
* sh_l2 matches at 1e-6, zero vectors (padded edges) included.
* The plain K10 (the wrapper's CPU path) against the JAX `ref_fused_tp` and
  the Pallas `_pallas_fused_tp` in interpret mode, 3-d edge operands and
  4-d cross-graph operands, at atol 2e-4 + rtol 2e-4 in f32 (as
  tests/test_kernels.py holds the Pallas kernel), and in bf16 against the
  JAX `ref_fused_tp` (the same rounding steps) at atol 2e-2 + rtol 2e-2,
  ~2.5 bf16 ulps for sums taken in another order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from codlad_tpu.kernels import tp_kernels as JTK
from codlad_tpu.models.encoder import irrep_ladder as jax_ladder
from codlad_tpu.nn import irreps as JI
from codlad_tpu.nn.tensor_product import fused_tp_tables as jax_tables
from codlad_tpu_torch.kernels import tp_kernels as TK
from codlad_tpu_torch.models.encoder import irrep_ladder
from codlad_tpu_torch.nn import irreps as PI
from codlad_tpu_torch.nn.tensor_product import fused_tp_tables

SIGS = [0, 1, 2]  # layer l: ladder[l] -> ladder[l + 1]


def _tables(layer):
    lad, jlad = irrep_ladder(12, 4), jax_ladder(12, 4)
    port = fused_tp_tables(tuple(lad[layer]), tuple(PI.SH_IRREPS), tuple(lad[layer + 1]))
    ref = jax_tables(tuple(jlad[layer]), tuple(JI.SH_IRREPS), tuple(jlad[layer + 1]))
    return port, ref


def test_coupling_constants_equal_jax():
    for triple in PI._COUPLING:
        np.testing.assert_array_equal(PI.coupling_tensor(*triple), JI.coupling_tensor(*triple))
    assert PI.coupling_tensor(0, 2, 1) is None and JI.coupling_tensor(0, 2, 1) is None


@pytest.mark.parametrize("layer", SIGS)
def test_tables_equal_jax(layer):
    port, ref = _tables(layer)
    for k in ("CBIG", "CBIG_R", "EXPW", "SUMR", "widx", "tidx"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    assert (port["numel"], port["KT"], port["R"]) == (ref["numel"], ref["KT"], ref["R"])


@pytest.mark.parametrize("layer", SIGS)
def test_sparse_tables_rebuild_dense(layer):
    tb, _ = _tables(layer)
    sp = TK.sparse_tables(tb)
    R, dout = tb["SUMR"].shape
    cbig, expw, sumr = (np.zeros_like(tb[k]) for k in ("CBIG_R", "EXPW", "SUMR"))
    for c in range(dout):
        for q in range(sp["cptr"][c], sp["cptr"][c + 1]):
            z = slice(sp["rptr"][q], sp["rptr"][q + 1])
            # q is a reordered expansion column; place it back by content
            cbig[sp["rows"][z], q] = sp["coef"][z]
            expw[sp["widx"][q], q] = 1.0
            sumr[q, c] = 1.0
    assert sp["cptr"][-1] == R and sp["nnz"] == np.count_nonzero(tb["CBIG_R"])
    # same columns up to the reordering
    order = np.argsort(tb["SUMR"].argmax(1), kind="stable")
    for k, got in (("CBIG_R", cbig), ("EXPW", expw)):
        np.testing.assert_array_equal(got, tb[k][:, order], err_msg=k)
    np.testing.assert_array_equal(sumr, tb["SUMR"][order])


def test_sh_matches_jax():
    rng = np.random.default_rng(0)
    vec = rng.normal(size=(50, 3)).astype(np.float32) * 5
    vec[:5] = 0.0  # padded edges: redirected to x-hat before the norm
    got = PI.sh_l2(torch.from_numpy(vec)).numpy()
    np.testing.assert_allclose(got, np.asarray(JI.sh_l2(jnp.asarray(vec))), atol=1e-6)
    np.testing.assert_array_equal(got[0], PI.sh_l2(torch.tensor([1.0, 0.0, 0.0])).numpy())


def _inputs(tb, layer, lead, seed):
    rng = np.random.default_rng(seed)
    din = irrep_ladder(12, 4)[layer].dim
    x = rng.normal(size=lead + (din,)).astype(np.float32)
    sh = np.array(JI.sh_l2(jnp.asarray(rng.normal(size=lead + (3,)).astype(np.float32))))
    w = (rng.normal(size=lead + (tb["numel"],)) * din ** -0.5).astype(np.float32)
    return x, sh, w


@pytest.mark.parametrize("layer", SIGS)
@pytest.mark.parametrize("lead", [(2, 40), (2, 3, 14)], ids=["edges", "cross"])
def test_fused_tp_plain_matches_jax(layer, lead):
    tb, _ = _tables(layer)
    x, sh, w = _inputs(tb, layer, lead, seed=layer)
    jt = [jnp.asarray(tb[k]) for k in ("CBIG_R", "EXPW", "SUMR")]
    got = TK.fused_tp(torch.from_numpy(x), torch.from_numpy(sh), torch.from_numpy(w), tb)
    assert got.shape == lead + (tb["SUMR"].shape[1],) and got.dtype == torch.float32
    want = JTK.ref_fused_tp(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w), *jt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    # the Pallas kernel in interpret mode, on the operands flattened to rows
    flat = lambda a: jnp.asarray(a.reshape(lead[0], -1, a.shape[-1]))
    call = pl.pallas_call
    try:
        JTK.pl.pallas_call = functools.partial(call, interpret=True)
        pallas = JTK._pallas_fused_tp(flat(x), flat(sh), flat(w), *jt)
    finally:
        JTK.pl.pallas_call = call
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas).reshape(got.shape),
                               atol=2e-4, rtol=2e-4)
    # bf16: the same rounding steps as the JAX reference twin
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    got16 = TK.fused_tp(*(torch.from_numpy(a).to(torch.bfloat16) for a in (x, sh, w)), tb)
    want16 = JTK.ref_fused_tp(bf(x), bf(sh), bf(w), *(t.astype(jnp.bfloat16) for t in jt))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
