"""The port's e3nn basis reconstruction (codlad_tpu_torch/convert/e3nn_basis.py)
against the JAX package's and against e3nn's conventions.

* e3nn_w3j equals the pinned fixtures (tests/fixtures/e3nn_w3j.npz, all
  15 l <= 2 triples) within 1e-12.
* basis_change and the per-path signs equal JAX's; tp_weight_corrections
  equals JAX's bit for bit for every (in, out) pair of the encoder's irrep
  ladder (the encoder's, the cross graph's and CGPrior's TP signatures).
  The port's signs come from its committed coupling constants, JAX's from
  its SVD-solved ones.
* The port's FullyConnectedTP with corrected weights reproduces a numpy
  model of e3nn's FullyConnectedTensorProduct (tests/test_e3nn_basis.py)
  on the ladder's three signatures and on rotated edges (the l = 2 basis
  mix), float64 inputs, within 1e-6 (the TP's coupling tables are f32
  constants; a wrong sign or scale would be off by O(1)).
"""

import os

import numpy as np
import pytest
import torch

from codlad_tpu.convert import e3nn_basis as jeb
from codlad_tpu_torch.convert import e3nn_basis as peb
from codlad_tpu_torch.models.encoder import irrep_ladder
from codlad_tpu_torch.nn.irreps import Irreps, sh_l2, tp_paths
from codlad_tpu_torch.nn.tensor_product import FullyConnectedTP
from test_e3nn_basis import _e3nn_fctp_np, _rand_rot

SH = Irreps("1x0e + 1x1o + 1x2e")
LADDER = irrep_ladder(12, 4)


def test_w3j_matches_pinned_fixtures():
    fix = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "e3nn_w3j.npz"))
    n = 0
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(abs(l1 - l2), min(l1 + l2, 2) + 1):
                np.testing.assert_allclose(peb.e3nn_w3j(l1, l2, l3), fix[f"w3j_{l1}_{l2}_{l3}"],
                                           atol=1e-12, err_msg=f"w3j({l1},{l2},{l3})")
                n += 1
    assert n == 15 and peb.e3nn_w3j(0, 0, 1) is None


def test_basis_changes_and_signs_equal_jax():
    for l in range(3):
        np.testing.assert_array_equal(peb.basis_change(l), jeb.basis_change(l))
    for t in [(0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0), (1, 1, 1), (1, 2, 1)]:
        assert peb.path_ratio(*t) == jeb.path_ratio(*t), t
        assert peb.path_weight_multiplier(*t) == jeb.path_weight_multiplier(*t), t


def test_tp_weight_corrections_equal_jax_on_every_ladder_signature():
    n = 0
    for in_ir in LADDER:
        for out_ir in LADDER:
            if not tp_paths(in_ir, SH, out_ir):
                continue
            got = peb.tp_weight_corrections(in_ir, SH, out_ir)
            want = jeb.tp_weight_corrections(str_irreps(in_ir), "1x0e + 1x1o + 1x2e",
                                             str_irreps(out_ir))
            np.testing.assert_array_equal(got, want)
            n += 1
    assert n == 16
    dense = {"kernel": np.random.default_rng(0).normal(size=(7, 288)),
             "bias": np.arange(288.0)}
    got = peb.correct_weight_dense(dense, LADDER[1], SH, LADDER[2])
    want = jeb.correct_weight_dense(dense, str_irreps(LADDER[1]), "1x0e + 1x1o + 1x2e",
                                    str_irreps(LADDER[2]))
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(got[k], want[k])


def str_irreps(ir):
    return " + ".join(f"{mul}x{l}{'e' if p == 1 else 'o'}" for mul, l, p in ir)


@pytest.mark.parametrize("step,rotate", [(0, False), (1, False), (2, False), (3, True)])
def test_tp_parity_with_e3nn_semantics(step, rotate):
    """The port's TP on corrected weights == e3nn's TP on the raw weights."""
    from codlad_tpu.nn.irreps import Irreps as JIrreps
    in_ir, out_ir = LADDER[min(step, 3)], LADDER[min(step + 1, 3)]
    rng = np.random.default_rng(step)
    E = 7
    x = rng.normal(size=(E, in_ir.dim))
    v = rng.normal(size=(E, 3))
    if rotate:
        v = v @ _rand_rot(rng).T
    numel = sum(in_ir[i][0] * out_ir[k][0] for i, _, k in tp_paths(in_ir, SH, out_ir))
    w = rng.normal(size=(E, numel))
    ref = _e3nn_fctp_np(JIrreps(str_irreps(in_ir)), JIrreps("1x0e + 1x1o + 1x2e"),
                        JIrreps(str_irreps(out_ir)), x, peb.e3nn_sh_np(v), w)
    mult = peb.tp_weight_corrections(in_ir, SH, out_ir)
    tp = FullyConnectedTP(in_ir, SH, out_ir)
    got = tp(torch.as_tensor(x), sh_l2(torch.as_tensor(v)), torch.as_tensor(w * mult[None, :]))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
