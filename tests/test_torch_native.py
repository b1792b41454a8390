"""The port's host helpers (codlad_tpu_torch/native.py) against the JAX package's.

Same seeded inputs through codlad_tpu.native and codlad_tpu_torch.native:
the LAP equal to scipy's optimum and to JAX's assignment, the radius graph's
edges equal in value and in order (the native cell list, its dense form and
JAX's), the XTC codec byte for byte JAX's native codec, and the port's
library built under codlad_tpu_torch/_build/, never under native/.
"""

from pathlib import Path

import numpy as np
import pytest

from codlad_tpu import native as JN
from codlad_tpu_torch import native as TN


def test_the_port_builds_its_own_library():
    assert TN.loaded(), TN.load_error()
    path = TN.library_path().resolve()
    assert path.exists() and path.parent == Path(TN.__file__).resolve().parent / "_build"
    assert Path(JN._NATIVE_DIR).resolve() not in path.parents


@pytest.mark.parametrize("n", [4, 16, 96])
def test_lap_matches_scipy_and_jax(n):
    from scipy.optimize import linear_sum_assignment

    cost = np.random.default_rng(n).random((n, n))
    col = TN.lap_solve(cost)
    _, want = linear_sum_assignment(cost)
    np.testing.assert_allclose(cost[np.arange(n), col].sum(), cost[np.arange(n), want].sum(),
                               rtol=1e-12)
    assert sorted(col.tolist()) == list(range(n)) and col.dtype == np.int32
    np.testing.assert_array_equal(col, JN.lap_solve(cost))


@pytest.mark.parametrize("seed,n,cutoff", [(1, 300, 6.0), (2, 700, 9.0)])
def test_radius_graph_edges_and_order_equal_jax(seed, n, cutoff):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 30, size=(n, 3))
    valid = rng.random(n) > 0.1
    got = TN.radius_graph(xyz, valid, cutoff)
    np.testing.assert_array_equal(got, JN.radius_graph(xyz, valid, cutoff))
    np.testing.assert_array_equal(got, TN.radius_graph_dense(xyz, valid, cutoff))
    assert got.dtype == np.int32 and len(got) > 0


def test_featurizer_uses_the_cell_list(monkeypatch):
    from codlad_tpu_torch.data import featurize

    calls = []
    real = TN.radius_graph
    monkeypatch.setattr(TN, "radius_graph", lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(3)
    pairs = featurize._radius_edges(rng.uniform(0, 12, (60, 3)), np.ones(60, bool), 5.0)
    assert calls and len(pairs) > 0


@pytest.mark.parametrize("n,step", [(64, 0.05), (500, 0.02), (160, 0.3)])
def test_xtc_codec_byte_for_byte_jax(n, step):
    rng = np.random.default_rng(n)
    pts = np.cumsum(rng.normal(0, step, size=(n, 3)), 0).astype(np.float32)
    enc = TN.xtc_encode(pts, 1000.0)
    assert enc == JN.xtc_encode(pts, 1000.0)
    data, mi, ma, si = enc
    out = TN.xtc_decode(data, n, mi, ma, si, 1000.0)
    np.testing.assert_array_equal(out, JN.xtc_decode(data, n, mi, ma, si, 1000.0))
    assert np.abs(out - pts).max() <= 0.5 / 1000.0 + 1e-5


def test_malformed_inputs_raise_before_the_library():
    with pytest.raises(ValueError, match="square"):
        TN.lap_solve(np.zeros((3, 4)))
    with pytest.raises(ValueError, match=r"\[n, 3\]"):
        TN.radius_graph(np.zeros((5, 2)), np.ones(5, bool), 1.0)
    with pytest.raises(ValueError, match=r"\[n, 3\]"):
        TN.radius_graph(np.zeros((5, 3)), np.ones(4, bool), 1.0)
    with pytest.raises(ValueError, match=r"\[n, 3\]"):
        TN.xtc_encode(np.zeros((5, 2), np.float32), 1000.0)
