"""The port's copies of the host data pipeline and its metrics against the
JAX package: featurize_frame and synthetic_examples give the same arrays
(radius-graph edges compared as sets, then as sorted lists), collate and
the shard reader read JAX-written shards (and the JAX reader the port's),
and the metrics agree on perturbed frames (rtol 1e-5, atol 1e-6: f32 sums
in another order; graph validity exactly)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codlad_tpu.data import batch as JB
from codlad_tpu.data import featurize as JF
from codlad_tpu.data import shards as JS
from codlad_tpu.data import synthetic as JSy
from codlad_tpu.eval import metrics as JM
from codlad_tpu.eval.harness import evaluate_structures as jax_evaluate
from codlad_tpu_torch.data import batch as PB
from codlad_tpu_torch.data import featurize as PF
from codlad_tpu_torch.data import shards as PS
from codlad_tpu_torch.data import synthetic as PSy
from codlad_tpu_torch.eval import metrics as PM
from codlad_tpu_torch.eval.harness import evaluate_structures

_EDGES = ("atom_edges", "cg_edges", "bond_edges", "clash_edges", "inter_edges",
          "pipi_pairs", "bb_no_edges")


def _assert_same_example(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k in _EDGES:
            assert {tuple(r) for r in a[k]} == {tuple(r) for r in b[k]}, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("structured", [False, True])
def test_featurize_frame_matches_jax(structured):
    rng = np.random.default_rng(5)
    frame = JSy.random_protein(rng, 40, structured=structured)
    cfg = JF.FeaturizeConfig(atom_cutoff=7.5)
    got = PF.featurize_frame(*frame, cfg=PF.FeaturizeConfig(atom_cutoff=7.5), prot_idx=3)
    _assert_same_example(got, JF.featurize_frame(*frame, cfg=cfg, prot_idx=3))
    assert len(got["atom_edges"]) > 0 and len(got["bond_edges"]) > 0


def test_synthetic_examples_match_jax():
    for a, b in zip(PSy.synthetic_examples(3, 24, seed=9, structured=True),
                    JSy.synthetic_examples(3, 24, seed=9, structured=True)):
        _assert_same_example(a, b)


def test_collate_and_shards_read_both_ways(tmp_path):
    ex = JSy.synthetic_examples(3, 22, seed=2)
    spec = JB.quantize_spec(JB.spec_for(ex))
    assert PB.quantize_spec(PB.spec_for(ex)) == PB.PadSpec(**vars(spec))
    want = JB.collate(ex, spec)
    got = PB.collate(ex, PB.PadSpec(**vars(spec)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    JS.save_protein_shard(os.path.join(tmp_path, "prot_0000.npz"), ex)
    PS.save_protein_shard(os.path.join(tmp_path, "prot_0001.npz"), ex)
    for name in ("prot_0000.npz", "prot_0001.npz"):
        jspec, jdata = JS.load_protein_shard(os.path.join(tmp_path, name))
        pspec, pdata = PS.load_protein_shard(os.path.join(tmp_path, name))
        assert vars(jspec) == vars(pspec) and jdata.keys() == pdata.keys()
        for k in jdata:
            np.testing.assert_array_equal(pdata[k], jdata[k], err_msg=k)
    pj = list(JS.ShardDataset(str(tmp_path), 2, shuffle=False))
    pp = list(PS.ShardDataset(str(tmp_path), 2, shuffle=False))
    assert len(pp) == len(pj) == 4
    for a, b in zip(pp, pj):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _frames(seed=1):
    ex = JSy.synthetic_examples(2, 34, seed=seed)
    nb = JB.collate(ex, JB.quantize_spec(JB.spec_for(ex)))
    rng = np.random.default_rng(seed)
    gen = (nb["xyz14"] + rng.normal(0, 0.6, nb["xyz14"].shape)).astype(np.float32)
    return nb, gen


def test_metrics_match_jax():
    nb, gen = _frames()
    B = gen.shape[0]
    t = {k: torch.from_numpy(v) for k, v in nb.items()}
    tg = torch.from_numpy(gen)
    flat_mask = nb["atom_mask"].reshape(B, -1)
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                    rtol=1e-5, atol=1e-6)
    close(PM.kabsch_rmsd(tg.reshape(B, -1, 3), t["xyz14"].reshape(B, -1, 3),
                         t["atom_mask"].reshape(B, -1)),
          JM.kabsch_rmsd(gen.reshape(B, -1, 3), nb["xyz14"].reshape(B, -1, 3), flat_mask))
    close(PM.unaligned_rmsd(tg.reshape(B, -1, 3), t["xyz14"].reshape(B, -1, 3),
                            t["atom_mask"].reshape(B, -1)),
          JM.unaligned_rmsd(gen.reshape(B, -1, 3), nb["xyz14"].reshape(B, -1, 3), flat_mask))
    close(PM.ged_score(tg, t["xyz14"], t["bond_edges"], t["bond_edges_mask"]),
          JM.ged_score(gen, nb["xyz14"], nb["bond_edges"], nb["bond_edges_mask"]))
    close(PM.clash_ratio(tg, t["clash_edges"], t["clash_edges_mask"], t["bb_no_edges"],
                         t["bb_no_edges_mask"]),
          JM.clash_ratio(gen, nb["clash_edges"], nb["clash_edges_mask"], nb["bb_no_edges"],
                         nb["bb_no_edges_mask"]))
    for a, b in zip(PM.interaction_scores(tg, t["inter_edges"], t["inter_edges_mask"],
                                          t["pipi_pairs"], t["pipi_pairs_mask"]),
                    JM.interaction_scores(gen, nb["inter_edges"], nb["inter_edges_mask"],
                                          nb["pipi_pairs"], nb["pipi_pairs_mask"])):
        close(a, b)
    # row chunks smaller than the atom count, as the JAX scan's chunks are
    for got in (PM.graph_validity(tg, t["xyz14"], t["res_type"], t["atom_mask"], chunk=100),
                PM.graph_validity(tg, t["xyz14"], t["res_type"], t["atom_mask"])):
        for a, b in zip(got, JM.graph_validity(gen, nb["xyz14"], nb["res_type"],
                                               nb["atom_mask"])):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_evaluate_structures_matches_jax():
    nb, gen = _frames(seed=3)
    rng = np.random.default_rng(4)
    ic = (nb["ic"] + rng.normal(0, 0.1, nb["ic"].shape)).astype(np.float32)
    got = evaluate_structures({k: torch.from_numpy(v) for k, v in nb.items()},
                              torch.from_numpy(ic), torch.from_numpy(gen))
    want = jax_evaluate({k: jnp.asarray(v) for k, v in nb.items()}, jnp.asarray(ic),
                        jnp.asarray(gen))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
