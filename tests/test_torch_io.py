"""The port's data I/O against the JAX package's, on the same files.

PDB and XTC files of small synthetic proteins (written by the port's
`write_structure_files`) go through both packages: `parse_pdb` (every
model, `model_index`, `return_topology`) and `load_xtc_ensemble` give equal
arrays, `write_pdb` and the native `write_xtc` equal bytes, `read_xtc` with
stride and max_frames equal frames; the pure-Python codec's decode within
the precision quantum of JAX's; `cli.preprocess` on a PDB directory (one
malformed file among them), on XTC ensembles and `--synthetic` gives shard
arrays equal to JAX's `cli.preprocess` and the same manifest, failures
included; `align_shard_buckets`, `repad_shard_data` and `compress_indices`
equal JAX's.
"""

import json
import os

import numpy as np
import pytest

from codlad_tpu.cli import preprocess as JPRE
from codlad_tpu.data import batch as JB
from codlad_tpu.data import pdb as JPDB
from codlad_tpu.data import shards as JSH
from codlad_tpu.data import xtc as JXTC
from codlad_tpu_torch.cli import preprocess as TPRE
from codlad_tpu_torch.data import batch as TB
from codlad_tpu_torch.data import pdb as TPDB
from codlad_tpu_torch.data import shards as TSH
from codlad_tpu_torch.data import xtc as TXTC
from codlad_tpu_torch.data.synthetic import write_structure_files

PREC = 1000.0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("io")
    frames = {}
    for i, n in enumerate((22, 27)):
        frames[f"p{i}"] = write_structure_files(d, f"p{i}", n, 4, seed=i, pdb_dir=d / "pdb",
                                                xtc_dir=d / "xtc")
    return d, frames


def _equal_dicts(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_parse_pdb_equal_jax(files):
    d, _ = files
    path = d / "pdb" / "p1.pdb"
    _equal_dicts(TPDB.parse_pdb(path), JPDB.parse_pdb(path))
    _equal_dicts(TPDB.parse_pdb(path, model_index=0), JPDB.parse_pdb(path, model_index=0))
    assert TPDB.parse_pdb(path, return_topology=True) == JPDB.parse_pdb(
        path, return_topology=True)
    bad = d / "bad.pdb"
    bad.write_text("HEADER nothing\n")
    with pytest.raises(TPDB.PDBParseError):
        TPDB.parse_pdb(bad)


def test_write_pdb_equal_bytes(files, tmp_path):
    d, frames = files
    xyz, res_type = frames["p0"]
    og = np.concatenate([res_type[:1], res_type, res_type[-1:]])
    chain = np.zeros_like(og)
    TPDB.write_pdb(tmp_path / "t.pdb", og, chain, xyz)
    JPDB.write_pdb(tmp_path / "j.pdb", og, chain, xyz)
    assert (tmp_path / "t.pdb").read_bytes() == (tmp_path / "j.pdb").read_bytes()
    assert TPDB.parse_pdb(tmp_path / "t.pdb")["xyz14"].shape[0] == len(xyz)


def test_write_xtc_native_equal_bytes_and_read(files, tmp_path):
    d, frames = files
    xyz = np.random.default_rng(5).normal(0, 2, (6, 150, 3)).astype(np.float32)
    TXTC.write_xtc(tmp_path / "t.xtc", xyz, time=np.arange(6) * 2.0, precision=PREC)
    JXTC.write_xtc(tmp_path / "j.xtc", xyz, time=np.arange(6) * 2.0, precision=PREC)
    assert (tmp_path / "t.xtc").read_bytes() == (tmp_path / "j.xtc").read_bytes()
    for kw in ({}, {"stride": 2}, {"max_frames": 3}, {"stride": 2, "max_frames": 2}):
        _equal_dicts(TXTC.read_xtc(tmp_path / "t.xtc", **kw),
                     JXTC.read_xtc(tmp_path / "j.xtc", **kw))
    assert (d / "xtc" / "p0.xtc").read_bytes()[:4] == (1995).to_bytes(4, "big")


def test_python_codec_decodes_as_jax(tmp_path, monkeypatch):
    """Without the library the port writes and reads with the pure-Python
    codec: other bytes (no run packing) than the native encoder, the same
    coordinates within the precision quantum."""
    xyz = np.cumsum(np.random.default_rng(6).normal(0, 0.05, (2, 80, 3)), 1).astype(np.float32)
    JXTC.write_xtc(tmp_path / "j.xtc", xyz, precision=PREC)
    monkeypatch.setattr(TXTC.native, "xtc_encode", lambda *a: None)
    monkeypatch.setattr(TXTC.native, "xtc_decode", lambda *a: None)
    TXTC.write_xtc(tmp_path / "t.xtc", xyz, precision=PREC)
    got = TXTC.read_xtc(tmp_path / "t.xtc")["xyz"]
    want = JXTC.read_xtc(tmp_path / "j.xtc")["xyz"]
    assert np.abs(got - xyz).max() <= 0.5 / PREC + 1e-5
    np.testing.assert_allclose(TXTC.read_xtc(tmp_path / "j.xtc")["xyz"], want, atol=2e-6)


def test_load_xtc_ensemble_equal_jax(files):
    d, frames = files
    pdb, xtcs = d / "pdb" / "p1.pdb", [d / "xtc" / "p1.xtc"]
    got = TPDB.load_xtc_ensemble(pdb, xtcs, stride=1)
    _equal_dicts(got, JPDB.load_xtc_ensemble(pdb, xtcs, stride=1))
    _equal_dicts(TPDB.load_xtc_ensemble(pdb, xtcs, stride=2, max_frames=1),
                 JPDB.load_xtc_ensemble(pdb, xtcs, stride=2, max_frames=1))
    assert got["xyz14"].shape[0] == 4
    exists = got["atom14_mask"]
    assert np.abs(got["xyz14"][:, exists] - frames["p1"][0][:, 1:-1][:, exists]).max() < 6e-3


def _shards(d):
    return {f: TSH.load_protein_shard(os.path.join(d, f)) for f in sorted(os.listdir(d))
            if f.endswith(".npz")}


def _same_preprocess(tmp_path, args):
    TPRE.main(args + ["--out_dir", str(tmp_path / "t")])
    JPRE.main(args + ["--out_dir", str(tmp_path / "j")])
    t, j = _shards(tmp_path / "t"), _shards(tmp_path / "j")
    assert set(t) == set(j) and t
    for f in t:
        assert t[f][0] == JB.PadSpec(**vars(j[f][0])) or vars(t[f][0]) == vars(j[f][0])
        _equal_dicts(t[f][1], j[f][1])
    mt, mj = (json.load(open(tmp_path / s / "manifest.json")) for s in ("t", "j"))
    assert mt["success"] == mj["success"] and mt["failed"] == mj["failed"]
    mt["config"].pop("out_dir"), mj["config"].pop("out_dir")
    assert mt["config"] == mj["config"]
    return mt


def test_preprocess_pdb_dir_equal_jax(files, tmp_path):
    d, _ = files
    (d / "pdb" / "broken.pdb").write_text("ATOM  garbage\n")
    try:
        m = _same_preprocess(tmp_path, ["--pdb_dir", str(d / "pdb")])
    finally:
        (d / "pdb" / "broken.pdb").unlink()
    assert m["success"] == ["p0", "p1"] and [f["name"] for f in m["failed"]] == ["broken"]


def test_preprocess_xtc_equal_jax(files, tmp_path):
    d, _ = files
    m = _same_preprocess(tmp_path, ["--pdb_dir", str(d / "pdb"), "--xtc_dir", str(d / "xtc"),
                                    "--stride", "2", "--max_frames", "3"])
    assert m["success"] == ["p0", "p1"]
    assert TSH.load_protein_shard(tmp_path / "t" / "p0.npz")[1]["res_type"].shape[0] == 2


def test_preprocess_synthetic_equal_jax(tmp_path):
    _same_preprocess(tmp_path, ["--synthetic", "2", "14", "2", "--res_range", "12", "40"])


def test_align_and_compress_equal_jax(tmp_path):
    """Two proteins of one length bucket with different edge capacities:
    both packages re-pad them to the same spec and bytes; compress_indices
    narrows the same arrays."""
    from codlad_tpu_torch.data.synthetic import synthetic_examples

    for sub in ("t", "j"):
        os.makedirs(tmp_path / sub)
        for i, n in enumerate((20, 34)):
            TSH.save_protein_shard(tmp_path / sub / f"p{i}.npz",
                                   synthetic_examples(2, n, seed=i, prot_idx=i))
    specs = [TSH.load_protein_shard(tmp_path / "t" / f"p{i}.npz")[0] for i in range(2)]
    assert specs[0].L == specs[1].L and specs[0] != specs[1]
    mt = TSH.align_shard_buckets(tmp_path / "t")
    mj = JSH.align_shard_buckets(tmp_path / "j")
    assert {L: vars(s) for L, s in mt.items()} == {L: vars(s) for L, s in mj.items()}
    t, j = _shards(tmp_path / "t"), _shards(tmp_path / "j")
    for f in t:
        _equal_dicts(t[f][1], j[f][1])
    data = t["p0.npz"][1]
    _equal_dicts(TSH.repad_shard_data(data, specs[0], mt[specs[0].L]),
                 JSH.repad_shard_data(data, JB.PadSpec(**vars(specs[0])),
                                      JB.PadSpec(**vars(mt[specs[0].L]))))
    ct, cj = TB.compress_indices(data), JB.compress_indices(data)
    _equal_dicts(ct, cj)
    assert all(ct[k].dtype == np.uint16 for k in TB.EDGE_KEYS)
    back = TB.decompress_indices(TB.to_device(ct, "cpu"))
    for k in TB.EDGE_KEYS:
        np.testing.assert_array_equal(back[k].numpy(), data[k])


def test_prefetch_keeps_order_raises_and_stops():
    """The same items in order as JAX's prefetch, the producer's error
    raised at the consumer, and the thread gone after the consumer breaks
    out early (JAX's keeps waiting on its full queue)."""
    import threading
    import time

    from codlad_tpu.data.prefetch import prefetch as jax_prefetch
    from codlad_tpu_torch.data.prefetch import prefetch

    before = threading.active_count()
    assert list(prefetch(iter(range(40)))) == list(jax_prefetch(iter(range(40))))
    for x in prefetch(iter(range(1000)), size=2):
        if x == 3:
            break
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before

    def failing():
        yield 1
        raise KeyError("producer")

    with pytest.raises(KeyError, match="producer"):
        list(prefetch(failing()))
