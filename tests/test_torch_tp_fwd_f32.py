"""The f32 K10's tables (`tp_kernels.f32_fwd_tables`) and its walk, on the
CPU.

* The blob decodes, at its offsets, to the packed arrays, and they to
  `sparse_tables`' lists: each nonzero's (rf, rb) and coefficient in the
  lists' order, each position's first nonzero and weight, the column
  pointers. The schedule lists every output column exactly once, each
  warp's list ascending, and no warp holds more than its share of the
  entries by more than one column's.
* `walk_f32_kernel` repeats the kernel's loops in float64 numpy over the
  words it reads from its shared memory: warp by warp of the schedule, for
  each of its output columns, the column's run of nonzeros (each q's
  nonzeros in rptr's order, q closed at its last one, the positions in
  cptr's order), every word the kernel loads inside the blob (each one
  step ahead of its use, past the last column into a zero word), the rows
  vectorised. It equals the dense
  form (x (x) sh) CBIG_R, w EXPW, SUMR in float64 at atol 1e-9, and JAX's
  `ref_fused_tp` (CPU, f32) at atol 2e-5 + rtol 2e-5 (f32 sums in another
  order), at the encoder's three layer signatures on edge and cross-graph
  rows.
* A signature too large for the 16-bit fields raises, for the f32 K10's
  tables and for the f32 K11's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from codlad_tpu.kernels import tp_kernels as JTK
from codlad_tpu.nn import irreps as JI
from codlad_tpu_torch.kernels import tp_kernels as TK
from codlad_tpu_torch.models.encoder import irrep_ladder
from codlad_tpu_torch.nn.irreps import SH_IRREPS
from codlad_tpu_torch.nn.tensor_product import fused_tp_tables

SIGS = [0, 1, 2]  # layer l: ladder[l] -> ladder[l + 1]
LADDER = irrep_ladder(12, 4)


def _tables(layer):
    return fused_tp_tables(tuple(LADDER[layer]), tuple(SH_IRREPS), tuple(LADDER[layer + 1]))


def _decode_blob(ft):
    """The tables as the kernel reads them from its shared memory: each
    array from ft["blob"] at its byte offset, up to the next one (the
    padding between them included)."""
    blob, off = ft["blob"], ft["offsets"]
    view = lambda a, b, kind: blob[a:b].view(kind).astype(np.int64)
    return {"z": view(0, off["q"], np.uint64), "q": view(off["q"], off["cp"], np.uint32),
            "cp": view(off["cp"], off["sc"], np.uint16), "sc": view(off["sc"], None, np.uint16)}


def _word(v):
    """(low 32 bits, f32 coefficient) of 64-bit entry words."""
    v = np.asarray(v, np.int64).astype(np.uint64)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.int64)
    hi = (v >> np.uint64(32)).astype(np.uint32).view(np.float32).astype(np.float64)
    return lo, hi


def walk_f32_kernel(x, sh, w, tb):
    """The f32 kernel's loops in float64: x [M, din], sh [M, dsh], w [M,
    numel] -> out [M, dout], every table read from the decoded blob."""
    d = _decode_blob(TK.f32_fwd_tables(tb))
    M = x.shape[0]
    dout = tb["SUMR"].shape[1]
    lo, cf = _word(d["z"])
    qw, cp, sc = d["q"], d["cp"], d["sc"]
    out = np.full((M, dout), np.nan)
    for warp in range(TK.FWD_WARPS):
        for c in sc[sc[warp]:sc[warp + 1]]:
            q = cp[c]
            z, zq, ze = qw[q] & 0xFFFF, qw[q + 1] & 0xFFFF, qw[cp[c + 1]] & 0xFFFF
            wv, tr, acc = w[:, qw[q] >> 16], np.zeros(M), np.zeros(M)
            for z in range(z, ze):
                assert z + 1 < len(lo)                 # the word loaded one step ahead
                rf, rb = lo[z] & 0xFFFF, lo[z] >> 16
                tr = tr + cf[z] * (x[:, rf] * sh[:, rb])
                if z + 1 == zq:                        # q's last nonzero
                    acc, tr = acc + wv * tr, np.zeros(M)
                    q += 1
                    zq, wv = qw[q + 1] & 0xFFFF, w[:, qw[q] >> 16]
            out[:, c] = acc
    return out


@pytest.mark.parametrize("layer", SIGS)
def test_f32_fwd_blob_decodes_to_sparse_lists(layer):
    tb = _tables(layer)
    sp, ft = TK.sparse_tables(tb), TK.f32_fwd_tables(tb)
    d = _decode_blob(ft)
    din, (K, R), dout, nnz = tb["din"], tb["CBIG_R"].shape, tb["SUMR"].shape[1], sp["nnz"]
    assert ft["bytes"] % 16 == 0 and ft["offsets"]["z"] == 0
    assert all(v % 16 == 0 for v in ft["offsets"].values())
    for key, arr in (("z", ft["ez"]), ("q", ft["qword"]), ("cp", ft["cptr"]),
                     ("sc", ft["sched"])):
        np.testing.assert_array_equal(d[key][:len(arr)], arr.astype(np.int64), err_msg=key)
        assert not d[key][len(arr):].any(), key   # zero padding
    lo, cf = _word(d["z"][:nnz])
    np.testing.assert_array_equal((lo >> 16) * din + (lo & 0xFFFF), sp["rows"])
    np.testing.assert_array_equal(cf, sp["coef"])
    assert len(ft["ez"]) == nnz + 1 and ft["ez"][nnz] == 0
    np.testing.assert_array_equal(d["q"][:R + 1] & 0xFFFF, sp["rptr"])
    np.testing.assert_array_equal(d["q"][:R] >> 16, sp["widx"])
    assert len(ft["qword"]) == R + 2 and d["q"][R] >> 16 == 0 and d["q"][R + 1] == 0
    np.testing.assert_array_equal(d["cp"][:dout + 1], sp["cptr"])
    assert nnz == np.count_nonzero(tb["CBIG_R"]) and (lo >> 16).max() < 9


@pytest.mark.parametrize("layer", SIGS)
def test_f32_fwd_schedule_covers_each_column_once(layer):
    tb = _tables(layer)
    sp, ft = TK.sparse_tables(tb), TK.f32_fwd_tables(tb)
    sc, nw, dout = ft["sched"].astype(np.int64), TK.FWD_WARPS, tb["SUMR"].shape[1]
    lists = [sc[sc[w]:sc[w + 1]] for w in range(nw)]
    assert sc[0] == nw + 1 and sc[nw] == len(sc)
    assert sorted(np.concatenate(lists)) == list(range(dout))
    assert all(np.all(np.diff(v) > 0) for v in lists)
    # balanced by entries: a column's nonzeros and positions
    zlen, cptr = np.diff(sp["rptr"]), sp["cptr"]
    cost = np.array([zlen[cptr[c]:cptr[c + 1]].sum() + cptr[c + 1] - cptr[c]
                     for c in range(dout)])
    loads = [cost[v].sum() for v in lists]
    assert max(loads) - min(loads) <= cost.max()


def _inputs(tb, layer, lead, seed):
    rng = np.random.default_rng(seed)
    din = LADDER[layer].dim
    x = rng.normal(size=lead + (din,)).astype(np.float32)
    sh = np.array(JI.sh_l2(jnp.asarray(rng.normal(size=lead + (3,)).astype(np.float32))))
    w = (rng.normal(size=lead + (tb["numel"],)) * din ** -0.5).astype(np.float32)
    return x, sh, w


@pytest.mark.parametrize("layer", SIGS)
@pytest.mark.parametrize("lead", [(2, 25), (1, 3, 14)], ids=["edges", "cross"])
def test_f32_fwd_walk_matches_dense_and_jax(layer, lead):
    tb = _tables(layer)
    x, sh, w = _inputs(tb, layer, lead, seed=80 + layer)
    rows = lambda a: a.reshape(-1, a.shape[-1]).astype(np.float64)
    got = walk_f32_kernel(rows(x), rows(sh), rows(w), tb)
    assert np.isfinite(got).all()
    xcat = (rows(sh)[:, :, None] * rows(x)[:, None, :]).reshape(got.shape[0], -1)
    dense = ((rows(w) @ tb["EXPW"].astype(np.float64))
             * (xcat @ tb["CBIG_R"].astype(np.float64))) @ tb["SUMR"].astype(np.float64)
    np.testing.assert_allclose(got, dense, atol=1e-9, rtol=0)
    jt = [jnp.asarray(tb[k]) for k in ("CBIG_R", "EXPW", "SUMR")]
    want = np.asarray(JTK.ref_fused_tp(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(w), *jt))
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("pack", ["f32_fwd_tables", "f32_bwd_tables"])
def test_f32_tables_refuse_16_bit_overflow(pack):
    R = 1 << 16   # one expansion column too many for a 16-bit field
    tb = {"CBIG_R": np.ones((1, R), np.float32), "EXPW": np.ones((1, R), np.float32),
          "SUMR": np.ones((R, 1), np.float32), "numel": 1, "din": 1, "sig": "oversized"}
    with pytest.raises(ValueError, match="16-bit"):
        getattr(TK, pack)(tb)
