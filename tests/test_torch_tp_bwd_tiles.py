"""The K11 kernels' tables and loops, on the CPU: the bf16 kernel's
(`tp_kernels.mma_bwd_tables`, beside K10's `mma_tables`, and its tile
loop) and the f32 kernel's (`tp_kernels.f32_bwd_tables`, and its walk).

* For each of the encoder ladder's three layer signatures: the packed k16 x
  n8 (q x j) tiles of CBIG_R^T and their group lists rebuild the
  column-ordered CBIG_R^T (bf16-rounded) exactly, no nonzero lies outside a
  listed tile, the tile counts are 63 / 339 / 570, the groups come as chunk
  0 then chunk 1 with k steps ascending, their masks are their codes, and
  qcol is SUMR's gather; the ring's slots hold whole pairs and groups.
* The dw codes cover each weight's columns q: one store, or a store, a
  stash and a three-term completion, in ascending q.
* `emulate_kernel` repeats the kernel's loop in torch with its rounding
  points and chunking: TR over K10's listed tiles, dwR = cast(dct[qcol] *
  TR) entering dw by its code, dTR = cast(dct[qcol] * w[widx]), Db over the
  listed CBIG_R^T tiles a chunk of nj column tiles at a time, each chunk
  folded into dx (cast(sh[b] * Db), ascending b) and dsh (cast(x[f] * Db),
  ascending f), every sum in f32, over 48-row blocks with the rows past M
  zero. It is held against the JAX Pallas `_pallas_fused_tp_bwd` in
  interpret mode (run as tests/test_torch_tp_bwd.py runs it) at M = 100
  rows, not a multiple of 48: bf16 within 2e-2 max|ref| of each output (the
  two differ in the order of the f32 sums, so a product or output may
  round to the neighbouring bf16 value), f32 at atol 2e-4 + rtol 2e-4 (as
  tests/test_kernels.py holds the Pallas kernel).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from codlad_tpu.kernels import tp_kernels as JTK
from codlad_tpu.nn import irreps as JI
from codlad_tpu_torch.kernels import tp_kernels as TK
from codlad_tpu_torch.models.encoder import irrep_ladder
from codlad_tpu_torch.nn.irreps import SH_IRREPS
from codlad_tpu_torch.nn.tensor_product import fused_tp_tables

SIGS = [0, 1, 2]              # layer l: ladder[l] -> ladder[l + 1]
TILES_T = {0: 63, 1: 339, 2: 570}
ROWS = 48                     # the kernel's rows a block

_LANE = np.arange(32)
_ROWS16 = 2 * (_LANE % 4)[:, None] + np.array([0, 1, 8, 9])
_COLS8 = np.repeat((_LANE // 4)[:, None], 4, axis=1)


def _tables(layer):
    lad = irrep_ladder(12, 4)
    return fused_tp_tables(tuple(lad[layer]), tuple(SH_IRREPS), tuple(lad[layer + 1]))


def _column_order(tb):
    return np.argsort(tb["SUMR"].argmax(axis=1), kind="stable")


def _tile(frag):
    """A k16 x n8 tile from its 32 lanes' B fragments."""
    block = torch.zeros((16, 8), dtype=frag.dtype)
    block[_ROWS16, _COLS8] = frag
    return block


def _groups(mb):
    """(chunk, k step, [tiles]) of each group, in order."""
    out = []
    for g in range(len(mb["gks"])):
        out.append((int(g >= mb["split"]), int(mb["gks"][g]),
                    range(mb["gptr"][g], mb["gptr"][g + 1])))
    return out


@pytest.mark.parametrize("layer", SIGS)
def test_cbig_t_tiles_rebuild_column_ordered_cbig_t(layer):
    tb = _tables(layer)
    mt, mb = TK.mma_tables(tb), TK.mma_bwd_tables(tb)
    K, R = tb["CBIG_R"].shape
    rp, nj = 16 * mt["npairs"], mb["nj"]
    assert nj == -(-K // 16) and len(mb["gcode"]) == TILES_T[layer]
    frags = torch.as_tensor(mb["gfrag"]).to(torch.bfloat16)
    got = torch.zeros((rp, 16 * nj), dtype=torch.bfloat16)
    listed = torch.zeros((rp, 16 * nj), dtype=torch.bool)
    last = (-1, -1)
    for chunk, s, tiles in _groups(mb):
        assert (chunk, s) > last        # chunk 0 first, k steps ascending
        last = (chunk, s)
        codes = mb["gcode"][tiles.start:tiles.stop]
        assert len(codes) > 0 and np.all(np.diff(codes) > 0) and codes.max() < nj
        for t in tiles:
            jt = chunk * nj + int(mb["gcode"][t])
            assert not bool(listed[16 * s, 8 * jt])              # listed once
            got[16 * s:16 * s + 16, 8 * jt:8 * jt + 8] = _tile(frags[t])
            listed[16 * s:16 * s + 16, 8 * jt:8 * jt + 8] = True
    want = torch.zeros((rp, 16 * nj), dtype=torch.bfloat16)
    want[:R, :K] = torch.as_tensor(tb["CBIG_R"][:, _column_order(tb)].T).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert not bool((want != 0)[~listed].any())                  # no nonzero outside a tile
    gmask = [sum(1 << int(c) for c in mb["gcode"][a:b])
             for a, b in zip(mb["gptr"][:-1], mb["gptr"][1:])]
    np.testing.assert_array_equal(mb["gmask"], gmask)
    qcol = np.full(rp, 0)
    qcol[:R] = tb["SUMR"].argmax(axis=1)[_column_order(tb)]
    np.testing.assert_array_equal(mb["qcol"], qcol)


@pytest.mark.parametrize("layer", SIGS)
def test_ring_slots_hold_whole_pairs_and_groups(layer):
    """The ring's slots: runs of whole pairs (then of whole groups) that
    cover them all in order, at most `cap` tiles each, no group slot
    crossing from chunk 0 to chunk 1."""
    tb = _tables(layer)
    mt, mb = TK.mma_tables(tb), TK.mma_bwd_tables(tb)
    for slots, ptr, n in ((mb["aslot"], mt["cptr"], mt["npairs"]),
                          (mb["cslot"], mb["gptr"], len(mb["gks"]))):
        assert slots[0] == 0 and slots[-1] == n and np.all(np.diff(slots) > 0)
        assert max(ptr[b] - ptr[a] for a, b in zip(slots[:-1], slots[1:])) <= mb["cap"]
    assert mb["cslot"][mb["csplit"]] == mb["split"]
    assert len(mb["aslot"]) - 1 < mt["npairs"]          # fewer ring steps than pairs


@pytest.mark.parametrize("layer", SIGS)
def test_dw_codes_cover_each_weights_columns(layer):
    tb = _tables(layer)
    mt, mb = TK.mma_tables(tb), TK.mma_bwd_tables(tb)
    R, numel = tb["R"], tb["numel"]
    code = mb["dwcode"]
    assert np.all(code[R:] == -1) and np.all(code[:R] >= 0)
    k, kind, slot = code[:R] & 0xFFF, (code[:R] >> 12) & 3, code[:R] >> 16
    np.testing.assert_array_equal(k, mt["widx"][:R])
    slots = []
    for w in range(numel):
        qs = np.nonzero(k == w)[0]                                 # ascending q
        want = {1: [TK.DW_STORE], 3: [TK.DW_STORE, TK.DW_STASH, TK.DW_ADD]}[len(qs)]
        np.testing.assert_array_equal(kind[qs], want)
        if len(qs) == 3:
            assert slot[qs[1]] == slot[qs[2]]
            slots.append(int(slot[qs[1]]))
    assert sorted(slots) == list(range(mb["ntri"])) and mb["ntri"] > 0


def emulate_kernel(x, sh, w, dct, tb, dtype):
    """The kernel's loop in torch: x [M, din], sh [M, dsh], w [M, numel],
    dct [M, dout] (numpy f32) -> (dx, dsh, dw) in `dtype`, over 48-row
    blocks (rows past M zero)."""
    f32 = torch.float32
    mt, mb = TK.mma_tables(tb), TK.mma_bwd_tables(tb)
    rnd = lambda t: t.to(dtype).to(f32)
    M, din = x.shape
    dsh, numel = sh.shape[1], w.shape[1]
    K, nj = dsh * din, mb["nj"]
    kp, rp = 16 * nj, 16 * mt["npairs"]
    mp = -(-M // ROWS) * ROWS
    pad = lambda a: torch.cat([torch.as_tensor(a).to(dtype).to(f32),
                               torch.zeros((mp - M, a.shape[1]))])
    x, sh, w, dct = map(pad, (x, sh, w, dct))
    cfrag = torch.as_tensor(mt["cfrag"]).to(dtype).to(f32)
    gfrag = torch.as_tensor(mb["gfrag"]).to(dtype).to(f32)
    qcol, widx = (torch.as_tensor(mb["qcol"]).long(), torch.as_tensor(mt["widx"]).long())
    # A: TR, dwR, dw
    xcat = torch.zeros((mp, kp))
    xcat[:, :K] = rnd(torch.cat([x * sh[:, b:b + 1] for b in range(dsh)], -1))
    tr = torch.zeros((mp, rp))
    for p in range(mt["npairs"]):
        for t in range(mt["cptr"][p], mt["cptr"][p + 1]):
            kt, nt = int(mt["ctile"][t]) >> 1, 2 * p + (int(mt["ctile"][t]) & 1)
            tr[:, 8 * nt:8 * nt + 8] += xcat[:, 16 * kt:16 * kt + 16] @ _tile(cfrag[t])
    dwr = rnd(dct[:, qcol] * tr)
    dw = torch.zeros((mp, numel))
    stash = torch.zeros((mp, max(mb["ntri"], 1)))
    for q in range(rp):
        code = int(mb["dwcode"][q])
        if code < 0:
            continue
        k, kind, slot = code & 0xFFF, (code >> 12) & 3, code >> 16
        if kind == TK.DW_STORE:
            dw[:, k] = dwr[:, q]
        elif kind == TK.DW_STASH:
            stash[:, slot] = dwr[:, q]
        else:
            dw[:, k] = rnd((dw[:, k] + stash[:, slot]) + dwr[:, q])
    # C: Db by chunk, folded into dx and dsh
    dtr = rnd(dct[:, qcol] * w[:, widx])
    dx, dsho = torch.zeros((mp, din)), torch.zeros((mp, dsh))
    for chunk in range(2):
        acc = torch.zeros((mp, 8 * nj))
        for c, s, tiles in _groups(mb):
            if c != chunk:
                continue
            for t in tiles:
                o = int(mb["gcode"][t])
                acc[:, 8 * o:8 * o + 8] += dtr[:, 16 * s:16 * s + 16] @ _tile(gfrag[t])
        c0, c1 = 8 * nj * chunk, min(K, 8 * nj * (chunk + 1))
        for b in range(dsh):                   # ascending b for dx, f for dsh
            for f in range(din):
                j = b * din + f
                if c0 <= j < c1:
                    dx[:, f] += rnd(sh[:, b] * acc[:, j - c0])
                    dsho[:, b] += rnd(x[:, f] * acc[:, j - c0])
    return tuple(t[:M].to(dtype) for t in (dx, dsho, dw))


def _pallas(x, sh, w, dct, tb, dtype):
    jt = [jnp.asarray(tb[k]) for k in ("CBIG_R", "EXPW", "SUMR")]
    cast = lambda a: jnp.asarray(a[None]).astype(dtype)
    call = pl.pallas_call
    try:
        JTK.pl.pallas_call = functools.partial(call, interpret=True)
        out = JTK._pallas_fused_tp_bwd(cast(x), cast(sh), cast(w), *jt, cast(dct))
    finally:
        JTK.pl.pallas_call = call
    return [np.asarray(o[0].astype(jnp.float32)) for o in out]


@pytest.mark.parametrize("layer", SIGS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_emulation_matches_pallas(layer, dtype):
    tb = _tables(layer)
    rng = np.random.default_rng(40 + layer)
    M, din = 100, irrep_ladder(12, 4)[layer].dim
    x = rng.normal(size=(M, din)).astype(np.float32)
    sh = np.array(JI.sh_l2(jnp.asarray(rng.normal(size=(M, 3)).astype(np.float32))))
    w = (rng.normal(size=(M, tb["numel"])) * din ** -0.5).astype(np.float32)
    dct = rng.normal(size=(M, tb["SUMR"].shape[1])).astype(np.float32)
    got = emulate_kernel(x, sh, w, dct, tb, getattr(torch, dtype))
    want = _pallas(x, sh, w, dct, tb, getattr(jnp, dtype))
    for g, ref, name in zip(got, want, ("dx", "dsh", "dw")):
        g = g.float().numpy()
        assert g.shape == ref.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g, ref, atol=2e-4, rtol=2e-4, err_msg=name)
        else:
            assert np.abs(g - ref).max() <= 2e-2 * np.abs(ref).max(), name


# ---------------------------------------------------------------------------
# The f32 kernel: f32_bwd_tables' blob and the kernel's walk

def _decode_blob(fb):
    """The tables as the kernel reads them from its shared memory: every
    array from fb["blob"] at its byte offset (the blob ends after sched)."""
    blob, off = fb["blob"], fb["offsets"]
    keys = ("tr", "db", "q", "kq", "tp", "sc")
    ends = [off[k] for k in keys[1:]] + [off["sc"] + fb["sched"].nbytes]
    kinds = {"tr": np.uint64, "db": np.uint64, "q": np.uint32, "kq": np.uint16,
             "tp": np.uint16, "sc": np.uint16}
    return {k: blob[off[k]:e].view(kinds[k]).astype(np.int64) for k, e in zip(keys, ends)}


def _word(v):
    """(low 32 bits, f32 coefficient) of 64-bit entry words."""
    v = np.asarray(v, np.int64).astype(np.uint64)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.int64)
    hi = (v >> np.uint64(32)).astype(np.uint32).view(np.float32)
    return lo, hi


@pytest.mark.parametrize("layer", SIGS)
def test_f32_blob_decodes_to_sparse_lists(layer):
    tb = _tables(layer)
    sp, fb = TK.sparse_tables(tb), TK.f32_bwd_tables(tb)
    d = _decode_blob(fb)
    din, numel, (K, R), nnz = tb["din"], tb["numel"], tb["CBIG_R"].shape, sp["nnz"]
    assert fb["bytes"] % 16 == 0 and fb["offsets"]["tr"] == 0
    for key, arr in (("tr", fb["etr"]), ("db", fb["edb"]), ("q", fb["qword"]),
                     ("kq", fb["kqptr"]), ("tp", fb["tptr"]), ("sc", fb["sched"])):
        np.testing.assert_array_equal(d[key], arr.astype(np.int64), err_msg=key)
    # by column, in dw order: position t is q = wq[t], weight k's run kqptr
    np.testing.assert_array_equal(d["kq"], sp["wptr"])
    lo, cf = _word(d["tr"])
    zs = d["q"] & 0xFFFF
    assert zs[-1] == nnz and len(zs) == R + 1
    for t, q in enumerate(sp["wq"]):
        z = slice(zs[t], zs[t + 1])
        want = slice(sp["rptr"][q], sp["rptr"][q + 1])
        np.testing.assert_array_equal((lo[z] >> 16) * din + (lo[z] & 0xFFFF), sp["rows"][want])
        np.testing.assert_array_equal(cf[z], sp["coef"][want])
        assert d["q"][t] >> 16 == sp["qcol"][q]
    # by row: each nonzero's gathers and coefficient, tptr's runs
    np.testing.assert_array_equal(d["tp"], sp["tptr"])
    lo, cf = _word(d["db"])
    np.testing.assert_array_equal(lo & 0xFFFF, sp["qcol"][sp["tq"]])
    np.testing.assert_array_equal(lo >> 16, sp["widx"][sp["tq"]])
    np.testing.assert_array_equal(cf, sp["tcoef"])
    # the schedule: every dw unit (4 weights from k0) and every feature f
    # once, each warp's list ascending
    sc, nw = d["sc"], TK.BWD_WARPS
    a_units = [sc[sc[w]:sc[w + 1]] for w in range(nw)]
    b_units = [sc[sc[nw + 1 + w]:sc[nw + 2 + w]] for w in range(nw)]
    assert sc[0] == 2 * (nw + 1) and sc[nw] == sc[nw + 1] and sc[2 * nw + 1] == len(sc)
    assert sorted(np.concatenate(a_units)) == list(range(0, numel, TK.BWD_GROUP))
    assert sorted(np.concatenate(b_units)) == list(range(din))
    assert all(np.all(np.diff(u) > 0) for u in a_units + b_units)


TILE_F32 = 64   # the f32 kernel's rows a tile: 32 lanes, two rows each


def _fma(a, b, c):
    """fmaf in f32 (the product exact in float64, one rounding of the sum
    to f32 after float64's; a double rounding can move a result by one f32
    ulp, far inside the limits held here)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_f32_kernel(x, sh, w, dct, tb):
    """The f32 kernel's walk in torch: x [M, din], sh [M, 9], w [M, numel],
    dct [M, dout] (numpy f32) -> (dx, dsh, dw) f32, over 64-row tiles
    (row tile * 64 + 32 r + lane: lane's rows r = 0, 1; rows past M zero),
    every table read from the decoded blob."""
    fb = TK.f32_bwd_tables(tb)
    d = _decode_blob(fb)
    M, din = x.shape
    numel, nw = w.shape[1], TK.BWD_WARPS
    mp = -(-M // TILE_F32) * TILE_F32
    pad = lambda a: torch.cat([torch.as_tensor(a), torch.zeros((mp - M, a.shape[1]))])
    x, sh, w, dct = map(pad, (x, sh, w, dct))
    # [tiles, RT, lanes] -> rows: the same row order, shown in the kernel's map
    lanes = torch.arange(mp).reshape(-1, 2, 32)
    assert torch.equal(lanes[:, 1], lanes[:, 0] + 32)
    tr_lo, tr_cf = _word(d["tr"])
    db_lo, db_cf = _word(d["db"])
    tr_cf, db_cf = torch.from_numpy(tr_cf), torch.from_numpy(db_cf)
    qw, kq, tp, sc = d["q"], d["kq"], d["tp"], d["sc"]
    zero = lambda: torch.zeros(mp)
    # dw phase: TR by fmaf chains, dw the sum of rounded products
    dw = torch.zeros((mp, numel))
    for k in range(numel):
        acc = zero()
        for t in range(kq[k], kq[k + 1]):
            tr = zero()
            for z in range(qw[t] & 0xFFFF, qw[t + 1] & 0xFFFF):
                f, b = tr_lo[z] & 0xFFFF, tr_lo[z] >> 16
                tr = _fma(tr_cf[z], x[:, f] * sh[:, b], tr)
            acc = acc + dct[:, qw[t] >> 16] * tr
        dw[:, k] = acc
    # Db phase, warp by warp: dx (b ascending), the warps' parts of dsh
    dx, parts = torch.zeros((mp, din)), []
    for wp in range(nw):
        dsp = torch.zeros((mp, 9))
        for f in sc[sc[nw + 1 + wp]:sc[nw + 2 + wp]]:
            dxa = zero()
            for b in range(9):
                j = b * din + f
                acc = zero()
                for t in range(tp[j], tp[j + 1]):
                    c, k = db_lo[t] & 0xFFFF, db_lo[t] >> 16
                    acc = _fma(db_cf[t], dct[:, c] * w[:, k], acc)
                dxa = dxa + sh[:, b] * acc
                dsp[:, b] = dsp[:, b] + x[:, f] * acc
            dx[:, f] = dxa
        parts.append(dsp)
    dsh = parts[0]
    for p in parts[1:]:
        dsh = dsh + p
    return dx[:M], dsh[:M], dw[:M]


@pytest.mark.parametrize("layer", SIGS)
def test_f32_kernel_walk_matches_pallas(layer):
    tb = _tables(layer)
    rng = np.random.default_rng(60 + layer)
    M, din = 100, irrep_ladder(12, 4)[layer].dim
    x = rng.normal(size=(M, din)).astype(np.float32)
    sh = np.array(JI.sh_l2(jnp.asarray(rng.normal(size=(M, 3)).astype(np.float32))))
    w = (rng.normal(size=(M, tb["numel"])) * din ** -0.5).astype(np.float32)
    dct = rng.normal(size=(M, tb["SUMR"].shape[1])).astype(np.float32)
    got = emulate_f32_kernel(x, sh, w, dct, tb)
    want = _pallas(x, sh, w, dct, tb, jnp.float32)
    for g, ref, name in zip(got, want, ("dx", "dsh", "dw")):
        assert g.dtype == torch.float32 and g.shape == ref.shape, name
        np.testing.assert_allclose(g.numpy(), ref, atol=2e-4, rtol=2e-4, err_msg=name)
