"""The bf16 K10 kernel's tile tables (`tp_kernels.mma_tables`) and its tile
loop, on the CPU.

* For each of the encoder ladder's three layer signatures: the packed k16 x
  n8 tiles of CBIG_R and their list rebuild the column-ordered CBIG_R
  (bf16-rounded) exactly, no nonzero lies outside a listed tile, the tile
  counts are 66 / 300 / 516, and SUMR's tile list rebuilds SUMR.
* `emulate_kernel` repeats the kernel's loop in torch with its rounding
  points: xcat = cast(x * sh[b]), TR summed in f32 over the listed tiles
  only, prod = cast(w[widx[r]] * TR) from the weight gather, out summed in
  f32 over SUMR's listed tiles and cast, over 64-row blocks with the rows
  past M zero. It is held against the JAX Pallas `_pallas_fused_tp` in
  interpret mode (run as tests/test_torch_tp.py runs it) at M = 100 rows, not
  a multiple of 64: bf16 within 2e-2 max|ref| (the two differ in the order
  of the f32 sums, so a product or output may round to the neighbouring
  bf16 value), f32 at atol 2e-4 + rtol 2e-4 (as tests/test_kernels.py holds
  the Pallas kernel).
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
TILES = {0: 66, 1: 300, 2: 516}
ROWS = 64                     # the kernel's rows a block


def _tables(layer):
    lad = irrep_ladder(12, 4)
    return fused_tp_tables(tuple(lad[layer]), tuple(SH_IRREPS), tuple(lad[layer + 1]))


def _column_order(tb):
    return np.argsort(tb["SUMR"].argmax(axis=1), kind="stable")


def _cbig_tile(p, code):
    """(k tile, column tile) of a packed CBIG_R tile of pair p."""
    return code >> 1, 2 * p + (code & 1)


def _sumr_tile(p, code):
    """(k tile, column tile) of a packed SUMR tile of k16 step p."""
    return p, code


def _unpack(ptr, codes, frags, where, shape):
    """The dense [K, N] matrix that the tile list and its B fragments
    describe (lane l of a tile holds rows 2(l%4) + (0, 1, 8, 9) of column
    l//4; where(group, code) places a tile), and the mask of the listed
    tiles."""
    dense, listed = torch.zeros(shape, dtype=frags.dtype), torch.zeros(shape, dtype=torch.bool)
    lane = np.arange(32)
    rows = 2 * (lane % 4)[:, None] + np.array([0, 1, 8, 9])
    cols = np.repeat((lane // 4)[:, None], 4, axis=1)
    for grp in range(len(ptr) - 1):
        for t in range(ptr[grp], ptr[grp + 1]):
            kt, nt = where(grp, int(codes[t]))
            block = torch.zeros((16, 8), dtype=frags.dtype)
            block[rows, cols] = frags[t]
            assert not bool(listed[16 * kt, 8 * nt])           # listed once
            dense[16 * kt:16 * kt + 16, 8 * nt:8 * nt + 8] = block
            listed[16 * kt:16 * kt + 16, 8 * nt:8 * nt + 8] = True
    return dense, listed


@pytest.mark.parametrize("layer", SIGS)
def test_cbig_tiles_rebuild_column_ordered_cbig(layer):
    tb = _tables(layer)
    mt = TK.mma_tables(tb)
    K, R = tb["CBIG_R"].shape
    kp, rp = -(-K // 16) * 16, 16 * mt["npairs"]
    assert len(mt["ctile"]) == TILES[layer] and len(mt["cptr"]) == mt["npairs"] + 1
    frags = torch.as_tensor(mt["cfrag"]).to(torch.bfloat16)
    got, listed = _unpack(mt["cptr"], mt["ctile"], frags, _cbig_tile, (kp, rp))
    want = torch.zeros((kp, rp), dtype=torch.bfloat16)
    want[:K, :R] = torch.as_tensor(tb["CBIG_R"][:, _column_order(tb)]).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert not bool((want != 0)[~listed].any())            # no nonzero outside a listed tile
    # every listed tile holds a nonzero; a pair's tiles come as cboth steps
    # of (2p, 2p+1), then cxa more of 2p, then the rest of 2p+1, each column
    # tile's k tiles ascending
    assert int(listed.sum()) == 128 * TILES[layer]
    assert mt["maxpair"] == max(np.diff(mt["cptr"]))
    for p in range(mt["npairs"]):
        codes = mt["ctile"][mt["cptr"][p]:mt["cptr"][p + 1]]
        nb, na = mt["cboth"][p], mt["cxa"][p]
        halves = [0, 1] * nb + [0] * na + [1] * (len(codes) - 2 * nb - na)
        np.testing.assert_array_equal(codes % 2, halves)
        assert min(na, len(codes) - 2 * nb - na) == 0
        for h in (0, 1):
            assert np.all(np.diff(codes[codes % 2 == h]) > 0)


@pytest.mark.parametrize("layer", SIGS)
def test_sumr_tiles_rebuild_sumr(layer):
    tb = _tables(layer)
    mt = TK.mma_tables(tb)
    R, dout = tb["SUMR"].shape
    rp, op = 16 * mt["npairs"], -(-dout // 8) * 8
    assert len(mt["snptr"]) == mt["npairs"] + 1
    got, listed = _unpack(mt["snptr"], mt["stile"], torch.as_tensor(mt["sfrag"]), _sumr_tile,
                          (rp, op))
    want = torch.zeros((rp, op))
    want[:R, :dout] = torch.as_tensor(tb["SUMR"][_column_order(tb)])
    assert torch.equal(got, want) and not bool((want != 0)[~listed].any())
    # each k16 step meets one or two output tiles (SUMR in column order is
    # nearly block diagonal)
    assert set(np.diff(mt["snptr"])) <= {1, 2}
    np.testing.assert_array_equal(mt["widx"][:R], tb["EXPW"].argmax(0)[_column_order(tb)])


def emulate_kernel(x, sh, w, mt, dout, dtype):
    """The kernel's tile loop in torch: x [M, din], sh [M, dsh], w [M, numel]
    (numpy f32) -> [M, dout] in `dtype`, over 64-row blocks."""
    f32 = torch.float32
    M, din = x.shape
    x, sh, w = (torch.as_tensor(a).to(dtype) for a in (x, sh, w))
    cfrag = torch.as_tensor(mt["cfrag"]).to(dtype).to(f32)
    sfrag = torch.as_tensor(mt["sfrag"]).to(f32)
    lane = np.arange(32)
    rows = 2 * (lane % 4)[:, None] + np.array([0, 1, 8, 9])
    cols = np.repeat((lane // 4)[:, None], 4, axis=1)

    def tile(frag):
        block = torch.zeros((16, 8), dtype=f32)
        block[rows, cols] = frag
        return block

    kp = -(-din * sh.shape[1] // 16) * 16
    rp, op = 16 * mt["npairs"], 8 * (-(-dout // 8))
    out = torch.empty((M, dout), dtype=dtype)
    for r0 in range(0, M, ROWS):
        n = min(ROWS, M - r0)
        xcat = torch.zeros((ROWS, kp), dtype=f32)
        xcat[:n, :din * sh.shape[1]] = torch.cat(
            [x[r0:r0 + n] * sh[r0:r0 + n, b:b + 1] for b in range(sh.shape[1])], -1).to(f32)
        wt = torch.zeros((ROWS, w.shape[1]), dtype=f32)
        wt[:n] = w[r0:r0 + n].to(f32)
        tr = torch.zeros((ROWS, rp), dtype=f32)
        for p in range(mt["npairs"]):
            for t in range(mt["cptr"][p], mt["cptr"][p + 1]):
                kt, nt = _cbig_tile(p, int(mt["ctile"][t]))
                tr[:, 8 * nt:8 * nt + 8] += xcat[:, 16 * kt:16 * kt + 16] @ tile(cfrag[t])
        prod = (wt[:, torch.as_tensor(mt["widx"]).long()] * tr).to(dtype).to(f32)
        acc = torch.zeros((ROWS, op), dtype=f32)
        for p in range(mt["npairs"]):
            for t in range(mt["snptr"][p], mt["snptr"][p + 1]):
                _, ot = _sumr_tile(p, int(mt["stile"][t]))
                acc[:, 8 * ot:8 * ot + 8] += prod[:, 16 * p:16 * p + 16] @ tile(sfrag[t])
        out[r0:r0 + n] = acc[:n, :dout].to(dtype)
    return out


def _pallas(x, sh, w, tb, dtype):
    jt = [jnp.asarray(tb[k]) for k in ("CBIG_R", "EXPW", "SUMR")]
    cast = lambda a: jnp.asarray(a[None]).astype(dtype)
    call = pl.pallas_call
    try:
        JTK.pl.pallas_call = functools.partial(call, interpret=True)
        out = JTK._pallas_fused_tp(cast(x), cast(sh), cast(w), *jt)
    finally:
        JTK.pl.pallas_call = call
    return np.asarray(out[0].astype(jnp.float32))


@pytest.mark.parametrize("layer", SIGS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_emulation_matches_pallas(layer, dtype):
    tb = _tables(layer)
    rng = np.random.default_rng(20 + layer)
    M, din = 100, irrep_ladder(12, 4)[layer].dim
    x = rng.normal(size=(M, din)).astype(np.float32)
    sh = np.array(JI.sh_l2(jnp.asarray(rng.normal(size=(M, 3)).astype(np.float32))))
    w = (rng.normal(size=(M, tb["numel"])) * din ** -0.5).astype(np.float32)
    dout = tb["SUMR"].shape[1]
    got = emulate_kernel(x, sh, w, TK.mma_tables(tb), dout,
                         getattr(torch, dtype)).float().numpy()
    want = _pallas(x, sh, w, tb, getattr(jnp, dtype))
    assert got.shape == want.shape == (M, dout)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
