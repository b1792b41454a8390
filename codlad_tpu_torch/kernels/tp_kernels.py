"""K10, the fused tensor product, and K11, its backward: CUDA kernels and the
plain version.

Counterpart of `fused_tp` in codlad_tpu/kernels/tp_kernels.py (Pallas
`_pallas_fused_tp`). With the tables of nn/tensor_product.fused_tp_tables:

    TR = concat_b(x * sh[b]) @ CBIG_R;  wR = w @ EXPW;  out = (wR * TR) @ SUMR

over rows of x [..., din], sh [..., dsh], w [..., numel] (edge operands
[B, E, *] and the cross graph's [B, L, 14, *] alike: every leading dim is a
row) -> [..., dout] in x's dtype.

On a CUDA tensor `fused_tp` launches `csrc/fused_tp.cu` or raises; the plain
version `ref_fused_tp` (the dense-table form of the JAX `ref_fused_tp`:
TR and wR cast to x's dtype before their product) runs only for tensors on
the CPU. The kernel computes the same function from the tables' nonzeros
(CBIG_R at layer 2 alone is 871 KB in f32, more than a block's shared
memory; EXPW and SUMR are 0/1 selections) and rounds as the Pallas kernel
does: x * sh[b] and CBIG_R in x's dtype, TR and wR in f32, their product
cast to x's dtype, the output summed in f32 and cast. So in bf16 it differs
from the plain version by the rounding of TR. In f32 it runs on CUDA cores
from `f32_fwd_tables`' blob (CBIG_R's nonzeros as 64-bit words in output
column order, a word a position q, 16-bit column pointers and the warps'
schedule of output columns), which a persistent block stages in shared
memory once, with 64 rows a tile (two a lane); in bf16 on the tensor cores,
from the nonzero 16 x 8 tiles of CBIG_R and SUMR that `mma_tables` packs.

On a CUDA tensor `fused_tp` is a torch.autograd.Function whose backward is
K11 (`csrc/fused_tp_bwd.cu`, counterpart of `_pallas_fused_tp_bwd`): dx,
dsh and dw of every row, rounded as the Pallas backward rounds (the note
at the top of the .cu file). In f32 on CUDA cores from `f32_bwd_tables`'
blob (CBIG_R's nonzeros by column and by row as 64-bit words, 16-bit
pointers and the warps' schedule), which a persistent block stages in
shared memory once, with 64 rows a tile (two a lane); in bf16 on the
tensor cores from `mma_tables`' CBIG_R tiles and `mma_bwd_tables`'
CBIG_R^T tiles, gathers and dw codes. The dsh store is skipped when sh
needs no grad (the encoder's sh come from coordinates). On the CPU
autograd differentiates the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from codlad_tpu_torch.kernels import build

LAUNCHES = {"fused_tp": 0, "fused_tp_bwd": 0}   # K10, K11 launches since the last reset
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ref_fused_tp(x, sh, w, cbig_r, expw, sumr):
    """Plain version: x [..., din], sh [..., dsh], w [..., numel] and the
    dense tables (numpy or tensors) -> [..., dout] in x's dtype. Products
    accumulate in f32 (float64 for float64 operands: the card's checks hold
    the f32 kernels against this version run in float64)."""
    dt, dev = x.dtype, x.device
    f32 = torch.float64 if dt == torch.float64 else torch.float32
    tab = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dt).to(f32)
    sh, w = sh.to(dt), w.to(dt)
    t = torch.cat([x * sh[..., b:b + 1] for b in range(sh.shape[-1])], dim=-1)
    TR = (t.to(f32) @ tab(cbig_r)).to(dt)
    wR = (w.to(f32) @ tab(expw)).to(dt)
    return ((wR * TR).to(f32) @ tab(sumr)).to(dt)


def sparse_tables(tb):
    """The kernels' lists, from fused_tp_tables' dense ones. The R expansion
    columns are reordered by output column: positions q of column c are
    cptr[c] .. cptr[c+1]-1 (qcol[q] = c); position q reads weight widx[q]
    and the nonzeros rptr[q] .. rptr[q+1]-1 of its CBIG_R column (row into
    concat_b(x * sh[b]), split as row = rb * din + rf, and coefficient).
    Every nonzero is kept, however small, so the kernels compute exactly the
    dense form's sums. The f32 K10's and K11's tables (`f32_fwd_tables`,
    `f32_bwd_tables`) are packed from these and, for K11, from two
    transposed lists: the positions q of weight k,
    wq[wptr[k] .. wptr[k+1]-1] (EXPW^T), and the nonzeros of CBIG_R row j,
    (tq, tcoef)[tptr[j] .. tptr[j+1]-1] (CBIG_R^T), each in increasing q."""
    cbig_r, expw, sumr = tb["CBIG_R"], tb["EXPW"], tb["SUMR"]
    col = sumr.argmax(axis=1)                 # output column of each r
    order = np.argsort(col, kind="stable")
    cptr = np.concatenate([[0], np.cumsum(np.bincount(col, minlength=sumr.shape[1]))])
    widx = expw.argmax(axis=0)[order]
    nz = [np.nonzero(cbig_r[:, r])[0] for r in order]
    rptr = np.concatenate([[0], np.cumsum([len(z) for z in nz])])
    rows = np.concatenate(nz)
    coef = np.concatenate([cbig_r[z, r] for z, r in zip(nz, order)])
    qz = np.repeat(np.arange(len(order)), np.diff(rptr))   # the q of each nonzero
    tord = np.argsort(rows, kind="stable")
    wq = np.argsort(widx, kind="stable")
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return {"cptr": i32(cptr), "qcol": i32(col[order]), "widx": i32(widx), "rptr": i32(rptr),
            "rows": i32(rows), "coef": f32(coef),
            "wptr": i32(np.concatenate([[0], np.cumsum(np.bincount(widx,
                                                                   minlength=tb["numel"]))])),
            "wq": i32(wq),
            "tptr": i32(np.concatenate([[0], np.cumsum(np.bincount(
                rows, minlength=cbig_r.shape[0]))])),
            "tq": i32(qz[tord]), "tcoef": f32(coef[tord]), "nnz": int(rows.size)}


FWD_WARPS = 16  # warps of the f32 K10's block: the lists of its schedule
BWD_WARPS = 16  # warps of the f32 K11's block: the lists of its schedule
BWD_GROUP = 4   # weights a unit of its dw phase


def _words(lo, coef):
    """64-bit entry words: the index fields `lo` in the low 32 bits, the f32
    coefficient's bits in the high 32 (a little-endian uint2 (x, y) on the
    card)."""
    hi = np.ascontiguousarray(coef, np.float32).view(np.uint32).astype(np.uint64)
    return np.asarray(lo, np.uint64) | hi << np.uint64(32)


def _balance(costs, n):
    """Unit indices split into n lists, longest first to the least loaded
    (ties to the lower list), each list ascending."""
    loads, lists = [0] * n, [[] for _ in range(n)]
    for u in sorted(range(len(costs)), key=lambda u: (-costs[u], u)):
        i = min(range(n), key=lambda i: (loads[i], i))
        lists[i].append(u)
        loads[i] += costs[u]
    return [sorted(v) for v in lists]


def _check16(tb, what):
    """Raise unless the signature's nonzeros, expansion columns, CBIG_R rows,
    weights and output columns all fit the 16-bit fields of `what`."""
    (K, R), nnz = tb["CBIG_R"].shape, int(np.count_nonzero(tb["CBIG_R"]))
    if max(nnz, R, K, tb["numel"], tb["SUMR"].shape[1]) >= 1 << 16:
        raise ValueError(f"the {what}'s 16-bit tables take fewer than 65536 nonzeros, "
                         f"columns and weights, not {tb['sig']}")


def _pack(parts, align=1):
    """One uint8 blob, a multiple of 16 bytes, holding the arrays of `parts`
    in order, each at a byte offset that is a multiple of `align`: (blob,
    {key: offset})."""
    offsets, at = {}, 0
    for key, arr in parts.items():
        at = -(-at // align) * align
        offsets[key] = at
        at += arr.nbytes
    blob = np.zeros(-(-at // 16) * 16, np.uint8)
    for key, arr in parts.items():
        blob[offsets[key]:offsets[key] + arr.nbytes] = arr.view(np.uint8)
    return blob, offsets


def f32_fwd_tables(tb):
    """The f32 K10's tables (csrc/fused_tp.cu `fused_tp_f32_kernel`), packed
    from `sparse_tables`' lists into one blob that a block copies to its
    shared memory once:

    * ez [nnz + 1] (64-bit words): CBIG_R's nonzeros in the lists' order
      (output column c, its positions q in cptr's order, each q's nonzeros
      in rptr's order), so that column c's nonzeros are one run; low word
      rf | rb << 16 (the nonzero's row rb * din + rf of concat_b(x *
      sh[b])), high word the coefficient; then a zero word, which the walk
      reads (and does not use) one step past the last column's run;
    * qword [R + 2] (32 bits): position q's first nonzero in ez | its
      weight widx[q] << 16; qword[R]'s start is nnz, qword[R + 1] zero;
    * cptr [dout + 1] (16 bits): the positions of output column c, cptr[c]
      .. cptr[c + 1] - 1;
    * sched (16 bits): ptr [FWD_WARPS + 1] (absolute indices into sched),
      then warp w's output columns sched[ptr[w] .. ptr[w + 1] - 1],
      ascending, balanced over the warps by their entries (a column's
      nonzeros and positions).

    "blob" (uint8, a multiple of 16 bytes) holds them in that order, each
    at a 16-byte aligned byte offset ("offsets": z, q, cp, sc; "bytes")."""
    _check16(tb, "f32 K10")
    sp = sparse_tables(tb)
    din, dout = tb["din"], tb["SUMR"].shape[1]
    rows, rptr, cptr = sp["rows"].astype(np.int64), sp["rptr"], sp["cptr"]
    ez = np.append(_words(rows % din | (rows // din) << 16, sp["coef"]), np.uint64(0))
    qword = np.append(rptr | np.append(sp["widx"], 0).astype(np.int64) << 16, 0)
    qword = qword.astype(np.uint32)
    zlen = np.diff(rptr)
    cost = [int(zlen[cptr[c]:cptr[c + 1]].sum() + cptr[c + 1] - cptr[c]) for c in range(dout)]
    lists = _balance(cost, FWD_WARPS)
    ptr = FWD_WARPS + 1 + np.concatenate([[0], np.cumsum([len(v) for v in lists])])
    sched = np.concatenate([ptr, *(np.asarray(v, np.int64) for v in lists)]).astype(np.uint16)
    parts = {"z": ez, "q": qword, "cp": cptr.astype(np.uint16), "sc": sched}
    blob, offsets = _pack(parts, align=16)
    return {"ez": ez, "qword": qword, "cptr": parts["cp"], "sched": sched, "blob": blob,
            "offsets": offsets, "bytes": blob.size}


def f32_bwd_tables(tb):
    """The f32 K11's tables (csrc/fused_tp_bwd.cu `fused_tp_bwd_f32_kernel`),
    packed from `sparse_tables`' lists into one blob that a block copies to
    its shared memory once:

    * etr [nnz] (64-bit words): CBIG_R's nonzeros by expansion column q in
      dw order, the q of weight 0, then of weight 1, ... (wq's order, q
      ascending within a weight), each q's nonzeros in rptr's order; low
      word rf | rb << 16 (the nonzero's row rb * din + rf of concat_b(x *
      sh[b])), high word the coefficient;
    * edb [nnz] (64-bit words): the nonzeros of each CBIG_R row j (tptr's
      runs, q ascending): low word qcol[q] | widx[q] << 16, the two gathers
      of dTR[q] = dct[qcol q] * w[widx q], high word the coefficient;
    * qword [R + 1] (32 bits): position t in dw order, its nonzeros' start
      in etr | its output column qcol << 16; qword[R]'s start is nnz;
    * kqptr [numel + 1] (16 bits): the positions of weight k, kqptr[k] ..
      kqptr[k + 1] - 1 (wptr);
    * tptr [K + 1] (16 bits): each CBIG_R row's run of edb;
    * sched (16 bits): aptr [BWD_WARPS + 1], bptr [BWD_WARPS + 1] (absolute
      indices into sched), then warp w's dw units sched[aptr[w] ..
      aptr[w + 1] - 1] (the first weight k0 of BWD_GROUP consecutive ones)
      and its Db units sched[bptr[w] .. bptr[w + 1] - 1] (an x feature f:
      the CBIG_R rows b * din + f, b ascending), each list ascending,
      balanced over the warps by their entries.

    "blob" (uint8, a multiple of 16 bytes) holds them in that order, each
    at its byte offset ("offsets": tr, db, q, kq, tp, sc; "bytes")."""
    _check16(tb, "f32 K11")
    sp = sparse_tables(tb)
    din, numel = tb["din"], tb["numel"]
    K, R = tb["CBIG_R"].shape
    rows, rptr, wq, qcol, widx = sp["rows"], sp["rptr"], sp["wq"], sp["qcol"], sp["widx"]
    zlen = np.diff(rptr)[wq]
    zstart = np.concatenate([[0], np.cumsum(zlen)])
    src = np.concatenate([np.arange(rptr[q], rptr[q + 1]) for q in wq])
    etr = _words(rows[src] % din | (rows[src] // din) << 16, sp["coef"][src])
    edb = _words(qcol[sp["tq"]] | widx[sp["tq"]] << 16, sp["tcoef"])
    qword = (zstart | np.append(qcol[wq], 0) << 16).astype(np.uint32)
    kqptr, tptr = sp["wptr"].astype(np.uint16), sp["tptr"].astype(np.uint16)
    units_a = range(0, numel, BWD_GROUP)
    cost_a = [sum(int(zlen[t]) + 1 for k in range(k0, min(k0 + BWD_GROUP, numel))
                  for t in range(kqptr[k], kqptr[k + 1])) + 1 for k0 in units_a]
    tlen = np.diff(sp["tptr"])
    cost_b = [int(tlen[f::din].sum()) + 2 * (K // din) for f in range(din)]
    lists_a = [[units_a[u] for u in v] for v in _balance(cost_a, BWD_WARPS)]
    lists_b = _balance(cost_b, BWD_WARPS)
    head = 2 * (BWD_WARPS + 1)
    aptr = head + np.concatenate([[0], np.cumsum([len(v) for v in lists_a])])
    bptr = aptr[-1] + np.concatenate([[0], np.cumsum([len(v) for v in lists_b])])
    sched = np.concatenate([aptr, bptr, *map(np.asarray, lists_a), *map(np.asarray, lists_b)])
    sched = sched.astype(np.uint16)
    blob, offsets = _pack({"tr": etr, "db": edb, "q": qword, "kq": kqptr, "tp": tptr,
                           "sc": sched})
    return {"etr": etr, "edb": edb, "qword": qword, "kqptr": kqptr, "tptr": tptr,
            "sched": sched, "blob": blob, "offsets": offsets, "bytes": blob.size}


def _pack_tiles(dense, by):
    """The nonzero k16 x n8 tiles of `dense` [K, N] (K % 16 == N % 8 == 0)
    as the B operand of mma.m16n8k16: (ptr, other, frags), the tiles grouped
    by column tile (by="n": tiles ptr[n] .. ptr[n+1]-1, `other` their k
    tiles, ascending) or by k tile (by="k", `other` the column tiles).
    frags [T, 32, 4]: lane l of tile t holds rows 2(l%4) + (0, 1, 8, 9) of
    column l//4, in the order its two registers take them."""
    K, N = dense.shape
    blocks = dense.reshape(K // 16, 16, N // 8, 8).transpose(0, 2, 1, 3)   # [kt, nt, 16, 8]
    nz = np.any(blocks != 0, axis=(2, 3))
    if by == "n":
        grp, other = np.nonzero(nz.T)
        sel = blocks[other, grp]
    else:
        grp, other = np.nonzero(nz)
        sel = blocks[grp, other]
    lane = np.arange(32)
    rows = 2 * (lane % 4)[:, None] + np.array([0, 1, 8, 9])
    frags = sel[:, rows, (lane // 4)[:, None]]
    ptr = np.concatenate([[0], np.cumsum(np.bincount(grp, minlength=nz.shape[1 if by == "n"
                                                                           else 0]))])
    return ptr, other, frags


def mma_tables(tb):
    """The bf16 kernel's tables: CBIG_R and SUMR with the R columns in
    `sparse_tables`' order (grouped by output column), padded to 16-wide k
    steps, cut into k16 x n8 tiles, the nonzero ones packed by `_pack_tiles`.
    CBIG_R's tiles by pair p of column tiles (2p, 2p+1): tiles cptr[p] ..
    cptr[p+1]-1, first cboth[p] steps of one tile of 2p then one of 2p+1,
    then cxa[p] more of 2p, then the rest of 2p+1, k tiles ascending within
    a column tile; ctile = 2 * k tile + (1 for 2p+1), fragments cfrag;
    maxpair, the most tiles of a pair. SUMR's by k16 step (snptr, stile,
    sfrag). widx: the weight of each reordered column, padded with 0.
    npairs = the k16 steps of R. Fragments in f32 (the caller rounds)."""
    cbig_r, sumr = tb["CBIG_R"], tb["SUMR"]
    order = np.argsort(sumr.argmax(axis=1), kind="stable")
    (K, R), dout = cbig_r.shape, sumr.shape[1]
    kp, rp, op = -(-K // 16) * 16, -(-R // 16) * 16, -(-dout // 8) * 8
    cb = np.zeros((kp, rp), np.float32)
    cb[:K, :R] = cbig_r[:, order]
    sr = np.zeros((rp, op), np.float32)
    sr[:R, :dout] = sumr[order]
    widx = np.zeros(rp, np.int64)
    widx[:R] = tb["EXPW"].argmax(axis=0)[order]
    nptr, kt, frags = _pack_tiles(cb, "n")
    seq, code, both, xa = [], [], [], []
    for p in range(rp // 16):
        a, b = (list(range(nptr[2 * p + h], nptr[2 * p + h + 1])) for h in (0, 1))
        nb = min(len(a), len(b))
        run = [t for pair in zip(a[:nb], b[:nb]) for t in pair] + a[nb:] + b[nb:]
        seq += run
        code += [2 * kt[t] + int(t >= nptr[2 * p + 1]) for t in run]
        both.append(nb)
        xa.append(len(a) - nb)
    snptr, stile, sfrag = _pack_tiles(sr, "k")
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return {"cptr": i32(nptr[::2]), "cboth": i32(both), "cxa": i32(xa), "ctile": i32(code),
            "cfrag": np.float32(frags[seq]), "maxpair": int(np.diff(nptr[::2]).max()),
            "snptr": i32(snptr), "stile": i32(stile), "sfrag": np.float32(sfrag),
            "widx": i32(widx), "npairs": rp // 16}


DW_STORE, DW_STASH, DW_ADD = 0, 1, 2   # kinds of `mma_bwd_tables`' dwcode
_SLOT_TILES = 32   # the bf16 K11's ring slot, in k16 x n8 tiles (8 KB of fragments)


def mma_bwd_tables(tb):
    """The bf16 K11's tables beside `mma_tables`, in its column order q
    (grouped by output column, padded to 16 * npairs):

    * qcol: the output column of q (0 in the padding), the gather dct SUMR^T;
    * dwcode: how cast(dwR[q]) enters dw = cast(dwR) EXPW^T, whose weight k
      has 1 or 3 columns q: k | kind << 12 | slot << 16, the kind DW_STORE
      (a weight's first q: into the dw tile), DW_STASH (the middle one of
      three: into stash slot `slot`) or DW_ADD (the last of three: dw =
      cast((first + stash) + it)); -1 in the padding; ntri weights have
      three;
    * CBIG_R^T in q order, [16 npairs, 8 ceil(K / 8)], cut into k16 x n8
      (q x j) tiles by `_pack_tiles`, the nonzero ones in two chunks of nj =
      ceil(K / 16) column tiles: groups [0, split) hold chunk 0, the rest
      chunk 1, each group one k step gks[g] with tiles gptr[g] ..
      gptr[g + 1] - 1, column tiles ascending, gcode the column tile within
      its chunk (gmask, the kernel's form: a group's codes as bits),
      fragments gfrag (f32; the caller rounds);
    * the ring's slots of at most `cap` tiles: runs of whole pairs of
      `mma_tables` (aslot: their first pairs, then npairs) and of whole
      groups (cslot, then ngroups; the first csplit slots hold chunk 0)."""
    cbig_r, sumr, expw = tb["CBIG_R"], tb["SUMR"], tb["EXPW"]
    order = np.argsort(sumr.argmax(axis=1), kind="stable")
    (K, R), numel = cbig_r.shape, tb["numel"]
    if numel >= 4096:
        raise ValueError(f"dwcode takes fewer than 4096 weights, not {numel}")
    rp = -(-R // 16) * 16
    njt = -(-K // 8)
    nj = -(-njt // 2)
    qcol = np.zeros(rp, np.int64)
    qcol[:R] = sumr.argmax(axis=1)[order]
    widx = expw.argmax(axis=0)[order]
    dwcode = np.full(rp, -1, np.int64)
    ntri = 0
    for k in range(numel):
        qs = np.nonzero(widx == k)[0]
        if len(qs) == 1:
            kinds = [DW_STORE]
        elif len(qs) == 3:
            kinds = [DW_STORE, DW_STASH, DW_ADD]
        else:
            raise ValueError(f"weight {k} has {len(qs)} expansion columns, not 1 or 3")
        for q, kind in zip(qs, kinds):
            dwcode[q] = k | kind << 12 | (ntri << 16 if len(qs) == 3 else 0)
        ntri += len(qs) == 3
    ct = np.zeros((rp, 8 * njt), np.float32)
    ct[:R, :K] = cbig_r[:, order].T
    kptr, jt, frags = _pack_tiles(ct, "k")
    gks, gptr, gcode, seq, split = [], [0], [], [], 0
    for c in range(2):
        for s in range(rp // 16):
            run = [t for t in range(kptr[s], kptr[s + 1]) if jt[t] // nj == c]
            if run:
                gks.append(s)
                seq += run
                gcode += [int(jt[t]) - c * nj for t in run]
                gptr.append(len(seq))
        if c == 0:
            split = len(gks)
    gmask = [sum(1 << c for c in gcode[a:b]) for a, b in zip(gptr[:-1], gptr[1:])]
    mt = mma_tables(tb)
    cap = max(_SLOT_TILES, mt["maxpair"], int(np.diff(gptr).max(initial=0)))
    aslot = _slots(mt["cptr"], [], cap)
    cslot = _slots(np.asarray(gptr), [split], cap)
    i32 = lambda a: np.ascontiguousarray(a, np.int32)
    return {"qcol": i32(qcol), "dwcode": i32(dwcode), "ntri": ntri, "gks": i32(gks),
            "gptr": i32(gptr), "gcode": i32(gcode), "gmask": np.asarray(gmask, np.uint32),
            "gfrag": np.float32(frags[seq]), "split": split, "nj": nj,
            "aslot": i32(aslot), "cslot": i32(cslot), "csplit": cslot.index(split),
            "cap": cap}


def _slots(ptr, cuts, cap):
    """Runs of consecutive units (pairs or groups; unit u holds tiles ptr[u]
    .. ptr[u + 1] - 1) of at most `cap` tiles in all, none crossing a unit
    index in `cuts`: their boundaries, from 0 to the number of units."""
    out, n = [0], len(ptr) - 1
    for u in range(n):
        if u > out[-1] and (u in cuts or ptr[u + 1] - ptr[out[-1]] > cap):
            out.append(u)
    if out[-1] != n:
        out.append(n)
    return out


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {  # the pointers, then M and the ints, of each entry point
    "fused_tp_f32": [_P] * 5 + [_LL] + [_I] * 8,
    "fused_tp_bf16": [_P] * 13 + [_LL] + [_I] * 6,
    "fused_tp_bwd_f32": [_P] * 8 + [_LL] + [_I] * 10,
    "fused_tp_bwd_bf16": [_P] * 21 + [_LL] + [_I] * 12,
}


_DEVICE_TABLES: dict = {}


def _device_tables(tb, device, dtype):
    """The kernels' tables on `device`, cached by signature: for f32 the
    blobs of `f32_fwd_tables` (key "f32_fwd", K10) and `f32_bwd_tables`
    (key "f32_bwd", K11); for bf16 the packed tiles of `mma_tables` (key
    "mma") and of `mma_bwd_tables` (key "mma_bwd"), their fragments rounded
    to bf16 (as the Pallas kernel casts CBIG_R to x's dtype)."""
    key = (tb["sig"], str(device), dtype)
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        hit = {}
        if dtype == torch.float32:
            for name, pack in (("f32_fwd", f32_fwd_tables), ("f32_bwd", f32_bwd_tables)):
                t = pack(tb)
                hit[name] = dict(t["offsets"], bytes=t["bytes"],
                                 blob=torch.as_tensor(t["blob"], device=device))
        if dtype == torch.bfloat16:
            mt = mma_tables(tb)
            hit["mma"] = {k: v if isinstance(v, int) else torch.as_tensor(v, device=device)
                          for k, v in mt.items()}
            for k in ("cfrag", "sfrag"):
                hit["mma"][k] = hit["mma"][k].to(dtype).contiguous()
            mb = mma_bwd_tables(tb)
            hit["mma_bwd"] = {k: v if isinstance(v, int) else torch.as_tensor(
                v.view(np.int32) if v.dtype == np.uint32 else v, device=device)
                for k, v in mb.items()}
            hit["mma_bwd"]["gfrag"] = hit["mma_bwd"]["gfrag"].to(dtype).contiguous()
        _DEVICE_TABLES[key] = hit
    return hit


def _check_operands(x, sh, w, tb):
    if x.dtype not in _SUFFIX:
        raise ValueError(f"x must be bfloat16 or float32, not {x.dtype}")
    din, dsh, numel = x.shape[-1], sh.shape[-1], w.shape[-1]
    if (din * dsh, numel) != (tb["CBIG_R"].shape[0], tb["numel"]):
        raise ValueError(f"operands (din {din}, dsh {dsh}, numel {numel}) do not match "
                         f"the tables {tb['sig']}")
    lead = x.shape[:-1]
    if sh.shape[:-1] != lead or w.shape[:-1] != lead:
        raise ValueError(f"row shapes differ: {tuple(x.shape)}, {tuple(sh.shape)}, "
                         f"{tuple(w.shape)}")
    for name, t in (("sh", sh), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch_fused_tp(x, sh, w, tb):
    din, dsh, numel = x.shape[-1], sh.shape[-1], w.shape[-1]
    dout = tb["SUMR"].shape[1]
    dev, dt = x.device, x.dtype
    M = x.numel() // din
    out = torch.empty(x.shape[:-1] + (dout,), dtype=dt, device=dev)
    tabs = _device_tables(tb, dev, dt)
    if dt == torch.bfloat16:
        if dout > 64:
            raise ValueError(f"the bf16 kernel takes dout <= 64, not {dout}")
        mt = tabs["mma"]
        args = [*(t.data_ptr() for t in (x, sh, w)),
                *(mt[k].data_ptr() for k in ("cptr", "cboth", "cxa", "ctile", "cfrag",
                                             "snptr", "stile", "sfrag", "widx")),
                out.data_ptr(), M, din, dsh, numel, dout, mt["npairs"], mt["maxpair"]]
    else:
        ft = tabs["f32_fwd"]
        args = [*(t.data_ptr() for t in (x, sh, w)), ft["blob"].data_ptr(), out.data_ptr(),
                M, din, dsh, numel, dout, *(ft[k] for k in ("bytes", "q", "cp", "sc"))]
    name = f"fused_tp_{_SUFFIX[dt]}"
    build.launch(build.entry("fused_tp", name, _ARGTYPES[name]), dev, *args)
    LAUNCHES["fused_tp"] += 1
    return out


def fused_tp_bwd(x, sh, w, dct, tb, want_dsh=True):
    """K11: (dx, dsh, dw) of K10 at x, sh, w for the output cotangent dct
    [..., dout], each in x's dtype (dsh None when not `want_dsh`). CUDA
    tensors only: the plain backward is autograd of `ref_fused_tp`."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_tp_bwd runs on CUDA tensors, not {x.device}")
    _check_operands(x, sh, w, tb)
    din, dsh, numel = x.shape[-1], sh.shape[-1], w.shape[-1]
    dout = tb["SUMR"].shape[1]
    if dct.shape != x.shape[:-1] + (dout,) or dct.device != x.device:
        raise ValueError(f"dct {tuple(dct.shape)} on {dct.device} does not match the "
                         f"output {tuple(x.shape[:-1]) + (dout,)} on {x.device}")
    dev, dt = x.device, x.dtype
    x, sh, w, dct = (t.to(dt).contiguous() for t in (x, sh, w, dct))
    M = x.numel() // din
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    dsh_out = torch.empty_like(sh) if want_dsh else None
    tabs = _device_tables(tb, dev, dt)
    name = f"fused_tp_bwd_{_SUFFIX[dt]}"
    outs = [dx.data_ptr(), None if dsh_out is None else dsh_out.data_ptr(), dw.data_ptr()]
    ptrs = [t.data_ptr() for t in (x, sh, w, dct)]
    if dt == torch.bfloat16:
        mt, mb = tabs["mma"], tabs["mma_bwd"]
        args = [*ptrs, *(mt[k].data_ptr() for k in ("cptr", "cboth", "cxa", "ctile", "cfrag")),
                mb["qcol"].data_ptr(), mb["dwcode"].data_ptr(), mt["widx"].data_ptr(),
                *(mb[k].data_ptr() for k in ("gks", "gptr", "gmask", "gfrag", "aslot", "cslot")),
                *outs,
                M, din, dsh, numel, dout, mt["npairs"], mb["ntri"], len(mb["gks"]),
                mb["nj"], len(mb["aslot"]) - 1, len(mb["cslot"]) - 1, mb["csplit"], mb["cap"]]
    else:
        ft = tabs["f32_bwd"]
        args = [*ptrs, ft["blob"].data_ptr(), *outs, M, din, dsh, numel, dout,
                *(ft[k] for k in ("bytes", "db", "q", "kq", "tp", "sc"))]
    build.launch(build.entry("fused_tp_bwd", name, _ARGTYPES[name]), dev, *args)
    LAUNCHES["fused_tp_bwd"] += 1
    return dx, dsh_out, dw


class _FusedTP(torch.autograd.Function):
    """K10 forward, K11 backward."""

    @staticmethod
    def forward(ctx, x, sh, w, tb):
        ctx.save_for_backward(x, sh, w)
        ctx.tb = tb
        return _launch_fused_tp(x, sh, w, tb)

    @staticmethod
    def backward(ctx, dct):
        need = ctx.needs_input_grad
        if not any(need[:3]):
            return None, None, None, None
        x, sh, w = ctx.saved_tensors
        dx, dsh, dw = fused_tp_bwd(x, sh, w, dct, ctx.tb, want_dsh=need[1])
        return dx if need[0] else None, dsh, dw if need[2] else None, None


def fused_tp(x, sh, w, tb):
    """K10: x [..., din] (x) sh [..., dsh] with per-row weights w [..., numel]
    and the tables `tb` of fused_tp_tables -> [..., dout] in x's dtype; its
    backward on the card is K11."""
    if x.device.type == "cpu":
        return ref_fused_tp(x, sh, w, tb["CBIG_R"], tb["EXPW"], tb["SUMR"])
    _check_operands(x, sh, w, tb)
    dt = x.dtype
    return _FusedTP.apply(x.contiguous(), sh.to(dt).contiguous(), w.to(dt).contiguous(), tb)
