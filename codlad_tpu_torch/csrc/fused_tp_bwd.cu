// Fused tensor-product backward (K11) for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the TPU kernel of codlad_tpu/kernels/tp_kernels.py:
//   K11 fused_tp_bwd_* <- _tp_bwd_kernel / _pallas_fused_tp_bwd
//
// The forward (K10, fused_tp.cu) is out = (wR * TR) SUMR with
// TR = xcat CBIG_R, wR = w EXPW, xcat[b*din + f] = x[f] * sh[b]. Per row
// (an edge, or an atom slot of the dense cross graph), given the output's
// cotangent dct [dout]:
//   dprod = dct SUMR^T        (dprod[q] = dct[col(q)]: a gather)
//   dTR = dprod * wR,  dwR = dprod * TR          (f32; TR recomputed)
//   dw  = cast(dwR) EXPW^T    (dw[k] = sum of cast(dwR[q]) over the q of weight k)
//   Db  = cast(dTR) CBIG_R^T  (f32)
//   dx[f]  = sum_b cast(sh[b] * Db[b*din + f]),  dsh[b] = sum_f cast(x[f] * Db[b*din + f])
// with the Pallas kernel's rounding: dct, CBIG_R's coefficients and x * sh[b]
// in the payload dtype (the wrapper rounds the coefficients), TR, dprod, dTR,
// dwR and Db in f32, dwR and dTR cast before their sums, the products sh * Db
// and x * Db cast before theirs, every sum in f32, the outputs cast. Every
// output is per row, so no sum crosses blocks, and every sum is taken in a
// fixed order (no atomics): a launch repeats bit for bit.
//
// Bound: each row reads din + dsh + numel + dout and writes din + dsh + numel
// elements; the w and dw rows are most of the bytes (at the Stage-1 bench
// shape, layer 2: 4 x 65536 edges, din 36, numel 384, 0.14 ms at 3.35 TB/s
// in bf16), and the block-sparse products (1086 nonzero k16 x n8 tiles a
// 16-row slab, 73 GFLOP: 0.07 ms at the bf16 tensor cores' peak) less, so
// memory sets the bound.
// chip_smoke.py computes it from the run's inputs.
//
// f32 (`fused_tp_bwd_f32_kernel<RT>`): CUDA cores. The tensor cores in f32
// would be TF32, outside the f32 tolerance, and a 3xTF32 form of the bf16
// design below would do three times its block-sparse products, whose bf16
// form alone (2.77 ms at layer 2) is slower than this kernel. The work is
// small: 4 nnz + 5 R + 5 dsh din FMAs a row (5.5 G at layer 2, 0.08 ms at
// 67 TFLOP/s), under the bytes (0.28 ms at 3.35 TB/s). It replaced a design
// bound by latency (one row a lane, 32 rows a block, every Db and dw entry
// a chain of dependent table loads through L1: 3.9 ms at layer 2). Here:
//   * Tables staged once: a persistent grid, one block of 16 warps an SM,
//     copies its signature's tables (kernels/tp_kernels.py `f32_bwd_tables`,
//     one blob) into shared memory at the start: CBIG_R's nonzeros by
//     expansion column in dw order (etr) and by CBIG_R row (edb) as 64-bit
//     words, index fields low, the f32 coefficient high; the small pointer
//     arrays in 16 bits (the q of each weight, each row's run of edb) and
//     each q's first nonzero and output column in 32 (qword). edb holds
//     (qcol[q], widx[q]) rather than q, so no entry waits on a second
//     lookup. Every warp walks the tables in step across its 32 lanes: each
//     read is a warp-uniform shared load (a broadcast). 69 KB at layer 2.
//   * Rows by cp.async: a tile of T = 32 RT rows, lane l owns rows l + 32 r
//     (r < RT; RT = 2, or 1 where two do not fit), so each entry word is read
//     once for RT rows, and the RT FMA chains are independent. x, sh and dct
//     (S, two buffers) and w (W, one) are staged feature-major, f * rs + r
//     with rs = T + 1: the lanes' reads of one feature and a warp's copy of
//     one row both fall on 32 distinct banks. The S of tile i + 1 loads
//     while tile i is computed.
//   * Two phases a tile over units that the host balances across the warps
//     (`f32_bwd_tables` sched). Db first, while W holds w: a unit is a
//     feature f, its CBIG_R rows j = b din + f (b ascending), Db[j] = sum of
//     coef (dct[qcol q] w[widx q]) over j's nonzeros (q ascending), then
//     dx[f] = sum_b sh[b] Db[j] into shared memory and the warp's part of
//     dsh in registers; the 16 warps' parts of dsh are added in warp order.
//     Then dw, into W (w is read): a unit is 4 consecutive weights; TR[q] =
//     sum of coef (x[rf] sh[rb]) over q's nonzeros (rptr's order), dw[k] =
//     sum of dct[qcol q] TR[q] over k's q (ascending), rows of dw in W at
//     an odd stride. dw, dx and dsh then leave row by row in coalesced
//     stores, and W of the next tile loads. (Stored from registers, a
//     lane a row, dw went out as 16-byte pieces 1.5 KB apart: on an H100
//     that took 0.78 of 2.13 ms at layer 2, more than all of Db.) The loops load each
//     entry one step ahead of its use. The Pallas backward's rounding in
//     f32: the products that it materialises before a sum (dwR = dprod TR,
//     sh Db, x Db) are rounded alone (__fmul_rn, never contracted into the
//     sum); the products inside its matmuls (TR, Db) are fmaf chains, x *
//     sh[b] and dct * w rounded first as it rounds xcat and dTR.
//   So every order is the old kernel's (the TR, Db, dw and dx sums) but
//   dsh's: there the old kernel took f ascending over all f, here each
//   warp's f ascending, then the warps in order.
// Shared memory at layer 2 (RT 2): the blob 68,928 bytes, W 99,840, S 2 x
// 24,180, P 2,340, X 9,360: 228,488 of the 232,448 bytes a block may take; at layer 3 -> 3 (enc_nconv > 3, numel 576) RT 1. ptxas: 94
// registers (RT 2), 80 (RT 1), no spills. What bounds it: each FMA reads
// one or two row operands from shared memory, ~17.8 k lane-words a row at
// layer 2 (Db and TR 2 a nonzero, dw and dx / dsh the rest), plus the
// entry words' broadcasts: at 32 lane-words a clock an SM on 132 SMs
// ~0.6-0.8 ms, above the byte bound (0.28 ms); and the W tile, which loads
// while no phase runs (the next tile's dw needs its buffer). PERF.md has
// the times.
//
// bf16 (`fused_tp_bwd_mma_kernel`): the Pallas backward's products on the
// tensor cores, block-sparse, mma.m16n8k16 (bf16 in, f32 sums). The first
// CUDA-core design (the f32 kernel's before its redesign) ran bf16 slower
// than f32 (5.15 against 4.19 ms, the extra roundings) and slower than the
// dense form's backward in cuBLAS. A block of
// BW = 3 warps owns BR = 48 rows, a warp 16. The R columns q are in K10's
// order (`mma_tables`: grouped by output column, padded to 16-wide steps).
// The packed tiles reach the warps through a two-slot cp.async ring in
// shared memory, one slot loading while the other is multiplied; a slot
// holds whole pairs (A) or whole groups (C) up to `cap` = 32 tiles
// (`mma_bwd_tables` aslot, cslot), so a block waits at 25 + 21 barriers at
// layer 2, not at one a pair or group (42 + 63, each exposing the next
// load's latency).
//   A. TR = xcat CBIG_R as the bf16 K10 computes it: xcat built in shared
//      memory from the staged x and sh, CBIG_R's nonzero k16 x n8 tiles
//      (66 / 300 / 516 at layers 0 / 1 / 2) by pair of column tiles, two
//      accumulator chains and two operand sets in flight. In each pair's
//      epilogue, dwR = cast(dct[qcol[q]] * TR[q]) from the staged dct tile
//      (SUMR is a 0/1 gather), and dw in a fixed order without atomics: EXPW
//      gives every weight 1 or 3 q's (dwcode), so the first q's cast(dwR)
//      goes to a bf16 dw tile in shared memory, a middle one to a small
//      stash, and the last one completes (d0 + d1) + d2 in f32 and casts it;
//      the stores come in two steps, a warp barrier between.
//   B. The dw tile leaves in 16-byte stores; w is staged into its place.
//   C. Db = cast(dTR) CBIG_R^T: dTR = cast(dct[qcol[q]] * w[widx[q]]) is two
//      gathers from the staged dct and w tiles, built in registers as the A
//      fragment of a k16 (q) step. CBIG_R^T in the same q order is cut into
//      k16 x n8 (q x j) tiles; only the nonzero ones (63 / 339 / 570) are
//      multiplied, by group (a k step's tiles of one chunk, gmask their
//      column tiles). Registers: Db is 41 n8 tiles a row at layer 2 (164 f32
//      a thread), so it is walked in two chunks of nj = ceil(dsh din / 16)
//      column tiles (7 / 14 / 21), each k step's A fragment built once a
//      chunk. A tile's accumulator is a static index: the loop runs over
//      every column tile of the chunk with a predicated mma (the mask bit,
//      the same in every lane); a switch on the tile's code instead, one
//      indirect branch a tile, was slower than all the products. Each chunk
//      is staged in f32 in the warp's xcat rows (free after A; a row holds
//      exactly 2 kpad bytes = 8 nj floats) and folded into dx and dsh, which
//      accumulate in registers over the chunks in ascending b and f.
// Shared memory at layer 2 (din 36, numel 384, dout 48): xcat 48 x 688,
// dw / w 48 x 784, stash 48 x 304, dct 48 x 112, x, sh, a 2 x 8.3 KB ring
// and the int tables, 113.0 KB: two blocks (6 warps) an SM, the dw tile
// being what keeps it from three; 238 / 202 / 166 registers at nj 24 / 16 /
// 8, no spills (three blocks an SM at layer 0). What bounds it is latency,
// not the bytes (0.14 ms) or the tensor cores: 6 warps an SM wait on
// shared-memory gathers, the ring and their own dependent steps. PERF.md
// has the times.

#include <algorithm>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

using mma::cp_async16;
using mma::cp_async4;
using mma::cp_async_commit;
using mma::cp_async_wait;
using mma::ldmatrix_x4;
using mma::mma_bf16;
using mma::pack_bf16;
using mma::round_bf16;
using mma::smem_addr;

constexpr int BW = 3;          // warps a block
constexpr int BR = 16 * BW;    // rows a block, 16 a warp (the mma's m)
constexpr int BNT = 32 * BW;
constexpr int MAX_DX = 24;     // dx elements a lane: 16 * din <= 32 * MAX_DX
constexpr int MAX_DS = 8;      // dsh elements a lane: 16 * dsh <= 32 * MAX_DS
constexpr int KIND_STORE = 0, KIND_STASH = 1, KIND_ADD = 2;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

struct BwdLayout {    // a block's shared memory, in bytes
  int kpad;           // dsh * din rounded up to the mma's k
  int xs;             // row stride of xcat [BR][kpad] (phase A), then of the Db chunks (C)
  int ws;             // row stride of the dw tile (A, B), then of w (C), [BR][numel]
  int ss, ds;         // row strides of the stash [BR][ntri] and of dct [BR][dout]
  int slot, codes;    // bytes of a ring slot (packed tiles, then their codes)
  int w_off, s_off, d_off, x_off, sh_off, ring_off, i_off, bytes;
};

// xcat, dw / w, the stash, dct, the raw x and sh tiles, a ring of two slots
// of `cap` tiles, then the int tables: the pairs' tile starts [npairs + 1],
// alternating steps [npairs] and extra tiles of column tile 2p [npairs],
// the A slots' first pairs [nas + 1], the groups' tile starts [ngroups +
// 1], k steps and masks [ngroups], the C slots' first groups [ncs + 1]
__host__ __device__ inline BwdLayout bwd_layout(int din, int dsh, int numel, int dout,
                                                int ntri, int npairs, int cap, int ngroups,
                                                int nas, int ncs) {
  BwdLayout l;
  l.kpad = round16(dsh * din);
  // (stride / 4) % 8 == 4: the 8 rows of an ldmatrix phase, and of a gather,
  // start in distinct 4-bank groups
  l.xs = 2 * l.kpad + 16;
  l.ws = round16(2 * numel) + 16;
  l.ss = round16(2 * ntri) + 16;
  l.ds = round16(2 * dout) + 16;
  l.codes = 256 * cap;
  l.slot = l.codes + round16(4 * cap);
  l.w_off = BR * l.xs;
  l.s_off = l.w_off + BR * l.ws;
  l.d_off = l.s_off + BR * l.ss;
  l.x_off = l.d_off + BR * l.ds;
  l.sh_off = l.x_off + round16(BR * din * 2);
  l.ring_off = l.sh_off + round16(BR * dsh * 2);
  l.i_off = l.ring_off + 2 * l.slot;
  l.bytes = l.i_off + 4 * (3 * npairs + nas + 3 * ngroups + ncs + 4);
  return l;
}

// bytes [0, valid) of src to dst and zeros up to `total` (a multiple of 16)
__device__ __forceinline__ void stage_flat(char* dst, const char* src, int valid, int total,
                                           bool a16, int tid) {
  const int full = a16 ? valid / 16 : 0;
  for (int i = tid; i < full; i += BNT) cp_async16(dst + 16 * i, src + 16 * i);
  const unsigned short* s2 = reinterpret_cast<const unsigned short*>(src);
  unsigned short* d2 = reinterpret_cast<unsigned short*>(dst);
  for (int i = 8 * full + tid; i < total / 2; i += BNT) d2[i] = 2 * i < valid ? s2[i] : 0;
}

// BR rows of rb bytes from contiguous src to dst at row stride ds: rows
// [0, nrows) copied, the others zero
__device__ __forceinline__ void stage_rows(char* dst, int ds, const char* src, int rb,
                                           int nrows, bool a16, int tid) {
  if (a16) {  // src 16-byte aligned, rb % 16 == 0
    const int cpr = rb / 16;
    for (int i = tid; i < BR * cpr; i += BNT) {
      const int r = i / cpr;
      char* d = dst + r * ds + 16 * (i - r * cpr);
      if (r < nrows) cp_async16(d, src + 16 * i);
      else *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
    }
  } else {
    const int epr = rb / 2;
    const unsigned short* s2 = reinterpret_cast<const unsigned short*>(src);
    for (int i = tid; i < BR * epr; i += BNT) {
      const int r = i / epr;
      reinterpret_cast<unsigned short*>(dst + r * ds)[i - r * epr] = r < nrows ? s2[i] : 0;
    }
  }
}

// n packed tiles from tile t0 into a ring slot (fragments, then their codes
// unless `code` is null), as one cp.async group
__device__ __forceinline__ void load_tiles(char* slot, int codes, int t0, int n,
                                           const int* __restrict__ code,
                                           const uint2* __restrict__ frag, int tid) {
  const char* src = reinterpret_cast<const char*>(frag + 32 * t0);
  for (int i = tid; i < 16 * n; i += BNT) cp_async16(slot + 16 * i, src + 16 * i);
  if (code != nullptr)
    for (int i = tid; i < n; i += BNT) cp_async4(slot + codes + 4 * i, code + t0 + i);
  cp_async_commit();
}

// TR: c += the product of CBIG_R tile t (A tile from xcat by its code)
__device__ __forceinline__ void tr_step(float* c, unsigned a_addr, const int* code,
                                        const uint2* frag, int t) {
  unsigned a[4];
  ldmatrix_x4(a, a_addr + 32 * (code[t] >> 1));
  const uint2 b = frag[32 * t];
  mma_bf16(c, a, b.x, b.y);
}

// the A tiles (ldmatrix from xcat) and B fragments of tiles t and t + 1
__device__ __forceinline__ void load2(unsigned* a0, unsigned* a1, uint2& b0, uint2& b1,
                                      unsigned a_addr, const int* code, const uint2* frag,
                                      int t) {
  ldmatrix_x4(a0, a_addr + 32 * (code[t] >> 1));
  ldmatrix_x4(a1, a_addr + 32 * (code[t + 1] >> 1));
  b0 = frag[32 * t];
  b1 = frag[32 * (t + 1)];
}

// ns steps from tile t: tile t + 2s into ca, t + 2s + 1 into cb (two
// accumulator chains in flight). Two register sets alternate, so each
// step's operands load while the step before it multiplies (as in the bf16
// K10).
__device__ __forceinline__ void tr_run2(float* ca, float* cb, unsigned a_addr,
                                        const int* code, const uint2* frag, int t, int ns) {
  if (ns <= 0) return;
  unsigned xa[4], xb[4], ya[4], yb[4];
  uint2 fxa, fxb, fya, fyb;
  load2(xa, xb, fxa, fxb, a_addr, code, frag, t);
  for (int s = 0; s < ns; s += 2) {
    const bool odd = s + 1 < ns;
    if (odd) load2(ya, yb, fya, fyb, a_addr, code, frag, t + 2 * s + 2);
    mma_bf16(ca, xa, fxa.x, fxa.y);
    mma_bf16(cb, xb, fxb.x, fxb.y);
    if (s + 2 < ns) load2(xa, xb, fxa, fxb, a_addr, code, frag, t + 2 * s + 4);
    if (odd) {
      mma_bf16(ca, ya, fya.x, fya.y);
      mma_bf16(cb, yb, fyb.x, fyb.y);
    }
  }
}

// c += a b where p (the same in every lane of the warp, as .aligned asks)
__device__ __forceinline__ void mma_bf16_if(float* c, const unsigned* a, uint2 b, bool p) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " @p mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n}\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y), "r"((int)p));
}

// one q's cast(dwR) `d` into the dw tile row `dwr` / stash row `str` by its
// code (weight k in bits 0-11, kind in 12-13, stash slot from bit 16; -1
// for a padding column), in step 0 (stores and stashes) or 1 (completions)
__device__ __forceinline__ void dw_update(int code, float d, __nv_bfloat16* dwr,
                                          __nv_bfloat16* str, int step) {
  const int kind = (code >> 12) & 3, k = code & 0xfff, slot = code >> 16;
  if (code < 0 || (kind == KIND_ADD) != (step == 1)) return;
  if (step == 0)
    *(kind == KIND_STORE ? dwr + k : str + slot) = __float2bfloat16(d);
  else  // (first + stash) + last
    dwr[k] = __float2bfloat16((__bfloat162float(dwr[k]) + __bfloat162float(str[slot])) + d);
}

struct BwdArgs {
  const void *x, *sh, *w, *dct;
  const void *cptr, *cboth, *cxa, *ctile, *cfrag;   // CBIG_R tiles (mma_tables)
  const void *qcol, *dwcode, *widx;                 // per column q (padded)
  const void *gks, *gptr, *gmask, *gfrag;           // CBIG_R^T tiles (mma_bwd_tables)
  const void *aslot, *cslot;                        // the ring's slots
  void *dx, *dsh_out, *dw;
  long long M;
  int din, dsh, numel, dout, npairs, ntri, ngroups, nj, nas, ncs, csplit, cap;
};

// at nj <= 8 (layer 0) the registers, not the shared memory, set the blocks
// an SM: three
template <int NJ>  // column tiles of Db a chunk, at least a.nj
__global__ void __launch_bounds__(BNT, NJ <= 8 ? 3 : 2)
    fused_tp_bwd_mma_kernel(BwdArgs a, int flags) {
  extern __shared__ __align__(16) char tile_smem[];
  char* smem = tile_smem;
  const int din = a.din, dsh = a.dsh, numel = a.numel, npairs = a.npairs;
  const BwdLayout l = bwd_layout(din, dsh, numel, a.dout, a.ntri, npairs, a.cap, a.ngroups,
                                 a.nas, a.ncs);
  const long long row0 = (long long)blockIdx.x * BR;
  const int nrows = a.M - row0 < BR ? (int)(a.M - row0) : BR;
  const int tid = threadIdx.x;
  const auto* x = static_cast<const __nv_bfloat16*>(a.x);
  const auto* sh = static_cast<const __nv_bfloat16*>(a.sh);
  const auto* dct = static_cast<const __nv_bfloat16*>(a.dct);
  const int* cptr = static_cast<const int*>(a.cptr);
  const int* ctile = static_cast<const int*>(a.ctile);
  const uint2* cfrag = static_cast<const uint2*>(a.cfrag);
  const int* qcol = static_cast<const int*>(a.qcol);
  const int* dwcode = static_cast<const int*>(a.dwcode);
  const int* widx = static_cast<const int*>(a.widx);
  const uint2* gfrag = static_cast<const uint2*>(a.gfrag);

  // x, sh, dct and the int tables (one cp.async group), slot 0's tiles (a
  // second): the tiles in flight while xcat is built
  stage_flat(smem + l.x_off, reinterpret_cast<const char*>(x + row0 * din), nrows * din * 2,
             round16(BR * din * 2), flags & 1, tid);
  stage_flat(smem + l.sh_off, reinterpret_cast<const char*>(sh + row0 * dsh),
             nrows * dsh * 2, round16(BR * dsh * 2), flags & 2, tid);
  stage_rows(smem + l.d_off, l.ds, reinterpret_cast<const char*>(dct + row0 * a.dout),
             2 * a.dout, nrows, flags & 4, tid);
  int* s_cptr = reinterpret_cast<int*>(smem + l.i_off);
  int* s_both = s_cptr + npairs + 1;
  int* s_xa = s_both + npairs;
  int* s_aslot = s_xa + npairs;
  int* s_gptr = s_aslot + a.nas + 1;
  int* s_gks = s_gptr + a.ngroups + 1;
  unsigned* s_gmask = reinterpret_cast<unsigned*>(s_gks + a.ngroups);
  int* s_cslot = reinterpret_cast<int*>(s_gmask + a.ngroups);
  const auto stage_ints = [&](int* dst, const void* src, int n) {
    for (int i = tid; i < n; i += BNT) cp_async4(dst + i, static_cast<const int*>(src) + i);
  };
  stage_ints(s_cptr, cptr, npairs + 1);
  stage_ints(s_both, a.cboth, npairs);
  stage_ints(s_xa, a.cxa, npairs);
  stage_ints(s_aslot, a.aslot, a.nas + 1);
  stage_ints(s_gptr, a.gptr, a.ngroups + 1);
  stage_ints(s_gks, a.gks, a.ngroups);
  stage_ints(reinterpret_cast<int*>(s_gmask), a.gmask, a.ngroups);
  stage_ints(s_cslot, a.cslot, a.ncs + 1);
  cp_async_commit();
  char* ring = smem + l.ring_off;
  const int* aslot = static_cast<const int*>(a.aslot);
  {
    const int t0 = __ldg(cptr), t1 = __ldg(cptr + __ldg(aslot + 1));
    load_tiles(ring, l.codes, t0, t1 - t0, ctile, cfrag, tid);
  }
  cp_async_wait<1>();
  __syncthreads();

  const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(smem + l.x_off);
  const __nv_bfloat16* ssh = reinterpret_cast<const __nv_bfloat16*>(smem + l.sh_off);
  // xcat[r][b * din + f] = cast(x[r][f] * sh[r][b]); zeros in the k padding
  {
    const int K = dsh * din, kp = l.kpad - K;
    for (int t = tid; t < BR * dsh; t += BNT) {
      const int r = t / dsh, b = t - r * dsh;
      const float s = __bfloat162float(ssh[t]);
      const __nv_bfloat16* xr = sx + r * din;
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(smem + r * l.xs) + b * din;
      for (int f = 0; f < din; ++f) d[f] = __float2bfloat16(__bfloat162float(xr[f]) * s);
    }
    for (int t = tid; t < BR * kp; t += BNT) {
      const int r = t / kp;
      reinterpret_cast<__nv_bfloat16*>(smem + r * l.xs)[K + t - r * kp] = __float2bfloat16(0.0f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int rg = warp * 16 + g;  // this lane's accumulator rows rg and rg + 8
  const unsigned a_addr = smem_addr(smem) + (warp * 16 + (lane & 15)) * l.xs + (lane >> 4) * 16;
  const auto* d0 = reinterpret_cast<const __nv_bfloat16*>(smem + l.d_off + rg * l.ds);
  const auto* d8 = reinterpret_cast<const __nv_bfloat16*>(smem + l.d_off + (rg + 8) * l.ds);
  auto* dw0 = reinterpret_cast<__nv_bfloat16*>(smem + l.w_off + rg * l.ws);
  auto* dw8 = reinterpret_cast<__nv_bfloat16*>(smem + l.w_off + (rg + 8) * l.ws);
  auto* st0 = reinterpret_cast<__nv_bfloat16*>(smem + l.s_off + rg * l.ss);
  auto* st8 = reinterpret_cast<__nv_bfloat16*>(smem + l.s_off + (rg + 8) * l.ss);
  const auto bf = [](__nv_bfloat16 v) { return __bfloat162float(v); };

  // A. TR by slot of whole pairs; pair p of column tiles (2p, 2p + 1):
  // `both` steps of the two, then `xa` more of 2p, then the rest of 2p + 1.
  // Slot sa + 1's tiles load while sa's pairs are multiplied. Then dwR and
  // dw for each pair's 16 columns.
  for (int sa = 0; sa < a.nas; ++sa) {
    const int p0 = s_aslot[sa], p1 = s_aslot[sa + 1], base = s_cptr[p0];
    if (sa + 1 < a.nas)
      load_tiles(ring + ((sa + 1) & 1) * l.slot, l.codes, s_cptr[p1],
                 s_cptr[s_aslot[sa + 2]] - s_cptr[p1], ctile, cfrag, tid);
    const char* slot = ring + (sa & 1) * l.slot;
    const uint2* frag = reinterpret_cast<const uint2*>(slot) + lane;
    const int* code = reinterpret_cast<const int*>(slot + l.codes);
    for (int p = p0; p < p1; ++p) {
      const int t0 = s_cptr[p] - base, n = s_cptr[p + 1] - s_cptr[p];
      const int q = 16 * p + 2 * t4;  // this lane's columns q, q + 1, q + 8, q + 9
      const int2 qc0 = __ldg(reinterpret_cast<const int2*>(qcol + q));
      const int2 qc8 = __ldg(reinterpret_cast<const int2*>(qcol + q + 8));
      const int2 co0 = __ldg(reinterpret_cast<const int2*>(dwcode + q));
      const int2 co8 = __ldg(reinterpret_cast<const int2*>(dwcode + q + 8));
      float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (n > 0) {
        const int nb = 2 * s_both[p], na = nb + s_xa[p];
        float e0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, e1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        tr_run2(c0, c1, a_addr, code, frag, t0, nb / 2);
        tr_run2(c0, e0, a_addr, code, frag, t0 + nb, (na - nb) / 2);
        if ((na - nb) % 2) tr_step(c0, a_addr, code, frag, t0 + na - 1);
        tr_run2(c1, e1, a_addr, code, frag, t0 + na, (n - na) / 2);
        if ((n - na) % 2) tr_step(c1, a_addr, code, frag, t0 + n - 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          c0[i] += e0[i];
          c1[i] += e1[i];
        }
      }
      // cast(dwR) of columns q, q + 1, q + 8, q + 9, rows rg then rg + 8
      const int codes[4] = {co0.x, co0.y, co8.x, co8.y};
      const float dv[8] = {
          round_bf16(bf(d0[qc0.x]) * c0[0]), round_bf16(bf(d0[qc0.y]) * c0[1]),
          round_bf16(bf(d0[qc8.x]) * c1[0]), round_bf16(bf(d0[qc8.y]) * c1[1]),
          round_bf16(bf(d8[qc0.x]) * c0[2]), round_bf16(bf(d8[qc0.y]) * c0[3]),
          round_bf16(bf(d8[qc8.x]) * c1[2]), round_bf16(bf(d8[qc8.y]) * c1[3])};
#pragma unroll
      for (int step = 0; step < 2; ++step) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dw_update(codes[i], dv[i], dw0, st0, step);
          dw_update(codes[i], dv[4 + i], dw8, st8, step);
        }
        __syncwarp();
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // slot sa + 1's tiles are in, and every warp is done with sa's
  }

  // B. the dw tile out (rows past M not stored); w into its place, and the
  // first slot of CBIG_R^T tiles into the ring
  {
    auto* dw = static_cast<__nv_bfloat16*>(a.dw);
    const char* src = smem + l.w_off;
    if (flags & 8) {  // dw 16-byte aligned, numel % 8 == 0
      const int cpr = numel / 8;
      for (int i = tid; i < nrows * cpr; i += BNT) {
        const int r = i / cpr, c = i - r * cpr;
        reinterpret_cast<uint4*>(dw + (row0 + r) * numel)[c] =
            *reinterpret_cast<const uint4*>(src + r * l.ws + 16 * c);
      }
    } else {
      for (int i = tid; i < nrows * numel; i += BNT) {
        const int r = i / numel, k = i - r * numel;
        dw[(row0 + r) * numel + k] = reinterpret_cast<const __nv_bfloat16*>(src + r * l.ws)[k];
      }
    }
  }
  __syncthreads();
  stage_rows(smem + l.w_off, l.ws,
             reinterpret_cast<const char*>(static_cast<const __nv_bfloat16*>(a.w) + row0 * numel),
             2 * numel, nrows, flags & 16, tid);
  cp_async_commit();
  if (a.ncs > 0) {
    const int t0 = s_gptr[0];
    load_tiles(ring, l.codes, t0, s_gptr[s_cslot[1]] - t0, nullptr, gfrag, tid);
  }
  cp_async_wait<0>();
  __syncthreads();

  // C. Db in two chunks of nj column tiles: slots [0, csplit) then [csplit,
  // ncs) of whole groups, each group a k step s with its nonzero tiles of
  // the chunk (the set bits of its mask, in order); the A fragment
  // cast(dct[qcol] * w[widx]) of rows rg, rg + 8 and columns 16 s + 2 t4 +
  // (0, 1, 8, 9). Each chunk is staged in f32 in the warp's xcat rows and
  // folded into dx (lane element e = lane + 32 i: row e / din, f = e % din)
  // and dsh (row e / dsh, b = e % dsh).
  const auto* w0 = reinterpret_cast<const __nv_bfloat16*>(smem + l.w_off + rg * l.ws);
  const auto* w8 = reinterpret_cast<const __nv_bfloat16*>(smem + l.w_off + (rg + 8) * l.ws);
  float dxa[MAX_DX], dsa[MAX_DS];
#pragma unroll
  for (int i = 0; i < MAX_DX; ++i) dxa[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < MAX_DS; ++i) dsa[i] = 0.0f;
  const int K = dsh * din, xsf = l.xs / 4;
  float* S = reinterpret_cast<float*>(smem + warp * 16 * l.xs);  // the warp's rows
  for (int c = 0; c < 2; ++c) {
    float acc[NJ][4];
#pragma unroll
    for (int o = 0; o < NJ; ++o) acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0.0f;
    const int s0 = c == 0 ? 0 : a.csplit, s1 = c == 0 ? a.csplit : a.ncs;
    for (int sc = s0; sc < s1; ++sc) {
      const int g0 = s_cslot[sc], g1 = s_cslot[sc + 1], base = s_gptr[g0];
      if (sc + 1 < a.ncs)
        load_tiles(ring + ((sc + 1) & 1) * l.slot, l.codes, s_gptr[g1],
                   s_gptr[s_cslot[sc + 2]] - s_gptr[g1], nullptr, gfrag, tid);
      const uint2* frag = reinterpret_cast<const uint2*>(ring + (sc & 1) * l.slot) + lane;
      for (int gi = g0; gi < g1; ++gi) {
        const int q = 16 * s_gks[gi] + 2 * t4, t0 = s_gptr[gi] - base;
        const unsigned mask = s_gmask[gi];
        const int2 qc0 = __ldg(reinterpret_cast<const int2*>(qcol + q));
        const int2 qc8 = __ldg(reinterpret_cast<const int2*>(qcol + q + 8));
        const int2 wi0 = __ldg(reinterpret_cast<const int2*>(widx + q));
        const int2 wi8 = __ldg(reinterpret_cast<const int2*>(widx + q + 8));
        unsigned af[4];
        af[0] = pack_bf16(bf(d0[qc0.x]) * bf(w0[wi0.x]), bf(d0[qc0.y]) * bf(w0[wi0.y]));
        af[1] = pack_bf16(bf(d8[qc0.x]) * bf(w8[wi0.x]), bf(d8[qc0.y]) * bf(w8[wi0.y]));
        af[2] = pack_bf16(bf(d0[qc8.x]) * bf(w0[wi8.x]), bf(d0[qc8.y]) * bf(w0[wi8.y]));
        af[3] = pack_bf16(bf(d8[qc8.x]) * bf(w8[wi8.x]), bf(d8[qc8.y]) * bf(w8[wi8.y]));
        // column tile o's fragment is the group's tile popc(mask below o)
#pragma unroll
        for (int o = 0; o < NJ; ++o) {
          const bool on = (mask >> o) & 1u;
          uint2 b = make_uint2(0u, 0u);
          if (on) b = frag[32 * (t0 + __popc(mask & ((1u << o) - 1u)))];
          mma_bf16_if(acc[o], af, b, on);
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // slot sc + 1's tiles are in, and every warp is done with sc's
    }
  // the chunk's Db, columns [c0, c1) of the row, into S at column j - c0
    float* S0 = S + g * xsf;
    float* S8 = S0 + 8 * xsf;
#pragma unroll
    for (int o = 0; o < NJ; ++o) {
      if (o < a.nj) {
        *reinterpret_cast<float2*>(S0 + 8 * o + 2 * t4) = make_float2(acc[o][0], acc[o][1]);
        *reinterpret_cast<float2*>(S8 + 8 * o + 2 * t4) = make_float2(acc[o][2], acc[o][3]);
      }
    }
    __syncwarp();
    const int c0 = 8 * a.nj * c, c1 = min(K, c0 + 8 * a.nj);
#pragma unroll
    for (int i = 0; i < MAX_DX; ++i) {
      const int e = lane + 32 * i;
      if (e < 16 * din) {
        const int r = e / din, f = e - r * din;
        const float* Sr = S + r * xsf - c0;
        const __nv_bfloat16* shr = ssh + (warp * 16 + r) * dsh;
        const int b0 = c0 > f ? (c0 - f + din - 1) / din : 0;
        const int b1 = min(dsh, (c1 - f + din - 1) / din);
#pragma unroll 4
        for (int b = b0; b < b1; ++b) dxa[i] += round_bf16(bf(shr[b]) * Sr[b * din + f]);
      }
    }
    if (a.dsh_out != nullptr) {
#pragma unroll
      for (int i = 0; i < MAX_DS; ++i) {
        const int e = lane + 32 * i;
        if (e < 16 * dsh) {
          const int r = e / dsh, b = e - r * dsh;
          const float* Sr = S + r * xsf - c0 + b * din;
          const __nv_bfloat16* xr = sx + (warp * 16 + r) * din;
          const int f0 = max(0, c0 - b * din), f1 = min(din, c1 - b * din);
#pragma unroll 4
          for (int f = f0; f < f1; ++f) dsa[i] += round_bf16(bf(xr[f]) * Sr[f]);
        }
      }
    }
    __syncwarp();  // every lane is done reading S before the next chunk's stores
  }

  const long long wrow0 = row0 + warp * 16;
  auto* dx = static_cast<__nv_bfloat16*>(a.dx);
#pragma unroll
  for (int i = 0; i < MAX_DX; ++i) {
    const int e = lane + 32 * i;
    if (e < 16 * din && wrow0 + e / din < a.M) dx[wrow0 * din + e] = __float2bfloat16(dxa[i]);
  }
  if (a.dsh_out != nullptr) {
    auto* dso = static_cast<__nv_bfloat16*>(a.dsh_out);
#pragma unroll
    for (int i = 0; i < MAX_DS; ++i) {
      const int e = lane + 32 * i;
      if (e < 16 * dsh && wrow0 + e / dsh < a.M) dso[wrow0 * dsh + e] = __float2bfloat16(dsa[i]);
    }
  }
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

template <int NJ>
int launch_mma(const BwdArgs& a, cudaStream_t stream) {
  const BwdLayout l = bwd_layout(a.din, a.dsh, a.numel, a.dout, a.ntri, a.npairs, a.cap,
                                 a.ngroups, a.nas, a.ncs);
  cudaError_t err = cudaFuncSetAttribute(fused_tp_bwd_mma_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
  if (err != cudaSuccess) return (int)err;
  const int flags = (aligned(a.x, 16) ? 1 : 0) | (aligned(a.sh, 16) ? 2 : 0) |
                    (aligned(a.dct, 16) && (2 * a.dout) % 16 == 0 ? 4 : 0) |
                    (aligned(a.dw, 16) && a.numel % 8 == 0 ? 8 : 0) |
                    (aligned(a.w, 16) && a.numel % 8 == 0 ? 16 : 0);
  const long long blocks = (a.M + BR - 1) / BR;
  fused_tp_bwd_mma_kernel<NJ><<<(unsigned)blocks, BNT, l.bytes, stream>>>(a, flags);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on CUDA cores (`fused_tp_bwd_f32_kernel<RT>`, the design note at the top)

namespace f32k {

constexpr int NW = 16;  // warps a block (kernels/tp_kernels.py BWD_WARPS)
constexpr int NT = 32 * NW;
constexpr int DSH = 9;  // sh width (l <= 2)
constexpr int G = 4;    // weights a dw unit (BWD_GROUP)

// 4 bytes global -> shared, zeros instead when !ok (src-size 0)
__device__ __forceinline__ void cp_async4z(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

struct Args {
  const float *x, *sh, *w, *dct;
  const unsigned char* blob;  // f32_bwd_tables' blob
  float *dx, *dsh_out, *dw;
  long long M;
  int din, numel, dout, bytes, db_off, q_off, kq_off, tp_off, sc_off;
};

// A block's shared memory: the blob at 0, then W (w [numel][rs], then the
// tile's dw [T][ws]), two row buffers S [din + DSH + dout][rs] (x, sh,
// dct), P [DSH][rs] (dsh), X [din][rs] (dx); the row operands
// feature-major, row r of feature f at f * rs + r
struct Layout {
  int rs, ws, w_off, s_off, s_floats, p_off, x_off, bytes;
};

__host__ __device__ inline Layout layout(int rt, int blob_bytes, int din, int numel, int dout) {
  Layout l;
  l.rs = 32 * rt + 1;  // odd: a warp's copy of one row writes 32 distinct banks
  l.ws = numel | 1;    // odd: the lanes' rows of one dw on distinct banks
  l.w_off = blob_bytes;
  const int w_floats = numel * l.rs > 32 * rt * l.ws ? numel * l.rs : 32 * rt * l.ws;
  l.s_off = l.w_off + 4 * w_floats;
  l.s_floats = (din + DSH + dout) * l.rs;
  l.p_off = l.s_off + 2 * 4 * l.s_floats;
  l.x_off = l.p_off + 4 * DSH * l.rs;
  l.bytes = l.x_off + 4 * din * l.rs;
  return l;
}

// dst[f * rs + r] = src[(e0 + r) * width + f] for the tile's 32 RT rows
// (zeros past M): a warp a row, its lanes over f (coalesced reads; rs odd
// puts the 32 writes on distinct banks), 4-byte cp.async copies
template <int RT>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int width,
                                      long long e0, long long M, int rs, int warp, int lane) {
  for (int r = warp; r < 32 * RT; r += NW) {
    const bool ok = e0 + r < M;
    const float* s = src + (ok ? (e0 + r) * width : 0);
    for (int f = lane; f < width; f += 32) cp_async4z(dst + f * rs + r, s + f, ok);
  }
}

template <int RT>
__global__ void __launch_bounds__(NT, 1) fused_tp_bwd_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T = 32 * RT;  // rows a tile; lane l owns rows l + 32 r, r < RT
  const Layout ly = layout(RT, a.bytes, a.din, a.numel, a.dout);
  const int rs = ly.rs, ws = ly.ws, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint2* etr = reinterpret_cast<const uint2*>(smem);
  const uint2* edb = reinterpret_cast<const uint2*>(smem + a.db_off);
  const unsigned* qw = reinterpret_cast<const unsigned*>(smem + a.q_off);
  const unsigned short* kq = reinterpret_cast<const unsigned short*>(smem + a.kq_off);
  const unsigned short* tp = reinterpret_cast<const unsigned short*>(smem + a.tp_off);
  const unsigned short* sc = reinterpret_cast<const unsigned short*>(smem + a.sc_off);
  float* sw = reinterpret_cast<float*>(smem + ly.w_off);
  float* ss = reinterpret_cast<float*>(smem + ly.s_off);
  float* sp = reinterpret_cast<float*>(smem + ly.p_off);
  float* sdx = reinterpret_cast<float*>(smem + ly.x_off);
  const int din = a.din, numel = a.numel, dout = a.dout;
  const long long M = a.M, ntiles = (M + T - 1) / T;

  // the tables, once (visible after the loop's first barrier)
  for (int i = tid; i < a.bytes / 16; i += NT)
    reinterpret_cast<int4*>(smem)[i] = __ldg(reinterpret_cast<const int4*>(a.blob) + i);
  // row tiles by cp.async, one group each: S of a tile, W of a tile
  auto stage_s = [&](float* S, long long tile) {
    if (tile < ntiles) {
      const long long e0 = tile * T;
      stage<RT>(S, a.x, din, e0, M, rs, warp, lane);
      stage<RT>(S + din * rs, a.sh, DSH, e0, M, rs, warp, lane);
      stage<RT>(S + (din + DSH) * rs, a.dct, dout, e0, M, rs, warp, lane);
    }
    cp_async_commit();
  };
  auto stage_w = [&](long long tile) {
    if (tile < ntiles) stage<RT>(sw, a.w, numel, tile * T, M, rs, warp, lane);
    cp_async_commit();
  };
  // groups in flight at the top of tile i: S of i, W of i, S of i + 1
  stage_s(ss, blockIdx.x);
  stage_w(blockIdx.x);
  stage_s(ss + ly.s_floats, (long long)blockIdx.x + gridDim.x);

  const int a0 = sc[warp], a1 = sc[warp + 1];                // this warp's dw units
  const int b0 = sc[NW + 1 + warp], b1 = sc[NW + 2 + warp];  // its Db units
  int it = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    float* S = ss + (it & 1) * ly.s_floats;
    const float* sx = S + lane;
    const float* ssh = S + din * rs + lane;
    const float* sd = S + (din + DSH) * rs + lane;
    const long long e0 = tile * T;
    cp_async_wait<1>();  // this tile's x, sh, dct and w
    __syncthreads();

    // Db[j] = sum over CBIG_R row j's nonzeros (q ascending) of coef *
    // (dct[qcol q] * w[widx q]); a unit is a feature f, its rows j = b din +
    // f in ascending b: dx[f] = sum_b sh[b] Db[j] (b ascending, each
    // product rounded), and this warp's part of dsh[b], the sum of x[f]
    // Db[j] over its f (ascending)
    float dsp[DSH][RT];
#pragma unroll
    for (int b = 0; b < DSH; ++b)
#pragma unroll
      for (int r = 0; r < RT; ++r) dsp[b][r] = 0.0f;
    const float* swl = sw + lane;
    for (int u = b0; u < b1; ++u) {
      const int f = sc[u];
      float xf[RT], dxa[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        xf[r] = sx[f * rs + 32 * r];
        dxa[r] = 0.0f;
      }
#pragma unroll
      for (int b = 0; b < DSH; ++b) {
        const int j = b * din + f;
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
        int t = tp[j];
        const int t1 = tp[j + 1];
        uint2 e = edb[t];  // each entry loads one step ahead of its use
#pragma unroll 2
        for (; t < t1; ++t) {
          const uint2 cur = e;
          if (t + 1 < t1) e = edb[t + 1];
          const float cf = __uint_as_float(cur.y);
          const float* dp = sd + (cur.x & 0xffff) * rs;
          const float* wp = swl + (cur.x >> 16) * rs;
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r] = fmaf(cf, dp[32 * r] * wp[32 * r], acc[r]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          dxa[r] += __fmul_rn(ssh[b * rs + 32 * r], acc[r]);
          dsp[b][r] += __fmul_rn(xf[r], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) sdx[f * rs + lane + 32 * r] = dxa[r];
    }
    __syncthreads();  // w is read: W takes the tile's dw

    // dw[k] = sum over the positions t of weight k (q ascending) of dct[qcol
    // q] * TR[q] (each product rounded), TR[q] = sum over q's nonzeros
    // (rptr's order) of coef * (x[rf] * sh[rb]); a unit is BWD_GROUP
    // weights from k0, written to W as rows (row r of dw at r * ws)
    for (int u = a0; u < a1; ++u) {
      const int k0 = sc[u];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (k0 + g >= numel) continue;
        float dwv[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) dwv[r] = 0.0f;
        for (int t = kq[k0 + g], t1 = kq[k0 + g + 1]; t < t1; ++t) {
          const unsigned w0 = qw[t];
          const int z1 = qw[t + 1] & 0xffff;
          float tr[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) tr[r] = 0.0f;
          int z = w0 & 0xffff;
          uint2 e = etr[z];
#pragma unroll 2
          for (; z < z1; ++z) {
            const uint2 cur = e;
            if (z + 1 < z1) e = etr[z + 1];
            const float cf = __uint_as_float(cur.y);
            const float* xp = sx + (cur.x & 0xffff) * rs;
            const float* hp = ssh + (cur.x >> 16) * rs;
#pragma unroll
            for (int r = 0; r < RT; ++r) tr[r] = fmaf(cf, xp[32 * r] * hp[32 * r], tr[r]);
          }
          const float* dp = sd + (w0 >> 16) * rs;
#pragma unroll
          for (int r = 0; r < RT; ++r) dwv[r] += __fmul_rn(dp[32 * r], tr[r]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) sw[(lane + 32 * r) * ws + k0 + g] = dwv[r];
      }
    }
    // dsh: the warps' parts added in warp order (fixed, no atomics)
    if (a.dsh_out != nullptr) {
      for (int w = 0; w < NW; ++w) {
        __syncthreads();
        if (warp == w) {
#pragma unroll
          for (int b = 0; b < DSH; ++b)
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              float* p = sp + b * rs + lane + 32 * r;
              *p = w == 0 ? dsp[b][r] : *p + dsp[b][r];
            }
        }
      }
    }
    __syncthreads();  // dw, dx and dsh are whole in shared memory
    // every output leaves row by row, coalesced
    for (int r = warp; r < T; r += NW) {
      if (e0 + r >= M) break;
      float* o = a.dw + (e0 + r) * numel;
      for (int k = lane; k < numel; k += 32) o[k] = sw[r * ws + k];
      for (int f = lane; f < din; f += 32) a.dx[(e0 + r) * din + f] = sdx[f * rs + r];
      if (a.dsh_out != nullptr && lane < DSH)
        a.dsh_out[(e0 + r) * DSH + lane] = sp[lane * rs + r];
    }
    __syncthreads();  // W, S, P and X are read
    stage_w(tile + gridDim.x);
    stage_s(S, tile + 2LL * gridDim.x);
  }
  cp_async_wait<0>();
}

inline int device_attr(cudaDeviceAttr what) {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, what, dev);
  return n;
}

template <int RT>
int launch(const Args& a, int bytes, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_tp_bwd_f32_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (a.M + 32 * RT - 1) / (32 * RT);
  const long long sms = std::max(device_attr(cudaDevAttrMultiProcessorCount), 1);
  fused_tp_bwd_f32_kernel<RT><<<(unsigned)std::min(tiles, sms), NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace f32k

}  // namespace

extern "C" {

// x [M, din], sh [M, dsh], w [M, numel], dct [M, dout] -> dx [M, din],
// dsh [M, dsh] (not written when dsh_out is null), dw [M, numel]. f32 on CUDA
// cores (dsh 9) from the blob of kernels/tp_kernels.py `f32_bwd_tables`
// (`bytes` long, a multiple of 16; its tables at the byte offsets given):
// 64 rows a tile where the shared memory takes them, else 32
int fused_tp_bwd_f32(const void* x, const void* sh, const void* w, const void* dct,
                     const void* blob, void* dx, void* dsh_out, void* dw, long long M,
                     int din, int dsh, int numel, int dout, int bytes, int db_off, int q_off,
                     int kq_off, int tp_off, int sc_off, void* stream) {
  if (M <= 0 || din <= 0 || dsh != f32k::DSH || numel <= 0 || dout <= 0 || bytes <= 0 ||
      bytes % 16 != 0 || !aligned(blob, 16))
    return (int)cudaErrorInvalidValue;
  const f32k::Args a{static_cast<const float*>(x), static_cast<const float*>(sh),
                     static_cast<const float*>(w), static_cast<const float*>(dct),
                     static_cast<const unsigned char*>(blob), static_cast<float*>(dx),
                     static_cast<float*>(dsh_out), static_cast<float*>(dw), M, din, numel,
                     dout, bytes, db_off, q_off, kq_off, tp_off, sc_off};
  const int cap = f32k::device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int two = f32k::layout(2, bytes, din, numel, dout).bytes;
  if (two <= cap) return f32k::launch<2>(a, two, st);
  const int one = f32k::layout(1, bytes, din, numel, dout).bytes;
  if (one <= cap) return f32k::launch<1>(a, one, st);
  return (int)cudaErrorInvalidValue;
}

// bf16 on the tensor cores (numel < 4096, din <= 48, dsh <= 16, dsh * din
// <= 384): the CBIG_R tiles of kernels/tp_kernels.py `mma_tables` (cptr,
// cboth, cxa [npairs], ctile, cfrag; widx padded to 16 * npairs columns)
// and the tables of `mma_bwd_tables`: per column q its output column (qcol)
// and dw code (dwcode), CBIG_R^T's nonzero k16 x n8 tiles by group (gptr
// [ngroups + 1]; gks, a group's k step; gmask, its column tiles within the
// chunk as bits; gfrag), nj column tiles a chunk, ntri weights with
// three q's, the ring's slots of at most cap tiles (aslot [nas + 1]: runs
// of pairs; cslot [ncs + 1]: runs of groups, the first csplit chunk 0's)
int fused_tp_bwd_bf16(const void* x, const void* sh, const void* w, const void* dct,
                      const void* cptr, const void* cboth, const void* cxa, const void* ctile,
                      const void* cfrag, const void* qcol, const void* dwcode,
                      const void* widx, const void* gks, const void* gptr, const void* gmask,
                      const void* gfrag, const void* aslot, const void* cslot, void* dx,
                      void* dsh_out, void* dw, long long M,
                      int din, int dsh, int numel, int dout, int npairs, int ntri,
                      int ngroups, int nj, int nas, int ncs, int csplit, int cap,
                      void* stream) {
  if (M <= 0 || din <= 0 || dsh <= 0 || numel <= 0 || dout <= 0 || npairs <= 0 ||
      ngroups < 0 || nas <= 0 || ncs < 0 || csplit < 0 || csplit > ncs || cap <= 0 ||
      numel >= 4096 || 16 * din > 32 * MAX_DX || 16 * dsh > 32 * MAX_DS ||
      nj != (dsh * din + 15) / 16)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{x, sh, w, dct, cptr, cboth, cxa, ctile, cfrag, qcol, dwcode, widx, gks,
                  gptr, gmask, gfrag, aslot, cslot, dx, dsh_out, dw, M, din, dsh,
                  numel, dout, npairs, ntri, ngroups, nj, nas, ncs, csplit, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nj <= 8) return launch_mma<8>(a, st);
  if (nj <= 16) return launch_mma<16>(a, st);
  if (nj <= 24) return launch_mma<24>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
