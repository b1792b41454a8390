// Fused tensor product (K10) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel of codlad_tpu/kernels/tp_kernels.py:
//   K10 fused_tp_* <- _tp_fwd_kernel / _pallas_fused_tp
//
// Per row (an edge, or an atom slot of the dense cross graph):
//   xcat[b*din + f] = cast(x[f] * sh[b])                         (b < dsh)
//   TR[r]  = sum over CBIG_R column r's nonzeros of coef * xcat[row]   (f32)
//   out[c] = cast(sum over the r of output column c of cast(w[widx[r]] * TR[r]))
// which is TR = xcat CBIG_R, wR = w EXPW, out = (wR * TR) SUMR with the
// Pallas kernel's rounding: CBIG_R's coefficients and x * sh[b] in the
// payload dtype (the wrapper rounds the coefficients), TR and wR in f32, their
// product cast to the payload dtype, the output summed in f32 and cast.
//
// Bound: each row reads din + dsh + numel and writes dout elements; the w
// rows are most of the bytes (at the Stage-1 bench shape, 4 x 65536 directed
// atom edges, layer 2: din 36, numel 384, dout 48, R 672, 250 MB in bf16,
// ~75 us at 3.35 TB/s), so memory sets the bound. The work is 2.1 MFLOP of
// nonzero k16 x n8 tiles a 16-row slab at layer 2 (34.6 GFLOP, ~35 us on
// the bf16 tensor cores). chip_smoke.py computes the bound from the run.
//
// f32 (`fused_tp_f32_kernel<RT>`): CUDA cores. The arithmetic is small (at
// layer 2 a row takes 4032 FMAs for TR and 672 products and sums: 2.55
// GFLOP at the bench shape, 0.038 ms at 67 TFLOP/s), under the bytes, so
// the tensor cores would buy nothing; what bounds a CUDA-core form is the
// shared-memory pipe. The TPU keeps the three dense tables resident per
// block; at layer 2 CBIG_R alone is 324 x 672 (871 KB in f32), more than a
// Hopper block's shared memory. EXPW and SUMR are 0/1 selections (one
// nonzero per column of EXPW and per row of SUMR), and CBIG_R holds 1-15
// nonzeros a column, so the kernel walks lists (kernels/tp_kernels.py
// `f32_fwd_tables`). It replaced a design bound by latency (32 rows a
// block of 8 warps, one row a lane, every nonzero a chain of dependent
// table loads through an L1 that the shared memory left small, the rows
// staged before any product: 2.16 ms at layer 2). Here:
//   * Tables staged once: a persistent grid, one block of 16 warps an SM,
//     copies its signature's blob into shared memory at the start: each
//     nonzero of CBIG_R as a 64-bit word in output-column order (column c,
//     its positions q in cptr's order, each q's nonzeros in rptr's order,
//     so a column's nonzeros are one run), the index field low (rf | rb <<
//     16, which the copy turns into the offsets of x[rf] and sh[rb] in the
//     staged rows), the f32 coefficient high; a 32-bit word a q (its first
//     nonzero | its weight widx[q] << 16); the 16-bit column pointers; the
//     warps' lists of output columns, balanced by entries. 35,232 bytes at
//     layer 2. Every table read in the loop is a warp-uniform shared load
//     (a broadcast), each word loaded one step ahead of its use.
//   * Rows by cp.async: a tile of T = 32 RT rows, lane l owns rows l + 32 r
//     (r < RT), so each table word serves RT rows and a lane runs RT
//     independent chains. x and sh (S, two buffers) and w (W) are staged
//     feature-major, f * rs + r with rs = T + 1 odd, by 4-byte copies
//     (zeros past M), so a warp's copy of one row and the lanes' reads of
//     one feature both fall on 32 distinct banks. The next tile's S loads
//     while this tile is computed, its w after this tile's products (a
//     second W buffer, where it fits, measured no faster).
//   * Each warp walks the run of each of its output columns c: TR[q] = an
//     fmaf chain over q's nonzeros of coef * cast(x[rf] * sh[rb]) (the
//     product formed from the staged rows, as the Pallas kernel rounds
//     xcat), and at q's last nonzero acc += cast(w[widx q] * TR[q]), the
//     product rounded alone (__fmul_rn, never contracted into the sum: the
//     Pallas kernel materialises prod before its SUMR matmul), the sum in
//     f32. The outputs go to shared memory [T][dout | 1] and leave row by
//     row in coalesced stores (rows past M are not stored).
//   The orders are the old kernel's (column by column, q in cptr's order,
//   each q's nonzeros in rptr's order), so the outputs differ from its only
//   where it contracted acc += w * TR into an FMA.
// A first form of this design built xcat = cast(x * sh) in shared memory
// once a tile (one operand read a nonzero) at one row a lane, the only
// tile that xcat and two W buffers leave room for at layer 2: 1.08 ms
// there, against 0.72 for two rows a lane with the products formed a
// nonzero (scripts/tp_fwd_probe.py, PERF.md). A walk four nonzeros a step
// (the words and operands of a step loaded before its products) was
// slower than one a step (0.76 against 0.66 ms).
// Shared memory: RT 2 where it fits, else RT 1. Layers 0, 1 and 2: RT 2,
// 73,192, 122,088 and 171,016 bytes (at layer 2 the blob 35,232, W 99,840,
// S 2 x 11,700, out 12,544); the 3 -> 3 signature of a fourth encoder
// layer: RT 1, 138,344 bytes. Bound at layer 2 (4 x
// 65536 rows): the bytes, x, sh, w read and out written once, 500 MB,
// 0.149 ms at 3.35 TB/s; the shared-memory pipe, five wavefronts a
// nonzero (its word, x and sh of two rows) and three a q for each 64
// rows, ~91 M, ~0.39 ms at one a clock an SM on 132 SMs. PERF.md has the
// measured times.
//
// bf16: the Pallas kernel's three products on the tensor cores,
// block-sparse (`fused_tp_mma_kernel`). The CUDA-core design that the f32
// kernel replaced (above) ran bf16 at f32 speed, two 97 KB blocks an SM,
// each of CBIG_R's nonzeros a chain of dependent loads. Here:
//   1. TR = xcat CBIG_R with mma.m16n8k16 (bf16 in, f32 sums). A block of 4
//      warps owns 64 rows, a warp 16. xcat is built in shared memory from
//      the staged x and sh (never read from device memory). CBIG_R, in
//      `sparse_tables`' output-column order, is cut into k16 x n8 tiles and
//      only the nonzero ones (26-36% of them) are multiplied: the host packs
//      them once per signature in B-fragment order (a lane's 8 bytes at
//      tile * 32 + lane), by pair p of column tiles (2p, 2p + 1): first
//      steps of one tile of each, then the longer one's rest, so that two
//      accumulator chains are always in flight and no product branches.
//      Read by every warp through L1 (which the shared memory leaves
//      small), the 132 KB table of layer 2 would be read once a 16-row
//      slab, 2.2 GB from L2 at the bench shape; so the block's 4 warps
//      share it through a ring of two slots in shared memory, pair p + 1's
//      tiles loading (cp.async) while pair p's are multiplied.
//   2. wR = w EXPW is the gather w[widx[r]] from the staged w tile, in the
//      epilogue of each pair of column tiles; prod = cast(wR * TR).
//   3. out = prod SUMR with a second mma: the accumulators of two adjacent
//      n8 tiles of TR are, rounded to bf16, the A fragment of one k16 step,
//      with no trip through shared memory. SUMR in column order is nearly
//      block diagonal, so each k16 step meets one or two of its packed n8
//      tiles (snptr, stile); out is summed in f32 in registers and cast once.
//   4. Staging: x, sh and w go to shared memory by cp.async (16-byte chunks
//      where a base pointer is 16-byte aligned, 2-byte copies otherwise);
//      xcat is built while w is in flight. Rows past M are zero-filled and
//      not stored. The block takes 109 KB at layer 2, so two blocks an SM:
//      one block's loads overlap the other's products.
// What bounds it in practice is not the bytes or the tensor cores but the
// shared-memory pipe and latency: every product reads its A tile by
// ldmatrix (512 B a warp), its fragment and its code, and each pair ends in
// a block-wide wait. Reading each A tile once for all the column tiles that
// use it (k tiles outside, column tiles inside) is the next step; PERF.md
// has the measured times.

#include <algorithm>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// bf16 on the tensor cores

constexpr int MW = 4;          // warps a block
constexpr int MR = 16 * MW;    // rows a block, 16 a warp (the mma's m)
constexpr int MNT = 32 * MW;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

struct Layout {       // a block's shared memory, in bytes
  int kpad;           // dsh * din rounded up to the mma's k
  int xs, ws;         // row strides of xcat [MR][kpad] and w [MR][numel]
  int slot, codes;    // bytes of a ring slot (one pair's packed tiles); its codes' offset
  int w_off, x_off, sh_off, ring_off, i_off, bytes;
};

// xcat, w, the raw x and sh tiles, a ring of two slots each holding one
// pair's packed CBIG_R tiles (fragments, then codes), then the int tables:
// the pairs' tile starts [npairs + 1], alternating steps [npairs] and
// extra tiles of column tile 2p [npairs], and their SUMR tile starts
// [npairs + 1]
__host__ __device__ inline Layout layout(int din, int dsh, int numel, int npairs,
                                         int maxpair) {
  Layout l;
  l.kpad = round16(dsh * din);
  // (stride / 4) % 8 == 4: the 8 rows of an ldmatrix phase, and of a w
  // gather, start in distinct 4-bank groups
  l.xs = 2 * l.kpad + 16;
  l.ws = round16(2 * numel) + 16;
  l.codes = 256 * maxpair;
  l.slot = l.codes + round16(4 * maxpair);
  l.w_off = MR * l.xs;
  l.x_off = l.w_off + MR * l.ws;
  l.sh_off = l.x_off + round16(MR * din * 2);
  l.ring_off = l.sh_off + round16(MR * dsh * 2);
  l.i_off = l.ring_off + 2 * l.slot;
  l.bytes = l.i_off + 4 * (4 * npairs + 2);
  return l;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bytes [0, valid) of src to dst and zeros up to `total` (a multiple of 16)
__device__ __forceinline__ void stage_flat(char* dst, const char* src, int valid, int total,
                                           bool a16, int tid) {
  const int full = a16 ? valid / 16 : 0;
  for (int i = tid; i < full; i += MNT) cp_async16(dst + 16 * i, src + 16 * i);
  const unsigned short* s2 = reinterpret_cast<const unsigned short*>(src);
  unsigned short* d2 = reinterpret_cast<unsigned short*>(dst);
  for (int i = 8 * full + tid; i < total / 2; i += MNT) d2[i] = 2 * i < valid ? s2[i] : 0;
}

// MR rows of rb bytes from contiguous src to dst at row stride ds: rows
// [0, nrows) copied, the others zero
__device__ __forceinline__ void stage_rows(char* dst, int ds, const char* src, int rb,
                                           int nrows, bool a16, int tid) {
  if (a16) {  // src 16-byte aligned, rb % 16 == 0
    const int cpr = rb / 16;
    for (int i = tid; i < MR * cpr; i += MNT) {
      const int r = i / cpr;
      char* d = dst + r * ds + 16 * (i - r * cpr);
      if (r < nrows) cp_async16(d, src + 16 * i);
      else *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
    }
  } else {
    const int epr = rb / 2;
    const unsigned short* s2 = reinterpret_cast<const unsigned short*>(src);
    for (int i = tid; i < MR * epr; i += MNT) {
      const int r = i / epr;
      reinterpret_cast<unsigned short*>(dst + r * ds)[i - r * epr] = r < nrows ? s2[i] : 0;
    }
  }
}

// not volatile: the compiler may issue it ahead of earlier products (xcat
// does not change while they run)
__device__ __forceinline__ void ldmatrix_x4(unsigned* a, unsigned addr) {
  asm("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a, uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// cast(lo), cast(hi) in one register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* out, long long r, int c, float v0,
                                           float v1, long long M, int dout, bool pairs) {
  if (r >= M) return;
  __nv_bfloat16* o = out + r * dout + c;
  if (pairs && c + 1 < dout) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < dout) o[0] = __float2bfloat16(v0);
    if (c + 1 < dout) o[1] = __float2bfloat16(v1);
  }
}

// out[o] += a * the SUMR tile `frag` if it is output tile o (static
// indices keep the accumulators in registers)
template <int NO>
__device__ __forceinline__ void sumr_mma(float (&acc)[NO][4], const unsigned* a, int ot,
                                         uint2 frag) {
#pragma unroll
  for (int o = 0; o < NO; ++o)
    if (o == ot) mma_bf16(acc[o], a, frag);
}

// n packed CBIG_R tiles from tile t0 into a ring slot (fragments, then
// codes), as one cp.async group
__device__ __forceinline__ void load_tiles(char* slot, int codes, int t0, int n,
                                           const int* __restrict__ ctile,
                                           const uint2* __restrict__ cfrag, int tid) {
  const char* src = reinterpret_cast<const char*>(cfrag + 32 * t0);
  for (int i = tid; i < 16 * n; i += MNT) cp_async16(slot + 16 * i, src + 16 * i);
  for (int i = tid; i < n; i += MNT) cp_async4(slot + codes + 4 * i, ctile + t0 + i);
  cp_async_commit();
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

// ns steps from tile t: tile t + 2s into ca, t + 2s + 1 into cb. Two
// register sets alternate, so each step's operands load while the step
// before it multiplies (a product never waits on its own loads).
__device__ __forceinline__ void run2(float* ca, float* cb, unsigned a_addr, const int* code,
                                     const uint2* frag, int t, int ns) {
  if (ns <= 0) return;
  unsigned xa[4], xb[4], ya[4], yb[4];
  uint2 fxa, fxb, fya, fyb;
  load2(xa, xb, fxa, fxb, a_addr, code, frag, t);
  for (int s = 0; s < ns; s += 2) {
    const bool odd = s + 1 < ns;
    if (odd) load2(ya, yb, fya, fyb, a_addr, code, frag, t + 2 * s + 2);
    mma_bf16(ca, xa, fxa);
    mma_bf16(cb, xb, fxb);
    if (s + 2 < ns) load2(xa, xb, fxa, fxb, a_addr, code, frag, t + 2 * s + 4);
    if (odd) {
      mma_bf16(ca, ya, fya);
      mma_bf16(cb, yb, fyb);
    }
  }
}

// c += the product of tile t alone
__device__ __forceinline__ void run1(float* c, unsigned a_addr, const int* code,
                                     const uint2* frag, int t) {
  unsigned a[4];
  ldmatrix_x4(a, a_addr + 32 * (code[t] >> 1));
  mma_bf16(c, a, frag[32 * t]);
}

// one k16 step's (a pair of column tiles') epilogue operands, loaded when
// the pair starts so that their latency hides behind its products
struct Pair {
  int s0, s1;       // its SUMR tiles
  int ot0, ot1;     // the first two's output tiles (-1: none)
  uint2 sb0, sb1;   // and their fragments
  int q0, q1, q8, q9;  // weights of this lane's columns 16p + 2 t4 + (0, 1, 8, 9)
};

__device__ __forceinline__ Pair load_pair(int p, const int* s_snptr,
                                          const int* __restrict__ widx,
                                          const int* __restrict__ stile,
                                          const uint2* __restrict__ sfrag, int lane) {
  Pair q;
  q.s0 = s_snptr[p];
  q.s1 = s_snptr[p + 1];
  q.ot0 = q.s0 < q.s1 ? __ldg(stile + q.s0) : -1;
  q.ot1 = q.s0 + 1 < q.s1 ? __ldg(stile + q.s0 + 1) : -1;
  q.sb0 = q.s0 < q.s1 ? __ldg(sfrag + 32 * q.s0 + lane) : make_uint2(0u, 0u);
  q.sb1 = q.s0 + 1 < q.s1 ? __ldg(sfrag + 32 * q.s0 + 32 + lane) : make_uint2(0u, 0u);
  const int col = 16 * p + 2 * (lane & 3);
  const int2 lo = __ldg(reinterpret_cast<const int2*>(widx + col));
  const int2 hi = __ldg(reinterpret_cast<const int2*>(widx + col + 8));
  q.q0 = lo.x;
  q.q1 = lo.y;
  q.q8 = hi.x;
  q.q9 = hi.y;
  return q;
}

// prod = cast(w[widx[r]] * TR[r]) for the pair's columns 16p + 2 t4 + (0, 1)
// (c0) and + 8 (c1), rows g and g + 8, in the A fragment order of a k16
// step; then out += prod SUMR over the step's nonzero n8 tiles
template <int NO>
__device__ __forceinline__ void pair_epilogue(float (&acc)[NO][4], const float* c0,
                                              const float* c1, const Pair& q,
                                              const __nv_bfloat16* w0, const __nv_bfloat16* w8,
                                              const int* __restrict__ stile,
                                              const uint2* __restrict__ sfrag, int lane) {
  const auto wf = [](__nv_bfloat16 v) { return __bfloat162float(v); };
  unsigned a[4];
  a[0] = pack_bf16(wf(w0[q.q0]) * c0[0], wf(w0[q.q1]) * c0[1]);
  a[1] = pack_bf16(wf(w8[q.q0]) * c0[2], wf(w8[q.q1]) * c0[3]);
  a[2] = pack_bf16(wf(w0[q.q8]) * c1[0], wf(w0[q.q9]) * c1[1]);
  a[3] = pack_bf16(wf(w8[q.q8]) * c1[2], wf(w8[q.q9]) * c1[3]);
  sumr_mma<NO>(acc, a, q.ot0, q.sb0);
  sumr_mma<NO>(acc, a, q.ot1, q.sb1);
  for (int jj = q.s0 + 2; jj < q.s1; ++jj)
    sumr_mma<NO>(acc, a, __ldg(stile + jj), __ldg(sfrag + 32 * jj + lane));
}

// NO: output n8 tiles (dout <= 8 * NO), the out accumulators in registers
template <int NO>
__global__ void __launch_bounds__(MNT)
fused_tp_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ sh,
                    const __nv_bfloat16* __restrict__ w, const int* __restrict__ cptr,
                    const int* __restrict__ cboth, const int* __restrict__ cxa,
                    const int* __restrict__ ctile, const uint2* __restrict__ cfrag,
                    const int* __restrict__ snptr, const int* __restrict__ stile,
                    const uint2* __restrict__ sfrag, const int* __restrict__ widx,
                    __nv_bfloat16* __restrict__ out, long long M, int din, int dsh, int numel,
                    int dout, int npairs, int maxpair, int flags) {
  extern __shared__ __align__(16) char tile_smem[];
  char* smem = tile_smem;
  const Layout l = layout(din, dsh, numel, npairs, maxpair);
  const long long row0 = (long long)blockIdx.x * MR;
  const int nrows = M - row0 < MR ? (int)(M - row0) : MR;
  const int tid = threadIdx.x;

  // x, sh and the int tables (one cp.async group), w (a second), pair 0's
  // tiles (a third): w and the tiles in flight while xcat is built
  stage_flat(smem + l.x_off, reinterpret_cast<const char*>(x + row0 * din), nrows * din * 2,
             round16(MR * din * 2), flags & 1, tid);
  stage_flat(smem + l.sh_off, reinterpret_cast<const char*>(sh + row0 * dsh),
             nrows * dsh * 2, round16(MR * dsh * 2), flags & 2, tid);
  int* s_cptr = reinterpret_cast<int*>(smem + l.i_off);
  int* s_both = s_cptr + npairs + 1;
  int* s_xa = s_both + npairs;
  int* s_snptr = s_xa + npairs;
  for (int i = tid; i <= npairs; i += MNT) {
    cp_async4(s_cptr + i, cptr + i);
    cp_async4(s_snptr + i, snptr + i);
    if (i < npairs) {
      cp_async4(s_both + i, cboth + i);
      cp_async4(s_xa + i, cxa + i);
    }
  }
  cp_async_commit();
  stage_rows(smem + l.w_off, l.ws, reinterpret_cast<const char*>(w + row0 * numel),
             2 * numel, nrows, flags & 4, tid);
  cp_async_commit();
  char* ring = smem + l.ring_off;
  {
    const int t0 = __ldg(cptr);
    load_tiles(ring, l.codes, t0, __ldg(cptr + 1) - t0, ctile, cfrag, tid);
  }
  cp_async_wait<2>();
  __syncthreads();

  // xcat[r][b * din + f] = cast(x[r][f] * sh[r][b]); zeros in the k padding
  {
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(smem + l.x_off);
    const __nv_bfloat16* ssh = reinterpret_cast<const __nv_bfloat16*>(smem + l.sh_off);
    for (int t = tid; t < MR * dsh; t += MNT) {
      const int r = t / dsh, b = t - r * dsh;
      const float s = __bfloat162float(ssh[t]);
      const __nv_bfloat16* xr = sx + r * din;
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(smem + r * l.xs) + b * din;
      if (din % 2 == 0) {  // pairs: 4-byte aligned, as din * 2 and the strides are
        const __nv_bfloat162* xr2 = reinterpret_cast<const __nv_bfloat162*>(xr);
        __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(d);
        for (int f = 0; f < din / 2; ++f) {
          const float2 v = __bfloat1622float2(xr2[f]);
          d2[f] = __floats2bfloat162_rn(v.x * s, v.y * s);
        }
      } else {
        for (int f = 0; f < din; ++f) d[f] = __float2bfloat16(__bfloat162float(xr[f]) * s);
      }
    }
    const int K = dsh * din, kp = l.kpad - K;
    for (int t = tid; t < MR * kp; t += MNT) {
      const int r = t / kp;
      reinterpret_cast<__nv_bfloat16*>(smem + r * l.xs)[K + t - r * kp] = __float2bfloat16(0.0f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  // ldmatrix.x4 of a 16 x 16 A tile: lanes 0-15 give rows 0-15 at k 0, lanes
  // 16-31 the same rows at k 8
  const unsigned a_addr = smem_addr(smem) + (warp * 16 + (lane & 15)) * l.xs + (lane >> 4) * 16;
  // the w rows of this lane's accumulator rows g and g + 8
  const __nv_bfloat16* w0 =
      reinterpret_cast<const __nv_bfloat16*>(smem + l.w_off + (warp * 16 + g) * l.ws);
  const __nv_bfloat16* w8 =
      reinterpret_cast<const __nv_bfloat16*>(smem + l.w_off + (warp * 16 + g + 8) * l.ws);
  float acc[NO][4];
#pragma unroll
  for (int o = 0; o < NO; ++o) acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0.0f;

  // Pair p's tiles: `both` steps of (column tile 2p, 2p + 1), then `xa`
  // more of 2p, then the rest of 2p + 1; every run feeds two accumulator
  // chains. The block's warps share the ring: pair p + 1's tiles load while
  // pair p is multiplied, and the table is read from L2 once a block.
  for (int p = 0; p < npairs; ++p) {
    const int t0 = s_cptr[p], n = s_cptr[p + 1] - t0;
    if (p + 1 < npairs)
      load_tiles(ring + ((p + 1) & 1) * l.slot, l.codes, s_cptr[p + 1],
                 s_cptr[p + 2] - s_cptr[p + 1], ctile, cfrag, tid);
    if (n > 0) {  // a pair without tiles adds nothing
      const Pair q = load_pair(p, s_snptr, widx, stile, sfrag, lane);
      const char* slot = ring + (p & 1) * l.slot;
      const uint2* frag = reinterpret_cast<const uint2*>(slot) + lane;
      const int* code = reinterpret_cast<const int*>(slot + l.codes);
      const int nb = 2 * s_both[p], na = nb + s_xa[p];
      // TR of column tiles 2p (c0, e0) and 2p + 1 (c1, e1)
      float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float e0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, e1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      run2(c0, c1, a_addr, code, frag, 0, nb / 2);
      run2(c0, e0, a_addr, code, frag, nb, (na - nb) / 2);
      if ((na - nb) % 2) run1(c0, a_addr, code, frag, na - 1);
      run2(c1, e1, a_addr, code, frag, na, (n - na) / 2);
      if ((n - na) % 2) run1(c1, a_addr, code, frag, n - 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c0[i] += e0[i];
        c1[i] += e1[i];
      }
      pair_epilogue<NO>(acc, c0, c1, q, w0, w8, stile, sfrag, lane);
    }
    cp_async_wait<0>();
    __syncthreads();  // pair p + 1's tiles are in, and every warp is done with p's
  }

  const long long r = row0 + warp * 16 + g;
  const bool pairs = flags & 8;
#pragma unroll
  for (int o = 0; o < NO; ++o) {
    const int c = 8 * o + 2 * t4;
    store_pair(out, r, c, acc[o][0], acc[o][1], M, dout, pairs);
    store_pair(out, r + 8, c, acc[o][2], acc[o][3], M, dout, pairs);
  }
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

struct MmaArgs {
  const void *x, *sh, *w, *cptr, *cboth, *cxa, *ctile, *cfrag, *snptr, *stile, *sfrag, *widx;
  void* out;
  long long M;
  int din, dsh, numel, dout, npairs, maxpair;
};

template <int NO>
int launch_mma(const MmaArgs& a, cudaStream_t stream) {
  const Layout l = layout(a.din, a.dsh, a.numel, a.npairs, a.maxpair);
  cudaError_t err = cudaFuncSetAttribute(fused_tp_mma_kernel<NO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
  if (err != cudaSuccess) return (int)err;
  const int flags = (aligned(a.x, 16) ? 1 : 0) | (aligned(a.sh, 16) ? 2 : 0) |
                    (aligned(a.w, 16) && (2 * a.numel) % 16 == 0 ? 4 : 0) |
                    (a.dout % 2 == 0 && aligned(a.out, 4) ? 8 : 0);
  const long long blocks = (a.M + MR - 1) / MR;
  fused_tp_mma_kernel<NO><<<(unsigned)blocks, MNT, l.bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const __nv_bfloat16*>(a.sh),
      static_cast<const __nv_bfloat16*>(a.w), static_cast<const int*>(a.cptr),
      static_cast<const int*>(a.cboth), static_cast<const int*>(a.cxa),
      static_cast<const int*>(a.ctile), static_cast<const uint2*>(a.cfrag),
      static_cast<const int*>(a.snptr), static_cast<const int*>(a.stile),
      static_cast<const uint2*>(a.sfrag), static_cast<const int*>(a.widx),
      static_cast<__nv_bfloat16*>(a.out), a.M, a.din, a.dsh, a.numel, a.dout, a.npairs,
      a.maxpair, flags);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// f32 on CUDA cores (`fused_tp_f32_kernel<RT>`, the design note at the top)

namespace f32k {

constexpr int NW = 16;  // warps a block (kernels/tp_kernels.py FWD_WARPS)
constexpr int NT = 32 * NW;

// 4 bytes global -> shared, zeros instead when !ok (src-size 0)
__device__ __forceinline__ void cp_async4z(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

struct Args {
  const float *x, *sh, *w;
  const unsigned char* blob;  // f32_fwd_tables' blob
  float* out;
  long long M;
  int din, dsh, numel, dout, bytes, q_off, cp_off, sc_off;
};

// A block's shared memory: the blob at 0, then W (w [numel][rs]), two S
// buffers ([din + dsh][rs]: x, then sh) and O [T][os] (out); the row
// operands feature-major, row r of feature f at f * rs + r
struct Layout {
  int rs, os, w_floats, s_floats, w_off, s_off, o_off, bytes;
};

__host__ __device__ inline Layout layout(int rt, int blob_bytes, int din, int dsh, int numel,
                                         int dout) {
  Layout l;
  l.rs = 32 * rt + 1;  // odd: a warp's copy of one row writes 32 distinct banks
  l.os = dout | 1;     // odd: the lanes' rows of one output column on distinct banks
  l.w_floats = numel * l.rs;
  l.s_floats = (din + dsh) * l.rs;
  l.w_off = blob_bytes;
  l.s_off = l.w_off + 4 * l.w_floats;
  l.o_off = l.s_off + 4 * 2 * l.s_floats;
  l.bytes = l.o_off + 4 * 32 * rt * l.os;
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
__global__ void __launch_bounds__(NT, 1) fused_tp_f32_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T = 32 * RT;  // rows a tile; lane l owns rows l + 32 r, r < RT
  const Layout ly = layout(RT, a.bytes, a.din, a.dsh, a.numel, a.dout);
  const int rs = ly.rs, os = ly.os, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int din = a.din, dsh = a.dsh, numel = a.numel, dout = a.dout;
  const uint2* ez = reinterpret_cast<const uint2*>(smem);
  const unsigned* qw = reinterpret_cast<const unsigned*>(smem + a.q_off);
  const unsigned short* cp = reinterpret_cast<const unsigned short*>(smem + a.cp_off);
  const unsigned short* sc = reinterpret_cast<const unsigned short*>(smem + a.sc_off);
  float* sw = reinterpret_cast<float*>(smem + ly.w_off);
  float* ss = reinterpret_cast<float*>(smem + ly.s_off);
  float* so = reinterpret_cast<float*>(smem + ly.o_off);
  const long long M = a.M, ntiles = (M + T - 1) / T;

  // the tables, once (visible after the loop's first barrier); a nonzero's
  // rf | rb << 16 becomes the offsets in S of its x row, rf rs, and of its
  // sh row, (din + rb) rs << 16
  for (int i = tid; i < a.bytes / 16; i += NT) {
    uint4 v = __ldg(reinterpret_cast<const uint4*>(a.blob) + i);
    if (16 * i < a.q_off) {
      v.x = (v.x & 0xffff) * rs | ((v.x >> 16) + din) * rs << 16;
      v.z = (v.z & 0xffff) * rs | ((v.z >> 16) + din) * rs << 16;
    }
    reinterpret_cast<uint4*>(smem)[i] = v;
  }
  // row tiles by cp.async, one group each: S of a tile, W of a tile
  auto stage_s = [&](float* S, long long tile) {
    if (tile < ntiles) {
      stage<RT>(S, a.x, din, tile * T, M, rs, warp, lane);
      stage<RT>(S + din * rs, a.sh, dsh, tile * T, M, rs, warp, lane);
    }
    cp_async_commit();
  };
  auto stage_w = [&](long long tile) {
    if (tile < ntiles) stage<RT>(sw, a.w, numel, tile * T, M, rs, warp, lane);
    cp_async_commit();
  };
  stage_s(ss, blockIdx.x);
  stage_w(blockIdx.x);

  int it = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const long long e0 = tile * T, next = tile + gridDim.x;
    cp_async_wait<0>();
    __syncthreads();  // this tile's x, sh and w are in; the last tile's S and O are read
    stage_s(ss + ((it + 1) & 1) * ly.s_floats, next);

    // out[c] = sum over the positions q of column c (cptr's order) of
    // cast(w[widx q] * TR[q]), TR[q] = sum over q's nonzeros (rptr's order)
    // of coef * cast(x[rf] * sh[rb]), an fmaf chain. Column c's nonzeros
    // are one run of ez; each word loads one step ahead of its use, and
    // w[widx q] when q starts.
    const float* S = ss + (it & 1) * ly.s_floats + lane;
    const float* wl = sw + lane;
    for (int u = sc[warp]; u < sc[warp + 1]; ++u) {
      const int c = sc[u];
      int q = cp[c];
      unsigned qa = qw[q], qb = qw[q + 1];
      int z = qa & 0xffff, zq = qb & 0xffff;  // q's nonzeros end at zq
      const int ze = qw[cp[c + 1]] & 0xffff;
      float wv[RT], tr[RT], acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        wv[r] = wl[(qa >> 16) * rs + 32 * r];
        tr[r] = 0.0f;
        acc[r] = 0.0f;
      }
      uint2 e = ez[z];
      for (; z < ze; ++z) {
        const uint2 cur = e;
        e = ez[z + 1];  // past the last column's run: the blob's zero word
        const float* xp = S + (cur.x & 0xffff);
        const float* hp = S + (cur.x >> 16);
        const float cf = __uint_as_float(cur.y);
#pragma unroll
        for (int r = 0; r < RT; ++r) tr[r] = fmaf(cf, __fmul_rn(xp[32 * r], hp[32 * r]), tr[r]);
        if (z + 1 == zq) {  // q's last nonzero: its product joins the sum
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            acc[r] = __fadd_rn(acc[r], __fmul_rn(wv[r], tr[r]));
            tr[r] = 0.0f;
          }
          qa = qb;
          qb = qw[++q + 1];  // past the last position: qword's zero word
          zq = qb & 0xffff;
#pragma unroll
          for (int r = 0; r < RT; ++r) wv[r] = wl[(qa >> 16) * rs + 32 * r];
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) so[(lane + 32 * r) * os + c] = acc[r];
    }
    __syncthreads();  // O is whole, and W is read: it takes the next tile's w
    stage_w(next);
    // the tile's outputs leave row by row, coalesced
    for (int r = warp; r < T; r += NW) {
      if (e0 + r >= M) break;
      float* o = a.out + (e0 + r) * dout;
      for (int c = lane; c < dout; c += 32) o[c] = so[r * os + c];
    }
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
      fused_tp_f32_kernel<RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (a.M + 32 * RT - 1) / (32 * RT);
  const long long sms = std::max(device_attr(cudaDevAttrMultiProcessorCount), 1);
  fused_tp_f32_kernel<RT><<<(unsigned)std::min(tiles, sms), NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace f32k

}  // namespace

extern "C" {

// x [M, din], sh [M, dsh], w [M, numel] -> out [M, dout]. f32 on CUDA
// cores from the blob of kernels/tp_kernels.py `f32_fwd_tables` (`bytes`
// long, a multiple of 16; its tables at the byte offsets given, each a
// multiple of 16): 64 rows a tile where the shared memory takes them, else
// 32
int fused_tp_f32(const void* x, const void* sh, const void* w, const void* blob, void* out,
                 long long M, int din, int dsh, int numel, int dout, int bytes, int q_off,
                 int cp_off, int sc_off, void* stream) {
  if (M <= 0 || din <= 0 || dsh <= 0 || numel <= 0 || dout <= 0 || bytes <= 0 ||
      bytes % 16 != 0 || q_off <= 0 || q_off % 16 != 0 || !aligned(blob, 16) ||
      (din + dsh) * 65 >= 1 << 16)  // the S offsets of a nonzero in 16 bits each
    return (int)cudaErrorInvalidValue;
  const f32k::Args a{static_cast<const float*>(x), static_cast<const float*>(sh),
                     static_cast<const float*>(w), static_cast<const unsigned char*>(blob),
                     static_cast<float*>(out), M, din, dsh, numel, dout, bytes, q_off,
                     cp_off, sc_off};
  const int cap = f32k::device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int two = f32k::layout(2, bytes, din, dsh, numel, dout).bytes;
  if (two <= cap) return f32k::launch<2>(a, two, st);
  const int one = f32k::layout(1, bytes, din, dsh, numel, dout).bytes;
  if (one <= cap) return f32k::launch<1>(a, one, st);
  return (int)cudaErrorInvalidValue;
}

// bf16 on the tensor cores: x [M, din], sh [M, dsh], w [M, numel] -> out
// [M, dout] (dout <= 64); the packed tiles from kernels/tp_kernels.py
// `mma_tables`: CBIG_R's nonzero k16 x n8 tiles by pair of column tiles
// (cptr [npairs + 1], cboth and cxa [npairs], ctile, cfrag; at most maxpair
// a pair), SUMR's by k16 step (snptr [npairs + 1], stile, sfrag), widx
// padded to 16 * npairs columns
int fused_tp_bf16(const void* x, const void* sh, const void* w, const void* cptr,
                  const void* cboth, const void* cxa, const void* ctile, const void* cfrag,
                  const void* snptr, const void* stile, const void* sfrag, const void* widx,
                  void* out, long long M, int din, int dsh, int numel, int dout, int npairs,
                  int maxpair, void* stream) {
  if (M <= 0 || din <= 0 || dsh <= 0 || numel <= 0 || dout <= 0 || npairs <= 0 ||
      maxpair <= 0)
    return (int)cudaErrorInvalidValue;
  const MmaArgs a{x, sh, w, cptr, cboth, cxa, ctile, cfrag, snptr, stile, sfrag, widx, out,
                  M, din, dsh, numel, dout, npairs, maxpair};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((dout + 7) / 8) {
    case 1: return launch_mma<1>(a, st);
    case 2: return launch_mma<2>(a, st);
    case 3: return launch_mma<3>(a, st);
    case 4: return launch_mma<4>(a, st);
    case 5: return launch_mma<5>(a, st);
    case 6: return launch_mma<6>(a, st);
    case 7: return launch_mma<7>(a, st);
    case 8: return launch_mma<8>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
