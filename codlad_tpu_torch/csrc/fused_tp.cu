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
// f32: CUDA cores (tensor cores in f32 would be TF32, outside the f32
// tolerance). The TPU keeps the three dense tables resident per block; at
// layer 2 CBIG_R alone is 324 x 672 (871 KB in f32), more than a Hopper
// block's shared memory. EXPW and SUMR are 0/1 selections (one nonzero per
// column of EXPW and per row of SUMR), and CBIG_R holds 2-15 nonzeros a
// column. So the kernel reads the tables as lists (kernels/tp_kernels.py
// `sparse_tables`): the R expansion columns grouped by output column (cptr),
// each with its weight column (widx) and its nonzeros (rptr, rows, coef). A
// block of 256 threads owns TE = 32 rows: it stages xcat [TE][dsh*din] and w
// [TE][numel] in shared memory as f32 (row strides odd, so the lanes' reads
// hit distinct banks), then each warp takes output columns c = warp, warp +
// 8, ... with one row a lane; the table reads are the same address across
// the warp. The outputs go through shared memory to coalesced stores.
//
// bf16: the Pallas kernel's three products on the tensor cores,
// block-sparse (`fused_tp_mma_kernel`). The f32 design above ran bf16 on
// CUDA cores at f32 speed, two 97 KB blocks an SM, each of CBIG_R's
// nonzeros a chain of dependent loads. Here:
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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float f(float v) { return v; }
  __device__ static float cast(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int TE = 32;  // rows per block, one a lane

template <typename T>
__global__ void __launch_bounds__(NT)
fused_tp_kernel(const T* __restrict__ x, const T* __restrict__ sh, const T* __restrict__ w,
                const int* __restrict__ cptr, const int* __restrict__ widx,
                const int* __restrict__ rptr, const int* __restrict__ rows,
                const float* __restrict__ coef, T* __restrict__ out, long long M, int din,
                int dsh, int numel, int dout) {
  using Nm = Num<T>;
  extern __shared__ float smem[];
  const int KX = dsh * din;
  const int XS = KX | 1, WS = numel | 1, OS = dout | 1;  // odd row strides
  float* sx = smem;             // [TE][XS] cast(x * sh[b])
  float* sw = sx + TE * XS;     // [TE][WS] w
  float* so = sw + TE * WS;     // [TE][OS] out
  const long long e0 = (long long)blockIdx.x * TE;
  const int ne = M - e0 < TE ? (int)(M - e0) : TE;
  const int tid = threadIdx.x;

  for (int i = tid; i < TE * KX; i += NT) {
    const int e = i / KX, j = i - e * KX;
    const int b = j / din, f = j - b * din;
    float v = 0.0f;
    if (e < ne) v = Nm::round(Nm::f(x[(e0 + e) * din + f]) * Nm::f(sh[(e0 + e) * dsh + b]));
    sx[e * XS + j] = v;
  }
  for (int i = tid; i < TE * numel; i += NT) {
    const int e = i / numel, k = i - e * numel;
    sw[e * WS + k] = e < ne ? Nm::f(w[(e0 + e) * numel + k]) : 0.0f;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const float* xr = sx + lane * XS;
  const float* wr = sw + lane * WS;
  for (int c = warp; c < dout; c += NW) {
    float acc = 0.0f;
    for (int q = cptr[c]; q < cptr[c + 1]; ++q) {
      float tr = 0.0f;
      for (int z = rptr[q]; z < rptr[q + 1]; ++z) tr = fmaf(coef[z], xr[rows[z]], tr);
      acc += Nm::round(wr[widx[q]] * tr);
    }
    so[lane * OS + c] = acc;
  }
  __syncthreads();
  for (int i = tid; i < ne * dout; i += NT) {
    const int e = i / dout, c = i - e * dout;
    out[e0 * dout + i] = Nm::cast(so[e * OS + c]);
  }
}

template <typename T>
int launch(const void* x, const void* sh, const void* w, const void* cptr, const void* widx,
           const void* rptr, const void* rows, const void* coef, void* out, long long M,
           int din, int dsh, int numel, int dout, void* stream) {
  if (M <= 0 || din <= 0 || dsh <= 0 || numel <= 0 || dout <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TE * (((dsh * din) | 1) + (numel | 1) + (dout | 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_tp_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (M + TE - 1) / TE;
  fused_tp_kernel<T><<<(unsigned)blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(sh), static_cast<const T*>(w),
      static_cast<const int*>(cptr), static_cast<const int*>(widx),
      static_cast<const int*>(rptr), static_cast<const int*>(rows),
      static_cast<const float*>(coef), static_cast<T*>(out), M, din, dsh, numel, dout);
  return (int)cudaGetLastError();
}

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

}  // namespace

extern "C" {

// x [M, din], sh [M, dsh], w [M, numel] -> out [M, dout]; tables from
// kernels/tp_kernels.py `sparse_tables` (coef already rounded to the payload
// dtype, as f32)
int fused_tp_f32(const void* x, const void* sh, const void* w, const void* cptr,
                 const void* widx, const void* rptr, const void* rows, const void* coef,
                 void* out, long long M, int din, int dsh, int numel, int dout,
                 void* stream) {
  return launch<float>(x, sh, w, cptr, widx, rptr, rows, coef, out, M, din, dsh, numel,
                       dout, stream);
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
