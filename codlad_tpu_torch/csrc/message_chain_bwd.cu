// Backward of the fused MPNN message chains for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernels of codlad_tpu/kernels/mpnn_kernels.py:
//   K3 message_sum_bwd_*        <- _sum_bwd_kernel / _pallas_sum_bwd
//   K4 message_edge_lnmod_bwd_* <- _edge_lnmod_bwd_kernel / _pallas_edge_lnmod_bwd
//   K5 (backward) the same entry with `keep` (has_keep) or `seeds` (drop_p):
//      the dropout mask is regenerated from the counter hash of chain_common.cuh
//   K6 message_edge_bwd_*       <- _edge_bwd_kernel / _pallas_edge_bwd
//
// What each computes (f32 accumulation; cast() rounds to the edge dtype where
// the TPU kernel does):
//   recompute pre = A + E W_e + Gn[idx], h1 = cast(gelu(pre)),
//             x2 = h1 W2 + b2, h2 = gelu(x2)
//   K3: dout (already / scale) [B, L, H]; s = cast(sum_k mask h2);
//       ds = cast(dout) W3^T, dW3 = s^T cast(dout), db3 = sum_l (sum_k mask) dout,
//       dh2 = ds * mask
//   K4: x = (cast(h2) W3 + b3) * keep, resid = E + x, ln = LN(resid);
//       dsh = sum dct*g, dsc = sum dct*g*ln, dgate = sum dct*ln*(1+sc) (the
//       sh * sum dct term is added by the wrapper, as on the TPU);
//       dresid = LN backward of dct*g*(1+sc); dmsg = dresid * keep;
//       dh2 = cast(dmsg) W3^T, dW3 = cast(h2)^T cast(dmsg), db3 = sum dmsg
//   K6: K4 without the LayerNorm: the cotangent [B, L, K, H] (E's dtype) is dmsg
//       itself, and dE has no dresid term
//   both: dx2 = dh2 gelu'(x2); dW2 = h1^T cast(dx2), db2 = sum dx2;
//         dpre = (cast(dx2) W2^T) gelu'(pre);
//         dE = cast(cast(dpre) W_e^T [+ dresid]), dA = sum_k dpre,
//         dGn[idx] += cast(dpre), dW_e = E^T cast(dpre)
//
// Design. The TPU grid runs in order and carries the weight grads and dGn in
// VMEM from one grid step to the next; Hopper blocks run in parallel. So:
//  * f32 K3, K4 / K5's and K6's backward on the tensor cores in 3xTF32 (the
//    slab functions of chain_tf32.cuh, so pre, x2 and msg are recomputed as
//    the f32 K1 and K2 compute them). One f32 H x H weight in fragment order is
//    64 KB: the forward's three and the backward's three transposed ones do
//    not fit in 227 KB, and restaging them every tile cost K7 1.375x K2
//    then K1 (PERF.md). So each runs in two passes, each pass a
//    persistent block of 8 warps (one an SM) with its weights staged once,
//    a warp walking over whole residues (a residue's 16-row slabs in order,
//    rows past K padding: K a multiple of 4 up to 64):
//      pass 1 (`message_sum_bwd_f32_mma_kernel`; K4 / K5:
//        `message_edge_lnmod_bwd_f32_mma_kernel<DROP>`; K6:
//        `message_edge_bwd_f32_mma_kernel`) with W_e, W2 (and W3, or K6's
//        W3^T) in fragment order: pre, h1 = gelu(pre) (-> s_h1) and
//        gelu'(pre) (-> s_dg1, parked) from one exp, x2, h2 and gelu'(x2).
//        K3: ds = dout W3^T per residue on CUDA cores (W3^T row-major in
//        shared memory, j in order), s's and db2's slab sums, dx2 = (ds
//        mask) gelu'(x2) (-> s_dx2). K4 / K5: h2 (-> s_h2), gelu'(x2) (->
//        s_dg2, parked), msg = h2 W3, the residual (E kept in registers, as
//        K2 keeps it), the LayerNorm and its backward in fragment layout
//        (K2's row sums), dresid (-> s_dres, parked), dmsg = dresid x keep
//        (-> s_dmsg; DROP 2 regenerates the forward's mask from the natural
//        element index), dsh's, dsc's, dgate's and db3's slab sums. K6: h2
//        (-> s_h2), gelu'(x2) held in registers through dh2 = dout W3^T
//        (dout's rows the A operand), dx2 = dh2 gelu'(x2) (-> s_dx2), db2's
//        and db3's slab sums;
//      pass 2 (`data_grads_f32_mma_kernel<EDGE>`) with the transposed
//        weights staged by stage_frag from W^T (W2^T's columns and W_e^T's
//        rows through unit(), so dh1 has pre's unit order and dE the
//        natural one): K4 / K5: dh2 = dmsg W3^T, dx2 = dh2 gelu'(x2) (->
//        s_dx2, db2's slab sums); K3 and K6 read dx2 back; dh1 = dx2 W2^T, dpre
//        = dh1 gelu'(pre) (-> s_dpre; dGn by float4 atomicAdd, the one
//        source of run-to-run differences; dA's slab sums), dE = dpre
//        W_e^T [+ dresid].
//    A column sum is a residue's slabs in order (rows g and g + 8, the
//    butterfly of reduce_rows, then the slabs), one part a residue, then
//    sum_partials over the residues (dsh, dsc, dgate: each sample's), so
//    every output but dGn repeats bit for bit.
//    K6's backward replaces the TPU's `_edge_bwd_kernel`
//    (codlad_tpu/kernels/mpnn_kernels.py, via `_pallas_edge_bwd`). Its
//    bound: 8 H x H products a row (2 recomputed, dh2, dh1, dE, three
//    weight grads), 206 GFLOP at the training shape, 1.25 ms in 3xTF32 at
//    the tensor cores' peak; above it its scratch, 16 [B*L*K, H] f32 arrays
//    read or written (6.4 GB, 1.92 ms). K4's pass 1 without its LayerNorm,
//    with dh2 = dout W3^T for its W3 product: gelu'(x2) stays in registers
//    instead of being parked, and pass 2 is K3's unchanged. A form that
//    parked gelu'(x2) and computed dh2 in pass 2 (17 arrays) timed the
//    same (PERF.md). Pass 1's products sum each two k8 steps from zero and
//    add them in f32 (`mma_slab<2>`): with the tensor core's truncating
//    sums alone its operands carry several times f32's error, which the
//    weight grads sum over every edge row to past the f32 limit of K6's
//    card test against f32 autograd (~1.2x; grouped, 0.43x against
//    float64). The three products share one rolled loop (one copy of their
//    code); gelu'(x2) live through it costs a few registers' spills.
//  * message_sum_bwd_mma_kernel (bf16 K3) on the tensor cores: K1's block
//    (8 warps, 128 edge rows of whole residues, K a multiple of 16) and
//    slabs (a warp 16 rows of one residue), with K1's slab functions
//    (chain_mma.cuh), so pre and x2 are recomputed as the forward computes them:
//      0. cast(dout) of the block's residues (-> s_dout), db3's tile part,
//         and ds = cast(dout) W3^T per residue on CUDA cores (W3's rows read
//         as 8-byte loads, a butterfly over the warp) while the tile arrives;
//      A. pre = A + Gn + E W_e; from one exp and one rcp an element, y =
//         cast(gelu(pre)) (gelu_exp's expression; -> s_h1)
//         and gelu'(pre) in f32, parked in f32 scratch (s_dg1, in fragment
//         order: 512 contiguous bytes a tile and warp) until phase C;
//      B. x2 = y W2 in halves; from one exp each: h2 = gelu(x2 + b2) for
//         s's masked row sums (butterflies, then the residue's slabs in slab
//         order, cast -> s_s) and dx2 = (ds mask) gelu'(x2) (f32), its
//         slab column sums (db2), cast into the warp's own tile rows (E is
//         read no more) and from there to s_dx2 in 16-byte stores;
//      C. by quarters of pre's columns: dh1 = cast(dx2) W2^T (A fragments
//         by ldmatrix from those rows), dpre = dh1 gelu'(pre) in f32 (gelu'
//         back from s_dg1, the next quarter's loads in flight): its slab row
//         sums (dA), cast -> float4 atomicAdd into dGn, -> s_dpre, packed as
//         the A fragments of dE = cast(dpre) W_e^T, cast and stored from
//         the warp's own tile rows.
//    ldmatrix without .trans reads W2^T and W_e^T from W2's and W_e's own
//    staging, whose unit order (message_chain.cu) then gives dh1 pre's
//    column order and dE the natural one: no weight is restaged or
//    transposed. gelu' is f32 throughout, as JAX keeps dg1 and dg2. Parking
//    gelu'(pre) (instead of holding it, or recomputing pre, beside dh1 and
//    cast(dpre)) keeps the kernel within 128 registers without spills (two
//    blocks an SM): spilled registers go to local memory, which the L1 left
//    beside two blocks' shared memory cannot hold.
//  * message_edge_bwd_mma_kernel (bf16 K6's backward) and
//    message_edge_lnmod_bwd_mma_kernel<DROP> (bf16 K4 at DROP 0, K5's
//    backward at DROP 1, `keep`, and DROP 2, `seeds`): K3's block, slabs and
//    phases A and C (the same device functions), around the backward of
//    the per-edge W3 product. Two weight buffers: W2 stays resident, the
//    other cycles W_e -> W3 -> W_e (cp.async, each restaging overlapped with
//    work that does not read the buffer: product 2, then phase C's dh1).
//    Column sums (db2, db3, dsh, dsc, dgate, and dA's slab parts) go
//    through [2][8][H] f32 slab parts in shared memory: each tile sums its
//    slabs in slab order, then sum_partials the tiles, so every output but
//    dGn repeats bit for bit.
//      K6: once product 1 has read a warp's E rows, the warp stages its 16
//         rows of the cotangent dmsg there (cp.async), sums them for db3,
//         and runs x2 = y W2 + b2 and dh2 = dmsg W3^T (A fragments by
//         ldmatrix from those rows, W3^T by ldmatrix from W3's own staging)
//         quarter by quarter: h2 = cast(gelu(x2)) -> s_h2 (4-byte stores, a
//         quad's fill 16 bytes), gelu'(x2) from the same exp, dx2 = dh2
//         gelu'(x2) (db2's slab parts), cast(dx2) held packed until the
//         last quarter, then staged in the rows for phase C. dW3's operands
//         are cast(h2) and the cotangent itself.
//      K4 / K5: x2 in halves, h2 = cast(gelu(x2)) packed as the A
//         fragments of msg = cast(h2) W3 (K2's fragment trick) and stored
//         to s_h2, gelu'(x2) parked in f32 scratch (s_dg2) in fragment
//         order; then the LayerNorm and its backward in fragment layout (a
//         row's 128 columns in the 4 lanes of a quad, row sums over the
//         lane's columns in order, then the quad, as K2's lnmod_out): pass
//         1, resid = E (the warp's tile rows) + (msg + b3) x keep, LN, the
//         slab parts of dsh and dsc, m1 and m2; pass 2, dgate's and db3's
//         slab parts, dresid in f32 (parked in s_dres for dE), cast(dmsg) =
//         cast(dresid x keep) into the tile rows (-> s_dmsg, and the A
//         fragments of dh2 = cast(dmsg) W3^T). K6's dh2 quarters follow,
//         gelu'(x2) read back, and phase C with dE = cast(f32(cast(dpre)
//         W_e^T) + dresid), dresid added before the cast as
//         _chain_bwd_common adds it. DROP 2 regenerates the forward's mask
//         (message_chain.cu: drop_bits of the natural column index, whatever
//         order the fragment holds) in pass 1 and keeps it as 64 bits a
//         lane for pass 2. Holding gelu'(x2) and dresid (64 f32 a lane
//         each) beside the LayerNorm's acc would pass 128 registers: they
//         are parked, 0.8 GB written and read a call at the training shape.
//  * wgrad_f32_mma_kernel (f32) / wgrad_mma_kernel (bf16), every backward's
//    weight grads: dW = X^T Y for the three operand pairs, each block
//    summing one chunk of rows into an [H, H] partial on the tensor cores,
//    a warp a 32 x 64 block (f32: mma.m16n8k8 in 3xTF32, the rows the k
//    dimension read from a cp.async ring as scalars, each 32-row stage
//    summed from a fresh accumulator and folded in with Kahan
//    compensation; bf16: mma.m16n8k16 with ldmatrix.trans).
//  * sum_partials: a second pass that adds the partials in a fixed order
//    (compensated), so the weight and per-sample grads are deterministic.
//
// Bound on an H100 at the training shape (B96 L128 K64 H128): K3 does
// about 6 B*L*K x H x H products (2 recomputed, dh1, dE, dW2, dW_e), K4 about 9
// and K6's backward 8, 25.8 GFLOP each; the bytes (E and dout read, dE
// written) put the floor at ~0.1-0.2 ms in bf16, ~0.25-0.37 ms in f32. The
// bf16 K3's scratch (three [B*L*K, H] bf16 arrays written, then read by the
// weight-grad pass with E; gelu'(pre) in f32 written and read back) moves
// ~2.2 GB, ~0.65 ms at 3.35 TB/s; its four per-edge products and gelu' are
// about twice K1's work, and it runs at about K1's rate. K6's backward adds
// s_h2 (bf16) to that traffic, K4's s_h2, s_dmsg and the two parked f32
// arrays: ~3.0 and ~4.2 GB. In f32, 3xTF32 puts the products at 0.94 ms
// (K3) and 1.40 ms (K4) at the TF32 peak, 495 TFLOP/s, and every scratch
// array is 4 bytes an element (402.6 MB a [B*L*K, H] array): the two-pass
// K3 writes and reads 12 of them (~4.8 GB, 1.44 ms), K4 / K5 21 (~8.5
// GB, 2.52 ms), above the products' floor; the split at fragment load
// holds the products near 47% of the peak. PERF.md has the times.

#include <algorithm>

#include "chain_common.cuh"
#include "chain_mma.cuh"
#include "chain_tf32.cuh"
#include "mma_common.cuh"

namespace {

using namespace chain;

template <typename T>
struct Pairs {
  const T* X[3];
  const T* Y[3];
  long long M[3];
};

// out[g][c] = sum_t part[g][t][c], compensated (Kahan) and in a fixed order, so
// deterministic. A block of 32 x 32 threads owns 32 columns: thread (ty, tx)
// sums t = ty, ty + 32, ... of column tx (coalesced across tx), then ty = 0
// adds the 32 partial sums in order. A plain f32 running sum over the 12288
// tiles of the training shape loses ~1e-5 of the sum's scale, which the f32
// check against float64 sees; one thread an output over 12288 tiles is
// latency-bound (8.6 ms a training step, torch.profiler on the H100).
constexpr int RT = 32;  // t-splits a block

__device__ __forceinline__ void kahan_add(float& s, float& comp, float v) {
  const float y = v - comp;
  const float u = s + y;
  comp = (u - s) - y;
  s = u;
}

__global__ void __launch_bounds__(32 * RT)
sum_partials(const float* __restrict__ part, float* __restrict__ out, int G, int T, int C) {
  __shared__ float ss[RT][33], sc[RT][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long g = blockIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.0f, comp = 0.0f;
  if (c < C) {
    const float* src = part + g * T * C + c;
    for (int t = ty; t < T; t += RT) kahan_add(s, comp, src[(long long)t * C]);
  }
  ss[ty][tx] = s;
  sc[ty][tx] = comp;
  __syncthreads();
  if (ty == 0 && c < C) {
    float total = 0.0f, tcomp = 0.0f;
    for (int q = 0; q < RT; ++q) {
      kahan_add(total, tcomp, ss[q][tx]);
      kahan_add(total, tcomp, -sc[q][tx]);
    }
    out[g * C + c] = total;
  }
}

int reduce(const float* part, float* out, int G, int T, int C, cudaStream_t stream) {
  sum_partials<<<dim3((C + 31) / 32, G), dim3(32, RT), 0, stream>>>(part, out, G, T, C);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: K3's main pass (`message_sum_bwd_mma_kernel`) and
// the weight-grad pass of every bf16 backward (`wgrad_mma_kernel`; K3, K4, K5's
// and K6's), mma.m16n8k16 with bf16 operands and f32 sums.

using namespace chain_mma;

// K3: W_e, W2 and the E tile as K1 stages them, then f32 b2 [H], sdo [8][H]
// (the residues' cast(dout), then s's slab parts, then dA's), sds [8][H] (ds,
// then db2's slab parts) and the mask counts [8]: two blocks an SM
constexpr int S3SMEM = 2 * WBYTES + TBYTES + (H + 8 * H + 8 * H + 8) * 4;
// K6's and K4's backwards: W_e / W3, W2 and the edge tile, then f32 vectors
// (K6: b2; K4: b2, b3, sc, g) and [2][MW][H] slab parts of column sums: two
// blocks an SM
constexpr int S6SMEM = 2 * WBYTES + TBYTES + (H + 2 * MW * H) * 4;
constexpr int S4SMEM = 2 * WBYTES + TBYTES + (4 * H + 2 * MW * H) * 4;

// gelu_exp's sigmoid sg = 1 / (1 + exp(-2u)) (gelu = x sg): one ex2 and one
// rcp, as gelu_exp
__device__ __forceinline__ float sigmoid_2u(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return __fdividef(1.0f, 1.0f + __expf(-2.0f * u));
}

// d gelu / dx from sg: JAX's _gelu_and_grad with tanh u = 2 sg - 1,
// 0.5 (1 + t) + 0.5 x (1 - t^2) u' = sg + 2 x sg (1 - sg) u', in f32
__device__ __forceinline__ float gelu_grad_of(float x, float sg) {
  return sg + 2.0f * x * sg * (1.0f - sg) *
                  (0.7978845608028654f * (1.0f + 3.0f * 0.044715f * x * x));
}

// the lane's column of a slab sum after reduce_rows<8> over four n tiles:
// original index 4 b0 + 2 b1 + b2 (lane bits 2, 3, 4) = 2 o + e, o < 4, e < 2
__device__ __forceinline__ int reduced_index(int lane) {
  const int g = lane >> 2;
  return 4 * (g & 1) + 2 * ((g >> 1) & 1) + (g >> 2);
}

// rows g and g + 8 of the slab from v, whose registers v[nt][h] hold units
// 32 t4 + 2 nt, + 1 of row g + 8 h (pre's unit order: 32 consecutive units a
// lane), to dst in natural column order, 16-byte stores
__device__ __forceinline__ void store_units(bf16* __restrict__ dst, const unsigned (&v)[16][2],
                                            const Slab& s) {
  const int g = s.lane >> 2, t4 = s.lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4* p = reinterpret_cast<uint4*>(dst + (s.row0 + s.r0 + g + 8 * h) * H + 32 * t4);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      p[q] = make_uint4(v[4 * q][h], v[4 * q + 1][h], v[4 * q + 2][h], v[4 * q + 3][h]);
  }
}

// K3 on half hf of x2's columns (n tiles 8 hf .. 8 hf + 7, natural order),
// from c2 = y W2 of that half, in two groups of four n tiles: h2 = gelu(x2 +
// b2) times the rows' masks (m0: row g, m8: row g + 8) summed over the slab
// into red (K1's masked row sums); dx2 = (ds mask) gelu'(x2), cast to bf16
// into the slab's 16 tile rows (`rows`, MRS bytes a row); dx2 summed over
// the slab into dbk[2 hf + q] (db2's slab part of the lane's reduced
// column). ds is the residue's row [H].
__device__ __forceinline__ void sum_bwd_half(const float (&c2)[8][4], const float* sb2,
                                             const float* ds, float m0, float m8, int hf,
                                             float* red, float (&dbk)[4], unsigned char* rows,
                                             int lane) {
  const int g = lane >> 2, t4 = lane & 3, ri = reduced_index(lane);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float sp[8], dp[8];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int nt = 8 * hf + 4 * q + o, c = 8 * nt + 2 * t4;
      const float2 bias = *reinterpret_cast<const float2*>(sb2 + c);
      const float2 dsv = *reinterpret_cast<const float2*>(ds + c);
      float dx[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = e ? bias.y : bias.x, d = e ? dsv.y : dsv.x;
        const float x0 = c2[4 * q + o][e] + b, x8 = c2[4 * q + o][2 + e] + b;
        const float s0 = sigmoid_2u(x0), s8 = sigmoid_2u(x8);
        sp[2 * o + e] = m0 * (x0 * s0) + m8 * (x8 * s8);
        dx[0][e] = (d * m0) * gelu_grad_of(x0, s0);
        dx[1][e] = (d * m8) * gelu_grad_of(x8, s8);
        dp[2 * o + e] = dx[0][e] + dx[1][e];
      }
      *reinterpret_cast<unsigned*>(rows + g * MRS + 2 * c) = pack_bf16(dx[0][0], dx[0][1]);
      *reinterpret_cast<unsigned*>(rows + (g + 8) * MRS + 2 * c) = pack_bf16(dx[1][0], dx[1][1]);
    }
    reduce_rows(sp, lane);
    reduce_rows(dp, lane);
    red[8 * (8 * hf + 4 * q + (ri >> 1)) + 2 * t4 + (ri & 1)] = sp[0];
    dbk[2 * hf + q] = dp[0];
  }
}

// c = a W^T at n tiles 2 np0 .. 2 (np0 + NP) - 1. W^T's column n is sW's row n, so
// ldmatrix without .trans reads the B fragments from W's own staging. dh1 =
// cast(dx2) W2^T from W2's rows in unit order has pre's (unit) column order;
// dE = cast(dpre) W_e^T from W_e's columns in unit order (the order of dpre,
// the k index) has natural column order. A tile's sums do not depend on NP.
// `a(kk, af)` gives k16 step kk's A fragment.
template <int NP, typename F>
__device__ __forceinline__ void mma_wt(float (&c)[2 * NP][4], F&& a, const unsigned char* sW,
                                       int lane, int np0) {
  const int mi = lane >> 3;
  const unsigned base = smem_addr(sW) + (8 * (mi >> 1) + (lane & 7)) * MRS + (mi & 1) * 16;
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    unsigned af[4];
    a(kk, af);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      unsigned bb[4];
      ldmatrix_x4(bb, base + 16 * (np0 + np) * MRS + 32 * kk);
      mma_bf16(c[2 * np], af, bb[0], bb[1]);
      mma_bf16(c[2 * np + 1], af, bb[2], bb[3]);
    }
  }
}

// gelu(x) as gelu_exp computes it, and gelu'(x) in f32, from one exp
__device__ __forceinline__ float gelu_and_grad(float x, float& dg) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  const float den = 1.0f + __expf(-2.0f * u);
  dg = gelu_grad_of(x, __fdividef(1.0f, den));
  return __fdividef(x, den);
}

// the column of a lane's slab sum after reduce_rows<8> over quarter j's values
// (n tiles 4 j + o, o < 4; natural columns 8 nt + 2 t4 + e)
__device__ __forceinline__ int quarter_col(int j, int lane) {
  const int ri = reduced_index(lane);
  return 8 * (4 * j + (ri >> 1)) + 2 * (lane & 3) + (ri & 1);
}

// dst[c] = the tile's nslab slab parts part[q][c] summed in slab order (threads c < H)
__device__ __forceinline__ void slab_order_sum(const float* part, int nslab,
                                               float* __restrict__ dst) {
  if (threadIdx.x < H) {
    float v = 0.0f;
    for (int q = 0; q < nslab; ++q) v += part[q * H + threadIdx.x];
    dst[threadIdx.x] = v;
  }
}

// dA[l] = residue l's slab parts (part: a row a slab) summed in slab order
__device__ __forceinline__ void residue_sums(const float* part, float* __restrict__ dA, int L,
                                             int spr, const Slab& s) {
  for (int i = threadIdx.x; i < s.TL * H; i += MNT) {
    const int ll = i / H, c = i - ll * H;
    if (s.l0 + ll >= L) continue;
    float v = 0.0f;
    for (int q = 0; q < spr; ++q) v += part[(ll * spr + q) * H + c];
    dA[((size_t)s.b * L + s.l0) * H + i] = v;
  }
}

// the slab's 16 rows of src (row stride H) into `rows` (MRS bytes a row) by
// cp.async, eight 16-byte copies a lane (committed by the caller)
__device__ __forceinline__ void stage_slab(unsigned char* rows, const bf16* __restrict__ src,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = lane + 32 * j, r = i >> 4, c = i & 15;
    cp_async16(rows + r * MRS + 16 * c, src + r * H + 8 * c);
  }
}

// Phase A of every bf16 backward: pre = acc (preset: A + Gn) + E W_e; y =
// cast(gelu(pre)), packed as gelu_pack packs it (gelu_exp's expression), ->
// s_h1; gelu'(pre) in f32 -> dg1, the slab's 2048 values in fragment order (n
// tile nt's float4 of a lane at dg1[32 nt]: 512 contiguous bytes a tile)
__device__ __forceinline__ void recompute_pre(float (&acc)[16][4], unsigned (&y)[16][2],
                                              const unsigned char* sE, const unsigned char* sWe,
                                              float4* dg1, bf16* __restrict__ s_h1,
                                              const Slab& s) {
  mma_edge_we(acc, sE, sWe, s);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    float gl[4], dg[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) gl[i] = gelu_and_grad(acc[nt][i], dg[i]);
    y[nt][0] = pack_bf16(gl[0], gl[1]);
    y[nt][1] = pack_bf16(gl[2], gl[3]);
    dg1[32 * nt] = make_float4(dg[0], dg[1], dg[2], dg[3]);
  }
  store_units(s_h1, y, s);
}

// Phase C of every bf16 backward, by quarters of pre's columns: dh1 = cast(dx2)
// W2^T (cast(dx2)'s A fragments from the slab's tile rows, W2^T from W2's own
// staging) and dpre = dh1 gelu'(pre) in f32 (gelu' back from dg1, the next
// quarter's loads in flight): dA's slab parts (red_w, by unit), dGn (two
// float4 atomics a row and quarter), s_dpre; dp <- cast(dpre), the A fragments
// of the dE product
__device__ __forceinline__ void dpre_quarters(unsigned (&dp)[16][2], const unsigned char* rows,
                                              const unsigned char* sW2, const float4* dg1,
                                              float* __restrict__ dGn,
                                              const int* __restrict__ idx, float* red_w,
                                              bf16* __restrict__ s_dpre, int N, const Slab& s) {
  const int lane = s.lane, g = lane >> 2, t4 = lane & 3, ri = reduced_index(lane);
  const unsigned x_addr = smem_addr(rows) + (lane & 15) * MRS + (lane >> 4) * 16;
  float* gd[2];  // dGn's rows j of rows g and g + 8, at unit 32 t4
#pragma unroll
  for (int h = 0; h < 2; ++h)
    gd[h] = dGn + ((size_t)s.b * N + min(max(idx[s.row0 + s.r0 + g + 8 * h], 0), N - 1)) * H +
            32 * t4;
  float4 nxt[4];
#pragma unroll
  for (int o = 0; o < 4; ++o) nxt[o] = dg1[32 * o];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float4 cur[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      cur[o] = nxt[o];
      if (q < 3) nxt[o] = dg1[32 * (4 * q + 4 + o)];
    }
    float dh[4][4];  // dh1 of n tiles 4 q .. 4 q + 3
    mma_wt<2>(dh, [&](int kk, unsigned (&af)[4]) { ldmatrix_x4(af, x_addr + 32 * kk); }, sW2,
              lane, 2 * q);
    float part[8];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const float dg[4] = {cur[o].x, cur[o].y, cur[o].z, cur[o].w};
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = dh[o][i] * dg[i];
      part[2 * o] = d[0] + d[2];
      part[2 * o + 1] = d[1] + d[3];
      dp[4 * q + o][0] = pack_bf16(d[0], d[1]);
      dp[4 * q + o][1] = pack_bf16(d[2], d[3]);
    }
    // cast(dpre) of units 32 t4 + 8 q .. + 7 (n tiles 4 q .. 4 q + 3) of
    // rows g and g + 8: two float4 atomics a row
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < 4; o += 2) {
        const float2 lo =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dp[4 * q + o][h]));
        const float2 hi =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dp[4 * q + o + 1][h]));
        atomicAdd(reinterpret_cast<float4*>(gd[h] + 8 * q + 2 * o),
                  make_float4(lo.x, lo.y, hi.x, hi.y));
      }
    reduce_rows(part, lane);
    red_w[32 * t4 + 8 * q + ri] = part[0];
  }
  store_units(s_dpre, dp, s);
}

// dE = cast(cast(dpre) W_e^T [+ dres]): W_e^T from W_e's own staging; with
// RES, dres (f32, fragment order, dres[32 nt]) added before the cast, as
// _chain_bwd_common adds de_extra. Staged in the slab's tile rows, then
// written in 16-byte stores.
template <bool RES>
__device__ __forceinline__ void edge_grad(const unsigned (&dp)[16][2], const unsigned char* sWe,
                                          unsigned char* rows, const float4* dres,
                                          bf16* __restrict__ dE, const Slab& s) {
  const int lane = s.lane, g = lane >> 2, t4 = lane & 3;
  float acc[16][4];
  mma_wt<8>(acc, [&](int kk, unsigned (&af)[4]) {
    af[0] = dp[2 * kk][0];
    af[1] = dp[2 * kk][1];
    af[2] = dp[2 * kk + 1][0];
    af[3] = dp[2 * kk + 1][1];
  }, sWe, lane, 0);
  if constexpr (RES) {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const float4 r = dres[32 * nt];
      acc[nt][0] += r.x;
      acc[nt][1] += r.y;
      acc[nt][2] += r.z;
      acc[nt][3] += r.w;
    }
  }
  __syncwarp();  // every lane's ldmatrix of the dx2 rows is done
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<unsigned*>(rows + (g + 8 * h) * MRS + 2 * (8 * nt + 2 * t4)) =
          pack_bf16(acc[nt][2 * h], acc[nt][2 * h + 1]);
  __syncwarp();
  write_slab(rows, dE + (s.row0 + s.r0) * H, lane);
}

// K3 for bf16 E (module note): K1's block and slabs; after product 1 each
// warp's tile rows hold its cast(dx2), then its dE. W3's rows for ds and the
// next quarter's gelu' are loaded ahead of the work that waits for them.
__global__ void __launch_bounds__(MNT, 2)
message_sum_bwd_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ E,
                           const bf16* __restrict__ Gn, const int* __restrict__ idx,
                           const float* __restrict__ mask, const bf16* __restrict__ We,
                           const bf16* __restrict__ W2, const float* __restrict__ b2,
                           const bf16* __restrict__ W3, const float* __restrict__ dout,
                           float* __restrict__ dA, bf16* __restrict__ dE,
                           float* __restrict__ dGn, bf16* __restrict__ s_h1,
                           bf16* __restrict__ s_dx2, bf16* __restrict__ s_dpre,
                           float* __restrict__ s_dg1, bf16* __restrict__ s_s,
                           bf16* __restrict__ s_dout, float* __restrict__ p_db, int L, int K,
                           int N, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sWe = smem;             // [H][MRS] W_e, columns in unit order
  unsigned char* sW2 = sWe + WBYTES;     // [H][MRS] W2, rows in unit order
  unsigned char* sE = sW2 + WBYTES;      // [MROWS][MRS] the edge tile
  float* sb2 = reinterpret_cast<float*>(sE + TBYTES);
  float* sdo = sb2 + H;
  float* sds = sdo + 8 * H;
  float* msum = sds + 8 * H;
  const Slab s = make_slab(L, K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = s.lane;
  const int g = lane >> 2;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int spr = K / 16;  // slabs a residue
  stage_we(sWe, We);
  stage_rows<true>(sW2, W2);
  stage_edges(sE, E, s);
  mma::cp_async_commit();
  load_vec(sb2, b2);
  // W3's rows 16 w .. 16 w + 15 for ds below (warp w), four columns a lane:
  // all sixteen 8-byte loads in flight through the prologue
  uint2 wv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    wv[i] = __ldg(reinterpret_cast<const uint2*>(W3 + (size_t)(16 * warp + i) * H + 4 * lane));

  // ---- the residues' cast(dout) (to s_dout: dW3's Y), mask counts, db3
  for (int i = tid; i < s.TL * H; i += MNT) {
    const int ll = i / H;
    float d = 0.0f;
    if (s.l0 + ll < L) {
      const size_t o = ((size_t)s.b * L + s.l0) * H + i;
      const bf16 v = __float2bfloat16(dout[o]);
      s_dout[o] = v;
      d = __bfloat162float(v);
    }
    sdo[i] = d;
  }
  if (warp < s.TL) {  // residue `warp`'s mask count: a sum of 0/1 values, exact in any order
    float v = 0.0f;
    if (s.l0 + warp < L)
      for (int k = lane; k < K; k += 32) v += mask[s.row0 + (size_t)warp * K + k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) msum[warp] = v;
  }
  __syncthreads();
  if (tid < H) {  // db3's tile part: sum_l (sum_k mask) dout, in f32 as on the TPU
    float v = 0.0f;
    for (int ll = 0; ll < s.TL; ++ll)
      if (s.l0 + ll < L) v += msum[ll] * dout[((size_t)s.b * L + s.l0 + ll) * H + tid];
    p_db[((size_t)n_tiles + tile) * H + tid] = v;
  }
  // ds = cast(dout) W3^T per residue (-> sds), while the tile arrives: warp
  // w takes the columns c = 16 w .. 16 w + 15, a lane four j of W3's row c,
  // summed over the warp by a butterfly
  {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 w01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv[i].x));
      const float2 w23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv[i].y));
      for (int ll = 0; ll < s.TL; ++ll) {
        const float4 d = *reinterpret_cast<const float4*>(sdo + ll * H + 4 * lane);
        float v = d.x * w01.x;
        v = fmaf(d.y, w01.y, v);
        v = fmaf(d.z, w23.x, v);
        v = fmaf(d.w, w23.y, v);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) sds[ll * H + 16 * warp + i] = v;
      }
    }
  }
  float acc[16][4];
  preset_pre(acc, A, Gn, idx, L, K, N, s);
  mma::cp_async_wait<0>();
  __syncthreads();  // the tile and ds are in place; every warp is done with cast(dout)

  // ---- A: pre, y = h1 (-> s_h1), gelu'(pre) (-> s_dg1)
  unsigned y[16][2];
  unsigned char* rows = sE + s.r0 * MRS;                        // the slab's tile rows
  float4* dg1 = reinterpret_cast<float4*>(s_dg1 + (s.row0 + s.r0) * H) + lane;
  if (s.active) recompute_pre(acc, y, sE, sWe, dg1, s_h1, s);

  // ---- B: x2 = y W2 in halves; s's slab parts, cast(dx2) into the slab's tile
  // rows (E is read no more) and from there to s_dx2, db2's slab parts
  float dbk[4];
  if (s.active) {
    const float m0 = mask[s.row0 + s.r0 + g], m8 = mask[s.row0 + s.r0 + g + 8];
    const float* ds = sds + (s.r0 / K) * H;
    __syncwarp();  // every lane's ldmatrix of its E rows is done
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float c2[8][4];
      mma_w2_half(c2, y, sW2, hf, lane);
      sum_bwd_half(c2, sb2, ds, m0, m8, hf, sdo + warp * H, dbk, rows, lane);
    }
    __syncwarp();
    write_slab(rows, s_dx2 + (s.row0 + s.r0) * H, lane);
  }
  __syncthreads();  // s's slab parts in sdo; every warp is done with ds
  // s = cast(the residue's slab parts summed in slab order) -> s_s (dW3's X)
  for (int i = tid; i < s.TL * H; i += MNT) {
    const int ll = i / H, c = i - ll * H;
    if (s.l0 + ll >= L) continue;
    float v = 0.0f;
    for (int q = 0; q < spr; ++q) v += sdo[(ll * spr + q) * H + c];
    s_s[((size_t)s.b * L + s.l0) * H + i] = __float2bfloat16(v);
  }
  if (s.active) {
#pragma unroll
    for (int j = 0; j < 4; ++j) sds[warp * H + quarter_col(j, lane)] = dbk[j];
  }
  __syncthreads();
  slab_order_sum(sds, s.nrows / 16, p_db + (size_t)tile * H);  // db2's tile part

  // ---- C: dh1, dpre (dA's slab parts -> sdo, dGn, s_dpre), then dE =
  // cast(cast(dpre) W_e^T)
  if (s.active) {
    unsigned dp[16][2];
    dpre_quarters(dp, rows, sW2, dg1, dGn, idx, sdo + warp * H, s_dpre, N, s);
    edge_grad<false>(dp, sWe, rows, nullptr, dE, s);
  }
  __syncthreads();  // dA's slab parts in sdo
  residue_sums(sdo, dA, L, spr, s);
}

// ---------------------------------------------------------------------------
// K6's backward and K4 / K5's backward in bf16 (module note): K3's block, slabs
// and phases A and C around the backward of the per-edge W3 product.

// product 2 at quarter q of x2's columns: c = y W2 at n tiles 4 q .. 4 q + 3
__device__ __forceinline__ void mma_w2_quarter(float (&c)[4][4], const unsigned (&y)[16][2],
                                               const unsigned char* sW2, int q, int lane) {
  const unsigned w2_addr = weight_addr(sW2, lane);
#pragma unroll
  for (int o = 0; o < 4; ++o) c[o][0] = c[o][1] = c[o][2] = c[o][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const unsigned a[4] = {y[2 * kk][0], y[2 * kk][1], y[2 * kk + 1][0], y[2 * kk + 1][1]};
    mma_step<2>(c, a, w2_addr, kk, 2 * q);
  }
}

// the packed bf16 pair v to row r, columns c and c + 1 of a [16][H] slab of
// device memory (a quad's four stores fill 16 contiguous bytes)
__device__ __forceinline__ void store_pair(bf16* __restrict__ slab, int r, int c, unsigned v) {
  *reinterpret_cast<unsigned*>(slab + r * H + c) = v;
}

__device__ __forceinline__ float2 bf16_pair(const void* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// K6: db3's slab parts, the cotangent dmsg (bf16, in the slab's tile rows)
// summed over rows g and g + 8, then the butterfly, as dx2's
__device__ __forceinline__ void dmsg_sums(const unsigned char* rows, float* dst, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float p[8];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int c = 8 * (4 * j + o) + 2 * t4;
      const float2 r0 = bf16_pair(rows + g * MRS + 2 * c);
      const float2 r8 = bf16_pair(rows + (g + 8) * MRS + 2 * c);
      p[2 * o] = r0.x + r8.x;
      p[2 * o + 1] = r0.y + r8.y;
    }
    reduce_rows(p, lane);
    dst[quarter_col(j, lane)] = p[0];
  }
}

// K4 / K5: x2 = y W2 + b2 in halves; h2 = cast(gelu(x2)), packed as the A
// fragments of the W3 product (h2_pack's arithmetic) and stored to the slab's
// s_h2 rows, and gelu'(x2) in f32 parked in dg2 in fragment order
__device__ __forceinline__ void x2_halves(unsigned (&h2)[16][2], const unsigned (&y)[16][2],
                                          const unsigned char* sW2, const float* sb2,
                                          float4* dg2, bf16* __restrict__ h2_slab, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float c2[8][4];
    mma_w2_half(c2, y, sW2, hf, lane);
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int nt = 8 * hf + o, c = 8 * nt + 2 * t4;
      const float2 bias = *reinterpret_cast<const float2*>(sb2 + c);
      float h[4], dg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[i] = gelu_and_grad(c2[o][i] + (i & 1 ? bias.y : bias.x), dg[i]);
      h2[nt][0] = pack_bf16(h[0], h[1]);
      h2[nt][1] = pack_bf16(h[2], h[3]);
      dg2[32 * nt] = make_float4(dg[0], dg[1], dg[2], dg[3]);
      store_pair(h2_slab, g, c, h2[nt][0]);
      store_pair(h2_slab, g + 8, c, h2[nt][1]);
    }
  }
}

// K4 / K5, first pass over acc = cast(h2) W3: msg = (acc + b3) x keep, resid =
// E + msg (E from the slab's tile rows), ln = LN(resid) (eps 1e-6) into acc,
// with rstd; then with dct = dout: dsh's (dct g) and dsc's (dct g ln) slab
// parts into psh, psc, and the row means m1 of dln = dct g (1 + sc) and m2 of
// dln ln. Row sums: the lane's 32 columns in order, then the quad (K2's
// lnmod_out). vec holds b2, b3, sc, g.
template <int DROP>
__device__ __forceinline__ void ln_pass1(float (&acc)[16][4], float (&rstd)[2], float (&m1)[2],
                                         float (&m2)[2], unsigned (&km)[2],
                                         const unsigned char* rows, const float* vec,
                                         const bf16* __restrict__ keep, uint32_t key,
                                         uint32_t thresh, float kscale,
                                         const bf16* __restrict__ dct_slab, float* psh,
                                         float* psc, int K, const Slab& s) {
  const int lane = s.lane, g = lane >> 2, t4 = lane & 3;
  const float *sb3 = vec + H, *ssc = vec + 2 * H, *sg = vec + 3 * H;
  float mean[2] = {0.0f, 0.0f};
  km[0] = km[1] = 0u;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = 8 * nt + 2 * t4;
    const float2 bias = *reinterpret_cast<const float2*>(sb3 + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 e = bf16_pair(rows + (g + 8 * h) * MRS + 2 * c);
      float x0 = acc[nt][2 * h] + bias.x, x1 = acc[nt][2 * h + 1] + bias.y;
      if constexpr (DROP != 0) {
        const float2 kp = keep_pair<DROP>(keep, key, thresh, kscale, km, K, nt, h, c, s);
        x0 *= kp.x;
        x1 *= kp.y;
      }
      acc[nt][2 * h] = e.x + x0;
      acc[nt][2 * h + 1] = e.y + x1;
      mean[h] += acc[nt][2 * h];
      mean[h] += acc[nt][2 * h + 1];
    }
  }
  float var[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] += __shfl_xor_sync(0xffffffffu, mean[h], 1);
    mean[h] += __shfl_xor_sync(0xffffffffu, mean[h], 2);
    mean[h] = mean[h] / H;
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = acc[nt][2 * h + e] - mean[h];
        var[h] += d * d;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    var[h] += __shfl_xor_sync(0xffffffffu, var[h], 1);
    var[h] += __shfl_xor_sync(0xffffffffu, var[h], 2);
    rstd[h] = rsqrtf(var[h] / H + 1e-6f);
  }
  __syncwarp();  // every lane has read its E
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = (acc[nt][i] - mean[i >> 1]) * rstd[i >> 1];
  float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float ph[8], pc[8];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int nt = 4 * j + o, c = 8 * nt + 2 * t4;
      const float2 gv = *reinterpret_cast<const float2*>(sg + c);
      const float2 scv = *reinterpret_cast<const float2*>(ssc + c);
      const float2 d0 = bf16_pair(dct_slab + g * H + c);
      const float2 d8 = bf16_pair(dct_slab + (g + 8) * H + c);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float gg = e ? gv.y : gv.x, sc1 = 1.0f + (e ? scv.y : scv.x);
        const float ln0 = acc[nt][e], ln8 = acc[nt][2 + e];
        const float dgo0 = (e ? d0.y : d0.x) * gg, dgo8 = (e ? d8.y : d8.x) * gg;
        ph[2 * o + e] = dgo0 + dgo8;
        pc[2 * o + e] = dgo0 * ln0 + dgo8 * ln8;
        const float dln0 = dgo0 * sc1, dln8 = dgo8 * sc1;
        s1[0] += dln0;
        s2[0] += dln0 * ln0;
        s1[1] += dln8;
        s2[1] += dln8 * ln8;
      }
    }
    reduce_rows(ph, lane);
    reduce_rows(pc, lane);
    psh[quarter_col(j, lane)] = ph[0];
    psc[quarter_col(j, lane)] = pc[0];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 1);
    s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 2);
    s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 1);
    s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 2);
    m1[h] = s1[h] / H;
    m2[h] = s2[h] / H;
  }
}

// K4 / K5, second pass over acc = ln: dgate's slab parts (dct ln (1 + sc))
// into pdg; dresid = rstd (dln - m1 - ln m2) in f32 into acc and parked in
// dres (fragment order) for dE; dmsg = dresid x keep: db3's slab parts (f32)
// into pdb, and cast(dmsg) into the slab's tile rows and from there to the
// slab's s_dmsg rows (dW3's Y)
template <int DROP>
__device__ __forceinline__ void ln_pass2(float (&acc)[16][4], const float (&rstd)[2],
                                         const float (&m1)[2], const float (&m2)[2],
                                         const unsigned (&km)[2], unsigned char* rows,
                                         const float* vec, const bf16* __restrict__ keep,
                                         float kscale, const bf16* __restrict__ dct_slab,
                                         float4* dres, float* pdg, float* pdb,
                                         bf16* __restrict__ dmsg_slab, const Slab& s) {
  const int lane = s.lane, g = lane >> 2, t4 = lane & 3;
  const float *ssc = vec + 2 * H, *sg = vec + 3 * H;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float pg[8], pb[8];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int nt = 4 * j + o, c = 8 * nt + 2 * t4;
      const float2 gv = *reinterpret_cast<const float2*>(sg + c);
      const float2 scv = *reinterpret_cast<const float2*>(ssc + c);
      float dm[2][2], dgt[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 d = bf16_pair(dct_slab + (g + 8 * h) * H + c);
        float2 kp = make_float2(1.0f, 1.0f);
        if constexpr (DROP == 1) kp = bf16_pair(keep + (s.row0 + s.r0 + g + 8 * h) * H + c);
        if constexpr (DROP == 2)
          kp = make_float2((km[h] >> (2 * nt)) & 1u ? kscale : 0.0f,
                           (km[h] >> (2 * nt + 1)) & 1u ? kscale : 0.0f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dct = e ? d.y : d.x, sc1 = 1.0f + (e ? scv.y : scv.x);
          const float ln = acc[nt][2 * h + e];
          const float dln = (dct * (e ? gv.y : gv.x)) * sc1;
          const float dr = rstd[h] * ((dln - m1[h]) - ln * m2[h]);
          dgt[h][e] = dct * (ln * sc1);
          acc[nt][2 * h + e] = dr;
          dm[h][e] = DROP != 0 ? dr * (e ? kp.y : kp.x) : dr;
        }
        *reinterpret_cast<unsigned*>(rows + (g + 8 * h) * MRS + 2 * c) =
            pack_bf16(dm[h][0], dm[h][1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pg[2 * o + e] = dgt[0][e] + dgt[1][e];
        pb[2 * o + e] = dm[0][e] + dm[1][e];
      }
      dres[32 * nt] = make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
    }
    reduce_rows(pg, lane);
    reduce_rows(pb, lane);
    pdg[quarter_col(j, lane)] = pg[0];
    pdb[quarter_col(j, lane)] = pb[0];
  }
  __syncwarp();
  write_slab(rows, dmsg_slab, lane);
}

// dh2 = cast(dmsg) W3^T by quarters of x2's columns (cast(dmsg)'s A fragments
// from the slab's tile rows; W3^T from W3's own staging, rows as they are, so
// dh2 has x2's natural column order) and dx2 = dh2 gelu'(x2) in f32: its slab
// column sums (db2's parts, dbk[q]) and cast(dx2), staged in the tile rows once
// the last quarter's dh2 is done and written to the slab's s_dx2 rows. RAW
// (K6): x2 = y W2 + b2 of each quarter here (c2 holds quarter 0's on entry),
// h2 = cast(gelu(x2)) to the slab's s_h2 rows and gelu'(x2) from the same exp;
// else (K4 / K5) gelu'(x2) comes back from dg2, the next quarter's in flight
// (y, c2, sb2 and h2_slab are not read).
template <bool RAW>
__device__ __forceinline__ void dx2_quarters(float (&dbk)[4], float (&c2)[4][4],
                                             const unsigned (&y)[16][2],
                                             const unsigned char* sW2, const float* sb2,
                                             unsigned char* rows, const unsigned char* sW3,
                                             const float4* dg2, bf16* __restrict__ h2_slab,
                                             bf16* __restrict__ dx2_slab, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const unsigned x_addr = smem_addr(rows) + (lane & 15) * MRS + (lane >> 4) * 16;
  unsigned dxp[16][2];
  float4 nxt[4];
  if constexpr (!RAW) {
#pragma unroll
    for (int o = 0; o < 4; ++o) nxt[o] = dg2[32 * o];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float4 cur[4];
    if constexpr (RAW) {
      if (q > 0) mma_w2_quarter(c2, y, sW2, q, lane);
    } else {
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        cur[o] = nxt[o];
        if (q < 3) nxt[o] = dg2[32 * (4 * q + 4 + o)];
      }
    }
    float dh[4][4];  // dh2 of n tiles 4 q .. 4 q + 3
    mma_wt<2>(dh, [&](int kk, unsigned (&af)[4]) { ldmatrix_x4(af, x_addr + 32 * kk); }, sW3,
              lane, 2 * q);
    float dp[8];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int nt = 4 * q + o, c = 8 * nt + 2 * t4;
      float dg[4];
      if constexpr (RAW) {
        const float2 bias = *reinterpret_cast<const float2*>(sb2 + c);
        float h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          h[i] = gelu_and_grad(c2[o][i] + (i & 1 ? bias.y : bias.x), dg[i]);
        store_pair(h2_slab, g, c, pack_bf16(h[0], h[1]));
        store_pair(h2_slab, g + 8, c, pack_bf16(h[2], h[3]));
      } else {
        dg[0] = cur[o].x;
        dg[1] = cur[o].y;
        dg[2] = cur[o].z;
        dg[3] = cur[o].w;
      }
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = dh[o][i] * dg[i];
      dp[2 * o] = d[0] + d[2];
      dp[2 * o + 1] = d[1] + d[3];
      dxp[nt][0] = pack_bf16(d[0], d[1]);
      dxp[nt][1] = pack_bf16(d[2], d[3]);
    }
    reduce_rows(dp, lane);
    dbk[q] = dp[0];
  }
  __syncwarp();  // every lane's ldmatrix of the dmsg rows is done
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<unsigned*>(rows + (g + 8 * h) * MRS + 2 * (8 * nt + 2 * t4)) = dxp[nt][h];
  __syncwarp();
  write_slab(rows, dx2_slab, lane);
}

// The edge backwards' tail, in every thread of the block, once cast(dx2) is
// in each slab's tile rows and db2's slab parts in dbk: W_e restaged into sW0
// (W3's buffer) while phase C's dh1 quarters run (dA's slab parts to
// part[1]); then dE = cast(cast(dpre) W_e^T [+ dres]); db2's tile part (to
// db2_tile) and dA. part is [2][MW][H] f32, free on entry.
template <bool RES>
__device__ __forceinline__ void edge_bwd_tail(const float (&dbk)[4], unsigned char* sW0,
                                              const unsigned char* sW2,
                                              const bf16* __restrict__ We, unsigned char* rows,
                                              float* part, const float4* dg1, const float4* dres,
                                              const int* __restrict__ idx,
                                              float* __restrict__ dA, bf16* __restrict__ dE,
                                              float* __restrict__ dGn,
                                              bf16* __restrict__ s_dpre,
                                              float* __restrict__ db2_tile, int L, int K, int N,
                                              const Slab& s) {
  const int warp = threadIdx.x >> 5, lane = s.lane;
  __syncthreads();  // every warp is done with W3
  stage_we(sW0, We);
  mma::cp_async_commit();
  unsigned dp[16][2];
  if (s.active) {
#pragma unroll
    for (int j = 0; j < 4; ++j) part[warp * H + quarter_col(j, lane)] = dbk[j];
    dpre_quarters(dp, rows, sW2, dg1, dGn, idx, part + (MW + warp) * H, s_dpre, N, s);
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // W_e in place; db2's slab parts in part[0]
  slab_order_sum(part, s.nrows / 16, db2_tile);
  if (s.active) edge_grad<RES>(dp, sW0, rows, dres, dE, s);
  __syncthreads();  // dA's slab parts in part[1]
  residue_sums(part + MW * H, dA, L, K / 16, s);
}

// K6's backward for bf16 E: dmsg is the cotangent, staged into each warp's own
// tile rows once product 1 has read its E rows; product 2 and dh2 run
// quarter by quarter, so gelu'(x2) never leaves registers. dW3's Y is the
// cotangent itself.
__global__ void __launch_bounds__(MNT, 2)
message_edge_bwd_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ E,
                            const bf16* __restrict__ Gn, const int* __restrict__ idx,
                            const bf16* __restrict__ We, const bf16* __restrict__ W2,
                            const float* __restrict__ b2, const bf16* __restrict__ W3,
                            const bf16* __restrict__ dout, float* __restrict__ dA,
                            bf16* __restrict__ dE, float* __restrict__ dGn,
                            bf16* __restrict__ s_h1, bf16* __restrict__ s_dx2,
                            bf16* __restrict__ s_dpre, bf16* __restrict__ s_h2,
                            float* __restrict__ s_dg1, float* __restrict__ p_db, int L, int K,
                            int N, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sW0 = smem;             // W_e (columns in unit order), W3, W_e again
  unsigned char* sW2 = sW0 + WBYTES;     // W2, rows in unit order
  unsigned char* sE = sW2 + WBYTES;      // E; then each warp's dmsg, cast(dx2), dE
  float* sb2 = reinterpret_cast<float*>(sE + TBYTES);
  float* part = sb2 + H;                 // [2][MW][H] slab parts of column sums
  const Slab s = make_slab(L, K);
  const int warp = threadIdx.x >> 5, lane = s.lane;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const size_t srow = s.row0 + s.r0;     // the slab's first edge row
  stage_we(sW0, We);
  stage_rows<true>(sW2, W2);
  stage_edges(sE, E, s);
  mma::cp_async_commit();
  load_vec(sb2, b2);
  float acc[16][4];
  preset_pre(acc, A, Gn, idx, L, K, N, s);
  mma::cp_async_wait<0>();
  __syncthreads();

  unsigned y[16][2];
  unsigned char* rows = sE + s.r0 * MRS;
  float4* dg1 = reinterpret_cast<float4*>(s_dg1 + srow * H) + lane;
  if (s.active) {
    recompute_pre(acc, y, sE, sW0, dg1, s_h1, s);
    __syncwarp();  // every lane's ldmatrix of its E rows is done
    stage_slab(rows, dout + srow * H, lane);
  }
  mma::cp_async_commit();
  __syncthreads();  // every warp is done with W_e
  stage_rows<false>(sW0, W3);
  mma::cp_async_commit();
  float c2[4][4];
  if (s.active) {
    mma::cp_async_wait<1>();
    __syncwarp();  // the warp's dmsg rows are in place
    dmsg_sums(rows, part + (MW + warp) * H, lane);
    mma_w2_quarter(c2, y, sW2, 0, lane);
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // W3 in place; db3's slab parts in part[1]
  slab_order_sum(part + MW * H, s.nrows / 16, p_db + ((size_t)n_tiles + tile) * H);
  float dbk[4];
  if (s.active)
    dx2_quarters<true>(dbk, c2, y, sW2, sb2, rows, sW0, nullptr, s_h2 + srow * H,
                       s_dx2 + srow * H, lane);
  edge_bwd_tail<false>(dbk, sW0, sW2, We, rows, part, dg1, nullptr, idx, dA, dE, dGn, s_dpre,
                       p_db + (size_t)tile * H, L, K, N, s);
}

// K4 (DROP 0) and K5's backward (DROP 1: `keep`; DROP 2: the mask from `seeds`)
// for bf16 E: the W3 product recomputed on h2 in registers, the LayerNorm and
// its backward in fragment layout (a row's columns in the 4 lanes of a quad),
// gelu'(x2) and dresid parked in f32 scratch in fragment order.
template <int DROP>
__global__ void __launch_bounds__(MNT, 2)
message_edge_lnmod_bwd_mma_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ E, const bf16* __restrict__ Gn,
    const int* __restrict__ idx, const bf16* __restrict__ We, const bf16* __restrict__ W2,
    const float* __restrict__ b2, const bf16* __restrict__ W3, const float* __restrict__ b3,
    const float* __restrict__ sc, const float* __restrict__ gate,
    const bf16* __restrict__ keep, const int* __restrict__ seeds, uint32_t thresh,
    float kscale, const bf16* __restrict__ dout, float* __restrict__ dA,
    bf16* __restrict__ dE, float* __restrict__ dGn, bf16* __restrict__ s_h1,
    bf16* __restrict__ s_dx2, bf16* __restrict__ s_dpre, bf16* __restrict__ s_h2,
    bf16* __restrict__ s_dmsg, float* __restrict__ s_dg1, float* __restrict__ s_dg2,
    float* __restrict__ s_dres, float* __restrict__ p_db, float* __restrict__ p_mod, int L,
    int K, int N, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sW0 = smem;             // W_e (columns in unit order), W3, W_e again
  unsigned char* sW2 = sW0 + WBYTES;     // W2, rows in unit order
  unsigned char* sE = sW2 + WBYTES;      // E; then each warp's cast(dmsg), cast(dx2), dE
  float* vec = reinterpret_cast<float*>(sE + TBYTES);  // b2, b3, sc, g of sample b
  float* part = vec + 4 * H;             // [2][MW][H] slab parts of column sums
  const Slab s = make_slab(L, K);
  const int warp = threadIdx.x >> 5, lane = s.lane;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int nslab = s.nrows / 16;
  const size_t srow = s.row0 + s.r0;     // the slab's first edge row
  stage_we(sW0, We);
  stage_rows<true>(sW2, W2);
  stage_edges(sE, E, s);
  mma::cp_async_commit();
  load_vec(vec, b2);
  load_vec(vec + H, b3);
  load_vec(vec + 2 * H, sc + (size_t)s.b * H);
  load_vec(vec + 3 * H, gate + (size_t)s.b * H);
  float acc[16][4];
  preset_pre(acc, A, Gn, idx, L, K, N, s);
  mma::cp_async_wait<0>();
  __syncthreads();

  unsigned y[16][2];
  unsigned char* rows = sE + s.r0 * MRS;
  float4* dg1 = reinterpret_cast<float4*>(s_dg1 + srow * H) + lane;
  float4* dg2 = reinterpret_cast<float4*>(s_dg2 + srow * H) + lane;
  float4* dres = reinterpret_cast<float4*>(s_dres + srow * H) + lane;
  if (s.active) recompute_pre(acc, y, sE, sW0, dg1, s_h1, s);
  __syncthreads();  // every warp is done with W_e
  stage_rows<false>(sW0, W3);
  mma::cp_async_commit();
  unsigned h2[16][2];
  if (s.active) x2_halves(h2, y, sW2, vec, dg2, s_h2 + srow * H, lane);
  mma::cp_async_wait<0>();
  __syncthreads();  // W3 in place

  float rstd[2], m1[2], m2[2];
  unsigned km[2];
  const uint32_t key = DROP == 2 ? sample_key(seeds[s.b], s.b) : 0u;
  const bf16* dct_slab = dout + srow * H;
  if (s.active) {
    mma_w3(acc, h2, sW0, lane);
    ln_pass1<DROP>(acc, rstd, m1, m2, km, rows, vec, keep, key, thresh, kscale, dct_slab,
                   part + warp * H, part + (MW + warp) * H, K, s);
  }
  __syncthreads();  // dsh's and dsc's slab parts in part
  float* pm = p_mod + (size_t)tile * H;
  slab_order_sum(part, nslab, pm);
  slab_order_sum(part + MW * H, nslab, pm + (size_t)n_tiles * H);
  __syncthreads();  // part is free
  if (s.active)
    ln_pass2<DROP>(acc, rstd, m1, m2, km, rows, vec, keep, kscale, dct_slab, dres,
                   part + warp * H, part + (MW + warp) * H, s_dmsg + srow * H, s);
  __syncthreads();  // dgate's and db3's slab parts in part
  slab_order_sum(part, nslab, pm + (size_t)2 * n_tiles * H);
  slab_order_sum(part + MW * H, nslab, p_db + ((size_t)n_tiles + tile) * H);
  __syncthreads();  // part is free
  float dbk[4], c2[4][4];  // c2: K6's (not read here)
  if (s.active)
    dx2_quarters<false>(dbk, c2, y, sW2, vec, rows, sW0, dg2, nullptr, s_dx2 + srow * H, lane);
  edge_bwd_tail<true>(dbk, sW0, sW2, We, rows, part, dg1, dres, idx, dA, dE, dGn, s_dpre,
                      p_db + (size_t)tile * H, L, K, N, s);
}

// The weight-grad pass of every bf16 backward: part[z][chunk] = X_z^T Y_z over
// the chunk's rows, mma.m16n8k16 from a ring of GSTAGES stages of GROWS rows of
// X and Y (cp.async, rows past the chunk zero); a warp owns a 32 x 64 block of
// the [H, H] partial (Xᵀ's A fragments by ldmatrix.trans from X's rows, Y's B
// fragments by ldmatrix.trans), f32 sums in the rows' order. sum_partials then
// adds the chunks in a fixed order, so the weight grads repeat bit for bit.
constexpr int GROWS = 32;
constexpr int GSTAGES = 4;
constexpr int GSTAGE = 2 * GROWS * MRS;
constexpr int GSMEM = GSTAGES * GSTAGE;

__global__ void __launch_bounds__(MNT, 2)
wgrad_mma_kernel(Pairs<bf16> p, int n_chunks, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = blockIdx.y, chunk = blockIdx.x;
  const bf16* X = p.X[z];
  const bf16* Y = p.Y[z];
  const long long M = p.M[z];
  const long long per = ((M + n_chunks - 1) / n_chunks + GROWS - 1) / GROWS * GROWS;
  const long long m_begin = min(M, chunk * per);
  const long long m_end = min(M, m_begin + per);
  const int n_steps = (int)((m_end - m_begin + GROWS - 1) / GROWS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = 32 * (warp & 3), j0 = 64 * (warp >> 2);
  auto issue = [&](int st) {
    if (st < n_steps) {
      unsigned char* buf = smem + (st % GSTAGES) * GSTAGE;
      const long long m0 = m_begin + (long long)st * GROWS;
      for (int i = tid; i < 2 * GROWS * (H / 8); i += MNT) {
        const int w = i / (GROWS * (H / 8)), rr = (i / (H / 8)) % GROWS, c = i % (H / 8);
        unsigned char* d = buf + (w * GROWS + rr) * MRS + 16 * c;
        if (m0 + rr < m_end) cp_async16(d, (w ? Y : X) + (m0 + rr) * H + 8 * c);
        else *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
      }
    }
    mma::cp_async_commit();
  };
  float acc[2][8][4];
#pragma unroll
  for (int ti = 0; ti < 2; ++ti)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[ti][nt][0] = acc[ti][nt][1] = acc[ti][nt][2] = acc[ti][nt][3] = 0.0f;
  for (int st = 0; st < GSTAGES - 1; ++st) issue(st);
  const int mi = lane >> 3;
  // A (X^T) fragment of i tile ti: X rows 8 (mi >> 1) + 0..7, columns i0 + 16 ti
  // + 8 (mi & 1); B (Y) fragments of n tiles 2 np, 2 np + 1: Y rows 8 (mi & 1) +
  // 0..7, columns j0 + 16 np + 8 (mi >> 1)
  const unsigned a_off = (8 * (mi >> 1) + (lane & 7)) * MRS + 2 * (i0 + 8 * (mi & 1));
  const unsigned b_off = (8 * (mi & 1) + (lane & 7)) * MRS + 2 * (j0 + 8 * (mi >> 1));
  for (int st = 0; st < n_steps; ++st) {
    mma::cp_async_wait<GSTAGES - 2>();
    __syncthreads();  // stage st in place; every warp is done with stage st - 1
    issue(st + GSTAGES - 1);
    const unsigned sx = smem_addr(smem + (st % GSTAGES) * GSTAGE), sy = sx + GROWS * MRS;
#pragma unroll
    for (int ks = 0; ks < GROWS / 16; ++ks) {
      unsigned a[2][4];
#pragma unroll
      for (int ti = 0; ti < 2; ++ti) ldmatrix_x4_trans(a[ti], sx + a_off + 16 * ks * MRS + 32 * ti);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned bb[4];
        ldmatrix_x4_trans(bb, sy + b_off + 16 * ks * MRS + 32 * np);
#pragma unroll
        for (int ti = 0; ti < 2; ++ti) {
          mma_bf16(acc[ti][2 * np], a[ti], bb[0], bb[1]);
          mma_bf16(acc[ti][2 * np + 1], a[ti], bb[2], bb[3]);
        }
      }
    }
  }
  const int g = lane >> 2, t4 = lane & 3;
  float* dst = part + ((size_t)z * n_chunks + chunk) * H * H;
#pragma unroll
  for (int ti = 0; ti < 2; ++ti)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int r = i0 + 16 * ti + g, c = j0 + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(dst + r * H + c) = make_float2(acc[ti][nt][0], acc[ti][nt][1]);
      *reinterpret_cast<float2*>(dst + (r + 8) * H + c) =
          make_float2(acc[ti][nt][2], acc[ti][nt][3]);
    }
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores in 3xTF32 (chain_tf32.cuh; module note): K3 and
// K4 / K5's backward in two passes each, pass 1 with the forward's weights
// (`message_sum_bwd_f32_mma_kernel`, `message_edge_lnmod_bwd_f32_mma_kernel`),
// pass 2 with the transposed ones (`data_grads_f32_mma_kernel`), and the
// weight-grad pass of every f32 backward (`wgrad_f32_mma_kernel`). A block
// of 8 warps stages its weights once and its warps walk over residues, each
// residue's slabs in order, so its column sums repeat bit for bit.

namespace tf = chain_tf32;

// K3's pass 1: W_e, W2 (fragment order), W3^T (row-major, ds on CUDA cores),
// b2, and a warp's [2][H] (its residue's dout, then ds)
constexpr int F3SMEM = (3 * tf::WFLOATS + H + 2 * tf::TW * H) * 4;
// K4 / K5's pass 1: K2's weights and vectors
constexpr int F4SMEM = (3 * tf::WFLOATS + 2 * H) * 4;
// pass 2: W2^T, W_e^T (and W3^T at EDGE)
constexpr int fd_smem(bool edge) { return (edge ? 3 : 2) * tf::WFLOATS * 4; }

// the 4 floats of row r (f32, row stride H) at column c, or zeros where
// the row is padding
__device__ __forceinline__ float4 row4(const float* __restrict__ X, size_t r, int c, bool ok) {
  return ok ? *reinterpret_cast<const float4*>(X + r * H + c)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ float2 row2(const float* __restrict__ X, size_t r, int c, bool ok) {
  return ok ? *reinterpret_cast<const float2*>(X + r * H + c) : make_float2(0.0f, 0.0f);
}

// v = gelu(v) in place and dg = gelu'(v), from one exp an element (the
// passes 1 run this one copy for pre and for x2 + b2)
__device__ __forceinline__ void gelu_in_place(float (&v)[16][4], float (&dg)[16][4]) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[nt][i] = gelu_and_grad(v[nt][i], dg[nt][i]);
}

// the slab's rows of v (pre's unit order: a lane's 32 columns of a row are
// units 32 t4 .. 32 t4 + 31) to X at their hidden units, float4 stores
__device__ __forceinline__ void store_units(float* __restrict__ X, const float (&v)[16][4],
                                            const tf::Slab& s) {
  const int g = s.lane >> 2, t4 = s.lane & 3;
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (g + 8 * h < s.nrow)
        *reinterpret_cast<float4*>(X + (s.row0 + g + 8 * h) * H + 32 * t4 + 4 * m) =
            make_float4(v[2 * m][2 * h], v[2 * m][2 * h + 1], v[2 * m + 1][2 * h],
                        v[2 * m + 1][2 * h + 1]);
}

// the slab's rows of v (natural columns) to X, float2 stores
__device__ __forceinline__ void store_natural(float* __restrict__ X, const float (&v)[16][4],
                                              const tf::Slab& s) {
  const int g = s.lane >> 2, t4 = s.lane & 3;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (g + 8 * h < s.nrow)
        *reinterpret_cast<float2*>(X + (s.row0 + g + 8 * h) * H + 8 * nt + 2 * t4) =
            make_float2(v[nt][2 * h], v[nt][2 * h + 1]);
}

// v += b (natural columns; b in shared memory)
__device__ __forceinline__ void add_bias(float (&v)[16][4], const float* b, int lane) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float2 bias = *reinterpret_cast<const float2*>(b + 8 * nt + 2 * (lane & 3));
    v[nt][0] += bias.x;
    v[nt][1] += bias.y;
    v[nt][2] += bias.x;
    v[nt][3] += bias.y;
  }
}

// x = acc, then acc = 0: a product's output becomes the next one's A
// operand (the accumulator layout is the A fragment layout, chain_tf32.cuh)
__device__ __forceinline__ void pass_on(float (&x)[16][4], float (&acc)[16][4]) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[nt][i] = acc[nt][i];
      acc[nt][i] = 0.0f;
    }
}

// v[j], a lane's column sum after quarter j's reduce_rows, to the row dst
// [H] at the lane's column quarter_col(j, lane)
__device__ __forceinline__ void store_sums(float* __restrict__ dst, const float (&v)[4],
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[quarter_col(j, lane)] = v[j];
}

// p[j] += the slab's column sums of v (accumulator layout; padding rows
// zero) over quarter j: rows g and g + 8, then the butterfly over g
// (reduce_rows); the lane's column quarter_col(j, lane)
__device__ __forceinline__ void slab_sums(float (&p)[4], const float (&v)[16][4], int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float q[8];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      q[2 * o] = v[4 * j + o][0] + v[4 * j + o][2];
      q[2 * o + 1] = v[4 * j + o][1] + v[4 * j + o][3];
    }
    reduce_rows(q, lane);
    p[j] += q[0];
  }
}

// K3, pass 1 (module note): a warp's residue: ds = dout W3^T on CUDA cores,
// db3's part (the mask count times dout); each slab: pre, h1 (-> s_h1) and
// gelu'(pre) (-> s_dg1), x2, then h2 = gelu(x2 + b2) and gelu'(x2) from one
// exp: mask h2 summed for s, dx2 = (ds mask) gelu'(x2) (-> s_dx2) summed for
// db2; the residue's s (-> s_s) and db2 part after its last slab.
__global__ void __launch_bounds__(tf::TNT, 1)
message_sum_bwd_f32_mma_kernel(const float* __restrict__ A, const float* __restrict__ E,
                               const float* __restrict__ Gn, const int* __restrict__ idx,
                               const float* __restrict__ mask, const float* __restrict__ We,
                               const float* __restrict__ W2, const float* __restrict__ b2,
                               const float* __restrict__ W3T, const float* __restrict__ dout,
                               float* __restrict__ s_h1, float* __restrict__ s_dg1,
                               float* __restrict__ s_dx2, float* __restrict__ s_s,
                               float* __restrict__ p_db, int B, int L, int K, int N) {
  extern __shared__ __align__(16) float fsm[];
  float* sWe = fsm;
  float* sW2 = sWe + tf::WFLOATS;
  float* sW3T = sW2 + tf::WFLOATS;   // W3^T row-major: ds's step j reads row j
  float* sb2 = sW3T + tf::WFLOATS;
  tf::stage_frag<false, true>(sWe, We);
  tf::stage_frag<true, false>(sW2, W2);
  for (int i = threadIdx.x; i < H * H / 4; i += tf::TNT)
    reinterpret_cast<float4*>(sW3T)[i] = __ldg(reinterpret_cast<const float4*>(W3T) + i);
  tf::load_vec(sb2, b2);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float* sdo = sb2 + H + 2 * warp * H;  // the warp's residue's dout
  float* sds = sdo + H;                 // its ds
  const int spr = (K + 15) / 16;        // slabs a residue
  const long long n_res = (long long)B * L;
  for (long long res = (long long)blockIdx.x * tf::TW + warp; res < n_res;
       res += (long long)gridDim.x * tf::TW) {
    const int b = (int)(res / L), l = (int)(res - (long long)b * L);
    const float4 d4 = __ldg(reinterpret_cast<const float4*>(dout + res * H) + lane);
    // db3's part: the residue's mask count (0 / 1 values: exact in any order) x dout
    const size_t er = (size_t)res * K;
    float mc = (lane < K ? __ldg(mask + er + lane) : 0.0f) +
               (lane + 32 < K ? __ldg(mask + er + lane + 32) : 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mc += __shfl_xor_sync(0xffffffffu, mc, off);
    reinterpret_cast<float4*>(p_db + (n_res + res) * H)[lane] =
        make_float4(mc * d4.x, mc * d4.y, mc * d4.z, mc * d4.w);
    __syncwarp();  // every lane is done with the last residue's dout and ds
    reinterpret_cast<float4*>(sdo)[lane] = d4;
    __syncwarp();
    // ds = dout W3^T: the lane's columns 4 lane .. 4 lane + 3, j in order
    float4 ds = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int j = 0; j < H; ++j) {
      const float d = sdo[j];
      const float4 w = reinterpret_cast<const float4*>(sW3T + j * H)[lane];
      ds.x = fmaf(d, w.x, ds.x);
      ds.y = fmaf(d, w.y, ds.y);
      ds.z = fmaf(d, w.z, ds.z);
      ds.w = fmaf(d, w.w, ds.w);
    }
    reinterpret_cast<float4*>(sds)[lane] = ds;
    __syncwarp();
    float ssum[4] = {0.0f, 0.0f, 0.0f, 0.0f}, db2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int q = 0; q < spr; ++q) {
      const tf::Slab s = tf::make_slab(b, l, q, L, K, lane);
      // pre = A[l] + Gn[idx] + E W_e, then x2 = h1 W2 + b2, each then gelu
      // and gelu' from one exp: one copy of the product's and the gelu's code
      // for both (a kernel of unrolled copies outgrows the instruction
      // cache). x is passed on at the end of either, so it holds nothing
      // live through the epilogues.
      float x[16][4], acc[16][4];
      tf::load_rows(x, E, s);
      tf::preset(acc, A, Gn, idx, L, N, s);
      const bool ok0 = g < s.nrow, ok8 = g + 8 < s.nrow;
      const float m0 = ok0 ? __ldg(mask + s.row0 + g) : 0.0f;
      const float m8 = ok8 ? __ldg(mask + s.row0 + g + 8) : 0.0f;
#pragma unroll 1
      for (int p = 0; p < 2; ++p) {
        tf::mma_slab(acc, x, p == 0 ? sWe : sW2, lane);
        if (p == 1) add_bias(acc, sb2, lane);
        float dg[16][4];
        gelu_in_place(acc, dg);
        if (p == 0) {   // h1 (-> s_h1, dW2's X), gelu'(pre) (-> s_dg1, parked)
          store_units(s_h1, acc, s);
          store_units(s_dg1, dg, s);
        } else {
          // mask h2 summed for s, dx2 = (ds mask) gelu'(x2) (-> s_dx2)
          // summed for db2
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float qs[8], qd[8];
#pragma unroll
            for (int o = 0; o < 4; ++o) {
              const int nt = 4 * j + o;
              const float2 dsv = *reinterpret_cast<const float2*>(sds + 8 * nt + 2 * t4);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float d = e ? dsv.y : dsv.x;
                qs[2 * o + e] = m0 * acc[nt][e] + m8 * acc[nt][2 + e];
                dg[nt][e] = (d * m0) * dg[nt][e];
                dg[nt][2 + e] = (d * m8) * dg[nt][2 + e];
                qd[2 * o + e] = dg[nt][e] + dg[nt][2 + e];
              }
            }
            reduce_rows(qs, lane);
            reduce_rows(qd, lane);
            ssum[j] += qs[0];
            db2[j] += qd[0];
          }
          store_natural(s_dx2, dg, s);
        }
        pass_on(x, acc);
      }
    }
    store_sums(s_s + res * H, ssum, lane);
    store_sums(p_db + res * H, db2, lane);
  }
}

// K4 / K5's backward, pass 1: from acc = h2 W3 and the slab's E rows (read
// again: L2 holds them, and registers do not), the residual, the LayerNorm
// (eps 1e-6; K2's lnmod_out sums: a lane's columns in order, then the quad)
// and its backward. Row means m1 of dln = dct g (1
// + sc) and m2 of dln ln in the same order; the slab sums of dsh (dct g),
// dsc (dct g ln) and dgate (dct ln (1 + sc)) by quarters; dresid = rstd
// ((dln - m1) - ln m2) in acc and to s_dres (parked for dE), dmsg = dresid x
// keep to s_dmsg (dW3's Y, pass 2's input) and db3's slab sums. DROP 1
// reads keep (f32, E's dtype), DROP 2 makes the forward's mask from the
// natural element index (drop_bits, as message_chain.cu) first, as 64 bits
// a lane for both uses. Padding rows (past nrow) read dct as zeros.
template <int DROP>
__device__ __forceinline__ void lnmod_bwd(float (&acc)[16][4], const float* __restrict__ E,
                                          const float* sb3, const float* __restrict__ sc,
                                          const float* __restrict__ gate,
                                          const float* __restrict__ keep, uint32_t key,
                                          uint32_t thresh, float kscale,
                                          const float* __restrict__ dout,
                                          float* __restrict__ s_dres,
                                          float* __restrict__ s_dmsg, float (&psh)[4],
                                          float (&psc)[4], float (&pdg)[4], float (&pdb)[4],
                                          size_t sample_row0, const tf::Slab& s) {
  const int lane = s.lane, g = lane >> 2, t4 = lane & 3;
  const bool ok[2] = {g < s.nrow, g + 8 < s.nrow};
  unsigned km[2] = {0u, 0u};  // DROP 2: keep bit 2 nt + e of rows g, g + 8
  if constexpr (DROP == 2) {
    // the hashes in a loop that is not unrolled: their code once, not 16 times
#pragma unroll 1
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t i0 =
            (uint32_t)((s.row0 + g + 8 * h - sample_row0) * H + 8 * nt + 2 * t4);
        km[h] |= (drop_bits(key, i0) >= thresh ? 1u : 0u) << (2 * nt) |
                 (drop_bits(key, i0 + 1) >= thresh ? 1u : 0u) << (2 * nt + 1);
      }
  }
  float mean[2] = {0.0f, 0.0f}, rstd[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = 8 * nt + 2 * t4;
    const float2 bias = *reinterpret_cast<const float2*>(sb3 + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x0 = acc[nt][2 * h] + bias.x, x1 = acc[nt][2 * h + 1] + bias.y;
      if constexpr (DROP != 0) {   // the forward's rounding (chain_tf32.cuh lnmod_out)
        const float2 kp =
            DROP == 1 ? row2(keep, s.row0 + g + 8 * h, c, ok[h])
                      : make_float2((km[h] >> (2 * nt)) & 1u ? kscale : 0.0f,
                                    (km[h] >> (2 * nt + 1)) & 1u ? kscale : 0.0f);
        x0 = __fmul_rn(x0, kp.x);
        x1 = __fmul_rn(x1, kp.y);
      }
      const float2 e = row2(E, s.row0 + g + 8 * h, c, ok[h]);
      acc[nt][2 * h] = e.x + x0;
      acc[nt][2 * h + 1] = e.y + x1;
      mean[h] += acc[nt][2 * h];
      mean[h] += acc[nt][2 * h + 1];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mean[h] += __shfl_xor_sync(0xffffffffu, mean[h], 1);
    mean[h] += __shfl_xor_sync(0xffffffffu, mean[h], 2);
    mean[h] = mean[h] / H;
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float d = acc[nt][2 * h + i] - mean[h];
        rstd[h] += d * d;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rstd[h] += __shfl_xor_sync(0xffffffffu, rstd[h], 1);
    rstd[h] += __shfl_xor_sync(0xffffffffu, rstd[h], 2);
    rstd[h] = rsqrtf(rstd[h] / H + 1e-6f);
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = (acc[nt][i] - mean[i >> 1]) * rstd[i >> 1];  // ln

  const float2* sc2 = reinterpret_cast<const float2*>(sc + (size_t)s.b * H + 2 * t4);
  const float2* g2 = reinterpret_cast<const float2*>(gate + (size_t)s.b * H + 2 * t4);
  float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float qh[8], qc[8], qg[8];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int nt = 4 * j + o, c = 8 * nt + 2 * t4;
      const float2 gv = __ldg(g2 + 4 * nt), scv = __ldg(sc2 + 4 * nt);
      const float2 d0 = row2(dout, s.row0 + g, c, ok[0]);
      const float2 d8 = row2(dout, s.row0 + g + 8, c, ok[1]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float gg = i ? gv.y : gv.x, sc1 = 1.0f + (i ? scv.y : scv.x);
        const float dct0 = i ? d0.y : d0.x, dct8 = i ? d8.y : d8.x;
        const float ln0 = acc[nt][i], ln8 = acc[nt][2 + i];
        const float dgo0 = dct0 * gg, dgo8 = dct8 * gg;
        qh[2 * o + i] = dgo0 + dgo8;
        qc[2 * o + i] = dgo0 * ln0 + dgo8 * ln8;
        qg[2 * o + i] = dct0 * (ln0 * sc1) + dct8 * (ln8 * sc1);
        const float dln0 = dgo0 * sc1, dln8 = dgo8 * sc1;
        s1[0] += dln0;
        s2[0] += dln0 * ln0;
        s1[1] += dln8;
        s2[1] += dln8 * ln8;
      }
    }
    reduce_rows(qh, lane);
    reduce_rows(qc, lane);
    reduce_rows(qg, lane);
    psh[j] += qh[0];
    psc[j] += qc[0];
    pdg[j] += qg[0];
  }
  float m1[2], m2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 1);
    s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], 2);
    s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 1);
    s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], 2);
    m1[h] = s1[h] / H;
    m2[h] = s2[h] / H;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float qb[8];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int nt = 4 * j + o, c = 8 * nt + 2 * t4;
      const float2 gv = __ldg(g2 + 4 * nt), scv = __ldg(sc2 + 4 * nt);
      float dm[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t r = s.row0 + g + 8 * h;
        const float2 d = row2(dout, r, c, ok[h]);
        float2 kp = make_float2(1.0f, 1.0f);
        if constexpr (DROP == 1) kp = row2(keep, r, c, ok[h]);
        if constexpr (DROP == 2)
          kp = make_float2((km[h] >> (2 * nt)) & 1u ? kscale : 0.0f,
                           (km[h] >> (2 * nt + 1)) & 1u ? kscale : 0.0f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float dln = ((i ? d.y : d.x) * (i ? gv.y : gv.x)) * (1.0f + (i ? scv.y : scv.x));
          const float dr = rstd[h] * ((dln - m1[h]) - acc[nt][2 * h + i] * m2[h]);
          acc[nt][2 * h + i] = dr;
          dm[h][i] = DROP != 0 ? __fmul_rn(dr, i ? kp.y : kp.x) : dr;
        }
        if (ok[h]) {
          *reinterpret_cast<float2*>(s_dres + r * H + c) =
              make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
          *reinterpret_cast<float2*>(s_dmsg + r * H + c) = make_float2(dm[h][0], dm[h][1]);
        }
      }
      qb[2 * o] = dm[0][0] + dm[1][0];
      qb[2 * o + 1] = dm[0][1] + dm[1][1];
    }
    reduce_rows(qb, lane);
    pdb[j] += qb[0];
  }
}

// K4 (DROP 0) and K5's backward (DROP 1: keep, 2: seeds), pass 1 (module
// note): a warp's residue, each slab: pre, h1 (-> s_h1) and gelu'(pre) (->
// s_dg1), x2, h2 = gelu(x2 + b2) (-> s_h2) and gelu'(x2) (-> s_dg2), msg =
// h2 W3, then lnmod_bwd; the residue's dsh, dsc, dgate and db3 parts after
// its last slab.
template <int DROP>
__global__ void __launch_bounds__(tf::TNT, 1)
message_edge_lnmod_bwd_f32_mma_kernel(
    const float* __restrict__ A, const float* __restrict__ E, const float* __restrict__ Gn,
    const int* __restrict__ idx, const float* __restrict__ We, const float* __restrict__ W2,
    const float* __restrict__ b2, const float* __restrict__ W3, const float* __restrict__ b3,
    const float* __restrict__ sc, const float* __restrict__ gate,
    const float* __restrict__ keep, const int* __restrict__ seeds, uint32_t thresh,
    float kscale, const float* __restrict__ dout, float* __restrict__ s_h1,
    float* __restrict__ s_dg1, float* __restrict__ s_h2, float* __restrict__ s_dg2,
    float* __restrict__ s_dres, float* __restrict__ s_dmsg, float* __restrict__ p_db,
    float* __restrict__ p_mod, int B, int L, int K, int N) {
  extern __shared__ __align__(16) float fsm[];
  float* sWe = fsm;
  float* sW2 = sWe + tf::WFLOATS;
  float* sW3 = sW2 + tf::WFLOATS;
  float* sb2 = sW3 + tf::WFLOATS;
  float* sb3 = sb2 + H;
  tf::stage_frag<false, true>(sWe, We);
  tf::stage_frag<true, false>(sW2, W2);
  tf::stage_frag<false, false>(sW3, W3);
  tf::load_vec(sb2, b2);
  tf::load_vec(sb3, b3);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int spr = (K + 15) / 16;
  const long long n_res = (long long)B * L;
  for (long long res = (long long)blockIdx.x * tf::TW + warp; res < n_res;
       res += (long long)gridDim.x * tf::TW) {
    const int b = (int)(res / L), l = (int)(res - (long long)b * L);
    const uint32_t key = DROP == 2 ? sample_key(__ldg(seeds + b), b) : 0u;
    float psh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, psc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float pdg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pdb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int q = 0; q < spr; ++q) {
      const tf::Slab s = tf::make_slab(b, l, q, L, K, lane);
      // pre = A[l] + Gn[idx] + E W_e, x2 = h1 W2 + b2, msg = h2 W3: one copy
      // of the product's code for the three and of the gelu's for the first
      // two (x is passed on at the end of each, so it holds nothing live
      // through the epilogues)
      float x[16][4], acc[16][4];
      tf::load_rows(x, E, s);
      tf::preset(acc, A, Gn, idx, L, N, s);
#pragma unroll 1
      for (int p = 0; p < 3; ++p) {
        tf::mma_slab(acc, x, p == 0 ? sWe : p == 1 ? sW2 : sW3, lane);
        if (p == 2) break;
        if (p == 1) add_bias(acc, sb2, lane);
        float dg[16][4];
        gelu_in_place(acc, dg);
        if (p == 0) {   // h1 (-> s_h1), gelu'(pre) (-> s_dg1)
          store_units(s_h1, acc, s);
          store_units(s_dg1, dg, s);
        } else {        // h2 (-> s_h2), gelu'(x2) (-> s_dg2)
          store_natural(s_h2, acc, s);
          store_natural(s_dg2, dg, s);
        }
        pass_on(x, acc);
      }
      lnmod_bwd<DROP>(acc, E, sb3, sc, gate, keep, key, thresh, kscale, dout, s_dres, s_dmsg,
                      psh, psc, pdg, pdb, (size_t)b * L * K, s);
    }
    store_sums(p_mod + res * H, psh, lane);
    store_sums(p_mod + (n_res + res) * H, psc, lane);
    store_sums(p_mod + (2 * n_res + res) * H, pdg, lane);
    store_sums(p_db + (n_res + res) * H, pdb, lane);
  }
}

// K6's backward, pass 1 (module note): K4's pass 1 with dh2 = dout W3^T for
// its W3 product and no LayerNorm. A warp's residue, each slab: pre, h1 (->
// s_h1) and gelu'(pre) (-> s_dg1), x2, h2 = gelu(x2 + b2) (-> s_h2, dW3's
// X) and gelu'(x2), held; dh2 = dout W3^T (W3^T in fragment order, dout's
// rows the A operand), dx2 = dh2 gelu'(x2) (-> s_dx2) and the slab sums of
// dx2 (db2) and of dout (db3), the residue's parts after its last slab.
// Its products sum each two k8 steps from zero, then add them in f32
// (mma_slab<2>): the weight grads then keep f32's accuracy (module note).
__global__ void __launch_bounds__(tf::TNT, 1)
message_edge_bwd_f32_mma_kernel(const float* __restrict__ A, const float* __restrict__ E,
                                const float* __restrict__ Gn, const int* __restrict__ idx,
                                const float* __restrict__ We, const float* __restrict__ W2,
                                const float* __restrict__ b2, const float* __restrict__ W3T,
                                const float* __restrict__ dout, float* __restrict__ s_h1,
                                float* __restrict__ s_dg1, float* __restrict__ s_h2,
                                float* __restrict__ s_dx2, float* __restrict__ p_db, int B,
                                int L, int K, int N) {
  extern __shared__ __align__(16) float fsm[];
  float* sWe = fsm;
  float* sW2 = sWe + tf::WFLOATS;
  float* sW3T = sW2 + tf::WFLOATS;
  float* sb2 = sW3T + tf::WFLOATS;
  tf::stage_frag<false, true>(sWe, We);
  tf::stage_frag<true, false>(sW2, W2);
  tf::stage_frag<false, false>(sW3T, W3T);
  tf::load_vec(sb2, b2);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int spr = (K + 15) / 16;
  const long long n_res = (long long)B * L;
  for (long long res = (long long)blockIdx.x * tf::TW + warp; res < n_res;
       res += (long long)gridDim.x * tf::TW) {
    const int b = (int)(res / L), l = (int)(res - (long long)b * L);
    float pd2[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pd3[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int q = 0; q < spr; ++q) {
      const tf::Slab s = tf::make_slab(b, l, q, L, K, lane);
      // pre = A[l] + Gn[idx] + E W_e, x2 = h1 W2 + b2 (each then gelu and
      // gelu' from one exp), dh2 = dout W3^T: one copy of the product's
      // code for the three, of the gelu's for the first two (x is passed on
      // at the end of each, so it holds nothing live through the epilogues)
      float x[16][4], acc[16][4], dg[16][4];
      tf::load_rows(x, E, s);
      tf::preset(acc, A, Gn, idx, L, N, s);
#pragma unroll 1
      for (int p = 0; p < 3; ++p) {
        if (p == 2) {   // dout's rows (padding rows zero), db3's slab sums
          tf::load_rows(x, dout, s);
          slab_sums(pd3, x, lane);
        }
        tf::mma_slab<2>(acc, x, p == 0 ? sWe : p == 1 ? sW2 : sW3T, lane);
        if (p == 2) break;
        if (p == 1) add_bias(acc, sb2, lane);
        gelu_in_place(acc, dg);
        if (p == 0) {   // h1 (-> s_h1), gelu'(pre) (-> s_dg1)
          store_units(s_h1, acc, s);
          store_units(s_dg1, dg, s);
        } else {        // h2 (-> s_h2); gelu'(x2) stays in dg
          store_natural(s_h2, acc, s);
        }
        pass_on(x, acc);
      }
      // dx2 = dh2 gelu'(x2) (-> s_dx2), db2's slab sums
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] *= dg[nt][i];
      store_natural(s_dx2, acc, s);
      slab_sums(pd2, acc, lane);
    }
    store_sums(p_db + res * H, pd2, lane);
    store_sums(p_db + (n_res + res) * H, pd3, lane);
  }
}

// Pass 2 of K3 and K6's backward (EDGE false) and of K4 / K5's backward
// (EDGE true) (module note): the transposed chain, its weights staged in fragment
// order from their transposes. A warp's residue, each slab: EDGE: dh2 =
// dmsg W3^T (dmsg from s_dmsg), dx2 = dh2 gelu'(x2) (-> s_dx2, its slab sums
// to db2); else dx2 from s_dx2. dh1 = dx2 W2^T in pre's unit order (W2^T's
// columns staged through unit()), dpre = dh1 gelu'(pre) (-> s_dpre, dGn by
// float4 atomics, its slab sums to dA), dE = dpre W_e^T (W_e^T's rows
// through unit(): natural columns) [+ dresid from s_dres]. The residue's dA
// (and db2 part) after its last slab.
template <bool EDGE>
__global__ void __launch_bounds__(tf::TNT, 1)
data_grads_f32_mma_kernel(const int* __restrict__ idx, const float* __restrict__ W3T,
                          const float* __restrict__ W2T, const float* __restrict__ WeT,
                          const float* __restrict__ s_dmsg, const float* __restrict__ s_dg2,
                          const float* __restrict__ s_dres, const float* __restrict__ s_dg1,
                          float* s_dx2, float* __restrict__ s_dpre, float* __restrict__ dA,
                          float* __restrict__ dE, float* __restrict__ dGn,
                          float* __restrict__ p_db, int B, int L, int K, int N) {
  extern __shared__ __align__(16) float fsm[];
  float* sW2T = fsm;
  float* sWeT = sW2T + tf::WFLOATS;
  float* sW3T = sWeT + tf::WFLOATS;
  tf::stage_frag<false, true>(sW2T, W2T);
  tf::stage_frag<true, false>(sWeT, WeT);
  if constexpr (EDGE) tf::stage_frag<false, false>(sW3T, W3T);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int spr = (K + 15) / 16;
  const long long n_res = (long long)B * L;
  for (long long res = (long long)blockIdx.x * tf::TW + warp; res < n_res;
       res += (long long)gridDim.x * tf::TW) {
    const int b = (int)(res / L), l = (int)(res - (long long)b * L);
    float da[4] = {0.0f, 0.0f, 0.0f, 0.0f}, db2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int q = 0; q < spr; ++q) {
      const tf::Slab s = tf::make_slab(b, l, q, L, K, lane);
      const bool ok[2] = {g < s.nrow, g + 8 < s.nrow};
      // dh2 = dmsg W3^T (EDGE), dh1 = dx2 W2^T, dE = dpre W_e^T: one copy of
      // the product's code for the three
      float x[16][4], acc[16][4];
      tf::load_rows(x, EDGE ? s_dmsg : s_dx2, s);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll 1
      for (int p = EDGE ? 0 : 1; p < 3; ++p) {
        tf::mma_slab(acc, x, p == 0 ? sW3T : p == 1 ? sW2T : sWeT, lane);
        if (EDGE && p == 0) {  // dx2 = dh2 gelu'(x2) (-> s_dx2), db2's slab sums
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int c = 8 * nt + 2 * t4;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const size_t r = s.row0 + g + 8 * h;
              const float2 dg = row2(s_dg2, r, c, ok[h]);
              acc[nt][2 * h] *= dg.x;
              acc[nt][2 * h + 1] *= dg.y;
              if (ok[h])
                *reinterpret_cast<float2*>(s_dx2 + r * H + c) =
                    make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
            }
          }
          slab_sums(db2, acc, lane);
          pass_on(x, acc);
        } else if (p == 1) {
          // dpre = dh1 gelu'(pre) in pre's unit order: gelu' back from s_dg1
          // at the units; dpre to s_dpre and dGn (the index clamped into
          // Gn's rows), its slab sums to dA
          float* gn[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jn = ok[h] ? min(max(__ldg(idx + s.row0 + g + 8 * h), 0), N - 1) : 0;
            gn[h] = dGn + ((size_t)b * N + jn) * H + 32 * t4;
          }
#pragma unroll
          for (int m = 0; m < 8; ++m) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 gv = row4(s_dg1, s.row0 + g + 8 * h, 32 * t4 + 4 * m, ok[h]);
              acc[2 * m][2 * h] *= gv.x;
              acc[2 * m][2 * h + 1] *= gv.y;
              acc[2 * m + 1][2 * h] *= gv.z;
              acc[2 * m + 1][2 * h + 1] *= gv.w;
              if (ok[h]) {
                const float4 v = make_float4(acc[2 * m][2 * h], acc[2 * m][2 * h + 1],
                                             acc[2 * m + 1][2 * h], acc[2 * m + 1][2 * h + 1]);
                *reinterpret_cast<float4*>(s_dpre + (s.row0 + g + 8 * h) * H + 32 * t4 +
                                           4 * m) = v;
                atomicAdd(reinterpret_cast<float4*>(gn[h] + 4 * m), v);
              }
            }
          }
          slab_sums(da, acc, lane);
          pass_on(x, acc);
        } else if (p == 2) {  // dE [+ dresid], natural columns
#pragma unroll
          for (int nt = 0; nt < 16; ++nt) {
            const int c = 8 * nt + 2 * t4;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!ok[h]) continue;
              const size_t r = s.row0 + g + 8 * h;
              float2 v = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
              if constexpr (EDGE) {
                const float2 dr = *reinterpret_cast<const float2*>(s_dres + r * H + c);
                v.x += dr.x;
                v.y += dr.y;
              }
              *reinterpret_cast<float2*>(dE + r * H + c) = v;
            }
          }
        }
      }
    }
    // dA: the reduced column n of pre's order is hidden unit unit(n)
#pragma unroll
    for (int j = 0; j < 4; ++j) dA[res * H + unit(quarter_col(j, lane))] = da[j];
    if constexpr (EDGE) store_sums(p_db + res * H, db2, lane);
  }
}

// The weight-grad pass of every f32 backward: part[z][chunk] = X_z^T Y_z over
// the chunk's rows on mma.sync m16n8k8 in 3xTF32, from a ring of FGSTAGES
// stages of FGROWS rows of X and Y (cp.async, rows past the chunk zero, row
// stride FGS: lane (g, t4) reads bank 8 t4 + g, no conflicts); a warp owns a
// 32 x 64 block of the [H, H] partial (X^T's A fragments and Y's B fragments
// read as scalars: the rows are the k dimension). Each stage's 4 k8 steps
// sum from a fresh accumulator, folded into the running sum with Kahan
// compensation (the tensor cores' sums over a chunk's ~3000 rows would lose
// bits the f32 check sees); sum_partials then adds the chunks in a fixed
// order, so the weight grads repeat bit for bit.
constexpr int FGROWS = 32;
constexpr int FGSTAGES = 4;
constexpr int FGS = H + 8;
constexpr int FGSTAGE = 2 * FGROWS * FGS;         // floats: X's rows, then Y's
constexpr int FGSMEM = FGSTAGES * FGSTAGE * 4;

__global__ void __launch_bounds__(tf::TNT, 1)
wgrad_f32_mma_kernel(Pairs<float> p, int n_chunks, float* __restrict__ part) {
  extern __shared__ __align__(16) float fsm[];
  const int z = blockIdx.y, chunk = blockIdx.x;
  // constant indices: a runtime index copies the parameter to local memory
  const float* X = z == 0 ? p.X[0] : z == 1 ? p.X[1] : p.X[2];
  const float* Y = z == 0 ? p.Y[0] : z == 1 ? p.Y[1] : p.Y[2];
  const long long M = z == 0 ? p.M[0] : z == 1 ? p.M[1] : p.M[2];
  const long long per = ((M + n_chunks - 1) / n_chunks + FGROWS - 1) / FGROWS * FGROWS;
  const long long m_begin = min(M, chunk * per);
  const long long m_end = min(M, m_begin + per);
  const int n_steps = (int)((m_end - m_begin + FGROWS - 1) / FGROWS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int i0 = 32 * (warp & 3), j0 = 64 * (warp >> 2);
  auto issue = [&](int st) {
    if (st < n_steps) {
      float* buf = fsm + (st % FGSTAGES) * FGSTAGE;
      const long long m0 = m_begin + (long long)st * FGROWS;
      for (int i = tid; i < 2 * FGROWS * (H / 4); i += tf::TNT) {
        const int w = i / (FGROWS * (H / 4)), rr = (i / (H / 4)) % FGROWS, c = i % (H / 4);
        float* d = buf + (w * FGROWS + rr) * FGS + 4 * c;
        if (m0 + rr < m_end) mma::cp_async16(d, (w ? Y : X) + (m0 + rr) * H + 4 * c);
        else *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    mma::cp_async_commit();
  };
  float acc[2][8][4], comp[2][8][4];
#pragma unroll
  for (int ti = 0; ti < 2; ++ti)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[ti][nt][i] = comp[ti][nt][i] = 0.0f;
  for (int st = 0; st < FGSTAGES - 1; ++st) issue(st);
  for (int st = 0; st < n_steps; ++st) {
    mma::cp_async_wait<FGSTAGES - 2>();
    __syncthreads();  // stage st in place; every warp is done with stage st - 1
    issue(st + FGSTAGES - 1);
    const float* sx = fsm + (st % FGSTAGES) * FGSTAGE;
    const float* sy = sx + FGROWS * FGS;
    float step[2][8][4];
#pragma unroll
    for (int ti = 0; ti < 2; ++ti)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) step[ti][nt][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < FGROWS / 8; ++ks) {
      // A = X^T: a0 (m g, k t4) = X[t4][g], a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4)
      const float* x0 = sx + (8 * ks + t4) * FGS + i0 + g;
      const float* x4 = x0 + 4 * FGS;
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int ti = 0; ti < 2; ++ti) {
        tf::split(x0[16 * ti], ahi[ti][0], alo[ti][0]);
        tf::split(x0[16 * ti + 8], ahi[ti][1], alo[ti][1]);
        tf::split(x4[16 * ti], ahi[ti][2], alo[ti][2]);
        tf::split(x4[16 * ti + 8], ahi[ti][3], alo[ti][3]);
      }
      // B = Y: b0 (k t4, n g), b1 (k t4 + 4, n g)
      const float* y0 = sy + (8 * ks + t4) * FGS + j0 + g;
      const float* y4 = y0 + 4 * FGS;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bh0, bl0, bh1, bl1;
        tf::split(y0[8 * nt], bh0, bl0);
        tf::split(y4[8 * nt], bh1, bl1);
#pragma unroll
        for (int ti = 0; ti < 2; ++ti) {
          tf::mma_tf32(step[ti][nt], alo[ti], bh0, bh1);
          tf::mma_tf32(step[ti][nt], ahi[ti], bl0, bl1);
          tf::mma_tf32(step[ti][nt], ahi[ti], bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int ti = 0; ti < 2; ++ti)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) kahan_add(acc[ti][nt][i], comp[ti][nt][i], step[ti][nt][i]);
  }
  float* dst = part + ((size_t)z * n_chunks + chunk) * H * H;
#pragma unroll
  for (int ti = 0; ti < 2; ++ti)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int r = i0 + 16 * ti + g, c = j0 + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(dst + r * H + c) = make_float2(acc[ti][nt][0], acc[ti][nt][1]);
      *reinterpret_cast<float2*>(dst + (r + 8) * H + c) =
          make_float2(acc[ti][nt][2], acc[ti][nt][3]);
    }
}

// The weight-grad pass: f32 and bf16 on the tensor cores.
cudaError_t launch_wgrad(const Pairs<float>& pairs, int n_chunks, float* wpart,
                         cudaStream_t st) {
  static unsigned done = 0;
  const cudaError_t err = tf::smem_once(wgrad_f32_mma_kernel, FGSMEM, done);
  if (err != cudaSuccess) return err;
  wgrad_f32_mma_kernel<<<dim3(n_chunks, 3), tf::TNT, FGSMEM, st>>>(pairs, n_chunks, wpart);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(const Pairs<bf16>& pairs, int n_chunks, float* wpart,
                         cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(wgrad_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
  if (err != cudaSuccess) return err;
  wgrad_mma_kernel<<<dim3(n_chunks, 3), MNT, GSMEM, st>>>(pairs, n_chunks, wpart);
  return cudaGetLastError();
}

// The weight grads of a backward from its main pass's scratch, dW = (E^T
// dpre, h1^T dx2, X3^T Y3) with the rows of X3 and Y3 (m3: the edge rows, or
// K3's residue rows) in the main pass's dtype T (bf16: dpre and dx2 cast), on
// the tensor cores, then the partial sums of dW and of db (p_db's [2,
// n_parts, H] tile or residue parts)
template <typename T>
int weight_grads(const void* E, const void* s_dpre, const void* s_h1, const void* s_dx2,
                 const void* X3, const void* Y3, long long rows, long long m3, void* wpart,
                 void* p_db, void* dW, void* db, int n_parts, int n_chunks, cudaStream_t st) {
  Pairs<T> pairs;
  pairs.X[0] = static_cast<const T*>(E);
  pairs.Y[0] = static_cast<const T*>(s_dpre);
  pairs.M[0] = rows;
  pairs.X[1] = static_cast<const T*>(s_h1);
  pairs.Y[1] = static_cast<const T*>(s_dx2);
  pairs.M[1] = rows;
  pairs.X[2] = static_cast<const T*>(X3);
  pairs.Y[2] = static_cast<const T*>(Y3);
  pairs.M[2] = m3;
  const cudaError_t err = launch_wgrad(pairs, n_chunks, static_cast<float*>(wpart), st);
  if (err != cudaSuccess) return (int)err;
  const int rc = reduce(static_cast<const float*>(wpart), static_cast<float*>(dW), 3, n_chunks,
                        H * H, st);
  if (rc != 0) return rc;
  return reduce(static_cast<const float*>(p_db), static_cast<float*>(db), 2, n_parts, H, st);
}

// the tensor-core main passes' checks: K a multiple of 16, at most 128;
// n_tiles counts blocks of 128 edge rows; returns the L-tiles a sample (0: bad)
int mma_tiles(int B, int L, int K, int N, int n_tiles, int n_chunks) {
  if (B <= 0 || L <= 0 || N <= 0 || K <= 0 || K > MROWS || K % 16 != 0 || n_chunks <= 0)
    return 0;
  const int TL = MROWS / K;
  const int ntl = (L + TL - 1) / TL;
  return n_tiles == B * ntl ? ntl : 0;
}

// K3 in bf16: the main pass, the tensor-core weight grads, then the partial
// sums. Scratch: s_h1, s_dx2, s_dpre [B*L*K, H], s_s, s_dout [B*L, H] in bf16;
// s_dg1 [B*L*K, H] f32 (gelu'(pre) between the main pass's phases A and C);
// wpart f32 [3, n_chunks, H, H]; p_db f32 [2, n_tiles, H], n_tiles = B *
// ceil(L / (128 / K)). Outputs as launch_sum_bwd_f32_mma's.
int launch_sum_bwd_mma(const void* A, const void* E, const void* Gn, const void* idx,
                       const void* mask, const void* We, const void* W2, const void* b2,
                       const void* W3, const void* dout, void* dA, void* dE, void* dGn,
                       void* s_h1, void* s_dx2, void* s_dpre, void* s_dg1, void* s_s,
                       void* s_dout,
                       void* wpart, void* p_db, void* dW, void* db, int B, int L, int K,
                       int N, int n_tiles, int n_chunks, void* stream) {
  const int ntl = mma_tiles(B, L, K, N, n_tiles, n_chunks);
  if (ntl == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(message_sum_bwd_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S3SMEM);
  if (err != cudaSuccess) return (int)err;
  message_sum_bwd_mma_kernel<<<dim3(ntl, B), MNT, S3SMEM, st>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(E), static_cast<const bf16*>(Gn),
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const bf16*>(We), static_cast<const bf16*>(W2),
      static_cast<const float*>(b2), static_cast<const bf16*>(W3),
      static_cast<const float*>(dout), static_cast<float*>(dA), static_cast<bf16*>(dE),
      static_cast<float*>(dGn), static_cast<bf16*>(s_h1), static_cast<bf16*>(s_dx2),
      static_cast<bf16*>(s_dpre), static_cast<float*>(s_dg1), static_cast<bf16*>(s_s),
      static_cast<bf16*>(s_dout),
      static_cast<float*>(p_db), L, K, N, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return weight_grads<bf16>(E, s_dpre, s_h1, s_dx2, s_s, s_dout, (long long)B * L * K,
                            (long long)B * L, wpart, p_db, dW, db, n_tiles, n_chunks, st);
}

// K6's backward in bf16: the main pass, then weight_grads<bf16> with dW3 = cast(h2)^T
// dout. Scratch: s_h1, s_dx2, s_dpre, s_h2 [B*L*K, H] bf16, s_dg1 [B*L*K, H]
// f32, wpart, p_db as K3's. Outputs as launch_sum_bwd_f32_mma's.
int launch_edge_bwd_mma(const void* A, const void* E, const void* Gn, const void* idx,
                        const void* We, const void* W2, const void* b2, const void* W3,
                        const void* dout, void* dA, void* dE, void* dGn, void* s_h1,
                        void* s_dx2, void* s_dpre, void* s_h2, void* s_dg1, void* wpart,
                        void* p_db, void* dW, void* db, int B, int L, int K, int N,
                        int n_tiles, int n_chunks, void* stream) {
  const int ntl = mma_tiles(B, L, K, N, n_tiles, n_chunks);
  if (ntl == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(message_edge_bwd_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S6SMEM);
  if (err != cudaSuccess) return (int)err;
  message_edge_bwd_mma_kernel<<<dim3(ntl, B), MNT, S6SMEM, st>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(E), static_cast<const bf16*>(Gn),
      static_cast<const int*>(idx), static_cast<const bf16*>(We),
      static_cast<const bf16*>(W2), static_cast<const float*>(b2),
      static_cast<const bf16*>(W3), static_cast<const bf16*>(dout), static_cast<float*>(dA),
      static_cast<bf16*>(dE), static_cast<float*>(dGn), static_cast<bf16*>(s_h1),
      static_cast<bf16*>(s_dx2), static_cast<bf16*>(s_dpre), static_cast<bf16*>(s_h2),
      static_cast<float*>(s_dg1), static_cast<float*>(p_db), L, K, N, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * L * K;
  return weight_grads<bf16>(E, s_dpre, s_h1, s_dx2, s_h2, dout, rows, rows, wpart, p_db, dW,
                            db, n_tiles, n_chunks, st);
}

// K4 / K5's backward in bf16 (DROP 0, 1: keep, 2: seeds): the main pass, then
// weight_grads<bf16> with dW3 = cast(h2)^T cast(dmsg), then dmod's partial sums.
// Scratch: K6's and s_dmsg [B*L*K, H] bf16, s_dg2, s_dres [B*L*K, H] f32,
// p_mod f32 [3, n_tiles, H]. Outputs as launch_edge_lnmod_bwd_f32_mma's.
template <int DROP>
int launch_edge_lnmod_bwd_mma(const void* A, const void* E, const void* Gn, const void* idx,
                              const void* We, const void* W2, const void* b2, const void* W3,
                              const void* b3, const void* sc, const void* gate,
                              const void* keep, const void* seeds, uint32_t thresh,
                              float kscale, const void* dout, void* dA, void* dE, void* dGn,
                              void* s_h1, void* s_dx2, void* s_dpre, void* s_h2, void* s_dmsg,
                              void* s_dg1, void* s_dg2, void* s_dres, void* wpart, void* p_db,
                              void* p_mod, void* dW, void* db, void* dmod, int B, int L, int K,
                              int N, int n_tiles, int n_chunks, cudaStream_t st) {
  const int ntl = mma_tiles(B, L, K, N, n_tiles, n_chunks);
  if (ntl == 0) return (int)cudaErrorInvalidValue;
  auto kern = message_edge_lnmod_bwd_mma_kernel<DROP>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S4SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(ntl, B), MNT, S4SMEM, st>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(E), static_cast<const bf16*>(Gn),
      static_cast<const int*>(idx), static_cast<const bf16*>(We),
      static_cast<const bf16*>(W2), static_cast<const float*>(b2),
      static_cast<const bf16*>(W3), static_cast<const float*>(b3),
      static_cast<const float*>(sc), static_cast<const float*>(gate),
      static_cast<const bf16*>(keep), static_cast<const int*>(seeds), thresh, kscale,
      static_cast<const bf16*>(dout), static_cast<float*>(dA), static_cast<bf16*>(dE),
      static_cast<float*>(dGn), static_cast<bf16*>(s_h1), static_cast<bf16*>(s_dx2),
      static_cast<bf16*>(s_dpre), static_cast<bf16*>(s_h2), static_cast<bf16*>(s_dmsg),
      static_cast<float*>(s_dg1), static_cast<float*>(s_dg2), static_cast<float*>(s_dres),
      static_cast<float*>(p_db), static_cast<float*>(p_mod), L, K, N, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * L * K;
  const int rc = weight_grads<bf16>(E, s_dpre, s_h1, s_dx2, s_h2, s_dmsg, rows, rows, wpart,
                                    p_db, dW, db, n_tiles, n_chunks, st);
  if (rc != 0) return rc;
  return reduce(static_cast<const float*>(p_mod), static_cast<float*>(dmod), 3 * B, ntl, H, st);
}

// The f32 kernels take K <= 64, a multiple of 4, as every f32 kernel of the
// forward does (the tensor-core passes pad a residue's last slab)
bool f32_bad(int B, int L, int K, int N, int n_chunks) {
  return B <= 0 || L <= 0 || N <= 0 || K <= 0 || K > 64 || K % 4 != 0 || n_chunks <= 0;
}

// the f32 tensor-core passes' grid: one block an SM (or fewer where the
// residues are fewer), each walking over its share of the residues
int f32_grid(int B, int L) {
  const long long warps = (long long)B * L;
  return (int)std::min<long long>((warps + tf::TW - 1) / tf::TW, tf::sm_count());
}

// K3 in f32 (3xTF32): pass 1, pass 2, then the weight grads and the partial
// sums. Scratch: s_h1, s_dx2, s_dpre, s_dg1 [B*L*K, H] f32 (gelu'(pre)
// between the passes), s_s [B*L, H]; wpart f32 [3, n_chunks, H, H]; p_db f32
// [2, n_res, H], n_res = B * L (a part a residue). dW3's Y is dout itself.
// Outputs: dA f32 [B, L, H], dE f32 [B, L, K, H], dGn f32 [B, N, H] (zeroed
// by the wrapper), dW f32 [3, H, H] (dW_e, dW2, dW3), db f32 [2, H] (db2,
// db3).
int launch_sum_bwd_f32_mma(const void* A, const void* E, const void* Gn, const void* idx,
                           const void* mask, const void* We, const void* WeT, const void* W2,
                           const void* W2T, const void* b2, const void* W3T, const void* dout,
                           void* dA, void* dE, void* dGn, void* s_h1, void* s_dx2,
                           void* s_dpre, void* s_dg1, void* s_s, void* wpart, void* p_db,
                           void* dW, void* db, int B, int L, int K, int N, int n_res,
                           int n_chunks, void* stream) {
  if (f32_bad(B, L, K, N, n_chunks) || n_res != B * L) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static unsigned done1 = 0, done2 = 0;
  cudaError_t err = tf::smem_once(message_sum_bwd_f32_mma_kernel, F3SMEM, done1);
  if (err == cudaSuccess)
    err = tf::smem_once(data_grads_f32_mma_kernel<false>, fd_smem(false), done2);
  if (err != cudaSuccess) return (int)err;
  const int grid = f32_grid(B, L);
  const float* f = nullptr;
  message_sum_bwd_f32_mma_kernel<<<grid, tf::TNT, F3SMEM, st>>>(
      static_cast<const float*>(A), static_cast<const float*>(E), static_cast<const float*>(Gn),
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const float*>(We), static_cast<const float*>(W2),
      static_cast<const float*>(b2), static_cast<const float*>(W3T),
      static_cast<const float*>(dout), static_cast<float*>(s_h1), static_cast<float*>(s_dg1),
      static_cast<float*>(s_dx2), static_cast<float*>(s_s), static_cast<float*>(p_db), B, L,
      K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  data_grads_f32_mma_kernel<false><<<grid, tf::TNT, fd_smem(false), st>>>(
      static_cast<const int*>(idx), f, static_cast<const float*>(W2T),
      static_cast<const float*>(WeT), f, f, f, static_cast<const float*>(s_dg1),
      static_cast<float*>(s_dx2), static_cast<float*>(s_dpre), static_cast<float*>(dA),
      static_cast<float*>(dE), static_cast<float*>(dGn), nullptr, B, L, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return weight_grads<float>(E, s_dpre, s_h1, s_dx2, s_s, dout, (long long)B * L * K,
                             (long long)B * L, wpart, p_db, dW, db, n_res, n_chunks, st);
}

// K4 / K5's backward in f32 (3xTF32; DROP 0, 1: keep, 2: seeds): pass 1,
// pass 2, the weight grads with dW3 = h2^T dmsg, then dmod's partial sums.
// Scratch: K3's (s_h2, s_dmsg [B*L*K, H] in s_s's place) and the parked
// s_dg2, s_dres [B*L*K, H] f32; p_mod f32 [3, n_res, H]. Outputs: K3's and
// dmod f32 [3, B, H] (dsh, dsc, dgate without its sh term).
template <int DROP>
int launch_edge_lnmod_bwd_f32_mma(const void* A, const void* E, const void* Gn, const void* idx,
                                  const void* We, const void* WeT, const void* W2,
                                  const void* W2T, const void* b2, const void* W3,
                                  const void* W3T, const void* b3, const void* sc,
                                  const void* gate, const void* keep, const void* seeds,
                                  uint32_t thresh, float kscale, const void* dout, void* dA,
                                  void* dE, void* dGn, void* s_h1, void* s_dx2, void* s_dpre,
                                  void* s_h2, void* s_dmsg, void* s_dg1, void* s_dg2,
                                  void* s_dres, void* wpart, void* p_db, void* p_mod, void* dW,
                                  void* db, void* dmod, int B, int L, int K, int N, int n_res,
                                  int n_chunks, cudaStream_t st) {
  if (f32_bad(B, L, K, N, n_chunks) || n_res != B * L) return (int)cudaErrorInvalidValue;
  static unsigned done1 = 0, done2 = 0;
  cudaError_t err = tf::smem_once(message_edge_lnmod_bwd_f32_mma_kernel<DROP>, F4SMEM, done1);
  if (err == cudaSuccess)
    err = tf::smem_once(data_grads_f32_mma_kernel<true>, fd_smem(true), done2);
  if (err != cudaSuccess) return (int)err;
  const int grid = f32_grid(B, L);
  message_edge_lnmod_bwd_f32_mma_kernel<DROP><<<grid, tf::TNT, F4SMEM, st>>>(
      static_cast<const float*>(A), static_cast<const float*>(E), static_cast<const float*>(Gn),
      static_cast<const int*>(idx), static_cast<const float*>(We),
      static_cast<const float*>(W2), static_cast<const float*>(b2),
      static_cast<const float*>(W3), static_cast<const float*>(b3),
      static_cast<const float*>(sc), static_cast<const float*>(gate),
      static_cast<const float*>(keep), static_cast<const int*>(seeds), thresh, kscale,
      static_cast<const float*>(dout), static_cast<float*>(s_h1), static_cast<float*>(s_dg1),
      static_cast<float*>(s_h2), static_cast<float*>(s_dg2), static_cast<float*>(s_dres),
      static_cast<float*>(s_dmsg), static_cast<float*>(p_db), static_cast<float*>(p_mod), B, L,
      K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  data_grads_f32_mma_kernel<true><<<grid, tf::TNT, fd_smem(true), st>>>(
      static_cast<const int*>(idx), static_cast<const float*>(W3T),
      static_cast<const float*>(W2T), static_cast<const float*>(WeT),
      static_cast<const float*>(s_dmsg), static_cast<const float*>(s_dg2),
      static_cast<const float*>(s_dres), static_cast<const float*>(s_dg1),
      static_cast<float*>(s_dx2), static_cast<float*>(s_dpre), static_cast<float*>(dA),
      static_cast<float*>(dE), static_cast<float*>(dGn), static_cast<float*>(p_db), B, L, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * L * K;
  const int rc = weight_grads<float>(E, s_dpre, s_h1, s_dx2, s_h2, s_dmsg, rows, rows, wpart,
                                     p_db, dW, db, n_res, n_chunks, st);
  if (rc != 0) return rc;
  return reduce(static_cast<const float*>(p_mod), static_cast<float*>(dmod), 3 * B, L, H, st);
}

// K6's backward in f32 (3xTF32): pass 1 (dh2, dx2, db2, db3), pass 2 (K3's),
// then the weight grads with dW3 = h2^T dout and the partial sums. Scratch:
// K3's, with s_h2 [B*L*K, H] in s_s's place; p_db f32 [2, n_res, H], n_res
// = B * L. Outputs as K3's.
int launch_edge_bwd_f32_mma(const void* A, const void* E, const void* Gn, const void* idx,
                            const void* We, const void* WeT, const void* W2, const void* W2T,
                            const void* b2, const void* W3T, const void* dout, void* dA,
                            void* dE, void* dGn, void* s_h1, void* s_dx2, void* s_dpre,
                            void* s_h2, void* s_dg1, void* wpart, void* p_db, void* dW,
                            void* db, int B, int L, int K, int N, int n_res, int n_chunks,
                            cudaStream_t st) {
  if (f32_bad(B, L, K, N, n_chunks) || n_res != B * L) return (int)cudaErrorInvalidValue;
  static unsigned done1 = 0, done2 = 0;
  cudaError_t err = tf::smem_once(message_edge_bwd_f32_mma_kernel, F4SMEM, done1);
  if (err == cudaSuccess)
    err = tf::smem_once(data_grads_f32_mma_kernel<false>, fd_smem(false), done2);
  if (err != cudaSuccess) return (int)err;
  const int grid = f32_grid(B, L);
  const float* f = nullptr;
  message_edge_bwd_f32_mma_kernel<<<grid, tf::TNT, F4SMEM, st>>>(
      static_cast<const float*>(A), static_cast<const float*>(E), static_cast<const float*>(Gn),
      static_cast<const int*>(idx), static_cast<const float*>(We),
      static_cast<const float*>(W2), static_cast<const float*>(b2),
      static_cast<const float*>(W3T), static_cast<const float*>(dout),
      static_cast<float*>(s_h1), static_cast<float*>(s_dg1), static_cast<float*>(s_h2),
      static_cast<float*>(s_dx2), static_cast<float*>(p_db), B, L, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  data_grads_f32_mma_kernel<false><<<grid, tf::TNT, fd_smem(false), st>>>(
      static_cast<const int*>(idx), f, static_cast<const float*>(W2T),
      static_cast<const float*>(WeT), f, f, f, static_cast<const float*>(s_dg1),
      static_cast<float*>(s_dx2), static_cast<float*>(s_dpre), static_cast<float*>(dA),
      static_cast<float*>(dE), static_cast<float*>(dGn), nullptr, B, L, K, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * L * K;
  return weight_grads<float>(E, s_dpre, s_h1, s_dx2, s_h2, dout, rows, rows, wpart, p_db, dW,
                             db, n_res, n_chunks, st);
}

}  // namespace

extern "C" {

// f32 on the tensor cores (3xTF32), with W_e^T, W2^T and W3^T from the
// wrapper beside W_e and W2: K at most 64, a multiple of 4; n_tiles = B * L
// (the column sums' parts are a residue's)
int message_sum_bwd_f32(const void* A, const void* E, const void* Gn, const void* idx,
                        const void* mask, const void* We, const void* WeT, const void* W2,
                        const void* W2T, const void* b2, const void* W3T, const void* dout,
                        void* dA, void* dE, void* dGn, void* s_h1, void* s_dx2, void* s_dpre,
                        void* s_dg1, void* s_s, void* wpart, void* p_db, void* dW, void* db,
                        int B, int L, int K, int N, int n_tiles, int n_chunks, void* stream) {
  return launch_sum_bwd_f32_mma(A, E, Gn, idx, mask, We, WeT, W2, W2T, b2, W3T, dout, dA, dE,
                                dGn, s_h1, s_dx2, s_dpre, s_dg1, s_s, wpart, p_db, dW, db, B, L,
                                K, N, n_tiles, n_chunks, stream);
}

// bf16 on the tensor cores, W_e, W2 and W3 as they are (no transposes): K a
// multiple of 16, at most 128; n_tiles counts blocks of 128 edge rows
int message_sum_bwd_bf16(const void* A, const void* E, const void* Gn, const void* idx,
                         const void* mask, const void* We, const void* W2, const void* b2,
                         const void* W3, const void* dout, void* dA, void* dE, void* dGn,
                         void* s_h1, void* s_dx2, void* s_dpre, void* s_dg1, void* s_s,
                         void* s_dout, void* wpart, void* p_db, void* dW, void* db, int B,
                         int L, int K, int N, int n_tiles, int n_chunks, void* stream) {
  return launch_sum_bwd_mma(A, E, Gn, idx, mask, We, W2, b2, W3, dout, dA, dE, dGn, s_h1,
                            s_dx2, s_dpre, s_dg1, s_s, s_dout, wpart, p_db, dW, db, B, L, K,
                            N, n_tiles, n_chunks, stream);
}

// K4, and K5's backward when `keep` (E's dtype) or `seeds` (int32 [B]) is given:
// f32 on the tensor cores (3xTF32), with W_e, W2, W3 and their transposes; K
// and n_tiles as message_sum_bwd_f32's
int message_edge_lnmod_bwd_f32(const void* A, const void* E, const void* Gn, const void* idx,
                               const void* We, const void* WeT, const void* W2,
                               const void* W2T, const void* b2, const void* W3,
                               const void* W3T, const void* b3, const void* sc,
                               const void* gate, const void* keep, const void* seeds,
                               const void* dout, void* dA, void* dE, void* dGn, void* s_h1,
                               void* s_dx2, void* s_dpre, void* s_h2, void* s_dmsg,
                               void* s_dg1, void* s_dg2, void* s_dres, void* wpart,
                               void* p_db, void* p_mod, void* dW, void* db, void* dmod, int B,
                               int L, int K, int N, int n_tiles, int n_chunks,
                               unsigned thresh, float kscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keep != nullptr && seeds != nullptr) return (int)cudaErrorInvalidValue;
  if (keep != nullptr)
    return launch_edge_lnmod_bwd_f32_mma<1>(
        A, E, Gn, idx, We, WeT, W2, W2T, b2, W3, W3T, b3, sc, gate, keep, nullptr, 0u, 1.0f,
        dout, dA, dE, dGn, s_h1, s_dx2, s_dpre, s_h2, s_dmsg, s_dg1, s_dg2, s_dres, wpart, p_db,
        p_mod, dW, db, dmod, B, L, K, N, n_tiles, n_chunks, st);
  if (seeds != nullptr)
    return launch_edge_lnmod_bwd_f32_mma<2>(
        A, E, Gn, idx, We, WeT, W2, W2T, b2, W3, W3T, b3, sc, gate, nullptr, seeds, thresh,
        kscale, dout, dA, dE, dGn, s_h1, s_dx2, s_dpre, s_h2, s_dmsg, s_dg1, s_dg2, s_dres,
        wpart, p_db, p_mod, dW, db, dmod, B, L, K, N, n_tiles, n_chunks, st);
  return launch_edge_lnmod_bwd_f32_mma<0>(
      A, E, Gn, idx, We, WeT, W2, W2T, b2, W3, W3T, b3, sc, gate, nullptr, nullptr, 0u, 1.0f,
      dout, dA, dE, dGn, s_h1, s_dx2, s_dpre, s_h2, s_dmsg, s_dg1, s_dg2, s_dres, wpart, p_db,
      p_mod, dW, db, dmod, B, L, K, N, n_tiles, n_chunks, st);
}

// the same in bf16 on the tensor cores, W_e, W2 and W3 as they are: K a
// multiple of 16, at most 128; n_tiles counts blocks of 128 edge rows
int message_edge_lnmod_bwd_bf16(const void* A, const void* E, const void* Gn, const void* idx,
                                const void* We, const void* W2, const void* b2,
                                const void* W3, const void* b3, const void* sc,
                                const void* gate, const void* keep, const void* seeds,
                                const void* dout, void* dA, void* dE, void* dGn, void* s_h1,
                                void* s_dx2, void* s_dpre, void* s_h2, void* s_dmsg,
                                void* s_dg1, void* s_dg2, void* s_dres, void* wpart,
                                void* p_db, void* p_mod, void* dW, void* db, void* dmod, int B,
                                int L, int K, int N, int n_tiles, int n_chunks,
                                unsigned thresh, float kscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (keep != nullptr && seeds != nullptr) return (int)cudaErrorInvalidValue;
  if (keep != nullptr)
    return launch_edge_lnmod_bwd_mma<1>(A, E, Gn, idx, We, W2, b2, W3, b3, sc, gate, keep,
                                        nullptr, 0u, 1.0f, dout, dA, dE, dGn, s_h1, s_dx2,
                                        s_dpre, s_h2, s_dmsg, s_dg1, s_dg2, s_dres, wpart, p_db,
                                        p_mod, dW, db, dmod, B, L, K, N, n_tiles, n_chunks, st);
  if (seeds != nullptr)
    return launch_edge_lnmod_bwd_mma<2>(A, E, Gn, idx, We, W2, b2, W3, b3, sc, gate, nullptr,
                                        seeds, thresh, kscale, dout, dA, dE, dGn, s_h1, s_dx2,
                                        s_dpre, s_h2, s_dmsg, s_dg1, s_dg2, s_dres, wpart, p_db,
                                        p_mod, dW, db, dmod, B, L, K, N, n_tiles, n_chunks, st);
  return launch_edge_lnmod_bwd_mma<0>(A, E, Gn, idx, We, W2, b2, W3, b3, sc, gate, nullptr,
                                      nullptr, 0u, 1.0f, dout, dA, dE, dGn, s_h1, s_dx2, s_dpre,
                                      s_h2, s_dmsg, s_dg1, s_dg2, s_dres, wpart, p_db, p_mod, dW,
                                      db, dmod, B, L, K, N, n_tiles, n_chunks, st);
}

// K6's backward: dout [B, L, K, H] in E's dtype (dW3's Y as it is). f32 on
// the tensor cores (3xTF32), with W_e^T, W2^T and W3^T beside W_e and W2;
// K and n_tiles as message_sum_bwd_f32's
int message_edge_bwd_f32(const void* A, const void* E, const void* Gn, const void* idx,
                         const void* We, const void* WeT, const void* W2, const void* W2T,
                         const void* b2, const void* W3T, const void* dout, void* dA,
                         void* dE, void* dGn, void* s_h1, void* s_dx2, void* s_dpre,
                         void* s_h2, void* s_dg1, void* wpart, void* p_db, void* dW, void* db,
                         int B, int L, int K, int N, int n_tiles, int n_chunks, void* stream) {
  return launch_edge_bwd_f32_mma(A, E, Gn, idx, We, WeT, W2, W2T, b2, W3T, dout, dA, dE, dGn,
                                 s_h1, s_dx2, s_dpre, s_h2, s_dg1, wpart, p_db, dW, db, B, L, K,
                                 N, n_tiles, n_chunks, static_cast<cudaStream_t>(stream));
}

// bf16 on the tensor cores, as message_edge_lnmod_bwd_bf16 (dout is dW3's Y)
int message_edge_bwd_bf16(const void* A, const void* E, const void* Gn, const void* idx,
                          const void* We, const void* W2, const void* b2, const void* W3,
                          const void* dout, void* dA, void* dE, void* dGn, void* s_h1,
                          void* s_dx2, void* s_dpre, void* s_h2, void* s_dg1, void* wpart,
                          void* p_db, void* dW, void* db, int B, int L, int K, int N,
                          int n_tiles, int n_chunks, void* stream) {
  return launch_edge_bwd_mma(A, E, Gn, idx, We, W2, b2, W3, dout, dA, dE, dGn, s_h1, s_dx2,
                             s_dpre, s_h2, s_dg1, wpart, p_db, dW, db, B, L, K, N, n_tiles,
                             n_chunks, stream);
}

}  // extern "C"
