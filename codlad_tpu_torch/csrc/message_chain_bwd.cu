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
//  * chain_bwd_kernel (f32 K3-K6): one block of 256 threads per
//    64-row tile (floor(64/K) whole residues; at K = 48 the last 16 rows stay
//    idle). It recomputes the activations from the inputs (nothing
//    [B, L, K, H]-sized is saved by the forward), keeps pre/x2 as their gelu
//    derivatives in registers, and does every row-wise product on CUDA cores
//    through one shared [H, H] weight buffer that is restaged for each product
//    (the transposed weights come from the wrapper). It writes dE and dA,
//    scatter-adds cast(dpre) into the f32 dGn with atomicAdd (the one source of
//    run-to-run differences: the order of f32 additions), and writes per-tile
//    column sums (db2, db3, dsh, dsc, dgate) and the product operands of the
//    weight grads (h1, cast(dx2), cast(dpre), cast(h2) or s, cast(dmsg) or
//    cast(dout)) in the edge dtype to scratch, in natural column order.
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
//  * wgrad_kernel (f32) / wgrad_mma_kernel (bf16, every backward): dW = X^T Y
//    for the three operand pairs, each block summing one chunk of rows into
//    an [H, H] partial (f32: 8 x 8 a thread on CUDA cores, Kahan-compensated;
//    bf16: mma.m16n8k16 with ldmatrix.trans for X^T, a warp 32 x 64).
//  * sum_partials: a second pass that adds the partials in a fixed order
//    (compensated), so the weight and per-sample grads are deterministic.
//
// Bound on an H100 at the training shape (B96 L128 K64 H128, bf16): K3 does
// about 6 B*L*K x H x H products (2 recomputed, dh1, dE, dW2, dW_e), K4 about 9
// and K6's backward 8, 25.8 GFLOP each; the bytes (E and dout read, dE
// written) put the floor at ~0.1-0.2 ms. On CUDA cores in f32 the kernels are
// bound by the FMA rate. The bf16 K3's scratch (three [B*L*K, H] bf16 arrays
// written, then read by the weight-grad pass with E; gelu'(pre) in f32
// written and read back) moves ~2.2 GB, ~0.65 ms at 3.35 TB/s; its four
// per-edge products and gelu' are about twice K1's work, and it runs at
// about K1's rate. K6's backward adds s_h2 (bf16) to that traffic, K4's s_h2,
// s_dmsg and the two parked f32 arrays: ~3.0 and ~4.2 GB (PERF.md has the
// times).

#include "chain_common.cuh"
#include "chain_mma.cuh"
#include "mma_common.cuh"

namespace {

using namespace chain;

constexpr int TM = 4;          // rows per thread, both dtypes
constexpr int ROWS = RG * TM;  // 64 edge rows per block
constexpr int WROWS = 32;      // rows per staging step of wgrad_kernel

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int XPAD = 4; };

template <typename T>
__device__ __forceinline__ void stage_weight(T* sW, const T* W) {
  constexpr int V = 16 / sizeof(T);
  for (int v = threadIdx.x; v < H * H / V; v += NT)
    reinterpret_cast<uint4*>(sW)[v] = reinterpret_cast<const uint4*>(W)[v];
}

// dst[c] = sum over the block's rows of part (each thread's sum over its TM
// rows, columns c0..c0+7), in a fixed order. `red` is [RG][H] f32.
__device__ __forceinline__ void column_sum(float* red, const float (&part)[TN], int rg,
                                           int c0, float* dst) {
  __syncthreads();
  store8(red + rg * H + c0, part);
  __syncthreads();
  if (threadIdx.x < H) {
    float s = 0.0f;
    for (int q = 0; q < RG; ++q) s += red[q * H + threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

// node[ll][c] = sum over residue ll's K rows of part (row groups of TM rows,
// K / TM of them a residue), for the TL residues of the tile.
__device__ __forceinline__ void residue_sum(float* red, const float (&part)[TN], int rg,
                                            int c0, int TL, int gpr, float* node) {
  __syncthreads();
  store8(red + rg * H + c0, part);
  __syncthreads();
  for (int t = threadIdx.x; t < TL * H; t += NT) {
    const int ll = t / H, c = t % H;
    float s = 0.0f;
    for (int q = 0; q < gpr; ++q) s += red[(ll * gpr + q) * H + c];
    node[t] = s;
  }
  __syncthreads();
}

// EDGE = false: K3. EDGE = true: K4, DROP 0 / 1 (keep) / 2 (seeds); with RAW
// (DROP 0), K6.
template <typename T, bool EDGE, int DROP, bool RAW>
__global__ void __launch_bounds__(NT)
chain_bwd_kernel(const T* __restrict__ A, const T* __restrict__ E, const T* __restrict__ Gn,
                 const int* __restrict__ idx, const float* __restrict__ mask,
                 const T* __restrict__ We, const T* __restrict__ WeT,
                 const T* __restrict__ W2, const T* __restrict__ W2T,
                 const float* __restrict__ b2, const T* __restrict__ W3,
                 const T* __restrict__ W3T, const float* __restrict__ b3,
                 const float* __restrict__ sc, const float* __restrict__ gate,
                 const T* __restrict__ keep, const int* __restrict__ seeds,
                 uint32_t thresh, float kscale, const void* __restrict__ dout,
                 float* __restrict__ dA, T* __restrict__ dE, float* __restrict__ dGn,
                 T* __restrict__ s_h1, T* __restrict__ s_dx2, T* __restrict__ s_dpre,
                 T* __restrict__ s_h2, T* __restrict__ s_dmsg,
                 float* __restrict__ p_db, float* __restrict__ p_mod, int L, int K,
                 int N, int n_tiles) {
  using Nm = Num<T>;
  constexpr int XS = H + Pad<T>::XPAD;
  constexpr int V = 16 / sizeof(T);

  extern __shared__ __align__(16) unsigned char smem[];
  T* sW = reinterpret_cast<T*>(smem);            // [H][H] current weight
  T* sX = sW + H * H;                            // [ROWS][XS] product input
  float* red = reinterpret_cast<float*>(sX + ROWS * XS);  // [RG][H]
  float* node = red + RG * H;                    // [TL][H]
  float* node2 = node + (ROWS / TM) * H;         // [TL][H]
  float* msum = node2 + (ROWS / TM) * H;         // [TL]

  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int r0 = rg * TM, c0 = cg * TN;
  const int TL = ROWS / K;
  const int gpr = K / TM;
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * TL;
  const int nrows = min(TL, L - l0) * K;
  const size_t row0 = ((size_t)b * L + l0) * K;
  const int tile = b * gridDim.x + blockIdx.x;

  // ---- recompute pre and h1 = cast(gelu(pre)); keep gelu'(pre)
  stage_weight(sW, We);
  for (int v = tid; v < ROWS * (H / V); v += NT) {
    const int r = v / (H / V), q = v % (H / V);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) val = reinterpret_cast<const uint4*>(E + (row0 + r) * H)[q];
    *reinterpret_cast<uint4*>(sX + r * XS + q * V) = val;
  }
  __syncthreads();

  float acc[TM][TN], dg1[TM][TN], dg2[TM][TN];
  tile_gemm<T, TM, XS>(sX, sW, r0, c0, acc);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + m;
    float y[8];
    if (r < nrows) {
      const int l = l0 + r / K;
      const int j = min(max(idx[row0 + r], 0), N - 1);
      float a[8], g[8];
      load8(A + ((size_t)b * L + l) * H + c0, a);
      load8(Gn + ((size_t)b * N + j) * H + c0, g);
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const float pre = acc[m][n] + a[n] + g[n];
        y[n] = Nm::round(gelu_tanh(pre));
        dg1[m][n] = gelu_tanh_grad(pre);
      }
      store8(s_h1 + (row0 + r) * H + c0, y);
    } else {
#pragma unroll
      for (int n = 0; n < TN; ++n) y[n] = dg1[m][n] = 0.0f;
    }
    store8(sX + r * XS + c0, y);
  }
  stage_weight(sW, W2);
  __syncthreads();

  // ---- x2 = h1 W2 + b2; keep gelu'(x2); acc <- h2 = gelu(x2)
  tile_gemm<T, TM, XS>(sX, sW, r0, c0, acc);
  {
    float bias[8];
    load8(b2 + c0, bias);
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const float x2 = acc[m][n] + bias[n];
        dg2[m][n] = gelu_tanh_grad(x2);
        acc[m][n] = gelu_tanh(x2);
      }
  }
  __syncthreads();

  float dres[TM][TN];  // K4: d resid (goes into dE); K3, K6: unused
  float part[8];
  if constexpr (!EDGE) {
    // s = cast(sum_k mask h2) per residue; W3 acts after the sum
    const float* dnode = static_cast<const float*>(dout);
    float mk[TM];
#pragma unroll
    for (int n = 0; n < TN; ++n) part[n] = 0.0f;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = r0 + m;
      mk[m] = r < nrows ? mask[row0 + r] : 0.0f;
#pragma unroll
      for (int n = 0; n < TN; ++n) part[n] += acc[m][n] * mk[m];
    }
    residue_sum(red, part, rg, c0, TL, gpr, node);
    for (int t = tid; t < TL * H; t += NT) {
      const int ll = t / H, c = t % H;
      const bool ok = l0 + ll < L;
      const size_t nrow = (size_t)b * L + l0 + ll;
      const float s = Nm::round(node[t]);
      const float d = ok ? dnode[nrow * H + c] : 0.0f;
      node2[t] = Nm::round(d);
      if (ok) {
        s_h2[nrow * H + c] = Nm::cast(s);
        s_dmsg[nrow * H + c] = Nm::cast(d);
      }
    }
    for (int ll = tid; ll < TL; ll += NT) {
      float s = 0.0f;
      if (l0 + ll < L)
        for (int k = 0; k < K; ++k) s += mask[row0 + (size_t)ll * K + k];
      msum[ll] = s;
    }
    __syncthreads();
    if (tid < H) {  // db3 = sum_l (sum_k mask) dout, f32 as on the TPU
      float s = 0.0f;
      for (int ll = 0; ll < TL; ++ll)
        if (l0 + ll < L) s += msum[ll] * dnode[((size_t)b * L + l0 + ll) * H + tid];
      p_db[((size_t)n_tiles + tile) * H + tid] = s;
    }
    // ds = cast(dout) W3^T per residue -> node
    for (int t = tid; t < TL * H; t += NT) {
      const int ll = t / H, c = t % H;
      float s = 0.0f;
      for (int i = 0; i < H; ++i) s = fmaf(node2[ll * H + i], Nm::f(W3T[i * H + c]), s);
      node[t] = s;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int ll = (r0 + m) / K;
      float ds[8];
      // idle rows past the tile's whole residues (K = 48) read no node row
      if (ll < TL) {
        load8(node + ll * H + c0, ds);
      } else {
#pragma unroll
        for (int n = 0; n < TN; ++n) ds[n] = 0.0f;
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] = ds[n] * mk[m];  // dh2
    }
  } else if constexpr (RAW) {
    // ---- dmsg is the cotangent: dW3's operands, db3 and dh2 = cast(dmsg) W3^T
    const T* dmsg_p = static_cast<const T*>(dout);
#pragma unroll
    for (int n = 0; n < TN; ++n) part[n] = 0.0f;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = r0 + m;
      float y[8], dm[8];
#pragma unroll
      for (int n = 0; n < TN; ++n) y[n] = Nm::round(acc[m][n]);
      if (r < nrows) {
        store8(s_h2 + (row0 + r) * H + c0, y);
        load8(dmsg_p + (row0 + r) * H + c0, dm);
        store8(s_dmsg + (row0 + r) * H + c0, dm);
      } else {
#pragma unroll
        for (int n = 0; n < TN; ++n) dm[n] = 0.0f;
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) part[n] += dm[n];
      store8(sX + r * XS + c0, dm);
    }
    column_sum(red, part, rg, c0, p_db + ((size_t)n_tiles + tile) * H);  // db3
    stage_weight(sW, W3T);
    __syncthreads();
    tile_gemm<T, TM, XS>(sX, sW, r0, c0, acc);  // dh2
    __syncthreads();
  } else {
    // ---- msg = cast(h2) W3 + b3 (x keep); LayerNorm; adaLN; their backward
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = r0 + m;
      float y[8];
#pragma unroll
      for (int n = 0; n < TN; ++n) y[n] = Nm::round(acc[m][n]);
      if (r < nrows) store8(s_h2 + (row0 + r) * H + c0, y);
      store8(sX + r * XS + c0, y);
    }
    stage_weight(sW, W3);
    __syncthreads();
    tile_gemm<T, TM, XS>(sX, sW, r0, c0, acc);
    __syncthreads();

    float bias[8], scv[8], gv[8], psh[8], psc[8], pdg[8];
    load8(b3 + c0, bias);
    load8(sc + (size_t)b * H + c0, scv);
    load8(gate + (size_t)b * H + c0, gv);
#pragma unroll
    for (int n = 0; n < TN; ++n) psh[n] = psc[n] = pdg[n] = part[n] = 0.0f;
    uint32_t key = 0;
    if constexpr (DROP == 2) key = sample_key(seeds[b], b);
    const T* dct_p = static_cast<const T*>(dout);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = r0 + m;
      const bool ok = r < nrows;
      float v[8], kp[8], dct[8];
      if (ok) {
        load8(E + (row0 + r) * H + c0, v);
        load8(dct_p + (row0 + r) * H + c0, dct);
        if constexpr (DROP == 1) load8(keep + (row0 + r) * H + c0, kp);
      } else {
#pragma unroll
        for (int n = 0; n < TN; ++n) v[n] = dct[n] = kp[n] = 0.0f;
      }
      if constexpr (DROP == 2) {
        const uint32_t e0 = (uint32_t)(((size_t)l0 * K + r) * H + c0);
#pragma unroll
        for (int n = 0; n < TN; ++n) kp[n] = drop_bits(key, e0 + n) >= thresh ? kscale : 0.0f;
      }
      float s = 0.0f;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        float msg = acc[m][n] + bias[n];
        if constexpr (DROP != 0) msg *= kp[n];
        v[n] += msg;
        s += v[n];
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const float mean = s / H;
      float q = 0.0f;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const float d = v[n] - mean;
        q += d * d;
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
      const float rstd = rsqrtf(q / H + 1e-6f);
      float dln[8], s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        const float ln = (v[n] - mean) * rstd;
        v[n] = ln;
        const float dgo = dct[n] * gv[n];
        psh[n] += dgo;
        psc[n] += dgo * ln;
        pdg[n] += dct[n] * ln * (1.0f + scv[n]);
        dln[n] = dgo * (1.0f + scv[n]);
        s1 += dln[n];
        s2 += dln[n] * ln;
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      const float m1 = s1 / H, m2 = s2 / H;
      float y[8];
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        dres[m][n] = rstd * (dln[n] - m1 - v[n] * m2);
        float dmsg = dres[m][n];
        if constexpr (DROP != 0) dmsg *= kp[n];
        part[n] += dmsg;
        y[n] = Nm::round(dmsg);
      }
      if (ok) store8(s_dmsg + (row0 + r) * H + c0, y);
      store8(sX + r * XS + c0, y);
    }
    float* pm = p_mod + (size_t)tile * H;
    column_sum(red, psh, rg, c0, pm);
    column_sum(red, psc, rg, c0, pm + (size_t)n_tiles * H);
    column_sum(red, pdg, rg, c0, pm + (size_t)2 * n_tiles * H);
    column_sum(red, part, rg, c0, p_db + ((size_t)n_tiles + tile) * H);  // db3
    stage_weight(sW, W3T);
    __syncthreads();
    tile_gemm<T, TM, XS>(sX, sW, r0, c0, acc);  // dh2
    __syncthreads();
  }

  // ---- dx2 = dh2 gelu'(x2); db2; dh1 = cast(dx2) W2^T
#pragma unroll
  for (int n = 0; n < TN; ++n) part[n] = 0.0f;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + m;
    float y[8];
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const float dx2 = acc[m][n] * dg2[m][n];
      part[n] += dx2;
      y[n] = Nm::round(dx2);
    }
    if (r < nrows) store8(s_dx2 + (row0 + r) * H + c0, y);
    store8(sX + r * XS + c0, y);
  }
  column_sum(red, part, rg, c0, p_db + (size_t)tile * H);  // db2
  stage_weight(sW, W2T);
  __syncthreads();
  tile_gemm<T, TM, XS>(sX, sW, r0, c0, acc);
  __syncthreads();

  // ---- dpre = dh1 gelu'(pre); dA, dGn; dE = cast(dpre) W_e^T (+ dresid)
#pragma unroll
  for (int n = 0; n < TN; ++n) part[n] = 0.0f;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + m;
    float y[8];
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const float dpre = acc[m][n] * dg1[m][n];
      part[n] += dpre;
      y[n] = Nm::round(dpre);
    }
    if (r < nrows) {
      store8(s_dpre + (row0 + r) * H + c0, y);
      const int j = min(max(idx[row0 + r], 0), N - 1);
      float* dst = dGn + ((size_t)b * N + j) * H + c0;
#pragma unroll
      for (int n = 0; n < TN; ++n) atomicAdd(dst + n, y[n]);
    }
    store8(sX + r * XS + c0, y);
  }
  stage_weight(sW, WeT);
  residue_sum(red, part, rg, c0, TL, gpr, node);  // syncs: sX, sW and node ready
  for (int t = tid; t < TL * H; t += NT) {
    const int ll = t / H;
    if (l0 + ll < L) dA[((size_t)b * L + l0) * H + t] = node[t];
  }
  tile_gemm<T, TM, XS>(sX, sW, r0, c0, acc);
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + m;
    if (r >= nrows) continue;
    if constexpr (EDGE && !RAW) {
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[m][n] += dres[m][n];
    }
    store8(dE + (row0 + r) * H + c0, acc[m]);
  }
}

template <typename T>
struct Pairs {
  const T* X[3];
  const T* Y[3];
  long long M[3];
};

// part[z][chunk][i][j] = sum over the chunk's rows m of X_z[m][i] * Y_z[m][j]
template <typename T>
__global__ void __launch_bounds__(NT)
wgrad_kernel(Pairs<T> p, int n_chunks, float* __restrict__ part) {
  constexpr int V = 16 / sizeof(T);
  __shared__ __align__(16) T sx[WROWS * H];
  __shared__ __align__(16) T sy[WROWS * H];
  const int z = blockIdx.y, chunk = blockIdx.x;
  const T* X = p.X[z];
  const T* Y = p.Y[z];
  const long long M = p.M[z];
  const long long per = ((M + n_chunks - 1) / n_chunks + WROWS - 1) / WROWS * WROWS;
  const long long m_begin = chunk * per;
  const long long m_end = min(M, m_begin + per);
  const int tid = threadIdx.x;
  const int i0 = (tid / 16) * 8, j0 = (tid % 16) * 8;
  // each 32-row step sums into `step`, which is added to `acc` with Kahan
  // compensation (`comp`): a plain running f32 sum over a chunk's ~3000 rows
  // loses ~1e-6 of the terms' scale, visible against autograd in f32
  float acc[8][8], comp[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = comp[a][c] = 0.0f;
  for (long long m0 = m_begin; m0 < m_end; m0 += WROWS) {
    float step[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) step[a][c] = 0.0f;
    for (int v = tid; v < WROWS * (H / V); v += NT) {
      const int r = v / (H / V), q = v % (H / V);
      uint4 xv = make_uint4(0u, 0u, 0u, 0u), yv = xv;
      if (m0 + r < m_end) {
        xv = reinterpret_cast<const uint4*>(X + (m0 + r) * H)[q];
        yv = reinterpret_cast<const uint4*>(Y + (m0 + r) * H)[q];
      }
      reinterpret_cast<uint4*>(sx)[v] = xv;
      reinterpret_cast<uint4*>(sy)[v] = yv;
    }
    __syncthreads();
#pragma unroll 4
    for (int mm = 0; mm < WROWS; ++mm) {
      float xv[8], yv[8];
      load8(sx + mm * H + i0, xv);
      load8(sy + mm * H + j0, yv);
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 8; ++c) step[a][c] = fmaf(xv[a], yv[c], step[a][c]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float y = step[a][c] - comp[a][c];
        const float u = acc[a][c] + y;
        comp[a][c] = (u - acc[a][c]) - y;
        acc[a][c] = u;
      }
  }
  float* dst = part + ((size_t)z * n_chunks + chunk) * H * H;
#pragma unroll
  for (int a = 0; a < 8; ++a) store8(dst + (size_t)(i0 + a) * H + j0, acc[a]);
}

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

// The weight-grad pass: f32 on CUDA cores (Kahan), bf16 on the tensor cores.
cudaError_t launch_wgrad(const Pairs<float>& pairs, int n_chunks, float* wpart,
                         cudaStream_t st) {
  wgrad_kernel<float><<<dim3(n_chunks, 3), NT, 0, st>>>(pairs, n_chunks, wpart);
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

// The weight grads of a bf16 backward from its main pass's scratch, dW =
// (E^T cast(dpre), h1^T cast(dx2), X3^T Y3) with the rows of X3 and Y3 (m3:
// the edge rows, or K3's residue rows), on the tensor cores, then the
// partial sums of dW and of db (p_db's [2, n_tiles, H] tile parts)
int bf16_grads(const void* E, const void* s_dpre, const void* s_h1, const void* s_dx2,
               const void* X3, const void* Y3, long long rows, long long m3, void* wpart,
               void* p_db, void* dW, void* db, int n_tiles, int n_chunks, cudaStream_t st) {
  Pairs<bf16> pairs;
  pairs.X[0] = static_cast<const bf16*>(E);
  pairs.Y[0] = static_cast<const bf16*>(s_dpre);
  pairs.M[0] = rows;
  pairs.X[1] = static_cast<const bf16*>(s_h1);
  pairs.Y[1] = static_cast<const bf16*>(s_dx2);
  pairs.M[1] = rows;
  pairs.X[2] = static_cast<const bf16*>(X3);
  pairs.Y[2] = static_cast<const bf16*>(Y3);
  pairs.M[2] = m3;
  const cudaError_t err = launch_wgrad(pairs, n_chunks, static_cast<float*>(wpart), st);
  if (err != cudaSuccess) return (int)err;
  const int rc = reduce(static_cast<const float*>(wpart), static_cast<float*>(dW), 3, n_chunks,
                        H * H, st);
  if (rc != 0) return rc;
  return reduce(static_cast<const float*>(p_db), static_cast<float*>(db), 2, n_tiles, H, st);
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
// ceil(L / (128 / K)). Outputs as launch_bwd's.
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
  return bf16_grads(E, s_dpre, s_h1, s_dx2, s_s, s_dout, (long long)B * L * K, (long long)B * L,
                    wpart, p_db, dW, db, n_tiles, n_chunks, st);
}

// K6's backward in bf16: the main pass, then bf16_grads with dW3 = cast(h2)^T
// dout. Scratch: s_h1, s_dx2, s_dpre, s_h2 [B*L*K, H] bf16, s_dg1 [B*L*K, H]
// f32, wpart, p_db as K3's. Outputs as launch_bwd's.
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
  return bf16_grads(E, s_dpre, s_h1, s_dx2, s_h2, dout, rows, rows, wpart, p_db, dW, db,
                    n_tiles, n_chunks, st);
}

// K4 / K5's backward in bf16 (DROP 0, 1: keep, 2: seeds): the main pass, then
// bf16_grads with dW3 = cast(h2)^T cast(dmsg), then dmod's partial sums.
// Scratch: K6's and s_dmsg [B*L*K, H] bf16, s_dg2, s_dres [B*L*K, H] f32,
// p_mod f32 [3, n_tiles, H]. Outputs as launch_bwd's.
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
  const int rc = bf16_grads(E, s_dpre, s_h1, s_dx2, s_h2, s_dmsg, rows, rows, wpart, p_db, dW,
                            db, n_tiles, n_chunks, st);
  if (rc != 0) return rc;
  return reduce(static_cast<const float*>(p_mod), static_cast<float*>(dmod), 3 * B, ntl, H, st);
}

// The f32 backwards on CUDA cores. Scratch (from the wrapper): s_h1, s_dx2,
// s_dpre [B*L*K, H] and s_h2, s_dmsg ([B*L*K, H] for K4, [B*L, H] for K3) in T;
// wpart f32 [3, n_chunks, H, H];
// p_db f32 [2, n_tiles, H]; p_mod f32 [3, n_tiles, H] (K4).
// Outputs: dA f32 [B, L, H], dE T [B, L, K, H], dGn f32 [B, N, H] (zeroed by
// the wrapper), dW f32 [3, H, H] (dW_e, dW2, dW3), db f32 [2, H] (db2, db3),
// dmod f32 [3, B, H] (dsh, dsc, dgate without its sh term; K4; not K6).
template <typename T, bool EDGE, int DROP, bool RAW = false>
int launch_bwd(const void* A, const void* E, const void* Gn, const void* idx,
               const void* mask, const void* We, const void* WeT, const void* W2,
               const void* W2T, const void* b2, const void* W3, const void* W3T,
               const void* b3, const void* sc, const void* gate, const void* keep,
               const void* seeds, uint32_t thresh, float kscale, const void* dout,
               void* dA, void* dE, void* dGn, void* s_h1, void* s_dx2, void* s_dpre,
               void* s_h2, void* s_dmsg, void* wpart, void* p_db, void* p_mod, void* dW,
               void* db, void* dmod, int B, int L, int K, int N, int n_tiles,
               int n_chunks, void* stream) {
  if (B <= 0 || L <= 0 || N <= 0 || K <= 0 || K > ROWS || K % TM != 0 ||
      n_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  const int TL = ROWS / K;
  const int ntl = (L + TL - 1) / TL;
  if (n_tiles != B * ntl) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)H * H * sizeof(T) +
                      (size_t)ROWS * (H + Pad<T>::XPAD) * sizeof(T) +
                      ((size_t)RG * H + 2 * (ROWS / TM) * H + (ROWS / TM)) * sizeof(float);
  auto kern = chain_bwd_kernel<T, EDGE, DROP, RAW>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(ntl, B), NT, smem, st>>>(
      static_cast<const T*>(A), static_cast<const T*>(E), static_cast<const T*>(Gn),
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const T*>(We), static_cast<const T*>(WeT), static_cast<const T*>(W2),
      static_cast<const T*>(W2T), static_cast<const float*>(b2), static_cast<const T*>(W3),
      static_cast<const T*>(W3T), static_cast<const float*>(b3),
      static_cast<const float*>(sc), static_cast<const float*>(gate),
      static_cast<const T*>(keep), static_cast<const int*>(seeds), thresh, kscale, dout,
      static_cast<float*>(dA), static_cast<T*>(dE), static_cast<float*>(dGn),
      static_cast<T*>(s_h1), static_cast<T*>(s_dx2), static_cast<T*>(s_dpre),
      static_cast<T*>(s_h2), static_cast<T*>(s_dmsg), static_cast<float*>(p_db),
      static_cast<float*>(p_mod), L, K, N, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long rows = (long long)B * L * K;
  Pairs<T> pairs;
  pairs.X[0] = static_cast<const T*>(E);
  pairs.Y[0] = static_cast<const T*>(s_dpre);
  pairs.M[0] = rows;
  pairs.X[1] = static_cast<const T*>(s_h1);
  pairs.Y[1] = static_cast<const T*>(s_dx2);
  pairs.M[1] = rows;
  pairs.X[2] = static_cast<const T*>(s_h2);
  pairs.Y[2] = static_cast<const T*>(s_dmsg);
  pairs.M[2] = EDGE ? rows : (long long)B * L;
  err = launch_wgrad(pairs, n_chunks, static_cast<float*>(wpart), st);
  if (err != cudaSuccess) return (int)err;

  int rc = reduce(static_cast<const float*>(wpart), static_cast<float*>(dW), 3, n_chunks,
                  H * H, st);
  if (rc != 0) return rc;
  rc = reduce(static_cast<const float*>(p_db), static_cast<float*>(db), 2, n_tiles, H, st);
  if (rc != 0) return rc;
  if (EDGE && !RAW)
    rc = reduce(static_cast<const float*>(p_mod), static_cast<float*>(dmod), 3 * B, ntl, H,
                st);
  return rc;
}

}  // namespace

extern "C" {

int message_sum_bwd_f32(const void* A, const void* E, const void* Gn, const void* idx,
                        const void* mask, const void* We, const void* WeT, const void* W2,
                        const void* W2T, const void* b2, const void* W3T, const void* dout,
                        void* dA, void* dE, void* dGn, void* s_h1, void* s_dx2, void* s_dpre,
                        void* s_s, void* s_dout, void* wpart, void* p_db, void* dW, void* db,
                        int B, int L, int K, int N, int n_tiles, int n_chunks, void* stream) {
  return launch_bwd<float, false, 0>(A, E, Gn, idx, mask, We, WeT, W2, W2T, b2, nullptr, W3T,
                                     nullptr, nullptr, nullptr, nullptr, nullptr, 0u, 1.0f,
                                     dout, dA, dE, dGn, s_h1, s_dx2, s_dpre, s_s, s_dout, wpart,
                                     p_db, nullptr, dW, db, nullptr, B, L, K, N, n_tiles,
                                     n_chunks, stream);
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
// f32 on CUDA cores, with W_e, W2, W3 and their transposes
int message_edge_lnmod_bwd_f32(const void* A, const void* E, const void* Gn, const void* idx,
                               const void* We, const void* WeT, const void* W2,
                               const void* W2T, const void* b2, const void* W3,
                               const void* W3T, const void* b3, const void* sc,
                               const void* gate, const void* keep, const void* seeds,
                               const void* dout, void* dA, void* dE, void* dGn, void* s_h1,
                               void* s_dx2, void* s_dpre, void* s_h2, void* s_dmsg,
                               void* wpart, void* p_db, void* p_mod, void* dW, void* db,
                               void* dmod, int B, int L, int K, int N, int n_tiles,
                               int n_chunks, unsigned thresh, float kscale, void* stream) {
  if (keep != nullptr && seeds != nullptr) return (int)cudaErrorInvalidValue;
  if (keep != nullptr)
    return launch_bwd<float, true, 1>(A, E, Gn, idx, nullptr, We, WeT, W2, W2T, b2, W3, W3T,
                                      b3, sc, gate, keep, nullptr, 0u, 1.0f, dout, dA, dE, dGn,
                                      s_h1, s_dx2, s_dpre, s_h2, s_dmsg, wpart, p_db, p_mod,
                                      dW, db, dmod, B, L, K, N, n_tiles, n_chunks, stream);
  if (seeds != nullptr)
    return launch_bwd<float, true, 2>(A, E, Gn, idx, nullptr, We, WeT, W2, W2T, b2, W3, W3T,
                                      b3, sc, gate, nullptr, seeds, thresh, kscale, dout, dA,
                                      dE, dGn, s_h1, s_dx2, s_dpre, s_h2, s_dmsg, wpart, p_db,
                                      p_mod, dW, db, dmod, B, L, K, N, n_tiles, n_chunks,
                                      stream);
  return launch_bwd<float, true, 0>(A, E, Gn, idx, nullptr, We, WeT, W2, W2T, b2, W3, W3T, b3,
                                    sc, gate, nullptr, nullptr, 0u, 1.0f, dout, dA, dE, dGn,
                                    s_h1, s_dx2, s_dpre, s_h2, s_dmsg, wpart, p_db, p_mod, dW,
                                    db, dmod, B, L, K, N, n_tiles, n_chunks, stream);
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

// K6's backward: dout [B, L, K, H] in E's dtype; scratch and outputs as K4's,
// without p_mod and dmod. f32 on CUDA cores with the transposes:
int message_edge_bwd_f32(const void* A, const void* E, const void* Gn, const void* idx,
                         const void* We, const void* WeT, const void* W2, const void* W2T,
                         const void* b2, const void* W3T, const void* dout, void* dA,
                         void* dE, void* dGn, void* s_h1, void* s_dx2, void* s_dpre,
                         void* s_h2, void* s_dmsg, void* wpart, void* p_db, void* dW, void* db,
                         int B, int L, int K, int N, int n_tiles, int n_chunks, void* stream) {
  return launch_bwd<float, true, 0, true>(A, E, Gn, idx, nullptr, We, WeT, W2, W2T, b2, nullptr,
                                          W3T, nullptr, nullptr, nullptr, nullptr, nullptr, 0u,
                                          1.0f, dout, dA, dE, dGn, s_h1, s_dx2, s_dpre, s_h2,
                                          s_dmsg, wpart, p_db, nullptr, dW, db, nullptr, B, L, K,
                                          N, n_tiles, n_chunks, stream);
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
