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
//  * chain_bwd_kernel: one block of 256 threads per 64-row tile
//    (floor(64/K) whole residues; at K = 48 the last 16 rows stay idle). It recomputes the activations from the inputs (nothing
//    [B, L, K, H]-sized is saved by the forward), keeps pre/x2 as their gelu
//    derivatives in registers, and does every row-wise product on CUDA cores
//    through one shared [H, H] weight buffer that is restaged for each product
//    (the transposed weights come from the wrapper). It writes dE and dA,
//    scatter-adds cast(dpre) into the f32 dGn with atomicAdd (the one source of
//    run-to-run differences: the order of f32 additions), and writes per-tile
//    column sums (db2, db3, dsh, dsc, dgate) and the product operands of the
//    weight grads (h1, cast(dx2), cast(dpre), cast(h2) or s, cast(dmsg) or
//    cast(dout)) in the edge dtype to scratch.
//  * wgrad_kernel: dW = X^T Y for the three operand pairs, each block summing
//    one chunk of rows into an [H, H] partial in registers (8 x 8 a thread).
//  * sum_partials: a second pass that adds the partials in a fixed order
//    (compensated), so the weight and per-sample grads are deterministic.
//
// Bound on an H100 at the training shape (B96 L128 K64 H128, bf16): K3 does
// about 6 B*L*K x H x H products (2 recomputed, dh1, dE, dW2, dW_e), K4 about 9,
// 25.8 GFLOP each; the bytes (E and dout read, dE written) put the floor at
// ~0.1-0.2 ms. On CUDA cores in f32 the kernels are bound by the FMA rate.

#include "chain_common.cuh"

namespace {

using namespace chain;

constexpr int TM = 4;          // rows per thread, both dtypes
constexpr int ROWS = RG * TM;  // 64 edge rows per block
constexpr int WROWS = 32;      // rows per staging step of wgrad_kernel

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int XPAD = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int XPAD = 8; };

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

// Scratch (from the wrapper): s_h1, s_dx2, s_dpre [B*L*K, H] and s_h2, s_dmsg
// ([B*L*K, H] for K4, [B*L, H] for K3) in T; wpart f32 [3, n_chunks, H, H];
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
  wgrad_kernel<T><<<dim3(n_chunks, 3), NT, 0, st>>>(pairs, n_chunks,
                                                    static_cast<float*>(wpart));
  err = cudaGetLastError();
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

#define SUM_BWD(SUFFIX, TYPE)                                                           \
  int message_sum_bwd_##SUFFIX(                                                         \
      const void* A, const void* E, const void* Gn, const void* idx, const void* mask,  \
      const void* We, const void* WeT, const void* W2, const void* W2T, const void* b2, \
      const void* W3T, const void* dout, void* dA, void* dE, void* dGn, void* s_h1,     \
      void* s_dx2, void* s_dpre, void* s_s, void* s_dout, void* wpart, void* p_db,      \
      void* dW, void* db, int B, int L, int K, int N, int n_tiles, int n_chunks,        \
      void* stream) {                                                                   \
    return launch_bwd<TYPE, false, 0>(                                                  \
        A, E, Gn, idx, mask, We, WeT, W2, W2T, b2, nullptr, W3T, nullptr, nullptr,      \
        nullptr, nullptr, nullptr, 0u, 1.0f, dout, dA, dE, dGn, s_h1, s_dx2, s_dpre,    \
        s_s, s_dout, wpart, p_db, nullptr, dW, db, nullptr, B, L, K, N, n_tiles,        \
        n_chunks, stream);                                                              \
  }

SUM_BWD(f32, float)
SUM_BWD(bf16, __nv_bfloat16)

// K4, and K5's backward when `keep` (E's dtype) or `seeds` (int32 [B]) is given.
#define EDGE_BWD(SUFFIX, TYPE)                                                          \
  int message_edge_lnmod_bwd_##SUFFIX(                                                  \
      const void* A, const void* E, const void* Gn, const void* idx, const void* We,    \
      const void* WeT, const void* W2, const void* W2T, const void* b2, const void* W3, \
      const void* W3T, const void* b3, const void* sc, const void* gate,                \
      const void* keep, const void* seeds, const void* dout, void* dA, void* dE,        \
      void* dGn, void* s_h1, void* s_dx2, void* s_dpre, void* s_h2, void* s_dmsg,       \
      void* wpart, void* p_db, void* p_mod, void* dW, void* db, void* dmod, int B,      \
      int L, int K, int N, int n_tiles, int n_chunks, unsigned thresh, float kscale,    \
      void* stream) {                                                                   \
    if (keep != nullptr && seeds != nullptr) return (int)cudaErrorInvalidValue;         \
    if (keep != nullptr)                                                                \
      return launch_bwd<TYPE, true, 1>(                                                 \
          A, E, Gn, idx, nullptr, We, WeT, W2, W2T, b2, W3, W3T, b3, sc, gate, keep,    \
          nullptr, 0u, 1.0f, dout, dA, dE, dGn, s_h1, s_dx2, s_dpre, s_h2, s_dmsg,      \
          wpart, p_db, p_mod, dW, db, dmod, B, L, K, N, n_tiles, n_chunks, stream);     \
    if (seeds != nullptr)                                                               \
      return launch_bwd<TYPE, true, 2>(                                                 \
          A, E, Gn, idx, nullptr, We, WeT, W2, W2T, b2, W3, W3T, b3, sc, gate, nullptr, \
          seeds, thresh, kscale, dout, dA, dE, dGn, s_h1, s_dx2, s_dpre, s_h2, s_dmsg,  \
          wpart, p_db, p_mod, dW, db, dmod, B, L, K, N, n_tiles, n_chunks, stream);     \
    return launch_bwd<TYPE, true, 0>(                                                   \
        A, E, Gn, idx, nullptr, We, WeT, W2, W2T, b2, W3, W3T, b3, sc, gate, nullptr,   \
        nullptr, 0u, 1.0f, dout, dA, dE, dGn, s_h1, s_dx2, s_dpre, s_h2, s_dmsg, wpart, \
        p_db, p_mod, dW, db, dmod, B, L, K, N, n_tiles, n_chunks, stream);              \
  }

EDGE_BWD(f32, float)
EDGE_BWD(bf16, __nv_bfloat16)

// K6's backward: dout [B, L, K, H] in E's dtype; scratch and outputs as K4's,
// without p_mod and dmod.
#define MESSAGE_EDGE_BWD(SUFFIX, TYPE)                                                  \
  int message_edge_bwd_##SUFFIX(                                                        \
      const void* A, const void* E, const void* Gn, const void* idx, const void* We,    \
      const void* WeT, const void* W2, const void* W2T, const void* b2,                 \
      const void* W3T, const void* dout, void* dA, void* dE, void* dGn, void* s_h1,     \
      void* s_dx2, void* s_dpre, void* s_h2, void* s_dmsg, void* wpart, void* p_db,     \
      void* dW, void* db, int B, int L, int K, int N, int n_tiles, int n_chunks,        \
      void* stream) {                                                                   \
    return launch_bwd<TYPE, true, 0, true>(                                             \
        A, E, Gn, idx, nullptr, We, WeT, W2, W2T, b2, nullptr, W3T, nullptr, nullptr,   \
        nullptr, nullptr, nullptr, 0u, 1.0f, dout, dA, dE, dGn, s_h1, s_dx2, s_dpre,    \
        s_h2, s_dmsg, wpart, p_db, nullptr, dW, db, nullptr, B, L, K, N, n_tiles,       \
        n_chunks, stream);                                                              \
  }

MESSAGE_EDGE_BWD(f32, float)
MESSAGE_EDGE_BWD(bf16, __nv_bfloat16)

}  // extern "C"
