// Fused MPNN message chains for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels of codlad_tpu/kernels/mpnn_kernels.py:
//   K1 message_sum_*        <- _sum_kernel / _pallas_message_sum
//   K2 message_edge_lnmod_* <- _edge_lnmod_kernel / _pallas_message_edge_lnmod
//   K5 message_edge_lnmod_drop_* (forward) <- _edge_lnmod_kernel with has_keep
//      (fused_message_edge_lnmod_drop) or drop_p (fused_message_edge_lnmod_pdrop,
//      mask from _inkernel_keep); here the mask is the counter hash of
//      chain_common.cuh, a pure function of (seed, sample, element)
//
// Per edge (l, k) of a [B, L, K, H] tile:
//   pre = A[l] + E[l,k] W_e + Gn[idx[l,k]]
//   h2  = gelu(cast(gelu(pre)) W2 + b2)                    (tanh gelu)
// K1:  out[l] = (cast(sum_k mask*h2) W3 + (sum_k mask) b3) / scale   -> f32
// K2:  out[l,k] = g * (LN(E + cast(h2) W3 + b3) * (1 + sc) + sh)      -> dtype of E
// cast() rounds to the edge dtype where the TPU kernel does; every product
// accumulates in f32.
//
// Design. One block of 256 threads owns ROWS = 16*TM edge rows (TM = 8 rows per
// thread in bf16, 4 in f32), i.e. floor(ROWS/K) whole residues, so K1's masked
// K-sum stays inside the block. Where K does not divide ROWS (K = 48) the rows
// past the last whole residue stay idle: they load zeros and store nothing. W_e, W2 (and W3 for K2) are staged once per block in
// shared memory; the edge tile lives in shared memory row-major and is
// overwritten in place by each activation. Each thread computes a TM x 8 tile
// of every H x H product on CUDA cores in f32. The neighbour table is read by
// index (Gn[b, idx]) instead of the TPU's one-hot selection matmul. K2's
// LayerNorm reduces over the 16 lanes that share a row with warp shuffles.
//
// Bound on an H100 at the bench shape (B96 L128 K64 H128, bf16): the two
// per-edge H x H products are ~52 GFLOP for K1 (~77 GFLOP for K2); the bytes
// moved (the E tile read once, plus K2's write) put the floor at tens of
// microseconds. This version does the products on CUDA cores, so it is bound
// by f32 FMA issue, not by memory; tensor-core (mma/wgmma) tiles are later work.

#include "chain_common.cuh"

namespace {

using namespace chain;

template <typename T> struct Traits;

template <> struct Traits<float> : Num<float> {
  static constexpr int TM = 4;    // rows per thread
  static constexpr int XPAD = 4;  // shared-memory row padding (elements)
};

template <> struct Traits<__nv_bfloat16> : Num<__nv_bfloat16> {
  static constexpr int TM = 8;
  static constexpr int XPAD = 8;
};

template <typename T>
__device__ __forceinline__ void fwd_gemm(const T* sX, const T* sW, int r0, int c0,
                                          float (&acc)[Traits<T>::TM][TN]) {
  chain::tile_gemm<T, Traits<T>::TM, H + Traits<T>::XPAD>(sX, sW, r0, c0, acc);
}

// EDGE = false: K1 (masked K-sum, f32 [B, L, H] out).
// EDGE = true:  K2 (per-edge W3, residual LayerNorm and adaLN, [B, L, K, H] out),
//   with dropout on the message before the residual (K5 forward) when
//   DROP = 1 (keep scales read from `keep`, E's dtype) or DROP = 2 (keep
//   scales made here from `seeds` by the counter hash; `mask_out`, when not
//   null, receives them as f32 for validation).
template <typename T, bool EDGE, int DROP>
__global__ void __launch_bounds__(NT)
chain_kernel(const T* __restrict__ A, const T* __restrict__ E, const T* __restrict__ Gn,
             const int* __restrict__ idx, const float* __restrict__ mask,
             const T* __restrict__ We, const T* __restrict__ W2,
             const float* __restrict__ b2, const T* __restrict__ W3,
             const float* __restrict__ b3, const float* __restrict__ sh,
             const float* __restrict__ sc, const float* __restrict__ gate,
             const T* __restrict__ keep, const int* __restrict__ seeds,
             uint32_t thresh, float kscale, float* __restrict__ mask_out,
             void* __restrict__ out, int L, int K, int N, float scale) {
  using Tr = Traits<T>;
  constexpr int TM = Tr::TM;
  constexpr int ROWS = RG * TM;
  constexpr int XS = H + Tr::XPAD;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector

  extern __shared__ __align__(16) unsigned char smem[];
  T* sWe = reinterpret_cast<T*>(smem);
  T* sW2 = sWe + H * H;
  T* sW3 = sW2 + H * H;             // staged by K2 only
  T* sX = EDGE ? sW3 + H * H : sW3; // [ROWS][XS] edge tile / activations

  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const int r0 = rg * TM, c0 = cg * TN;
  const int TL = ROWS / K;  // whole residues per block; rows past TL*K idle
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * TL;
  const int nrows = min(TL, L - l0) * K;  // valid edge rows of this tile
  const size_t row0 = ((size_t)b * L + l0) * K;

  for (int v = tid; v < H * H / V; v += NT) {
    reinterpret_cast<uint4*>(sWe)[v] = reinterpret_cast<const uint4*>(We)[v];
    reinterpret_cast<uint4*>(sW2)[v] = reinterpret_cast<const uint4*>(W2)[v];
    if (EDGE) reinterpret_cast<uint4*>(sW3)[v] = reinterpret_cast<const uint4*>(W3)[v];
  }
  for (int v = tid; v < ROWS * (H / V); v += NT) {
    const int r = v / (H / V), q = v % (H / V);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) val = reinterpret_cast<const uint4*>(E + (row0 + r) * H)[q];
    *reinterpret_cast<uint4*>(sX + r * XS + q * V) = val;
  }
  __syncthreads();

  float acc[TM][TN];
  float y[TM][TN];
  fwd_gemm<T>(sX, sWe, r0, c0, acc);

  // pre = A[l] + E W_e + Gn[idx]; keep cast(gelu(pre)) for the next product.
  // Indices come from the kNN builder; they are clamped so that a bad index
  // can never read outside Gn.
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = r0 + m;
    if (r < nrows) {
      const int l = l0 + r / K;
      const int j = min(max(idx[row0 + r], 0), N - 1);
      float a[8], g[8];
      load8(A + ((size_t)b * L + l) * H + c0, a);
      load8(Gn + ((size_t)b * N + j) * H + c0, g);
#pragma unroll
      for (int n = 0; n < TN; ++n) y[m][n] = Tr::round(gelu_tanh(acc[m][n] + a[n] + g[n]));
    } else {
#pragma unroll
      for (int n = 0; n < TN; ++n) y[m][n] = 0.0f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < TM; ++m) store8(sX + (r0 + m) * XS + c0, y[m]);
  __syncthreads();

  fwd_gemm<T>(sX, sW2, r0, c0, acc);
  float bias[8];
  load8(b2 + c0, bias);
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = gelu_tanh(acc[m][n] + bias[n]);  // h2

  if constexpr (!EDGE) {
    // masked sum over this thread's TM rows (all of one residue: K % TM == 0)
    float part[8];
#pragma unroll
    for (int n = 0; n < TN; ++n) part[n] = 0.0f;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = r0 + m;
      const float mk = r < nrows ? mask[row0 + r] : 0.0f;
#pragma unroll
      for (int n = 0; n < TN; ++n) part[n] += acc[m][n] * mk;
    }
    __syncthreads();  // every product has finished reading sX
    float* red = reinterpret_cast<float*>(sX);  // [RG][H] per-row-group sums
    float* ssum = red + RG * H;                 // [TL][H] node sums (edge dtype)
    float* msum = ssum + TL * H;                // [TL] mask counts
    store8(red + rg * H + c0, part);
    __syncthreads();
    const int gpr = K / TM;  // row groups per residue
    for (int t = tid; t < TL * H; t += NT) {
      const int ll = t / H, c = t % H;
      float s = 0.0f;
      for (int q = 0; q < gpr; ++q) s += red[(ll * gpr + q) * H + c];
      ssum[t] = Tr::round(s);
    }
    for (int ll = tid; ll < TL; ll += NT) {
      float s = 0.0f;
      if (l0 + ll < L)
        for (int k = 0; k < K; ++k) s += mask[row0 + (size_t)ll * K + k];
      msum[ll] = s;
    }
    __syncthreads();
    float* o = static_cast<float*>(out);
    for (int t = tid; t < TL * H; t += NT) {
      const int ll = t / H, c = t % H;
      if (l0 + ll >= L) continue;
      float s = 0.0f;
      for (int i = 0; i < H; ++i) s = fmaf(ssum[ll * H + i], Tr::f(W3[i * H + c]), s);
      s += msum[ll] * b3[c];
      o[((size_t)b * L + l0 + ll) * H + c] = s / scale;
    }
  } else {
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) y[m][n] = Tr::round(acc[m][n]);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < TM; ++m) store8(sX + (r0 + m) * XS + c0, y[m]);
    __syncthreads();

    fwd_gemm<T>(sX, sW3, r0, c0, acc);
    float shv[8], scv[8], gv[8];
    load8(b3 + c0, bias);
    load8(sh + (size_t)b * H + c0, shv);
    load8(sc + (size_t)b * H + c0, scv);
    load8(gate + (size_t)b * H + c0, gv);
    T* o = static_cast<T*>(out);
    uint32_t key = 0;
    if constexpr (DROP == 2) key = sample_key(seeds[b], b);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = r0 + m;
      float v[8], kp[8];
      if (r < nrows) {
        load8(E + (row0 + r) * H + c0, v);
        if constexpr (DROP == 1) load8(keep + (row0 + r) * H + c0, kp);
      } else {
#pragma unroll
        for (int n = 0; n < TN; ++n) v[n] = kp[n] = 0.0f;
      }
      if constexpr (DROP == 2) {
        const uint32_t e0 = (uint32_t)(((size_t)l0 * K + r) * H + c0);
#pragma unroll
        for (int n = 0; n < TN; ++n) kp[n] = drop_bits(key, e0 + n) >= thresh ? kscale : 0.0f;
        if (mask_out != nullptr && r < nrows) store8(mask_out + (row0 + r) * H + c0, kp);
      }
      float s = 0.0f;
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        float msg = acc[m][n] + bias[n];
        if constexpr (DROP != 0) msg *= kp[n];
        v[n] = v[n] + msg;
        s += v[n];
      }
      // the 16 lanes of a row are 16 consecutive lanes of one warp
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
#pragma unroll
      for (int n = 0; n < TN; ++n)
        v[n] = gv[n] * (((v[n] - mean) * rstd) * (1.0f + scv[n]) + shv[n]);
      if (r < nrows) store8(o + (row0 + r) * H + c0, v);
    }
  }
}

template <typename T, bool EDGE, int DROP>
int launch(const void* A, const void* E, const void* Gn, const void* idx,
           const void* mask, const void* We, const void* W2, const void* b2,
           const void* W3, const void* b3, const void* sh, const void* sc,
           const void* gate, const void* keep, const void* seeds, uint32_t thresh,
           float kscale, void* mask_out, void* out, int B, int L, int K, int N,
           float scale, void* stream) {
  constexpr int TM = Traits<T>::TM;
  constexpr int ROWS = RG * TM;
  if (B <= 0 || L <= 0 || N <= 0 || K <= 0 || K > ROWS || K % TM != 0)
    return (int)cudaErrorInvalidValue;
  const int TL = ROWS / K;
  const size_t smem = (size_t)(EDGE ? 3 : 2) * H * H * sizeof(T) +
                      (size_t)ROWS * (H + Traits<T>::XPAD) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<T, EDGE, DROP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + TL - 1) / TL, B);
  chain_kernel<T, EDGE, DROP><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(E), static_cast<const T*>(Gn),
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const T*>(We), static_cast<const T*>(W2),
      static_cast<const float*>(b2), static_cast<const T*>(W3),
      static_cast<const float*>(b3), static_cast<const float*>(sh),
      static_cast<const float*>(sc), static_cast<const float*>(gate),
      static_cast<const T*>(keep), static_cast<const int*>(seeds), thresh, kscale,
      static_cast<float*>(mask_out), out, L, K, N, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int message_sum_f32(const void* A, const void* E, const void* Gn, const void* idx,
                    const void* mask, const void* We, const void* W2, const void* b2,
                    const void* W3, const void* b3, void* out, int B, int L, int K,
                    int N, float scale, void* stream) {
  return launch<float, false, 0>(A, E, Gn, idx, mask, We, W2, b2, W3, b3, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, 0u, 1.0f, nullptr,
                                 out, B, L, K, N, scale, stream);
}

int message_sum_bf16(const void* A, const void* E, const void* Gn, const void* idx,
                     const void* mask, const void* We, const void* W2, const void* b2,
                     const void* W3, const void* b3, void* out, int B, int L, int K,
                     int N, float scale, void* stream) {
  return launch<__nv_bfloat16, false, 0>(A, E, Gn, idx, mask, We, W2, b2, W3, b3,
                                         nullptr, nullptr, nullptr, nullptr, nullptr,
                                         0u, 1.0f, nullptr, out, B, L, K, N, scale,
                                         stream);
}

int message_edge_lnmod_f32(const void* A, const void* E, const void* Gn,
                           const void* idx, const void* We, const void* W2,
                           const void* b2, const void* W3, const void* b3,
                           const void* sh, const void* sc, const void* gate, void* out,
                           int B, int L, int K, int N, void* stream) {
  return launch<float, true, 0>(A, E, Gn, idx, nullptr, We, W2, b2, W3, b3, sh, sc,
                                gate, nullptr, nullptr, 0u, 1.0f, nullptr, out, B, L, K,
                                N, 1.0f, stream);
}

int message_edge_lnmod_bf16(const void* A, const void* E, const void* Gn,
                            const void* idx, const void* We, const void* W2,
                            const void* b2, const void* W3, const void* b3,
                            const void* sh, const void* sc, const void* gate, void* out,
                            int B, int L, int K, int N, void* stream) {
  return launch<__nv_bfloat16, true, 0>(A, E, Gn, idx, nullptr, We, W2, b2, W3, b3, sh,
                                        sc, gate, nullptr, nullptr, 0u, 1.0f, nullptr,
                                        out, B, L, K, N, 1.0f, stream);
}

// K5 forward: K2 with dropout on the message. Exactly one of `keep` (E's
// dtype, [B, L, K, H] scales 0 or 1/(1-p)) and `seeds` (int32 [B]) is given;
// with seeds, `mask_out` (f32 [B, L, K, H]) may receive the generated scales.
#define EDGE_DROP(SUFFIX, TYPE)                                                        \
  int message_edge_lnmod_drop_##SUFFIX(                                                \
      const void* A, const void* E, const void* Gn, const void* idx, const void* We,   \
      const void* W2, const void* b2, const void* W3, const void* b3, const void* sh,  \
      const void* sc, const void* gate, const void* keep, const void* seeds,           \
      void* mask_out, void* out, int B, int L, int K, int N, unsigned thresh,          \
      float kscale, void* stream) {                                                    \
    if ((keep == nullptr) == (seeds == nullptr)) return (int)cudaErrorInvalidValue;    \
    if (keep != nullptr)                                                               \
      return launch<TYPE, true, 1>(A, E, Gn, idx, nullptr, We, W2, b2, W3, b3, sh, sc, \
                                   gate, keep, nullptr, 0u, 1.0f, nullptr, out, B, L,  \
                                   K, N, 1.0f, stream);                                \
    return launch<TYPE, true, 2>(A, E, Gn, idx, nullptr, We, W2, b2, W3, b3, sh, sc,   \
                                 gate, nullptr, seeds, thresh, kscale, mask_out, out,  \
                                 B, L, K, N, 1.0f, stream);                            \
  }

EDGE_DROP(f32, float)
EDGE_DROP(bf16, __nv_bfloat16)

}  // extern "C"
