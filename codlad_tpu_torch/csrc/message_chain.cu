// Fused MPNN message chains for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels of codlad_tpu/kernels/mpnn_kernels.py:
//   K1 message_sum_*        <- _sum_kernel / _pallas_message_sum
//   K2 message_edge_lnmod_* <- _edge_lnmod_kernel / _pallas_message_edge_lnmod
//   K5 message_edge_lnmod_drop_* (forward) <- _edge_lnmod_kernel with has_keep
//      (fused_message_edge_lnmod_drop) or drop_p (fused_message_edge_lnmod_pdrop,
//      mask from _inkernel_keep); here the mask is the counter hash of
//      chain_common.cuh, a pure function of (seed, sample, element)
//   K6 message_edge_*       <- _edge_kernel / _pallas_message_edge
//   K7 edge_then_sum_*      <- _edge_then_sum_kernel / _pallas_edge_then_sum
//
// Per edge (l, k) of a [B, L, K, H] tile:
//   pre = A[l] + E[l,k] W_e + Gn[idx[l,k]]
//   h2  = gelu(cast(gelu(pre)) W2 + b2)                    (tanh gelu)
// K1:  out[l] = (cast(sum_k mask*h2) W3 + (sum_k mask) b3) / scale   -> f32
// K2:  out[l,k] = g * (LN(E + cast(h2) W3 + b3) * (1 + sc) + sh)      -> dtype of E
// K6:  out[l,k] = cast(h2) W3 + b3                                    -> dtype of E
// K7:  e2 = K2 of the first weight set (cast to E's dtype), then K1 of the
//      second weight set and the mask with e2 as its edge operand -> (e2, f32 sum)
// cast() rounds to the edge dtype where the TPU kernel does; every product
// accumulates in f32.
//
// Design. One block of 256 threads owns ROWS = 16*TM edge rows (TM = 8 rows per
// thread in bf16, 4 in f32), i.e. floor(ROWS/K) whole residues, so K1's masked
// K-sum stays inside the block. Where K does not divide ROWS (K = 48) the rows
// past the last whole residue stay idle: they load zeros and store nothing. W_e,
// W2 (and W3 for K2/K6) are staged once per block in shared memory; the edge tile
// lives in shared memory row-major and is overwritten in place by each
// activation. Each thread computes a TM x 8 tile of every H x H product on CUDA
// cores in f32. The neighbour table is read by index (Gn[b, idx]) instead of the
// TPU's one-hot selection matmul. K2's LayerNorm reduces over the 16 lanes that
// share a row with warp shuffles.
//
// K7 keeps e2 in the block: the edge half writes it to device memory and into
// the shared edge tile, and the node half runs K1's chain on that tile. Three
// H x H matrices and the tile already fill a block's shared memory in f32 (226
// of 227 KB), so the two weight sets are never resident together. K7 holds two
// weight buffers only, K1's footprint (98 KB in bf16: two blocks an SM, where
// K2's three matrices allow one): each buffer is restaged as soon as every
// thread is done with its product, buffer 0 W_e -> W3 -> node W2, buffer 1
// W2 -> node W_e; K1's W3 acts per residue and is read from global memory, as
// in K1.
//
// Bound on an H100 at the bench shape (B96 L128 K64 H128, bf16): the two
// per-edge H x H products are ~52 GFLOP for K1 (~77 GFLOP for K2 and K6, ~129 for
// K7); the bytes moved (the E tile read once, plus the edge output's write) put
// the floor at tens of microseconds. This version does the products on CUDA
// cores, so it is bound by the f32 FMA rate, not by memory; tensor-core
// (mma/wgmma) tiles are later work.

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

// The block's tile: TL whole residues of sample b from residue l0; this thread
// owns rows r0 .. r0 + TM - 1 (row group rg) and columns c0 .. c0 + 7.
struct Tile {
  int b, l0, TL, nrows, rg, r0, c0;
  size_t row0;  // first edge row of the tile in [B * L * K]
};

template <typename T>
__device__ __forceinline__ Tile make_tile(int L, int K) {
  constexpr int ROWS = RG * Traits<T>::TM;
  Tile t;
  t.rg = threadIdx.x / CG;
  t.r0 = t.rg * Traits<T>::TM;
  t.c0 = (threadIdx.x % CG) * TN;
  t.TL = ROWS / K;  // rows past TL*K idle
  t.b = blockIdx.y;
  t.l0 = blockIdx.x * t.TL;
  t.nrows = min(t.TL, L - t.l0) * K;
  t.row0 = ((size_t)t.b * L + t.l0) * K;
  return t;
}

// dst[0:H*H] = src[0:H*H], 16 bytes a thread and step
template <typename T>
__device__ __forceinline__ void stage_weight(T* dst, const T* src) {
  constexpr int V = 16 / sizeof(T);
  for (int v = threadIdx.x; v < H * H / V; v += NT)
    reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(src)[v];
}

// sX <- the tile's E rows (zeros past nrows)
template <typename T>
__device__ __forceinline__ void load_edges(T* sX, const T* __restrict__ E, const Tile& t) {
  constexpr int ROWS = RG * Traits<T>::TM;
  constexpr int XS = H + Traits<T>::XPAD;
  constexpr int V = 16 / sizeof(T);
  for (int v = threadIdx.x; v < ROWS * (H / V); v += NT) {
    const int r = v / (H / V), q = v % (H / V);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < t.nrows) val = reinterpret_cast<const uint4*>(E + (t.row0 + r) * H)[q];
    *reinterpret_cast<uint4*>(sX + r * XS + q * V) = val;
  }
}

// acc <- h2 = gelu(cast(gelu(A[l] + X W_e + Gn[idx])) W2 + b2) of the edge tile X
// in sX, which is overwritten by cast(gelu(pre)); sWe and sW2 hold the weights.
// RESTAGE: once every thread is done with the W_e product, sWe is refilled
// with `next` (visible to every thread on return). Indices come from the kNN
// search; they are clamped so that a bad index can never read outside Gn.
template <typename T, bool RESTAGE = false>
__device__ __forceinline__ void chain_h2(T* sX, T* sWe, const T* sW2,
                                         const T* __restrict__ A, const T* __restrict__ Gn,
                                         const int* __restrict__ idx,
                                         const float* __restrict__ b2, int L, int K, int N,
                                         const Tile& t,
                                         float (&acc)[Traits<T>::TM][TN],
                                         const T* __restrict__ next = nullptr) {
  using Tr = Traits<T>;
  constexpr int TM = Tr::TM;
  constexpr int XS = H + Tr::XPAD;
  float y[TM][TN];
  fwd_gemm<T>(sX, sWe, t.r0, t.c0, acc);
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = t.r0 + m;
    if (r < t.nrows) {
      const int l = t.l0 + r / K;
      const int j = min(max(idx[t.row0 + r], 0), N - 1);
      float a[8], g[8];
      load8(A + ((size_t)t.b * L + l) * H + t.c0, a);
      load8(Gn + ((size_t)t.b * N + j) * H + t.c0, g);
#pragma unroll
      for (int n = 0; n < TN; ++n) y[m][n] = Tr::round(gelu_tanh(acc[m][n] + a[n] + g[n]));
    } else {
#pragma unroll
      for (int n = 0; n < TN; ++n) y[m][n] = 0.0f;
    }
  }
  __syncthreads();
  if constexpr (RESTAGE) stage_weight(sWe, next);
#pragma unroll
  for (int m = 0; m < TM; ++m) store8(sX + (t.r0 + m) * XS + t.c0, y[m]);
  __syncthreads();

  fwd_gemm<T>(sX, sW2, t.r0, t.c0, acc);
  float bias[8];
  load8(b2 + t.c0, bias);
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = gelu_tanh(acc[m][n] + bias[n]);
}

// K1's epilogue: out[l] = (cast(sum_k mask h2) W3 + (sum_k mask) b3) / scale,
// with sX (no longer read by any product) as scratch.
template <typename T>
__device__ __forceinline__ void sum_epilogue(const float (&acc)[Traits<T>::TM][TN], T* sX,
                                             const float* __restrict__ mask,
                                             const T* __restrict__ W3,
                                             const float* __restrict__ b3,
                                             float* __restrict__ out, int L, int K,
                                             float scale, const Tile& t) {
  using Tr = Traits<T>;
  constexpr int TM = Tr::TM;
  const int tid = threadIdx.x;
  // masked sum over this thread's TM rows (all of one residue: K % TM == 0)
  float part[8];
#pragma unroll
  for (int n = 0; n < TN; ++n) part[n] = 0.0f;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = t.r0 + m;
    const float mk = r < t.nrows ? mask[t.row0 + r] : 0.0f;
#pragma unroll
    for (int n = 0; n < TN; ++n) part[n] += acc[m][n] * mk;
  }
  __syncthreads();  // every product has finished reading sX
  float* red = reinterpret_cast<float*>(sX);  // [RG][H] per-row-group sums
  float* ssum = red + RG * H;                 // [TL][H] node sums (edge dtype)
  float* msum = ssum + t.TL * H;              // [TL] mask counts
  store8(red + t.rg * H + t.c0, part);
  __syncthreads();
  const int gpr = K / TM;  // row groups per residue
  for (int i = tid; i < t.TL * H; i += NT) {
    const int ll = i / H, c = i % H;
    float s = 0.0f;
    for (int q = 0; q < gpr; ++q) s += red[(ll * gpr + q) * H + c];
    ssum[i] = Tr::round(s);
  }
  for (int ll = tid; ll < t.TL; ll += NT) {
    float s = 0.0f;
    if (t.l0 + ll < L)
      for (int k = 0; k < K; ++k) s += mask[t.row0 + (size_t)ll * K + k];
    msum[ll] = s;
  }
  __syncthreads();
  for (int i = tid; i < t.TL * H; i += NT) {
    const int ll = i / H, c = i % H;
    if (t.l0 + ll >= L) continue;
    float s = 0.0f;
    for (int j = 0; j < H; ++j) s = fmaf(ssum[ll * H + j], Tr::f(W3[j * H + c]), s);
    s += msum[ll] * b3[c];
    out[((size_t)t.b * L + t.l0 + ll) * H + c] = s / scale;
  }
}

// The per-edge epilogue: msg = cast(h2) W3 + b3 (W3 in sW3); K6 (RAW) writes msg,
// K2 writes g * (LN(E + msg) * (1 + sc) + sh), with dropout on msg (K5's forward)
// when DROP = 1 (keep scales read from `keep`, E's dtype) or DROP = 2 (keep
// scales made here from `seeds` by the counter hash; `mask_out`, when not null,
// receives them as f32 for validation). TO_TILE (K7) also writes the output,
// cast to E's dtype, into sX (zeros past nrows), and restages the weight
// buffers as they fall free: sW2 (the W2 product's, done) with `next2`, then
// sW3 with `next3` after the W3 product.
template <typename T, int DROP, bool RAW, bool TO_TILE>
__device__ __forceinline__ void edge_epilogue(
    float (&acc)[Traits<T>::TM][TN], T* sX, T* sW3, const T* __restrict__ E,
    const float* __restrict__ b3, const float* __restrict__ sh,
    const float* __restrict__ sc, const float* __restrict__ gate,
    const T* __restrict__ keep, const int* __restrict__ seeds, uint32_t thresh,
    float kscale, float* __restrict__ mask_out, T* __restrict__ out, int K,
    const Tile& t, T* sW2 = nullptr, const T* __restrict__ next2 = nullptr,
    const T* __restrict__ next3 = nullptr) {
  using Tr = Traits<T>;
  constexpr int TM = Tr::TM;
  constexpr int XS = H + Tr::XPAD;
  {
    float y[TM][TN];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < TN; ++n) y[m][n] = Tr::round(acc[m][n]);
    __syncthreads();
    if constexpr (TO_TILE) stage_weight(sW2, next2);
#pragma unroll
    for (int m = 0; m < TM; ++m) store8(sX + (t.r0 + m) * XS + t.c0, y[m]);
    __syncthreads();
  }

  fwd_gemm<T>(sX, sW3, t.r0, t.c0, acc);
  if constexpr (TO_TILE) {
    __syncthreads();  // every thread is done reading sX and sW3
    stage_weight(sW3, next3);
  }
  float bias[8];
  load8(b3 + t.c0, bias);
  if constexpr (RAW) {
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int r = t.r0 + m;
      float v[8];
#pragma unroll
      for (int n = 0; n < TN; ++n) v[n] = acc[m][n] + bias[n];
      if (r < t.nrows) store8(out + (t.row0 + r) * H + t.c0, v);
    }
    return;
  }
  float shv[8], scv[8], gv[8];
  load8(sh + (size_t)t.b * H + t.c0, shv);
  load8(sc + (size_t)t.b * H + t.c0, scv);
  load8(gate + (size_t)t.b * H + t.c0, gv);
  uint32_t key = 0;
  if constexpr (DROP == 2) key = sample_key(seeds[t.b], t.b);
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = t.r0 + m;
    float v[8], kp[8];
    if (r < t.nrows) {
      load8(E + (t.row0 + r) * H + t.c0, v);
      if constexpr (DROP == 1) load8(keep + (t.row0 + r) * H + t.c0, kp);
    } else {
#pragma unroll
      for (int n = 0; n < TN; ++n) v[n] = kp[n] = 0.0f;
    }
    if constexpr (DROP == 2) {
      const uint32_t e0 = (uint32_t)(((size_t)t.l0 * K + r) * H + t.c0);
#pragma unroll
      for (int n = 0; n < TN; ++n) kp[n] = drop_bits(key, e0 + n) >= thresh ? kscale : 0.0f;
      if (mask_out != nullptr && r < t.nrows)
        store8(mask_out + (t.row0 + r) * H + t.c0, kp);
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
    if (r < t.nrows) store8(out + (t.row0 + r) * H + t.c0, v);
    if constexpr (TO_TILE) {
      if (r >= t.nrows) {
#pragma unroll
        for (int n = 0; n < TN; ++n) v[n] = 0.0f;
      }
      store8(sX + r * XS + t.c0, v);  // store8 rounds to T: the cast of `out`
    }
  }
}

// EDGE = false: K1 (masked K-sum, f32 [B, L, H] out).
// EDGE = true:  K2 / K5's forward (DROP), or K6 (RAW), [B, L, K, H] out.
template <typename T, bool EDGE, int DROP, bool RAW>
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
  extern __shared__ __align__(16) unsigned char smem[];
  T* sWe = reinterpret_cast<T*>(smem);
  T* sW2 = sWe + H * H;
  T* sW3 = sW2 + H * H;             // staged by K2 / K6 only
  T* sX = EDGE ? sW3 + H * H : sW3; // [ROWS][XS] edge tile / activations

  const Tile t = make_tile<T>(L, K);
  stage_weight(sWe, We);
  stage_weight(sW2, W2);
  if (EDGE) stage_weight(sW3, W3);
  load_edges(sX, E, t);
  __syncthreads();

  float acc[Traits<T>::TM][TN];
  chain_h2<T>(sX, sWe, sW2, A, Gn, idx, b2, L, K, N, t, acc);
  if constexpr (!EDGE)
    sum_epilogue<T>(acc, sX, mask, W3, b3, static_cast<float*>(out), L, K, scale, t);
  else
    edge_epilogue<T, DROP, RAW, false>(acc, sX, sW3, E, b3, sh, sc, gate, keep, seeds,
                                       thresh, kscale, mask_out, static_cast<T*>(out), K, t);
}

// K7: K2 with the edge weight set, then K1 with the node set on its output, in
// two weight buffers (K1's shared memory; at most 128 registers a thread, so
// that two blocks fit an SM in bf16).
template <typename T>
__global__ void __launch_bounds__(NT, 2)
edge_then_sum_kernel(const T* __restrict__ Ae, const T* __restrict__ E,
                     const T* __restrict__ Ge, const int* __restrict__ idx,
                     const T* __restrict__ Wee, const T* __restrict__ W2e,
                     const float* __restrict__ b2e, const T* __restrict__ W3e,
                     const float* __restrict__ b3e, const float* __restrict__ sh,
                     const float* __restrict__ sc, const float* __restrict__ gmod,
                     const T* __restrict__ An, const T* __restrict__ Gnn,
                     const T* __restrict__ Wen, const T* __restrict__ W2n,
                     const float* __restrict__ b2n, const T* __restrict__ W3n,
                     const float* __restrict__ b3n, const float* __restrict__ mask,
                     T* __restrict__ e_out, float* __restrict__ n_out, int L, int K, int N,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* w0 = reinterpret_cast<T*>(smem);  // W_e, then W3, then the node W2
  T* w1 = w0 + H * H;                  // W2, then the node W_e
  T* sX = w1 + H * H;

  const Tile t = make_tile<T>(L, K);
  stage_weight(w0, Wee);
  stage_weight(w1, W2e);
  load_edges(sX, E, t);
  __syncthreads();

  float acc[Traits<T>::TM][TN];
  chain_h2<T, true>(sX, w0, w1, Ae, Ge, idx, b2e, L, K, N, t, acc, W3e);
  edge_epilogue<T, 0, false, true>(acc, sX, w0, E, b3e, sh, sc, gmod, nullptr, nullptr, 0u,
                                   1.0f, nullptr, e_out, K, t, w1, Wen, W2n);
  __syncthreads();  // e2 in sX and the node weights are in place
  chain_h2<T>(sX, w1, w0, An, Gnn, idx, b2n, L, K, N, t, acc);
  sum_epilogue<T>(acc, sX, mask, W3n, b3n, n_out, L, K, scale, t);
}

template <typename T, bool EDGE>
size_t smem_bytes() {
  constexpr int ROWS = RG * Traits<T>::TM;
  return (size_t)(EDGE ? 3 : 2) * H * H * sizeof(T) +
         (size_t)ROWS * (H + Traits<T>::XPAD) * sizeof(T);
}

template <typename T>
bool bad_dims(int B, int L, int K, int N) {
  constexpr int TM = Traits<T>::TM;
  return B <= 0 || L <= 0 || N <= 0 || K <= 0 || K > RG * TM || K % TM != 0;
}

template <typename T>
dim3 grid_of(int B, int L, int K) {
  const int TL = RG * Traits<T>::TM / K;
  return dim3((L + TL - 1) / TL, B);
}

template <typename T, bool EDGE, int DROP, bool RAW>
int launch(const void* A, const void* E, const void* Gn, const void* idx,
           const void* mask, const void* We, const void* W2, const void* b2,
           const void* W3, const void* b3, const void* sh, const void* sc,
           const void* gate, const void* keep, const void* seeds, uint32_t thresh,
           float kscale, void* mask_out, void* out, int B, int L, int K, int N,
           float scale, void* stream) {
  if (bad_dims<T>(B, L, K, N)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, EDGE>();
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<T, EDGE, DROP, RAW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  chain_kernel<T, EDGE, DROP, RAW>
      <<<grid_of<T>(B, L, K), NT, smem, static_cast<cudaStream_t>(stream)>>>(
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

template <typename T>
int launch_edge_then_sum(const void* Ae, const void* E, const void* Ge, const void* idx,
                         const void* Wee, const void* W2e, const void* b2e,
                         const void* W3e, const void* b3e, const void* sh,
                         const void* sc, const void* gmod, const void* An,
                         const void* Gnn, const void* Wen, const void* W2n,
                         const void* b2n, const void* W3n, const void* b3n,
                         const void* mask, void* e_out, void* n_out, int B, int L, int K,
                         int N, float scale, void* stream) {
  if (bad_dims<T>(B, L, K, N)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, false>();  // two weight buffers, as K1
  cudaError_t err = cudaFuncSetAttribute(edge_then_sum_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  edge_then_sum_kernel<T><<<grid_of<T>(B, L, K), NT, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Ae), static_cast<const T*>(E), static_cast<const T*>(Ge),
      static_cast<const int*>(idx), static_cast<const T*>(Wee), static_cast<const T*>(W2e),
      static_cast<const float*>(b2e), static_cast<const T*>(W3e),
      static_cast<const float*>(b3e), static_cast<const float*>(sh),
      static_cast<const float*>(sc), static_cast<const float*>(gmod),
      static_cast<const T*>(An), static_cast<const T*>(Gnn), static_cast<const T*>(Wen),
      static_cast<const T*>(W2n), static_cast<const float*>(b2n),
      static_cast<const T*>(W3n), static_cast<const float*>(b3n),
      static_cast<const float*>(mask), static_cast<T*>(e_out), static_cast<float*>(n_out),
      L, K, N, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define MESSAGE_SUM(SUFFIX, TYPE)                                                        \
  int message_sum_##SUFFIX(const void* A, const void* E, const void* Gn, const void* idx, \
                           const void* mask, const void* We, const void* W2,             \
                           const void* b2, const void* W3, const void* b3, void* out,    \
                           int B, int L, int K, int N, float scale, void* stream) {      \
    return launch<TYPE, false, 0, false>(A, E, Gn, idx, mask, We, W2, b2, W3, b3,        \
                                         nullptr, nullptr, nullptr, nullptr, nullptr, 0u, \
                                         1.0f, nullptr, out, B, L, K, N, scale, stream); \
  }

MESSAGE_SUM(f32, float)
MESSAGE_SUM(bf16, __nv_bfloat16)

#define EDGE_LNMOD(SUFFIX, TYPE)                                                         \
  int message_edge_lnmod_##SUFFIX(const void* A, const void* E, const void* Gn,          \
                                  const void* idx, const void* We, const void* W2,       \
                                  const void* b2, const void* W3, const void* b3,        \
                                  const void* sh, const void* sc, const void* gate,      \
                                  void* out, int B, int L, int K, int N, void* stream) { \
    return launch<TYPE, true, 0, false>(A, E, Gn, idx, nullptr, We, W2, b2, W3, b3, sh,  \
                                        sc, gate, nullptr, nullptr, 0u, 1.0f, nullptr,   \
                                        out, B, L, K, N, 1.0f, stream);                  \
  }

EDGE_LNMOD(f32, float)
EDGE_LNMOD(bf16, __nv_bfloat16)

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
      return launch<TYPE, true, 1, false>(A, E, Gn, idx, nullptr, We, W2, b2, W3, b3,  \
                                          sh, sc, gate, keep, nullptr, 0u, 1.0f,       \
                                          nullptr, out, B, L, K, N, 1.0f, stream);     \
    return launch<TYPE, true, 2, false>(A, E, Gn, idx, nullptr, We, W2, b2, W3, b3,    \
                                        sh, sc, gate, nullptr, seeds, thresh, kscale,  \
                                        mask_out, out, B, L, K, N, 1.0f, stream);      \
  }

EDGE_DROP(f32, float)
EDGE_DROP(bf16, __nv_bfloat16)

// K6: the raw per-edge messages cast(h2) W3 + b3, [B, L, K, H] in E's dtype.
#define MESSAGE_EDGE(SUFFIX, TYPE)                                                      \
  int message_edge_##SUFFIX(const void* A, const void* E, const void* Gn,               \
                            const void* idx, const void* We, const void* W2,            \
                            const void* b2, const void* W3, const void* b3, void* out,  \
                            int B, int L, int K, int N, void* stream) {                 \
    return launch<TYPE, true, 0, true>(A, E, Gn, idx, nullptr, We, W2, b2, W3, b3,      \
                                       nullptr, nullptr, nullptr, nullptr, nullptr, 0u, \
                                       1.0f, nullptr, out, B, L, K, N, 1.0f, stream);   \
  }

MESSAGE_EDGE(f32, float)
MESSAGE_EDGE(bf16, __nv_bfloat16)

// K7: e_out [B, L, K, H] (E's dtype) = K2 of (Ae, E, Ge, the edge weights, sh, sc,
// gmod); n_out f32 [B, L, H] = K1 of (An, e_out, Gnn, the node weights, mask,
// scale). Ge and Gnn are [B, N, H] tables indexed by the same idx.
#define EDGE_THEN_SUM(SUFFIX, TYPE)                                                      \
  int edge_then_sum_##SUFFIX(                                                            \
      const void* Ae, const void* E, const void* Ge, const void* idx, const void* Wee,   \
      const void* W2e, const void* b2e, const void* W3e, const void* b3e,                \
      const void* sh, const void* sc, const void* gmod, const void* An, const void* Gnn, \
      const void* Wen, const void* W2n, const void* b2n, const void* W3n,                \
      const void* b3n, const void* mask, void* e_out, void* n_out, int B, int L, int K,  \
      int N, float scale, void* stream) {                                                \
    return launch_edge_then_sum<TYPE>(Ae, E, Ge, idx, Wee, W2e, b2e, W3e, b3e, sh, sc,   \
                                      gmod, An, Gnn, Wen, W2n, b2n, W3n, b3n, mask,      \
                                      e_out, n_out, B, L, K, N, scale, stream);          \
  }

EDGE_THEN_SUM(f32, float)
EDGE_THEN_SUM(bf16, __nv_bfloat16)

}  // extern "C"
