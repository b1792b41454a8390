// Edge gather (K8) and edge aggregate (K9) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernels of codlad_tpu/kernels/edge_kernels.py:
//   K8 edge_gather_*    <- _gather_kernel / _pallas_gather
//   K9 edge_aggregate_* <- _aggregate_kernel / _pallas_aggregate
//
// K8: out[b, e, f] = nodes[b, idx[b, e], f] * cast(mask[b, e]). The TPU
//   builds a one-hot in VMEM and splits f32 payloads hi/lo because its
//   matrix unit rounds; an index read is exact, so this equals the plain
//   version (index_select, then the mask in the payload dtype) bit for bit.
//   Bound: memory. At the Stage-1 bench shape (B4, 65536 directed edges a
//   sample, 2688 atoms, F 36 bf16) it moves 21.7 MB (18.9 MB of rows out,
//   the 0.77 MB node table, 2 MB of indices and masks): ~6.5 us at 3.35 TB/s.
//   Design: a thread owns a chunk of V elements of one row (V = 4: 8 bytes
//   in bf16, 16 in f32) with all index math in 32 bits; the sample is the
//   grid's y axis and the row one 32-bit division of the chunk index, so
//   no 64-bit division (a software routine on the GPU) is left. The lanes
//   of a row read its index and mask at one address (one transaction a
//   warp), and a warp's vector stores cover one contiguous range. Where F %
//   4 != 0 or a pointer is not aligned to the vector (a contiguous view
//   with a storage offset), the same kernel runs its scalar path (V = 1).
//   The host refuses B*E*F or B*N*F at or above 2^31 (int32 offsets).
// K9: out[n, f] = cast(sum over node n's valid edges e of mask[e] * msgs[e, f])
//   (f32 sum, payload-dtype result); with `mean`, then divided by
//   max(cast(sum of those masks), 1) and cast again, as DenseEdgeOps rounds
//   (codlad_tpu/nn/graph.py). The TPU accumulates across an in-order grid in
//   VMEM; Hopper blocks run in parallel, so the edges come grouped by node in
//   a CSR (ptr, edge list: built once per batch by a stable sort outside the
//   kernel) and one warp owns a node: its lanes take the features, and each
//   lane adds the node's edges in list order. No atomics, so a run repeats
//   bit for bit. Bound: memory, as K8 (B*E*F payload elements once plus the
//   indices).

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
template <> struct Num<__nv_bfloat16> {
  __device__ static float f(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 cast(float v) { return __float2bfloat16(v); }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16(v)); }
};

constexpr int NT = 256;

// V consecutive elements of T, to and from f32
template <typename T, int V> struct Chunk;
template <typename T> struct Chunk<T, 1> {
  __device__ static void load(const T* p, float* v) { v[0] = Num<T>::f(*p); }
  __device__ static void store(T* p, const float* v) { *p = Num<T>::cast(v[0]); }
};
template <> struct Chunk<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Chunk<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&lo);
    t.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = t;
  }
};

// chunk i (of E * F / V) of sample b
template <typename T, int V>
__device__ __forceinline__ void gather_chunk(const int* __restrict__ idx,
                                             const float* __restrict__ mask,
                                             const T* __restrict__ nodes, T* __restrict__ out,
                                             int b, int i, int E, int N, int F) {
  const int per_row = F / V;
  const int e = i / per_row;
  const int c = (i - e * per_row) * V;
  const int row = b * E + e;
  // indices come from the featurizer; clamped so a bad one cannot read
  // outside the sample's node table
  const int j = min(max(__ldg(idx + row), 0), N - 1);
  const float m = Num<T>::round(__ldg(mask + row));
  float v[V];
  Chunk<T, V>::load(nodes + (b * N + j) * F + c, v);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] *= m;
  Chunk<T, V>::store(out + row * F + c, v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
gather_kernel(const int* __restrict__ idx, const float* __restrict__ mask,
              const T* __restrict__ nodes, T* __restrict__ out, int E, int N, int F,
              int vec) {
  const int b = blockIdx.y;
  const unsigned i = blockIdx.x * NT + threadIdx.x;  // < 2^31 + NT
  if (vec) {
    if (i < (unsigned)(E * (F / 4))) gather_chunk<T, 4>(idx, mask, nodes, out, b, i, E, N, F);
  } else if (i < (unsigned)(E * F)) {
    gather_chunk<T, 1>(idx, mask, nodes, out, b, i, E, N, F);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
aggregate_kernel(const int* __restrict__ ptr, const int* __restrict__ edges,
                 const float* __restrict__ mask, const T* __restrict__ msgs,
                 T* __restrict__ out, int n_nodes, int F, int mean) {
  const int lane = threadIdx.x & 31;
  const long long node = ((long long)blockIdx.x * NT + threadIdx.x) >> 5;
  if (node >= n_nodes) return;
  const int begin = ptr[node], end = ptr[node + 1];
  float deg = 0.0f;
  if (mean)
    for (int j = begin; j < end; ++j) deg += mask[edges[j]];
  const float denom = fmaxf(Num<T>::round(deg), 1.0f);
  for (int f = lane; f < F; f += 32) {
    float s = 0.0f;
    for (int j = begin; j < end; ++j) {
      const long long e = edges[j];
      s = fmaf(mask[e], Num<T>::f(msgs[e * F + f]), s);
    }
    float v = Num<T>::round(s);
    if (mean) v = v / denom;
    out[node * F + f] = Num<T>::cast(v);
  }
}

template <typename T>
int gather(const void* idx, const void* mask, const void* nodes, void* out, int B, int E,
           int N, int F, void* stream) {
  constexpr long long kMax = 2147483647LL;
  if (B <= 0 || E <= 0 || N <= 0 || F <= 0 || B > 65535 || (long long)B * E * F > kMax ||
      (long long)B * N * F > kMax)
    return (int)cudaErrorInvalidValue;
  constexpr uintptr_t align = 4 * sizeof(T);
  const int vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(nodes) % align == 0 &&
                  reinterpret_cast<uintptr_t>(out) % align == 0;
  const int chunks = vec ? E * (F / 4) : E * F;
  const dim3 grid((unsigned)(((long long)chunks + NT - 1) / NT), B);
  gather_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const T*>(nodes), static_cast<T*>(out), E, N, F, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int aggregate(const void* ptr, const void* edges, const void* mask, const void* msgs,
              void* out, int n_nodes, int F, int mean, void* stream) {
  if (n_nodes <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)n_nodes * 32 + NT - 1) / NT;
  aggregate_kernel<T><<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(edges),
      static_cast<const float*>(mask), static_cast<const T*>(msgs), static_cast<T*>(out),
      n_nodes, F, mean);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// idx int32 [B, E], mask f32 [B, E], nodes [B, N, F] -> out [B, E, F]
int edge_gather_f32(const void* idx, const void* mask, const void* nodes, void* out, int B,
                    int E, int N, int F, void* stream) {
  return gather<float>(idx, mask, nodes, out, B, E, N, F, stream);
}
int edge_gather_bf16(const void* idx, const void* mask, const void* nodes, void* out, int B,
                     int E, int N, int F, void* stream) {
  return gather<__nv_bfloat16>(idx, mask, nodes, out, B, E, N, F, stream);
}

// ptr int32 [n_nodes + 1], edges int32 (flat b * E + e, grouped by node),
// mask f32 [B * E], msgs [B * E, F] -> out [n_nodes, F] (n_nodes = B * N)
int edge_aggregate_f32(const void* ptr, const void* edges, const void* mask,
                       const void* msgs, void* out, int n_nodes, int F, int mean,
                       void* stream) {
  return aggregate<float>(ptr, edges, mask, msgs, out, n_nodes, F, mean, stream);
}
int edge_aggregate_bf16(const void* ptr, const void* edges, const void* mask,
                        const void* msgs, void* out, int n_nodes, int F, int mean,
                        void* stream) {
  return aggregate<__nv_bfloat16>(ptr, edges, mask, msgs, out, n_nodes, F, mean, stream);
}

}  // extern "C"
