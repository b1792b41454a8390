// Edge gather (K8) and edge aggregate (K9) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernels of codlad_tpu/kernels/edge_kernels.py:
//   K8 edge_gather_*    <- _gather_kernel / _pallas_gather
//   K9 edge_aggregate_* <- _aggregate_kernel / _pallas_aggregate
//
// K8: out[b, e, f] = nodes[b, idx[b, e], f] * cast(mask[b, e]), one thread an
//   output element. The TPU builds a one-hot in VMEM and splits f32 payloads
//   hi/lo because its matrix unit rounds; an index read is exact, so this
//   equals the plain version (index_select, then the mask in the payload
//   dtype) bit for bit.
// K9: out[n, f] = cast(sum over node n's valid edges e of mask[e] * msgs[e, f])
//   (f32 sum, payload-dtype result); with `mean`, then divided by
//   max(cast(sum of those masks), 1) and cast again, as DenseEdgeOps rounds
//   (codlad_tpu/nn/graph.py). The TPU accumulates across an in-order grid in
//   VMEM; Hopper blocks run in parallel, so the edges come grouped by node in
//   a CSR (ptr, edge list: built once per batch by a stable sort outside the
//   kernel) and one warp owns a node: its lanes take the features, and each
//   lane adds the node's edges in list order. No atomics, so a run repeats
//   bit for bit.
//
// Bound at the Stage-1 bench shape (B4, 2688 atoms, 65536 directed edges a
// sample, F 12..48): both move B*E*F payload elements once plus the indices;
// memory-bound, tens of microseconds.

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

template <typename T>
__global__ void __launch_bounds__(NT)
gather_kernel(const int* __restrict__ idx, const float* __restrict__ mask,
              const T* __restrict__ nodes, T* __restrict__ out, int E, int N, int F,
              long long total) {
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < total;
       i += (long long)gridDim.x * NT) {
    const long long row = i / F;  // b * E + e
    const int f = (int)(i - row * F);
    const long long b = row / E;
    // indices come from the featurizer; clamped so a bad one cannot read
    // outside the sample's node table
    const int j = min(max(idx[row], 0), N - 1);
    const float m = Num<T>::round(mask[row]);
    out[i] = Num<T>::cast(Num<T>::f(nodes[(b * N + j) * F + f]) * m);
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
  if (B <= 0 || E <= 0 || N <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * E * F;
  const long long want = (total + NT - 1) / NT;
  const int blocks = (int)(want < 1048576 ? want : 1048576);
  gather_kernel<T><<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const T*>(nodes), static_cast<T*>(out), E, N, F, total);
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
