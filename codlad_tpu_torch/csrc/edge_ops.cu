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
//   kernel). No atomics. Bound: memory, as K8 (the listed edges' payload rows
//   once, the CSR, their masks, the output). At the Stage-1 shape (~24 edges
//   a node, F 12-48) a lane that walks its node's list alone waits on two
//   dependent loads an edge (the id, then the row) with 2- or 4-byte loads;
//   the design keeps several rows in flight instead:
//   * A node's group of W lanes (W = 32, or 16, 8, 4 where F is small: a
//     warp then serves 32 / W nodes) reads up to W of its edge ids and their
//     masks in one coalesced load (then the next W), and hands them out by
//     __shfl_sync: the only load left in the edge loop is the payload row.
//   * The group's lanes are S sub-slots x C chunks of V elements (C = F / V;
//     V = 16, 8 or 4 bytes, the widest that divides F, loaded as one vector;
//     the host refuses msgs or out off a 16-byte boundary, and the wrapper
//     copies an offset view of msgs to a fresh buffer): sub-slot s takes the
//     entries j = s, s + S, ... of each W-id chunk, U = 4 rows at a time, all
//     loaded before any is summed.
//   * The sub-slots' partial sums meet through a fixed tree of
//     __shfl_down_sync (P / 2, ..., 1 sub-slots apart, P the power of two at
//     or above S); the degree sums the same broadcast masks (one lane each,
//     then a tree over the group). Every order is a pure function of the CSR
//     and of F: a run repeats bit for bit. `aggregate` and `layout` below
//     pick V, S and W; tests/_torch_aggregate_order.py repeats them and the
//     order in torch, and the tests hold that emulation against the TPU
//     kernel on the CPU and against this kernel on the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  __device__ static float cast(float v) { return v; }
  __device__ static float round(float v) { return v; }
};
template <> struct Num<__nv_bfloat16> {
  __device__ static __nv_bfloat16 cast(float v) { return __float2bfloat16(v); }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16(v)); }
};

constexpr int NT = 256;

// V consecutive elements of T (K8's and K9's chunks) held as NW 32-bit
// words (bf16: two a word, the lower element in the low half), loaded as
// one 16-, 8- or 4-byte access (p on a V * sizeof(T) boundary), element by
// element where V is a single bf16. Every word stays a register (no local
// memory, which reinterpreting a vector register's address can cost).
__device__ __forceinline__ unsigned bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned bits_of(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

template <typename T, int V>
struct Vec {
  static constexpr int PER = 4 / sizeof(T);  // elements a word
  static constexpr int NW = (V + PER - 1) / PER;
  struct Words {
    unsigned w[NW];
  };
  __device__ static Words zero() {
    Words r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = 0u;
    return r;
  }
  __device__ static Words load(const T* p) {
    Words r;
    if constexpr (NW == 4) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      r.w[0] = u.x;
      r.w[1] = u.y;
      r.w[2] = u.z;
      r.w[3] = u.w;
    } else if constexpr (NW == 2) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      r.w[0] = u.x;
      r.w[1] = u.y;
    } else if constexpr (V == PER) {
      r.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
      r = zero();
#pragma unroll
      for (int k = 0; k < V; ++k) r.w[k / PER] |= bits_of(p[k]) << (32 / PER * (k % PER));
    }
    return r;
  }
  __device__ static void to_f32(const Words& r, float* v) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const unsigned w = r.w[k / PER];
      v[k] = __uint_as_float(PER == 1 ? w : (k % PER ? w & 0xffff0000u : w << 16));
    }
  }
  __device__ static void store(T* p, const float* v) {
    if constexpr (V >= PER) {
      unsigned w[NW];
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = 0u;
#pragma unroll
      for (int k = 0; k < V; ++k)
        w[k / PER] |= bits_of(Num<T>::cast(v[k])) << (32 / PER * (k % PER));
      if constexpr (NW == 4)
        *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
      else if constexpr (NW == 2)
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<unsigned*>(p) = w[0];
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) p[k] = Num<T>::cast(v[k]);
    }
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
  Vec<T, V>::to_f32(Vec<T, V>::load(nodes + (b * N + j) * F + c), v);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] *= m;
  Vec<T, V>::store(out + row * F + c, v);
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

constexpr int U = 4;  // payload rows a sub-slot has in flight

// One node a group of W lanes (a power of two; the warp's 32 / W groups
// take consecutive nodes). Lane gl of the group is sub-slot gl / CL, chunk
// gl % CL (+ CL a pass: more than one pass only where C > 32), CL = min(C,
// W); the lanes past S sub-slots only pass ids along.
template <typename T, int V>
__global__ void __launch_bounds__(NT)
aggregate_kernel(const int* __restrict__ ptr, const int* __restrict__ edges,
                 const float* __restrict__ mask, const T* __restrict__ msgs,
                 T* __restrict__ out, int n_nodes, int F, int mean, int C, int S, int W) {
  const int lane = threadIdx.x & 31;
  const int gl = lane & (W - 1);
  const unsigned gmask = W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (lane & ~(W - 1));
  const long long node = (((long long)blockIdx.x * NT + threadIdx.x) >> 5) * (32 / W) + lane / W;
  if (node >= n_nodes) return;  // the whole group leaves
  const int CL = min(C, W);
  const int sub = gl / CL, c0 = gl - sub * CL;
  int P = 1;
  while (P < S) P <<= 1;
  const int begin = __ldg(ptr + node), end = __ldg(ptr + node + 1);
  float deg = 0.0f;
  for (int pass = 0; pass * CL < C; ++pass) {
    const int chunk = c0 + pass * CL;
    const bool act = sub < S && chunk < C;
    const T* col = msgs + (size_t)chunk * V;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int base = begin; base < end; base += W) {
      const int n = min(W, end - base);
      int eid = 0;
      float m = 0.0f;
      if (gl < n) {
        eid = __ldg(edges + base + gl);
        m = __ldg(mask + eid);
      }
      if (pass == 0) deg += m;
      const int rounds = (n + S - 1) / S;
      for (int t0 = 0; t0 < rounds; t0 += U) {
        typename Vec<T, V>::Words raw[U];
        float mu[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = (t0 + u) * S + sub;
          const int e = __shfl_sync(gmask, eid, min(j, n - 1), W);
          mu[u] = __shfl_sync(gmask, m, min(j, n - 1), W);
          if (act && j < n) {
            raw[u] = Vec<T, V>::load(col + (size_t)e * F);
          } else {
            raw[u] = Vec<T, V>::zero();
            mu[u] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float v[V];
          Vec<T, V>::to_f32(raw[u], v);
#pragma unroll
          for (int k = 0; k < V; ++k) acc[k] = fmaf(mu[u], v[k], acc[k]);
        }
      }
    }
    // sub-slot s + off's sum into s's, off = P / 2, ..., 1
    for (int off = P >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float o = __shfl_down_sync(gmask, acc[k], off * CL, W);
        if (sub + off < S) acc[k] += o;
      }
    }
    if (pass == 0 && mean) {  // the group's masks, lane gl + off's into gl's
      for (int off = W >> 1; off > 0; off >>= 1) deg += __shfl_down_sync(gmask, deg, off, W);
      deg = __shfl_sync(gmask, deg, 0, W);
    }
    if (act && sub == 0) {
      const float denom = fmaxf(Num<T>::round(deg), 1.0f);
      float v[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        v[k] = Num<T>::round(acc[k]);
        if (mean) v[k] = v[k] / denom;
      }
      Vec<T, V>::store(out + node * F + (size_t)chunk * V, v);
    }
  }
}

// K9's lane layout from F and the elements a lane loads at once, V (the
// widest of 16, 8 and 4 bytes that divides a row, else 1), so that the
// summation order depends on F and the CSR only: C = F / V chunks a row; a
// group of W lanes a node, W halved from 32 while half of it still holds 4
// sub-slots; S = W / C sub-slots (1 where C >= W).
// tests/_torch_aggregate_order.py `aggregate_layout` repeats it.
struct Layout {
  int C, S, W;
};

inline Layout layout(int F, int V) {
  Layout l;
  l.C = F / V;
  l.W = 32;
  while (l.W / 2 >= 4 * l.C) l.W /= 2;
  l.S = l.C >= l.W ? 1 : l.W / l.C;
  return l;
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

template <typename T, int V>
cudaError_t launch_aggregate(const void* ptr, const void* edges, const void* mask,
                             const void* msgs, void* out, int n_nodes, int F, int mean,
                             cudaStream_t stream) {
  const Layout l = layout(F, V);
  const long long warps = ((long long)n_nodes * l.W + 31) / 32;
  const long long blocks = (warps * 32 + NT - 1) / NT;
  aggregate_kernel<T, V><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(edges),
      static_cast<const float*>(mask), static_cast<const T*>(msgs), static_cast<T*>(out),
      n_nodes, F, mean, l.C, l.S, l.W);
  return cudaGetLastError();
}

template <typename T>
int aggregate(const void* ptr, const void* edges, const void* mask, const void* msgs,
              void* out, int n_nodes, int F, int mean, void* stream) {
  if (n_nodes <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(msgs) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T), V4 = 4 / sizeof(T);
  cudaError_t err;
  if (F % V16 == 0)
    err = launch_aggregate<T, V16>(ptr, edges, mask, msgs, out, n_nodes, F, mean, st);
  else if (F % V8 == 0)
    err = launch_aggregate<T, V8>(ptr, edges, mask, msgs, out, n_nodes, F, mean, st);
  else if (F % V4 == 0)
    err = launch_aggregate<T, V4>(ptr, edges, mask, msgs, out, n_nodes, F, mean, st);
  else
    err = launch_aggregate<T, 1>(ptr, edges, mask, msgs, out, n_nodes, F, mean, st);
  return (int)err;
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
