// Helpers shared by the message-chain kernels (message_chain.cu, forward;
// message_chain_bwd.cu, backward): vector loads and stores, tanh-gelu, a
// CUDA-core tile product, and the counter-based dropout bits.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace chain {

constexpr int H = 128;      // hidden width the kernels are built for
constexpr int NT = 256;     // threads per block
constexpr int CG = 16;      // column groups; a thread owns TN columns
constexpr int TN = 8;       // CG * TN == H
constexpr int RG = NT / CG; // row groups; a thread owns TM rows

template <typename T> struct Num;

template <> struct Num<float> {
  __device__ static float f(float v) { return v; }
  __device__ static float cast(float v) { return v; }
  __device__ static float round(float v) { return v; }
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(u));
}

// eight consecutive f32 values <-> registers (16-byte aligned addresses)
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// acc[m][n] = sum_i X[r0+m][i] * W[i][c0+n] over the shared tile X (row
// stride XS) and the shared weight W [H][H], f32 FMAs on CUDA cores. It
// serves the f32 K6 forward only: every other kernel runs its products on
// the tensor cores (chain_mma.cuh's slab functions in bf16, chain_tf32.cuh's
// in f32, 3xTF32).
template <typename T, int TM, int XS>
__device__ __forceinline__ void tile_gemm(const T* sX, const T* sW, int r0, int c0,
                                          float (&acc)[TM][TN]) {
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.0f;
#pragma unroll 2
  for (int i0 = 0; i0 < H; i0 += 8) {
    float x[TM][8];
#pragma unroll
    for (int m = 0; m < TM; ++m) load8(sX + (r0 + m) * XS + i0, x[m]);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float w[8];
      load8(sW + (i0 + kk) * H + c0, w);
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[m][n] = fmaf(x[m][kk], w[n], acc[m][n]);
    }
  }
}

// Counter-based dropout bits: a pure function of (seed, sample, element), so
// the forward, the backward and the plain PyTorch version
// (kernels/mpnn_kernels.py: keep_bits) give the same mask whatever their
// tiling. The element index counts within one sample: ((l * K) + k) * H + h.
// Keep iff bits >= floor(p * 2^32), scaled by 1 / (1 - p).
__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t sample_key(int seed, int b) {
  return lowbias32((uint32_t)seed ^ lowbias32((uint32_t)b + 0x9e3779b9u));
}

__device__ __forceinline__ uint32_t drop_bits(uint32_t key, uint32_t i) {
  return lowbias32(lowbias32(i ^ key) + key);
}

}  // namespace chain
