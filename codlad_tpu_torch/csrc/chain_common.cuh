// Helpers shared by the message-chain kernels (message_chain.cu, forward;
// message_chain_bwd.cu, backward): the hidden width and the counter-based
// dropout bits.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace chain {

constexpr int H = 128;  // hidden width the kernels are built for

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
