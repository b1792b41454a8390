// Fused MPNN message chains for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernels of codlad_tpu/kernels/mpnn_kernels.py:
//   K1 message_sum_*        <- _sum_kernel / _pallas_message_sum
//   K2 message_edge_lnmod_* <- _edge_lnmod_kernel / _pallas_message_edge_lnmod
//   K5 message_edge_lnmod_drop_* (forward) <- _edge_lnmod_kernel with has_keep
//      (fused_message_edge_lnmod_drop) or drop_p (fused_message_edge_lnmod_pdrop,
//      mask from _inkernel_keep); here the mask is the counter hash of
//      chain_common.cuh, a pure function of (seed, sample, element); K2's
//      tensor-core kernel at DROP 1 (keep) or 2 (seeds), in either dtype
//   K6 message_edge_*       <- _edge_kernel / _pallas_message_edge
//   K7 edge_then_sum_*      <- _edge_then_sum_kernel / _pallas_edge_then_sum
//
// Per edge (l, k) of a [B, L, K, H] tile:
//   pre = A[l] + E[l,k] W_e + Gn[idx[l,k]]
//   h2  = gelu(cast(gelu(pre)) W2 + b2)                    (tanh gelu)
// K1:  out[l] = (cast(sum_k mask*h2) W3 + (sum_k mask) b3) / scale   -> f32
// K2:  out[l,k] = g * (LN(E + cast(h2) W3 + b3) * (1 + sc) + sh)      -> dtype of E
// K5:  K2 with (cast(h2) W3 + b3) x keep (0 or 1 / (1 - p)) in the LN
// K6:  out[l,k] = cast(h2) W3 + b3                                    -> dtype of E
// K7:  e2 = K2 of the first weight set (cast to E's dtype), then K1 of the
//      second weight set and the mask with e2 as its edge operand -> (e2, f32 sum)
// cast() rounds to the edge dtype where the TPU kernel does; every product
// accumulates in f32.
//
// Two designs share this file, one a dtype; every kernel runs on the tensor
// cores.
//
// f32 K1, K2, K5's forward, K6's forward and K7 on the tensor cores in
// 3xTF32 (`message_sum_f32_mma_kernel`, `message_edge_lnmod_f32_mma_kernel<DROP,
// MASK_OUT>`, `message_edge_f32_mma_kernel`, `edge_then_sum_f32_mma_kernel`;
// the slab functions of chain_tf32.cuh and the design note there, below).
// Every f32 kernel takes K <= 64, a multiple of 4. K6's forward is K2's
// kernel with another epilogue (`raw_slab`): out = msg + b3 in f32, the add
// lnmod_out makes before its LayerNorm, so it is K2's message term bit for
// bit; no LayerNorm, and neither sh, sc, the gate nor E (after the chain) is
// read. It replaced a CUDA-core design (one block of 64 edge rows, every
// H x H product in f32 FMAs: bound by the FFMA rate, 1.15 ms at the bench
// shape, and 3.5 ms measured). K5's forward is K2's kernel with the keep scales
// applied to msg + b3 in lnmod_out's first pass, where JAX's
// _edge_lnmod_kernel applies them: DROP 1 reads `keep` (f32) there, DROP 2
// first makes the slab's mask as 64 bits a lane from the counter hash of the
// natural element index (the indices the f32 backward regenerates it from),
// its hashes in a rolled loop; MASK_OUT (edge_lnmod_pdrop_debug only) writes
// the scales. It is bound as K2 (below) plus the hash, two lowbias32 an
// element, ~100 M a call on the integer units, which the rolled loop keeps
// out of the instruction cache's way.
//
// Bound on an H100 at the bench shape (B96 L128 K64 H128): the per-edge H x H
// products are ~52 GFLOP for K1 (~77 GFLOP for K2 and K6, ~129 for K7); the
// bytes moved (the E tile read once, plus the edge output's write) put the
// floor at 0.07-0.13 ms in bf16 and 0.12-0.24 ms in f32. In 3xTF32 the
// products are three TF32 ones each: 0.32 ms (K1) and 0.47 ms (K2, K6) at
// the tensor cores' 495 TFLOP/s (K5's forward as K2); a loop of these
// products alone reached 47% of that peak (scripts/tf32_split_bench.py), so
// the products bound the f32 K1 and K2 (and K6) near 0.67 and 0.99 ms.
//
// In bf16, K1 (`message_sum_mma_kernel`), K2 and K5's forward
// (`message_edge_lnmod_mma_kernel<DROP, MASK_OUT>`), K6
// (`message_edge_mma_kernel`) and K7 (`edge_then_sum_mma_kernel`) run on the
// tensor cores (the slab functions of chain_mma.cuh), on the TPU
// kernel's own rounding points: a block of 8 warps owns 128 edge rows (whole
// residues, K a multiple of 16), a warp a 16-row slab of one residue x all
// 128 columns (16 n8 accumulator tiles, 64 registers).
//   1. pre = A[l] + Gn[idx] + E W_e with mma.m16n8k16 (bf16 in, f32 sums):
//      the accumulators start as A + Gn, read as 16-byte loads because the
//      first product's columns are permuted (`unit`: a lane's 32 columns are
//      32 consecutive hidden units; W_e is staged with its columns in that
//      order, 4-byte cp.async copies); E rows (cp.async) and the weights
//      sit in shared memory at a 272-byte row stride, A by ldmatrix, B by
//      ldmatrix.trans.
//   2. y = cast(gelu(pre)) stays in registers: two adjacent n8 accumulator
//      tiles are the A fragment of one k16 step of the W2 product, whose
//      rows are staged in the same unit order.
//   3. x2 = y W2 in two halves of 64 columns (registers: 128 a thread, no
//      spills, two blocks an SM).
//   K1: mask * gelu(x2 + b2) summed over the slab's 16 rows by a butterfly
//      of warp shuffles, then the residue's K / 16 slabs in slab order
//      through shared memory (a run repeats bit for bit), rounded to bf16;
//      the per-residue epilogue (cast(s) W3 + msum b3) / scale, K-fold
//      fewer rows, on CUDA cores.
//   K2: h2 = gelu(x2 + b2) packed to bf16 is, by the same fragment trick,
//      the A operand of msg = cast(h2) W3 (W3's rows are W2's columns, in
//      order), so h2 never leaves registers; W3 is restaged into W_e's
//      buffer by cp.async once every warp is done with product 1,
//      overlapping product 2 (two blocks an SM). The LayerNorm and adaLN
//      epilogue runs in registers: a row's 128 columns lie in the 4 lanes of
//      a quad (two shuffles a pass); E for the residual comes from the
//      block's tile; the bf16 rows are staged in the warp's own tile rows
//      and leave in 16-byte stores.
//   K5's forward: K2's kernel at DROP 1 or 2, the keep scales applied to
//      msg + b3 in lnmod_out's first pass, at the accumulator positions:
//      DROP 1 reads `keep` there as bf16 pairs, DROP 2 hashes each element
//      there (chain_mma.cuh's keep_pair, the function K5's backward
//      regenerates the mask with), computed where it is used, so nothing is
//      held beside acc; MASK_OUT (edge_lnmod_pdrop_debug's instantiation
//      only) writes the scales as f32 pairs. At DROP 0 lnmod_out is K2's.
//   K6: K2's chain (`edge_chain`, the same function) with another epilogue
//      (`raw_out`): msg + b3 cast to bf16, staged and stored as K2's rows,
//      no residual and no LayerNorm; b2 and b3 the only vectors.
//   K7: K2's functions with the edge weights, e2 kept in the warp's own
//      slab rows, then K1's functions with the node weights on those rows:
//      the same instructions as K2's kernel followed by K1's, so the same
//      bits (the pair-fused denoiser equals the unfused one).
// The gelu is tanh gelu computed as x / (1 + exp(-2u)) (ex2 and rcp, relative
// error ~1e-6); tanh.approx.f32 is not used. Its 2 x 100.7 M evaluations a
// call, two MUFU operations each (~0.22 ms at 16 a clock an SM), bound K1
// and K2 on the H100 more than the products (52 / 77 GFLOP: 0.053 / 0.078 ms
// at the tensor cores' peak) or the bytes (0.066 / 0.123 ms); PERF.md has
// the times.

#include <algorithm>

#include "chain_common.cuh"
#include "chain_mma.cuh"
#include "chain_tf32.cuh"
#include "mma_common.cuh"

namespace {

using namespace chain;

// the f32 kernels take K <= 64, a multiple of 4 (16-row slabs of one
// residue, padded past K; chain_tf32.cuh)
constexpr int F32_KMAX = 64, F32_KSTEP = 4;

bool bad_dims(int B, int L, int K, int N) {
  return B <= 0 || L <= 0 || N <= 0 || K <= 0 || K > F32_KMAX || K % F32_KSTEP != 0;
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores (3xTF32, the slab functions of chain_tf32.cuh): K1
// (`message_sum_f32_mma_kernel`), K2 and K5's forward
// (`message_edge_lnmod_f32_mma_kernel<DROP, MASK_OUT>`), K6's forward
// (`message_edge_f32_mma_kernel`) and K7 (`edge_then_sum_f32_mma_kernel`). A
// block of 8 warps stages its three weights once and walks over its share of
// the work (one block an SM: the weights fill 192 KB). K2's and K6's warps
// walk over slabs on their own, with no block barrier. K1's and K7's blocks walk over tiles of TRES residues of one
// sample, warp w residue w: its slabs' masked sums, then, after one barrier,
// the tile's s W3 with warp w computing 16 of its columns. K7 runs K2's slab
// function on its residue's slabs (e2 to device memory), restages the node
// weights, then K1's functions on the e2 each lane has just written: the
// same instructions as K2's kernel followed by K1's, so the same bits.

namespace tf = chain_tf32;

constexpr int F1SMEM = (3 * tf::WFLOATS + 2 * H + 2 * tf::TRES * tf::SS + 2 * tf::TRES) * 4;
constexpr int F2SMEM = (3 * tf::WFLOATS + 2 * H) * 4;
constexpr int F7SMEM = (3 * tf::WFLOATS + 4 * H + 2 * tf::TRES * tf::SS + 2 * tf::TRES) * 4;

// K1 in f32: out[b, l] = (s W3 + msum b3) / scale, s the masked K-sum of h2
__global__ void __launch_bounds__(tf::TNT, 1)
message_sum_f32_mma_kernel(const float* __restrict__ A, const float* __restrict__ E,
                           const float* __restrict__ Gn, const int* __restrict__ idx,
                           const float* __restrict__ mask, const float* __restrict__ We,
                           const float* __restrict__ W2, const float* __restrict__ b2,
                           const float* __restrict__ W3, const float* __restrict__ b3,
                           float* __restrict__ out, int B, int L, int K, int N, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* sWe = fsm;
  float* sW2 = sWe + tf::WFLOATS;
  float* sW3 = sW2 + tf::WFLOATS;
  float* sb2 = sW3 + tf::WFLOATS;
  float* sb3 = sb2 + H;
  float* ssum = sb3 + H;                        // [2][TRES][SS], by tile parity
  float* smsum = ssum + 2 * tf::TRES * tf::SS;  // [2][TRES]
  tf::stage_frag<false, true>(sWe, We);
  tf::stage_frag<true, false>(sW2, W2);
  tf::stage_frag<false, false>(sW3, W3);
  tf::load_vec(sb2, b2);
  tf::load_vec(sb3, b3);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tps = (L + tf::TRES - 1) / tf::TRES;  // tiles a sample
  int par = 0;
  for (int tile = blockIdx.x; tile < B * tps; tile += gridDim.x, par ^= 1) {
    const int b = tile / tps, l0 = (tile - b * tps) * tf::TRES;
    float* ss = ssum + par * tf::TRES * tf::SS;
    float* sm = smsum + par * tf::TRES;
    tf::residue_sum(ss + warp * tf::SS, sm + warp, E, A, Gn, idx, mask, sWe, sW2, sb2, b,
                    l0 + warp, L, K, N, lane);
    __syncthreads();  // (the other parity's buffers are free: one barrier a tile)
    tf::residue_out(ss, sm, sW3, sb3, out, b, l0, L, scale, warp, lane);
  }
}

// K2's and K6's walk: the three weights, b2 and b3 staged once, then each
// warp takes slabs on its own (no block barrier) and hands them to
// slab(sWe, sW2, sW3, sb2, sb3, s)
template <typename SlabFn>
__device__ __forceinline__ void edge_walk(const float* __restrict__ We,
                                          const float* __restrict__ W2,
                                          const float* __restrict__ b2,
                                          const float* __restrict__ W3,
                                          const float* __restrict__ b3, int B, int L, int K,
                                          SlabFn slab) {
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
  const int lane = threadIdx.x & 31, spr = (K + 15) / 16;  // slabs a residue
  const long long total = (long long)B * L * spr;
  for (long long i = (long long)blockIdx.x * tf::TW + (threadIdx.x >> 5); i < total;
       i += (long long)gridDim.x * tf::TW) {
    const long long bl = i / spr;
    const int b = (int)(bl / L), l = (int)(bl - (long long)b * L), q = (int)(i - bl * spr);
    slab(sWe, sW2, sW3, sb2, sb3, tf::make_slab(b, l, q, L, K, lane));
  }
}

// K2 in f32 (DROP 0): out[b, l, k] = g (LN(E + h2 W3 + b3) (1 + sc) + sh);
// K5's forward (DROP 1: keep, 2: seeds; MASK_OUT: the scales to
// drop.mask_out) with (h2 W3 + b3) x keep in the LayerNorm
template <int DROP, bool MASK_OUT>
__global__ void __launch_bounds__(tf::TNT, 1)
message_edge_lnmod_f32_mma_kernel(const float* __restrict__ A, const float* __restrict__ E,
                                  const float* __restrict__ Gn, const int* __restrict__ idx,
                                  const float* __restrict__ We, const float* __restrict__ W2,
                                  const float* __restrict__ b2, const float* __restrict__ W3,
                                  const float* __restrict__ b3, const float* __restrict__ sh,
                                  const float* __restrict__ sc,
                                  const float* __restrict__ gate, const tf::Dropout drop,
                                  float* __restrict__ out, int B, int L, int K, int N) {
  edge_walk(We, W2, b2, W3, b3, B, L, K,
            [=](const float* sWe, const float* sW2, const float* sW3, const float* sb2,
                const float* sb3, const tf::Slab& s) {
              tf::edge_slab<DROP, MASK_OUT>(E, A, Gn, idx, sWe, sW2, sW3, sb2, sb3, sh, sc,
                                            gate, out, L, N, s, drop);
            });
}

// K6's forward in f32: out[b, l, k] = h2 W3 + b3, K2's walk with
// raw_slab's epilogue (no LayerNorm; sh, sc, the gate not read)
__global__ void __launch_bounds__(tf::TNT, 1)
message_edge_f32_mma_kernel(const float* __restrict__ A, const float* __restrict__ E,
                            const float* __restrict__ Gn, const int* __restrict__ idx,
                            const float* __restrict__ We, const float* __restrict__ W2,
                            const float* __restrict__ b2, const float* __restrict__ W3,
                            const float* __restrict__ b3, float* __restrict__ out, int B, int L,
                            int K, int N) {
  edge_walk(We, W2, b2, W3, b3, B, L, K,
            [=](const float* sWe, const float* sW2, const float* sW3, const float* sb2,
                const float* sb3, const tf::Slab& s) {
              tf::raw_slab(E, A, Gn, idx, sWe, sW2, sW3, sb2, sb3, out, L, N, s);
            });
}

// K7 in f32: e_out = K2 of the edge set; n_out = K1 of the node set on e_out
__global__ void __launch_bounds__(tf::TNT, 1)
edge_then_sum_f32_mma_kernel(const float* __restrict__ Ae, const float* __restrict__ E,
                             const float* __restrict__ Ge, const int* __restrict__ idx,
                             const float* __restrict__ Wee, const float* __restrict__ W2e,
                             const float* __restrict__ b2e, const float* __restrict__ W3e,
                             const float* __restrict__ b3e, const float* __restrict__ sh,
                             const float* __restrict__ sc, const float* __restrict__ gmod,
                             const float* __restrict__ An, const float* __restrict__ Gnn,
                             const float* __restrict__ Wen, const float* __restrict__ W2n,
                             const float* __restrict__ b2n, const float* __restrict__ W3n,
                             const float* __restrict__ b3n, const float* __restrict__ mask,
                             float* e_out, float* __restrict__ n_out, int B, int L, int K,
                             int N, float scale) {
  extern __shared__ __align__(16) float fsm[];
  float* w0 = fsm;                 // W_e of the edge set, then of the node set
  float* w1 = w0 + tf::WFLOATS;    // W2 likewise
  float* w2 = w1 + tf::WFLOATS;    // W3 likewise
  float* vec = w2 + tf::WFLOATS;   // b2e, b3e, b2n, b3n
  float* ssum = vec + 4 * H;
  float* smsum = ssum + 2 * tf::TRES * tf::SS;
  tf::load_vec(vec, b2e);
  tf::load_vec(vec + H, b3e);
  tf::load_vec(vec + 2 * H, b2n);
  tf::load_vec(vec + 3 * H, b3n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tps = (L + tf::TRES - 1) / tf::TRES;
  int par = 0;
  for (int tile = blockIdx.x; tile < B * tps; tile += gridDim.x, par ^= 1) {
    const int b = tile / tps, l0 = (tile - b * tps) * tf::TRES, l = l0 + warp;
    __syncthreads();  // every warp is done with the node weights
    tf::stage_frag<false, true>(w0, Wee);
    tf::stage_frag<true, false>(w1, W2e);
    tf::stage_frag<false, false>(w2, W3e);
    __syncthreads();
    if (l < L)
      for (int q = 0; 16 * q < K; ++q)
        tf::edge_slab(E, Ae, Ge, idx, w0, w1, w2, vec, vec + H, sh, sc, gmod, e_out, L, N,
                      tf::make_slab(b, l, q, L, K, lane));
    __syncthreads();  // every warp is done with the edge weights
    tf::stage_frag<false, true>(w0, Wen);
    tf::stage_frag<true, false>(w1, W2n);
    tf::stage_frag<false, false>(w2, W3n);
    __syncthreads();
    float* ss = ssum + par * tf::TRES * tf::SS;
    float* sm = smsum + par * tf::TRES;
    tf::residue_sum(ss + warp * tf::SS, sm + warp, e_out, An, Gnn, idx, mask, w0, w1,
                    vec + 2 * H, b, l, L, K, N, lane);
    __syncthreads();
    tf::residue_out(ss, sm, w2, vec + 3 * H, n_out, b, l0, L, scale, warp, lane);
  }
}

using tf::sm_count;
using tf::smem_once;

int launch_sum_f32_mma(const void* A, const void* E, const void* Gn, const void* idx,
                       const void* mask, const void* We, const void* W2, const void* b2,
                       const void* W3, const void* b3, void* out, int B, int L, int K, int N,
                       float scale, void* stream) {
  if (bad_dims(B, L, K, N)) return (int)cudaErrorInvalidValue;
  static unsigned done = 0;
  const cudaError_t err = smem_once(message_sum_f32_mma_kernel, F1SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)B * ((L + tf::TRES - 1) / tf::TRES);
  const int grid = (int)std::min<long long>(tiles, sm_count());
  message_sum_f32_mma_kernel<<<grid, tf::TNT, F1SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(E), static_cast<const float*>(Gn),
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const float*>(We), static_cast<const float*>(W2),
      static_cast<const float*>(b2), static_cast<const float*>(W3),
      static_cast<const float*>(b3), static_cast<float*>(out), B, L, K, N, scale);
  return (int)cudaGetLastError();
}

template <int DROP, bool MASK_OUT>
int launch_edge_lnmod_f32_mma(const void* A, const void* E, const void* Gn, const void* idx,
                              const void* We, const void* W2, const void* b2, const void* W3,
                              const void* b3, const void* sh, const void* sc, const void* gate,
                              const tf::Dropout& drop, void* out, int B, int L, int K, int N,
                              void* stream) {
  if (bad_dims(B, L, K, N)) return (int)cudaErrorInvalidValue;
  auto kern = message_edge_lnmod_f32_mma_kernel<DROP, MASK_OUT>;
  static unsigned done = 0;
  const cudaError_t err = smem_once(kern, F2SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)B * L * ((K + 15) / 16);
  const int grid = (int)std::min<long long>((warps + tf::TW - 1) / tf::TW, sm_count());
  kern<<<grid, tf::TNT, F2SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(E), static_cast<const float*>(Gn),
      static_cast<const int*>(idx), static_cast<const float*>(We),
      static_cast<const float*>(W2), static_cast<const float*>(b2),
      static_cast<const float*>(W3), static_cast<const float*>(b3),
      static_cast<const float*>(sh), static_cast<const float*>(sc),
      static_cast<const float*>(gate), drop, static_cast<float*>(out), B, L, K, N);
  return (int)cudaGetLastError();
}

int launch_edge_f32_mma(const void* A, const void* E, const void* Gn, const void* idx,
                        const void* We, const void* W2, const void* b2, const void* W3,
                        const void* b3, void* out, int B, int L, int K, int N, void* stream) {
  if (bad_dims(B, L, K, N)) return (int)cudaErrorInvalidValue;
  static unsigned done = 0;
  const cudaError_t err = smem_once(message_edge_f32_mma_kernel, F2SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const long long warps = (long long)B * L * ((K + 15) / 16);
  const int grid = (int)std::min<long long>((warps + tf::TW - 1) / tf::TW, sm_count());
  message_edge_f32_mma_kernel<<<grid, tf::TNT, F2SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(E), static_cast<const float*>(Gn),
      static_cast<const int*>(idx), static_cast<const float*>(We),
      static_cast<const float*>(W2), static_cast<const float*>(b2),
      static_cast<const float*>(W3), static_cast<const float*>(b3), static_cast<float*>(out),
      B, L, K, N);
  return (int)cudaGetLastError();
}

int launch_edge_then_sum_f32_mma(const void* Ae, const void* E, const void* Ge, const void* idx,
                                 const void* Wee, const void* W2e, const void* b2e,
                                 const void* W3e, const void* b3e, const void* sh,
                                 const void* sc, const void* gmod, const void* An,
                                 const void* Gnn, const void* Wen, const void* W2n,
                                 const void* b2n, const void* W3n, const void* b3n,
                                 const void* mask, void* e_out, void* n_out, int B, int L,
                                 int K, int N, float scale, void* stream) {
  if (bad_dims(B, L, K, N)) return (int)cudaErrorInvalidValue;
  static unsigned done = 0;
  const cudaError_t err = smem_once(edge_then_sum_f32_mma_kernel, F7SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)B * ((L + tf::TRES - 1) / tf::TRES);
  const int grid = (int)std::min<long long>(tiles, sm_count());
  edge_then_sum_f32_mma_kernel<<<grid, tf::TNT, F7SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(Ae), static_cast<const float*>(E),
      static_cast<const float*>(Ge), static_cast<const int*>(idx),
      static_cast<const float*>(Wee), static_cast<const float*>(W2e),
      static_cast<const float*>(b2e), static_cast<const float*>(W3e),
      static_cast<const float*>(b3e), static_cast<const float*>(sh),
      static_cast<const float*>(sc), static_cast<const float*>(gmod),
      static_cast<const float*>(An), static_cast<const float*>(Gnn),
      static_cast<const float*>(Wen), static_cast<const float*>(W2n),
      static_cast<const float*>(b2n), static_cast<const float*>(W3n),
      static_cast<const float*>(b3n), static_cast<const float*>(mask),
      static_cast<float*>(e_out), static_cast<float*>(n_out), B, L, K, N, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: K1 (`message_sum_mma_kernel`), K2
// (`message_edge_lnmod_mma_kernel`) and K7 (`edge_then_sum_mma_kernel`),
// built from the slab functions below. K7 runs K2's functions and then K1's,
// so its outputs are K2's kernel followed by K1's kernel, bit for bit; K6
// (`message_edge_mma_kernel`) runs K2's chain with its own epilogue.

using namespace chain_mma;

constexpr int MSMEM = 2 * WBYTES + TBYTES + H * 4;          // K1: W_e, W2, E; b2
constexpr int ESMEM = 2 * WBYTES + TBYTES + 5 * H * 4;      // K2: W3 restaged; b2 b3 sh sc g
constexpr int RSMEM = 2 * WBYTES + TBYTES + 2 * H * 4;      // K6: W3 restaged; b2 b3
constexpr int PSMEM = 2 * WBYTES + TBYTES + 6 * H * 4;      // K7; and the node b2

// K1: h2 = gelu(x2 + b2) of half hf times the rows' masks (m0: row g, m8:
// row g + 8), summed over the slab's 16 rows, into red[64 hf .. 64 hf + 63]
__device__ __forceinline__ void masked_row_sums(const float (&c2)[8][4], const float* sb2,
                                                float m0, float m8, int hf, float* red,
                                                int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  // part[2 o + e] = mask h2 of column 8 (8 hf + o) + 2 t4 + e
  float part[16];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const float2 bias = *reinterpret_cast<const float2*>(sb2 + 8 * (8 * hf + o) + 2 * t4);
    part[2 * o] = m0 * gelu_exp(c2[o][0] + bias.x) + m8 * gelu_exp(c2[o][2] + bias.x);
    part[2 * o + 1] = m0 * gelu_exp(c2[o][1] + bias.y) + m8 * gelu_exp(c2[o][3] + bias.y);
  }
  reduce_rows(part, lane);
  // part[0], part[1]: the sums of original index 2 (4 b0 + 2 b1 + b2) + (0, 1)
  const int o = 4 * (g & 1) + 2 * ((g >> 1) & 1) + (g >> 2);
  *reinterpret_cast<float2*>(red + 8 * (8 * hf + o) + 2 * t4) = make_float2(part[0], part[1]);
}

// K1's chain from the preset accumulators: products 1 and 2 (WAIT_W2: W2
// is still arriving, its cp.async group the last committed), the slab's
// masked row sums into its own (no longer read) rows of sE, the residues'
// sums over their K / 16 slabs in slab order (a run repeats bit for bit),
// rounded to bf16, into W_e's buffer (free by then) with the mask counts,
// and the per-residue epilogue out = (ssum W3 + msum b3) / scale: K-fold
// fewer rows, on CUDA cores, W3 from device memory.
template <bool WAIT_W2>
__device__ __forceinline__ void message_sum_chain(float (&acc)[16][4], unsigned char* sWe,
                                                  const unsigned char* sW2, unsigned char* sE,
                                                  const float* sb2,
                                                  const float* __restrict__ mask,
                                                  const bf16* __restrict__ W3,
                                                  const float* __restrict__ b3,
                                                  float* __restrict__ out, int L, int K,
                                                  float scale, const Slab& s) {
  unsigned y[16][2];
  if (s.active) {
    mma_edge_we(acc, sE, sWe, s);
    gelu_pack(y, acc);
  }
  if constexpr (WAIT_W2) {
    mma::cp_async_wait<0>();
    __syncthreads();
  }
  if (s.active) {
    const int g = s.lane >> 2;
    const float m0 = s.r0 + g < s.nrows ? mask[s.row0 + s.r0 + g] : 0.0f;
    const float m8 = s.r0 + g + 8 < s.nrows ? mask[s.row0 + s.r0 + g + 8] : 0.0f;
    float* red = reinterpret_cast<float*>(sE + s.r0 * MRS);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float c2[8][4];
      mma_w2_half(c2, y, sW2, hf, s.lane);
      masked_row_sums(c2, sb2, m0, m8, hf, red, s.lane);
    }
  }
  __syncthreads();

  float* ssum = reinterpret_cast<float*>(sWe);  // [TL][H]
  float* msum = ssum + s.TL * H;                // [TL]
  const int spr = K / 16;
  for (int i = threadIdx.x; i < s.TL * H; i += MNT) {
    const int ll = i / H, c = i - ll * H;
    float v = 0.0f;
    for (int q = 0; q < spr; ++q)
      v += reinterpret_cast<const float*>(sE + 16 * (ll * spr + q) * MRS)[c];
    ssum[i] = round_bf16(v);
  }
  for (int ll = threadIdx.x; ll < s.TL; ll += MNT) {
    float v = 0.0f;
    if (s.l0 + ll < L)
      for (int k = 0; k < K; ++k) v += mask[s.row0 + (size_t)ll * K + k];
    msum[ll] = v;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s.TL * H; i += MNT) {
    const int ll = i / H, c = i - ll * H;
    if (s.l0 + ll >= L) continue;
    float v = 0.0f;
    for (int j = 0; j < H; ++j) v = fmaf(ssum[ll * H + j], __bfloat162float(W3[j * H + c]), v);
    v += msum[ll] * b3[c];
    out[((size_t)s.b * L + s.l0 + ll) * H + c] = v / scale;
  }
}

// K2: h2 = gelu(x2 + b2) of half hf, cast to bf16 and packed as the A
// fragments of the W3 product (the same fragment trick as y)
__device__ __forceinline__ void h2_pack(unsigned (&h2)[16][2], const float (&c2)[8][4],
                                        const float* sb2, int hf, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int nt = 8 * hf + o;
    const float2 bias = *reinterpret_cast<const float2*>(sb2 + 8 * nt + 2 * t4);
    h2[nt][0] = pack_bf16(gelu_exp(c2[o][0] + bias.x), gelu_exp(c2[o][1] + bias.y));
    h2[nt][1] = pack_bf16(gelu_exp(c2[o][2] + bias.x), gelu_exp(c2[o][3] + bias.y));
  }
}

// K2's epilogue in registers: resid = E + (msg + b3) with E read from the
// slab's rows of sE at the accumulator positions (conflict-free at the
// 272-byte stride); a row's 128 columns lie in the 4 lanes of a quad, so the
// LayerNorm's two passes (the mean, then the mean of squared deviations;
// eps 1e-6, no affine) are local sums and two shuffles each; out = g
// (LN (1 + sc) + sh), cast to bf16 into the slab's own rows of sE, then
// written to `out` in 16-byte stores. vec holds b2, b3, sh, sc, g of
// sample b ([5][H] f32). K5 (DROP 1, 2): msg + b3 times keep_pair's scales
// first, and with MASK_OUT the scales to d.mask_out (f32 [B, L, K, H]).
struct Drop {
  const bf16* keep;      // DROP 1
  const int* seeds;      // DROP 2, with thresh and kscale
  uint32_t thresh;
  float kscale;
  float* mask_out;       // MASK_OUT
  int K;
};

template <int DROP = 0, bool MASK_OUT = false>
__device__ __forceinline__ void lnmod_out(float (&acc)[16][4], unsigned char* sE,
                                          const float* vec, bf16* __restrict__ out,
                                          const Slab& s, const Drop d = {}) {
  const int g = s.lane >> 2, t4 = s.lane & 3;
  const float *sb3 = vec + H, *ssh = vec + 2 * H, *ssc = vec + 3 * H, *sg = vec + 4 * H;
  unsigned char* rows = sE + s.r0 * MRS;
  const uint32_t key = DROP == 2 ? sample_key(d.seeds[s.b], s.b) : 0u;
  unsigned km[2] = {0u, 0u};  // the backward's record of the mask, not read here
  float mean[2] = {0.0f, 0.0f}, rstd[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = 8 * nt + 2 * t4;
    const float2 bias = *reinterpret_cast<const float2*>(sb3 + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 e = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(rows + (g + 8 * h) * MRS + 2 * c));
      float x0 = acc[nt][2 * h] + bias.x, x1 = acc[nt][2 * h + 1] + bias.y;
      if constexpr (DROP != 0) {
        const float2 kp = keep_pair<DROP>(d.keep, key, d.thresh, d.kscale, km, d.K, nt, h, c, s);
        x0 *= kp.x;
        x1 *= kp.y;
        if constexpr (MASK_OUT)
          *reinterpret_cast<float2*>(d.mask_out + (s.row0 + s.r0 + g + 8 * h) * H + c) = kp;
      }
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
      for (int e = 0; e < 2; ++e) {
        const float d = acc[nt][2 * h + e] - mean[h];
        rstd[h] += d * d;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rstd[h] += __shfl_xor_sync(0xffffffffu, rstd[h], 1);
    rstd[h] += __shfl_xor_sync(0xffffffffu, rstd[h], 2);
    rstd[h] = rsqrtf(rstd[h] / H + 1e-6f);
  }
  __syncwarp();  // every lane has read its E
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = 8 * nt + 2 * t4;
    const float2 shv = *reinterpret_cast<const float2*>(ssh + c);
    const float2 scv = *reinterpret_cast<const float2*>(ssc + c);
    const float2 gv = *reinterpret_cast<const float2*>(sg + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float o0 = gv.x * (((acc[nt][2 * h] - mean[h]) * rstd[h]) * (1.0f + scv.x) + shv.x);
      const float o1 =
          gv.y * (((acc[nt][2 * h + 1] - mean[h]) * rstd[h]) * (1.0f + scv.y) + shv.y);
      *reinterpret_cast<unsigned*>(rows + (g + 8 * h) * MRS + 2 * c) = pack_bf16(o0, o1);
    }
  }
  __syncwarp();
  write_slab(rows, out + (s.row0 + s.r0) * H, s.lane);
}

// K6's epilogue: out = cast(acc + b3), staged as bf16 in the slab's own rows
// of sE (no longer read: product 1 was this warp's last use of its E rows)
// and written in 16-byte stores; lnmod_out without the residual and the
// LayerNorm.
__device__ __forceinline__ void raw_out(const float (&acc)[16][4], unsigned char* sE,
                                        const float* sb3, bf16* __restrict__ out,
                                        const Slab& s) {
  const int g = s.lane >> 2, t4 = s.lane & 3;
  unsigned char* rows = sE + s.r0 * MRS;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const int c = 8 * nt + 2 * t4;
    const float2 bias = *reinterpret_cast<const float2*>(sb3 + c);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<unsigned*>(rows + (g + 8 * h) * MRS + 2 * c) =
          pack_bf16(acc[nt][2 * h] + bias.x, acc[nt][2 * h + 1] + bias.y);
  }
  __syncwarp();
  write_slab(rows, out + (s.row0 + s.r0) * H, s.lane);
}

// The per-edge chain (K2, K6, K7's edge half) from the preset accumulators:
// products 1 and 2, h2 in registers, product 3 into acc, then `epilogue(acc)`
// in the warps that hold edge rows (K2 and K7: lnmod_out; K6: raw_out). W_e
// sits in sW0 and W2 in sW2; W3 is copied into sW0 once every warp is done
// with product 1, overlapping product 2. `w2_free()` runs in every thread
// once W3 is in place and no warp reads sW2 any more (K7 restages there).
// sb2 holds b2.
template <typename F, typename G>
__device__ __forceinline__ void edge_chain(float (&acc)[16][4], unsigned char* sW0,
                                           const unsigned char* sW2,
                                           const bf16* __restrict__ W3, unsigned char* sE,
                                           const float* sb2, const Slab& s, F&& w2_free,
                                           G&& epilogue) {
  unsigned y[16][2];
  if (s.active) {
    mma_edge_we(acc, sE, sW0, s);
    gelu_pack(y, acc);
  }
  __syncthreads();  // every warp is done with W_e
  stage_rows<false>(sW0, W3);
  mma::cp_async_commit();
  unsigned h2[16][2];
  if (s.active) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float c2[8][4];
      mma_w2_half(c2, y, sW2, hf, s.lane);
      h2_pack(h2, c2, sb2, hf, s.lane);
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // W3 in place; every warp is done with W2
  w2_free();
  if (s.active) {
    mma_w3(acc, h2, sW0, s.lane);
    epilogue(acc);
  }
}

// K1 for bf16 E (module note): a block of MW warps owns MROWS edge rows,
// floor(MROWS / K) whole residues (K a multiple of 16; the rows past the
// last whole residue idle), a warp a 16-row slab of one residue.
__global__ void __launch_bounds__(MNT, 2)
message_sum_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ E,
                       const bf16* __restrict__ Gn, const int* __restrict__ idx,
                       const float* __restrict__ mask, const bf16* __restrict__ We,
                       const bf16* __restrict__ W2, const float* __restrict__ b2,
                       const bf16* __restrict__ W3, const float* __restrict__ b3,
                       float* __restrict__ out, int L, int K, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sWe = smem;             // [H][MRS] W_e, columns in unit order
  unsigned char* sW2 = sWe + WBYTES;     // [H][MRS] W2, rows in unit order
  unsigned char* sE = sW2 + WBYTES;      // [MROWS][MRS] the edge tile
  float* sb2 = reinterpret_cast<float*>(sE + TBYTES);
  const Slab s = make_slab(L, K);
  stage_we(sWe, We);
  stage_rows<true>(sW2, W2);
  stage_edges(sE, E, s);
  load_vec(sb2, b2);
  mma::cp_async_commit();
  float acc[16][4];
  preset_pre(acc, A, Gn, idx, L, K, N, s);
  mma::cp_async_wait<0>();
  __syncthreads();
  message_sum_chain<false>(acc, sWe, sW2, sE, sb2, mask, W3, b3, out, L, K, scale, s);
}

// K2 (DROP 0) and K5's forward (DROP 1: `keep`; DROP 2: `seeds`) for bf16
// E: K1's block and slabs; W3 is restaged into W_e's buffer (ESMEM: two
// blocks an SM).
template <int DROP, bool MASK_OUT>
__global__ void __launch_bounds__(MNT, 2)
message_edge_lnmod_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ E,
                              const bf16* __restrict__ Gn, const int* __restrict__ idx,
                              const bf16* __restrict__ We, const bf16* __restrict__ W2,
                              const float* __restrict__ b2, const bf16* __restrict__ W3,
                              const float* __restrict__ b3, const float* __restrict__ sh,
                              const float* __restrict__ sc, const float* __restrict__ gate,
                              const Drop drop, bf16* __restrict__ out, int L, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sW0 = smem;             // W_e, then W3
  unsigned char* sW2 = sW0 + WBYTES;
  unsigned char* sE = sW2 + WBYTES;
  float* vec = reinterpret_cast<float*>(sE + TBYTES);  // b2, b3, sh, sc, g
  const Slab s = make_slab(L, K);
  stage_we(sW0, We);
  stage_rows<true>(sW2, W2);
  stage_edges(sE, E, s);
  load_vec(vec, b2);
  load_vec(vec + H, b3);
  load_vec(vec + 2 * H, sh + (size_t)s.b * H);
  load_vec(vec + 3 * H, sc + (size_t)s.b * H);
  load_vec(vec + 4 * H, gate + (size_t)s.b * H);
  mma::cp_async_commit();
  float acc[16][4];
  preset_pre(acc, A, Gn, idx, L, K, N, s);
  mma::cp_async_wait<0>();
  __syncthreads();
  edge_chain(acc, sW0, sW2, W3, sE, vec, s, [] {},
             [&](float (&a)[16][4]) { lnmod_out<DROP, MASK_OUT>(a, sE, vec, out, s, drop); });
}

// K6 for bf16 E: K2's kernel with raw_out for its epilogue (RSMEM: b2 and b3
// only; two blocks an SM).
__global__ void __launch_bounds__(MNT, 2)
message_edge_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ E,
                        const bf16* __restrict__ Gn, const int* __restrict__ idx,
                        const bf16* __restrict__ We, const bf16* __restrict__ W2,
                        const float* __restrict__ b2, const bf16* __restrict__ W3,
                        const float* __restrict__ b3, bf16* __restrict__ out, int L, int K,
                        int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sW0 = smem;             // W_e, then W3
  unsigned char* sW2 = sW0 + WBYTES;
  unsigned char* sE = sW2 + WBYTES;
  float* vec = reinterpret_cast<float*>(sE + TBYTES);  // b2, b3
  const Slab s = make_slab(L, K);
  stage_we(sW0, We);
  stage_rows<true>(sW2, W2);
  stage_edges(sE, E, s);
  load_vec(vec, b2);
  load_vec(vec + H, b3);
  mma::cp_async_commit();
  float acc[16][4];
  preset_pre(acc, A, Gn, idx, L, K, N, s);
  mma::cp_async_wait<0>();
  __syncthreads();
  edge_chain(acc, sW0, sW2, W3, sE, vec, s, [] {},
             [&](float (&a)[16][4]) { raw_out(a, sE, vec + H, out, s); });
}

// K7 for bf16 E: K2's chain with the edge weights, then K1's with the node
// weights on e2, which each warp keeps in its own slab rows (a warp only
// reads its own rows: no block barrier for e2). Two weight buffers, each
// restaged as soon as the last warp is done with it: b0 W_e -> W3 -> node
// W2, b1 W2 -> node W_e; the node W3 is read per residue from device memory.
__global__ void __launch_bounds__(MNT, 2)
edge_then_sum_mma_kernel(const bf16* __restrict__ Ae, const bf16* __restrict__ E,
                         const bf16* __restrict__ Ge, const int* __restrict__ idx,
                         const bf16* __restrict__ Wee, const bf16* __restrict__ W2e,
                         const float* __restrict__ b2e, const bf16* __restrict__ W3e,
                         const float* __restrict__ b3e, const float* __restrict__ sh,
                         const float* __restrict__ sc, const float* __restrict__ gmod,
                         const bf16* __restrict__ An, const bf16* __restrict__ Gnn,
                         const bf16* __restrict__ Wen, const bf16* __restrict__ W2n,
                         const float* __restrict__ b2n, const bf16* __restrict__ W3n,
                         const float* __restrict__ b3n, const float* __restrict__ mask,
                         bf16* __restrict__ e_out, float* __restrict__ n_out, int L, int K,
                         int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* b0 = smem;             // W_e, then W3, then the node W2
  unsigned char* b1 = b0 + WBYTES;      // W2, then the node W_e
  unsigned char* sE = b1 + WBYTES;      // E, then e2 (each warp its own slab)
  float* vec = reinterpret_cast<float*>(sE + TBYTES);  // b2, b3, sh, sc, g; node b2
  const Slab s = make_slab(L, K);
  stage_we(b0, Wee);
  stage_rows<true>(b1, W2e);
  stage_edges(sE, E, s);
  load_vec(vec, b2e);
  load_vec(vec + H, b3e);
  load_vec(vec + 2 * H, sh + (size_t)s.b * H);
  load_vec(vec + 3 * H, sc + (size_t)s.b * H);
  load_vec(vec + 4 * H, gmod + (size_t)s.b * H);
  load_vec(vec + 5 * H, b2n);
  mma::cp_async_commit();
  float acc[16][4];
  preset_pre(acc, Ae, Ge, idx, L, K, N, s);
  mma::cp_async_wait<0>();
  __syncthreads();
  edge_chain(acc, b0, b1, W3e, sE, vec, s,
             [b1, Wen] {
               stage_we(b1, Wen);
               mma::cp_async_commit();
             },
             [&](float (&a)[16][4]) { lnmod_out(a, sE, vec, e_out, s); });
  __syncthreads();  // every warp is done with W3
  stage_rows<true>(b0, W2n);
  mma::cp_async_commit();
  preset_pre(acc, An, Gnn, idx, L, K, N, s);
  mma::cp_async_wait<1>();
  __syncthreads();  // the node W_e in place (the node W2 may still be arriving)
  message_sum_chain<true>(acc, b1, b0, sE, vec + 5 * H, mask, W3n, b3n, n_out, L, K, scale, s);
}

bool bad_mma_dims(int B, int L, int K, int N) {
  return B <= 0 || L <= 0 || N <= 0 || K <= 0 || K > MROWS || K % 16 != 0;
}

dim3 mma_grid(int B, int L, int K) {
  const int TL = MROWS / K;
  return dim3((L + TL - 1) / TL, B);
}

template <typename KernelT>
cudaError_t set_smem(KernelT kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int launch_sum_mma(const void* A, const void* E, const void* Gn, const void* idx,
                   const void* mask, const void* We, const void* W2, const void* b2,
                   const void* W3, const void* b3, void* out, int B, int L, int K, int N,
                   float scale, void* stream) {
  if (bad_mma_dims(B, L, K, N)) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(message_sum_mma_kernel, MSMEM);
  if (err != cudaSuccess) return (int)err;
  message_sum_mma_kernel<<<mma_grid(B, L, K), MNT, MSMEM,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(E), static_cast<const bf16*>(Gn),
      static_cast<const int*>(idx), static_cast<const float*>(mask),
      static_cast<const bf16*>(We), static_cast<const bf16*>(W2),
      static_cast<const float*>(b2), static_cast<const bf16*>(W3),
      static_cast<const float*>(b3), static_cast<float*>(out), L, K, N, scale);
  return (int)cudaGetLastError();
}

template <int DROP, bool MASK_OUT>
int launch_edge_lnmod_mma(const void* A, const void* E, const void* Gn, const void* idx,
                          const void* We, const void* W2, const void* b2, const void* W3,
                          const void* b3, const void* sh, const void* sc, const void* gate,
                          const Drop& drop, void* out, int B, int L, int K, int N,
                          void* stream) {
  if (bad_mma_dims(B, L, K, N)) return (int)cudaErrorInvalidValue;
  auto kern = message_edge_lnmod_mma_kernel<DROP, MASK_OUT>;
  cudaError_t err = set_smem(kern, ESMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<mma_grid(B, L, K), MNT, ESMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(E), static_cast<const bf16*>(Gn),
      static_cast<const int*>(idx), static_cast<const bf16*>(We),
      static_cast<const bf16*>(W2), static_cast<const float*>(b2),
      static_cast<const bf16*>(W3), static_cast<const float*>(b3),
      static_cast<const float*>(sh), static_cast<const float*>(sc),
      static_cast<const float*>(gate), drop, static_cast<bf16*>(out), L, K, N);
  return (int)cudaGetLastError();
}

int launch_edge_mma(const void* A, const void* E, const void* Gn, const void* idx,
                    const void* We, const void* W2, const void* b2, const void* W3,
                    const void* b3, void* out, int B, int L, int K, int N, void* stream) {
  if (bad_mma_dims(B, L, K, N)) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(message_edge_mma_kernel, RSMEM);
  if (err != cudaSuccess) return (int)err;
  message_edge_mma_kernel<<<mma_grid(B, L, K), MNT, RSMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(E), static_cast<const bf16*>(Gn),
      static_cast<const int*>(idx), static_cast<const bf16*>(We),
      static_cast<const bf16*>(W2), static_cast<const float*>(b2),
      static_cast<const bf16*>(W3), static_cast<const float*>(b3), static_cast<bf16*>(out),
      L, K, N);
  return (int)cudaGetLastError();
}

int launch_edge_then_sum_mma(const void* Ae, const void* E, const void* Ge, const void* idx,
                             const void* Wee, const void* W2e, const void* b2e,
                             const void* W3e, const void* b3e, const void* sh,
                             const void* sc, const void* gmod, const void* An,
                             const void* Gnn, const void* Wen, const void* W2n,
                             const void* b2n, const void* W3n, const void* b3n,
                             const void* mask, void* e_out, void* n_out, int B, int L, int K,
                             int N, float scale, void* stream) {
  if (bad_mma_dims(B, L, K, N)) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(edge_then_sum_mma_kernel, PSMEM);
  if (err != cudaSuccess) return (int)err;
  edge_then_sum_mma_kernel<<<mma_grid(B, L, K), MNT, PSMEM,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(Ae), static_cast<const bf16*>(E), static_cast<const bf16*>(Ge),
      static_cast<const int*>(idx), static_cast<const bf16*>(Wee),
      static_cast<const bf16*>(W2e), static_cast<const float*>(b2e),
      static_cast<const bf16*>(W3e), static_cast<const float*>(b3e),
      static_cast<const float*>(sh), static_cast<const float*>(sc),
      static_cast<const float*>(gmod), static_cast<const bf16*>(An),
      static_cast<const bf16*>(Gnn), static_cast<const bf16*>(Wen),
      static_cast<const bf16*>(W2n), static_cast<const float*>(b2n),
      static_cast<const bf16*>(W3n), static_cast<const float*>(b3n),
      static_cast<const float*>(mask), static_cast<bf16*>(e_out), static_cast<float*>(n_out),
      L, K, N, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int message_sum_f32(const void* A, const void* E, const void* Gn, const void* idx,
                    const void* mask, const void* We, const void* W2, const void* b2,
                    const void* W3, const void* b3, void* out, int B, int L, int K, int N,
                    float scale, void* stream) {
  return launch_sum_f32_mma(A, E, Gn, idx, mask, We, W2, b2, W3, b3, out, B, L, K, N, scale,
                            stream);
}

// bf16 on the tensor cores: K a multiple of 16, at most 128
int message_sum_bf16(const void* A, const void* E, const void* Gn, const void* idx,
                     const void* mask, const void* We, const void* W2, const void* b2,
                     const void* W3, const void* b3, void* out, int B, int L, int K, int N,
                     float scale, void* stream) {
  return launch_sum_mma(A, E, Gn, idx, mask, We, W2, b2, W3, b3, out, B, L, K, N, scale,
                        stream);
}

int message_edge_lnmod_f32(const void* A, const void* E, const void* Gn, const void* idx,
                           const void* We, const void* W2, const void* b2, const void* W3,
                           const void* b3, const void* sh, const void* sc, const void* gate,
                           void* out, int B, int L, int K, int N, void* stream) {
  return launch_edge_lnmod_f32_mma<0, false>(A, E, Gn, idx, We, W2, b2, W3, b3, sh, sc, gate,
                                              tf::Dropout{}, out, B, L, K, N, stream);
}

// bf16 on the tensor cores: K a multiple of 16, at most 128
int message_edge_lnmod_bf16(const void* A, const void* E, const void* Gn, const void* idx,
                            const void* We, const void* W2, const void* b2, const void* W3,
                            const void* b3, const void* sh, const void* sc, const void* gate,
                            void* out, int B, int L, int K, int N, void* stream) {
  return launch_edge_lnmod_mma<0, false>(A, E, Gn, idx, We, W2, b2, W3, b3, sh, sc, gate,
                                         Drop{}, out, B, L, K, N, stream);
}

// K5 forward: K2 with dropout on the message. Exactly one of `keep` (E's
// dtype, [B, L, K, H] scales 0 or 1/(1-p)) and `seeds` (int32 [B]) is given;
// with seeds, `mask_out` (f32 [B, L, K, H]) may receive the generated scales.
// f32 on the tensor cores (3xTF32), K2's kernel: K at most 64, a multiple of 4
int message_edge_lnmod_drop_f32(const void* A, const void* E, const void* Gn,
                                const void* idx, const void* We, const void* W2,
                                const void* b2, const void* W3, const void* b3,
                                const void* sh, const void* sc, const void* gate,
                                const void* keep, const void* seeds, void* mask_out,
                                void* out, int B, int L, int K, int N, unsigned thresh,
                                float kscale, void* stream) {
  if ((keep == nullptr) == (seeds == nullptr)) return (int)cudaErrorInvalidValue;
  const tf::Dropout d{static_cast<const float*>(keep), static_cast<const int*>(seeds), thresh,
                      kscale, static_cast<float*>(mask_out), (long long)L * K};
  if (keep != nullptr)
    return launch_edge_lnmod_f32_mma<1, false>(A, E, Gn, idx, We, W2, b2, W3, b3, sh, sc, gate,
                                               d, out, B, L, K, N, stream);
  if (mask_out != nullptr)
    return launch_edge_lnmod_f32_mma<2, true>(A, E, Gn, idx, We, W2, b2, W3, b3, sh, sc, gate,
                                              d, out, B, L, K, N, stream);
  return launch_edge_lnmod_f32_mma<2, false>(A, E, Gn, idx, We, W2, b2, W3, b3, sh, sc, gate, d,
                                             out, B, L, K, N, stream);
}

// bf16 on the tensor cores, K2's kernel: K a multiple of 16, at most 128
int message_edge_lnmod_drop_bf16(const void* A, const void* E, const void* Gn,
                                 const void* idx, const void* We, const void* W2,
                                 const void* b2, const void* W3, const void* b3,
                                 const void* sh, const void* sc, const void* gate,
                                 const void* keep, const void* seeds, void* mask_out,
                                 void* out, int B, int L, int K, int N, unsigned thresh,
                                 float kscale, void* stream) {
  if ((keep == nullptr) == (seeds == nullptr)) return (int)cudaErrorInvalidValue;
  const Drop d{static_cast<const bf16*>(keep), static_cast<const int*>(seeds), thresh,
               kscale, static_cast<float*>(mask_out), K};
  if (keep != nullptr)
    return launch_edge_lnmod_mma<1, false>(A, E, Gn, idx, We, W2, b2, W3, b3, sh, sc, gate,
                                           d, out, B, L, K, N, stream);
  if (mask_out != nullptr)
    return launch_edge_lnmod_mma<2, true>(A, E, Gn, idx, We, W2, b2, W3, b3, sh, sc, gate,
                                          d, out, B, L, K, N, stream);
  return launch_edge_lnmod_mma<2, false>(A, E, Gn, idx, We, W2, b2, W3, b3, sh, sc, gate, d,
                                         out, B, L, K, N, stream);
}

// K6: the raw per-edge messages cast(h2) W3 + b3, [B, L, K, H] in E's dtype.
// f32 on the tensor cores (3xTF32), K2's kernel: K at most 64, a multiple of 4
int message_edge_f32(const void* A, const void* E, const void* Gn, const void* idx,
                     const void* We, const void* W2, const void* b2, const void* W3,
                     const void* b3, void* out, int B, int L, int K, int N, void* stream) {
  return launch_edge_f32_mma(A, E, Gn, idx, We, W2, b2, W3, b3, out, B, L, K, N, stream);
}

// bf16 on the tensor cores: K a multiple of 16, at most 128
int message_edge_bf16(const void* A, const void* E, const void* Gn, const void* idx,
                      const void* We, const void* W2, const void* b2, const void* W3,
                      const void* b3, void* out, int B, int L, int K, int N, void* stream) {
  return launch_edge_mma(A, E, Gn, idx, We, W2, b2, W3, b3, out, B, L, K, N, stream);
}

// K7: e_out [B, L, K, H] (E's dtype) = K2 of (Ae, E, Ge, the edge weights, sh, sc,
// gmod); n_out f32 [B, L, H] = K1 of (An, e_out, Gnn, the node weights, mask,
// scale). Ge and Gnn are [B, N, H] tables indexed by the same idx.
#define EDGE_THEN_SUM(SUFFIX, LAUNCH)                                                    \
  int edge_then_sum_##SUFFIX(                                                            \
      const void* Ae, const void* E, const void* Ge, const void* idx, const void* Wee,   \
      const void* W2e, const void* b2e, const void* W3e, const void* b3e,                \
      const void* sh, const void* sc, const void* gmod, const void* An, const void* Gnn, \
      const void* Wen, const void* W2n, const void* b2n, const void* W3n,                \
      const void* b3n, const void* mask, void* e_out, void* n_out, int B, int L, int K,  \
      int N, float scale, void* stream) {                                                \
    return LAUNCH(Ae, E, Ge, idx, Wee, W2e, b2e, W3e, b3e, sh, sc, gmod, An, Gnn, Wen,   \
                  W2n, b2n, W3n, b3n, mask, e_out, n_out, B, L, K, N, scale, stream);    \
  }

// f32 on the tensor cores (3xTF32): K at most 64, a multiple of 4
EDGE_THEN_SUM(f32, launch_edge_then_sum_f32_mma)
// bf16 on the tensor cores: K a multiple of 16, at most 128
EDGE_THEN_SUM(bf16, launch_edge_then_sum_mma)

}  // extern "C"
