// The slab functions of the bf16 tensor-core message chains, shared by the
// forwards (message_chain.cu: K1, K2 and K5's, K6 and K7) and the backwards
// (message_chain_bwd.cu: K3, K4, K5's and K6's), so that the backwards
// recompute pre, x2 and msg with the forwards' own instructions. A block of MW warps owns MROWS edge rows (whole residues, K
// a multiple of 16), a warp a 16-row slab of one residue x all 128 columns.
// The f32 chains (chain_tf32.cuh) take unit(), gelu_exp and reduce_rows
// from here.
#pragma once

#include "chain_common.cuh"
#include "mma_common.cuh"

namespace chain_mma {

using chain::H;
using bf16 = __nv_bfloat16;
using mma::cp_async16;
using mma::cp_async4;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16;
using mma::pack_bf16;
using mma::round_bf16;
using mma::smem_addr;

constexpr int MW = 8;             // warps a block
constexpr int MNT = 32 * MW;
constexpr int MROWS = 16 * MW;    // edge rows a block, 16 a warp (the mma's m)
constexpr int MRS = 2 * H + 16;   // bytes a row of the E tile and of the weights
constexpr int WBYTES = H * MRS;   // one staged weight
constexpr int TBYTES = MROWS * MRS;

// The first product's column n is hidden unit unit(n): lane t4's columns
// 8 nt + 2 t4 + e (n tile nt < 16, e < 2) are units 32 t4 + 2 nt + e, so a
// lane's part of a row of A, Gn and of pre is 32 consecutive units.
__device__ __forceinline__ int unit(int n) { return 32 * ((n >> 1) & 3) + 2 * (n >> 3) + (n & 1); }

// tanh gelu as x sigmoid(2u) = x / (1 + exp(-2u)), u = sqrt(2/pi) (x + 0.044715 x^3):
// two MUFU operations (ex2, rcp), relative error ~1e-6, against tanhf's ~20
// instructions (tanh.approx.f32, one MUFU but ~5e-4 relative error, is not used)
__device__ __forceinline__ float gelu_exp(float x) {
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return __fdividef(x, 1.0f + __expf(-2.0f * u));
}

// sum v over the 8 lanes of one t4 (lane bits 2, 3, 4 = b0, b1, b2) in
// three butterfly steps, each exchanging half of what is left: v[i], i <
// N2 / 8, ends as the sum of the original v[i + (N2 / 8) (4 b0 + 2 b1 + b2)]
template <int N2>
__device__ __forceinline__ void reduce_rows(float (&v)[N2], int lane) {
  constexpr int HALF = N2 / 2;
#pragma unroll
  for (int st = 0; st < 3; ++st) {
    const int half = HALF >> st;
    const bool hi = (lane >> (2 + st)) & 1;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      if (i < half) {
        const float send = hi ? v[i] : v[half + i];
        const float keep = hi ? v[half + i] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << st);
      }
    }
  }
}

// A block's tile: TL = MROWS / K whole residues of sample b from residue l0
// (K a multiple of 16; the rows past the last whole residue idle), nrows of
// them in the input; this warp's 16-row slab r0 .. r0 + 15 of one residue,
// `active` where it holds edge rows (nrows is a multiple of 16).
struct Slab {
  int b, l0, TL, nrows, r0, lane;
  size_t row0;  // first edge row of the tile in [B * L * K]
  bool active;
};

__device__ __forceinline__ Slab make_slab(int L, int K) {
  Slab s;
  s.TL = MROWS / K;
  s.b = blockIdx.y;
  s.l0 = blockIdx.x * s.TL;
  s.nrows = min(s.TL, L - s.l0) * K;
  s.row0 = ((size_t)s.b * L + s.l0) * K;
  s.lane = threadIdx.x & 31;
  s.r0 = 16 * (threadIdx.x >> 5);
  s.active = s.r0 < s.nrows;
  return s;
}

// Staging (every thread of the block; cp.async, committed by the caller).
// W_e with its columns in unit order, by column pairs (4-byte copies)
__device__ __forceinline__ void stage_we(unsigned char* dst, const bf16* __restrict__ We) {
  for (int i = threadIdx.x; i < H * H / 2; i += MNT) {
    const int k = i / (H / 2), n = 2 * (i - k * (H / 2));
    cp_async4(dst + k * MRS + 2 * n, We + k * H + unit(n));
  }
}

// W by rows, 16-byte copies: in unit order (W2, whose rows are the first
// product's columns) or as it is (W3, whose rows are W2's columns)
template <bool UNIT_ROWS>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const bf16* __restrict__ W) {
  for (int i = threadIdx.x; i < H * H / 8; i += MNT) {
    const int n = i / (H / 8), c = i - n * (H / 8);
    cp_async16(dst + n * MRS + 16 * c, W + (UNIT_ROWS ? unit(n) : n) * H + 8 * c);
  }
}

// the tile's E rows, zeros past nrows
__device__ __forceinline__ void stage_edges(unsigned char* sE, const bf16* __restrict__ E,
                                            const Slab& s) {
  for (int i = threadIdx.x; i < MROWS * H / 8; i += MNT) {
    const int r = i / (H / 8), c = i - r * (H / 8);
    unsigned char* d = sE + r * MRS + 16 * c;
    if (r < s.nrows) cp_async16(d, E + (s.row0 + r) * H + 8 * c);
    else *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
  }
}

// dst[0:H] = src[0:H] (plain loads; visible after the next barrier)
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src) {
  for (int i = threadIdx.x; i < H; i += MNT) dst[i] = src[i];
}

// pre starts as A[l] + Gn[idx] (index clamped into Gn) of rows r0 + g and
// r0 + g + 8, units 32 t4 .. 32 t4 + 31, in 16-byte loads
__device__ __forceinline__ void preset_pre(float (&acc)[16][4], const bf16* __restrict__ A,
                                           const bf16* __restrict__ Gn,
                                           const int* __restrict__ idx, int L, int K, int N,
                                           const Slab& s) {
  const int g = s.lane >> 2, t4 = s.lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = s.r0 + g + 8 * h;
    if (s.active && r < s.nrows) {
      const int l = s.l0 + r / K;
      const int j = min(max(idx[s.row0 + r], 0), N - 1);
      const uint4* ap = reinterpret_cast<const uint4*>(A + ((size_t)s.b * L + l) * H + 32 * t4);
      const uint4* gp = reinterpret_cast<const uint4*>(Gn + ((size_t)s.b * N + j) * H + 32 * t4);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const uint4 au = __ldg(ap + v), gu = __ldg(gp + v);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&au);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gu);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 fa = __bfloat1622float2(a2[m]), fg = __bfloat1622float2(g2[m]);
          acc[4 * v + m][2 * h] = fa.x + fg.x;
          acc[4 * v + m][2 * h + 1] = fa.y + fg.y;
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) acc[nt][2 * h] = acc[nt][2 * h + 1] = 0.0f;
    }
  }
}

// lanes 8i .. 8i + 7 address matrix i of an ldmatrix.x4: for a weight, k
// rows 8 (i & 1) + 0..7 of a k16 step at n tile 2 np + (i >> 1)
__device__ __forceinline__ unsigned weight_addr(const unsigned char* sW, int lane) {
  const int mi = lane >> 3;
  return smem_addr(sW) + (8 * (mi & 1) + (lane & 7)) * MRS + (mi >> 1) * 16;
}

// c[2 np + j] += a (k16 step kk of the slab's rows) times the weight's k
// rows 16 kk .. 16 kk + 15 at n tile 2 (np0 + np) + j, np < NP, j < 2
template <int NP>
__device__ __forceinline__ void mma_step(float (&c)[2 * NP][4], const unsigned (&a)[4],
                                         unsigned w_addr, int kk, int np0) {
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    unsigned bb[4];
    ldmatrix_x4_trans(bb, w_addr + 16 * kk * MRS + 32 * (np0 + np));
    mma_bf16(c[2 * np], a, bb[0], bb[1]);
    mma_bf16(c[2 * np + 1], a, bb[2], bb[3]);
  }
}

// product 1: acc += E W_e of the slab's rows of sE (A fragments by
// ldmatrix), W_e staged by stage_we in sWe
__device__ __forceinline__ void mma_edge_we(float (&acc)[16][4], const unsigned char* sE,
                                            const unsigned char* sWe, const Slab& s) {
  const unsigned e_addr = smem_addr(sE) + (s.r0 + (s.lane & 15)) * MRS + (s.lane >> 4) * 16;
  const unsigned we_addr = weight_addr(sWe, s.lane);
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    unsigned a[4];
    ldmatrix_x4(a, e_addr + 32 * kk);
    mma_step<8>(acc, a, we_addr, kk, 0);
  }
}

// y = cast(gelu(pre)) stays in registers: n tiles 2 kk and 2 kk + 1 of an
// accumulator are the A fragment of k16 step kk of the next product
__device__ __forceinline__ void gelu_pack(unsigned (&y)[16][2], const float (&acc)[16][4]) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    y[nt][0] = pack_bf16(gelu_exp(acc[nt][0]), gelu_exp(acc[nt][1]));
    y[nt][1] = pack_bf16(gelu_exp(acc[nt][2]), gelu_exp(acc[nt][3]));
  }
}

// product 2, half hf: c2 = y W2 at columns 64 hf .. 64 hf + 63 (n tiles
// 8 hf .. 8 hf + 7), W2 staged by stage_rows<true> in sW2
__device__ __forceinline__ void mma_w2_half(float (&c2)[8][4], const unsigned (&y)[16][2],
                                            const unsigned char* sW2, int hf, int lane) {
  const unsigned w2_addr = weight_addr(sW2, lane);
#pragma unroll
  for (int o = 0; o < 8; ++o) c2[o][0] = c2[o][1] = c2[o][2] = c2[o][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const unsigned a[4] = {y[2 * kk][0], y[2 * kk][1], y[2 * kk + 1][0], y[2 * kk + 1][1]};
    mma_step<4>(c2, a, w2_addr, kk, 4 * hf);
  }
}

// product 3: acc = cast(h2) W3, W3 staged by stage_rows<false> in sW3
__device__ __forceinline__ void mma_w3(float (&acc)[16][4], const unsigned (&h2)[16][2],
                                       const unsigned char* sW3, int lane) {
  const unsigned w3_addr = weight_addr(sW3, lane);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    const unsigned a[4] = {h2[2 * kk][0], h2[2 * kk][1], h2[2 * kk + 1][0], h2[2 * kk + 1][1]};
    mma_step<8>(acc, a, w3_addr, kk, 0);
  }
}

// K5's keep scales at row g + 8 h of the slab, natural columns c and c + 1
// of n tile nt, for the forward (message_chain.cu: lnmod_out) and the
// backward (message_chain_bwd.cu: ln_pass1), so that both read one mask.
// DROP 1 reads them from `keep` (E's dtype, [B, L, K, H]); DROP 2 makes
// them from the counter hash, drop_bits(key, ((l0 K) + r) H + c) >= thresh
// with key = sample_key(seeds[b], b) (chain_common.cuh), and records them
// in km[h] (bits 2 nt and 2 nt + 1; the backward's second pass reads them).
template <int DROP>
__device__ __forceinline__ float2 keep_pair(const bf16* __restrict__ keep, uint32_t key,
                                            uint32_t thresh, float kscale, unsigned (&km)[2],
                                            int K, int nt, int h, int c, const Slab& s) {
  const int r = s.r0 + (s.lane >> 2) + 8 * h;  // the row in the tile
  if constexpr (DROP == 1) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(keep + (s.row0 + r) * H + c));
  } else {
    const uint32_t i0 = (uint32_t)(((size_t)s.l0 * K + r) * H + c);
    const bool k0 = chain::drop_bits(key, i0) >= thresh;
    const bool k1 = chain::drop_bits(key, i0 + 1) >= thresh;
    km[h] |= (k0 ? 1u : 0u) << (2 * nt) | (k1 ? 1u : 0u) << (2 * nt + 1);
    return make_float2(k0 ? kscale : 0.0f, k1 ? kscale : 0.0f);
  }
}

// the slab's 16 bf16 rows, staged at MRS bytes a row in `rows`, to dst (row
// stride H) in 16-byte stores: 16 rows x 16 chunks, eight a lane
__device__ __forceinline__ void write_slab(const unsigned char* rows, bf16* __restrict__ dst,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = lane + 32 * j, r = i >> 4, c = i & 15;
    *reinterpret_cast<uint4*>(dst + r * H + 8 * c) =
        *reinterpret_cast<const uint4*>(rows + r * MRS + 16 * c);
  }
}

}  // namespace chain_mma
