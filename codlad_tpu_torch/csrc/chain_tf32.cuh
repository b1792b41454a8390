// The slab functions of the f32 tensor-core message chains (message_chain.cu:
// K1 `message_sum_f32_mma_kernel`, K2 `message_edge_lnmod_f32_mma_kernel`
// and K7 `edge_then_sum_f32_mma_kernel`). Every product runs on mma.sync
// m16n8k8 in TF32 with the 3xTF32 split (`split`): x = hi + lo, hi = x
// rounded to TF32 (nearest, ties away from zero), lo = x - hi, and c +=
// lo_a hi_b + hi_a lo_b + hi_a hi_b (lo_a lo_b, ~2^-22 of the product, is
// left out), every sum in f32. One TF32 product alone keeps ~11 bits of each
// operand: ~1e-3 off the f32 chain, several times the f32 limits; the split
// is as close to the float64 chain as f32 itself
// (tests/test_torch_chain_tiles_f32.py).
//
// A warp owns a 16-row slab of one residue x all 128 columns: 16 n8
// accumulator tiles, 64 f32 registers a lane. Rows at or past K (K not a
// multiple of 16) load zeros and store nothing.
//   * An operand in the accumulator layout is the next product's A operand
//     where it lies: k8 step kk of the next product is accumulator tile kk,
//     its k position t4 the tile's column 2 t4 and t4 + 4 its column
//     2 t4 + 1 (`a_split`). E is loaded in that layout too (8-byte loads),
//     so E, gelu(pre), h2 and, in K7, e2 feed their products alike.
//   * The weights are staged once per block in shared memory in that k
//     order, already in fragment order (`stage_frag`): one 16-byte load a
//     lane gives the B fragments of two n8 tiles at one k8 step, 64 KB a
//     weight without padding and without bank conflicts. Their split is
//     made at fragment load, in registers: three f32 weights fill 192 KB of
//     the 227 KB, so a split copy (twice the bytes) does not fit.
//   * The first product's columns are in chain_mma.cuh's unit order (its
//     column n is hidden unit unit(n)), so A[l] + Gn[idx], the accumulators'
//     preset, is read as 16-byte loads; W_e's columns and W2's rows are
//     staged in that order.
#pragma once

#include "chain_common.cuh"
#include "chain_mma.cuh"

namespace chain_tf32 {

using chain::H;
using chain_mma::gelu_exp;
using chain_mma::reduce_rows;
using chain_mma::unit;

constexpr int TW = 8;             // warps a block
constexpr int TNT = 32 * TW;
constexpr int WFLOATS = H * H;    // one staged weight (fragment order, 64 KB)
constexpr int TRES = TW;          // residues a K1 / K7 tile: one a warp
constexpr int SS = H + 8;         // row stride (floats) of the residue sums: no bank conflicts

// x = hi + lo: hi is x rounded to TF32 as cvt.rna.tf32.f32 rounds every
// finite or infinite x (nearest, ties away from zero), here by an integer add
// on the bits (2 operations; the cvt instruction takes 4 and an FSETP on this
// card: a 3xTF32 loop ran at 42% of the TF32 peak with the add, at 34% with
// cvt, PERF.md); lo = x - hi is exact and goes to the tensor core as it is,
// which reads its top 19 bits (lo truncated to TF32: as close to the f32
// product as lo rounded, within the f32 sums' own error). A NaN x gives a NaN
// lo (the add may carry a NaN's bits to 0 or inf in hi), an infinite x too:
// non-finite in, non-finite out.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c[16 x 8] += a[16 x 8] b[8 x 8], TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small products first; a given split, b (b0, b1:
// k positions t4 and t4 + 4 of column g) split here
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma_tf32(c, alo, h0, h1);
  mma_tf32(c, ahi, l0, l1);
  mma_tf32(c, ahi, h0, h1);
}

// the A fragment of a k8 step from an accumulator tile c (rows g and g + 8,
// columns 2 t4 and 2 t4 + 1): a0 (g, t4) = c0, a1 (g + 8, t4) = c2,
// a2 (g, t4 + 4) = c1, a3 (g + 8, t4 + 4) = c3
__device__ __forceinline__ void a_split(const float (&c)[4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

// The k row of k8 step kk at position p (t4 or t4 + 4) of an operand in the
// accumulator layout: 8 kk + 2 (p & 3) + (p >> 2)
__device__ __forceinline__ int k_row(int kk, int p) { return 8 * kk + 2 * (p & 3) + (p >> 2); }

// W [H][H] (in, out) into sW in fragment order: float4 slot (kk, np, lane)
// holds W[r0][c0], W[r1][c0], W[r0][c1], W[r1][c1] with r0, r1 the k rows
// of k8 step kk at positions t4, t4 + 4 and c0 = 16 np + g, c1 = c0 + 8 (the
// B fragments of n tiles 2 np and 2 np + 1); ROW_UNIT / COL_UNIT: rows /
// columns through unit(). Every thread of the block; plain loads.
template <bool ROW_UNIT, bool COL_UNIT>
__device__ __forceinline__ void stage_frag(float* sW, const float* __restrict__ W) {
  float4* d = reinterpret_cast<float4*>(sW);
  for (int i = threadIdx.x; i < WFLOATS / 4; i += TNT) {
    const int lane = i & 31, np = (i >> 5) & 7, kk = i >> 8;
    const int g = lane >> 2, t4 = lane & 3;
    int r0 = k_row(kk, t4), r1 = k_row(kk, t4 + 4), c0 = 16 * np + g, c1 = c0 + 8;
    if (ROW_UNIT) {
      r0 = unit(r0);
      r1 = unit(r1);
    }
    if (COL_UNIT) {
      c0 = unit(c0);
      c1 = unit(c1);
    }
    d[i] = make_float4(__ldg(W + r0 * H + c0), __ldg(W + r1 * H + c0), __ldg(W + r0 * H + c1),
                       __ldg(W + r1 * H + c1));
  }
}

// dst[0:H] = src[0:H] (plain loads; visible after the next barrier)
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src) {
  for (int i = threadIdx.x; i < H; i += TNT) dst[i] = src[i];
}

// One 16-row slab: rows k0 .. k0 + 15 of residue l of sample b, nrow of
// them edges (the rest padding); this lane's rows are g and g + 8.
struct Slab {
  int b, l, nrow, lane;
  size_t row0;  // edge row of k0 in [B L K]
};

__device__ __forceinline__ Slab make_slab(int b, int l, int q, int L, int K, int lane) {
  Slab s;
  s.b = b;
  s.l = l;
  s.lane = lane;
  s.nrow = min(16, K - 16 * q);
  s.row0 = ((size_t)b * L + l) * K + 16 * q;
  return s;
}

// x = the slab's rows of X ([rows, H] f32) in the accumulator layout: x[kk]
// holds rows g, g + 8 at columns 8 kk + 2 t4 and + 1 (8-byte loads), zeros
// past nrow. X may be written earlier in the same kernel by this lane (K7's
// e2): plain loads.
__device__ __forceinline__ void load_rows(float (&x)[16][4], const float* X, const Slab& s) {
  const int g = s.lane >> 2, t4 = s.lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (g + 8 * h < s.nrow) {
      const float2* p = reinterpret_cast<const float2*>(X + (s.row0 + g + 8 * h) * H + 2 * t4);
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        const float2 v = p[4 * kk];
        x[kk][2 * h] = v.x;
        x[kk][2 * h + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) x[kk][2 * h] = x[kk][2 * h + 1] = 0.0f;
    }
  }
}

// acc = A[l] + Gn[idx] of the slab's rows at the first product's columns
// (lane t4's 32 columns are units 32 t4 .. 32 t4 + 31: 16-byte loads), zeros
// past nrow; the index clamped into Gn
__device__ __forceinline__ void preset(float (&acc)[16][4], const float* __restrict__ A,
                                       const float* __restrict__ Gn,
                                       const int* __restrict__ idx, int L, int N,
                                       const Slab& s) {
  const int g = s.lane >> 2, t4 = s.lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r < s.nrow) {
      const int j = min(max(__ldg(idx + s.row0 + r), 0), N - 1);
      const float4* ap = reinterpret_cast<const float4*>(A + ((size_t)s.b * L + s.l) * H + 32 * t4);
      const float4* gp = reinterpret_cast<const float4*>(Gn + ((size_t)s.b * N + j) * H + 32 * t4);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 a = __ldg(ap + q), gv = __ldg(gp + q);
        acc[2 * q][2 * h] = a.x + gv.x;
        acc[2 * q][2 * h + 1] = a.y + gv.y;
        acc[2 * q + 1][2 * h] = a.z + gv.z;
        acc[2 * q + 1][2 * h + 1] = a.w + gv.w;
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) acc[nt][2 * h] = acc[nt][2 * h + 1] = 0.0f;
    }
  }
}

// acc += x W: x the slab's rows in the accumulator layout (x[kk] the A
// fragment of k8 step kk), W staged by stage_frag in sW
__device__ __forceinline__ void mma_slab(float (&acc)[16][4], const float (&x)[16][4],
                                         const float* sW, int lane) {
  const float4* w = reinterpret_cast<const float4*>(sW) + lane;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    uint32_t hi[4], lo[4];
    a_split(x[kk], hi, lo);
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      const float4 v = w[(kk * 8 + np) * 32];
      mma3(acc[2 * np], hi, lo, v.x, v.y);
      mma3(acc[2 * np + 1], hi, lo, v.z, v.w);
    }
  }
}

// x2 = gelu(A[l] + Gn[idx] + E W_e) W2 of the slab's rows (natural
// columns), e their E rows (load_rows); sWe holds W_e
// (stage_frag<false, true>), sW2 W2 (stage_frag<true, false>)
__device__ __forceinline__ void chain_x2(float (&x2)[16][4], const float (&e)[16][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ Gn,
                                         const int* __restrict__ idx, const float* sWe,
                                         const float* sW2, int L, int N, const Slab& s) {
  float acc[16][4];
  preset(acc, A, Gn, idx, L, N, s);
  mma_slab(acc, e, sWe, s.lane);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = gelu_exp(acc[nt][j]);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) x2[nt][0] = x2[nt][1] = x2[nt][2] = x2[nt][3] = 0.0f;
  mma_slab(x2, acc, sW2, s.lane);
}

// ---------------------------------------------------------------------------
// K2 (and K7's edge half): one slab

// out = g (LN(E + msg + b3) (1 + sc) + sh) of the slab's rows at the
// accumulator positions (acc = msg), f32; e the slab's E rows as load_rows
// gave them to the first product (the accumulator layout: e[nt] lies where
// acc[nt] does; kept in registers rather than read again); the
// LayerNorm's sums as message_chain.cu's bf16 lnmod_out takes them (a lane's
// columns in order, then the quad by two shuffles). sb3 in shared memory,
// sh, sc, g the sample's [H] rows.
__device__ __forceinline__ void lnmod_out(float (&acc)[16][4], const float (&e)[16][4],
                                          const float* sb3,
                                          const float* __restrict__ sh,
                                          const float* __restrict__ sc,
                                          const float* __restrict__ gate, float* out,
                                          const Slab& s) {
  const int g = s.lane >> 2, t4 = s.lane & 3;
  float mean[2] = {0.0f, 0.0f}, rstd[2] = {0.0f, 0.0f};
  {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      const float2 bias = *reinterpret_cast<const float2*>(sb3 + 8 * nt + 2 * t4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[nt][2 * h] = e[nt][2 * h] + (acc[nt][2 * h] + bias.x);
        acc[nt][2 * h + 1] = e[nt][2 * h + 1] + (acc[nt][2 * h + 1] + bias.y);
        mean[h] += acc[nt][2 * h];
        mean[h] += acc[nt][2 * h + 1];
      }
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
  const float2* sh2 = reinterpret_cast<const float2*>(sh + (size_t)s.b * H + 2 * t4);
  const float2* sc2 = reinterpret_cast<const float2*>(sc + (size_t)s.b * H + 2 * t4);
  const float2* g2 = reinterpret_cast<const float2*>(gate + (size_t)s.b * H + 2 * t4);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float2 shv = __ldg(sh2 + 4 * nt), scv = __ldg(sc2 + 4 * nt), gv = __ldg(g2 + 4 * nt);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (g + 8 * h < s.nrow) {
        const float o0 = gv.x * (((acc[nt][2 * h] - mean[h]) * rstd[h]) * (1.0f + scv.x) + shv.x);
        const float o1 =
            gv.y * (((acc[nt][2 * h + 1] - mean[h]) * rstd[h]) * (1.0f + scv.y) + shv.y);
        *reinterpret_cast<float2*>(out + (s.row0 + g + 8 * h) * H + 8 * nt + 2 * t4) =
            make_float2(o0, o1);
      }
    }
  }
}

// K2's chain of one slab: E's rows, x2, h2 = gelu(x2 + b2) in place (the A
// operand of the W3 product), msg = h2 W3, then lnmod_out with those E rows. sWe, sW2 as chain_x2, sW3
// W3 (stage_frag<false, false>); sb2, sb3 in shared memory.
__device__ __forceinline__ void edge_slab(const float* E, const float* __restrict__ A,
                                          const float* __restrict__ Gn,
                                          const int* __restrict__ idx, const float* sWe,
                                          const float* sW2, const float* sW3, const float* sb2,
                                          const float* sb3, const float* __restrict__ sh,
                                          const float* __restrict__ sc,
                                          const float* __restrict__ gate, float* out, int L,
                                          int N, const Slab& s) {
  const int t4 = s.lane & 3;
  float e[16][4], h2[16][4];
  load_rows(e, E, s);
  chain_x2(h2, e, A, Gn, idx, sWe, sW2, L, N, s);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float2 bias = *reinterpret_cast<const float2*>(sb2 + 8 * nt + 2 * t4);
    h2[nt][0] = gelu_exp(h2[nt][0] + bias.x);
    h2[nt][1] = gelu_exp(h2[nt][1] + bias.y);
    h2[nt][2] = gelu_exp(h2[nt][2] + bias.x);
    h2[nt][3] = gelu_exp(h2[nt][3] + bias.y);
  }
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  mma_slab(acc, h2, sW3, s.lane);
  lnmod_out(acc, e, sb3, sh, sc, gate, out, s);
}

// ---------------------------------------------------------------------------
// K1 (and K7's node half): a tile of TRES residues of one sample, one a warp

// K1's chain of residue l of sample b, every lane of the warp: each of its
// ceil(K / 16) slabs, in order, gives mask * gelu(x2 + b2) of rows g and
// g + 8 summed over the slab's 16 rows by the butterfly of reduce_rows; the
// slabs' sums are added in slab order (a run repeats bit for bit). The sums
// go to row `srow` (shared, natural columns), the mask count to *smsum. A
// residue at or past L gives zeros.
__device__ __forceinline__ void residue_sum(float* srow, float* smsum, const float* E,
                                            const float* __restrict__ A,
                                            const float* __restrict__ Gn,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ mask, const float* sWe,
                                            const float* sW2, const float* sb2, int b, int l,
                                            int L, int K, int N, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ms = 0.0f;
  if (l < L) {
    for (int q = 0; 16 * q < K; ++q) {
      const Slab s = make_slab(b, l, q, L, K, lane);
      float x2[16][4];
      {
        float e[16][4];
        load_rows(e, E, s);
        chain_x2(x2, e, A, Gn, idx, sWe, sW2, L, N, s);
      }
      const float m0 = g < s.nrow ? __ldg(mask + s.row0 + g) : 0.0f;
      const float m8 = g + 8 < s.nrow ? __ldg(mask + s.row0 + g + 8) : 0.0f;
      // part[2 nt + e]: column 8 nt + 2 t4 + e
      float part[32];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const float2 bias = *reinterpret_cast<const float2*>(sb2 + 8 * nt + 2 * t4);
        part[2 * nt] = m0 * gelu_exp(x2[nt][0] + bias.x) + m8 * gelu_exp(x2[nt][2] + bias.x);
        part[2 * nt + 1] =
            m0 * gelu_exp(x2[nt][1] + bias.y) + m8 * gelu_exp(x2[nt][3] + bias.y);
      }
      reduce_rows(part, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] += part[i];
      float m = m0 + m8;  // the slab's mask count: the 8 lanes of a t4
      m += __shfl_xor_sync(0xffffffffu, m, 4);
      m += __shfl_xor_sync(0xffffffffu, m, 8);
      m += __shfl_xor_sync(0xffffffffu, m, 16);
      ms += m;
    }
  }
  // r[i]: the sum of part[i + 4 o], o = 4 b0 + 2 b1 + b2 (g's bits), i.e.
  // columns 8 (2 o + (i >> 1)) + 2 t4 + (i & 1)
  const int o = 4 * (g & 1) + 2 * ((g >> 1) & 1) + (g >> 2);
  *reinterpret_cast<float2*>(srow + 16 * o + 2 * t4) = make_float2(r[0], r[1]);
  *reinterpret_cast<float2*>(srow + 16 * o + 8 + 2 * t4) = make_float2(r[2], r[3]);
  if (lane == 0) *smsum = ms;
}

// out[b, l0 + n] = (s_n W3 + msum_n b3) / scale for the tile's residues n <
// TRES, columns 16 w .. 16 w + 15 by warp w, as out^T = W3^T s^T on the
// tensor cores: W3 staged by stage_frag<false, false> holds W3^T's A
// fragments (m tile w = n pair w: a = v.x, v.z, v.y, v.w), the residues'
// sums (ssum rows, stride SS) are the B operand, residue n its column n.
// Residues at or past L are not written.
__device__ __forceinline__ void residue_out(const float* ssum, const float* smsum,
                                            const float* sW3, const float* sb3,
                                            float* __restrict__ out, int b, int l0, int L,
                                            float scale, int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float4* w = reinterpret_cast<const float4*>(sW3) + warp * 32 + lane;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const float4 v = w[kk * 8 * 32];
    uint32_t hi[4], lo[4];
    split(v.x, hi[0], lo[0]);
    split(v.z, hi[1], lo[1]);
    split(v.y, hi[2], lo[2]);
    split(v.w, hi[3], lo[3]);
    const float2 sv = *reinterpret_cast<const float2*>(ssum + g * SS + 8 * kk + 2 * t4);
    mma3(c, hi, lo, sv.x, sv.y);
  }
  // c0, c1: column 16 w + g of residues 2 t4, 2 t4 + 1; c2, c3: column + 8
  const int col = 16 * warp + g;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int n = 2 * t4 + e;
    if (l0 + n < L) {
      float* o = out + ((size_t)b * L + l0 + n) * H + col;
      o[0] = (c[e] + smsum[n] * sb3[col]) / scale;
      o[8] = (c[2 + e] + smsum[n] * sb3[col + 8]) / scale;
    }
  }
}

}  // namespace chain_tf32
