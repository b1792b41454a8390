// Fused tensor product (K10) for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel of codlad_tpu/kernels/tp_kernels.py:
//   K10 fused_tp_* <- _tp_fwd_kernel / _pallas_fused_tp
//
// Per row (an edge, or an atom slot of the dense cross graph):
//   xcat[b*din + f] = cast(x[f] * sh[b])                         (b < dsh)
//   TR[r]  = sum over CBIG_R column r's nonzeros of coef * xcat[row]   (f32)
//   out[c] = cast(sum over the r of output column c of cast(w[widx[r]] * TR[r]))
// which is TR = xcat CBIG_R, wR = w EXPW, out = (wR * TR) SUMR with the
// Pallas kernel's rounding: CBIG_R's coefficients and x * sh[b] in the
// payload dtype (the wrapper rounds the coefficients), TR and wR in f32, their
// product cast to the payload dtype, the output summed in f32 and cast.
//
// Design. The TPU keeps the three dense tables resident per block; at layer 2
// CBIG_R alone is 324 x 672 (871 KB in f32), more than a Hopper block's shared
// memory. EXPW and SUMR are 0/1 selections (one nonzero per column of EXPW and
// per row of SUMR), and CBIG_R holds 2-15 nonzeros a column. So the kernel
// reads the tables as lists (kernels/tp_kernels.py `sparse_tables`): the R
// expansion columns grouped by output column (cptr), each with its weight
// column (widx) and its nonzeros (rptr, rows, coef). A block of 256 threads
// owns TE = 32 rows: it stages xcat [TE][dsh*din] and w [TE][numel] in
// shared memory as f32 (row strides odd, so the lanes' reads hit distinct
// banks), then each warp takes output columns c = warp, warp + 8, ... with
// one row a lane; the table reads are the same address across the warp.
// The outputs go through shared memory to coalesced stores.
//
// Bound: each row reads din + dsh + numel and writes dout elements, and the
// nonzero form does dsh*din + 2*nnz + 2*R operations; at the Stage-1 bench
// shape (4 x 65536 directed atom edges; layer 2: din 36, numel 384, dout 48,
// R 672, nnz 4032) the w rows are most of the bytes, so the floor is set by
// memory. chip_smoke.py computes it from the run's inputs.

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
constexpr int NW = NT / 32;
constexpr int TE = 32;  // rows per block, one a lane

template <typename T>
__global__ void __launch_bounds__(NT)
fused_tp_kernel(const T* __restrict__ x, const T* __restrict__ sh, const T* __restrict__ w,
                const int* __restrict__ cptr, const int* __restrict__ widx,
                const int* __restrict__ rptr, const int* __restrict__ rows,
                const float* __restrict__ coef, T* __restrict__ out, long long M, int din,
                int dsh, int numel, int dout) {
  using Nm = Num<T>;
  extern __shared__ float smem[];
  const int KX = dsh * din;
  const int XS = KX | 1, WS = numel | 1, OS = dout | 1;  // odd row strides
  float* sx = smem;             // [TE][XS] cast(x * sh[b])
  float* sw = sx + TE * XS;     // [TE][WS] w
  float* so = sw + TE * WS;     // [TE][OS] out
  const long long e0 = (long long)blockIdx.x * TE;
  const int ne = M - e0 < TE ? (int)(M - e0) : TE;
  const int tid = threadIdx.x;

  for (int i = tid; i < TE * KX; i += NT) {
    const int e = i / KX, j = i - e * KX;
    const int b = j / din, f = j - b * din;
    float v = 0.0f;
    if (e < ne) v = Nm::round(Nm::f(x[(e0 + e) * din + f]) * Nm::f(sh[(e0 + e) * dsh + b]));
    sx[e * XS + j] = v;
  }
  for (int i = tid; i < TE * numel; i += NT) {
    const int e = i / numel, k = i - e * numel;
    sw[e * WS + k] = e < ne ? Nm::f(w[(e0 + e) * numel + k]) : 0.0f;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const float* xr = sx + lane * XS;
  const float* wr = sw + lane * WS;
  for (int c = warp; c < dout; c += NW) {
    float acc = 0.0f;
    for (int q = cptr[c]; q < cptr[c + 1]; ++q) {
      float tr = 0.0f;
      for (int z = rptr[q]; z < rptr[q + 1]; ++z) tr = fmaf(coef[z], xr[rows[z]], tr);
      acc += Nm::round(wr[widx[q]] * tr);
    }
    so[lane * OS + c] = acc;
  }
  __syncthreads();
  for (int i = tid; i < ne * dout; i += NT) {
    const int e = i / dout, c = i - e * dout;
    out[e0 * dout + i] = Nm::cast(so[e * OS + c]);
  }
}

template <typename T>
int launch(const void* x, const void* sh, const void* w, const void* cptr, const void* widx,
           const void* rptr, const void* rows, const void* coef, void* out, long long M,
           int din, int dsh, int numel, int dout, void* stream) {
  if (M <= 0 || din <= 0 || dsh <= 0 || numel <= 0 || dout <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TE * (((dsh * din) | 1) + (numel | 1) + (dout | 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_tp_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (M + TE - 1) / TE;
  fused_tp_kernel<T><<<(unsigned)blocks, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(sh), static_cast<const T*>(w),
      static_cast<const int*>(cptr), static_cast<const int*>(widx),
      static_cast<const int*>(rptr), static_cast<const int*>(rows),
      static_cast<const float*>(coef), static_cast<T*>(out), M, din, dsh, numel, dout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, din], sh [M, dsh], w [M, numel] -> out [M, dout]; tables from
// kernels/tp_kernels.py `sparse_tables` (coef already rounded to the payload
// dtype, as f32)
int fused_tp_f32(const void* x, const void* sh, const void* w, const void* cptr,
                 const void* widx, const void* rptr, const void* rows, const void* coef,
                 void* out, long long M, int din, int dsh, int numel, int dout,
                 void* stream) {
  return launch<float>(x, sh, w, cptr, widx, rptr, rows, coef, out, M, din, dsh, numel,
                       dout, stream);
}

int fused_tp_bf16(const void* x, const void* sh, const void* w, const void* cptr,
                  const void* widx, const void* rptr, const void* rows, const void* coef,
                  void* out, long long M, int din, int dsh, int numel, int dout,
                  void* stream) {
  return launch<__nv_bfloat16>(x, sh, w, cptr, widx, rptr, rows, coef, out, M, din, dsh,
                               numel, dout, stream);
}

}  // extern "C"
