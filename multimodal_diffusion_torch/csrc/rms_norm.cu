// RMSNorm of the MMDiT core for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel. The JAX package writes its `RMSNorm`
// (multimodal_diffusion_tpu/models/mmdit.py) in plain jnp and leaves it to
// XLA, which fuses the whole formula into one pass over each row. Eager
// PyTorch ran the same formula as ten launches (upcast, square, mean,
// +1e-12, sqrt, weight cast, product, +eps, division, downcast), each a pass
// over the row in fp32; this kernel is that one pass.
//
// Function, for each row x of x [B, N, d] (unit stride along d, any batch and
// row strides) and a weight w [d]:
//   ms  = (sum_j x_j * x_j) / d          fp32: each square rounded, then summed
//   s   = sqrt(ms + 1e-12) + eps         IEEE square root, eps outside the root
//   out = (w_j * x_j) / s                IEEE division, the product first
// written in the output dtype (round to nearest even). This is the formula of
// the plain version in ops/rms_norm.py term for term: no fast-math, no rsqrt,
// no contraction of a product and a sum into one FMA (the __f*_rn
// intrinsics). Only the order of the sum differs: s may differ from the
// plain version's by an ulp of fp32, which moves a bf16 or fp16 output by at
// most one ulp of its dtype and an fp32 output by at most two (one of s and
// one of the quotient's rounding). A row of zeros gives exact zeros
// (s = 1e-6 + eps > 0).
//
// Bound on an H100 SXM (3.35 TB/s): at the flagship sampler's [16, 421, 1024]
// bf16 the call reads 13.8 MB and writes 13.8 MB, 8.2 us; its 6.9 M
// divisions are far below the card's arithmetic rate. It is bound by bytes,
// and the least it can move is each element read once and written once,
// which a row held in registers gives:
//   * one warp a row, 4 rows a block (128 threads). A lane loads 8 elements
//     at a time (16 bytes of bf16 or fp16, 32 of fp32), lanes on neighbouring
//     vectors, so a warp's loads are whole 512-byte runs. The row stays in
//     the lanes' registers (NV vectors a lane, NV = 1, 2, 4 or 8 by d: up to
//     d = 2048 in registers) between the sum and the output; a longer row
//     reads its remainder from L2 a second time.
//   * the sum of squares is each lane's sequential sum, then a butterfly of
//     xor shuffles: every lane ends with the same bits, and every call adds
//     in the same order, so repeats are bit-identical (no atomics).
//   * the weight (2 or 4 KB) is read by every warp and stays in L1 and L2.
//   * the output is a new contiguous [B, N, d] buffer, written 8 elements a
//     lane. Base pointers and batch and row strides must be multiples of 16
//     bytes, and d a multiple of 8 (the wrapper checks).
// Launched on the caller's stream; allocates nothing; does not synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows a block
constexpr int kVec = 8;    // elements a lane loads at a time

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __half* p, float (&v)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __half22float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(__half* p, const float (&v)[kVec]) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) h[k] = __floats2half2_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float add_squares(float ss, const float (&v)[kVec]) {
#pragma unroll
  for (int k = 0; k < kVec; ++k) ss = __fadd_rn(ss, __fmul_rn(v[k], v[k]));
  return ss;
}

// out[j8 .. j8 + 8) of a row = (w * x) / s. The weight's and the output's
// dtypes are arguments (a branch every warp takes the same way), so the
// library holds a kernel for each input dtype and NV only.
__device__ __forceinline__ void scale_store(const void* w, bool w_bf16, int j8,
                                            const float (&x)[kVec], float s, void* out,
                                            int out_dtype) {
  float wv[kVec], o[kVec];
  if (w_bf16) {
    load8(static_cast<const __nv_bfloat16*>(w) + j8, wv);
  } else {
    load8(static_cast<const float*>(w) + j8, wv);
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) o[k] = __fdiv_rn(__fmul_rn(wv[k], x[k]), s);
  if (out_dtype == 1) {
    store8(static_cast<__nv_bfloat16*>(out) + j8, o);
  } else if (out_dtype == 2) {
    store8(static_cast<__half*>(out) + j8, o);
  } else {
    store8(static_cast<float*>(out) + j8, o);
  }
}

template <typename TIn, int NV>
__global__ void __launch_bounds__(kWarps * 32)
rms_norm_kernel(const TIn* __restrict__ x, const void* __restrict__ w, void* __restrict__ out,
                long long rows, long long n, long long sb, long long sn, int d, bool w_bf16,
                int out_dtype, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: a row is one warp's
  const TIn* xr = x + (row / n) * sb + (row % n) * sn;
  const int elem = out_dtype == 0 ? 4 : 2;
  void* orow = static_cast<char*>(out) + row * d * elem;
  const int nvec = d / kVec;

  float v[NV][kVec];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) {
      load8(xr + j * kVec, v[i]);
      ss = add_squares(ss, v[i]);
    }
  }
  for (int j = lane + 32 * NV; j < nvec; j += 32) {  // past what the registers hold
    float t[kVec];
    load8(xr + j * kVec, t);
    ss = add_squares(ss, t);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float s = __fadd_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(ss, static_cast<float>(d)), 1e-12f)),
                            eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + 32 * i;
    if (j < nvec) scale_store(w, w_bf16, j * kVec, v[i], s, orow, out_dtype);
  }
  for (int j = lane + 32 * NV; j < nvec; j += 32) {
    float t[kVec];
    load8(xr + j * kVec, t);
    scale_store(w, w_bf16, j * kVec, t, s, orow, out_dtype);
  }
}

template <typename TIn>
cudaError_t launch(const void* x, const void* w, void* out, long long B, long long N, int d,
                   long long sb, long long sn, bool w_bf16, int out_dtype, float eps,
                   cudaStream_t stream) {
  const long long rows = B * N;
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps)), block(kWarps * 32);
  const TIn* xi = static_cast<const TIn*>(x);
  const int per_lane = (d / kVec + 31) / 32;
  if (per_lane <= 1) {
    rms_norm_kernel<TIn, 1><<<grid, block, 0, stream>>>(xi, w, out, rows, N, sb, sn, d, w_bf16,
                                                         out_dtype, eps);
  } else if (per_lane <= 2) {
    rms_norm_kernel<TIn, 2><<<grid, block, 0, stream>>>(xi, w, out, rows, N, sb, sn, d, w_bf16,
                                                         out_dtype, eps);
  } else if (per_lane <= 4) {
    rms_norm_kernel<TIn, 4><<<grid, block, 0, stream>>>(xi, w, out, rows, N, sb, sn, d, w_bf16,
                                                         out_dtype, eps);
  } else {
    rms_norm_kernel<TIn, 8><<<grid, block, 0, stream>>>(xi, w, out, rows, N, sb, sn, d, w_bf16,
                                                         out_dtype, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// out [B, N, d] contiguous = RMSNorm(x) with x's element (b, n, j) at
// x + b * sb + n * sn + j. dtype codes: 0 fp32, 1 bf16, 2 fp16 (the weight:
// 0 or 1). Returns the cudaError_t of the launch (0 = success).
extern "C" int rms_norm(const void* x, const void* w, void* out, int device, long long B,
                        long long N, int d, long long sb, long long sn, int x_dtype,
                        int w_dtype, int out_dtype, float eps, void* stream) {
  if (B <= 0 || N <= 0 || d <= 0 || d % kVec != 0 || w_dtype < 0 || w_dtype > 1
      || out_dtype < 0 || out_dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w_bf16 = w_dtype == 1;
  switch (x_dtype) {
    case 0: return (int)launch<float>(x, w, out, B, N, d, sb, sn, w_bf16, out_dtype, eps, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, w, out, B, N, d, sb, sn, w_bf16, out_dtype, eps, s);
    case 2: return (int)launch<__half>(x, w, out, B, N, d, sb, sn, w_bf16, out_dtype, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
