// FLUX.1's QK RMSNorm, RoPE and bf16 rounding of q and k for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces no TPU kernel. The JAX package has no FLUX.1; this is the chain of
// models/flux.py that eager PyTorch ran as about 14 launches a tensor (the
// fp32 upcast of a permuted bf16 view, square, mean, +1e-6, rsqrt, two
// products, the pair unbind, four products, a difference, a sum, the stack
// and the bf16 cast), each a pass over the tensor in fp32. This kernel is
// one pass: q and k read once in bf16 and written once in bf16.
//
// Function, for each (token, head) row x of q, and likewise of k, with
// Dh = 128, the row's scale w [128] and its token's tables cos, sin [64]:
//   ms = (sum_j x_j * x_j) * (1 / 128)   fp32: each square rounded, then summed
//   r  = rsqrtf(ms + 1e-6)               the rsqrt PyTorch's CUDA kernel calls
//   y  = (x * r) * w                     two rounded products, in that order
//   (y0, y1) of each adjacent pair -> (cos y0 - sin y1, sin y0 + cos y1)
//   one rounding to bf16 (round to nearest even)
// This is RMSNorm.forward, apply_rope and the cast of models/flux.py term for
// term: no fast-math, no contraction of a product and a sum into one FMA (the
// __f*_rn intrinsics). Only the order of the sum of squares differs, so r may
// differ from the plain chain's by an ulp of fp32: an output moves by at most
// one bf16 ulp, or, where a pair's rotation cancels, by a few fp32 ulps of its
// terms. A row of zeros gives exact zeros (r = 1000).
//
// Input: the stream's qkv projection [B, n, 3, H, Dh] in bf16, read in place:
// element (b, t, c, h, j) at qkv + b * sb + t * sn + (c H + h) Dh + j, any
// batch and row strides (a single block's qkv is the first 3 d columns of
// linear1's output, rows 21504 elements apart). Output: q and k as
// [B, H, N_total, Dh] bf16 buffers, the layout the flash forward reads fastest
// (each head's rows one contiguous run), the stream's rows written at
// offset .. offset + n of every head, its tables' rows taken from the same
// place: a double block's txt and img streams go into one joint buffer by two
// launches, in place of the concatenation.
//
// Bound on an H100 SXM (3.35 TB/s): at a single block's [1, 4608, 24, 128]
// the call reads 56.6 MB of q and k and 2.4 MB of tables and writes 56.6 MB,
// 34.5 us; its 28 M products are far below the card's arithmetic rate. It is bound by bytes,
// and the least it can move is each element read once and written once:
//   * one warp a (token, head): lanes 0-15 hold q's row, lanes 16-31 k's, 8
//     elements a lane, one 16-byte load and one 16-byte store; the row stays
//     in registers from the sum to the store. 8 warps a block.
//   * the sum of squares is each lane's sequential sum of its 8, then xor
//     shuffles within the half-warp: every lane ends with the same bits and
//     every call adds in the same order, so repeats are bit-identical (no
//     atomics).
//   * a pair (y_2i, y_2i+1) lies inside a lane's 8 elements: the rotation
//     needs no exchange between lanes. A lane reads its 4 cos and 4 sin as
//     one 16-byte load each; the token's 512 bytes of tables serve its 48
//     rows from L1 and L2, as do the bf16 scales (256 bytes).
//   * base pointers and the batch and row strides must be multiples of 16
//     bytes (the wrapper checks).
// Launched on the caller's stream; allocates nothing; does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDh = 128;     // the head dim
constexpr int kVec = 8;      // elements a lane holds: a half-warp a row
constexpr int kWarps = 8;    // (token, head) rows a block

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

__global__ void __launch_bounds__(kWarps * 32)
qk_norm_rope_kernel(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ q_scale,
                    const __nv_bfloat16* __restrict__ k_scale, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ q_out,
                    __nv_bfloat16* __restrict__ k_out, long long rows, long long n, int H,
                    long long sb, long long sn, long long offset, long long n_total) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp: a row is one warp's
  const int lane = threadIdx.x & 31;
  const int is_k = lane >> 4;                   // lanes 16-31: k
  const int e = (lane & 15) * kVec;             // the lane's first element of the row
  const int h = static_cast<int>(row % H);
  const long long bt = row / H;
  const long long b = bt / n, t = bt % n;

  float x[kVec], w[kVec];
  load8(qkv + b * sb + t * sn + static_cast<long long>(is_k * H + h) * kDh + e, x);
  load8((is_k ? k_scale : q_scale) + e, w);
  const long long pos = offset + t;  // the token's row of the tables and the outputs
  const float4 c4 = __ldg(reinterpret_cast<const float4*>(cos_t + pos * (kDh / 2) + e / 2));
  const float4 s4 = __ldg(reinterpret_cast<const float4*>(sin_t + pos * (kDh / 2) + e / 2));

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kVec; ++k) ss = __fadd_rn(ss, __fmul_rn(x[k], x[k]));
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / kDh), 1e-6f));

  const float c[kVec / 2] = {c4.x, c4.y, c4.z, c4.w};
  const float s[kVec / 2] = {s4.x, s4.y, s4.z, s4.w};
  uint4 u;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float y0 = __fmul_rn(__fmul_rn(x[2 * k], r), w[2 * k]);
    const float y1 = __fmul_rn(__fmul_rn(x[2 * k + 1], r), w[2 * k + 1]);
    o[k] = __floats2bfloat162_rn(__fsub_rn(__fmul_rn(c[k], y0), __fmul_rn(s[k], y1)),
                                 __fadd_rn(__fmul_rn(s[k], y0), __fmul_rn(c[k], y1)));
  }
  __nv_bfloat16* out = is_k ? k_out : q_out;
  *reinterpret_cast<uint4*>(out + ((b * H + h) * n_total + pos) * kDh + e) = u;
}

}  // namespace

// q_out, k_out [B, H, n_total, 128] contiguous bf16, rows offset .. offset + n
// = RMSNorm, RoPE and bf16 rounding of q and k of qkv, whose element
// (b, t, c, h, j) is at qkv + b * sb + t * sn + (c H + h) 128 + j; cos and sin
// [n_total, 64] fp32 contiguous; the scales [128] bf16, as FLUX.1 is served.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int qk_norm_rope(const void* qkv, const void* q_scale, const void* k_scale,
                            const float* cos_t, const float* sin_t, void* q_out, void* k_out,
                            int device, long long B, long long n, int H, long long sb,
                            long long sn, long long offset, long long n_total, void* stream) {
  if (B <= 0 || n <= 0 || H <= 0 || offset < 0 || offset + n > n_total) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long rows = B * n * H;
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps)), block(kWarps * 32);
  qk_norm_rope_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(q_scale),
      static_cast<const __nv_bfloat16*>(k_scale), cos_t, sin_t,
      static_cast<__nv_bfloat16*>(q_out), static_cast<__nv_bfloat16*>(k_out), rows, n, H, sb, sn,
      offset, n_total);
  return (int)cudaGetLastError();
}
