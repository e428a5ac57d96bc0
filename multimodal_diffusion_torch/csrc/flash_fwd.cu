// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_fwd_kernel` in
// multimodal_diffusion_tpu/ops/flash_attention.py (launched by
// `_flash_forward`). Same function: for every (batch, head, query row),
//   s_j   = scale * q . k_j                  (fp32 accumulation)
//   s_j   = -1e30 where key j is masked      (finite sentinel, not -inf)
//   out   = sum_j p_j v_j / max(sum_j p_j, 1e-30),  p_j = exp(s_j - m)
//   lse   = m + log(max(sum_j p_j, 1e-30))   (fp32, the backward residual)
// computed with the online (running max / running sum) softmax, so a masked
// key contributes exactly 0 and a row whose keys are all masked gives 0.
// For bf16 inputs p is rounded to bf16 before the PV product, as the TPU
// kernel does (`p.astype(v.dtype)`); the sum of p stays fp32.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s fp32
// without tensor cores): at the mvp sampling shape [16, 8, 133, 64] bf16 the
// call must move ~8.8 MB (q, k, v, out, lse), 2.6 us, against 0.58 GFLOP
// (4*B*H*N^2*Dh), 0.6 us: it is bound by bytes. The flagship
// [8, 8, 421, 128] bf16 shape is bound by bytes too (8.2 us vs 5.9 us), the
// t2i [2, 4, 1152, 128] shape by operations (5.3 us vs 2.8 us), and every
// fp32 shape by operations. This kernel does its products on the fp32 FMA
// units, not the tensor cores, so it stays far above the bf16 bound: the
// first aim is a kernel that is right (see PERF.md for its measured times).
//
// Design (simple first; wgmma/TMA are later work):
//   * grid = (B*H, ceil(N / 64)); a block of 128 threads owns 64 query rows
//     and walks all K/V tiles in a loop (the TPU's sequential grid axis
//     becomes this loop; nothing carries over between blocks).
//   * Q, K, V tiles are staged through shared memory as fp32; the K/V tile is
//     64 keys for Dh <= 64 and 32 keys for Dh = 128, so three blocks fit on
//     an SM. Row strides are padded by one word so the column walks below
//     hit distinct banks.
//   * thread (rg, cg) = (tid / 8, tid % 8) owns query rows 4*rg .. 4*rg+3 and
//     the key columns / output columns cg, cg+8, ...: S and PV are register-
//     tiled FMA loops, the row max and row sum are reduced over the 8 lanes
//     of a row group with warp shuffles, and P goes through shared memory to
//     the PV loop.
//   * the ragged edge (N not a multiple of the tile) is masked in the
//     kernel: no host padding. The optional key-validity mask is one byte per
//     key, [B, N] (1 = attendable), shared by all heads.
//   * inputs are [B, H, N, Dh] with any batch/head/row strides and unit
//     stride along Dh; the output takes strides too, so the caller can hand
//     in a [B, N, H, Dh] buffer and skip a transpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;
constexpr int THREADS = 128;
constexpr int COL_GROUPS = 8;
constexpr int ROWS_PER_THREAD = 4;
constexpr float NEG_SENTINEL = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* valid;
  void* out;
  float* lse;
  int H, N;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
struct Tile {
  static constexpr int BN = D >= 128 ? 32 : 64;  // keys per K/V tile
  static constexpr int NJ = BN / COL_GROUPS;      // score columns per thread
  static constexpr int DJ = D / COL_GROUPS;       // output columns per thread
  static constexpr int QS = D + 1;                // padded row strides (floats)
  static constexpr int KS = D + 1;
  static constexpr int VS = D;
  static constexpr int PS = BN + 1;
  static constexpr int SMEM_FLOATS = BLOCK_M * QS + BN * KS + BN * VS + BLOCK_M * PS + BN;
  static constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  using TL = Tile<D>;
  constexpr int BN = TL::BN;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BLOCK_M * TL::QS;
  float* sV = sK + BN * TL::KS;
  float* sP = sV + BN * TL::VS;
  float* sOk = sP + BLOCK_M * TL::PS;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.y * BLOCK_M;
  const int tid = threadIdx.x;
  const int rg = tid / COL_GROUPS;
  const int cg = tid % COL_GROUPS;
  const int N = p.N;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < BLOCK_M * D; i += THREADS) {
    const int r = i / D, c = i - (i / D) * D;
    const int n = m0 + r;
    sQ[r * TL::QS + c] = n < N ? to_f32(q[n * p.q_sn + c]) : 0.f;
  }

  float m_run[ROWS_PER_THREAD], l_run[ROWS_PER_THREAD];
  float acc[ROWS_PER_THREAD][TL::DJ];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    m_run[i] = NEG_SENTINEL;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TL::DJ; ++j) acc[i][j] = 0.f;
  }

  for (int n0 = 0; n0 < N; n0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BN * D; i += THREADS) {
      const int r = i / D, c = i - (i / D) * D;
      const int n = n0 + r;
      const bool in = n < N;
      sK[r * TL::KS + c] = in ? to_f32(k[n * p.k_sn + c]) : 0.f;
      sV[r * TL::VS + c] = in ? to_f32(v[n * p.v_sn + c]) : 0.f;
    }
    if (tid < BN) {
      const int n = n0 + tid;
      const bool ok = n < N && (p.valid == nullptr || p.valid[(long long)b * N + n] != 0);
      sOk[tid] = ok ? 1.f : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 rows x NJ columns
    float s[ROWS_PER_THREAD][TL::NJ];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
      for (int j = 0; j < TL::NJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[ROWS_PER_THREAD], kv[TL::NJ];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) qv[i] = sQ[(rg * ROWS_PER_THREAD + i) * TL::QS + d];
#pragma unroll
      for (int j = 0; j < TL::NJ; ++j) kv[j] = sK[(cg + COL_GROUPS * j) * TL::KS + d];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
        for (int j = 0; j < TL::NJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    bool ok[TL::NJ];
#pragma unroll
    for (int j = 0; j < TL::NJ; ++j) ok[j] = sOk[cg + COL_GROUPS * j] > 0.5f;

#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      float mt = NEG_SENTINEL;
#pragma unroll
      for (int j = 0; j < TL::NJ; ++j) {
        s[i][j] = ok[j] ? s[i][j] * p.scale : NEG_SENTINEL;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < COL_GROUPS; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m_run[i], mt);
      const float alpha = expf(m_run[i] - m_new);
      float rs = 0.f;
      float* prow = sP + (rg * ROWS_PER_THREAD + i) * TL::PS;
#pragma unroll
      for (int j = 0; j < TL::NJ; ++j) {
        const float pij = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += pij;
        prow[cg + COL_GROUPS * j] = to_f32(from_f32<T>(pij));
      }
#pragma unroll
      for (int off = 1; off < COL_GROUPS; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_run[i] = l_run[i] * alpha + rs;
      m_run[i] = m_new;
#pragma unroll
      for (int j = 0; j < TL::DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P V over the keys of this tile that exist
    const int n_cols = min(BN, N - n0);
    for (int c = 0; c < n_cols; ++c) {
      float pv[ROWS_PER_THREAD];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) pv[i] = sP[(rg * ROWS_PER_THREAD + i) * TL::PS + c];
#pragma unroll
      for (int j = 0; j < TL::DJ; ++j) {
        const float vv = sV[c * TL::VS + cg + COL_GROUPS * j];
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int n = m0 + rg * ROWS_PER_THREAD + i;
    if (n >= N) continue;
    const float l_safe = fmaxf(l_run[i], 1e-30f);
    T* o = static_cast<T*>(p.out) + b * p.o_sb + h * p.o_sh + n * p.o_sn;
#pragma unroll
    for (int j = 0; j < TL::DJ; ++j) o[cg + COL_GROUPS * j] = from_f32<T>(acc[i][j] / l_safe);
    if (cg == 0) p.lse[(long long)bh * N + n] = m_run[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int BH, cudaStream_t stream) {
  using TL = Tile<D>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TL::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.N + BLOCK_M - 1) / BLOCK_M);
  kernel<<<grid, THREADS, TL::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const Params& p, int BH, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(p, BH, stream);
    case 64: return launch<T, 64>(p, BH, stream);
    case 128: return launch<T, 128>(p, BH, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `device` is the
// CUDA ordinal the tensors live on (this library's runtime keeps its own
// current device). Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* valid,
                         void* out, void* lse, int device, int B, int H, int N, int D,
                         int dtype,
                         long long q_sb, long long q_sh, long long q_sn,
                         long long k_sb, long long k_sh, long long k_sn,
                         long long v_sb, long long v_sh, long long v_sn,
                         long long o_sb, long long o_sh, long long o_sn,
                         float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.valid = static_cast<const uint8_t*>(valid);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.N = N;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.scale = scale;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_dh<float>(p, B * H, D, s);
  if (dtype == 1) return (int)dispatch_dh<__nv_bfloat16>(p, B * H, D, s);
  return (int)cudaErrorInvalidValue;
}
