// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels replace the TPU kernels of
// multimodal_diffusion_tpu/ops/flash_attention.py (launched by
// `_flash_backward`):
//   flash_bwd_dkdv_kernel  <- `_flash_bwd_dkdv_kernel`: one block owns a K/V
//                             tile and walks every Q tile;
//   flash_bwd_dq_kernel    <- `_flash_bwd_dq_kernel`: one block owns a Q tile
//                             and walks every K/V tile.
// Both recompute, for every (query row i, key j) of a (batch, head),
//   s_ij  = scale * q_i . k_j                       (fp32 accumulation)
//   p_ij  = ok_ij ? exp(s_ij - lse_i) : 0           (a select, never an exp
//                                                    expected to underflow)
//   dp_ij = dO_i . v_j                              (fp32)
//   ds_ij = p_ij * (dp_ij - D_i)
// and accumulate in fp32
//   dV_j += round_dO(p_ij) dO_i,  dK_j += round_q(ds_ij) q_i,
//   dQ_i += round_q(ds_ij) k_j,
// applying `scale` once to dK and dQ at the end. round_x(.) rounds to the
// dtype of x (bf16 or fp32), as the TPU kernel's `p.astype(do.dtype)` and
// `ds.astype(q.dtype)`. ok_ij is false for a masked key (the optional [B, N]
// byte mask, 1 = attendable), for key and query indices past N (the ragged
// edge is masked here: no host padding). A row whose keys are all masked has
// lse = -1e30 (the forward's sentinel), so exp(s - lse) is inf; the select
// keeps every one of its grads exactly 0. lse [B, H, N] and
// D = rowsum(dO * O) [B, H, N] are inputs, fp32 and contiguous, computed by
// the caller: a ring attention hands in global ones.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s fp32
// without tensor cores) at the mvp training shape [8, 8, 133, 64] bf16, where
// one [B, H, N, Dh] tensor is 1.09 MB:
//   dK/dV reads q, dO, k, v, lse, D and writes dk, dv: 6.6 MB, 2.0 us;
//         4 products x 2*B*H*N^2*Dh = 0.58 GFLOP, 0.59 us: bound by bytes.
//   dQ    reads q, dO, k, v, lse, D and writes dq: 5.5 MB, 1.6 us;
//         3 products = 0.43 GFLOP, 0.44 us: bound by bytes.
// These kernels do their products on the fp32 FMA units from shared memory,
// not the tensor cores, so they stay far above that bound: the first aim is
// kernels that are right (see PERF.md for their measured times).
//
// Design (simple first; mma.sync / wgmma / TMA are later work):
//   * each output element has one owner block, so there are no atomics and
//     the result is the same from run to run;
//   * tiles are staged through shared memory as fp32 with row strides padded
//     by one word, so the column walks below hit distinct banks;
//   * thread (rg, cg) = (tid / 8, tid % 8) owns a few rows of the block's
//     own tile and the columns cg, cg + 8, ... of the other operand: the
//     score products are register-tiled FMA loops, P and dS go through
//     shared memory to the accumulation loops;
//   * inputs and outputs are [B, H, N, Dh] with any batch/head/row strides
//     and unit stride along Dh, so q, k, v can be head views of a fused qkv
//     projection and dO a view of a [B, N, H, Dh] buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int COL_GROUPS = 8;
constexpr int ROW_GROUPS = THREADS / COL_GROUPS;  // 16

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  const uint8_t* valid;
  void* dq;
  void* dk;
  void* dv;
  int H, N;
  // element strides (batch, head, row) of q, k, v, dout, dq, dk, dv
  long long q_s[3], k_s[3], v_s[3], do_s[3], dq_s[3], dk_s[3], dv_s[3];
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the value a product in T's precision sees
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, const long long* s, int b, int h) {
  return static_cast<const T*>(base) + b * s[0] + h * s[1];
}

template <typename T>
__device__ __forceinline__ T* head_ptr_mut(void* base, const long long* s, int b, int h) {
  return static_cast<T*>(base) + b * s[0] + h * s[1];
}

// rows [r0, r0 + R) of a [N, D] head (row stride `sn`) into a padded fp32
// tile, zeros past N
template <typename T, int R, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long sn, int r0, int N,
                                          int tid) {
  constexpr int S = D + 1;
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, c = i - (i / D) * D;
    const int n = r0 + r;
    dst[r * S + c] = n < N ? to_f32(src[n * sn + c]) : 0.f;
  }
}

__device__ __forceinline__ bool key_ok(const Params& p, int b, int n) {
  return n < p.N && (p.valid == nullptr || p.valid[(long long)b * p.N + n] != 0);
}

// ---------------------------------------------------------------------------
// dK / dV: one block per (batch*head, K/V tile)
// ---------------------------------------------------------------------------

template <int D>
struct KVTile {
  static constexpr int BN = D >= 128 ? 32 : 64;  // keys owned by a block
  static constexpr int BM = D >= 128 ? 32 : 64;  // query rows per step of the walk
  static constexpr int KR = BN / ROW_GROUPS;     // key rows per thread
  static constexpr int QC = BM / COL_GROUPS;     // query columns per thread
  static constexpr int DC = D / COL_GROUPS;      // dk/dv columns per thread
  static constexpr int S = D + 1;                // padded row stride of K, V, Q, dO
  static constexpr int PS = BM + 1;              // padded row stride of P^T, dS^T
  static constexpr int SMEM_FLOATS = 2 * BN * S + 2 * BM * S + 2 * BN * PS + 3 * BM + BN;
  static constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(const Params p) {
  using TL = KVTile<D>;
  constexpr int BN = TL::BN, BM = TL::BM, KR = TL::KR, QC = TL::QC, DC = TL::DC;
  constexpr int S = TL::S, PS = TL::PS;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BN * S;
  float* sQ = sV + BN * S;
  float* sdO = sQ + BM * S;
  float* sP = sdO + BM * S;   // P^T [key][query], rounded to dO's dtype
  float* sdS = sP + BN * PS;  // dS^T [key][query], rounded to q's dtype
  float* sL = sdS + BN * PS;  // lse of the Q tile's rows
  float* sDl = sL + BM;       // D of the Q tile's rows
  float* sOkQ = sDl + BM;     // 1 where the query row exists
  float* sOkK = sOkQ + BM;    // 1 where the key exists and is attendable

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int rg = tid / COL_GROUPS;
  const int cg = tid % COL_GROUPS;
  const int N = p.N;

  const T* q = head_ptr<T>(p.q, p.q_s, b, h);
  const T* k = head_ptr<T>(p.k, p.k_s, b, h);
  const T* v = head_ptr<T>(p.v, p.v_s, b, h);
  const T* dout = head_ptr<T>(p.dout, p.do_s, b, h);
  const float* lse = p.lse + (long long)bh * N;
  const float* delta = p.delta + (long long)bh * N;

  load_rows<T, BN, D>(sK, k, p.k_s[2], n0, N, tid);
  load_rows<T, BN, D>(sV, v, p.v_s[2], n0, N, tid);
  if (tid < BN) sOkK[tid] = key_ok(p, b, n0 + tid) ? 1.f : 0.f;

  float dk[KR][DC], dv[KR][DC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int m0 = 0; m0 < N; m0 += BM) {
    __syncthreads();  // the previous step's readers of sQ, sdO, sP, sdS are done
    load_rows<T, BM, D>(sQ, q, p.q_s[2], m0, N, tid);
    load_rows<T, BM, D>(sdO, dout, p.do_s[2], m0, N, tid);
    if (tid < BM) {
      const int m = m0 + tid;
      const bool in = m < N;
      sL[tid] = in ? lse[m] : 0.f;
      sDl[tid] = in ? delta[m] : 0.f;
      sOkQ[tid] = in ? 1.f : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for key rows rg*KR + i, query columns
    // cg + 8*j
    float s[KR][QC], dp[KR][QC];
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < QC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[KR], vv[KR], qv[QC], ov[QC];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        kv[i] = sK[(rg * KR + i) * S + d];
        vv[i] = sV[(rg * KR + i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        qv[j] = sQ[(cg + COL_GROUPS * j) * S + d];
        ov[j] = sdO[(cg + COL_GROUPS * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < KR; ++i)
#pragma unroll
        for (int j = 0; j < QC; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const int kr = rg * KR + i;
      const bool okk = sOkK[kr] > 0.5f;
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        const int qc = cg + COL_GROUPS * j;
        const bool ok = okk && sOkQ[qc] > 0.5f;
        const float pij = ok ? expf(s[i][j] * p.scale - sL[qc]) : 0.f;
        const float dsij = ok ? pij * (dp[i][j] - sDl[qc]) : 0.f;
        sP[kr * PS + qc] = round_to<T>(pij);
        sdS[kr * PS + qc] = round_to<T>(dsij);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the query rows of this tile that exist
    const int n_rows = min(BM, N - m0);
    for (int r = 0; r < n_rows; ++r) {
      float pv[KR], sv[KR];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        pv[i] = sP[(rg * KR + i) * PS + r];
        sv[i] = sdS[(rg * KR + i) * PS + r];
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float ov = sdO[r * S + cg + COL_GROUPS * j];
        const float qv = sQ[r * S + cg + COL_GROUPS * j];
#pragma unroll
        for (int i = 0; i < KR; ++i) {
          dv[i][j] = fmaf(pv[i], ov, dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv, dk[i][j]);
        }
      }
    }
  }

  T* dk_out = head_ptr_mut<T>(p.dk, p.dk_s, b, h);
  T* dv_out = head_ptr_mut<T>(p.dv, p.dv_s, b, h);
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int n = n0 + rg * KR + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = cg + COL_GROUPS * j;
      dk_out[n * p.dk_s[2] + c] = from_f32<T>(dk[i][j] * p.scale);
      dv_out[n * p.dv_s[2] + c] = from_f32<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (batch*head, Q tile)
// ---------------------------------------------------------------------------

template <int D>
struct QTile {
  static constexpr int BM = 64;                  // query rows owned by a block
  static constexpr int BN = D >= 128 ? 32 : 64;  // keys per step of the walk
  static constexpr int QR = BM / ROW_GROUPS;     // query rows per thread
  static constexpr int KC = BN / COL_GROUPS;     // key columns per thread
  static constexpr int DC = D / COL_GROUPS;      // dq columns per thread
  static constexpr int S = D + 1;
  static constexpr int PS = BN + 1;
  static constexpr int SMEM_FLOATS = 2 * BM * S + 2 * BN * S + BM * PS + 2 * BM + BN;
  static constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Params p) {
  using TL = QTile<D>;
  constexpr int BM = TL::BM, BN = TL::BN, QR = TL::QR, KC = TL::KC, DC = TL::DC;
  constexpr int S = TL::S, PS = TL::PS;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BM * S;
  float* sK = sdO + BM * S;
  float* sV = sK + BN * S;
  float* sdS = sV + BN * S;  // dS [query][key], rounded to q's dtype
  float* sL = sdS + BM * PS;
  float* sDl = sL + BM;
  float* sOkK = sDl + BM;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int rg = tid / COL_GROUPS;
  const int cg = tid % COL_GROUPS;
  const int N = p.N;

  const T* q = head_ptr<T>(p.q, p.q_s, b, h);
  const T* k = head_ptr<T>(p.k, p.k_s, b, h);
  const T* v = head_ptr<T>(p.v, p.v_s, b, h);
  const T* dout = head_ptr<T>(p.dout, p.do_s, b, h);
  const float* lse = p.lse + (long long)bh * N;
  const float* delta = p.delta + (long long)bh * N;

  load_rows<T, BM, D>(sQ, q, p.q_s[2], m0, N, tid);
  load_rows<T, BM, D>(sdO, dout, p.do_s[2], m0, N, tid);
  if (tid < BM) {
    const int m = m0 + tid;
    const bool in = m < N;
    sL[tid] = in ? lse[m] : 0.f;
    sDl[tid] = in ? delta[m] : 0.f;
  }

  float dq[QR][DC];
#pragma unroll
  for (int i = 0; i < QR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dq[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += BN) {
    __syncthreads();  // the previous step's readers of sK, sV, sdS are done
    load_rows<T, BN, D>(sK, k, p.k_s[2], n0, N, tid);
    load_rows<T, BN, D>(sV, v, p.v_s[2], n0, N, tid);
    if (tid < BN) sOkK[tid] = key_ok(p, b, n0 + tid) ? 1.f : 0.f;
    __syncthreads();

    // S = Q K^T and dP = dO V^T for query rows rg*QR + i, key columns cg + 8*j
    float s[QR][KC], dp[QR][KC];
#pragma unroll
    for (int i = 0; i < QR; ++i)
#pragma unroll
      for (int j = 0; j < KC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[QR], ov[QR], kv[KC], vv[KC];
#pragma unroll
      for (int i = 0; i < QR; ++i) {
        qv[i] = sQ[(rg * QR + i) * S + d];
        ov[i] = sdO[(rg * QR + i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        kv[j] = sK[(cg + COL_GROUPS * j) * S + d];
        vv[j] = sV[(cg + COL_GROUPS * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < QR; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < QR; ++i) {
      const int qr = rg * QR + i;
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int kc = cg + COL_GROUPS * j;
        const bool ok = sOkK[kc] > 0.5f;
        const float pij = ok ? expf(s[i][j] * p.scale - sL[qr]) : 0.f;
        const float dsij = ok ? pij * (dp[i][j] - sDl[qr]) : 0.f;
        sdS[qr * PS + kc] = round_to<T>(dsij);
      }
    }
    __syncthreads();

    // dQ += dS K over the keys of this tile that exist
    const int n_cols = min(BN, N - n0);
    for (int c = 0; c < n_cols; ++c) {
      float sv[QR];
#pragma unroll
      for (int i = 0; i < QR; ++i) sv[i] = sdS[(rg * QR + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float kk = sK[c * S + cg + COL_GROUPS * j];
#pragma unroll
        for (int i = 0; i < QR; ++i) dq[i][j] = fmaf(sv[i], kk, dq[i][j]);
      }
    }
  }

  T* dq_out = head_ptr_mut<T>(p.dq, p.dq_s, b, h);
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int m = m0 + rg * QR + i;
    if (m >= N) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq_out[m * p.dq_s[2] + cg + COL_GROUPS * j] = from_f32<T>(dq[i][j] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_dkdv(const Params& p, int BH, cudaStream_t stream) {
  using TL = KVTile<D>;
  auto kernel = flash_bwd_dkdv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TL::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.N + TL::BN - 1) / TL::BN);
  kernel<<<grid, THREADS, TL::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, int BH, cudaStream_t stream) {
  using TL = QTile<D>;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TL::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.N + TL::BM - 1) / TL::BM);
  kernel<<<grid, THREADS, TL::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int BH, int D, bool dq, cudaStream_t stream) {
  switch (D) {
    case 32: return dq ? launch_dq<T, 32>(p, BH, stream) : launch_dkdv<T, 32>(p, BH, stream);
    case 64: return dq ? launch_dq<T, 64>(p, BH, stream) : launch_dkdv<T, 64>(p, BH, stream);
    case 128: return dq ? launch_dq<T, 128>(p, BH, stream) : launch_dkdv<T, 128>(p, BH, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dq, const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* valid, void* dq_out, void* dk_out,
        void* dv_out, int device, int B, int H, int N, int D, int dtype,
        const long long* strides, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.valid = static_cast<const uint8_t*>(valid);
  p.dq = dq_out;
  p.dk = dk_out;
  p.dv = dv_out;
  p.H = H;
  p.N = N;
  long long* dst[7] = {p.q_s, p.k_s, p.v_s, p.do_s, p.dq_s, p.dk_s, p.dv_s};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.scale = scale;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, B * H, D, dq, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, B * H, D, dq, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `strides` holds 21 element strides:
// (batch, head, row) of q, k, v, dout, dq, dk, dv in that order (the
// kernel that does not write an output ignores its strides and pointer).
// lse and delta are contiguous fp32 [B, H, N]; valid is an optional
// contiguous [B, N] byte mask. `device` is the CUDA ordinal the tensors
// live on. Each returns the cudaError_t of its launch (0 = success).
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* valid,
                              void* dk, void* dv, int device, int B, int H, int N, int D,
                              int dtype, const long long* strides, float scale, void* stream) {
  return run(false, q, k, v, dout, lse, delta, valid, nullptr, dk, dv, device, B, H, N, D,
             dtype, strides, scale, stream);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* valid, void* dq,
                            int device, int B, int H, int N, int D, int dtype,
                            const long long* strides, float scale, void* stream) {
  return run(true, q, k, v, dout, lse, delta, valid, dq, nullptr, nullptr, device, B, H, N, D,
             dtype, strides, scale, stream);
}
