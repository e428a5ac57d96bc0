// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels replace the TPU kernels of
// multimodal_diffusion_tpu/ops/flash_attention.py (launched by
// `_flash_backward`):
//   flash_bwd_dkdv  <- `_flash_bwd_dkdv_kernel`: one block owns a K/V tile and
//                      walks every Q tile;
//   flash_bwd_dq    <- `_flash_bwd_dq_kernel`: one block owns a Q tile and
//                      walks every K/V tile.
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
// the caller: a ring attention hands in global ones. Each output element has
// one owner block and a fixed order of summation, so there are no atomics and
// the result is the same from run to run.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s fp32
// without tensor cores) at the mvp training shape [8, 8, 133, 64] bf16, where
// one [B, H, N, Dh] tensor is 1.09 MB:
//   dK/dV reads q, dO, k, v, lse, D and writes dk, dv: 6.6 MB, 2.0 us;
//         4 products x 2*B*H*N^2*Dh = 0.58 GFLOP, 0.59 us: bound by bytes.
//   dQ    reads q, dO, k, v, lse, D and writes dq: 5.5 MB, 1.6 us;
//         3 products = 0.43 GFLOP, 0.44 us: bound by bytes.
// At the flagship shape [8, 8, 421, 128] the two are 12.4 and 10.4 us, by
// bytes still; a head's operands are small enough to stay in L2 however often
// the blocks of a head re-read them, so what the design has to keep low is
// the time per product and the latency of each step of the walk (PERF.md has
// the measured times).
//
// bf16 design (`*_wgmma_kernel`, with csrc/flash_common.cuh): a block is one
// warpgroup that owns 64 rows (keys for dK/dV, query rows for dQ) and walks
// the other operand 64 rows at a time.
//   * Every product is a `wgmma.mma_async` with fp32 accumulators. The scores
//     (S^T = K Q^T and dP^T = V dO^T for dK/dV; S = Q K^T and dP = dO V^T for
//     dQ) read both operands from shared memory. They come out in the
//     orientation whose accumulator is the A operand of the next product, so
//     P and dS are rounded to bf16 in registers and fed straight back as
//     register-A fragments of dV += P^T dO, dK += dS^T Q and dQ += dS K: they
//     never touch shared or device memory. dO, Q and K enter those products
//     with their rows as the contraction dim, as transposed B operands read
//     from the same tiles (no second copy, no transposing pass).
//   * `mma.sync.m16n8k16` with 16-row warp tiles (8 % of waste at N = 133
//     where a 64-row tile wastes 44 %) was built first and was right. With the
//     same copies, selects and write-out it took 22.1 us for the pair at mvp
//     training where this design takes 19.8, and 124 us against 77 at the
//     flagship shape (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py; PERF.md):
//     each of its warps re-reads the same fragments of the walked tile from
//     shared memory, which wgmma reads once per warpgroup.
//   * Tiles are bf16 in shared memory in wgmma's swizzled layout, filled by
//     16-byte `cp.async` with zero fill past N (nothing undefined reaches a
//     contraction dim), two stages for the walked operand: the next tile's
//     copy runs under this tile's products. Base pointers and batch/head/row
//     strides must be multiples of 16 bytes (the wrapper checks).
//   * The exp and the masking between the products are straight-line code:
//     the mask is applied as a bitwise select (`select_bits`), which turns the
//     inf of a fully masked row into 0 as a select does and cannot be compiled
//     into a branch per element.
//   * The grads leave through plain tiles in the same shared memory, each row
//     as one contiguous 16-byte-per-lane run.
//   * 64 own rows per block give 192 blocks at mvp training (64 heads, N =
//     133) and 144 at t2i (8 heads, N = 1152) on 132 SMs, two resident per SM
//     at Dh 128 (98 KB of shared memory, at most 231 registers) and more below.
// fp32 keeps the FMA kernels below (`flash_bwd_dkdv_kernel`,
// `flash_bwd_dq_kernel`): tensor cores take fp32 only as TF32, about three
// decimal digits, which the 1e-4 tolerance forbids. They stage fp32 tiles in
// shared memory with rows padded by one word; thread (rg, cg) =
// (tid / 8, tid % 8) owns a few rows of the block's own tile and the columns
// cg, cg + 8, ... of the other operand, and P and dS go through shared memory
// to the accumulation loops.
// Inputs and outputs of both are [B, H, N, Dh] with any batch/head/row
// strides and unit stride along Dh, so q, k, v can be head views of a fused
// qkv projection and dO a view of a [B, N, H, Dh] buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

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
template <int R, int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long sn, int r0, int N,
                                          int tid) {
  constexpr int S = D + 1;
  for (int i = tid; i < R * D; i += THREADS) {
    const int r = i / D, c = i - (i / D) * D;
    const int n = r0 + r;
    dst[r * S + c] = n < N ? src[n * sn + c] : 0.f;
  }
}

__device__ __forceinline__ bool key_ok(const Params& p, int b, int n) {
  return n < p.N && (p.valid == nullptr || p.valid[(long long)b * p.N + n] != 0);
}

// ---------------------------------------------------------------------------
// fp32 on the FMA units. dK / dV: one block per (batch*head, K/V tile)
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

template <int D>
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

  const float* q = head_ptr<float>(p.q, p.q_s, b, h);
  const float* k = head_ptr<float>(p.k, p.k_s, b, h);
  const float* v = head_ptr<float>(p.v, p.v_s, b, h);
  const float* dout = head_ptr<float>(p.dout, p.do_s, b, h);
  const float* lse = p.lse + (long long)bh * N;
  const float* delta = p.delta + (long long)bh * N;

  load_rows<BN, D>(sK, k, p.k_s[2], n0, N, tid);
  load_rows<BN, D>(sV, v, p.v_s[2], n0, N, tid);
  if (tid < BN) sOkK[tid] = key_ok(p, b, n0 + tid) ? 1.f : 0.f;

  float dk[KR][DC], dv[KR][DC];
#pragma unroll
  for (int i = 0; i < KR; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int m0 = 0; m0 < N; m0 += BM) {
    __syncthreads();  // the previous step's readers of sQ, sdO, sP, sdS are done
    load_rows<BM, D>(sQ, q, p.q_s[2], m0, N, tid);
    load_rows<BM, D>(sdO, dout, p.do_s[2], m0, N, tid);
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
        sP[kr * PS + qc] = pij;
        sdS[kr * PS + qc] = dsij;
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

  float* dk_out = head_ptr_mut<float>(p.dk, p.dk_s, b, h);
  float* dv_out = head_ptr_mut<float>(p.dv, p.dv_s, b, h);
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int n = n0 + rg * KR + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int c = cg + COL_GROUPS * j;
      dk_out[n * p.dk_s[2] + c] = dk[i][j] * p.scale;
      dv_out[n * p.dv_s[2] + c] = dv[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 on the FMA units. dQ: one block per (batch*head, Q tile)
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

template <int D>
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

  const float* q = head_ptr<float>(p.q, p.q_s, b, h);
  const float* k = head_ptr<float>(p.k, p.k_s, b, h);
  const float* v = head_ptr<float>(p.v, p.v_s, b, h);
  const float* dout = head_ptr<float>(p.dout, p.do_s, b, h);
  const float* lse = p.lse + (long long)bh * N;
  const float* delta = p.delta + (long long)bh * N;

  load_rows<BM, D>(sQ, q, p.q_s[2], m0, N, tid);
  load_rows<BM, D>(sdO, dout, p.do_s[2], m0, N, tid);
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
    load_rows<BN, D>(sK, k, p.k_s[2], n0, N, tid);
    load_rows<BN, D>(sV, v, p.v_s[2], n0, N, tid);
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
        sdS[qr * PS + kc] = dsij;
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

  float* dq_out = head_ptr_mut<float>(p.dq, p.dq_s, b, h);
#pragma unroll
  for (int i = 0; i < QR; ++i) {
    const int m = m0 + rg * QR + i;
    if (m >= N) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq_out[m * p.dq_s[2] + cg + COL_GROUPS * j] = dq[i][j] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D, bool DQ>
struct WgTile {
  static constexpr int OWN = 64;  // rows of the block's own tile: the M of one wgmma
  static constexpr int WALK = 64;  // rows of the other operand per stage: the N of the scores
  static constexpr int KS = D / 16;  // k16 steps over the head dim
  static constexpr int OWN_BYTES = OWN * D * 2;
  static constexpr int WALK_BYTES = WALK * D * 2;
  // two own tiles, two walked operands x two stages
  static constexpr int TILES_BYTES = 2 * OWN_BYTES + 4 * WALK_BYTES;
  // after the tiles: lse and D of the walked rows (dK/dV), or the walked
  // keys' mask bytes (dQ), two stages each
  static constexpr int STATS_BYTES = DQ ? 2 * WALK : 4 * WALK * (int)sizeof(float);
  // 1024 bytes of slack to start the tiles on a swizzle boundary
  static constexpr size_t SMEM_BYTES = 1024 + TILES_BYTES + STATS_BYTES;
  static_assert((DQ ? 1 : 2) * flash::OutTile<D>::BYTES <= TILES_BYTES,
                "the grads leave through the tiles' memory");
};

// dK / dV: one warpgroup per (batch*head, 64 keys); it walks every query
template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_wgmma_kernel(const Params p) {
  using namespace flash;
  using TL = WgTile<D, false>;
  using L = Swizzled<D>;
  constexpr int OWN = TL::OWN, WALK = TL::WALK, KS = TL::KS;
  extern __shared__ unsigned char smem_wgmma[];
  unsigned char* smem = align_1024(smem_wgmma);
  const uint32_t sK = smem_addr(smem);
  const uint32_t sV = sK + TL::OWN_BYTES;
  const uint32_t sQ = sV + TL::OWN_BYTES;        // 2 stages
  const uint32_t sdO = sQ + 2 * TL::WALK_BYTES;  // 2 stages
  float* sL = reinterpret_cast<float*>(smem + TL::TILES_BYTES);  // lse, 2 stages
  float* sDl = sL + 2 * WALK;                                    // D, 2 stages

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int n0 = blockIdx.y * OWN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int N = p.N;

  const bf16* q = head_ptr<bf16>(p.q, p.q_s, b, h);
  const bf16* k = head_ptr<bf16>(p.k, p.k_s, b, h);
  const bf16* v = head_ptr<bf16>(p.v, p.v_s, b, h);
  const bf16* dout = head_ptr<bf16>(p.dout, p.do_s, b, h);
  const float* lse = p.lse + (long long)bh * N;
  const float* delta = p.delta + (long long)bh * N;

  // one commit group per stage of the walk (the first takes K and V along)
  auto load_walk = [&](int t) {
    const int st = t & 1, m0 = t * WALK;
    load_tile_async<WALK, D, THREADS>(sQ + st * TL::WALK_BYTES, q, p.q_s[2], m0, N, tid);
    load_tile_async<WALK, D, THREADS>(sdO + st * TL::WALK_BYTES, dout, p.do_s[2], m0, N, tid);
    load_row_stats_async(sL + st * WALK, lse, m0, N, WALK, tid, 0);
    load_row_stats_async(sDl + st * WALK, delta, m0, N, WALK, tid, WALK);
    cp_async_commit();
  };

  load_tile_async<OWN, D, THREADS>(sK, k, p.k_s[2], n0, N, tid);
  load_tile_async<OWN, D, THREADS>(sV, v, p.v_s[2], n0, N, tid);
  load_walk(0);

  // the thread's two key rows of every accumulator: 16 warp + g and + 8
  const int keep_lo = key_ok(p, b, n0 + 16 * warp + g) ? -1 : 0;
  const int keep_hi = key_ok(p, b, n0 + 16 * warp + g + 8) ? -1 : 0;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  const int n_tiles = (N + WALK - 1) / WALK;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_walk(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_proxy();
    __syncthreads();
    const int st = t & 1, m0 = t * WALK;
    const uint32_t tQ = sQ + st * TL::WALK_BYTES;
    const uint32_t tdO = sdO + st * TL::WALK_BYTES;
    const float* tL = sL + st * WALK;
    const float* tDl = sDl + st * WALK;

    // S^T = K Q^T and dP^T = V dO^T: [64 keys][WALK queries]
    float s[WALK / 2], dp[WALK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, L::template desc_k_major<OWN>(sK, kk), L::template desc_k_major<WALK>(tQ, kk),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(dp, L::template desc_k_major<OWN>(sV, kk),
               L::template desc_k_major<WALK>(tdO, kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    wgmma_pin(s);
    wgmma_pin(dp);

    // P^T and dS^T in place: register 4 j + e is key row g + 8 (e / 2) of the
    // warp's 16, query column 8 j + 2 tq + e % 2
#pragma unroll
    for (int j = 0; j < WALK / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float2 l2 = *reinterpret_cast<const float2*>(tL + col);
      const float2 d2 = *reinterpret_cast<const float2*>(tDl + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int keep = ((e & 2) ? keep_hi : keep_lo) & (m0 + col + (e & 1) < N ? -1 : 0);
        const float le = (e & 1) ? l2.y : l2.x;
        const float de = (e & 1) ? d2.y : d2.x;
        const float pij = select_bits(__expf(s[4 * j + e] * p.scale - le), keep);
        s[4 * j + e] = pij;
        dp[4 * j + e] = select_bits(pij * (dp[4 * j + e] - de), keep);
      }
    }
    uint32_t pa[WALK / 16][4], da[WALK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WALK / 16; ++kk) {
      acc_to_a(pa[kk], &s[8 * kk]);   // rounds P to bf16 (dO's dtype)
      acc_to_a(da[kk], &dp[8 * kk]);  // rounds dS to bf16 (q's dtype)
    }
    // dV += P^T dO and dK += dS^T Q: the queries are the contraction dim,
    // dO and Q enter as transposed B operands from the same tiles
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WALK / 16; ++kk) {
      wgmma_rs(dv, pa[kk], L::template desc_mn_major<WALK>(tdO, kk));
      wgmma_rs(dk, da[kk], L::template desc_mn_major<WALK>(tQ, kk));
    }
    wgmma_commit();
    wgmma_wait();
    __syncthreads();  // this stage is refilled by the next step's prefetch
  }
  wgmma_pin(dk);
  wgmma_pin(dv);

  // every tile is free now: dk and dv leave through plain tiles at the start
  // of the block's memory, each warp its own 16 rows, a whole row at a time
  bf16* out_dk = reinterpret_cast<bf16*>(smem);
  bf16* out_dv = out_dk + 64 * OutTile<D>::LD;
  store_acc_to_tile<D>(out_dk, dk, p.scale, warp, lane);
  store_acc_to_tile<D>(out_dv, dv, 1.f, warp, lane);
  __syncwarp();
  copy_rows_out<D>(head_ptr_mut<bf16>(p.dk, p.dk_s, b, h), p.dk_s[2], out_dk, warp,
                   n0 + 16 * warp, N, lane);
  copy_rows_out<D>(head_ptr_mut<bf16>(p.dv, p.dv_s, b, h), p.dv_s[2], out_dv, warp,
                   n0 + 16 * warp, N, lane);
}

// dQ: one warpgroup per (batch*head, 64 query rows); it walks every key
template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_wgmma_kernel(const Params p) {
  using namespace flash;
  using TL = WgTile<D, true>;
  using L = Swizzled<D>;
  constexpr int OWN = TL::OWN, WALK = TL::WALK, KS = TL::KS;
  extern __shared__ unsigned char smem_wgmma[];
  unsigned char* smem = align_1024(smem_wgmma);
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sdO = sQ + TL::OWN_BYTES;
  const uint32_t sK = sdO + TL::OWN_BYTES;      // 2 stages
  const uint32_t sV = sK + 2 * TL::WALK_BYTES;  // 2 stages
  uint8_t* sOk = smem + TL::TILES_BYTES;        // 1 where the key may be attended, 2 stages

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.y * OWN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int N = p.N;

  const bf16* q = head_ptr<bf16>(p.q, p.q_s, b, h);
  const bf16* k = head_ptr<bf16>(p.k, p.k_s, b, h);
  const bf16* v = head_ptr<bf16>(p.v, p.v_s, b, h);
  const bf16* dout = head_ptr<bf16>(p.dout, p.do_s, b, h);

  // one commit group per stage of the walk (the first takes Q and dO along)
  auto load_walk = [&](int t) {
    const int st = t & 1;
    load_tile_async<WALK, D, THREADS>(sK + st * TL::WALK_BYTES, k, p.k_s[2], t * WALK, N, tid);
    load_tile_async<WALK, D, THREADS>(sV + st * TL::WALK_BYTES, v, p.v_s[2], t * WALK, N, tid);
    cp_async_commit();
  };

  load_tile_async<OWN, D, THREADS>(sQ, q, p.q_s[2], m0, N, tid);
  load_tile_async<OWN, D, THREADS>(sdO, dout, p.do_s[2], m0, N, tid);
  load_walk(0);
  if (tid < WALK) sOk[tid] = key_ok(p, b, tid);

  // lse and D of the thread's two rows, 16 warp + g and + 8; a row past N has
  // q = dO = 0, so with lse = D = 0 its ds is 0, and nothing of it is stored
  const int row_lo = m0 + 16 * warp + g, row_hi = row_lo + 8;
  const float* lse = p.lse + (long long)bh * N;
  const float* delta = p.delta + (long long)bh * N;
  const float l_lo = row_lo < N ? lse[row_lo] : 0.f, l_hi = row_hi < N ? lse[row_hi] : 0.f;
  const float d_lo = row_lo < N ? delta[row_lo] : 0.f, d_hi = row_hi < N ? delta[row_hi] : 0.f;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  const int n_tiles = (N + WALK - 1) / WALK;
  for (int t = 0; t < n_tiles; ++t) {
    // the next tile's mask bytes are read here and stored after this tile's
    // products, so their latency is hidden
    bool ok_next = false;
    if (t + 1 < n_tiles) {
      load_walk(t + 1);
      if (tid < WALK) ok_next = key_ok(p, b, (t + 1) * WALK + tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_proxy();
    __syncthreads();
    const int st = t & 1;
    const uint32_t tK = sK + st * TL::WALK_BYTES;
    const uint32_t tV = sV + st * TL::WALK_BYTES;
    const uint8_t* tOk = sOk + st * WALK;

    // S = Q K^T and dP = dO V^T: [64 queries][WALK keys]
    float s[WALK / 2], dp[WALK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, L::template desc_k_major<OWN>(sQ, kk), L::template desc_k_major<WALK>(tK, kk),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(dp, L::template desc_k_major<OWN>(sdO, kk),
               L::template desc_k_major<WALK>(tV, kk), kk > 0);
    wgmma_commit();
    wgmma_wait();
    wgmma_pin(s);
    wgmma_pin(dp);

    // dS in place: register 4 j + e is query row g + 8 (e / 2) of the warp's
    // 16, key column 8 j + 2 tq + e % 2
#pragma unroll
    for (int j = 0; j < WALK / 8; ++j) {
      const uchar2 ok2 = *reinterpret_cast<const uchar2*>(tOk + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int keep = -(int)((e & 1) ? ok2.y : ok2.x);
        const float le = (e & 2) ? l_hi : l_lo;
        const float de = (e & 2) ? d_hi : d_lo;
        const float pij = __expf(s[4 * j + e] * p.scale - le);
        dp[4 * j + e] = select_bits(pij * (dp[4 * j + e] - de), keep);
      }
    }
    uint32_t da[WALK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WALK / 16; ++kk)
      acc_to_a(da[kk], &dp[8 * kk]);  // rounds dS to bf16 (q's dtype)
    // dQ += dS K: the keys are the contraction dim, K enters as a transposed
    // B operand from the same tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WALK / 16; ++kk)
      wgmma_rs(dq, da[kk], L::template desc_mn_major<WALK>(tK, kk));
    wgmma_commit();
    wgmma_wait();
    if (t + 1 < n_tiles && tid < WALK) sOk[((t + 1) & 1) * WALK + tid] = ok_next;
    __syncthreads();  // this stage is refilled by the next step's prefetch
  }
  wgmma_pin(dq);

  bf16* out_dq = reinterpret_cast<bf16*>(smem);
  store_acc_to_tile<D>(out_dq, dq, p.scale, warp, lane);
  __syncwarp();
  copy_rows_out<D>(head_ptr_mut<bf16>(p.dq, p.dq_s, b, h), p.dq_s[2], out_dq, warp,
                   m0 + 16 * warp, N, lane);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_dkdv(const Params& p, int BH, cudaStream_t stream) {
  using TL = KVTile<D>;
  auto kernel = flash_bwd_dkdv_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TL::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.N + TL::BN - 1) / TL::BN);
  kernel<<<grid, THREADS, TL::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, int BH, cudaStream_t stream) {
  using TL = QTile<D>;
  auto kernel = flash_bwd_dq_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TL::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.N + TL::BM - 1) / TL::BM);
  kernel<<<grid, THREADS, TL::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Params& p, int BH, bool dq, cudaStream_t stream) {
  auto kernel = dq ? flash_bwd_dq_wgmma_kernel<D> : flash_bwd_dkdv_wgmma_kernel<D>;
  const size_t smem = dq ? WgTile<D, true>::SMEM_BYTES : WgTile<D, false>::SMEM_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.N + 63) / 64);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// dynamic shared memory of a block and the blocks of it an SM holds at once
template <int D>
cudaError_t occupancy_wgmma(bool dq, int* smem_bytes, int* blocks_per_sm) {
  auto kernel = dq ? flash_bwd_dq_wgmma_kernel<D> : flash_bwd_dkdv_wgmma_kernel<D>;
  const size_t smem = dq ? WgTile<D, true>::SMEM_BYTES : WgTile<D, false>::SMEM_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = (int)smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS, smem);
}

// fp32: the FMA kernels
cudaError_t dispatch_f32(const Params& p, int BH, int D, bool dq, cudaStream_t stream) {
  switch (D) {
    case 32: return dq ? launch_dq<32>(p, BH, stream) : launch_dkdv<32>(p, BH, stream);
    case 64: return dq ? launch_dq<64>(p, BH, stream) : launch_dkdv<64>(p, BH, stream);
    case 128:
      return dq ? launch_dq<128>(p, BH, stream) : launch_dkdv<128>(p, BH, stream);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: the tensor-core kernels
cudaError_t dispatch_bf16(const Params& p, int BH, int D, bool dq, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_wgmma<32>(p, BH, dq, stream);
    case 64: return launch_wgmma<64>(p, BH, dq, stream);
    case 128: return launch_wgmma<128>(p, BH, dq, stream);
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
  if (dtype == 0) return (int)dispatch_f32(p, B * H, D, dq, s);
  if (dtype == 1) return (int)dispatch_bf16(p, B * H, D, dq, s);
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

// Occupancy of a bf16 kernel (dq = 0: dK/dV, 1: dQ) at head dim D on the
// current device: the dynamic shared memory of one block, and how many blocks
// an SM holds at once given its registers and shared memory. Returns the
// cudaError_t (0 = success).
extern "C" int flash_bwd_occupancy(int dq, int D, int* smem_bytes, int* blocks_per_sm) {
  switch (D) {
    case 32: return (int)occupancy_wgmma<32>(dq != 0, smem_bytes, blocks_per_sm);
    case 64: return (int)occupancy_wgmma<64>(dq != 0, smem_bytes, blocks_per_sm);
    case 128: return (int)occupancy_wgmma<128>(dq != 0, smem_bytes, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
