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
// fp32 shape by operations. A head's K and V stay in L2 however many blocks
// re-read them, so what the design has to keep low is the time per product
// and the latency of each step of the walk over the keys (PERF.md has the
// measured times).
//
// bf16 design (`flash_fwd_wgmma_kernel`, with csrc/flash_common.cuh):
//   * grid = (B*H, ceil(N / 64)); a block is one warpgroup (128 threads) that
//     owns 64 query rows and walks K and V 64 keys at a time (the TPU's
//     sequential grid axis becomes this loop; nothing carries over between
//     blocks). Q is copied once, K and V go through two `cp.async` stages, so
//     the next tile's copy runs under this tile's products. Tiles are bf16 in
//     wgmma's swizzled layout, rows at or past N filled with zeros. Base
//     pointers and batch/head/row strides must be multiples of 16 bytes (the
//     wrapper checks).
//   * S = Q K^T is a `wgmma.mma_async` over both tiles in shared memory into
//     32 fp32 registers a thread. The online softmax runs on those registers
//     where they are: a thread holds two rows (16 warp + lane / 4 and + 8),
//     16 columns of each, and the 4 lanes of a quad hold a whole row, so the
//     row max is two shuffles. Masked and ragged keys take the -1e30 sentinel
//     before the max; p = exp(s - m_new) is set to 0 for them by a bitwise
//     select (`select_bits`: a row whose keys are all masked has m = -1e30
//     and exp(0) = 1 there), which cannot be compiled into a branch per
//     score. The exp is one multiply-add and one `ex2.approx` a score: m is
//     kept for q . k before `scale`, and scale * log2(e) is one factor.
//     Each thread keeps the fp32 sum of its own p; the quad adds them up
//     once, after the walk (every partial of a row is rescaled by the same
//     alpha).
//   * P never leaves the registers: rounded to bf16 it is the register-A
//     operand of O += P V, and V enters with its rows (the keys) as the
//     contraction dim, a transposed B operand read from the same swizzled
//     tile. O is a wgmma accumulator (Dh / 2 registers) that ordinary
//     instructions rescale by alpha = exp(m_old - m_new) between two batches
//     of products: the previous batch is waited for and the registers pinned
//     before the multiply, and a `wgmma.fence` follows it.
//   * Epilogue: O times 1 / max(l, 1e-30) by row, staged through the tiles'
//     shared memory and written 16 bytes a lane, a row as one contiguous run;
//     lse by one lane of each quad.
//   * 64-row tiles give 384 blocks at the mvp sampling shape and 448 at the
//     flagship shape on 132 SMs; a block takes 81 KB of shared memory at
//     Dh 128 (2 an SM), 41 KB at Dh 64 (4), 21 KB at Dh 32 (5).
//   * The order within a step is plain: S, wait, softmax and rescale, P V,
//     wait. Issuing the next tile's S before this tile's softmax, and taking
//     the next tile's softmax under this tile's P V, were both built and both
//     slower: with these one-instruction `asm` wrappers ptxas serialises the
//     products of a stage in which other instructions write registers that a
//     wgmma reads or accumulates into (PERF.md has the readings). The blocks
//     an SM holds at once overlap one block's softmax with another's products.
// bf16 at head dim 64 and long N (`flash_fwd_ws_kernel`, chosen by the
// caller: ops/flash_attention.py::forward_kernel). At [2, 48, 17 776, 64]
// the call is bound by operations (7.85 ms of FLOPs against 0.26 ms of
// bytes), and so is its exp: B*H*N^2 = 3.0e10 `ex2` on the special-function
// units take about as long as the products on the tensor cores. At Dh 64 a
// 64-key step of the kernel above pays its fixed costs (two waits, a
// barrier, the rescale) against half the tensor work they meet at Dh 128,
// and its blocks overlap one's softmax with another's products only by
// chance. This design makes the overlap its structure:
//   * grid = (ceil(N / 192), B*H), the query tiles of a head neighbours so
//     the blocks on the card share that head's K and V in L2; a block is
//     four warpgroups, one block an SM. Warpgroup 0 is the producer: it gives
//     up registers (`setmaxnreg`), and one of its warps fills a ring of 4
//     stages of 128 keys by TMA (K and V boxes in the 128-byte swizzle that
//     wgmma reads, one copy each; Q once) under full/empty mbarrier pairs,
//     and writes each stage's mask bytes and an "all 128 keys attendable"
//     byte beside it. TMA takes the [B, H, N, D] strides as given and fills
//     rows at or past N with zeros; those rows are masked.
//   * Three consumer warpgroups own 64 query rows each and read the same
//     stages. A step's products are S = Q K^T over 128 keys (m64n128k16 x 4,
//     64 fp32 registers) and O += P V of the stage before (8 register-A
//     m64n64k16), committed as two groups. The consumers take turns issuing
//     them (named barriers, one a consumer, in a ring), so their batches
//     reach the tensor cores one after another while the other warpgroups
//     run their softmax. Within a warpgroup the softmax of a stage starts when
//     its S is in, under its own P V of the stage before, and touches only
//     S and the row statistics; O is rescaled and P packed to bf16 after P V
//     is waited for, between batches, as above (ptxas reports no serialised
//     wgmma). The softmax is the kernel above's, on 128 keys; a stage whose
//     keys are all attendable skips the sentinel and the select.
//   * Epilogue as above, each consumer through its own tile.
//   Measured designs (PERF.md): two consumers of 64 rows and plain order S,
//   softmax, P V ran at 42 % of the bound; three consumers with the softmax
//   under the warpgroup's own P V at 50 %.
// fp32 keeps the FMA kernel below (`flash_fwd_kernel`): tensor cores take
// fp32 only as TF32, about three decimal digits, which the 1e-4 tolerance
// forbids. It stages fp32 tiles in shared memory (64 keys for Dh <= 64, 32
// for Dh = 128, rows padded by one word); thread (rg, cg) = (tid / 8,
// tid % 8) owns query rows 4*rg .. 4*rg+3 and the key / output columns cg,
// cg+8, ...; S and PV are register-tiled FMA loops, the row max and sum are
// reduced over the 8 lanes of a row group with shuffles, and P goes through
// shared memory to the PV loop.
// All three kernels mask the ragged edge themselves (no host padding), take the
// optional key-validity mask as one byte per key, [B, N] (1 = attendable),
// shared by all heads, and take [B, H, N, Dh] inputs with any batch/head/row
// strides and unit stride along Dh; the output takes strides too, so the
// caller can hand in a [B, N, H, Dh] buffer and skip a transpose.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

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

__device__ __forceinline__ bool key_ok(const Params& p, int b, int n) {
  return n < p.N && (p.valid == nullptr || p.valid[(long long)b * p.N + n] != 0);
}

// ---------------------------------------------------------------------------
// fp32 on the FMA units
// ---------------------------------------------------------------------------

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

template <int D>
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  for (int i = tid; i < BLOCK_M * D; i += THREADS) {
    const int r = i / D, c = i - (i / D) * D;
    const int n = m0 + r;
    sQ[r * TL::QS + c] = n < N ? q[n * p.q_sn + c] : 0.f;
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
      sK[r * TL::KS + c] = in ? k[n * p.k_sn + c] : 0.f;
      sV[r * TL::VS + c] = in ? v[n * p.v_sn + c] : 0.f;
    }
    if (tid < BN) sOk[tid] = key_ok(p, b, n0 + tid) ? 1.f : 0.f;
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
        prow[cg + COL_GROUPS * j] = pij;
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
    float* o = static_cast<float*>(p.out) + b * p.o_sb + h * p.o_sh + n * p.o_sn;
#pragma unroll
    for (int j = 0; j < TL::DJ; ++j) o[cg + COL_GROUPS * j] = acc[i][j] / l_safe;
    if (cg == 0) p.lse[(long long)bh * N + n] = m_run[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <int D>
struct WgTile {
  static constexpr int OWN = 64;   // query rows of a block: the M of one wgmma
  static constexpr int WALK = 64;  // keys per stage: the N of the scores
  static constexpr int KS = D / 16;  // k16 steps over the head dim
  static constexpr int OWN_BYTES = OWN * D * 2;
  static constexpr int WALK_BYTES = WALK * D * 2;
  // Q, then K and V in two stages each
  static constexpr int TILES_BYTES = OWN_BYTES + 4 * WALK_BYTES;
  // after the tiles: the walked keys' mask bytes, two stages
  static constexpr int MASK_BYTES = 2 * WALK;
  // 1024 bytes of slack to start the tiles on a swizzle boundary
  static constexpr size_t SMEM_BYTES = 1024 + TILES_BYTES + MASK_BYTES;
  static_assert(flash::OutTile<D>::BYTES <= TILES_BYTES, "out leaves through the tiles' memory");
};

// max over the 4 lanes of a quad: the lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit (about 2 ulp; 0 for x below -126)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one warpgroup per (batch*head, 64 query rows); it walks every key
template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_wgmma_kernel(const Params p) {
  using namespace flash;
  using TL = WgTile<D>;
  using L = Swizzled<D>;
  constexpr int OWN = TL::OWN, WALK = TL::WALK, KS = TL::KS;
  extern __shared__ unsigned char smem_wgmma[];
  unsigned char* smem = align_1024(smem_wgmma);
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sK = sQ + TL::OWN_BYTES;       // 2 stages
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

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // one commit group per stage of the walk (the first takes Q along)
  auto load_walk = [&](int t) {
    const int st = t & 1;
    load_tile_async<WALK, D, THREADS>(sK + st * TL::WALK_BYTES, k, p.k_sn, t * WALK, N, tid);
    load_tile_async<WALK, D, THREADS>(sV + st * TL::WALK_BYTES, v, p.v_sn, t * WALK, N, tid);
    cp_async_commit();
  };

  load_tile_async<OWN, D, THREADS>(sQ, q, p.q_sn, m0, N, tid);
  load_walk(0);
  if (tid < WALK) sOk[tid] = key_ok(p, b, tid);

  // The thread's two rows of every accumulator are 16 warp + g ("lo") and
  // + 8 ("hi"): registers 4 j + e with e < 2 are lo, the others hi. m is the
  // running max of the whole row's q . k (before `scale`: the exponent takes
  // scale and log2(e) in one factor c), l the running sum of this thread's
  // columns of p.
  const float c = p.scale * 1.4426950408889634f;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_lo = NEG_SENTINEL, m_hi = NEG_SENTINEL, l_lo = 0.f, l_hi = 0.f;

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

    // S = Q K^T: [64 queries][WALK keys]
    float s[WALK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss(s, L::template desc_k_major<OWN>(sQ, kk), L::template desc_k_major<WALK>(tK, kk),
               kk > 0);
    wgmma_commit();
    wgmma_wait();
    wgmma_pin(s);

    // the sentinel on masked and ragged keys, and the tile's row max:
    // register 4 j + e is key column 8 j + 2 tq + e % 2
    int keep[WALK / 4];
    float mt_lo = NEG_SENTINEL, mt_hi = NEG_SENTINEL;
#pragma unroll
    for (int j = 0; j < WALK / 8; ++j) {
      const uchar2 ok2 = *reinterpret_cast<const uchar2*>(tOk + 8 * j + 2 * tq);
      keep[2 * j] = -(int)ok2.x;
      keep[2 * j + 1] = -(int)ok2.y;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = select_bits(s[4 * j + e], NEG_SENTINEL, keep[2 * j + (e & 1)]);
        s[4 * j + e] = x;
        if (e & 2) mt_hi = fmaxf(mt_hi, x);
        else mt_lo = fmaxf(mt_lo, x);
      }
    }
    const float mn_lo = fmaxf(m_lo, quad_max(mt_lo)), mn_hi = fmaxf(m_hi, quad_max(mt_hi));
    // 2^(c (-1e30 - m)) is 0 after a tile whose keys were all masked, and
    // 2^0 = 1 while every key so far was (l and o are 0 then)
    const float alpha_lo = exp2_approx(c * (m_lo - mn_lo));
    const float alpha_hi = exp2_approx(c * (m_hi - mn_hi));
    m_lo = mn_lo;
    m_hi = mn_hi;

    // P = 2^(c s - c m) in place, one multiply-add and one exp2 a score,
    // then the select: where m is still the sentinel the exponent of a
    // masked key is the rounding error of -1e30 c, anything from -1e22 to
    // 1e22. The row sums add the fp32 p.
    const float mc_lo = c * mn_lo, mc_hi = c * mn_hi;
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < WALK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mc = (e & 2) ? mc_hi : mc_lo;
        const float pij =
            select_bits(exp2_approx(fmaf(s[4 * j + e], c, -mc)), keep[2 * j + (e & 1)]);
        s[4 * j + e] = pij;
        if (e & 2) rs_hi += pij;
        else rs_lo += pij;
      }
    }
    l_lo = l_lo * alpha_lo + rs_lo;
    l_hi = l_hi * alpha_hi + rs_hi;
    uint32_t pa[WALK / 16][4];
#pragma unroll
    for (int kk = 0; kk < WALK / 16; ++kk) acc_to_a(pa[kk], &s[8 * kk]);  // rounds P to bf16

    // O = alpha O + P V: the keys are the contraction dim, V enters as a
    // transposed B operand. The last batch into o was waited for at the end
    // of the step before, so ordinary instructions may rescale it here; the
    // fence orders them before the products.
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha_lo;
      o[4 * j + 1] *= alpha_lo;
      o[4 * j + 2] *= alpha_hi;
      o[4 * j + 3] *= alpha_hi;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WALK / 16; ++kk)
      wgmma_rs(o, pa[kk], L::template desc_mn_major<WALK>(tV, kk));
    wgmma_commit();
    wgmma_wait();
    wgmma_pin(o);
    if (t + 1 < n_tiles && tid < WALK) sOk[((t + 1) & 1) * WALK + tid] = ok_next;
    __syncthreads();  // this stage is refilled by the next step's prefetch
  }

  // every warp's products are behind the loop's last barrier, so the tiles
  // are free: out leaves through a plain tile at the start of the block's
  // memory, each warp its own 16 rows, a whole row at a time
  const float ls_lo = fmaxf(quad_sum(l_lo), 1e-30f), ls_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  bf16* out_tile = reinterpret_cast<bf16*>(smem);
  store_acc_to_tile<D>(out_tile, o, 1.f / ls_lo, 1.f / ls_hi, warp, lane);
  __syncwarp();
  copy_rows_out<D>(static_cast<bf16*>(p.out) + b * p.o_sb + h * p.o_sh, p.o_sn, out_tile, warp,
                   m0 + 16 * warp, N, lane);
  if (tq == 0) {
    const int row_lo = m0 + 16 * warp + g, row_hi = row_lo + 8;
    float* lse = p.lse + (long long)bh * N;
    // the sentinel is not scaled: a row whose keys are all masked keeps -1e30
    if (row_lo < N) lse[row_lo] = (m_lo == NEG_SENTINEL ? m_lo : m_lo * p.scale) + logf(ls_lo);
    if (row_hi < N) lse[row_hi] = (m_hi == NEG_SENTINEL ? m_hi : m_hi * p.scale) + logf(ls_hi);
  }
}

// ---------------------------------------------------------------------------
// bf16 at long N: a TMA producer warp and three consumer warpgroups
// ---------------------------------------------------------------------------

// mbarriers in shared memory (addresses in the shared window)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// the bytes of asynchronous copies the barrier's current phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a [64 columns, rows] box of a [B, H, N, 64] tensor into shared memory, its
// bytes completing on the barrier; coordinates innermost first
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// named barriers 1 .. 3 order the consumers' product batches (0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

constexpr int WS_D = 64;            // head dim: a row is one 128-byte swizzle row and one TMA box
constexpr int WS_ROWS = 64;         // query rows of a consumer warpgroup
constexpr int WS_KEYS = 128;        // keys a stage
constexpr int WS_CONSUMERS = 3;     // consumer warpgroups: a block owns 192 query rows
constexpr int WS_THREADS = (1 + WS_CONSUMERS) * 128;  // the producer warpgroup, then the consumers
// the block's 512 x 128 registers, moved from the producer to the consumers
constexpr int WS_PRODUCER_REGS = 32;
constexpr int WS_CONSUMER_REGS = 160;
static_assert(128 * (WS_PRODUCER_REGS + WS_CONSUMERS * WS_CONSUMER_REGS) <= 65536, "registers");
// a stage's mask bytes, then its "all attendable" byte
constexpr int WS_MASK_STRIDE = WS_KEYS + 16;

struct WsTile {
  static constexpr int STAGES = 4;  // K and V stages in the ring
  static constexpr int Q_BYTES = WS_CONSUMERS * WS_ROWS * WS_D * 2;
  static constexpr int KV_BYTES = WS_KEYS * WS_D * 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K, then V
  static constexpr int OUT = Q_BYTES + STAGES * STAGE_BYTES;  // the consumers' out tiles
  static constexpr int MASK = OUT + WS_CONSUMERS * flash::OutTile<WS_D>::BYTES;
  static constexpr int BARS = MASK + STAGES * WS_MASK_STRIDE;  // full, empty, then Q's
  static constexpr size_t SMEM_BYTES = 1024 + BARS + (2 * STAGES + 1) * 8;
  static_assert(BARS % 8 == 0 && SMEM_BYTES <= 232448, "shared memory");
};

// The online softmax of one stage on a consumer's S registers (64 rows x 128
// keys; register 4 j + e is key 8 j + 2 tq + e % 2 of row lo, e < 2, or hi),
// as flash_fwd_wgmma_kernel's on 64 keys: P = 2^(c s - c m) in place, m and l
// carried, and alpha = 2^(c m_old - c m_new) for o. MASKED takes the sentinel
// and the select on each key; a stage whose 128 keys are all attendable
// takes neither.
template <bool MASKED>
__device__ __forceinline__ void ws_scores(float (&s)[2 * WS_KEYS / 4], float& m_lo, float& m_hi,
                                          float& l_lo, float& l_hi, float& alpha_lo,
                                          float& alpha_hi, float c, const uint8_t* ok, int tq) {
  using flash::select_bits;
  // -1 where key 8 j + 2 tq + e % 2 may be attended, 0 where not
  auto keep = [&](int j, int e) {
    const uchar2 ok2 = *reinterpret_cast<const uchar2*>(ok + 8 * j + 2 * tq);
    return -(int)((e & 1) ? ok2.y : ok2.x);
  };
  float mt_lo = NEG_SENTINEL, mt_hi = NEG_SENTINEL;
#pragma unroll
  for (int j = 0; j < WS_KEYS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if (MASKED) s[4 * j + e] = x = select_bits(x, NEG_SENTINEL, keep(j, e));
      if (e & 2) mt_hi = fmaxf(mt_hi, x);
      else mt_lo = fmaxf(mt_lo, x);
    }
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mt_lo)), mn_hi = fmaxf(m_hi, quad_max(mt_hi));
  alpha_lo = exp2_approx(c * (m_lo - mn_lo));
  alpha_hi = exp2_approx(c * (m_hi - mn_hi));
  m_lo = mn_lo;
  m_hi = mn_hi;
  const float mc_lo = c * mn_lo, mc_hi = c * mn_hi;
  float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
  for (int j = 0; j < WS_KEYS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pij = exp2_approx(fmaf(s[4 * j + e], c, (e & 2) ? -mc_hi : -mc_lo));
      if (MASKED) pij = select_bits(pij, keep(j, e));
      s[4 * j + e] = pij;
      if (e & 2) rs_hi += pij;
      else rs_lo += pij;
    }
  }
  l_lo = l_lo * alpha_lo + rs_lo;
  l_hi = l_hi * alpha_hi + rs_hi;
}

// P rounded to bf16 into the register-A fragments of P V, and o rescaled
__device__ __forceinline__ void ws_pack(const float (&s)[2 * WS_KEYS / 4],
                                        uint32_t (&pa)[WS_KEYS / 16][4],
                                        float (&o)[WS_D / 2], float alpha_lo, float alpha_hi) {
#pragma unroll
  for (int kk = 0; kk < WS_KEYS / 16; ++kk) flash::acc_to_a(pa[kk], &s[8 * kk]);
#pragma unroll
  for (int j = 0; j < WS_D / 8; ++j) {
    o[4 * j] *= alpha_lo;
    o[4 * j + 1] *= alpha_lo;
    o[4 * j + 2] *= alpha_hi;
    o[4 * j + 3] *= alpha_hi;
  }
}

__global__ void __launch_bounds__(WS_THREADS, 1)
    flash_fwd_ws_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, const Params p) {
  using namespace flash;
  using TL = WsTile;
  constexpr int D = WS_D;
  using L = Swizzled<D>;
  constexpr int STAGES = TL::STAGES;
  extern __shared__ unsigned char smem_ws[];
  unsigned char* smem = align_1024(smem_ws);
  const uint32_t sQ = smem_addr(smem);
  const uint32_t sKV = sQ + TL::Q_BYTES;
  uint8_t* sOk = smem + TL::MASK;
  const uint32_t bars = smem_addr(smem + TL::BARS);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };
  const uint32_t q_bar = bars + 8 * 2 * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int m0 = blockIdx.x * WS_CONSUMERS * WS_ROWS;
  const int N = p.N;
  const int n_stages = (N + WS_KEYS - 1) / WS_KEYS;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 32);   // the producer warp's lanes, each after its mask bytes
      mbar_init(empty(st), 128 * WS_CONSUMERS);  // every consumer thread, after its last read
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one warp fills the ring, the others leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WS_PRODUCER_REGS));
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    if (lane == 0) {
      mbar_expect_tx(q_bar, TL::Q_BYTES);
      tma_load(sQ, &map_q, q_bar, 0, m0, h, b);
      mbar_arrive(q_bar);
    }
    for (int t = 0; t < n_stages; ++t) {
      const int st = t % STAGES;
      // the first round finds every stage empty
      mbar_wait(empty(st), ((t / STAGES) & 1) ^ 1);
      const int n0 = t * WS_KEYS;
      if (lane == 0) {
        mbar_expect_tx(full(st), TL::STAGE_BYTES);
        const uint32_t dst = sKV + st * TL::STAGE_BYTES;
        tma_load(dst, &map_k, full(st), 0, n0, h, b);
        tma_load(dst + TL::KV_BYTES, &map_v, full(st), 0, n0, h, b);
      }
      // the stage's mask bytes (rows at or past N are masked: TMA filled them
      // with zeros), 4 a lane, while the copies are in flight
      uint32_t word = 0;
      bool all = true;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key_ok(p, b, n0 + 4 * lane + e);
        word |= (uint32_t)ok << (8 * e);
        all = all && ok;
      }
      uint8_t* ok_bytes = sOk + st * WS_MASK_STRIDE;
      *reinterpret_cast<uint32_t*>(ok_bytes + 4 * lane) = word;
      all = __all_sync(0xffffffffu, all);
      if (lane == 0) ok_bytes[WS_KEYS] = all;
      mbar_arrive(full(st));
    }
    return;
  }

  // a consumer: 64 query rows against every stage of keys
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WS_CONSUMER_REGS));
  const int cw = wg - 1;
  const int tid = threadIdx.x - 128 * wg;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  // this warpgroup's rows of the Q tile
  const uint32_t myQ = sQ + cw * WS_ROWS * L::ROW_BYTES;
  // The consumers take turns at the tensor cores, in a ring: each batch of
  // products is issued between a wait on this warpgroup's barrier and an
  // arrival at the next one's. Consumer 0 is let through its first wait by
  // its own arrival; the last consumer skips its last arrival, which nothing
  // waits for.
  const int bar_mine = 1 + cw, bar_next = 1 + (cw + 1) % WS_CONSUMERS;
  if (cw == 0) named_arrive(bar_mine, 256);

  const float c = p.scale * 1.4426950408889634f;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[2 * WS_KEYS / 4];
  uint32_t pa[WS_KEYS / 16][4];
  float m_lo = NEG_SENTINEL, m_hi = NEG_SENTINEL, l_lo = 0.f, l_hi = 0.f;
  float alpha_lo, alpha_hi;

  auto issue_s = [&](int st) {
    const uint32_t tK = sKV + st * TL::STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, L::template desc_k_major<WS_CONSUMERS * WS_ROWS>(myQ, kk),
               L::template desc_k_major<WS_KEYS>(tK, kk), kk > 0);
  };
  auto issue_pv = [&](int st) {
    const uint32_t tV = sKV + st * TL::STAGE_BYTES + TL::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < WS_KEYS / 16; ++kk)
      wgmma_rs(o, pa[kk], L::template desc_mn_major<WS_KEYS>(tV, kk));
  };
  auto scores = [&](int st) {
    const uint8_t* ok = sOk + st * WS_MASK_STRIDE;
    if (ok[WS_KEYS]) ws_scores<false>(s, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, c, ok, tq);
    else ws_scores<true>(s, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi, c, ok, tq);
  };

  mbar_wait(q_bar, 0);
  mbar_wait(full(0), 0);
  named_sync(bar_mine, 256);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  named_arrive(bar_next, 256);
  wgmma_wait();
  wgmma_pin(s);
  scores(0);
  ws_pack(s, pa, o, alpha_lo, alpha_hi);
  // Step t: S of stage t and P V of stage t - 1, committed as two groups in
  // one turn. Stage t's softmax starts once S is in and runs under P V (it
  // touches only s, m and l); then P V is waited for, stage t - 1 released,
  // and P packed and o rescaled between batches, as in flash_fwd_wgmma_kernel.
  for (int t = 1; t < n_stages; ++t) {
    const int st = t % STAGES, prev = (t - 1) % STAGES;
    mbar_wait(full(st), (t / STAGES) & 1);
    named_sync(bar_mine, 256);
    wgmma_fence();
    issue_s(st);
    wgmma_commit();
    issue_pv(prev);
    wgmma_commit();
    named_arrive(bar_next, 256);
    wgmma_wait<1>();
    wgmma_pin(s);
    scores(st);
    wgmma_wait<0>();
    wgmma_pin(o);
    mbar_arrive(empty(prev));
    ws_pack(s, pa, o, alpha_lo, alpha_hi);
  }
  named_sync(bar_mine, 256);
  wgmma_fence();
  issue_pv((n_stages - 1) % STAGES);
  wgmma_commit();
  if (cw != WS_CONSUMERS - 1) named_arrive(bar_next, 256);
  wgmma_wait();
  wgmma_pin(o);

  // out through this warpgroup's own tile, each warp its 16 rows
  const float ls_lo = fmaxf(quad_sum(l_lo), 1e-30f), ls_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  bf16* out_tile = reinterpret_cast<bf16*>(smem + TL::OUT + cw * OutTile<D>::BYTES);
  store_acc_to_tile<D>(out_tile, o, 1.f / ls_lo, 1.f / ls_hi, warp, lane);
  __syncwarp();
  const int r0 = m0 + cw * WS_ROWS + 16 * warp;
  copy_rows_out<D>(static_cast<bf16*>(p.out) + b * p.o_sb + h * p.o_sh, p.o_sn, out_tile, warp,
                   r0, N, lane);
  if (tq == 0) {
    const int row_lo = r0 + g, row_hi = row_lo + 8;
    float* lse = p.lse + (long long)bh * N;
    if (row_lo < N) lse[row_lo] = (m_lo == NEG_SENTINEL ? m_lo : m_lo * p.scale) + logf(ls_lo);
    if (row_hi < N) lse[row_hi] = (m_hi == NEG_SENTINEL ? m_hi : m_hi * p.scale) + logf(ls_hi);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch_f32(const Params& p, int BH, cudaStream_t stream) {
  using TL = Tile<D>;
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TL::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.N + BLOCK_M - 1) / BLOCK_M);
  kernel<<<grid, THREADS, TL::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Params& p, int BH, cudaStream_t stream) {
  using TL = WgTile<D>;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TL::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (p.N + TL::OWN - 1) / TL::OWN);
  kernel<<<grid, THREADS, TL::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query: the
// library links no libcuda of its own
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault,
                                         &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(entry);
  }
  return fn;
}

// The TMA map of a [B, H, N, D] bf16 operand with element strides (sb, sh,
// sn) and unit stride along D, read in boxes of 64 columns (one 128-byte
// swizzle row) by `rows` rows; rows at or past N read as zeros. A dim of
// extent 1 is never stepped over, so its stride is replaced by one TMA takes.
bool tensor_map(CUtensorMap* map, const void* base, int B, int H, int N, int D, long long sb,
                long long sh, long long sn, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t extent[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
  const long long given[3] = {sn, sh, sb};
  cuuint64_t stride[3];
  cuuint64_t dense = (cuuint64_t)D * 2;
  for (int i = 0; i < 3; ++i) {
    stride[i] = extent[i + 1] == 1 ? dense : (cuuint64_t)given[i] * 2;
    dense *= extent[i + 1];
  }
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), extent, stride,
                box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_ws(const Params& p, int B, cudaStream_t stream) {
  using TL = WsTile;
  constexpr int D = WS_D;
  if ((long long)B * p.H > 65535) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v;
  if (!tensor_map(&map_q, p.q, B, p.H, p.N, D, p.q_sb, p.q_sh, p.q_sn, WS_CONSUMERS * WS_ROWS) ||
      !tensor_map(&map_k, p.k, B, p.H, p.N, D, p.k_sb, p.k_sh, p.k_sn, WS_KEYS) ||
      !tensor_map(&map_v, p.v, B, p.H, p.N, D, p.v_sb, p.v_sh, p.v_sn, WS_KEYS))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_ws_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)TL::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + WS_CONSUMERS * WS_ROWS - 1) / (WS_CONSUMERS * WS_ROWS), B * p.H);
  kernel<<<grid, WS_THREADS, TL::SMEM_BYTES, stream>>>(map_q, map_k, map_v, p);
  return cudaGetLastError();
}

// dynamic shared memory of a block and the blocks of it an SM holds at once
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem, int* smem_bytes,
                      int* blocks_per_sm) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = (int)smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
}

// design 0: fp32 on the FMA kernel, bf16 on the one-warpgroup tensor-core
// kernel; design 1: bf16 on the warp-specialised kernel (head dim 64)
cudaError_t dispatch(const Params& p, int B, int D, bool bf16_inputs, int design,
                     cudaStream_t stream) {
  const int BH = B * p.H;
  if (design == 1) {
    if (!bf16_inputs || D != WS_D) return cudaErrorInvalidValue;
    return launch_ws(p, B, stream);
  }
  switch (D) {
    case 32: return bf16_inputs ? launch_wgmma<32>(p, BH, stream) : launch_f32<32>(p, BH, stream);
    case 64: return bf16_inputs ? launch_wgmma<64>(p, BH, stream) : launch_f32<64>(p, BH, stream);
    case 128:
      return bf16_inputs ? launch_wgmma<128>(p, BH, stream) : launch_f32<128>(p, BH, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `device` is the
// CUDA ordinal the tensors live on (this library's runtime keeps its own
// current device). Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* valid,
                         void* out, void* lse, int device, int B, int H, int N, int D,
                         int dtype, int design,
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
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (design != 0 && design != 1) return (int)cudaErrorInvalidValue;
  return (int)dispatch(p, B, D, dtype == 1, design, s);
}

// Occupancy of a bf16 kernel at head dim D on the current device (design as
// flash_fwd's; the warp-specialised one at D = 64 only): the dynamic shared
// memory of one block, and how many blocks an SM holds at once given its
// registers and shared memory. Returns the cudaError_t (0 = success).
extern "C" int flash_fwd_occupancy(int D, int design, int* smem_bytes, int* blocks_per_sm) {
  if (design == 1)
    return D == WS_D ? (int)occupancy(flash_fwd_ws_kernel, WS_THREADS, WsTile::SMEM_BYTES,
                                      smem_bytes, blocks_per_sm)
                     : (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return (int)occupancy(flash_fwd_wgmma_kernel<32>, THREADS, WgTile<32>::SMEM_BYTES,
                                   smem_bytes, blocks_per_sm);
    case 64: return (int)occupancy(flash_fwd_wgmma_kernel<64>, THREADS, WgTile<64>::SMEM_BYTES,
                                   smem_bytes, blocks_per_sm);
    case 128: return (int)occupancy(flash_fwd_wgmma_kernel<128>, THREADS,
                                    WgTile<128>::SMEM_BYTES, smem_bytes, blocks_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}
