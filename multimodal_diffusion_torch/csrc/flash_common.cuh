// Building blocks of the tensor-core flash-attention kernels for Hopper
// (sm_90a): bf16 tiles in shared memory in the swizzled layout that `wgmma`
// reads, filled by 16-byte asynchronous copies; the shared-memory matrix
// descriptors; the `wgmma.mma_async` products (both operands from shared
// memory, or A from registers and B transposed); and the bf16 pack/round and
// write-out helpers. One warpgroup (4 warps, 128 threads) issues each product.
//
// Accumulator layout of wgmma m64nNk16 (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): the thread's registers d[4j .. 4j+3] hold, of the 8-column
// group j,
//   d[4j]   = D[16w + g][8j + 2t],     d[4j+1] = D[16w + g][8j + 2t + 1],
//   d[4j+2] = D[16w + g + 8][8j + 2t], d[4j+3] = D[16w + g + 8][8j + 2t + 1].
// The register-A operand of a k16 step wants, of the same rows,
//   a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9],
//   a3 = A[g+8][2t+8, 2t+9],
// so eight consecutive accumulator registers (two column groups), rounded to
// bf16 and packed in pairs, are the A fragment of the next product with those
// 16 columns as its contraction dim. That is how P and dS stay in registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary of shared memory at or after p: where the
// swizzled tiles of a block start (its dynamic shared memory has 1024 bytes
// of slack for this)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// x where keep is -1 and +0 where it is 0: a select that cannot become a
// branch (64 data-dependent branches a step cost several times the products)
// and, unlike a product with 0, turns inf and NaN into 0 too
__device__ __forceinline__ float select_bits(float x, int keep) {
  return __int_as_float(__float_as_int(x) & keep);
}

// x where keep is -1 and `other` where it is 0, bitwise as well
__device__ __forceinline__ float select_bits(float x, float other, int keep) {
  return __int_as_float((__float_as_int(x) & keep) | (__float_as_int(other) & ~keep));
}

// A [R, D] bf16 tile in shared memory as wgmma wants it: blocks of up to 64
// columns, each block R rows of 128 bytes (64 bytes at D = 32) with the
// 16-byte pieces of a row XOR-swizzled by the row index (the hardware's
// 128-byte and 64-byte swizzle modes, which also keep the copies free of
// bank conflicts). The tile must start on a 1024-byte boundary.
template <int D>
struct Swizzled {
  static constexpr int BLOCK_COLS = D < 64 ? D : 64;
  static constexpr int ROW_BYTES = BLOCK_COLS * 2;  // 128 or 64
  static constexpr int PIECES_PER_ROW = D / 8;      // 16-byte pieces of a full row
  static constexpr int PIECES_PER_BLOCK_ROW = ROW_BYTES / 16;
  static constexpr uint32_t XOR_MASK = ROW_BYTES == 128 ? 0x70 : 0x30;
  static constexpr uint64_t MODE = ROW_BYTES == 128 ? 1 : 2;  // descriptor layout type
  static constexpr uint64_t GROUP_STRIDE = (8 * ROW_BYTES) >> 4;  // 8 rows, in 16-byte units

  // byte offset of 16-byte piece `piece` (0 .. D/8) of row `row` in a tile of R rows
  template <int R>
  __device__ __forceinline__ static uint32_t piece_offset(int row, int piece) {
    uint32_t o = row * ROW_BYTES + (piece % PIECES_PER_BLOCK_ROW) * 16;
    o ^= (o >> 3) & XOR_MASK;
    return (piece / PIECES_PER_BLOCK_ROW) * (R * ROW_BYTES) + o;
  }

  // Descriptor of the tile as a K-major operand (the contraction dim runs
  // along the rows' columns), all R rows, columns [16 kk, 16 kk + 16).
  template <int R>
  __device__ __forceinline__ static uint64_t desc_k_major(uint32_t tile, int kk) {
    const uint32_t a = tile + ((16 * kk) / BLOCK_COLS) * (R * ROW_BYTES) +
                       ((16 * kk) % BLOCK_COLS) * 2;
    return (uint64_t)((a & 0x3FFFF) >> 4) | (1ull << 16) | (GROUP_STRIDE << 32) | (MODE << 62);
  }

  // Descriptor of the tile as a transposed ("MN-major") B operand: the
  // contraction dim runs down the rows, rows [16 kk, 16 kk + 16), all D
  // columns. The leading offset steps from one 64-column block to the next.
  template <int R>
  __device__ __forceinline__ static uint64_t desc_mn_major(uint32_t tile, int kk) {
    const uint32_t a = tile + 16 * kk * ROW_BYTES;
    return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(((R * ROW_BYTES) >> 4) & 0x3FFF) << 16) |
           (GROUP_STRIDE << 32) | (MODE << 62);
  }
};

// 16 bytes global -> shared, bypassing L1; zeros when `pred` is false (the
// source is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool pred) {
  const int bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes global -> shared; zeros when `pred` is false
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool pred) {
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most PENDING of this thread's committed groups are in flight
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// make shared-memory writes of this thread visible to wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [r0, r0 + R) of a [N, D] bf16 head (row stride `sn` elements, base
// and stride multiples of 16 bytes) into a swizzled tile at shared address
// `tile`, as 16-byte asynchronous copies; rows at or past N are filled with
// zeros. A thread keeps one piece column and steps down the rows by a
// multiple of 8, so its swizzle is fixed and each copy costs two additions.
template <int R, int D, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t tile, const __nv_bfloat16* src,
                                                long long sn, int r0, int N, int tid) {
  using L = Swizzled<D>;
  constexpr int ROWS_PER_PASS = THREADS / L::PIECES_PER_ROW;
  static_assert(THREADS % L::PIECES_PER_ROW == 0 && ROWS_PER_PASS % 8 == 0 &&
                    R % ROWS_PER_PASS == 0,
                "tile does not divide among the threads");
  const int r = tid / L::PIECES_PER_ROW, c = tid % L::PIECES_PER_ROW;
  int n = r0 + r;
  uint32_t d = tile + L::template piece_offset<R>(r, c);
  const __nv_bfloat16* s = src + n * sn + c * 8;
#pragma unroll
  for (int pass = 0; pass < R / ROWS_PER_PASS; ++pass) {
    const bool in = n < N;
    cp_async_16(d, in ? s : src, in);
    n += ROWS_PER_PASS;
    d += ROWS_PER_PASS * L::ROW_BYTES;
    s += ROWS_PER_PASS * sn;
  }
}

// `count` floats src[r0 ..] (zeros at or past N) into dst, 4-byte
// asynchronous copies, by the threads tid0 <= tid < tid0 + count
__device__ __forceinline__ void load_row_stats_async(float* dst, const float* src, int r0, int N,
                                                     int count, int tid, int tid0) {
  const int i = tid - tid0;
  if (i >= 0 && i < count) {
    const bool in = r0 + i < N;
    cp_async_4(smem_addr(dst + i), src + (in ? r0 + i : 0), in);
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// before the first wgmma of a batch, and after registers it reads (the
// accumulators, a register A operand) were written by other instructions
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most PENDING of the warpgroup's committed wgmma groups are in
// flight (by default, for all of them)
template <int PENDING = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Pin accumulator registers after the wait: the compiler must not move a
// read of them above it.
template <int REGS>
__device__ __forceinline__ void wgmma_pin(float (&d)[REGS]) {
#pragma unroll
  for (int i = 0; i < REGS; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FLASH_ACC8(d, o)                                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), \
      "+f"(d[o + 6]), "+f"(d[o + 7])
#define FLASH_ACC16(d, o) FLASH_ACC8(d, o), FLASH_ACC8(d, o + 8)
#define FLASH_ACC32(d, o) FLASH_ACC16(d, o), FLASH_ACC16(d, o + 16)
#define FLASH_ACC64(d) FLASH_ACC32(d, 0), FLASH_ACC32(d, 32)

// d (64 x N fp32) = a (64 x 16, shared, K-major) * b (N x 16, shared,
// K-major)^T, plus d when accumulate is nonzero. N = 2 * REGS.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : FLASH_ACC16(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_ACC32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : FLASH_ACC64(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N fp32) += a (64 x 16 bf16, registers) * b (16 x N, shared, stored
// [k][n]: the transposed B form). N = 2 * REGS. (The accumulate flag is a
// predicate in PTX; it is always set here.)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : FLASH_ACC16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FLASH_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// registers <-> bf16
// ---------------------------------------------------------------------------

// (lo, hi) rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// eight consecutive accumulator registers (two 8-column groups) -> the bf16
// register-A fragment over those 16 columns
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* c) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c[4], c[5]);
  a[3] = pack_bf16(c[6], c[7]);
}

// Row stride, in elements, of the plain [64, D] bf16 tile through which an
// accumulator leaves: 16 bytes of padding keep the stores and the 16-byte
// reads below free of bank conflicts.
template <int D>
struct OutTile {
  static constexpr int LD = D + 8;
  static constexpr int BYTES = 64 * LD * 2;
};

// A warp's 16 rows of a 64 x D fp32 accumulator, rounded to bf16 into rows
// [16 warp, 16 warp + 16) of such a tile; the thread's row lane / 4 of them
// times `scale_lo`, its row lane / 4 + 8 times `scale_hi`
template <int D>
__device__ __forceinline__ void store_acc_to_tile(__nv_bfloat16* tile, const float (&c)[D / 2],
                                                  float scale_lo, float scale_hi, int warp,
                                                  int lane) {
  constexpr int LD = OutTile<D>::LD;
  __nv_bfloat16* row = tile + (16 * warp + (lane >> 2)) * LD + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
        __floats2bfloat162_rn(c[4 * j] * scale_lo, c[4 * j + 1] * scale_lo);
    *reinterpret_cast<__nv_bfloat162*>(row + 8 * LD + 8 * j) =
        __floats2bfloat162_rn(c[4 * j + 2] * scale_hi, c[4 * j + 3] * scale_hi);
  }
}

// the same with one scale for every row
template <int D>
__device__ __forceinline__ void store_acc_to_tile(__nv_bfloat16* tile, const float (&c)[D / 2],
                                                  float scale, int warp, int lane) {
  store_acc_to_tile<D>(tile, c, scale, scale, warp, lane);
}

// The same 16 rows of the tile to rows n_first .. n_first + 15 of a [N, D]
// head (row stride `sn`, 16-byte aligned), those below N only, by the warp
// that stored them, 16 bytes a lane: a row leaves as one contiguous run
template <int D>
__device__ __forceinline__ void copy_rows_out(__nv_bfloat16* out, long long sn,
                                              const __nv_bfloat16* tile, int warp, int n_first,
                                              int N, int lane) {
  constexpr int PIECES = D / 8;
  constexpr int LD = OutTile<D>::LD;
#pragma unroll
  for (int i = lane; i < 16 * PIECES; i += 32) {
    const int r = i / PIECES, c = i % PIECES;
    if (n_first + r < N)
      *reinterpret_cast<int4*>(out + (n_first + r) * sn + c * 8) =
          *reinterpret_cast<const int4*>(tile + (16 * warp + r) * LD + c * 8);
  }
}

}  // namespace flash
