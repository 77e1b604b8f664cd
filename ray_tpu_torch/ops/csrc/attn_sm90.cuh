// Device helpers shared by the flash-attention kernels (flash_fwd.cu, K1;
// flash_bwd.cu, K2): tensor-core products with their operands in registers,
// asynchronous tile copies into swizzled shared memory, and the reductions
// of the m16n8 accumulator layout.
//
// mma.sync.m16n8k16 (bf16 in, f32 sums). With lane = 4 * g + t (g = lane / 4,
// t = lane % 4), a warp holds:
//   A, 16 x 16 (4 x b32):  a0 (row g, cols 2t, 2t+1)    a1 (row g+8, cols 2t, 2t+1)
//                          a2 (row g, cols 2t+8, 2t+9)  a3 (row g+8, cols 2t+8, 2t+9)
//   B, 16 x 8  (2 x b32):  b0 (k 2t, 2t+1; col g)       b1 (k 2t+8, 2t+9; col g)
//   C, 16 x 8  (4 x f32):  c0, c1 (row g, cols 2t, 2t+1)  c2, c3 (row g+8, same cols)
// So two neighbouring C tiles (cols 0-7 and 8-15) rounded to bf16 are, value
// for value, the A fragment of a product of depth 16 (`a_from_c`): P and dS
// feed the next product from registers, with no shared-memory round trip.
//
// Shared-memory tiles are [rows, W] bf16, row-major, with each row's 16-byte
// chunks permuted by chunk ^ (row % 8) (`swz`). ldmatrix reads 8 rows of one
// chunk column at a time and a cp.async writes one chunk per thread; with the
// permutation both touch 8 different chunks in every 8 rows, so neither has
// bank conflicts, with no padding.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of (row, col) in a swizzled [rows, W] tile; W a multiple of 64.
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  return row * W + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

// c += a . b on the tensor cores: A 16 x 16, B 16 x 8, C 16 x 8.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ldmatrix addresses. Each lane hands ldmatrix.x4 one 16-byte row segment; its
// byte offset in a swizzled tile is row * 2W + ((chunk ^ (row % 8)) * 16).
// Fragments start at rows that are multiples of 8 and at columns c0 that are
// multiples of 16, so for the fragment at (r0, c0) the offset is
//   r0 * 2W + (lane_off ^ (c0 * 2)),
// with lane_off the lane's offset for the fragment at (0, 0): one xor with a
// constant per fragment, and r0 * 2W folds into the instruction's immediate.
// (lane_off ^ (c0 * 2) stays below 2W, inside the row.)

// A (16 x 16) from rows r0.., cols c0.. of a row-major tile.
template <int W>
__device__ __forceinline__ uint32_t lane_off_a(int lane) {
  const int row = lane & 15;
  return row * 2 * W + (((lane >> 4) ^ (row & 7)) << 4);
}

// Two n-tiles of B at depth k0.. where B[k][n] = tile[n][k] (the operand of
// x . tile^T): rows n0..n0+15, cols k0..k0+15.
template <int W>
__device__ __forceinline__ uint32_t lane_off_b_rows(int lane) {
  const int row = (lane & 7) + ((lane >> 4) << 3);
  return row * 2 * W + ((((lane >> 3) & 1) ^ (row & 7)) << 4);
}

// Two n-tiles of B at depth k0.. where B[k][n] = tile[k][n] (the operand of
// x . tile), read transposed: rows k0..k0+15, cols n0..n0+15.
template <int W>
__device__ __forceinline__ uint32_t lane_off_b_cols(int lane) {
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
  return row * 2 * W + (((lane >> 4) ^ (row & 7)) << 4);
}

// A fragment at (r0, k0); `tile` is the tile's shared-memory address.
template <int W>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t tile, uint32_t off, int r0,
                                       int k0) {
  ldmatrix_x4(a, tile + r0 * 2 * W + (off ^ (k0 * 2)));
}

// B fragments of n-tiles n0.. and n0+8.. (b[0..1], b[2..3]) at depth k0.. of
// x . tile^T.
template <int W>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], uint32_t tile, uint32_t off, int n0,
                                            int k0) {
  ldmatrix_x4(b, tile + n0 * 2 * W + (off ^ (k0 * 2)));
}

// B fragments of n-tiles n0.. and n0+8.. at depth k0.. of x . tile.
template <int W>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4], uint32_t tile, uint32_t off, int k0,
                                            int n0) {
  ldmatrix_x4_trans(b, tile + k0 * 2 * W + (off ^ (n0 * 2)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (depth 16) made of C tiles c_lo (cols 0-7) and c_hi (8-15).
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c_lo)[4],
                                         const float (&c_hi)[4]) {
  a[0] = pack_bf16(c_lo[0], c_lo[1]);
  a[1] = pack_bf16(c_lo[2], c_lo[3]);
  a[2] = pack_bf16(c_hi[0], c_hi[1]);
  a[3] = pack_bf16(c_hi[2], c_hi[3]);
}

// Max and sum over the 4 lanes (t = 0..3) that share a row of a C tile.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the special-function unit (2 ulp; exp2(-inf) = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte global -> shared copy that bypasses L1; with pred false it reads
// nothing and writes 16 zero bytes (the src-size operand is 0).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

// 4-byte copy, zero-filled when pred is false.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of rows r0..r0+ROWS-1 (row stride `stride` elements, W
// contiguous columns) from global memory into a swizzled [ROWS, W] tile;
// rows at or past `nrows` become zeros. THREADS threads take part.
template <int ROWS, int W, int THREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long stride, int r0, int nrows) {
  constexpr int CPR = W / 8;             // 16-byte chunks per row
  constexpr int RSTEP = THREADS / CPR;   // rows the block covers per round
  static_assert(THREADS % CPR == 0 && ROWS % RSTEP == 0, "tile must split evenly");
  const int r = threadIdx.x / CPR;
  const int c = (threadIdx.x % CPR) * 8;
  const __nv_bfloat16* from = src + (long long)(r0 + r) * stride + c;
  const uint32_t to = smem_u32(dst);
#pragma unroll
  for (int it = 0; it < ROWS / RSTEP; ++it) {
    const int rr = r + it * RSTEP;
    const bool ok = r0 + rr < nrows;
    cp_async_16(to + swz<W>(rr, c) * 2, ok ? from + it * RSTEP * stride : src, ok);
  }
}

// Writes a warp's 16 rows (row0.. of a swizzled [*, W] tile in shared memory)
// to global rows grow0.. (row stride `stride`) with 16-byte stores; rows at or
// past `nrows` are left alone.
template <int W>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long stride,
                                           const __nv_bfloat16* tile, int row0, int grow0,
                                           int nrows, int lane) {
  constexpr int CPR = W / 8;
#pragma unroll
  for (int it = 0; it < 16 * CPR / 32; ++it) {
    const int i = it * 32 + lane;
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    if (grow0 + r < nrows)
      *reinterpret_cast<uint4*>(dst + (long long)(grow0 + r) * stride + c) =
          *reinterpret_cast<const uint4*>(tile + swz<W>(row0 + r, c));
  }
}

// Puts a warp's 16 x W f32 accumulator (W / 8 C tiles), times `mul`, as bf16
// into rows row0..row0+15 of a swizzled tile.
template <int W>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile, const float (&acc)[W / 8][4],
                                           int row0, float mul_lo, float mul_hi, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < W / 8; ++n) {
    const int col = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(tile + swz<W>(row0 + g, col)) =
        pack_bf16(acc[n][0] * mul_lo, acc[n][1] * mul_lo);
    *reinterpret_cast<uint32_t*>(tile + swz<W>(row0 + g + 8, col)) =
        pack_bf16(acc[n][2] * mul_hi, acc[n][3] * mul_hi);
  }
}

}  // namespace attn_sm90
