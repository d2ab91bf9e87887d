// Tensor-core building blocks of the port's kernels (flash_attn.cu,
// fused_mha.cu, small_attn.cu, the out-projection of mha_tail.cuh and the
// MLP family's mlp_tile.cuh), written as inline PTX for sm_90a:
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, its operands from
//   shared memory through ldmatrix (.trans for an operand stored k-major), and
//   16-byte cp.async copies into shared memory (zero-filled past the data);
//   mma.sync m16n8k32 .s8 (int32 sums), whose fragments are the bf16 ones
//   with each b16 holding two int8 values; and 3xTF32 (m16n8k8 .tf32 with
//   hi/lo operand splits), float32 accuracy on the tensor cores.
//
// Fragment layout of one m16n8k16 product (lane = threadIdx.x % 32,
// g = lane / 4, c = 2 * (lane % 4)):
//   A (16 x 16, row-major): a0 = A[g][c..c+1], a1 = A[g+8][c..c+1],
//                           a2 = A[g][c+8..c+9], a3 = A[g+8][c+8..c+9];
//   B (16 x 8, k x n):      b0 = B[c..c+1][g], b1 = B[c+8..c+9][g];
//   C (16 x 8, f32):        c0, c1 = C[g][c..c+1], c2, c3 = C[g+8][c..c+1].
// So the C fragments of two neighbouring n-tiles, rounded and packed two by
// two, are the A fragment of one k-step: a product's output feeds the next
// product from registers, with no shared-memory round trip.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>

namespace exo {
namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lane t gives the address of row t % 8 of matrix
// t / 8, and register i receives matrix i in the A/B fragment layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way (an operand stored k-major).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two matrices (lanes 0-15 give the addresses; the others' are ignored but
// must be valid shared addresses).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a . b on the tensor cores, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on the tensor cores, int8 operands, exact int32 sums (m16n8k32).
// The fragments of a 16 x 32 int8 A tile (row-major) and a 32 x 8 B tile
// stored n-major (k contiguous) are those of m16n8k16 above with each b16
// read as two int8 values: a0 = A[g][4t..4t+3], a1 = A[g+8][4t..], a2 =
// A[g][16+4t..], a3 = A[g+8][16+4t..]; b0 = B[4t..4t+3][g], b1 =
// B[16+4t..][g] (t = lane % 4). So ldsm_x4 on the int8 tile seen as b16
// (half the columns, the same byte pitch) loads them; C as m16n8k16's.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- 3xTF32: float32 products on the tensor cores ----
// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a bit mask; the
// rounding conversion cost ~20% of the fused MLP's time), lo = x - hi
// exactly, which the tensor core truncates to TF32 (it reads the top 19
// bits); then d += a_lo b_hi + a_hi b_lo + a_hi b_hi. The dropped a_lo b_lo
// term and the truncation of a_lo are each below 2^-20 of a product, so the
// sum keeps float32 accuracy (plain TF32, ~2^-10, does not) at 3 x FLOPs /
// 495 TFLOP/s rather than FLOPs / 67 on the CUDA cores.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b, m16n8k8, TF32 operands, f32 accumulators. Fragments (g = lane /
// 4, t = lane % 4): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 =
// A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; C as m16n8k16's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 8) and B fragment (8 x 8), each split into TF32 halves
struct Tf32A {
  uint32_t hi[4], lo[4];
};
struct Tf32B {
  uint32_t hi[2], lo[2];
};

// the A fragment of rows 0.. of a row-major f32 tile at pitch p (read as
// 32-bit words; a pitch of 4 floats more than the data is conflict-free)
__device__ __forceinline__ Tf32A load_a_tf32(const float* t, int p, int lane) {
  const int g = lane / 4, c = lane % 4;
  Tf32A a;
  split_tf32(t[g * p + c], a.hi[0], a.lo[0]);
  split_tf32(t[(g + 8) * p + c], a.hi[1], a.lo[1]);
  split_tf32(t[g * p + c + 4], a.hi[2], a.lo[2]);
  split_tf32(t[(g + 8) * p + c + 4], a.hi[3], a.lo[3]);
  return a;
}

// the B fragment of an n-major f32 tile (rows n, columns k) at pitch p
__device__ __forceinline__ Tf32B load_b_tf32(const float* t, int p, int lane) {
  const float* w = t + (lane / 4) * p + lane % 4;
  Tf32B b;
  split_tf32(w[0], b.hi[0], b.lo[0]);
  split_tf32(w[4], b.hi[1], b.lo[1]);
  return b;
}

// d += a . b in 3xTF32, smaller terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Tf32A& a, const Tf32B& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// This lane's ldmatrix row and column inside a 16 x 16 block of a row-major
// tile: as the A operand (rows 0-7 / 8-15 by lane bit 3, columns 0-7 / 8-15
// by bit 4; the same offsets serve a transposed B operand stored k-major,
// whose rows are k) and as a non-transposed B operand of two n-tiles stored
// n-major (n-tile by bit 4, k half by bit 3).
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + (lane & 8); }
__device__ __forceinline__ int a_col(int lane) { return (lane & 16) >> 1; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane & 16) >> 1); }
__device__ __forceinline__ int b_col(int lane) { return lane & 8; }

// Max and sum over the 4 lanes of a quad: the lanes that hold one row of a
// C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two f32 values rounded to bf16 (nearest even) and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes from global to shared memory, asynchronously; with full == false
// nothing is read and the 16 bytes are zero-filled (src must still be a
// valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a tile of `rows` rows of `width` bf16 values (width a multiple of 8)
// from src (row pitch ld elements, rows r0.. of a matrix of n_rows rows and
// n_cols valid columns, n_cols a multiple of 8) into shared memory dst (row
// pitch pitch elements), zero-filling rows past n_rows and columns past
// n_cols. Called by all nthreads threads of the CTA.
template <int rows, int width, int nthreads>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, int pitch,
                                        const __nv_bfloat16* src, int ld, int r0, int n_rows,
                                        int c0, int n_cols) {
  constexpr int kChunks = width / 8;
  for (int e = threadIdx.x; e < rows * kChunks; e += nthreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool in = r0 + r < n_rows && c0 + c < n_cols;
    const __nv_bfloat16* s = in ? src + size_t(r0 + r) * ld + c0 + c : src;
    cp_async16(dst + r * pitch + c, s, in);
  }
}

// True when p is 16-byte aligned (what cp.async needs).
__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace tc
}  // namespace exo
