// The bfloat16 GEMM of the wide-head bodies of the fused-MHA family on
// Hopper's warpgroup MMA: y (M x N) = a (M x K) . w (N x K)^T + bias (+ res,
// the block bodies' residual), summed in f32 and rounded to bf16 once. It
// serves the qkv projection (N = 3C) of the wide exact bodies (mha_tile.cuh
// 2d) and the out-projection of every wide bf16 body (mha_tail.cuh
// out_projection) at a head above 64; it replaces no TPU kernel of its own
// (the TPU kernels' qkv and out-projections, attention.py:575-674, run
// inside the MHA kernels), and takes the place of linear_bias_bf16_kernel's
// mma.sync tile there. Its float32 twin (3xTF32 on wgmma .tf32) follows it
// below, for the same products of the wide f32 bodies.
//
// What bounds it on an H100: operations (2*M*N*K FLOPs, 206 GFLOP for the
// qkv at M 8192, N 6144, K 2048, against 2*(M*K + N*K + M*N) bytes: ~1,800
// FLOP/byte, far above the bf16 balance point of ~295). wgmma is the only way
// to the card's full tensor-core rate; mma.sync reached ~190 TFLOP/s there.
//
// Design: a CTA owns a 128 x BN tile of y (BN 256, or 128 where N < 2048)
// and walks K in stages of 64 (one 128-byte row of bf16 a tile row):
//   - one producer warpgroup (setmaxnreg down to 40 registers) whose first
//     thread keeps kStages = 4 stages in flight with cp.async.bulk.tensor
//     (TMA) loads of a's and w's tiles, 128-byte swizzled, each stage's
//     arrival counted in bytes on its "full" mbarrier (expect-tx);
//   - two consumer warpgroups (setmaxnreg up to 232), each owning 64 rows:
//     wgmma.mma_async m64nBNk16 bf16 -> f32 straight from the swizzled
//     tiles (both operands K-major, the layout wgmma takes for both), one
//     stage's products in flight while the previous stage's finish; a stage
//     is handed back on its "empty" mbarrier once its products are done;
//   - the epilogue adds the bias, and the residual read as bf16 pairs, to
//     the f32 sum in registers and rounds once, as linear_bias_bf16_kernel
//     does; rows past M and columns past N are not written. TMA zero-fills
//     loads past the edges (M, N and K tails).
// The tensor maps are encoded on the host for each call, through
// cuTensorMapEncodeTiled reached by cudaGetDriverEntryPoint (no link
// against libcuda), and passed as __grid_constant__ parameters.
// a and w 16-byte aligned with K a multiple of 8 (TMA's 16-byte pitch), N a
// multiple of 8, res 4-byte aligned.
// Each launch is counted where it is made (wg::launches below); every
// library that includes this header exports wgmma_linear_launches(), which
// hands the count to the wrappers and starts it again from 0.
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "tc.cuh"

namespace exo {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;          // tile rows: two consumer warpgroups of 64
constexpr int kBK = 64;           // K a stage: one 128-byte swizzle row of bf16
constexpr int kStages = 4;        // the TMA ring
constexpr int kConsumers = 256;   // two warpgroups
constexpr int kThreads = 384;     // and the producer's

template <int BN>
struct Layout {
  static constexpr int A = kBM * kBK * 2;  // bytes of a's tile a stage
  static constexpr int B = BN * kBK * 2;   // of w's
  static constexpr int STAGE = A + B;
  // the ring, its 2 * kStages mbarriers, and 1 KB to align the ring to the
  // 1024 bytes of the 128-byte swizzle's 8-row period
  static constexpr size_t SMEM = size_t(kStages) * STAGE + 2 * kStages * 8 + 1024;
};

// ---- mbarriers (shared::cta), TMA and wgmma, as inline PTX for sm_90a ----
__device__ __forceinline__ void mbar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(tc::smem_addr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   tc::smem_addr(b)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(tc::smem_addr(b)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(tc::smem_addr(b)), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of the tensor map at (c0 along K, c1 along the rows) into dst,
// counted in bytes on barrier b.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* b, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(tc::smem_addr(b)), "r"(c0), "r"(c1)
      : "memory");
}

// The descriptor of a K-major bf16 tile in the 128-byte swizzle at p (rows
// of 128 bytes, 8-row groups 1024 bytes apart; the leading offset is unused
// there). A k-step of 16 values moves p by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = tc::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0..128) = A . B^T + (scale_d ? d : 0), m64n256k16: bf16 A and B from
// shared memory (descriptors da, db; both K-major), f32 accumulators in
// the wgmma D layout.
__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[0..64) = A . B^T + (scale_d ? d : 0), m64n128k16: bf16 A and B from
// shared memory (descriptors da, db; both K-major), f32 accumulators in
// the wgmma D layout.
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ------------------------------------------------------------------ kernel
// y tile (blockIdx.y, blockIdx.x) = rows m0.. + 128, columns n0.. + BN.
// RES: the block bodies' residual res (row pitch N), read as bf16 pairs.
template <int BN, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
linear_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                    const bf16* __restrict__ bias, const bf16* __restrict__ res,
                    bf16* __restrict__ y, int M, int N, int K) {
  using L = Layout<BN>;
  extern __shared__ unsigned char smem_wg[];
  unsigned char* base = smem_wg + ((1024u - (tc::smem_addr(smem_wg) & 1023u)) & 1023u);
  bf16* as = reinterpret_cast<bf16*>(base);                      // [kStages][kBM][kBK]
  bf16* bs = reinterpret_cast<bf16*>(base + kStages * L::A);     // [kStages][BN][kBK]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * L::STAGE);  // [kStages]
  uint64_t* empty = full + kStages;                                          // [kStages]
  const int grp = threadIdx.x / 128, t = threadIdx.x % 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN, nk = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (grp == kConsumers / 128) {
    // ---- the producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(&full[s], L::STAGE);
        tma_load(as + s * (kBM * kBK), &ta, &full[s], kt * kBK, m0);
        tma_load(bs + s * (BN * kBK), &tw, &full[s], kt * kBK, n0);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: rows grp * 64.. of the tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const bf16* a = as + s * (kBM * kBK) + grp * 64 * kBK;
    const bf16* b = bs + s * (BN * kBK);
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (BN == 256) {
        mma_n256(d, desc_sw128(a + kk * 16), desc_sw128(b + kk * 16), 1);
      } else {
        mma_n128(d, desc_sw128(a + kk * 16), desc_sw128(b + kk * 16), 1);
      }
    }
    wgmma_commit();
    fence_acc(d);
    wgmma_wait<1>();  // stage kt - 1's products are done: hand it back
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_acc(d);

  // ---- epilogue: + bias (+ res) in f32, one rounding to bf16 ----
  const int lane = t % 32, g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + grp * 64 + (t / 32) * 16 + g + 8 * half;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + c;
      if (n >= N) continue;
      float v0 = d[4 * j + 2 * half] + to_f(bias[n]);
      float v1 = d[4 * j + 2 * half + 1] + to_f(bias[n + 1]);
      if constexpr (RES) {
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(res + size_t(m) * N + n));
        v0 += r.x;
        v1 += r.y;
      }
      *reinterpret_cast<uint32_t*>(y + size_t(m) * N + n) = tc::pack_bf16(v0, v1);
    }
  }
}

// ================================================ float32: 3xTF32 on wgmma
// The float32 twin for the same products of the wide f32 bodies: y = a . w^T
// + bias (+ res) summed in f32, every product in 3xTF32 as tc.cuh's
// mma_3xtf32 (x = hi + lo, hi x with its low 13 mantissa bits cleared, lo =
// x - hi exactly, which the tensor core reads as TF32; a_lo w_hi + a_hi w_lo
// + a_hi w_hi, smaller terms first, k-step by k-step). It takes the place
// of linear_bias_tf32_kernel (the 128 x 128 mma.sync 3xTF32 tile of
// mha_tail.cuh) at a head above 64 and replaces no TPU kernel of its own.
//
// What bounds it on an H100: operations, 3 x 2*M*N*K TF32 FLOPs at 495
// TFLOP/s (165 of f32 work; 1.25 ms for the C 2048 qkv, M 8192 N 6144 K
// 2048, against 0.10 ms of bytes).
//
// Design: the bf16 kernel's shape, a CTA owning a 128 x 128 tile of y and
// walking K in stages of 32 f32 (one 128-byte swizzle row), four stages in
// flight:
//   - the producer warpgroup (setmaxnreg 40): its first thread issues the
//     TMA loads of a's and w's tiles, 128-byte swizzled, counted in bytes
//     on the stage's "full" mbarrier; its other three warps split w's tile
//     in place into hi and into a lo tile beside it (the same swizzled
//     layout), fence the generic-proxy writes for the async proxy
//     (fence.proxy.async.shared::cta) and arrive on the stage's "ready"
//     mbarrier. The weights are split as they stream, and no second copy
//     of them is kept;
//   - two consumer warpgroups (setmaxnreg 232) of 64 rows: a's fragments
//     read from the swizzled tile and split in registers, then wgmma
//     m64n128k8 .tf32 three times a k-step with a from registers and w's hi
//     and lo tiles from shared memory (K-major, the only layout wgmma takes
//     for tf32); the stage's products are waited on before the registers
//     are reused and the stage goes back to the producer on its "empty"
//     mbarrier. (On an H100 this beat a's hi and lo tiles split into
//     shared memory too, and matched a 128 x 256 tile.)
//   - each stage's products start a fresh wgmma sum that is then added to
//     the f32 sum in registers: the tensor cores add into their
//     accumulator truncating, so a sum kept in them over all of K drifts
//     with K (past the f32 limit of 1e-4 of max|y| at K 8320: chip_smoke's
//     head of 520), where K / 32 rounded adds keep it at float32's;
//   - the epilogue adds the bias, then the residual, to the f32 sum, as
//     linear_bias_tf32_kernel does; rows past M and columns past N are not
//     written. TMA zero-fills past the edges (M, N, K tails).
// Each launch is counted where it is made (wg::launches_tf32); the libraries
// export wgmma_linear_tf32_launches() beside wgmma_linear_launches().
constexpr int kBKf = 32;          // f32 K a stage: one 128-byte swizzle row
constexpr int kBNf = 128;         // tile columns
constexpr int kSplitters = 96;    // the producer warpgroup's warps 1-3

struct LayoutF {
  static constexpr int A = kBM * kBKf * 4;   // bytes of a's tile a stage (16 KB)
  static constexpr int B = kBNf * kBKf * 4;  // of w's, and of its lo tile
  static constexpr int STAGE = A + 2 * B;
  static constexpr int STAGES = 4;
  static constexpr size_t SMEM = size_t(STAGES) * STAGE + 3 * STAGES * 8 + 1024;
};

// The offset of element (r, c) of a tile of 128-byte rows in the 128-byte
// swizzle (16-byte chunk c / 4 of row r at chunk (c / 4) ^ (r % 8)), in
// floats.
__device__ __forceinline__ int swz32(int r, int c) {
  return r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d = A . B^T + (scale_d ? d : 0), tf32, m64n128k8: A from registers (the
// m16n8k8 A fragment of each warp's 16 rows: a0 = A[g][t], a1 = A[g+8][t],
// a2 = A[g][t+4], a3 = A[g+8][t+4]), B from shared memory (descriptor db,
// K-major); f32 accumulators in the wgmma D layout.
__device__ __forceinline__ void mma_tf32_n128_rs(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// x = hi + lo over n float4s at p (hi in place, lo at q): tc::split_tf32
__device__ __forceinline__ void split_tile(float4* p, float4* q, int n, int i0, int step) {
  for (int e = i0; e < n; e += step) {
    const float4 x = p[e];
    uint32_t h[4], l[4];
    tc::split_tf32(x.x, h[0], l[0]);
    tc::split_tf32(x.y, h[1], l[1]);
    tc::split_tf32(x.z, h[2], l[2]);
    tc::split_tf32(x.w, h[3], l[3]);
    p[e] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                       __uint_as_float(h[3]));
    q[e] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                       __uint_as_float(l[3]));
  }
}

// y tile (blockIdx.y, blockIdx.x) = rows m0.. + 128, columns n0.. + 128.
// RES: the block bodies' residual res (row pitch N), read as float2.
template <bool RES>
__global__ void __launch_bounds__(kThreads, 1)
linear_tf32_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tw, const float* __restrict__ bias,
                         const float* __restrict__ res, float* __restrict__ y, int M, int N,
                         int K) {
  using L = LayoutF;
  constexpr int NS = L::STAGES;
  extern __shared__ unsigned char smem_wf[];
  unsigned char* base = smem_wf + ((1024u - (tc::smem_addr(smem_wf) & 1023u)) & 1023u);
  // stage s: a's tile [128][32], w's [128][32], w's lo tile [128][32]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + NS * L::STAGE);  // [NS]
  uint64_t* ready = full + NS;                                         // [NS]
  uint64_t* empty = ready + NS;                                        // [NS]
  const int grp = threadIdx.x / 128, t = threadIdx.x % 128;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBNf, nk = (K + kBKf - 1) / kBKf;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], kSplitters);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (grp == kConsumers / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t < 32) {
      // ---- the loads: one thread issues them ----
      if (t == 0) {
        for (int kt = 0; kt < nk; ++kt) {
          const int s = kt % NS;
          unsigned char* st = base + s * L::STAGE;
          mbar_wait(&empty[s], ((kt / NS) & 1) ^ 1);  // the first round passes at once
          mbar_expect_tx(&full[s], L::A + L::B);
          tma_load(st, &ta, &full[s], kt * kBKf, m0);
          tma_load(st + L::A, &tw, &full[s], kt * kBKf, n0);
        }
      }
    } else {
      // ---- the splits of w's tiles: warps 1-3 ----
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % NS;
        unsigned char* st = base + s * L::STAGE;
        mbar_wait(&full[s], (kt / NS) & 1);
        split_tile(reinterpret_cast<float4*>(st + L::A),
                   reinterpret_cast<float4*>(st + L::A + L::B), L::B / 16, t - 32, kSplitters);
        fence_proxy_async();  // the generic writes, before wgmma reads them
        mbar_arrive(&ready[s]);
      }
    }
    return;
  }

  // ---- the consumer warpgroups: rows grp * 64.. of the tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  float acc[kBNf / 2], d[kBNf / 2];  // the f32 sum; a stage's wgmma sum
#pragma unroll
  for (int i = 0; i < kBNf / 2; ++i) acc[i] = d[i] = 0.f;
  const int lane = t % 32, g = lane / 4, c = 2 * (lane % 4);
  const int r0 = grp * 64 + (t / 32) * 16 + g, tq = lane % 4;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % NS;
    const unsigned char* st = base + s * L::STAGE;
    mbar_wait(&full[s], (kt / NS) & 1);
    mbar_wait(&ready[s], (kt / NS) & 1);
    const float* at = reinterpret_cast<const float*>(st);
    const float* bh = reinterpret_cast<const float*>(st + L::A);
    const float* bl = reinterpret_cast<const float*>(st + L::A + L::B);
    uint32_t ahi[kBKf / 8][4], alo[kBKf / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBKf / 8; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = at[swz32(r0 + 8 * (i & 1), kk * 8 + tq + 4 * (i >> 1))];
        tc::split_tf32(x, ahi[kk][i], alo[kk][i]);
      }
    }
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKf / 8; ++kk) {
      mma_tf32_n128_rs(d, alo[kk], desc_sw128(bh + kk * 8), kk > 0);  // a fresh sum a stage
      mma_tf32_n128_rs(d, ahi[kk], desc_sw128(bl + kk * 8), 1);
      mma_tf32_n128_rs(d, ahi[kk], desc_sw128(bh + kk * 8), 1);
    }
    wgmma_commit();
    fence_acc(d);
    wgmma_wait<0>();  // the A registers are read until the products finish
    fence_acc(d);
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < kBNf / 2; ++i) acc[i] += d[i];
  }

  // ---- epilogue: + bias, then + res, in f32 ----
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + grp * 64 + (t / 32) * 16 + g + 8 * half;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kBNf / 8; ++j) {
      const int n = n0 + 8 * j + c;
      if (n >= N) continue;
      float v0 = acc[4 * j + 2 * half] + bias[n];
      float v1 = acc[4 * j + 2 * half + 1] + bias[n + 1];
      if constexpr (RES) {
        const float2 r = *reinterpret_cast<const float2*>(res + size_t(m) * N + n);
        v0 += r.x;
        v1 += r.y;
      }
      *reinterpret_cast<float2*>(y + size_t(m) * N + n) = make_float2(v0, v1);
    }
  }
}

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once (null where libcuda has none).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a (rows x K) bf16 (or, f32, float32) matrix of row pitch K
// in boxes of 128 bytes of K x box_rows, 128-byte swizzled, zero-filled past
// its edges.
inline cudaError_t tensor_map(CUtensorMap* map, const void* p, int rows, int K, int box_rows,
                              bool f32 = false) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const size_t elem = f32 ? sizeof(float) : sizeof(bf16);
  const cuuint64_t dims[2] = {cuuint64_t(K), cuuint64_t(rows)};
  const cuuint64_t pitch[1] = {cuuint64_t(K) * elem};
  const cuuint32_t box[2] = {cuuint32_t(f32 ? kBKf : kBK), cuuint32_t(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, const_cast<void*>(p), dims, pitch, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The GEMM's launches in this library since the last wgmma_linear_launches()
// (internal linkage: each library keeps its own).
static std::atomic<int> launches{0};

template <int BN>
inline cudaError_t launch(const void* a, const void* w, const void* bias, void* y, int M, int N,
                          int K, cudaStream_t st, const void* res) {
  CUtensorMap ta, tw;
  cudaError_t err = tensor_map(&ta, a, M, K, kBM);
  if (err == cudaSuccess) err = tensor_map(&tw, w, N, K, BN);
  if (err != cudaSuccess) return err;
  auto kernel = res ? linear_wgmma_kernel<BN, true> : linear_wgmma_kernel<BN, false>;
  err = allow_smem(kernel, Layout<BN>::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + BN - 1) / BN, (M + kBM - 1) / kBM), kThreads, Layout<BN>::SMEM, st>>>(
      ta, tw, static_cast<const bf16*>(bias), static_cast<const bf16*>(res), static_cast<bf16*>(y),
      M, N, K);
  err = cudaGetLastError();
  if (err == cudaSuccess) launches.fetch_add(1, std::memory_order_relaxed);
  return err;
}

// y (M x N) = a (M x K) . w (N x K)^T + bias (+ res) in bf16 (see the top).
inline cudaError_t linear(const void* a, const void* w, const void* bias, void* y, int M, int N,
                          int K, cudaStream_t st, const void* res = nullptr) {
  if (!tc::aligned16(a) || !tc::aligned16(w)) return cudaErrorMisalignedAddress;
  if (res && reinterpret_cast<uintptr_t>(res) % 4) return cudaErrorMisalignedAddress;
  if (M < 1 || N % 8 || K % 8 || N < 8 || K < 8) return cudaErrorInvalidValue;
  return N >= 2048 ? launch<256>(a, w, bias, y, M, N, K, st, res)
                   : launch<128>(a, w, bias, y, M, N, K, st, res);
}

// The f32 GEMM's launches since the last wgmma_linear_tf32_launches().
static std::atomic<int> launches_tf32{0};

// y (M x N) = a (M x K) . w (N x K)^T + bias (+ res) in float32 (3xTF32; see
// the f32 kernel's note). a and w 16-byte aligned, N and K multiples of 8,
// res 8-byte aligned.
inline cudaError_t linear_tf32(const void* a, const void* w, const void* bias, void* y, int M,
                               int N, int K, cudaStream_t st, const void* res = nullptr) {
  if (!tc::aligned16(a) || !tc::aligned16(w)) return cudaErrorMisalignedAddress;
  if (res && reinterpret_cast<uintptr_t>(res) % 8) return cudaErrorMisalignedAddress;
  if (M < 1 || N % 8 || K % 8 || N < 8 || K < 8) return cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  cudaError_t err = tensor_map(&ta, a, M, K, kBM, true);
  if (err == cudaSuccess) err = tensor_map(&tw, w, N, K, kBNf, true);
  if (err != cudaSuccess) return err;
  auto kernel = res ? linear_tf32_wgmma_kernel<true> : linear_tf32_wgmma_kernel<false>;
  err = allow_smem(kernel, LayoutF::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((N + kBNf - 1) / kBNf, (M + kBM - 1) / kBM), kThreads, LayoutF::SMEM, st>>>(
      ta, tw, static_cast<const float*>(bias), static_cast<const float*>(res),
      static_cast<float*>(y), M, N, K);
  err = cudaGetLastError();
  if (err == cudaSuccess) launches_tf32.fetch_add(1, std::memory_order_relaxed);
  return err;
}

}  // namespace wg
}  // namespace exo

// The GEMM's launches in this library since the last call (the wrappers
// count them under wgmma_linear after each call that may launch it).
// Launches from two threads at once are all counted, though either call may
// take the other's.
extern "C" int wgmma_linear_launches() { return exo::wg::launches.exchange(0); }

// The f32 GEMM's launches in this library since the last call.
extern "C" int wgmma_linear_tf32_launches() { return exo::wg::launches_tf32.exchange(0); }
