// Shared helpers of the port's CUDA kernels: float/bf16 conversion, the
// dynamic shared-memory cap, int8 row quantization, the block kernels'
// float32 LayerNorm.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace exo {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Raise a kernel's dynamic shared-memory cap, then launch nothing: callers
// launch right after and return cudaGetLastError().
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---- int8 row quantization (the TPU kernels' _quant_rows_f32) ----
// The sources build without --use_fast_math, so '/' is the IEEE quotient
// and matches the port's plain versions bit for bit.

// A row's scale: absmax / 127 where absmax > 0, else 1.
__device__ __forceinline__ float row_scale(float absmax) {
  return absmax > 0.f ? absmax / 127.f : 1.f;
}

// clip(round_half_even(v / s), -127, 127)
__device__ __forceinline__ int quant_i8(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

// Four consecutive values quantized with scale s, packed into one word (the
// lowest address in the low byte, as int8 memory reads back): a __dp4a
// operand, or four values of an int8 tile in shared memory.
template <typename T>
__device__ __forceinline__ int quant_pack4(const T* p, float s) {
  int w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= (quant_i8(to_f(p[i]), s) & 0xff) << (8 * i);
  return w;
}

// float(acc) * xs * ws + b, each step rounded on its own (no FMA
// contraction), in the JAX kernels' order.
__device__ __forceinline__ float dequant(int acc, float xs, float ws, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), b);
}

// absmax of a row of n values read by the 32 lanes of a warp (all lanes
// return it)
template <typename T>
__device__ __forceinline__ float warp_absmax(const T* row, int n, int lane) {
  float m = 0.f;
  for (int k = lane; k < n; k += 32) m = fmaxf(m, fabsf(to_f(row[k])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// ---- LayerNorm in f32 (the TPU block kernels' _layernorm_f32) ----

constexpr float kLnEps = 1e-5f;  // torch LayerNorm default

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The statistics of a row of n values read by the 32 lanes of a warp: mean =
// sum / n, then the mean of the squared deviations (a second pass), rstd =
// 1 / sqrt(var + eps), IEEE quotient and root. Every lane returns them, and
// every CTA that reads the row gets the same values.
template <typename T>
__device__ __forceinline__ void warp_ln_stats(const T* row, int n, int lane, float& mean,
                                              float& rstd) {
  float s = 0.f;
  for (int k = lane; k < n; k += 32) s += to_f(row[k]);
  mean = warp_sum(s) / static_cast<float>(n);
  float v = 0.f;
  for (int k = lane; k < n; k += 32) {
    const float d = to_f(row[k]) - mean;
    v = fmaf(d, d, v);
  }
  rstd = 1.f / sqrtf(warp_sum(v) / static_cast<float>(n) + kLnEps);
}

// (x - mean) * rstd * g + b in f32, each step rounded on its own (no FMA
// contraction), in the plain version's order
__device__ __forceinline__ float ln_apply(float x, float mean, float rstd, float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), g), b);
}

// absmax over a row of the f32 LayerNorm output (g, b: the LN weight and
// bias), read by the 32 lanes of a warp (all lanes return it)
template <typename T>
__device__ __forceinline__ float warp_ln_absmax(const T* row, const T* g, const T* b, int n,
                                                int lane, float mean, float rstd) {
  float m = 0.f;
  for (int k = lane; k < n; k += 32) {
    m = fmaxf(m, fabsf(ln_apply(to_f(row[k]), mean, rstd, to_f(g[k]), to_f(b[k]))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Four consecutive f32 LayerNorm outputs quantized with scale s and packed
// as quant_pack4 (p, g, b point at the same column; g and b in
// T or already in f32)
template <typename T, typename P>
__device__ __forceinline__ int ln_quant_pack4(const T* p, const P* g, const P* b, float mean,
                                              float rstd, float s) {
  int w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = ln_apply(to_f(p[i]), mean, rstd, to_f(g[i]), to_f(b[i]));
    w |= (quant_i8(v, s) & 0xff) << (8 * i);
  }
  return w;
}

}  // namespace exo
