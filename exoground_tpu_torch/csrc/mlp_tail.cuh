// The parts the CUDA-core MLP kernels share (csrc/fused_mlp_int8.cu and the
// block kernels of csrc/block_mlp.cu; csrc/fused_mlp.cu used them until its
// tensor-core redesign and no longer includes this header): the CTA shape,
// and the c_proj half of one hidden chunk with the final store.
// A CTA of kMlpThreads threads owns kMlpRows rows
// and 32*NJ output columns; thread (ty, tx) = (tid / 32, tid % 32) owns rows
// ty + 8*i (i < 4) and columns n0 + tx + 32*j. Counterpart of the TPU
// kernels' shared second product (exoground_tpu/ops/fused_mlp.py:140-146).
#pragma once

#include <cstddef>

#include "common.cuh"

namespace exo {

constexpr int kMlpThreads = 256;
constexpr int kMlpRows = 32;  // rows of x per CTA
constexpr int kMlpHC = 64;    // hidden columns per chunk
constexpr int kMlpPC = 8;     // hidden sub-chunk of c_proj staged through shared memory

// acc += h . c_proj[n0 : n0 + 32*NJ, c0 : c0 + kMlpHC]^T, with h the chunk's
// hidden (kMlpRows x kMlpHC floats in hs, pitch kMlpHC + 1) and c_proj
// (C, 4C) staged through ps (kMlpPC x (32*NJ + 1) floats); columns past C
// read 0. Called by all threads; ends with a barrier.
template <typename T, int NJ>
__device__ __forceinline__ void mlp_c_proj_chunk(const float* hs, float* ps,
                                                 const T* __restrict__ wpr,
                                                 float (&acc)[4][NJ], int n0, int c0, int C) {
  constexpr int NS = NJ * 32;
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  for (int p0 = 0; p0 < kMlpHC; p0 += kMlpPC) {
    for (int e = tid; e < NS * kMlpPC; e += kMlpThreads) {
      const int n = e / kMlpPC, pp = e % kMlpPC;
      ps[pp * (NS + 1) + n] =
          n0 + n < C ? to_f(wpr[size_t(n0 + n) * 4 * C + c0 + p0 + pp]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int pp = 0; pp < kMlpPC; ++pp) {
      float hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hv[i] = hs[(ty + 8 * i) * (kMlpHC + 1) + p0 + pp];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float w = ps[pp * (NS + 1) + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(hv[i], w, acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// out[r, n] = acc + b_proj[n] (+ res[r, n] when res is not null: the block
// kernels' residual, summed in f32 before the one rounding) for the
// thread's rows below `rows` and columns below C.
template <typename T, int NJ>
__device__ __forceinline__ void mlp_store(const float (&acc)[4][NJ], const T* __restrict__ bpr,
                                          T* __restrict__ out, size_t r0, int rows, int n0,
                                          int C, const T* __restrict__ res = nullptr) {
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = r0 + ty + 8 * i;
    if (r >= size_t(rows)) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + tx + 32 * j;
      if (n >= C) continue;
      float v = acc[i][j] + to_f(bpr[n]);
      if (res) v += to_f(res[r * C + n]);
      out[r * C + n] = from_f<T>(v);
    }
  }
}

}  // namespace exo
