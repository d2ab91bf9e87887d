// The tail the fused-MHA family shares (mha_tile.cuh's bodies, under
// csrc/fused_mha.cu, fused_mha_int8.cu, block_attn.cu and block_attn_int8.cu):
// the per-window attention of the f32 (window, head) CTAs and the tiled
// out-projection. Counterpart of the TPU kernels' shared
// _mha_attention_tail (exoground_tpu/ops/attention.py:575).
//
// The out-projection has two bodies. float32: linear_bias_kernel, a 64 x 64
// f32 GEMM on the CUDA cores (the first design, kept as it was). bfloat16: a
// tensor-core GEMM, linear_bias_bf16_kernel: 128 x 128 output tiles, 8 warps
// of 64 x 32, mma.sync m16n8k16 (bf16 in, f32 accumulated) fed by ldmatrix
// from a two-stage cp.async ring of 32-wide K chunks (row pitch 40 elements,
// so an ldmatrix touches 8 distinct bank groups), the bias (and the block
// bodies' residual, read as bf16 pairs: x 4-byte aligned) added to the f32
// sum before the one rounding. It serves
// every bf16 body of the family. K = C spans every head, so the heads are
// summed inside one dot product, with no atomics. It needs the attn scratch
// and W_out 16-byte aligned (cp.async) and returns cudaErrorMisalignedAddress
// otherwise.
#pragma once

#include <cfloat>
#include <cstddef>

#include "common.cuh"
#include "tc.cuh"

namespace exo {

constexpr float kMhaNegInf = -1e30f;  // finite fill, as attention_plain's NEG_INF

// Attention of one head over one window from q, k, v (S rows of pitch qp,
// float32, in shared memory): scores and softmax in ps (S x S floats of
// shared memory), masked by km (nonzero at padding keys), o_h rounded to T
// into ob (row pitch C). A window whose keys are all padding averages its own
// S values uniformly, as attention_plain does with its finite -1e30 fill.
// DHC: the head size when fixed at compile time, else 0 and it is dh.
// Called by all kThreads threads of the CTA; ends without a barrier.
template <typename T, int DHC, int kThreads>
__device__ __forceinline__ void window_attention(const float* qs, const float* ks,
                                                 const float* vs, int qp, float* ps,
                                                 const int* km, T* ob, int S, int C,
                                                 int dh, float scale) {
  const int DH = DHC ? DHC : dh;
  const int tid = threadIdx.x;
  // ---- scores, masked by key padding ----
  for (int e = tid; e < S * S; e += kThreads) {
    const int i = e / S, j = e % S;
    const float* q = qs + i * qp;
    const float* k = ks + j * qp;
    float dot = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) dot = fmaf(q[d], k[d], dot);
    ps[e] = km[j] ? kMhaNegInf : dot * scale;
  }
  __syncthreads();

  // ---- row softmax, one warp per row ----
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < S; i += kThreads / 32) {
    float* row = ps + i * S;
    float m = -FLT_MAX;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      float p = expf(row[j] - m);
      row[j] = p;
      l += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    for (int j = lane; j < S; j += 32) row[j] = row[j] / l;
  }
  __syncthreads();

  // ---- o_h = p . v_h into the (B*S, C) scratch ----
  for (int e = tid; e < S * DH; e += kThreads) {
    const int i = e / DH, d = e % DH;
    const float* p = ps + i * S;
    float o = 0.f;
    for (int j = 0; j < S; ++j) o = fmaf(p[j], vs[j * qp + d], o);
    ob[size_t(i) * C + d] = from_f<T>(o);
  }
}

// y[m, n] = sum_k a[m, k] * w[n, k] + bias[n] (+ res[m, n] when res is not
// null: the block bodies' residual, summed in f32 before the one rounding);
// one 64x64 tile per CTA of 256 threads. Heads are summed inside one dot
// product, so the out-projection does not depend on scheduling (no atomics
// across heads).
template <typename T>
__global__ void __launch_bounds__(256)
linear_bias_kernel(const T* __restrict__ a, const T* __restrict__ w,
                   const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ y,
                   int M, int N, int K) {
  constexpr int KC = 32;
  __shared__ float as[KC][65];
  __shared__ float bs[KC][65];
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * 64;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int e = tid; e < 64 * KC; e += 256) {
      const int r = e / KC, kk = e % KC, k = k0 + kk;
      const int m = m0 + r, n = n0 + r;
      as[kk][r] = (m < M && k < K) ? to_f(a[size_t(m) * K + k]) : 0.f;
      bs[kk][r] = (n < N && k < K) ? to_f(w[size_t(n) * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j] + to_f(bias[n]);
      if (res) v += to_f(res[size_t(m) * N + n]);
      y[size_t(m) * N + n] = from_f<T>(v);
    }
  }
}

// The out-projection of a fused MHA: out (M x C) = attn . W_out^T + b_out
// (+ res, the block bodies' residual x, when given).
template <typename T>
inline cudaError_t out_projection(const void* attn, const void* w_out, const void* b_out,
                                  void* out, int M, int C, cudaStream_t st,
                                  const void* res = nullptr) {
  const dim3 grid((M + 63) / 64, (C + 63) / 64);
  linear_bias_kernel<T><<<grid, 256, 0, st>>>(
      static_cast<const T*>(attn), static_cast<const T*>(w_out),
      static_cast<const T*>(b_out), static_cast<const T*>(res), static_cast<T*>(out), M, C,
      C);
  return cudaGetLastError();
}

// y = a . w^T + bias (+ res) for bf16: the tensor-core body (see the note at
// the top). A CTA owns a 128 x 128 tile of y; warp (wm, wn) = (warp / 4,
// warp % 4) owns its rows wm * 64.. + 64 and columns wn * 32.. + 32. Rows
// past M, columns past N and K past its end are zero-filled as they are
// staged (K and N multiples of 8).
constexpr int kLinBM = 128, kLinBN = 128, kLinBK = 32, kLinPitch = kLinBK + 8;

// RES: the block bodies' residual res (row pitch N, 4-byte aligned), read
// as bf16 pairs; without it the epilogue is the plain bias add.
template <bool RES>
__global__ void __launch_bounds__(256)
linear_bias_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ w,
                        const __nv_bfloat16* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ res, __nv_bfloat16* __restrict__ y,
                        int M, int N, int K) {
  using tc::ldsm_x4;
  using tc::mma;
  __shared__ __align__(16) __nv_bfloat16 as[2][kLinBM * kLinPitch];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kLinBN * kLinPitch];
  const int m0 = blockIdx.x * kLinBM, n0 = blockIdx.y * kLinBN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, c = 2 * (lane % 4);
  const int ar = tc::a_row(lane), ac = tc::a_col(lane), br = tc::b_row(lane),
            bc = tc::b_col(lane);
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nch = (K + kLinBK - 1) / kLinBK;
  tc::cp_tile<kLinBM, kLinBK, 256>(as[0], kLinPitch, a, K, m0, M, 0, K);
  tc::cp_tile<kLinBN, kLinBK, 256>(bs[0], kLinPitch, w, K, n0, N, 0, K);
  tc::cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch & 1;
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (ch + 1 < nch) {
      const int k0 = (ch + 1) * kLinBK;
      tc::cp_tile<kLinBM, kLinBK, 256>(as[st ^ 1], kLinPitch, a, K, m0, M, k0, K);
      tc::cp_tile<kLinBN, kLinBK, 256>(bs[st ^ 1], kLinPitch, w, K, n0, N, k0, K);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kLinBK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], as[st] + (wm * 64 + mt * 16 + ar) * kLinPitch + kk * 16 + ac);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, bs[st] + (wn * 32 + np * 16 + br) * kLinPitch + kk * 16 + bc);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma(acc[mt][2 * np], af[mt], b[0], b[1]);
          mma(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + mt * 16 + g + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + c;
        if (n >= N) continue;
        float v0 = acc[mt][nt][2 * half] + to_f(bias[n]);
        float v1 = acc[mt][nt][2 * half + 1] + to_f(bias[n + 1]);
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

// bf16: the tensor-core body.
template <>
inline cudaError_t out_projection<__nv_bfloat16>(const void* attn, const void* w_out,
                                                 const void* b_out, void* out, int M, int C,
                                                 cudaStream_t st, const void* res) {
  if (!tc::aligned16(attn) || !tc::aligned16(w_out)) return cudaErrorMisalignedAddress;
  if (res && reinterpret_cast<uintptr_t>(res) % 4) return cudaErrorMisalignedAddress;
  if (C % 8) return cudaErrorInvalidValue;
  const dim3 grid((M + kLinBM - 1) / kLinBM, (C + kLinBN - 1) / kLinBN);
  auto kernel = res ? linear_bias_bf16_kernel<true> : linear_bias_bf16_kernel<false>;
  kernel<<<grid, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(attn), static_cast<const __nv_bfloat16*>(w_out),
      static_cast<const __nv_bfloat16*>(b_out), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), M, C, C);
  return cudaGetLastError();
}

}  // namespace exo
