// The tail the fused-MHA family shares (mha_tile.cuh's bodies, under
// csrc/fused_mha.cu, fused_mha_int8.cu, block_attn.cu and block_attn_int8.cu):
// the per-window attention of the int8 f32 body's (window, head) CTAs and the
// tiled out-projection. Counterpart of the TPU kernels' shared
// _mha_attention_tail (exoground_tpu/ops/attention.py:575).
//
// What bounds the out-projection on an H100: operations (2*M*C^2 FLOPs,
// 10.2 GFLOP at B304 S64 C512, against M*C*8 + C^2*4 bytes in f32). Both
// bodies are tensor-core GEMMs of 128 x 128 output tiles. float32:
// linear_bias_tf32_kernel, 3xTF32 (see below; plain TF32 would miss the f32
// limit of 1e-4), every body's f32 out-projection. bfloat16:
// linear_bias_bf16_kernel: 128 x 128 output tiles, 8 warps
// of 64 x 32, mma.sync m16n8k16 (bf16 in, f32 accumulated) fed by ldmatrix
// from a two-stage cp.async ring of 32-wide K chunks (row pitch 40 elements,
// so an ldmatrix touches 8 distinct bank groups), the bias (and the block
// bodies' residual, read as bf16 pairs: x 4-byte aligned) added to the f32
// sum before the one rounding. It serves
// every bf16 body of the family at a head of 64 or less; a wider head's bf16
// bodies take the wgmma GEMM of wgmma_linear.cuh for the out-projection and
// the exact qkv (N = 3C). The f32 kernel, at N = 3C, is also the wide f32
// body's qkv projection (mha_tile.cuh 2d), and linear_s8_kernel the int8
// one (below). K = C spans every head, so the heads are
// summed inside one dot product, with no atomics. It needs the attn scratch
// and W_out 16-byte aligned (cp.async) and returns cudaErrorMisalignedAddress
// otherwise.
#pragma once

#include <cfloat>
#include <cstddef>
#include <type_traits>

#include "common.cuh"
#include "tc.cuh"
#include "wgmma_linear.cuh"

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

// y = a . w^T + bias (+ res) for float32: the same 128 x 128 tile and warp
// layout as the bf16 body below, every product in 3xTF32 (tc.cuh) from a
// two-stage cp.async ring of 32-wide f32 K chunks at a row pitch of 36
// floats (4 more than the data: conflict-free fragment reads); each warp
// splits its four B fragments once a k-step and reuses them over its four
// m-tiles. The bias (and the residual, read as float2: res 8-byte aligned)
// is added to the f32 sum once.
constexpr int kLinPf = 32 + 4;  // f32 row pitch, floats
constexpr size_t kLinTf32Bytes = sizeof(float) * 2 * (128 + 128) * kLinPf;

template <bool RES>
__global__ void __launch_bounds__(256, 2)
linear_bias_tf32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                        const float* __restrict__ bias, const float* __restrict__ res,
                        float* __restrict__ y, int M, int N, int K) {
  constexpr int BM = 128, BN = 128, BK = 32;
  extern __shared__ __align__(16) unsigned char smem_lin[];
  float* as = reinterpret_cast<float*>(smem_lin);  // [2][BM * kLinPf]
  float* bs = as + 2 * BM * kLinPf;                // [2][BN * kLinPf]
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, c = 2 * (lane % 4);
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int nch = (K + BK - 1) / BK;
  tc::cp_tile<BM, BK, 256>(as, kLinPf, a, K, m0, M, 0, K);
  tc::cp_tile<BN, BK, 256>(bs, kLinPf, w, K, n0, N, 0, K);
  tc::cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch & 1;
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (ch + 1 < nch) {
      const int k0 = (ch + 1) * BK;
      tc::cp_tile<BM, BK, 256>(as + (st ^ 1) * BM * kLinPf, kLinPf, a, K, m0, M, k0, K);
      tc::cp_tile<BN, BK, 256>(bs + (st ^ 1) * BN * kLinPf, kLinPf, w, K, n0, N, k0, K);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const float* at = as + st * BM * kLinPf + wm * 64 * kLinPf;
    const float* bt = bs + st * BN * kLinPf + wn * 32 * kLinPf;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      tc::Tf32B b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        b[nt] = tc::load_b_tf32(bt + nt * 8 * kLinPf + kk * 8, kLinPf, lane);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const tc::Tf32A af = tc::load_a_tf32(at + mt * 16 * kLinPf + kk * 8, kLinPf, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) tc::mma_3xtf32(acc[mt][nt], af, b[nt]);
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
        float v0 = acc[mt][nt][2 * half] + bias[n];
        float v1 = acc[mt][nt][2 * half + 1] + bias[n + 1];
        if constexpr (RES) {
          const float2 r = *reinterpret_cast<const float2*>(res + size_t(m) * N + n);
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<float2*>(y + size_t(m) * N + n) = make_float2(v0, v1);
      }
    }
}

// y (M x N) = a (M x K) . w (N x K)^T + bias (+ res, the block bodies'
// residual, when given) on the tensor cores. The primary template is the
// f32 body; bf16 is specialized below. a and w 16-byte aligned (cp.async),
// res 8-byte aligned (f32; 4-byte in bf16), N and K multiples of 8.
template <typename T>
inline cudaError_t linear(const void* a, const void* w, const void* bias, void* y, int M, int N,
                          int K, cudaStream_t st, const void* res = nullptr) {
  const dim3 grid((M + 127) / 128, (N + 127) / 128);
  auto kernel = res ? linear_bias_tf32_kernel<true> : linear_bias_tf32_kernel<false>;
  cudaError_t err = allow_smem(kernel, kLinTf32Bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 256, kLinTf32Bytes, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(res), static_cast<float*>(y), M, N, K);
  return cudaGetLastError();
}

// The out-projection of a fused MHA: out (M x C) = attn . W_out^T + b_out
// (+ res, the block bodies' residual x, when given). attn and W_out
// 16-byte aligned (cp.async, TMA), res 8-byte aligned in f32 and 4-byte in
// bf16. wide: a head above 64, whose bodies take the wgmma GEMMs
// (wgmma_linear.cuh: bf16, and f32 in 3xTF32); every other body the
// mma.sync tiles below.
template <typename T>
inline cudaError_t out_projection(const void* attn, const void* w_out, const void* b_out,
                                  void* out, int M, int C, cudaStream_t st, const void* res,
                                  bool wide) {
  if (!tc::aligned16(attn) || !tc::aligned16(w_out)) return cudaErrorMisalignedAddress;
  if (res && reinterpret_cast<uintptr_t>(res) % (sizeof(T) == 4 ? 8 : 4)) {
    return cudaErrorMisalignedAddress;
  }
  if (C % 8) return cudaErrorInvalidValue;
  if (wide) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      return wg::linear(attn, w_out, b_out, out, M, C, C, st, res);
    } else {
      return wg::linear_tf32(attn, w_out, b_out, out, M, C, C, st, res);
    }
  }
  return linear<T>(attn, w_out, b_out, out, M, C, C, st, res);
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
inline cudaError_t linear<__nv_bfloat16>(const void* a, const void* w, const void* bias, void* y,
                                         int M, int N, int K, cudaStream_t st, const void* res) {
  const dim3 grid((M + kLinBM - 1) / kLinBM, (N + kLinBN - 1) / kLinBN);
  auto kernel = res ? linear_bias_bf16_kernel<true> : linear_bias_bf16_kernel<false>;
  kernel<<<grid, 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(y), M, N, K);
  return cudaGetLastError();
}

// y (M x N) in T = float(aq . wq^T) * xs[m] * wsc[n] + bias[n], each step
// rounded on its own (exo::dequant, the plain version's order), for the
// int8 qkv product of the wide-head bodies (mha_tile.cuh 2d): the bf16
// kernel's 128 x 128 tile and warp layout with the int8 operands seen as b16
// (K / 2 of them a row, 64 int8 values a K chunk), mma.sync m16n8k32 .s8
// (tc::mma_s8, exact int32 sums). aq (M x K) and wq (N x K) int8, 16-byte
// aligned, K a multiple of 16; xs (M) and wsc (N) f32, bias (N) in T.
template <typename T>
__global__ void __launch_bounds__(256)
linear_s8_kernel(const int8_t* __restrict__ aq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wq, const float* __restrict__ wsc,
                 const T* __restrict__ bias, T* __restrict__ y, int M, int N, int K) {
  using b16 = __nv_bfloat16;
  __shared__ __align__(16) b16 as[2][kLinBM * kLinPitch];
  __shared__ __align__(16) b16 bs[2][kLinBN * kLinPitch];
  const b16* a = reinterpret_cast<const b16*>(aq);
  const b16* w = reinterpret_cast<const b16*>(wq);
  const int K2 = K / 2;  // b16 units a row
  const int m0 = blockIdx.x * kLinBM, n0 = blockIdx.y * kLinBN;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, c = 2 * (lane % 4);
  const int ar = tc::a_row(lane), ac = tc::a_col(lane), br = tc::b_row(lane),
            bc = tc::b_col(lane);
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nch = (K2 + kLinBK - 1) / kLinBK;
  tc::cp_tile<kLinBM, kLinBK, 256>(as[0], kLinPitch, a, K2, m0, M, 0, K2);
  tc::cp_tile<kLinBN, kLinBK, 256>(bs[0], kLinPitch, w, K2, n0, N, 0, K2);
  tc::cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch & 1;
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (ch + 1 < nch) {
      const int k0 = (ch + 1) * kLinBK;
      tc::cp_tile<kLinBM, kLinBK, 256>(as[st ^ 1], kLinPitch, a, K2, m0, M, k0, K2);
      tc::cp_tile<kLinBN, kLinBK, 256>(bs[st ^ 1], kLinPitch, w, K2, n0, N, k0, K2);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kLinBK / 16; ++kk) {  // 32 int8 values a k-step
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        tc::ldsm_x4(af[mt], as[st] + (wm * 64 + mt * 16 + ar) * kLinPitch + kk * 16 + ac);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        tc::ldsm_x4(b, bs[st] + (wn * 32 + np * 16 + br) * kLinPitch + kk * 16 + bc);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          tc::mma_s8(acc[mt][2 * np], af[mt], b[0], b[1]);
          tc::mma_s8(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
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
      const float sm = xs[m];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + c;
        if (n >= N) continue;
        const float v0 = dequant(acc[mt][nt][2 * half], sm, wsc[n], to_f(bias[n]));
        const float v1 = dequant(acc[mt][nt][2 * half + 1], sm, wsc[n + 1], to_f(bias[n + 1]));
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float2*>(y + size_t(m) * N + n) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(y + size_t(m) * N + n) = tc::pack_bf16(v0, v1);
        }
      }
    }
}

template <typename T>
inline cudaError_t linear_int8(const void* aq, const void* xs, const void* wq, const void* wsc,
                               const void* bias, void* y, int M, int N, int K, cudaStream_t st) {
  if (!tc::aligned16(aq) || !tc::aligned16(wq)) return cudaErrorMisalignedAddress;
  if (K % 16 || N % 8) return cudaErrorInvalidValue;
  const dim3 grid((M + kLinBM - 1) / kLinBM, (N + kLinBN - 1) / kLinBN);
  linear_s8_kernel<T><<<grid, 256, 0, st>>>(
      static_cast<const int8_t*>(aq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(wq), static_cast<const float*>(wsc),
      static_cast<const T*>(bias), static_cast<T*>(y), M, N, K);
  return cudaGetLastError();
}

}  // namespace exo
