// Attention at head sizes past the fixed head tiles, in head-dimension slabs
// of kDS = 64 columns: the building blocks of the wide-head bodies of
// small_attn.cu (D > 128), the fused-MHA family (mha_tile.cuh, Dh > 64) and
// flash_attn.cu (D > 128), and the window kernel the first two share.
//
// Why slabs: the fixed-tile bodies keep a whole head of q, k and v (S x Dh)
// in shared memory and a whole head of o accumulators in registers. At Dh
// 256 three f32 tiles of 128 rows take 399 KB, past a CTA's 227 KB, and o
// alone takes 128 registers a thread. Split the head into slabs of 64
// columns and both stay bounded at any head size:
//   - the scores s = q . k^T are the sum of the slabs' products, so the
//     (16 x <= 128) f32 score fragments of a warp accumulate over the slabs
//     of q and k, staged one slab at a time;
//   - the softmax runs once on the whole score tile;
//   - o = p . v is separable by column, so each slab of v gives its slab of
//     o, which is written out before the next slab is staged.
// Every product is on the tensor cores: bf16 mma.sync m16n8k16 from
// ldmatrix, f32 3xTF32 (m16n8k8 .tf32, hi/lo operand splits; plain TF32
// misses the f32 limit of 1e-4 of max|plain|). p goes from the score C
// fragments to the A fragments of p . v in registers, as in the fixed-tile
// bodies (tc.cuh).
#pragma once

#include <cstddef>
#include <cstdint>
#include <math.h>

#include "common.cuh"
#include "tc.cuh"

namespace exo {
namespace wide {

using bf16 = __nv_bfloat16;

constexpr int kDS = 64;             // head columns a slab
constexpr float kFillNeg = -1e30f;  // padding keys: the plain versions' finite NEG_INF

// Row pitch of a slab tile in elements: bf16 kDS + 8 (the 8 rows of an
// ldmatrix fall in distinct bank groups), f32 kDS + 4 (4 mod 8: conflict-free
// fragment reads, row g and column t, or rows 2t, 2t + 1 and column g).
template <typename T> struct Pitch;
template <> struct Pitch<float> { static constexpr int P = kDS + 4; };
template <> struct Pitch<bf16> { static constexpr int P = kDS + 8; };

// Stage columns d0.. d0 + kDS of `rows` rows (pitch ld elements) into a
// slab tile by 16-byte cp.async: rows at or past nrows and columns at or
// past D are zero-filled (D a multiple of 8, src 16-byte aligned with ld a
// multiple of 16 bytes). Called by every thread of the CTA.
template <typename T>
__device__ __forceinline__ void stage_slab(T* dst, const T* src, long long ld, int rows,
                                           int nrows, int d0, int D) {
  constexpr int EC = 16 / sizeof(T), CH = kDS / EC, P = Pitch<T>::P;
  for (int e = threadIdx.x; e < rows * CH; e += blockDim.x) {
    const int r = e / CH, c = (e % CH) * EC;
    const bool in = r < nrows && d0 + c < D;
    tc::cp_async16(dst + r * P + c, in ? src + r * ld + d0 + c : src, in);
  }
}

// The same through registers, each value taken to T(float(x) * scale): the
// window core's q, scaled as it is loaded.
template <typename T>
__device__ __forceinline__ void stage_slab_scaled(T* dst, const T* src, long long ld, int rows,
                                                  int nrows, int d0, int D, float scale) {
  constexpr int EC = 16 / sizeof(T), CH = kDS / EC, P = Pitch<T>::P;
  for (int e = threadIdx.x; e < rows * CH; e += blockDim.x) {
    const int r = e / CH, c = (e % CH) * EC;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows && d0 + c < D) raw = *reinterpret_cast<const uint4*>(src + r * ld + d0 + c);
    T* x = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < EC; ++i) x[i] = from_f<T>(to_f(x[i]) * scale);
    *reinterpret_cast<uint4*>(dst + r * P + c) = raw;
  }
}

// s += A . B^T over one slab: A the 16 rows of a slab tile at a (row-major),
// B the rows 0.. of another (n-major); s[nt] is n-tile nt (8 rows of B).
// n-tiles at or past nn (even for bf16) and k-steps at or past the slab's
// `cols` valid columns are skipped.
template <int NT>
__device__ __forceinline__ void slab_qk(float (&s)[NT][4], const float* a, const float* b,
                                        int nn, int cols, int lane) {
  constexpr int P = Pitch<float>::P;
#pragma unroll
  for (int kk = 0; kk < kDS / 8; ++kk) {
    if (kk * 8 < cols) {
      const tc::Tf32A af = tc::load_a_tf32(a + kk * 8, P, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt < nn) tc::mma_3xtf32(s[nt], af, tc::load_b_tf32(b + nt * 8 * P + kk * 8, P, lane));
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void slab_qk(float (&s)[NT][4], const bf16* a, const bf16* b, int nn,
                                        int cols, int lane) {
  constexpr int P = Pitch<bf16>::P;
#pragma unroll
  for (int kk = 0; kk < kDS / 16; ++kk) {
    if (kk * 16 < cols) {
      uint32_t af[4];
      tc::ldsm_x4(af, a + tc::a_row(lane) * P + kk * 16 + tc::a_col(lane));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        if (2 * np < nn) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, b + (np * 16 + tc::b_row(lane)) * P + kk * 16 + tc::b_col(lane));
          tc::mma(s[2 * np], af, bb[0], bb[1]);
          tc::mma(s[2 * np + 1], af, bb[2], bb[3]);
        }
      }
    }
  }
}

// acc += p . V over one slab of V's columns: p the C fragments p[0..NT) of a
// warp's 16 x 8 NT scores (n-tile nt = keys 8 nt..), divided by l (rows g,
// g + 8) first when NORM; V the rows (keys) 0.. of a slab tile, read k-major.
// Key tiles at or past nn (even for bf16) are skipped. bf16: p (p / l) is
// rounded to bf16 as it is packed, as the plain versions cast p to v's type.
template <int NT, bool NORM>
__device__ __forceinline__ void slab_pv(float (&acc)[kDS / 8][4], const float (&p)[NT][4],
                                        const float (&l)[2], const float* v, int nn, int lane) {
  constexpr int P = Pitch<float>::P;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    if (kk < nn) {
      float pn[4] = {p[kk][0], p[kk][1], p[kk][2], p[kk][3]};
      if (NORM) {
        pn[0] /= l[0];
        pn[1] /= l[0];
        pn[2] /= l[1];
        pn[3] /= l[1];
      }
      const tc::Tf32A a = tc::c_to_a_tf32(pn);
#pragma unroll
      for (int dn = 0; dn < kDS / 8; ++dn)
        tc::mma_3xtf32(acc[dn], a, tc::load_bk_tf32(v + kk * 8 * P + dn * 8, P, lane));
    }
  }
}

template <int NT, bool NORM>
__device__ __forceinline__ void slab_pv(float (&acc)[kDS / 8][4], const float (&p)[NT][4],
                                        const float (&l)[2], const bf16* v, int nn, int lane) {
  constexpr int P = Pitch<bf16>::P;
  const float i0 = NORM ? l[0] : 1.f, i1 = NORM ? l[1] : 1.f;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (2 * kk < nn) {
      const uint32_t a[4] = {tc::pack_bf16(p[2 * kk][0] / i0, p[2 * kk][1] / i0),
                             tc::pack_bf16(p[2 * kk][2] / i1, p[2 * kk][3] / i1),
                             tc::pack_bf16(p[2 * kk + 1][0] / i0, p[2 * kk + 1][1] / i0),
                             tc::pack_bf16(p[2 * kk + 1][2] / i1, p[2 * kk + 1][3] / i1)};
#pragma unroll
      for (int dp = 0; dp < kDS / 16; ++dp) {
        uint32_t bb[4];
        tc::ldsm_x4_t(bb, v + (kk * 16 + tc::a_row(lane)) * P + dp * 16 + tc::a_col(lane));
        tc::mma(acc[2 * dp], a, bb[0], bb[1]);
        tc::mma(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// A warp's slab of o (rows g and g + 8 of acc, each divided by its d[]) into
// dst, the warp's first row at the slab's first column (row pitch ld): rows
// at or past rlim and columns at or past clim are not written.
template <typename T>
__device__ __forceinline__ void store_slab(const float (&acc)[kDS / 8][4], const float (&d)[2],
                                           T* dst, long long ld, int rlim, int clim, int lane) {
  const int g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    if (r >= rlim) continue;
#pragma unroll
    for (int nt = 0; nt < kDS / 8; ++nt) {
      const int col = nt * 8 + c;
      if (col >= clim) continue;
      const float v0 = acc[nt][2 * half] / d[half], v1 = acc[nt][2 * half + 1] / d[half];
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float2*>(dst + r * ld + col) = make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(dst + r * ld + col) = tc::pack_bf16(v0, v1);
      }
    }
  }
}

// ======================================================== the window kernel
// Element strides (batch, head, row) of q, k, v and o, (B, H, S, D) views
// with a contiguous last dimension.
struct Window {
  long long qb, qh, qr, kb, kh, kr, vb, vh, vr, ob, oh, orow;
};

// One CTA per (batch, head) window of S <= 128 tokens, one warp per 16 query
// rows (ceil(S / 16) warps), the head in slabs:
//   1. per slab, q and k staged (rows past S and columns past D zero), each
//      warp's scores accumulated in registers (NKP pairs of key n-tiles: 4
//      up to S 64, 6 up to 96, 8 up to 128);
//   2. keys past S excluded (-inf), padding keys at the finite -1e30 (a
//      window whose keys are all padding averages its own S values, as
//      attention_plain does), p = exp(s - max) and l = sum p in f32;
//   3. per slab, v staged over q's tile and o's slab written.
// SMALL: the window core's order (small_attn.cu; _small_kernel): q scaled
// as it is loaded, T(float(q) * scale); p unnormalised in p . v, o / l
// after. Else the MHA tile's (mha_tile.cuh; _mha_attention_tail): the scores
// times scale, then p / l before p . v. M: the key-padding flag's type (bool
// for the window core, int32 for the MHA family), nonzero at padding; null
// for none.
template <typename T, bool SMALL, int NKP, typename M>
__global__ void __launch_bounds__(256)
window_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const M* __restrict__ kpad, T* __restrict__ o, Window W, int H, int S, int D,
              float scale) {
  constexpr int P = Pitch<T>::P;
  extern __shared__ __align__(16) unsigned char smem_w[];
  const int SP = (S + 15) & ~15, nn = SP / 8;
  T* qs = reinterpret_cast<T*>(smem_w);           // [SP][P]: q, then the v slab
  T* ks = qs + SP * P;                            // [SP][P]
  int* km = reinterpret_cast<int*>(ks + SP * P);  // [SP]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  q += b * W.qb + h * W.qh;
  k += b * W.kb + h * W.kh;
  v += b * W.vb + h * W.vh;
  o += b * W.ob + h * W.oh;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, c = 2 * (lane % 4);
  for (int j = tid; j < SP; j += blockDim.x) {
    km[j] = j < S && kpad != nullptr ? kpad[size_t(b) * S + j] != 0 : 0;
  }

  // ---- 1. s = q . k^T, slab by slab ----
  float s[2 * NKP][4];
  zero(s);
  for (int d0 = 0; d0 < D; d0 += kDS) {
    __syncthreads();  // every warp is done with the previous slab
    if constexpr (SMALL) {
      stage_slab_scaled(qs, q, W.qr, SP, S, d0, D, scale);
    } else {
      stage_slab(qs, q, W.qr, SP, S, d0, D);
    }
    stage_slab(ks, k, W.kr, SP, S, d0, D);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    slab_qk<2 * NKP>(s, qs + 16 * w * P, ks, nn, D - d0, lane);
  }

  // ---- 2. the softmax over the whole score tile ----
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 2 * NKP; ++nt) {
    if (nt < nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = nt * 8 + c + (e & 1);
        const float x = t >= S ? -INFINITY : (km[t] ? kFillNeg : (SMALL ? s[nt][e] : s[nt][e] * scale));
        s[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = tc::quad_max(mx[r]);
#pragma unroll
  for (int nt = 0; nt < 2 * NKP; ++nt) {
    if (nt < nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - mx[e / 2]);
        s[nt][e] = p;
        l[e / 2] += p;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = tc::quad_sum(l[r]);

  // ---- 3. o = p . v, slab by slab ----
  const float odiv[2] = {SMALL ? l[0] : 1.f, SMALL ? l[1] : 1.f};  // o / l after, or o as it is
  for (int d0 = 0; d0 < D; d0 += kDS) {
    __syncthreads();  // every warp is done with q and k, or the previous v slab
    stage_slab(qs, v, W.vr, SP, S, d0, D);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    float acc[kDS / 8][4];
    zero(acc);
    slab_pv<2 * NKP, !SMALL>(acc, s, l, qs, nn, lane);
    store_slab(acc, odiv, o + (16 * w) * W.orow + d0, W.orow, S - 16 * w, D - d0, lane);
  }
}

// Shared memory of the window kernel: two slab tiles and the key flags.
template <typename T>
inline size_t window_smem(int S) {
  const int SP = (S + 15) & ~15;
  return size_t(2) * SP * Pitch<T>::P * sizeof(T) + size_t(SP) * sizeof(int);
}

template <typename T, bool SMALL, int NKP, typename M>
inline cudaError_t launch_window(const void* q, const void* k, const void* v, const M* kpad,
                                 void* o, const Window& W, int B, int H, int S, int D,
                                 float scale, cudaStream_t st) {
  auto kernel = window_kernel<T, SMALL, NKP, M>;
  const size_t smem = window_smem<T>(S);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, 32 * ((S + 15) / 16), smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kpad,
      static_cast<T*>(o), W, H, S, D, scale);
  return cudaGetLastError();
}

// The window kernel over B*H windows of 1 <= S <= 128 tokens at any head size
// D (a multiple of 8); every base and stride 16-byte aligned.
template <typename T, bool SMALL, typename M>
inline cudaError_t window(const void* q, const void* k, const void* v, const M* kpad, void* o,
                         const Window& W, int B, int H, int S, int D, float scale,
                         cudaStream_t st) {
  if (S < 1 || S > 128 || D < 8 || D % 8) return cudaErrorInvalidValue;
  if (S <= 64) return launch_window<T, SMALL, 4, M>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
  if (S <= 96) return launch_window<T, SMALL, 6, M>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
  return launch_window<T, SMALL, 8, M>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
}

}  // namespace wide
}  // namespace exo
