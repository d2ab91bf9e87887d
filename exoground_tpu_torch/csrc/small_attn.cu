// Window attention core over (B*H) windows of S <= 128 tokens.
//
// Replaces the TPU kernel exoground_tpu/ops/attention.py::_small
// (pallas_call in _small_impl, body _small_kernel): from q, k and v of one
// window,
//   q scaled by 1/sqrt(D) as it is loaded, rounded to q's type: T(float(q) *
//     scale), the value PyTorch's q * scale gives, so the scores start from
//     the same q as the plain version's;
//   s = q k^T in f32, keys masked where the bool kpad is set (the finite
//     -1e30 fill),
//   m = row max, p = exp(s - m) in f32, l = sum of the unrounded p,
//   o = (p rounded to v's type) . v accumulated in f32, then o / l,
// rounded to q's type. The normalisation comes after the product, as in the
// TPU body (attention_plain normalises before it).
// A window whose keys are all padding averages its own S values uniformly
// (every score -1e30, so p = 1 for each of its keys), as attention_plain
// does; the TPU kernel averages all 128 columns of its packed tile instead.
//
// Operands. q, k, v and o are (B, H, S, D) views with a contiguous last
// dimension and any batch, head and row strides (in elements): the views
// mha_plain's head split makes of the packed (B, S, 3C) qkv, with strides
// (S*3C, D, 3C, 1), are read where they lie, with no copy. Every base and
// stride is a multiple of 16 bytes (the wrapper checks).
//
// What bounds it on an H100: at the serving shapes (B*H = 512 windows at
// S = 64 and 128, 2432 at S = 64 and 96; D = 64) the work is 4*BH*S^2*D
// flops over 4*BH*S*D elements of input and output, 32-64 flops an element:
// in bf16 on the tensor cores the bytes bound it (~2 us of HBM traffic at
// B64 S128), in f32 on the CUDA cores the operations.
//
// bfloat16 body (tcb::small_attn_kernel): the tensor cores, through tc.cuh
// (mma.sync m16n8k16, ldmatrix, cp.async). One CTA per (batch, head) window
// and one warp per 16-row query block, ceil(S/16) warps. k and v arrive by
// 16-byte cp.async and q through registers (scaled and rounded), all three
// at a row pitch of DP + 8 elements (DP: D rounded up to 16; rows past S and
// columns past D zero-filled). s = q k^T stays in C fragments; keys past S
// take -inf (excluded), padding keys -1e30; l sums the f32 p, then the C
// fragments of two n-tiles, rounded to bf16 and packed, are the A fragment
// of one k-step of p . v, with v by ldmatrix.trans. One window a CTA: at
// B304 S64 the CTA is 4 warps and 27.6 KB of shared memory, and under the
// 128-register cap 4 CTAs (16 warps) an SM are resident (registers decide;
// shared memory would allow 8), so the 2432 CTAs run in ~4.6 waves with
// enough warps to hide the loads. Two windows a CTA would halve that to 2
// resident CTAs of 8 warps, the same warps an SM with a coarser tail. The
// score registers are sized by S (16, 24 or 32 n-tiles at S <= 64, 96,
// 128), so S96's 6-warp CTAs fit 3 an SM.
//
// float32 body (f32::small_attn_kernel): the CUDA cores (plain TF32 misses the
// 1e-4 limit; the work is 2.15 GFLOP at B64 H8 S128). One CTA of 8 warps
// per window; k and v arrive by 16-byte cp.async in shared memory at row
// pitch D + 4 floats (the 8 rows a quarter-warp reads with one 128-bit load
// fall in 8 distinct 4-bank groups), q rows by 128-bit loads. Each warp
// owns kRows = 8 query rows at a time: a lane holds the scores of keys
// lane, lane + 32, ... for all 8 rows, so every key it reads (a float4 of
// 4 head columns) feeds 32 FMAs, and in p . v every float4 of 4 p's (a
// broadcast) feeds 8 FMAs per owned column pair (a 64-bit load a key), 8
// rows at once.
//
// Head sizes: multiples of 8 up to 128 in the bodies above; larger multiples
// of 8 in the wide body (wide_window.cuh's window kernel in its SMALL order,
// the same function: q scaled and rounded as it is loaded, p unnormalised in
// p . v, o / l after): per (batch, head) window q and k in head slabs of 64
// columns, the scores summed over the slabs in registers, the softmax once,
// then o slab by slab from v's slabs, every product on the tensor cores
// (3xTF32 in f32). Its tiles take 2 * 128 * 68 floats (70 KB) in f32 at S
// 128 whatever the head size, where the f32 body above keeps all of k and v
// (266 KB at D 256).
#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <math.h>

#include "common.cuh"
#include "tc.cuh"
#include "wide_window.cuh"

namespace {

constexpr int kMaxS = 128;
constexpr int kMaxTileD = 128;  // the largest head the bodies above hold; past it, slabs
constexpr float kNegInf = -1e30f;  // finite fill, as the plain version's NEG_INF

// Element strides of one (B, H, S, D) operand; the last dimension is contiguous.
struct Strides {
  long long b, h, r;
};

struct Window {
  Strides q, k, v, o;
};

__device__ __forceinline__ long long at(const Strides& s, int b, int h) {
  return b * s.b + h * s.h;
}

// ============================================================ f32: CUDA cores
namespace f32 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;                  // query rows a warp owns at a time
constexpr int kKeysPerLane = kMaxS / 32;  // keys lane + 32 t

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// k, v: S4 x (D + 4); per warp kRows x (max(D, S4) + 4) floats holding the
// scaled q rows, then the rounded p; the key mask.
size_t smem_bytes(int S, int D) {
  const int S4 = round4(S), P = D + 4, PB = (D > S4 ? D : S4) + 4;
  return (size_t(2) * S4 * P + size_t(kWarps) * kRows * PB) * sizeof(float) +
         size_t(S4) * sizeof(int);
}

// U: column pairs a lane owns in p . v (2 lane + 64 u and + 1), ceil(D / 64).
template <int U>
__global__ void __launch_bounds__(kThreads, 2)
small_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const unsigned char* __restrict__ kpad,
              float* __restrict__ o, Window W, int H, int S, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int S4 = round4(S), P = D + 4, PB = (D > S4 ? D : S4) + 4;
  float* ks = smem;              // [S4][P]
  float* vs = ks + S4 * P;       // [S4][P]
  float* wb = vs + S4 * P;       // [kWarps][kRows][PB]
  int* km = reinterpret_cast<int*>(wb + kWarps * kRows * PB);  // [S4]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  q += at(W.q, b, h);
  k += at(W.k, b, h);
  v += at(W.v, b, h);
  o += at(W.o, b, h);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch = D / 4;  // 16-byte chunks a row, <= 32: lane c copies chunk c
  // k, then v in a second group: v lands while the first rows' scores run
  for (int j = warp; j < S4; j += kWarps) {
    if (lane < ch) {
      const bool in = j < S;
      exo::tc::cp_async16(ks + j * P + 4 * lane, in ? k + j * W.k.r + 4 * lane : k, in);
    }
  }
  exo::tc::cp_async_commit();
  for (int j = warp; j < S4; j += kWarps) {
    if (lane < ch) {
      const bool in = j < S;
      exo::tc::cp_async16(vs + j * P + 4 * lane, in ? v + j * W.v.r + 4 * lane : v, in);
    }
  }
  exo::tc::cp_async_commit();
  for (int j = tid; j < S4; j += kThreads) km[j] = j < S && kpad ? kpad[size_t(b) * S + j] : 0;
  exo::tc::cp_async_wait<1>();  // this thread's k copies
  __syncthreads();

  float* qw = wb + warp * kRows * PB;  // this warp's q rows, then its p rows
  int koff[kKeysPerLane];
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + 32 * t;
    koff[t] = (j < S4 ? j : S4 - 1) * P;  // in range; scores past S are masked
  }
  // every warp runs every pass (its rows may lie past S), so that the one
  // barrier, v's, is reached by all
  const int npass = (S + kWarps * kRows - 1) / (kWarps * kRows);
  for (int pass = 0; pass < npass; ++pass) {
    const int i0 = (warp + kWarps * pass) * kRows;
    const bool active = i0 < S;
    float l[kRows];
    if (active) {
      // the warp's q rows, T(float(q) * scale), zeros past S
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (lane < ch) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i0 + r < S) {
            x = *reinterpret_cast<const float4*>(q + (i0 + r) * W.q.r + 4 * lane);
          }
          *reinterpret_cast<float4*>(qw + r * PB + 4 * lane) =
              make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
        }
      }
      __syncwarp();

      // ---- scores of keys lane + 32 t for the warp's kRows rows ----
      float s[kRows][kKeysPerLane];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) s[r][t] = 0.f;
      for (int d = 0; d < D; d += 4) {
        float4 kv[kKeysPerLane];
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t)
          kv[t] = *reinterpret_cast<const float4*>(ks + koff[t] + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(qw + r * PB + d);
#pragma unroll
          for (int t = 0; t < kKeysPerLane; ++t) {
            s[r][t] = fmaf(qv.x, kv[t].x, s[r][t]);
            s[r][t] = fmaf(qv.y, kv[t].y, s[r][t]);
            s[r][t] = fmaf(qv.z, kv[t].z, s[r][t]);
            s[r][t] = fmaf(qv.w, kv[t].w, s[r][t]);
          }
        }
      }
      __syncwarp();  // q is read; its rows become p

      // ---- p = exp(s - m) in f32; l over the unrounded p; p to the warp's rows ----
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float m = -INFINITY;
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          const int j = lane + 32 * t;
          s[r][t] = j >= S ? -INFINITY : (km[j] ? kNegInf : s[r][t]);
          m = fmaxf(m, s[r][t]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        }
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < kKeysPerLane; ++t) {
          const int j = lane + 32 * t;
          const float p = expf(s[r][t] - m);  // 0 past S
          sum += p;
          if (j < S4) qw[r * PB + j] = p;
        }
        l[r] = exo::warp_sum(sum);
      }
      __syncwarp();
    }
    if (pass == 0) {  // v has landed
      exo::tc::cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) continue;

    // ---- o[r][d] = sum_j p[r][j] v[j][d], then / l; lane owns d = 2 lane + 64 u, + 1 ----
    float2 acc[kRows][U];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u) acc[r][u] = make_float2(0.f, 0.f);
    for (int j = 0; j < S4; j += 4) {
      float2 vv[4][U];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int d = 2 * lane + 64 * u;
          vv[jj][u] = d < D ? *reinterpret_cast<const float2*>(vs + (j + jj) * P + d)
                            : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pv = *reinterpret_cast<const float4*>(qw + r * PB + j);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc[r][u].x = fmaf(pv.x, vv[0][u].x, acc[r][u].x);
          acc[r][u].y = fmaf(pv.x, vv[0][u].y, acc[r][u].y);
          acc[r][u].x = fmaf(pv.y, vv[1][u].x, acc[r][u].x);
          acc[r][u].y = fmaf(pv.y, vv[1][u].y, acc[r][u].y);
          acc[r][u].x = fmaf(pv.z, vv[2][u].x, acc[r][u].x);
          acc[r][u].y = fmaf(pv.z, vv[2][u].y, acc[r][u].y);
          acc[r][u].x = fmaf(pv.w, vv[3][u].x, acc[r][u].x);
          acc[r][u].y = fmaf(pv.w, vv[3][u].y, acc[r][u].y);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (i0 + r >= S) continue;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = 2 * lane + 64 * u;
        if (d < D) {
          *reinterpret_cast<float2*>(o + (i0 + r) * W.o.r + d) =
              make_float2(acc[r][u].x / l[r], acc[r][u].y / l[r]);
        }
      }
    }
    __syncwarp();  // the row buffers are refilled for the warp's next rows
  }
}

template <int U>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpad, void* o,
                   const Window& W, int B, int H, int S, int D, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(S, D);
  cudaError_t err = exo::allow_smem(small_attn_kernel<U>, smem);
  if (err != cudaSuccess) return err;
  small_attn_kernel<U><<<B * H, kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const unsigned char*>(kpad), static_cast<float*>(o), W, H, S, D, scale);
  return cudaGetLastError();
}

cudaError_t forward(const void* q, const void* k, const void* v, const void* kpad, void* o,
                    const Window& W, int B, int H, int S, int D, float scale, cudaStream_t st) {
  switch ((D + 63) / 64) {
    case 1: return launch<1>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
    case 2: return launch<2>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32

// ======================================================= bf16: tensor cores
namespace tcb {

using bf16 = __nv_bfloat16;
using exo::tc::a_col;
using exo::tc::a_row;
using exo::tc::b_col;
using exo::tc::b_row;
using exo::tc::ldsm_x4;
using exo::tc::ldsm_x4_t;
using exo::tc::mma;
using exo::tc::pack_bf16;
using exo::tc::quad_max;
using exo::tc::quad_sum;

// q, k, v tiles of SP = 16 * ceil(S / 16) rows at pitch DP + 8, the key mask
size_t smem_bytes(int S, int DP) {
  const int SP = (S + 15) & ~15;
  return size_t(3) * SP * (DP + 8) * sizeof(bf16) + size_t(SP) * sizeof(int);
}

// DP: the head size rounded up to 16; NKP: key blocks of 16 it serves (4:
// S <= 64, 6: S <= 96, 8: S <= 128). The CTA is ceil(S / 16) warps. At DP <=
// 64 the register cap keeps 16-18 warps an SM resident: 4 CTAs of 4 warps
// (128 registers), 3 of 6 (113), 2 of 8 (128).
template <int NKP>
constexpr int min_ctas() { return NKP == 6 ? 3 : 512 / (32 * NKP); }

template <int DP, int NKP>
__global__ void __launch_bounds__(32 * NKP, DP <= 64 ? min_ctas<NKP>() : 1)
small_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const unsigned char* __restrict__ kpad,
              bf16* __restrict__ o, Window W, int H, int S, int D, float scale) {
  constexpr int P = DP + 8;
  constexpr int kCh = DP / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_tc[];
  const int SP = (S + 15) & ~15, nk16 = SP / 16;
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [SP][P]
  bf16* ks = qs + SP * P;                        // [SP][P]
  bf16* vs = ks + SP * P;                        // [SP][P]
  int* km = reinterpret_cast<int*>(vs + SP * P);  // [SP]

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  q += at(W.q, b, h);
  k += at(W.k, b, h);
  v += at(W.v, b, h);
  o += at(W.o, b, h);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int e = tid; e < SP * kCh; e += nthreads) {
    const int r = e / kCh, c = (e % kCh) * 8;
    const bool in = r < S && c < D;
    exo::tc::cp_async16(ks + r * P + c, in ? k + r * W.k.r + c : k, in);
    exo::tc::cp_async16(vs + r * P + c, in ? v + r * W.v.r + c : v, in);
  }
  exo::tc::cp_async_commit();
  // q through registers: T(float(q) * scale), zeros past S and D
  for (int e = tid; e < SP * kCh; e += nthreads) {
    const int r = e / kCh, c = (e % kCh) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < S && c < D) raw = *reinterpret_cast<const uint4*>(q + r * W.q.r + c);
    bf16* x = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __float2bfloat16(__bfloat162float(x[i]) * scale);
    *reinterpret_cast<uint4*>(qs + r * P + c) = raw;
  }
  for (int j = tid; j < SP; j += nthreads) km[j] = j < S && kpad ? kpad[size_t(b) * S + j] : 0;
  exo::tc::cp_async_wait<0>();
  __syncthreads();

  // ---- s = q k^T: warp w owns query rows 16 w .. 16 w + 15 ----
  const int lane = tid % 32, w = tid / 32, g = lane / 4, c = 2 * (lane % 4);
  float s[2 * NKP][4];
#pragma unroll
  for (int nt = 0; nt < 2 * NKP; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qs + (16 * w + a_row(lane)) * P + kk * 16 + a_col(lane));
#pragma unroll
    for (int np = 0; np < NKP; ++np) {
      if (np < nk16) {
        uint32_t bb[4];
        ldsm_x4(bb, ks + (np * 16 + b_row(lane)) * P + kk * 16 + b_col(lane));
        mma(s[2 * np], a, bb[0], bb[1]);
        mma(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
  }
  // keys past S take -inf (excluded), padding keys the finite -1e30 (a
  // window whose keys are all padding averages its own S values)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 2 * NKP; ++nt) {
    if (nt / 2 < nk16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = nt * 8 + c + (e & 1);
        const float x = t >= S ? -INFINITY : (km[t] ? kNegInf : s[nt][e]);
        s[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
  // p = exp(s - m) in f32; l sums the unrounded p
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2 * NKP; ++nt) {
    if (nt / 2 < nk16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - mx[e / 2]);
        s[nt][e] = p;
        l[e / 2] += p;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);

  // ---- o = (p rounded to bf16) . v, from registers; v by ldmatrix.trans ----
  float acc[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKP; ++kk) {
    if (kk < nk16) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vs + (kk * 16 + a_row(lane)) * P + dp * 16 + a_col(lane));
        mma(acc[2 * dp], a, bb[0], bb[1]);
        mma(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
  }
  // o / l (IEEE quotient), rounded once to bf16
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = 16 * w + g + 8 * half;
    if (row >= S) continue;
    bf16* orow = o + row * W.o.r;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const int d = nt * 8 + c;
      if (d < D) {
        *reinterpret_cast<uint32_t*>(orow + d) =
            pack_bf16(acc[nt][2 * half] / l[half], acc[nt][2 * half + 1] / l[half]);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpad, void* o,
                   const Window& W, int B, int H, int S, int D, float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(S, DP);
  const int threads = 32 * ((S + 15) / 16);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const unsigned char* kp = static_cast<const unsigned char*>(kpad);
  bf16* ob = static_cast<bf16*>(o);
  cudaError_t err;
  if (S <= 64) {
    err = exo::allow_smem(small_attn_kernel<DP, 4>, smem);
    if (err != cudaSuccess) return err;
    small_attn_kernel<DP, 4><<<B * H, threads, smem, st>>>(qb, kb, vb, kp, ob, W, H, S, D, scale);
  } else if (S <= 96) {
    err = exo::allow_smem(small_attn_kernel<DP, 6>, smem);
    if (err != cudaSuccess) return err;
    small_attn_kernel<DP, 6><<<B * H, threads, smem, st>>>(qb, kb, vb, kp, ob, W, H, S, D, scale);
  } else {
    err = exo::allow_smem(small_attn_kernel<DP, 8>, smem);
    if (err != cudaSuccess) return err;
    small_attn_kernel<DP, 8><<<B * H, threads, smem, st>>>(qb, kb, vb, kp, ob, W, H, S, D, scale);
  }
  return cudaGetLastError();
}

cudaError_t forward(const void* q, const void* k, const void* v, const void* kpad, void* o,
                    const Window& W, int B, int H, int S, int D, float scale, cudaStream_t st) {
  switch ((D + 15) / 16) {
    case 1: return launch<16>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
    case 2: return launch<32>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
    case 3: return launch<48>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
    case 4: return launch<64>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
    case 5: return launch<80>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
    case 6: return launch<96>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
    case 7: return launch<112>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
    case 8: return launch<128>(q, k, v, kpad, o, W, B, H, S, D, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tcb

}  // namespace

// True when p and the strides (elements of `size` bytes) are 16-byte aligned.
static bool aligned(const void* p, const Strides& s, int size) {
  const int e = 16 / size;
  return exo::tc::aligned16(p) && s.b % e == 0 && s.h % e == 0 && s.r % e == 0;
}

// q, k, v, o (B, H, S, D) in elements of one type (dtype 0: float32, 1:
// bfloat16), the last dimension contiguous, at the given batch, head and
// row strides (elements), every base and stride 16-byte aligned; q unscaled
// (scale = 1/sqrt(D) as a float is applied as q is loaded); kpad (B, S) bool
// contiguous, true at padding keys, or null for none; 1 <= S <= 128, D a
// multiple of 8. Returns the first CUDA error, or 0.
extern "C" int small_attn_forward(const void* q, const void* k, const void* v,
                                  const void* kpad, void* o, int B, int H, int S, int D,
                                  long long qsb, long long qsh, long long qsr, long long ksb,
                                  long long ksh, long long ksr, long long vsb, long long vsh,
                                  long long vsr, long long osb, long long osh, long long osr,
                                  float scale, int dtype, void* stream) {
  if (B < 1 || H < 1 || S < 1 || S > kMaxS || D < 8 || D % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  const Window W{{qsb, qsh, qsr}, {ksb, ksh, ksr}, {vsb, vsh, vsr}, {osb, osh, osr}};
  const int size = dtype == 0 ? 4 : 2;
  if (!aligned(q, W.q, size) || !aligned(k, W.k, size) || !aligned(v, W.v, size) ||
      !aligned(o, W.o, size)) {
    return cudaErrorMisalignedAddress;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* kp = static_cast<const unsigned char*>(kpad);
  if (D > kMaxTileD) {
    const exo::wide::Window WW{qsb, qsh, qsr, ksb, ksh, ksr, vsb, vsh, vsr, osb, osh, osr};
    if (dtype == 0) {
      return exo::wide::window<float, true>(q, k, v, kp, o, WW, B, H, S, D, scale, st);
    }
    if (dtype == 1) {
      return exo::wide::window<exo::wide::bf16, true>(q, k, v, kp, o, WW, B, H, S, D, scale, st);
    }
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) return f32::forward(q, k, v, kpad, o, W, B, H, S, D, scale, st);
  if (dtype == 1) return tcb::forward(q, k, v, kpad, o, W, B, H, S, D, scale, st);
  return cudaErrorInvalidValue;
}
