// Window attention core over (B*H) windows of S <= 128 tokens.
//
// Replaces the TPU kernel exoground_tpu/ops/attention.py::_small
// (pallas_call in _small_impl, body _small_kernel): from q (pre-scaled by
// 1/sqrt(D)), k and v of one window,
//   s = q k^T in f32, keys masked where kpad != 0 (the finite -1e30 fill),
//   m = row max, p = exp(s - m) in f32, l = sum of the unrounded p,
//   o = (p rounded to v's type) . v accumulated in f32, then o / l,
// rounded to q's type. The normalisation comes after the product, as in the
// TPU body (attention_plain normalises before it).
//
// What bounds it on an H100: at the serving shapes (B*H = 512 windows at
// S = 64 and 128, 2432 at S = 64 and 96; D = 64) the work is 4*BH*S^2*D
// flops over 4*BH*S*D elements of input and output, 32-64 flops a float32
// element: on the CUDA cores' 67 TFLOP/s the operations bound it, on the
// bf16 tensor cores the bytes would. This first version runs on the CUDA
// cores in f32.
//
// Design. The TPU kernel packs two 64-token windows into one 128-row tile
// with a block-diagonal mask and runs 8 tiles a grid step, to fill the
// MXU's rows; neither has a purpose here. One CTA owns one (batch, head)
// window: it stages k and v in f32 in shared memory (row pitch D + 1, odd,
// so 32 lanes reading 32 key rows hit 32 banks; 2*128*129*4 B = 129 KB at
// the largest S and D), and each of its 8 warps owns query rows in turn:
// its lanes hold the scores of keys lane, lane+32, ... in registers, a warp
// reduction gives m and l, the rounded p goes to the warp's row buffer, and
// lane d accumulates o[d] over the keys. Nothing but q, k, v, kpad in and o
// out touches device memory.
// A window whose keys are all padding averages its own S values uniformly
// (every score -1e30, so p = 1 for each key), as attention_plain does; the
// TPU kernel averages all 128 columns of its packed tile instead.
// Head sizes: multiples of 8 up to 128.
#include <cfloat>
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 128;
constexpr int kMaxD = 128;
constexpr int kKeysPerLane = kMaxS / 32;
constexpr int kColsPerLane = kMaxD / 32;
constexpr float kNegInf = -1e30f;  // finite fill, as the plain version's NEG_INF

size_t smem_bytes(int S, int D) {
  return (size_t(2) * S * (D + 1) + size_t(kWarps) * (D + S)) * sizeof(float) +
         size_t(S) * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
small_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ kpad, T* __restrict__ o, int H, int S, int D) {
  extern __shared__ float smem[];
  const int KP = D + 1;
  float* ks = smem;                 // S x KP
  float* vs = ks + S * KP;          // S x KP
  float* qb = vs + S * KP;          // kWarps x D: the warp's query row
  float* pb = qb + kWarps * D;      // kWarps x S: the warp's rounded p
  int* km = reinterpret_cast<int*>(pb + kWarps * S);

  const int bh = blockIdx.x, b = bh / H;
  const size_t base = size_t(bh) * S * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < S * D; e += kThreads) {
    const int j = e / D, d = e % D;
    ks[j * KP + d] = exo::to_f(k[base + e]);
    vs[j * KP + d] = exo::to_f(v[base + e]);
  }
  for (int j = tid; j < S; j += kThreads) km[j] = kpad[size_t(b) * S + j];
  __syncthreads();

  float* qw = qb + warp * D;
  float* pw = pb + warp * S;
  // key rows of this lane (clamped in range; the scores past S are unused)
  int koff[kKeysPerLane];
#pragma unroll
  for (int t = 0; t < kKeysPerLane; ++t) {
    const int j = lane + 32 * t;
    koff[t] = (j < S ? j : S - 1) * KP;
  }
  for (int i = warp; i < S; i += kWarps) {
    for (int d = lane; d < D; d += 32) qw[d] = exo::to_f(q[base + size_t(i) * D + d]);
    __syncwarp();

    // ---- scores of keys lane + 32 t, masked by key padding ----
    float s[kKeysPerLane];
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) s[t] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = qw[d];
#pragma unroll
      for (int t = 0; t < kKeysPerLane; ++t) s[t] = fmaf(qd, ks[koff[t] + d], s[t]);
    }
    float m = -FLT_MAX;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < S) {
        if (km[j]) s[t] = kNegInf;
        m = fmaxf(m, s[t]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));

    // ---- p = exp(s - m); l over the unrounded p; p rounded to T for p . v ----
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerLane; ++t) {
      const int j = lane + 32 * t;
      if (j < S) {
        const float p = expf(s[t] - m);
        l += p;
        pw[j] = exo::to_f(exo::from_f<T>(p));
      }
    }
    l = exo::warp_sum(l);
    __syncwarp();

    // ---- o[d] = sum_j p_j v[j, d], then / l ----
    float acc[kColsPerLane];
#pragma unroll
    for (int u = 0; u < kColsPerLane; ++u) acc[u] = 0.f;
    for (int j = 0; j < S; ++j) {
      const float pj = pw[j];
      const float* vr = vs + j * KP;
#pragma unroll
      for (int u = 0; u < kColsPerLane; ++u) {
        const int d = lane + 32 * u;
        if (d < D) acc[u] = fmaf(pj, vr[d], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kColsPerLane; ++u) {
      const int d = lane + 32 * u;
      if (d < D) o[base + size_t(i) * D + d] = exo::from_f<T>(acc[u] / l);
    }
    __syncwarp();  // the row buffers are refilled for the warp's next row
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kpad, void* o,
                   int BH, int H, int S, int D, cudaStream_t st) {
  const size_t smem = smem_bytes(S, D);
  cudaError_t err = exo::allow_smem(small_attn_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  small_attn_kernel<T><<<BH, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kpad), static_cast<T*>(o), H, S, D);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o (BH, S, D), q pre-scaled by 1/sqrt(D); kpad (B, S) int32
// nonzero at padding keys, B = BH / H (heads share their window's mask); all
// contiguous, q/k/v/o of one type (dtype 0: float32, 1: bfloat16); 1 <= S <=
// 128, D a multiple of 8 up to 128. Returns the first CUDA error, or 0.
extern "C" int small_attn_forward(const void* q, const void* k, const void* v,
                                  const void* kpad, void* o, int BH, int H, int S, int D,
                                  int dtype, void* stream) {
  if (BH < 1 || H < 1 || BH % H != 0 || S < 1 || S > kMaxS || D < 8 || D > kMaxD ||
      D % 8 != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, kpad, o, BH, H, S, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, kpad, o, BH, H, S, D, st);
  return cudaErrorInvalidValue;
}
