// Fused multi-head self-attention over windows of S <= 128 tokens.
//
// Replaces the TPU kernel exoground_tpu/ops/attention.py::_fused_mha
// (pallas_call in _mha_pallas, body _mha_kernel + _mha_attention_tail):
//   qkv = x . W_in^T + b_in; per head softmax(q k^T / sqrt(Dh), key padding) v;
//   out = concat_h(o_h) . W_out^T + b_out.
// Weights arrive in torch layout: W_in (3C, C) packed [q | k | v], W_out (C, C).
//
// What bounds it on an H100: operations. At the main-path shapes (B=304
// windows, S=64 and 64+Npad, C=512, H=8) the two projections are ~95% of the
// FLOPs (8*B*S*C^2) and the inputs are a few tens of MB, so the card's
// arithmetic rate decides; this first version runs on the CUDA cores in f32
// (no tensor cores), so it sits far from the bf16 tensor-core bound.
//
// Design. The TPU kernel keeps both weights (4 MB in f32) and a (128, 3C) f32
// qkv tile resident in VMEM and packs two 64-token windows per 128-row tile to
// fill the MXU. Neither fits a Hopper block's 227 KB of shared memory, and the
// packing has no purpose here, so:
//   1. mha_window_head_kernel: one CTA per (window, head). It streams W_in's
//      3*Dh rows of this head through shared memory in K chunks of 32,
//      accumulating q_h, k_h, v_h (S x Dh each) in registers (register tile of
//      ceil(S/16) x 3*Dhp/16 per thread, Dhp = Dh rounded up to 16; each of
//      q, k, v gets Dhp columns, those past Dh read zero weights and are
//      dropped; S and Dh are template parameters, so the index math is
//      compile-time), keeps them and the S x S f32
//      scores in shared memory, and writes o_h into an (B*S, C) scratch. The qkv and the
//      scores never reach device memory. Attention is per window: a window
//      whose keys are all padding averages its own S values uniformly, as the
//      plain path (attention_plain) does with its finite -1e30 fill.
//   2. linear_bias_kernel: the out-projection o . W_out^T + b_out as a tiled
//      64x64 GEMM. Heads are summed inside one dot product, so the result does
//      not depend on scheduling (no atomics across heads).
// The attention tail of step 1 and step 2 live in mha_tail.cuh, shared with
// the int8 variant (fused_mha_int8.cu).
// Head sizes: multiples of 8 up to 64 (the shared-memory budget at S = 128:
// q/k/v and the scores take 164 KB at Dh = 64). Larger heads are not served
// yet.
// Accumulation and softmax are f32 for float32 and bfloat16 inputs; o_h is
// rounded to the input type before the out-projection, as the TPU kernel casts
// it to W_out's type.
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "mha_tail.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;  // K chunk staged through shared memory
constexpr int kMaxDh = 64;         // largest head size served

// RT: register-tile rows / 16 (ceil(S/16)); DH: the head size (a multiple of 8).
template <int RT, int DH>
struct MhaLayout {
  static constexpr int DHP = (DH + 15) / 16 * 16;  // tile columns per q/k/v part
  static constexpr int SP = RT * 16;     // rows covered by the register tile
  static constexpr int QP = DHP + 1;     // q/k/v row pitch (odd: conflict-free)
  static constexpr int XP = SP + 1;      // staged x chunk pitch, [kKC][XP]
  static constexpr int WP = 3 * DHP + 1; // staged W_in chunk pitch, [kKC][WP]
  __host__ __device__ static int union_floats(int S) {
    int stage = kKC * (XP + WP);
    return stage > S * S ? stage : S * S;
  }
  __host__ __device__ static size_t bytes(int S) {
    return (size_t(3) * SP * QP + union_floats(S)) * sizeof(float) + SP * sizeof(int);
  }
};

template <typename T, int RT, int DH>
__global__ void __launch_bounds__(kThreads)
mha_window_head_kernel(const T* __restrict__ x, const int* __restrict__ kpad,
                       const T* __restrict__ w_in, const T* __restrict__ b_in,
                       T* __restrict__ attn, int S, int C, int H, float scale) {
  using L = MhaLayout<RT, DH>;
  constexpr int DHP = L::DHP, SP = L::SP, QP = L::QP, XP = L::XP, WP = L::WP;
  constexpr int CT = 3 * DHP / 16;  // tile column r: part r / DHP, d = r % DHP < DH
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + SP * QP;
  float* vs = ks + SP * QP;
  float* uni = vs + SP * QP;
  float* xs = uni;             // projection phase: x chunk, transposed
  float* ws = uni + kKC * XP;  // projection phase: W_in chunk, transposed
  float* ps = uni;             // attention phase: S x S scores / probabilities
  int* km = reinterpret_cast<int*>(uni + L::union_floats(S));

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int j = tid; j < SP; j += kThreads) km[j] = j < S ? kpad[size_t(b) * S + j] : 1;

  // ---- q_h, k_h, v_h = x_b . W_in[rows of head h]^T + b_in ----
  const T* xb = x + size_t(b) * S * C;
  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kKC) {
    for (int e = tid; e < SP * kKC; e += kThreads) {
      int s = e / kKC, kk = e % kKC;
      xs[kk * XP + s] = s < S ? exo::to_f(xb[size_t(s) * C + k0 + kk]) : 0.f;
    }
    for (int e = tid; e < 3 * DHP * kKC; e += kThreads) {
      int r = e / kKC, kk = e % kKC, d = r % DHP;
      size_t row = size_t(r / DHP) * C + h * DH + d;
      ws[kk * WP + r] = (DHP == DH || d < DH) ? exo::to_f(w_in[row * C + k0 + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      float a[RT], w[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = xs[kk * XP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CT; ++j) w[j] = ws[kk * WP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int r = tx + 16 * j, part = r / DHP, d = r % DHP;
    if (DHP != DH && d >= DH) continue;  // padding column (compile-time when DH % 16 == 0)
    const float bias = exo::to_f(b_in[part * C + h * DH + d]);
    float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
#pragma unroll
    for (int i = 0; i < RT; ++i) dst[(ty + 16 * i) * QP + d] = acc[i][j] + bias;
  }
  __syncthreads();  // qkv complete; the staging area becomes the score matrix
  exo::window_attention<T, DH, kThreads>(qs, ks, vs, QP, ps, km,
                                         attn + size_t(b) * S * C + h * DH, S, C, DH,
                                         scale);
}

template <typename T, int RT, int DH>
cudaError_t launch_attention(const void* x, const void* kpad, const void* w_in,
                             const void* b_in, void* attn, int B, int S, int C, int H,
                             cudaStream_t stream) {
  auto kernel = mha_window_head_kernel<T, RT, DH>;
  const size_t smem = MhaLayout<RT, DH>::bytes(S);
  cudaError_t err = exo::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(kpad),
      static_cast<const T*>(w_in), static_cast<const T*>(b_in), static_cast<T*>(attn),
      S, C, H, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t attention_by_rows(int rt, const void* x, const void* kpad, const void* w_in,
                              const void* b_in, void* attn, int B, int S, int C, int H,
                              cudaStream_t st) {
  switch (rt) {
    case 1: return launch_attention<T, 1, DH>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    case 2: return launch_attention<T, 2, DH>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    case 3: return launch_attention<T, 3, DH>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    case 4: return launch_attention<T, 4, DH>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    case 5: return launch_attention<T, 5, DH>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    case 6: return launch_attention<T, 6, DH>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    case 7: return launch_attention<T, 7, DH>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    case 8: return launch_attention<T, 8, DH>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t forward(const void* x, const void* kpad, const void* w_in, const void* b_in,
                    const void* w_out, const void* b_out, void* attn, void* out,
                    int B, int S, int C, int H, cudaStream_t st) {
  const int rt = (S + 15) / 16;
  cudaError_t err;
#define EXO_DH(dh) \
  case dh: err = attention_by_rows<T, dh>(rt, x, kpad, w_in, b_in, attn, B, S, C, H, st); break;
  switch (C / H) {
    EXO_DH(8) EXO_DH(16) EXO_DH(24) EXO_DH(32) EXO_DH(40) EXO_DH(48) EXO_DH(56) EXO_DH(64)
    default: err = cudaErrorInvalidValue;
  }
#undef EXO_DH
  if (err != cudaSuccess) return err;
  return exo::out_projection<T>(attn, w_out, b_out, out, B * S, C, st);
}

}  // namespace

// x (B, S, C), kpad (B, S) int32 nonzero at padding, w_in (3C, C), b_in (3C),
// w_out (C, C), b_out (C), attn scratch (B*S, C), out (B, S, C); all
// contiguous, of one type (dtype 0: float32, 1: bfloat16) apart from kpad;
// S <= 128, C a multiple of 32, head size C/H a multiple of 8 up to 64.
// Returns the first CUDA error of the launches, or 0.
extern "C" int fused_mha_forward(const void* x, const void* kpad, const void* w_in,
                                 const void* b_in, const void* w_out, const void* b_out,
                                 void* attn, void* out, int B, int S, int C, int H,
                                 int dtype, void* stream) {
  if (B < 1 || S < 1 || S > 128 || H < 1 || C % H != 0 || C % kKC != 0) {
    return cudaErrorInvalidValue;
  }
  if (C / H > kMaxDh || (C / H) % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return forward<float>(x, kpad, w_in, b_in, w_out, b_out, attn, out, B, S, C, H, st);
  }
  if (dtype == 1) {
    return forward<__nv_bfloat16>(x, kpad, w_in, b_in, w_out, b_out, attn, out, B, S, C, H,
                                  st);
  }
  return cudaErrorInvalidValue;
}
