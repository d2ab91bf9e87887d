// Fused multi-head self-attention over windows of S <= 128 tokens with an
// int8 qkv projection (the int8 serving mode).
//
// Replaces the TPU kernel exoground_tpu/ops/attention.py::_fused_mha_int8
// (:777; pallas_call in _mha_pallas :736, body _mha_kernel_int8 :674 +
// _mha_attention_tail :575):
//   xq, xs = per-row int8 quantization of x (absmax / 127 over the row of C,
//            round half to even, clip to +-127), inside the kernel;
//   qkv = float(xq . Wq^T) * xs * wsc + b_in   (int8 x int8 -> int32, then f32);
//   per head softmax(q k^T / sqrt(Dh), key padding) v;  out = o . W_out^T + b_out.
// W_in arrives quantized per output row (torch layout (3C, C) int8, packed
// [q | k | v], scales (3C) float32), by the wrapper's plain quantizer; b_in,
// W_out, b_out are of the input type. Attention and the out-projection are
// exact, as in the TPU kernel.
//
// What bounds it on an H100: operations. At the main-path shapes (B = 304
// windows, S = 64 and 96, C = 512, H = 8) the int8 projection is 6*B*S*C^2
// operations (1,979 TOPS on int8 tensor cores), the out-projection 2*B*S*C^2
// and the attention 4*B*S^2*C (f32 at 67 TFLOP/s, bf16 at 989 on tensor
// cores); the inputs are a few tens of MB. The (window, head) kernel runs
// its products on the CUDA cores: the int8 product as __dp4a (4
// multiply-adds an instruction, exact int32 sums), the rest in f32, far from
// the tensor-core bound; in bf16 the out-projection of mha_tail.cuh runs on
// the tensor cores.
//
// Design: fused_mha.cu's, with only the projection phase changed.
//   1. mha_int8_window_head_kernel: one CTA per (window, head). A first pass
//      takes each of the window's S rows' absmax over the whole row (one warp
//      a row) into shared memory; the K loop then quantizes the x chunk to
//      int8 as it stages it (packed 4 to a word), stages this head's 3*Dh
//      int8 W_in rows as they are, and accumulates in int32 registers with
//      __dp4a. The epilogue turns the sums into f32 q, k, v in shared memory;
//      the shared tail (mha_tail.cuh) computes the per-window attention and
//      writes o_h to an (B*S, C) scratch. Every chunk uses the whole row's
//      scale, so the kernel's int8 values equal the plain quantizer's.
//   2. the tiled out-projection of mha_tail.cuh.
// Head sizes: multiples of 8 up to 64. The register tile is templated on the
// head size rounded up to 16 (DHP) and on ceil(S/16); the head size itself is
// a run-time argument, so 64 instantiations serve every case.
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "mha_tail.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKW = 32;     // K chunk in 4-byte words of int8 (128 values)
constexpr int kMaxDh = 64;  // largest head size served

// RT: register-tile rows / 16 (ceil(S/16)); DHP: the head size rounded up to 16.
template <int RT, int DHP>
struct MhaInt8Layout {
  static constexpr int SP = RT * 16;      // rows covered by the register tile
  static constexpr int QP = DHP + 1;      // q/k/v row pitch (odd: conflict-free)
  static constexpr int XP = SP + 1;       // staged x words pitch, [kKW][XP]
  static constexpr int WP = 3 * DHP + 1;  // staged W_in words pitch, [kKW][WP]
  __host__ __device__ static int union_words(int S) {
    int stage = kKW * (XP + WP);
    return stage > S * S ? stage : S * S;
  }
  // q, k, v; the staging area / scores; row scales; key-padding flags
  __host__ __device__ static size_t bytes(int S) {
    return (size_t(3) * SP * QP + union_words(S) + 2 * SP) * 4;
  }
};

template <typename T, int RT, int DHP>
__global__ void __launch_bounds__(kThreads)
mha_int8_window_head_kernel(const T* __restrict__ x, const int* __restrict__ kpad,
                            const int* __restrict__ wq, const float* __restrict__ wsc,
                            const T* __restrict__ b_in, T* __restrict__ attn, int S, int C,
                            int H, int DH, float scale) {
  using L = MhaInt8Layout<RT, DHP>;
  constexpr int SP = L::SP, QP = L::QP, XP = L::XP, WP = L::WP;
  constexpr int CT = 3 * DHP / 16;  // tile column r: part r / DHP, d = r % DHP < DH
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + SP * QP;
  float* vs = ks + SP * QP;
  float* uni = vs + SP * QP;
  int* xst = reinterpret_cast<int*>(uni);  // projection phase: int8 x words, transposed
  int* wst = xst + kKW * XP;               // projection phase: int8 W_in words, transposed
  float* ps = uni;                         // attention phase: S x S scores
  float* xsc = uni + L::union_words(S);    // row scales
  int* km = reinterpret_cast<int*>(xsc + SP);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int CW = C / 4;  // words of an int8 row
  const T* xb = x + size_t(b) * S * C;
  for (int j = tid; j < SP; j += kThreads) km[j] = j < S ? kpad[size_t(b) * S + j] : 1;
  // ---- the scale of each row: absmax over the whole row of C ----
  for (int r = warp; r < SP; r += kThreads / 32) {
    const float m = r < S ? exo::warp_absmax(xb + size_t(r) * C, C, lane) : 0.f;
    if (lane == 0) xsc[r] = exo::row_scale(m);
  }
  __syncthreads();

  // ---- int32 q_h, k_h, v_h = xq . Wq[rows of head h]^T ----
  int acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < CW; k0 += kKW) {
    for (int e = tid; e < SP * kKW; e += kThreads) {
      const int s = e / kKW, kw = e % kKW;
      xst[kw * XP + s] =
          s < S ? exo::quant_pack4(xb + size_t(s) * C + 4 * (k0 + kw), xsc[s]) : 0;
    }
    for (int e = tid; e < 3 * DHP * kKW; e += kThreads) {
      const int r = e / kKW, kw = e % kKW, d = r % DHP;
      const size_t row = size_t(r / DHP) * C + h * DH + d;
      wst[kw * WP + r] = d < DH ? wq[row * CW + k0 + kw] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < kKW; ++kw) {
      int a[RT], w[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = xst[kw * XP + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CT; ++j) w[j] = wst[kw * WP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = __dp4a(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
  // ---- epilogue: float(acc) * xs * wsc + b_in, in f32 ----
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int r = tx + 16 * j, part = r / DHP, d = r % DHP;
    if (d >= DH) continue;  // padding column
    const int row = part * C + h * DH + d;
    const float ws = wsc[row], bias = exo::to_f(b_in[row]);
    float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int s = ty + 16 * i;
      dst[s * QP + d] = exo::dequant(acc[i][j], xsc[s], ws, bias);
    }
  }
  __syncthreads();  // qkv complete; the staging area becomes the score matrix
  exo::window_attention<T, 0, kThreads>(qs, ks, vs, QP, ps, km,
                                        attn + size_t(b) * S * C + h * DH, S, C, DH, scale);
}

template <typename T, int RT, int DHP>
cudaError_t launch_attention(const void* x, const void* kpad, const void* wq,
                             const void* wsc, const void* b_in, void* attn, int B, int S,
                             int C, int H, cudaStream_t st) {
  auto kernel = mha_int8_window_head_kernel<T, RT, DHP>;
  const size_t smem = MhaInt8Layout<RT, DHP>::bytes(S);
  cudaError_t err = exo::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int dh = C / H;
  kernel<<<B * H, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(kpad), static_cast<const int*>(wq),
      static_cast<const float*>(wsc), static_cast<const T*>(b_in), static_cast<T*>(attn), S,
      C, H, dh, 1.0f / sqrtf(static_cast<float>(dh)));
  return cudaGetLastError();
}

template <typename T, int DHP>
cudaError_t attention_by_rows(int rt, const void* x, const void* kpad, const void* wq,
                              const void* wsc, const void* b_in, void* attn, int B, int S,
                              int C, int H, cudaStream_t st) {
#define EXO_RT(n) \
  case n: return launch_attention<T, n, DHP>(x, kpad, wq, wsc, b_in, attn, B, S, C, H, st);
  switch (rt) {
    EXO_RT(1) EXO_RT(2) EXO_RT(3) EXO_RT(4) EXO_RT(5) EXO_RT(6) EXO_RT(7) EXO_RT(8)
    default: return cudaErrorInvalidValue;
  }
#undef EXO_RT
}

template <typename T>
cudaError_t forward(const void* x, const void* kpad, const void* wq, const void* wsc,
                    const void* b_in, const void* w_out, const void* b_out, void* attn,
                    void* out, int B, int S, int C, int H, cudaStream_t st) {
  const int rt = (S + 15) / 16;
  cudaError_t err;
  switch ((C / H + 15) / 16) {
    case 1: err = attention_by_rows<T, 16>(rt, x, kpad, wq, wsc, b_in, attn, B, S, C, H, st); break;
    case 2: err = attention_by_rows<T, 32>(rt, x, kpad, wq, wsc, b_in, attn, B, S, C, H, st); break;
    case 3: err = attention_by_rows<T, 48>(rt, x, kpad, wq, wsc, b_in, attn, B, S, C, H, st); break;
    case 4: err = attention_by_rows<T, 64>(rt, x, kpad, wq, wsc, b_in, attn, B, S, C, H, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return exo::out_projection<T>(attn, w_out, b_out, out, B * S, C, st);
}

}  // namespace

// x (B, S, C), kpad (B, S) int32 nonzero at padding, wq (3C, C) int8 and wsc
// (3C) float32 (W_in quantized per row), b_in (3C), w_out (C, C), b_out (C),
// attn scratch (B*S, C), out (B, S, C); all contiguous; x, b_in, w_out, b_out,
// attn and out of one type (dtype 0: float32, 1: bfloat16); S <= 128, C a
// multiple of 128, head size C/H a multiple of 8 up to 64. Returns the first
// CUDA error of the launches, or 0.
extern "C" int fused_mha_int8_forward(const void* x, const void* kpad, const void* wq,
                                      const void* wsc, const void* b_in, const void* w_out,
                                      const void* b_out, void* attn, void* out, int B, int S,
                                      int C, int H, int dtype, void* stream) {
  if (B < 1 || S < 1 || S > 128 || H < 1 || C % H != 0 || C % (4 * kKW) != 0) {
    return cudaErrorInvalidValue;
  }
  if (C / H > kMaxDh || (C / H) % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return forward<float>(x, kpad, wq, wsc, b_in, w_out, b_out, attn, out, B, S, C, H, st);
  }
  if (dtype == 1) {
    return forward<__nv_bfloat16>(x, kpad, wq, wsc, b_in, w_out, b_out, attn, out, B, S, C,
                                  H, st);
  }
  return cudaErrorInvalidValue;
}
