// Block attention, int8-qkv body: (x + MHA(LN_1(x)), LN_1(x)) over windows of
// S <= 128 tokens with the qkv product in int8; the design and the shared
// parts are in block_attn.cuh.
//
// Replaces the TPU kernel of exoground_tpu/ops/attention.py::_block_attn /
// fused_block_attn (:891, :927; pallas_call in _block_attn_pallas :833),
// body _block_attn_kernel_int8 (:636): qkv = float(quant(xn) . Wq) * xs *
// wsc + b_in, the unrounded f32 xn quantized per row (absmax / 127 over the
// row of C, round half to even, clip to +-127), W_in quantized per output row
// by the wrapper's plain quantizer; then the exact body's attention and
// out = o . W_out^T + b_out + x.
#include <cstddef>

#include "block_attn.cuh"

namespace {

constexpr int kThreads = exo::kBlockThreads;
constexpr int kKC = exo::kBlockKC;

// DHC: the head size when fixed at compile time, else 0 and it is dh.
template <typename T, int RT, int DHP, int DHC>
__global__ void __launch_bounds__(kThreads)
block_attn_int8_kernel(const T* __restrict__ x, const int* __restrict__ kpad,
                       const T* __restrict__ lnw, const T* __restrict__ lnb,
                       const int* __restrict__ wq, const float* __restrict__ wsc,
                       const T* __restrict__ b_in, T* __restrict__ attn, T* __restrict__ xn,
                       int S, int C, int H, int dh, float scale) {
  const int DH = DHC ? DHC : dh;
  using L = exo::BlockLayout<RT, DHP>;
  constexpr int SP = L::SP, QP = L::QP, XP = L::XP, WP = L::WP;
  constexpr int CT = 3 * DHP / 16;
  extern __shared__ float smem[];
  const exo::BlockSmem<RT, DHP> sm(smem, S);
  int* xst = reinterpret_cast<int*>(sm.uni);  // projection phase: int8 xn words, transposed
  int* wst = xst + kKC * XP;                  // projection phase: int8 W_in words, transposed

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int CW = C / 4;  // words of an int8 row
  const T* xb = x + size_t(b) * S * C;
  for (int j = tid; j < SP; j += kThreads) sm.km[j] = j < S ? kpad[size_t(b) * S + j] : 1;
  // ---- LN statistics and the int8 scale of the f32 xn of each row ----
  for (int r = warp; r < SP; r += kThreads / 32) {
    float m = 0.f, rstd = 0.f, am = 0.f;
    if (r < S) {
      const T* row = xb + size_t(r) * C;
      exo::warp_ln_stats(row, C, lane, m, rstd);
      am = exo::warp_ln_absmax(row, lnw, lnb, C, lane, m, rstd);
    }
    if (lane == 0) {
      sm.mu[r] = m;
      sm.rs[r] = rstd;
      sm.sc[r] = exo::row_scale(am);
    }
  }
  __syncthreads();

  // ---- int32 q_h, k_h, v_h = quant(xn) . Wq[rows of head h]^T ----
  int acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < CW; k0 += kKC) {
    {  // the thread stages word k0 + kw of rows tid / kKC + 8 i
      const int kw = tid % kKC, k = 4 * (k0 + kw);
      float g[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        g[i] = exo::to_f(lnw[k + i]);
        bb[i] = exo::to_f(lnb[k + i]);
      }
      for (int s = tid / kKC; s < SP; s += kThreads / kKC) {
        xst[kw * XP + s] =
            s < S ? exo::ln_quant_pack4(xb + size_t(s) * C + k, g, bb, sm.mu[s], sm.rs[s],
                                        sm.sc[s])
                  : 0;
      }
    }
    for (int e = tid; e < 3 * DHP * kKC; e += kThreads) {
      const int r = e / kKC, kw = e % kKC, d = r % DHP;
      const size_t row = size_t(r / DHP) * C + h * DH + d;
      wst[kw * WP + r] = d < DH ? wq[row * CW + k0 + kw] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < kKC; ++kw) {
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
    float* dst = part == 0 ? sm.qs : (part == 1 ? sm.ks : sm.vs);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int s = ty + 16 * i;
      dst[s * QP + d] = exo::dequant(acc[i][j], sm.sc[s], ws, bias);
    }
  }
  exo::write_x_norm(xb, lnw, lnb, sm.mu, sm.rs, xn + size_t(b) * S * C, S, C, h, DH);
  __syncthreads();  // qkv complete; the staging area becomes the score matrix
  exo::window_attention<T, DHC, kThreads>(sm.qs, sm.ks, sm.vs, QP, sm.uni, sm.km,
                                          attn + size_t(b) * S * C + h * DH, S, C, DH, scale);
}

struct Int8Body {
  template <typename T, int RT, int DHP, int DHC>
  static cudaError_t launch(const exo::BlockArgs& a, cudaStream_t st) {
    auto kernel = block_attn_int8_kernel<T, RT, DHP, DHC>;
    const size_t smem = exo::BlockLayout<RT, DHP>::bytes(a.S);
    cudaError_t err = exo::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int dh = a.C / a.H;
    kernel<<<a.B * a.H, kThreads, smem, st>>>(
        static_cast<const T*>(a.x), static_cast<const int*>(a.kpad),
        static_cast<const T*>(a.lnw), static_cast<const T*>(a.lnb),
        static_cast<const int*>(a.w_in), a.wsc, static_cast<const T*>(a.b_in),
        static_cast<T*>(a.attn), static_cast<T*>(a.xn), a.S, a.C, a.H, dh,
        1.0f / sqrtf(static_cast<float>(dh)));
    return cudaGetLastError();
  }
};

}  // namespace

// As block_attn_forward (csrc/block_attn.cu), with W_in quantized per row:
// wq (3C, C) int8 and wsc (3C) float32.
extern "C" int block_attn_int8_forward(const void* x, const void* kpad, const void* ln_w,
                                       const void* ln_b, const void* wq, const void* wsc,
                                       const void* b_in, const void* w_out, const void* b_out,
                                       void* attn, void* out, void* x_norm, int B, int S, int C,
                                       int H, int dtype, void* stream) {
  const exo::BlockArgs a{x, kpad, ln_w, ln_b, wq, static_cast<const float*>(wsc), b_in,
                         w_out, b_out, attn, out, x_norm, B, S, C, H};
  return exo::block_attn_dispatch<Int8Body>(a, dtype, stream);
}
