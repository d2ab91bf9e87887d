// Block attention, exact body: (x + MHA(LN_1(x)), LN_1(x)) over windows of
// S <= 128 tokens; the design and the shared parts are in block_attn.cuh.
//
// Replaces the TPU kernel of exoground_tpu/ops/attention.py::_block_attn /
// fused_block_attn (:891, :927; pallas_call in _block_attn_pallas :833),
// body _block_attn_kernel (:616): qkv = round_T(xn) . W_in + b_in (f32
// sums), then per head softmax(q k^T / sqrt(Dh), key padding) v and
// out = o . W_out^T + b_out + x, as _mha_attention_tail (:575) with x_res.
#include <cstddef>

#include "block_attn.cuh"

namespace {

constexpr int kThreads = exo::kBlockThreads;
constexpr int kKC = exo::kBlockKC;

// DHC: the head size when fixed at compile time, else 0 and it is dh.
template <typename T, int RT, int DHP, int DHC>
__global__ void __launch_bounds__(kThreads)
block_attn_kernel(const T* __restrict__ x, const int* __restrict__ kpad,
                  const T* __restrict__ lnw, const T* __restrict__ lnb,
                  const T* __restrict__ w_in, const T* __restrict__ b_in, T* __restrict__ attn,
                  T* __restrict__ xn, int S, int C, int H, int dh, float scale) {
  const int DH = DHC ? DHC : dh;
  using L = exo::BlockLayout<RT, DHP>;
  constexpr int SP = L::SP, QP = L::QP, XP = L::XP, WP = L::WP;
  constexpr int CT = 3 * DHP / 16;  // tile column r: part r / DHP, d = r % DHP < DH
  extern __shared__ float smem[];
  const exo::BlockSmem<RT, DHP> sm(smem, S);
  float* xs = sm.uni;             // projection phase: xn chunk, transposed
  float* ws = sm.uni + kKC * XP;  // projection phase: W_in chunk, transposed

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const T* xb = x + size_t(b) * S * C;
  for (int j = tid; j < SP; j += kThreads) sm.km[j] = j < S ? kpad[size_t(b) * S + j] : 1;
  // ---- LN statistics of the window's rows ----
  for (int r = warp; r < S; r += kThreads / 32) {
    float m, rstd;
    exo::warp_ln_stats(xb + size_t(r) * C, C, lane, m, rstd);
    if (lane == 0) {
      sm.mu[r] = m;
      sm.rs[r] = rstd;
    }
  }
  __syncthreads();

  // ---- q_h, k_h, v_h = round_T(xn) . W_in[rows of head h]^T + b_in ----
  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kKC) {
    {  // the thread stages column k0 + kk of rows tid / kKC + 8 i
      const int kk = tid % kKC, k = k0 + kk;
      const float g = exo::to_f(lnw[k]), bb = exo::to_f(lnb[k]);
      for (int s = tid / kKC; s < SP; s += kThreads / kKC) {
        float v = 0.f;
        if (s < S) {
          v = exo::ln_apply(exo::to_f(xb[size_t(s) * C + k]), sm.mu[s], sm.rs[s], g, bb);
          v = exo::to_f(exo::from_f<T>(v));  // xn rounded to the weights' type
        }
        xs[kk * XP + s] = v;
      }
    }
    for (int e = tid; e < 3 * DHP * kKC; e += kThreads) {
      const int r = e / kKC, kk = e % kKC, d = r % DHP;
      const size_t row = size_t(r / DHP) * C + h * DH + d;
      ws[kk * WP + r] = d < DH ? exo::to_f(w_in[row * C + k0 + kk]) : 0.f;
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
    if (d >= DH) continue;  // padding column
    const float bias = exo::to_f(b_in[part * C + h * DH + d]);
    float* dst = part == 0 ? sm.qs : (part == 1 ? sm.ks : sm.vs);
#pragma unroll
    for (int i = 0; i < RT; ++i) dst[(ty + 16 * i) * QP + d] = acc[i][j] + bias;
  }
  exo::write_x_norm(xb, lnw, lnb, sm.mu, sm.rs, xn + size_t(b) * S * C, S, C, h, DH);
  __syncthreads();  // qkv complete; the staging area becomes the score matrix
  exo::window_attention<T, DHC, kThreads>(sm.qs, sm.ks, sm.vs, QP, sm.uni, sm.km,
                                          attn + size_t(b) * S * C + h * DH, S, C, DH, scale);
}

struct ExactBody {
  template <typename T, int RT, int DHP, int DHC>
  static cudaError_t launch(const exo::BlockArgs& a, cudaStream_t st) {
    auto kernel = block_attn_kernel<T, RT, DHP, DHC>;
    const size_t smem = exo::BlockLayout<RT, DHP>::bytes(a.S);
    cudaError_t err = exo::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int dh = a.C / a.H;
    kernel<<<a.B * a.H, kThreads, smem, st>>>(
        static_cast<const T*>(a.x), static_cast<const int*>(a.kpad),
        static_cast<const T*>(a.lnw), static_cast<const T*>(a.lnb),
        static_cast<const T*>(a.w_in), static_cast<const T*>(a.b_in), static_cast<T*>(a.attn),
        static_cast<T*>(a.xn), a.S, a.C, a.H, dh, 1.0f / sqrtf(static_cast<float>(dh)));
    return cudaGetLastError();
  }
};

}  // namespace

// x (B, S, C), kpad (B, S) int32 nonzero at padding, ln_w and ln_b (C), w_in
// (3C, C), b_in (3C), w_out (C, C), b_out (C), attn scratch (B*S, C), out and
// x_norm (B, S, C); all contiguous, of one type (dtype 0: float32, 1:
// bfloat16) apart from kpad; S <= 128, C a multiple of 128, head size C/H a
// multiple of 8 up to 64. Returns the first CUDA error of the launches, or 0.
extern "C" int block_attn_forward(const void* x, const void* kpad, const void* ln_w,
                                  const void* ln_b, const void* w_in, const void* b_in,
                                  const void* w_out, const void* b_out, void* attn, void* out,
                                  void* x_norm, int B, int S, int C, int H, int dtype,
                                  void* stream) {
  const exo::BlockArgs a{x, kpad, ln_w, ln_b, w_in, nullptr, b_in, w_out, b_out,
                         attn, out, x_norm, B, S, C, H};
  return exo::block_attn_dispatch<ExactBody>(a, dtype, stream);
}
