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
// arithmetic rate decides: 67 TFLOP/s for f32 on the CUDA cores, 989 for
// bf16 on the tensor cores.
//
// Two bodies, by input type; both keep the (S, 3C) qkv and the S x S scores
// out of device memory, and both end in the out-projection of mha_tail.cuh.
//
// float32: the first design, kept as it was (the f32 limit of 1e-4 of
// max|plain| rules out plain TF32). The TPU kernel keeps both weights (4 MB
// in f32) and a (128, 3C) f32 qkv tile resident in VMEM and packs two
// 64-token windows per 128-row tile to fill the MXU. Neither fits a Hopper
// block's 227 KB of shared memory, so:
//   1. mha_window_head_kernel: one CTA per (window, head). It streams W_in's
//      3*Dh rows of this head through shared memory in K chunks of 32,
//      accumulating q_h, k_h, v_h (S x Dh each) in registers (register tile of
//      ceil(S/16) x 3*Dhp/16 per thread, Dhp = Dh rounded up to 16; each of
//      q, k, v gets Dhp columns, those past Dh read zero weights and are
//      dropped; S and Dh are template parameters, so the index math is
//      compile-time), keeps them and the S x S f32
//      scores in shared memory, and writes o_h into an (B*S, C) scratch.
//      Attention is per window: a window
//      whose keys are all padding averages its own S values uniformly, as the
//      plain path (attention_plain) does with its finite -1e30 fill.
//   2. linear_bias_kernel: the out-projection o . W_out^T + b_out as a tiled
//      64x64 GEMM. Heads are summed inside one dot product, so the result does
//      not depend on scheduling (no atomics across heads).
// Accumulation and softmax are f32; the first body also served bf16 this way
// (converting every value to f32 as it staged it) at 2% of the card's bf16
// rate.
//
// bfloat16: mha_bf16_kernel, every product on the tensor cores (tc.cuh,
// mma.sync m16n8k16, bf16 operands, f32 accumulators), one CTA of 8 warps
// per (128-row tile, head). The tile holds two windows of S <= 64 (each at
// rows 64 w..) or one of S <= 128, as the TPU kernel packs them (:660-664):
// each CTA streams its head's 3*Dh W_in rows once for 128 rows instead of
// 64, which halves the weight traffic from L2, the body's largest, at the
// main path's S = 64; S = 96 runs a third of its rows as zero padding.
//   1. qkv_h = x . W_in,h^T: x and W_in chunks of K = 64 arrive by 16-byte
//      cp.async in a two-stage ring (row pitch 72 elements: conflict-free
//      ldmatrix); each warp owns 32 rows x 3*Dhp/2 columns of f32
//      accumulators. The bias is added in f32 and q, k and v are rounded to
//      bf16 into shared memory (over the staging ring): the rounding of
//      mha_plain's bf16 F.linear.
//   2. each warp owns 16 query rows: s = q . k^T on the tensor cores, times
//      1/sqrt(Dh) in f32 (as attention_plain scales the f32 scores), padding
//      keys at -1e30 and keys past S excluded, the softmax on the fragments
//      with quad shuffles, p normalised and rounded to bf16 (attention_plain
//      casts p to v's type) and repacked into A fragments in registers;
//      o = p . v (v by ldmatrix.trans), rounded to bf16 into the (B*S, C)
//      scratch, as the TPU kernel casts o_h to W_out's type.
//   3. the tensor-core out-projection of mha_tail.cuh.
// The template covers the head tile only (Dhp = 16, 32, 48, 64: four
// instantiations); S and Dh are run-time values. x and W_in must be 16-byte
// aligned (cp.async), C a multiple of 8.
// Head sizes: multiples of 8 up to 64 in both bodies (the f32 body's
// shared-memory budget at S = 128: q/k/v and the scores take 164 KB at Dh =
// 64). Larger heads are not served yet.
#include <cstddef>
#include <cstdint>
#include <math.h>

#include "common.cuh"
#include "mha_tail.cuh"
#include "tc.cuh"

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

// ======================================================= bf16: tensor cores
namespace tcm {

using bf16 = __nv_bfloat16;
using exo::tc::a_col;
using exo::tc::a_row;
using exo::tc::b_col;
using exo::tc::b_row;
using exo::tc::ldsm_x2;
using exo::tc::ldsm_x4;
using exo::tc::ldsm_x4_t;
using exo::tc::mma;
using exo::tc::pack_bf16;
using exo::tc::quad_max;
using exo::tc::quad_sum;

constexpr int kTh = 256;          // 8 warps
constexpr int kRows = 128;        // CTA row tile: two windows of S <= 64 or one of S <= 128
constexpr int kKCt = 64;          // K chunk of the projection
constexpr int kXPt = kKCt + 8;    // staged row pitch (72 elements)

// DHP: the head size rounded up to 16.
template <int DHP>
struct TcMha {
  static constexpr int N = 3 * DHP;                   // projection columns [q | k | v]
  static constexpr int NTW = N / 16;                  // n-tiles per warp (2 warp columns)
  static constexpr int QP = DHP + 8;                  // q/k/v row pitch
  static constexpr int STAGE = (kRows + N) * kXPt;    // one ring stage: x chunk, W chunk
  static constexpr int QKV = 3 * kRows * QP;          // q, k, v (over the ring)
  static constexpr int ELEMS = 2 * STAGE > QKV ? 2 * STAGE : QKV;
  static constexpr size_t bytes = sizeof(bf16) * ELEMS + sizeof(int) * kRows;
};

// Tile row r holds token r % RW of window b0 + r / RW (RW = 64 packs two
// windows of S <= 64, RW = 128 holds one); it is real when the token is < S
// and the window < B.
// Two CTAs an SM (a cap of 128 registers; at Dh 64 it spills ~120 bytes a
// thread) keep a second CTA's loads in flight under one's products, which
// one CTA of 168 spill-free registers does not.
template <int DHP>
__global__ void __launch_bounds__(kTh, 2)
mha_bf16_kernel(const bf16* __restrict__ x, const int* __restrict__ kpad,
                const bf16* __restrict__ w_in, const bf16* __restrict__ b_in,
                bf16* __restrict__ attn, int B, int S, int C, int H, float scale) {
  using L = TcMha<DHP>;
  extern __shared__ __align__(16) unsigned char smem_m[];
  bf16* ring = reinterpret_cast<bf16*>(smem_m);
  int* km = reinterpret_cast<int*>(ring + L::ELEMS);
  const int DH = C / H;
  const int RW = S <= 64 ? 64 : 128;
  const int b0 = (blockIdx.x / H) * (kRows / RW), h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = 2 * (lane % 4);

  for (int r = tid; r < kRows; r += kTh) {
    const int b = b0 + r / RW, t = r % RW;
    km[r] = (t < S && b < B) ? kpad[size_t(b) * S + t] : 1;
  }

  // ---- 1. qkv_h = x . W_in,h^T + b_in, f32 accumulators ----
  auto stage_chunk = [&](int k0, int st) {
    bf16* xs = ring + st * L::STAGE;
    bf16* ws = xs + kRows * kXPt;
    constexpr int kCh = kKCt / 8;  // 16-byte chunks a row
    for (int e = tid; e < kRows * kCh; e += kTh) {
      const int r = e / kCh, cc = (e % kCh) * 8;
      const int b = b0 + r / RW, t = r % RW;
      const bool in = t < S && b < B && k0 + cc < C;
      exo::tc::cp_async16(xs + r * kXPt + cc, in ? x + (size_t(b) * S + t) * C + k0 + cc : x,
                          in);
    }
    for (int e = tid; e < L::N * kCh; e += kTh) {
      const int n = e / kCh, cc = (e % kCh) * 8;
      const int part = n / DHP, d = n % DHP;
      const bool in = d < DH && k0 + cc < C;
      exo::tc::cp_async16(
          ws + n * kXPt + cc,
          in ? w_in + (size_t(part) * C + size_t(h) * DH + d) * C + k0 + cc : w_in, in);
    }
  };
  const int wm = warp / 2, wn = warp % 2;  // 32 rows x NTW n-tiles a warp
  float acc[2][L::NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < L::NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  const int nch = (C + kKCt - 1) / kKCt;
  stage_chunk(0, 0);
  exo::tc::cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch & 1;
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (ch + 1 < nch) stage_chunk((ch + 1) * kKCt, st ^ 1);
    exo::tc::cp_async_commit();
    exo::tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* xs = ring + st * L::STAGE;
    const bf16* ws = xs + kRows * kXPt + wn * L::NTW * 8 * kXPt;
#pragma unroll
    for (int kk = 0; kk < kKCt / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(a[mt], xs + (wm * 32 + mt * 16 + a_row(lane)) * kXPt + kk * 16 + a_col(lane));
#pragma unroll
      for (int j = 0; j < L::NTW; j += 2) {
        if (j + 1 < L::NTW) {
          uint32_t b[4];
          ldsm_x4(b, ws + (j * 8 + b_row(lane)) * kXPt + kk * 16 + b_col(lane));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma(acc[mt][j], a[mt], b[0], b[1]);
            mma(acc[mt][j + 1], a[mt], b[2], b[3]);
          }
        } else {  // an odd last n-tile (Dhp = 16 or 48)
          uint32_t b[2];
          ldsm_x2(b, ws + (j * 8 + (lane & 7)) * kXPt + kk * 16 + (lane & 8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma(acc[mt][j], a[mt], b[0], b[1]);
        }
      }
    }
  }
  __syncthreads();  // the ring becomes q, k, v
  bf16* qs = ring;
  bf16* ks = qs + kRows * L::QP;
  bf16* vs = ks + kRows * L::QP;
#pragma unroll
  for (int j = 0; j < L::NTW; ++j) {
    const int n = (wn * L::NTW + j) * 8 + c, part = n / DHP, d = n % DHP;
    bf16* dst = part == 0 ? qs : (part == 1 ? ks : vs);
    float b_lo = 0.f, b_hi = 0.f;
    if (d < DH) {
      b_lo = exo::to_f(b_in[size_t(part) * C + h * DH + d]);
      b_hi = exo::to_f(b_in[size_t(part) * C + h * DH + d + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + mt * 16 + g + 8 * half;
        const bool col_in = d < DH;  // padding columns stay 0
        const float v0 = col_in ? acc[mt][j][2 * half] + b_lo : 0.f;
        const float v1 = col_in ? acc[mt][j][2 * half + 1] + b_hi : 0.f;
        *reinterpret_cast<uint32_t*>(dst + r * L::QP + d) = pack_bf16(v0, v1);
      }
  }
  __syncthreads();

  // ---- 2. attention: warp w owns query rows 16 w.. of the tile ----
  const int win = 16 * warp / RW, kb = win * RW, t0 = 16 * warp - kb;
  if (t0 >= S || b0 + win >= B) return;  // padding rows only: no barrier follows
  const int nk16 = (S + 15) / 16;        // key k-steps of 16
  float s[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qs + (16 * warp + a_row(lane)) * L::QP + kk * 16 + a_col(lane));
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      if (np < nk16) {
        uint32_t b[4];
        ldsm_x4(b, ks + (kb + np * 16 + b_row(lane)) * L::QP + kk * 16 + b_col(lane));
        mma(s[2 * np], a, b[0], b[1]);
        mma(s[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  // scores in f32 times 1/sqrt(Dh); padding keys at -1e30 (a window whose
  // keys are all padding averages its own S values), keys past S excluded
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    if (nt / 2 < nk16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = nt * 8 + c + (e & 1);
        float v = t >= S ? -INFINITY : (km[kb + t] ? exo::kMhaNegInf : s[nt][e] * scale);
        s[nt][e] = v;
        mx[e / 2] = fmaxf(mx[e / 2], v);
      }
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
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
  // o = (p / l rounded to bf16) . v
  float o[DHP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DHP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    if (kk < nk16) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0] / l[0], s[2 * kk][1] / l[0]),
                             pack_bf16(s[2 * kk][2] / l[1], s[2 * kk][3] / l[1]),
                             pack_bf16(s[2 * kk + 1][0] / l[0], s[2 * kk + 1][1] / l[0]),
                             pack_bf16(s[2 * kk + 1][2] / l[1], s[2 * kk + 1][3] / l[1])};
#pragma unroll
      for (int dp = 0; dp < DHP / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + (kb + kk * 16 + a_row(lane)) * L::QP + dp * 16 + a_col(lane));
        mma(o[2 * dp], a, b[0], b[1]);
        mma(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
  // o_h rounded to bf16 into the (B*S, C) scratch, columns h*Dh..
  bf16* ob = attn + size_t(b0 + win) * S * C + size_t(h) * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + g + 8 * half;
    if (t >= S) continue;
#pragma unroll
    for (int nt = 0; nt < DHP / 8; ++nt) {
      const int d = nt * 8 + c;
      if (d < DH) {
        *reinterpret_cast<uint32_t*>(ob + size_t(t) * C + d) =
            pack_bf16(o[nt][2 * half], o[nt][2 * half + 1]);
      }
    }
  }
}

template <int DHP>
cudaError_t launch(const void* x, const void* kpad, const void* w_in, const void* b_in,
                   void* attn, int B, int S, int C, int H, cudaStream_t st) {
  auto kernel = mha_bf16_kernel<DHP>;
  constexpr size_t smem = TcMha<DHP>::bytes;
  cudaError_t err = exo::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int wpc = S <= 64 ? 2 : 1;  // windows a CTA's 128 rows hold
  kernel<<<((B + wpc - 1) / wpc) * H, kTh, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(kpad),
      static_cast<const bf16*>(w_in), static_cast<const bf16*>(b_in), static_cast<bf16*>(attn),
      B, S, C, H, 1.0f / sqrtf(static_cast<float>(C / H)));
  return cudaGetLastError();
}

cudaError_t forward(const void* x, const void* kpad, const void* w_in, const void* b_in,
                    const void* w_out, const void* b_out, void* attn, void* out, int B, int S,
                    int C, int H, cudaStream_t st) {
  if (!exo::tc::aligned16(x) || !exo::tc::aligned16(w_in)) return cudaErrorMisalignedAddress;
  cudaError_t err;
  switch ((C / H + 15) / 16) {
    case 1: err = launch<16>(x, kpad, w_in, b_in, attn, B, S, C, H, st); break;
    case 2: err = launch<32>(x, kpad, w_in, b_in, attn, B, S, C, H, st); break;
    case 3: err = launch<48>(x, kpad, w_in, b_in, attn, B, S, C, H, st); break;
    case 4: err = launch<64>(x, kpad, w_in, b_in, attn, B, S, C, H, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return exo::out_projection<bf16>(attn, w_out, b_out, out, B * S, C, st);
}

}  // namespace tcm

}  // namespace

// x (B, S, C), kpad (B, S) int32 nonzero at padding, w_in (3C, C), b_in (3C),
// w_out (C, C), b_out (C), attn scratch (B*S, C), out (B, S, C); all
// contiguous, of one type (dtype 0: float32, 1: bfloat16) apart from kpad;
// S <= 128, C a multiple of 32, head size C/H a multiple of 8 up to 64;
// bfloat16: x, w_in, w_out and attn 16-byte aligned.
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
    return tcm::forward(x, kpad, w_in, b_in, w_out, b_out, attn, out, B, S, C, H, st);
  }
  return cudaErrorInvalidValue;
}
