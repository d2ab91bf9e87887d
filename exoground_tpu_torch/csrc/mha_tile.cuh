// The bodies the fused-MHA family shares:
//   fused_mha.cu        out = MHA(x)                          (no prologue)
//   fused_mha_int8.cu   out = MHA(x), int8 qkv product         (prologue kRowQuant)
//   block_attn.cu       (x + MHA(LN_1(x)), LN_1(x))            (kRowLn)
//   block_attn_int8.cu  the same with an int8 qkv product      (kRowLnQuant)
// with MHA(a) = concat_h softmax(q_h k_h^T / sqrt(Dh), key padding) v_h .
// W_out^T + b_out and qkv = a . W_in^T + b_in (the int8 bodies: float(aq .
// Wq^T) * as * wsc + b_in, W_in quantized per output row by the wrapper).
// The TPU kernels share their tail the same way
// (exoground_tpu/ops/attention.py::_mha_attention_tail :575 under
// _mha_kernel :658, _mha_kernel_int8 :674, _block_attn_kernel :616 and
// _block_attn_kernel_int8 :636): only the row work before the qkv product,
// its operands and the residual differ.
//
// Order of work, every body: (1) the row prologue, where there is one, once
// per row; (2) the attention kernel, one CTA per (tile of packed windows,
// head) on the tensor cores (the int8 f32 body: per (window, head) on the
// CUDA cores), writing o in the input type to a (B*S, C) scratch; (3) the
// out-projection of mha_tail.cuh, with x as its residual in the block
// bodies.
//
// What bounds them on an H100: operations (8*B*S*C^2 + 4*B*S^2*C FLOPs,
// 43.4 GFLOP at B304 S64 C512, against a few tens of MB). The TPU kernel
// (exoground_tpu/ops/attention.py::_mha_kernel) keeps both weights and a
// (128, 3C) qkv tile in VMEM; a Hopper CTA cannot, so it owns one head of a
// row tile and streams that head's 3*Dh W_in rows once for the whole tile:
// the more rows a tile packs, the less weight traffic from L2.
//
// 1. row_prologue_kernel: one warp a row of C. kRowLn: the LN mean and rstd
//    in two passes (f32, IEEE root and quotient), xn written in x's type
//    (the x_norm output the block wrapper returns, and the block bodies'
//    qkv operand). kRowQuant / kRowLnQuant: the absmax of the row of x as
//    f32 (or of the unrounded f32 xn), xs = absmax / 127 (1 for a zero
//    row), xq = clip(round_half_even(v / xs), +-127) as int8 (B*S, C) with
//    xs (B*S) in f32. The sources build without fast math, so xq and xs
//    are bit for bit quant._quant_last_axis of the same f32 values. The
//    head CTAs do none of this work: at H = 8 each row's statistics were
//    taken 8 times when every head CTA took them.
// 2a. float32, exact (mha_tf32_kernel<DHP>): every product in 3xTF32 on
//    the tensor cores (tc.cuh: m16n8k8 .tf32, each operand split into a
//    TF32 hi half and the rest, lo.hi + hi.lo + hi.hi, float32 accuracy; plain
//    TF32 misses the f32 limit of 1e-4 of max|plain|), one CTA of 8 warps per
//    (row tile, head). Windows are packed at RW = round16(S) rows, 128 / RW a
//    tile (two at S = 64, as the TPU kernel packs them (:660-664); one
//    96-row tile at S = 96, a quarter fewer rows than the bf16 tile's 128).
//    - qkv_h: x and W_in in K chunks of 32 floats by 16-byte cp.async in a
//      two-stage ring at a row pitch of 36 floats (4 mod 8: the fragment
//      reads hit 32 distinct banks). Warp w owns column half w % 2 and the
//      m-tiles w / 2 and w / 2 + 4, so with 5-7 m-tiles (S 65-112) the two
//      warps of each SM sub-partition still share the products evenly; each
//      B fragment is split once and used for both m-tiles. + b_in, then q,
//      k, v stay float32 in shared memory (over the ring), pitch Dhp + 4.
//    - each warp owns 16 query rows: s = q . k^T over its window's keys in
//      3xTF32, times 1/sqrt(Dh); padding keys at -1e30 and keys past S (the
//      packed neighbour's among them) at -inf; the softmax on the fragments
//      with quad shuffles; p / l in float32 goes from the score C fragments
//      to the A fragments of o = p . v in registers (tc::c_to_a_tf32, v read
//      k-major by tc::load_bk_tf32), o into the scratch in float32.
//    Two CTAs an SM (104 KB of shared memory each at Dh 64; the cap of 128
//    registers spills ~300 bytes a thread there, and one CTA an SM without
//    the spill was slower). Operands 16-byte aligned, C a multiple of 32.
// 2b. float32, int8 qkv (int8_window_head_kernel): one CTA per (window,
//    head) on the CUDA cores: __dp4a over the prologue's xq words (4 values
//    a word) and this head's int8 W_in rows, exact int32 sums, dequantized as
//    float(acc) * xs[row] * wsc[col] + b_in[col], each step rounded on its
//    own (exo::dequant, the plain version's order), then the tail of
//    mha_tail.cuh. Only the f32 + int8 agreement check runs it.
// 2c. bfloat16 (mha_tc_kernel<DHP, Q8>): every product on the tensor cores
//    (mma.sync m16n8k16), one CTA of 8 warps per (128-row tile, head). The tile holds
//    two windows of S <= 64 (each at rows 64 w..) or one of S <= 128, as the
//    TPU kernel packs them (:660-664): each CTA streams its head's 3*Dh W_in
//    rows once for 128 rows, which halves the weight traffic from L2 at the
//    main path's S = 64; S = 96 runs a third of its rows as zero padding.
//    - qkv_h: the row operand and W_in in K chunks of 128 bytes a row (64
//      bf16, or 128 int8 with Q8) by 16-byte cp.async in a two-stage ring
//      (row pitch 144 bytes: conflict-free ldmatrix); each warp owns 32 rows
//      x 3*Dhp/2 columns of accumulators. bf16: mma.sync m16n8k16, f32 sums,
//      + b_in. Q8: the int8 tiles seen as b16 give m16n8k32's fragments
//      through the same ldmatrix (tc.cuh::mma_s8, exact int32 sums, half the
//      K steps), dequantized as 2b. Then q, k, v are rounded to bf16 into
//      shared memory (over the ring): the rounding of mha_plain's bf16
//      F.linear.
//    - each warp owns 16 query rows: s = q . k^T, times 1/sqrt(Dh) in f32,
//      padding keys at -1e30 and keys past S excluded, the softmax on the
//      fragments with quad shuffles, p normalised and rounded to bf16
//      (attention_plain casts p to v's type) and repacked into A fragments in
//      registers; o = p . v (v by ldmatrix.trans), rounded to bf16 into the
//      scratch, as the TPU kernel casts o_h to W_out's type.
//    The template covers the head tile (Dhp = 16, 32, 48, 64) and the product
//    kind; S and Dh are run-time values. Its operands must be 16-byte aligned
//    (cp.async), C a multiple of 16.
// Head sizes: multiples of 8 up to 64 in the bodies 2a-2c (the int8 f32
// body's shared-memory budget at S = 128: q/k/v and the scores take 164 KB
// at Dh = 64; a head tile past Dh reads zero columns); larger multiples of 8
// in 2d, the wide-head body: the qkv projection as a GEMM into a scratch,
// then attention in head slabs of 64 columns (below).
#pragma once

#include <cstddef>
#include <cstdint>
#include <math.h>
#include <type_traits>

#include "common.cuh"
#include "mha_tail.cuh"
#include "tc.cuh"
#include "wide_window.cuh"

namespace exo {
namespace mha {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTh = 256;    // the tensor-core tiles: 8 warps
constexpr int kRows = 128;  // their row tile: packed windows of S <= 64, or one of S <= 128
constexpr int kKC = 32;       // the int8 f32 body: K chunk (32 words of int8)
// the largest head the bodies 2a-2c hold; above it 2d, which takes the qkv
// scratch (the wrapper allocates it above ops/attention.py's
// MAX_TILE_HEAD_DIM, the same 64; a wide head handed none is refused)
constexpr int kMaxTileDh = 64;

// The entry points' shape checks: B, S <= 128 and H positive, C a multiple
// of c_mult and of H, the head size a multiple of 8.
inline bool valid_shape(int B, int S, int C, int H, int c_mult) {
  return B >= 1 && S >= 1 && S <= 128 && H >= 1 && C % H == 0 && C % c_mult == 0 &&
         (C / H) % 8 == 0;
}

// ============================================================ 1. row prologue
enum Row : int { kRowLn = 1, kRowQuant = 2, kRowLnQuant = 3 };

// four consecutive f32 values written in T (p 8- or 16-byte aligned)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]));
}

// Row `row`'s values k..k+3 as the prologue forms them: x as f32, or the f32
// LayerNorm output (each step rounded on its own, common.cuh::ln_apply).
template <typename T, bool LN>
__device__ __forceinline__ void row_values(const T* xr, const T* lnw, const T* lnb, int k,
                                           float mean, float rstd, float (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = LN ? ln_apply(to_f(xr[k + i]), mean, rstd, to_f(lnw[k + i]), to_f(lnb[k + i]))
              : to_f(xr[k + i]);
  }
}

// One warp a row; lane l takes the values 4 l + 128 i.. (C a multiple of
// 128). x is read value by value (any alignment of its type); xn and xq,
// fresh allocations, are written 4 values a store.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
row_prologue_kernel(const T* __restrict__ x, const T* __restrict__ lnw,
                    const T* __restrict__ lnb, T* __restrict__ xn, int* __restrict__ xq,
                    float* __restrict__ xs, int rows, int C) {
  constexpr bool LN = MODE != kRowQuant, Q = MODE != kRowLn;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + size_t(row) * C;
  float mean = 0.f, rstd = 0.f;
  if (LN) warp_ln_stats(xr, C, lane, mean, rstd);
  float am = 0.f;
  for (int k = 4 * lane; k < C; k += 128) {
    float v[4];
    row_values<T, LN>(xr, lnw, lnb, k, mean, rstd, v);
    if (LN) store4(xn + size_t(row) * C + k, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) am = fmaxf(am, fabsf(v[i]));
  }
  if (!Q) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
  const float s = row_scale(am);
  if (lane == 0) xs[row] = s;
  int* qr = xq + size_t(row) * (C / 4);
  for (int k = 4 * lane; k < C; k += 128) {
    float v[4];
    row_values<T, LN>(xr, lnw, lnb, k, mean, rstd, v);  // the same f32 values again
    int w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) w |= (quant_i8(v[i], s) & 0xff) << (8 * i);
    qr[k / 4] = w;
  }
}

// xn (kRowLn, kRowLnQuant), xq and xs (kRowQuant, kRowLnQuant) of `rows` rows.
template <typename T, int MODE>
inline cudaError_t row_prologue(const void* x, const void* lnw, const void* lnb, void* xn,
                                void* xq, void* xs, int rows, int C, cudaStream_t st) {
  constexpr int kRowsPerCta = kThreads / 32;
  row_prologue_kernel<T, MODE><<<(rows + kRowsPerCta - 1) / kRowsPerCta, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(lnw), static_cast<const T*>(lnb),
      static_cast<T*>(xn), static_cast<int*>(xq), static_cast<float*>(xs), rows, C);
  return cudaGetLastError();
}

// ===================================================== 2a. float32, exact
constexpr int kKCf = 32;        // K chunk of the projection, floats (128 bytes a row)
constexpr int kXPf = kKCf + 4;  // staged row pitch: 4 (mod 8) floats, conflict-free fragments

// DHP: the head size rounded up to 16.
template <int DHP>
struct Tf32Mha {
  static constexpr int N = 3 * DHP;                 // projection columns [q | k | v]
  static constexpr int NTW = N / 16;                // n-tiles per warp (2 warp columns)
  static constexpr int QP = DHP + 4;                // q/k/v row pitch, 4 (mod 8) floats
  static constexpr int STAGE = (kRows + N) * kXPf;  // one ring stage: x chunk, W chunk
  static constexpr int QKV = 3 * kRows * QP;        // q, k, v (over the ring)
  static constexpr int FLOATS = 2 * STAGE > QKV ? 2 * STAGE : QKV;
  // the ring / q, k, v; key-padding flags
  static constexpr size_t bytes = sizeof(float) * FLOATS + sizeof(int) * kRows;
};

// Windows a tile holds: each takes round16(S) rows, as many as fit in 128.
__host__ __device__ inline int tf32_windows(int S) { return kRows / ((S + 15) / 16 * 16); }

// Tile row r holds token r % RW of window b0 + r / RW (RW = round16(S)); it
// is real when the token is < S and the window < B. Every product in 3xTF32
// (tc.cuh), q, k, v and p in float32 as the plain versions keep them.
// Projection: warp w owns column half w % 2 and the m-tiles w / 2 and
// w / 2 + 4 (the second where the tile has it), so that with 5-7 m-tiles the
// two warps of each SM sub-partition (w, w + 4) still share the work evenly.
template <int DHP>
__global__ void __launch_bounds__(kTh, 2)
mha_tf32_kernel(const float* __restrict__ x, const int* __restrict__ kpad,
                const float* __restrict__ w_in, const float* __restrict__ b_in,
                float* __restrict__ attn, int B, int S, int C, int H, float scale) {
  using L = Tf32Mha<DHP>;
  using tc::load_a_tf32;
  using tc::load_b_tf32;
  using tc::load_bk_tf32;
  using tc::mma_3xtf32;
  using tc::quad_max;
  using tc::quad_sum;
  using tc::Tf32A;
  using tc::Tf32B;
  extern __shared__ __align__(16) unsigned char smem_f[];
  float* ring = reinterpret_cast<float*>(smem_f);
  int* km = reinterpret_cast<int*>(ring + L::FLOATS);
  const int DH = C / H;
  const int RW = (S + 15) / 16 * 16, wpc = kRows / RW, rows = wpc * RW, MT = rows / 16;
  const int b0 = (blockIdx.x / H) * wpc, h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = 2 * (lane % 4);

  for (int r = tid; r < rows; r += kTh) {
    const int b = b0 + r / RW, t = r % RW;
    km[r] = t < S && b < B ? kpad[size_t(b) * S + t] : 1;
  }

  // ---- 1. qkv_h = x . W_in,h^T + b_in ----
  auto stage_chunk = [&](int k0, int st) {
    float* xs = ring + st * L::STAGE;
    float* ws = xs + kRows * kXPf;
    constexpr int kCh = kKCf / 4;  // 16-byte chunks a row
    for (int e = tid; e < rows * kCh; e += kTh) {
      const int r = e / kCh, cc = (e % kCh) * 4;
      const int b = b0 + r / RW, t = r % RW;
      const bool in = t < S && b < B;
      tc::cp_async16(xs + r * kXPf + cc, in ? x + (size_t(b) * S + t) * C + k0 + cc : x, in);
    }
    for (int e = tid; e < L::N * kCh; e += kTh) {
      const int n = e / kCh, cc = (e % kCh) * 4;
      const int part = n / DHP, d = n % DHP;
      const bool in = d < DH;
      tc::cp_async16(ws + n * kXPf + cc,
                     in ? w_in + (size_t(part) * C + size_t(h) * DH + d) * C + k0 + cc : w_in,
                     in);
    }
  };
  const int wn = warp % 2, m0 = warp / 2;
  const bool two = m0 + 4 < MT;  // the warp's second m-tile (warp-uniform)
  float acc[2][L::NTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < L::NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int nch = C / kKCf;
  stage_chunk(0, 0);
  tc::cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch & 1;
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (ch + 1 < nch) stage_chunk((ch + 1) * kKCf, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const float* xs = ring + st * L::STAGE;
    const float* ws = xs + kRows * kXPf + wn * L::NTW * 8 * kXPf;
#pragma unroll
    for (int kk = 0; kk < kKCf / 8; ++kk) {
      const Tf32A a0 = load_a_tf32(xs + 16 * m0 * kXPf + kk * 8, kXPf, lane);
      Tf32A a1 = a0;
      if (two) a1 = load_a_tf32(xs + 16 * (m0 + 4) * kXPf + kk * 8, kXPf, lane);
#pragma unroll
      for (int j = 0; j < L::NTW; ++j) {
        const Tf32B b = load_b_tf32(ws + j * 8 * kXPf + kk * 8, kXPf, lane);
        mma_3xtf32(acc[0][j], a0, b);
        if (two) mma_3xtf32(acc[1][j], a1, b);
      }
    }
  }
  __syncthreads();  // the ring becomes q, k, v
  float* qs = ring;
  float* ks = qs + kRows * L::QP;
  float* vs = ks + kRows * L::QP;
#pragma unroll
  for (int j = 0; j < L::NTW; ++j) {
    const int n = (wn * L::NTW + j) * 8 + c, part = n / DHP, d = n % DHP;
    float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
    const bool col_in = d < DH;  // padding columns stay 0
    float b_lo = 0.f, b_hi = 0.f;
    if (col_in) {
      const size_t col = size_t(part) * C + h * DH + d;
      b_lo = b_in[col];
      b_hi = b_in[col + 1];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i == 1 && !two) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * (m0 + 4 * i) + g + 8 * half;
        *reinterpret_cast<float2*>(dst + r * L::QP + d) =
            col_in ? make_float2(acc[i][j][2 * half] + b_lo, acc[i][j][2 * half + 1] + b_hi)
                   : make_float2(0.f, 0.f);
      }
    }
  }
  __syncthreads();

  // ---- 2. attention: warp w owns query rows 16 w.. of the tile ----
  const int win = 16 * warp / RW, kb = win * RW, t0 = 16 * warp - kb;
  if (warp >= MT || t0 >= S || b0 + win >= B) return;  // padding rows: no barrier follows
  const int nk8 = (S + 7) / 8;                          // key n-tiles of 8
  float s[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DHP / 8; ++kk) {
    const Tf32A a = load_a_tf32(qs + 16 * warp * L::QP + kk * 8, L::QP, lane);
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      if (nt < nk8) {
        const Tf32B b = load_b_tf32(ks + (kb + nt * 8) * L::QP + kk * 8, L::QP, lane);
        mma_3xtf32(s[nt], a, b);
      }
    }
  }
  // scores times 1/sqrt(Dh); padding keys at -1e30 (a window whose keys are
  // all padding averages its own S values), keys past S (and so the packed
  // neighbour's) excluded
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    if (nt < nk8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = nt * 8 + c + (e & 1);
        const float v = t >= S ? -INFINITY : (km[kb + t] ? kMhaNegInf : s[nt][e] * scale);
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
    if (nt < nk8) {
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
  // o = (p / l) . v, p from the score fragments in registers (tc::c_to_a_tf32)
  float o[DHP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    if (kk < nk8) {
      const float pn[4] = {s[kk][0] / l[0], s[kk][1] / l[0], s[kk][2] / l[1], s[kk][3] / l[1]};
      const Tf32A a = tc::c_to_a_tf32(pn);
#pragma unroll
      for (int dn = 0; dn < DHP / 8; ++dn) {
        const Tf32B b = load_bk_tf32(vs + (kb + kk * 8) * L::QP + dn * 8, L::QP, lane);
        mma_3xtf32(o[dn], a, b);
      }
    }
  }
  // o_h into the (B*S, C) scratch, columns h*Dh..
  float* ob = attn + size_t(b0 + win) * S * C + size_t(h) * DH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + g + 8 * half;
    if (t >= S) continue;
#pragma unroll
    for (int dn = 0; dn < DHP / 8; ++dn) {
      const int d = dn * 8 + c;
      if (d < DH) {
        *reinterpret_cast<float2*>(ob + size_t(t) * C + d) =
            make_float2(o[dn][2 * half], o[dn][2 * half + 1]);
      }
    }
  }
}

template <int DHP>
cudaError_t launch_tf32(const void* x, const void* kpad, const void* w_in, const void* b_in,
                        void* attn, int B, int S, int C, int H, cudaStream_t st) {
  auto kernel = mha_tf32_kernel<DHP>;
  constexpr size_t smem = Tf32Mha<DHP>::bytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int wpc = tf32_windows(S);
  kernel<<<((B + wpc - 1) / wpc) * H, kTh, smem, st>>>(
      static_cast<const float*>(x), static_cast<const int*>(kpad),
      static_cast<const float*>(w_in), static_cast<const float*>(b_in),
      static_cast<float*>(attn), B, S, C, H, 1.0f / sqrtf(static_cast<float>(C / H)));
  return cudaGetLastError();
}

// o of the f32 exact body into attn (B*S, C): x (B*S, C) and W_in (3C, C),
// both 16-byte aligned (cp.async), C a multiple of 32. T is float; a
// template so that only the sources that call it build its kernels.
template <typename T>
cudaError_t attention_f32(const void* x, const void* kpad, const void* w_in,
                          const void* b_in, void* attn, int B, int S, int C, int H,
                          cudaStream_t st) {
  if (!tc::aligned16(x) || !tc::aligned16(w_in)) return cudaErrorMisalignedAddress;
  switch ((C / H + 15) / 16) {
    case 1: return launch_tf32<16>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    case 2: return launch_tf32<32>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    case 3: return launch_tf32<48>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    case 4: return launch_tf32<64>(x, kpad, w_in, b_in, attn, B, S, C, H, st);
    default: return cudaErrorInvalidValue;
  }
}

// ================================================= 2b. float32, int8 qkv
// RT: register-tile rows / 16 (ceil(S/16)); DHP: the head size rounded up to 16.
template <int RT, int DHP>
struct Int8Layout {
  static constexpr int SP = RT * 16;      // rows covered by the register tile
  static constexpr int QP = DHP + 1;      // q/k/v row pitch (odd: conflict-free)
  static constexpr int XP = SP + 1;       // staged xq words pitch, [kKC][XP]
  static constexpr int WP = 3 * DHP + 1;  // staged W_in words pitch, [kKC][WP]
  __host__ __device__ static int union_words(int S) {
    int stage = kKC * (XP + WP);
    return stage > S * S ? stage : S * S;
  }
  // q, k, v; the staging area / scores; row scales; key-padding flags
  __host__ __device__ static size_t bytes(int S) {
    return (size_t(3) * SP * QP + union_words(S) + 2 * SP) * 4;
  }
};

// Two CTAs an SM up to S = 96 (RT 6), where two fit in shared memory: a cap
// of 128 registers (130 uncapped at RT 6, which left one CTA an SM). The
// head size is a run-time value (fixed at 64 it took 168 registers at RT 6).
template <int RT, int DHP>
__global__ void __launch_bounds__(kThreads, RT <= 6 ? 2 : 1)
int8_window_head_kernel(const int* __restrict__ xq, const float* __restrict__ xsc_g,
                        const int* __restrict__ kpad, const int* __restrict__ wq,
                        const float* __restrict__ wsc, const float* __restrict__ b_in,
                        float* __restrict__ attn, int S, int C, int H, int DH, float scale) {
  using L = Int8Layout<RT, DHP>;
  constexpr int SP = L::SP, QP = L::QP, XP = L::XP, WP = L::WP;
  constexpr int CT = 3 * DHP / 16;  // tile column r: part r / DHP, d = r % DHP < DH
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + SP * QP;
  float* vs = ks + SP * QP;
  float* uni = vs + SP * QP;
  int* xst = reinterpret_cast<int*>(uni);  // projection phase: xq words, transposed
  int* wst = xst + kKC * XP;               // projection phase: int8 W_in words, transposed
  float* ps = uni;                         // attention phase: S x S scores
  float* xsc = uni + L::union_words(S);    // row scales
  int* km = reinterpret_cast<int*>(xsc + SP);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int CW = C / 4;  // words of an int8 row
  const int* xb = xq + size_t(b) * S * CW;
  for (int j = tid; j < SP; j += kThreads) {
    km[j] = j < S ? kpad[size_t(b) * S + j] : 1;
    xsc[j] = j < S ? xsc_g[size_t(b) * S + j] : 1.f;
  }

  // ---- int32 q_h, k_h, v_h = xq . Wq[rows of head h]^T ----
  int acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < CW; k0 += kKC) {
    for (int e = tid; e < SP * kKC; e += kThreads) {
      const int s = e / kKC, kw = e % kKC;
      xst[kw * XP + s] = s < S ? xb[size_t(s) * CW + k0 + kw] : 0;
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
    const float ws = wsc[row], bias = b_in[row];
    float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int s = ty + 16 * i;
      dst[s * QP + d] = dequant(acc[i][j], xsc[s], ws, bias);
    }
  }
  __syncthreads();  // qkv complete; the staging area becomes the score matrix
  window_attention<float, 0, kThreads>(qs, ks, vs, QP, ps, km,
                                         attn + size_t(b) * S * C + h * DH, S, C, DH, scale);
}

template <int RT, int DHP>
cudaError_t launch_int8_window_head(const void* xq, const void* xs, const void* kpad,
                                    const void* wq, const void* wsc, const void* b_in,
                                    void* attn, int B, int S, int C, int H, cudaStream_t st) {
  auto kernel = int8_window_head_kernel<RT, DHP>;
  const size_t smem = Int8Layout<RT, DHP>::bytes(S);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int dh = C / H;
  kernel<<<B * H, kThreads, smem, st>>>(
      static_cast<const int*>(xq), static_cast<const float*>(xs),
      static_cast<const int*>(kpad), static_cast<const int*>(wq),
      static_cast<const float*>(wsc), static_cast<const float*>(b_in),
      static_cast<float*>(attn), S, C, H, dh, 1.0f / sqrtf(static_cast<float>(dh)));
  return cudaGetLastError();
}

template <int DHP>
cudaError_t int8_window_head_by_rows(const void* xq, const void* xs, const void* kpad,
                                     const void* wq, const void* wsc, const void* b_in,
                                     void* attn, int B, int S, int C, int H, cudaStream_t st) {
#define EXO_RT(n) \
  case n:         \
    return launch_int8_window_head<n, DHP>(xq, xs, kpad, wq, wsc, b_in, attn, B, S, C, H, st);
  switch ((S + 15) / 16) {
    EXO_RT(1) EXO_RT(2) EXO_RT(3) EXO_RT(4) EXO_RT(5) EXO_RT(6) EXO_RT(7) EXO_RT(8)
    default: return cudaErrorInvalidValue;
  }
#undef EXO_RT
}

// o of the f32 int8 body into attn: xq (B*S, C) int8 and xs (B*S) from the
// prologue, Wq (3C, C) int8, wsc (3C) f32, b_in f32. T is float (a template
// for the reason attention_f32 is).
template <typename T>
cudaError_t attention_int8_f32(const void* xq, const void* xs, const void* kpad,
                                      const void* wq, const void* wsc, const void* b_in,
                                      void* attn, int B, int S, int C, int H,
                                      cudaStream_t st) {
  switch ((C / H + 15) / 16) {
    case 1: return int8_window_head_by_rows<16>(xq, xs, kpad, wq, wsc, b_in, attn, B, S, C, H, st);
    case 2: return int8_window_head_by_rows<32>(xq, xs, kpad, wq, wsc, b_in, attn, B, S, C, H, st);
    case 3: return int8_window_head_by_rows<48>(xq, xs, kpad, wq, wsc, b_in, attn, B, S, C, H, st);
    case 4: return int8_window_head_by_rows<64>(xq, xs, kpad, wq, wsc, b_in, attn, B, S, C, H, st);
    default: return cudaErrorInvalidValue;
  }
}

// ============================================== 2c. bfloat16, tensor cores
constexpr int kKCt = 64;        // K chunk of the projection, in b16 units (128 bytes a row)
constexpr int kXPt = kKCt + 8;  // staged row pitch (72 b16 units)

// DHP: the head size rounded up to 16; Q8: the int8 qkv product.
template <int DHP, bool Q8>
struct TcMha {
  static constexpr int N = 3 * DHP;                   // projection columns [q | k | v]
  static constexpr int NTW = N / 16;                  // n-tiles per warp (2 warp columns)
  static constexpr int QP = DHP + 8;                  // q/k/v row pitch
  static constexpr int STAGE = (kRows + N) * kXPt;    // one ring stage: x chunk, W chunk
  static constexpr int QKV = 3 * kRows * QP;          // q, k, v (over the ring)
  static constexpr int ELEMS = 2 * STAGE > QKV ? 2 * STAGE : QKV;
  // the ring / q, k, v; key-padding flags; Q8: the row scales
  static constexpr size_t bytes = sizeof(bf16) * ELEMS + sizeof(int) * kRows +
                                  (Q8 ? sizeof(float) * kRows : 0);
};

// the product of one fragment pair by kind: bf16 m16n8k16 into f32, or
// int8 m16n8k32 into int32
__device__ __forceinline__ void mma_any(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  tc::mma(d, a, b0, b1);
}
__device__ __forceinline__ void mma_any(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  tc::mma_s8(d, a, b0, b1);
}

// Tile row r holds token r % RW of window b0 + r / RW (RW = 64 packs two
// windows of S <= 64, RW = 128 holds one); it is real when the token is < S
// and the window < B. xa, wa: bf16 x and W_in, or (Q8) int8 xq and Wq with
// their scales xsc (B*S) and wsc (3C).
// Two CTAs an SM (a cap of 128 registers; at Dh 64 it spills ~120 bytes a
// thread) keep a second CTA's loads in flight under one's products, which
// one CTA of 168 spill-free registers does not.
template <int DHP, bool Q8>
__global__ void __launch_bounds__(kTh, 2)
mha_tc_kernel(const void* __restrict__ xa, const float* __restrict__ xsc,
              const int* __restrict__ kpad, const void* __restrict__ wa,
              const float* __restrict__ wsc, const bf16* __restrict__ b_in,
              bf16* __restrict__ attn, int B, int S, int C, int H, float scale) {
  using L = TcMha<DHP, Q8>;
  using E = typename std::conditional<Q8, int8_t, bf16>::type;  // product operands
  using Acc = typename std::conditional<Q8, int, float>::type;
  constexpr int EC = 16 / sizeof(E);  // E values a 16-byte copy
  constexpr int KE = 8 * EC;          // E values a K chunk of a row (128 bytes)
  using tc::a_col;
  using tc::a_row;
  using tc::b_col;
  using tc::b_row;
  using tc::ldsm_x2;
  using tc::ldsm_x4;
  using tc::ldsm_x4_t;
  using tc::mma;
  using tc::pack_bf16;
  using tc::quad_max;
  using tc::quad_sum;
  const E* x = static_cast<const E*>(xa);
  const E* w_in = static_cast<const E*>(wa);
  extern __shared__ __align__(16) unsigned char smem_m[];
  bf16* ring = reinterpret_cast<bf16*>(smem_m);
  int* km = reinterpret_cast<int*>(ring + L::ELEMS);
  float* rsc = reinterpret_cast<float*>(km + kRows);  // Q8: the tile rows' scales
  const int DH = C / H;
  const int RW = S <= 64 ? 64 : 128;
  const int b0 = (blockIdx.x / H) * (kRows / RW), h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = 2 * (lane % 4);

  for (int r = tid; r < kRows; r += kTh) {
    const int b = b0 + r / RW, t = r % RW;
    const bool real = t < S && b < B;
    km[r] = real ? kpad[size_t(b) * S + t] : 1;
    if constexpr (Q8) rsc[r] = real ? xsc[size_t(b) * S + t] : 1.f;
  }

  // ---- 1. qkv_h = x . W_in,h^T (+ b_in), f32 or int32 accumulators ----
  auto stage_chunk = [&](int k0, int st) {
    bf16* xs = ring + st * L::STAGE;
    bf16* ws = xs + kRows * kXPt;
    constexpr int kCh = kKCt / 8;  // 16-byte chunks a row
    for (int e = tid; e < kRows * kCh; e += kTh) {
      const int r = e / kCh, cb = e % kCh, cc = cb * EC;
      const int b = b0 + r / RW, t = r % RW;
      const bool in = t < S && b < B && k0 + cc < C;
      tc::cp_async16(xs + r * kXPt + cb * 8, in ? x + (size_t(b) * S + t) * C + k0 + cc : x,
                     in);
    }
    for (int e = tid; e < L::N * kCh; e += kTh) {
      const int n = e / kCh, cb = e % kCh, cc = cb * EC;
      const int part = n / DHP, d = n % DHP;
      const bool in = d < DH && k0 + cc < C;
      tc::cp_async16(
          ws + n * kXPt + cb * 8,
          in ? w_in + (size_t(part) * C + size_t(h) * DH + d) * C + k0 + cc : w_in, in);
    }
  };
  const int wm = warp / 2, wn = warp % 2;  // 32 rows x NTW n-tiles a warp
  Acc acc[2][L::NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < L::NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0;
  const int nch = (C + KE - 1) / KE;
  stage_chunk(0, 0);
  tc::cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    const int st = ch & 1;
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (ch + 1 < nch) stage_chunk((ch + 1) * KE, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* xs = ring + st * L::STAGE;
    const bf16* ws = xs + kRows * kXPt + wn * L::NTW * 8 * kXPt;
#pragma unroll
    for (int kk = 0; kk < kKCt / 16; ++kk) {  // 16 bf16 (m16n8k16) or 32 int8 (m16n8k32)
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
            mma_any(acc[mt][j], a[mt], b[0], b[1]);
            mma_any(acc[mt][j + 1], a[mt], b[2], b[3]);
          }
        } else {  // an odd last n-tile (Dhp = 16 or 48)
          uint32_t b[2];
          ldsm_x2(b, ws + (j * 8 + (lane & 7)) * kXPt + kk * 16 + (lane & 8));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_any(acc[mt][j], a[mt], b[0], b[1]);
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
    float b_lo = 0.f, b_hi = 0.f, w_lo = 1.f, w_hi = 1.f;
    if (d < DH) {
      const size_t col = size_t(part) * C + h * DH + d;
      b_lo = to_f(b_in[col]);
      b_hi = to_f(b_in[col + 1]);
      if constexpr (Q8) {
        w_lo = wsc[col];
        w_hi = wsc[col + 1];
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + mt * 16 + g + 8 * half;
        const bool col_in = d < DH;  // padding columns stay 0
        float v0, v1;
        if constexpr (Q8) {
          const float sr = rsc[r];
          v0 = col_in ? dequant(acc[mt][j][2 * half], sr, w_lo, b_lo) : 0.f;
          v1 = col_in ? dequant(acc[mt][j][2 * half + 1], sr, w_hi, b_hi) : 0.f;
        } else {
          v0 = col_in ? acc[mt][j][2 * half] + b_lo : 0.f;
          v1 = col_in ? acc[mt][j][2 * half + 1] + b_hi : 0.f;
        }
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
        float v = t >= S ? -INFINITY : (km[kb + t] ? kMhaNegInf : s[nt][e] * scale);
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

template <int DHP, bool Q8>
cudaError_t launch_tc(const void* x, const void* xsc, const void* kpad, const void* w,
                      const void* wsc, const void* b_in, void* attn, int B, int S, int C,
                      int H, cudaStream_t st) {
  auto kernel = mha_tc_kernel<DHP, Q8>;
  constexpr size_t smem = TcMha<DHP, Q8>::bytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int wpc = S <= 64 ? 2 : 1;  // windows a CTA's 128 rows hold
  kernel<<<((B + wpc - 1) / wpc) * H, kTh, smem, st>>>(
      x, static_cast<const float*>(xsc), static_cast<const int*>(kpad), w,
      static_cast<const float*>(wsc), static_cast<const bf16*>(b_in), static_cast<bf16*>(attn),
      B, S, C, H, 1.0f / sqrtf(static_cast<float>(C / H)));
  return cudaGetLastError();
}

// o of a bf16 body into attn (B*S, C): x (B*S, C) bf16 and W_in (3C, C)
// bf16, or (Q8) xq int8 with its scales xsc and Wq int8 with wsc; the
// operands staged by cp.async must be 16-byte aligned
template <bool Q8>
inline cudaError_t attention_tc(const void* x, const void* xsc, const void* kpad,
                                const void* w, const void* wsc, const void* b_in, void* attn,
                                int B, int S, int C, int H, cudaStream_t st) {
  if (!tc::aligned16(x) || !tc::aligned16(w)) return cudaErrorMisalignedAddress;
  switch ((C / H + 15) / 16) {
    case 1: return launch_tc<16, Q8>(x, xsc, kpad, w, wsc, b_in, attn, B, S, C, H, st);
    case 2: return launch_tc<32, Q8>(x, xsc, kpad, w, wsc, b_in, attn, B, S, C, H, st);
    case 3: return launch_tc<48, Q8>(x, xsc, kpad, w, wsc, b_in, attn, B, S, C, H, st);
    case 4: return launch_tc<64, Q8>(x, xsc, kpad, w, wsc, b_in, attn, B, S, C, H, st);
    default: return cudaErrorInvalidValue;
  }
}

// ============================================== 2d. wide heads (Dh > 64)
// Past a head of 64 the bodies above no longer fit: the f32 tile's q, k and
// v take 3 * 128 * (Dh + 4) floats (399 KB at Dh 256, past a CTA's 227 KB),
// its o accumulator Dh / 2 registers a thread, and the int8 f32 body's S x Dh
// tiles with the scores 164 KB already at Dh 64. So a wide head runs in two
// kernels with the (B*S, 3C) qkv between them, in a scratch of its own that
// the wrapper hands over beside the o scratch (null below a head of 64; a
// wide head given none fails with cudaErrorInvalidValue):
//   1. qkv = the row operand . W_in^T + b_in by the tail's 128 x 128
//      tensor-core GEMM (mha_tail.cuh: 3xTF32 in f32, bf16 mma.sync, or for
//      the int8 bodies linear_s8_kernel: mma.sync m16n8k32 .s8, exact int32
//      sums dequantized as float(acc) * xs * wsc + b_in), q, k and v written
//      in T (bf16: rounded, as the tile rounds them);
//   2. the slab window kernel (wide_window.cuh) per (window, head), reading
//      q, k and v where they lie in qkv (row pitch 3C), the MHA tile's order
//      (scores times 1/sqrt(Dh), p / l before p . v), o into the o scratch.
// The qkv round trip costs 2 * B*S*3C elements of device traffic (200 MB in
// f32 at B64 S128 C1024, ~0.06 ms at 3.35 TB/s) against 8*B*S*C^2 FLOPs; in
// exchange the projection runs in full 128 x 128 tiles, not a head's 3*Dh
// columns a CTA, and shared memory and registers stay bounded at any head.
// Then the out-projection, as every body.

// Step 2: o of each (window, head) into attn from the packed qkv.
template <typename T>
inline cudaError_t attention_wide(const void* qkv, const void* kpad, void* attn, int B, int S,
                                  int C, int H, cudaStream_t st) {
  const long long DH = C / H, R = 3LL * C;
  const wide::Window W{S * R, DH, R, S * R, DH, R, S * R, DH, R, (long long)S * C, DH, C};
  const T* q = static_cast<const T*>(qkv);
  return wide::window<T, false, int>(q, q + C, q + 2 * C, static_cast<const int*>(kpad), attn,
                                     W, B, H, S, int(DH), 1.0f / sqrtf(static_cast<float>(DH)),
                                     st);
}

// ================================================================ dispatch
// The int8 bodies after their prologue: xq, xs -> o (attn) in T; a wide
// head takes 2d with the int8 projection into qkv (B*S, 3C) in T.
template <typename T>
inline cudaError_t attention_int8(const void* xq, const void* xs, const void* kpad,
                                  const void* wq, const void* wsc, const void* b_in,
                                  void* attn, void* qkv, int B, int S, int C, int H,
                                  cudaStream_t st) {
  if (C / H > kMaxTileDh) {
    if (qkv == nullptr) return cudaErrorInvalidValue;
    cudaError_t err = linear_int8<T>(xq, xs, wq, wsc, b_in, qkv, B * S, 3 * C, C, st);
    if (err != cudaSuccess) return err;
    return attention_wide<T>(qkv, kpad, attn, B, S, C, H, st);
  }
  if constexpr (std::is_same<T, float>::value) {
    return attention_int8_f32<T>(xq, xs, kpad, wq, wsc, b_in, attn, B, S, C, H, st);
  } else {
    return attention_tc<true>(xq, xs, kpad, wq, wsc, b_in, attn, B, S, C, H, st);
  }
}

// The exact bodies: a (x or xn) -> o (attn) in T; a wide head takes 2d with
// its projection into qkv (B*S, 3C) in T.
template <typename T>
inline cudaError_t attention_exact(const void* a, const void* kpad, const void* w_in,
                                   const void* b_in, void* attn, void* qkv, int B, int S, int C,
                                   int H, cudaStream_t st) {
  if (C / H > kMaxTileDh) {
    if (qkv == nullptr) return cudaErrorInvalidValue;
    if (!tc::aligned16(a) || !tc::aligned16(w_in)) return cudaErrorMisalignedAddress;
    cudaError_t err = linear<T>(a, w_in, b_in, qkv, B * S, 3 * C, C, st);
    if (err != cudaSuccess) return err;
    return attention_wide<T>(qkv, kpad, attn, B, S, C, H, st);
  }
  if constexpr (std::is_same<T, float>::value) {
    return attention_f32<T>(a, kpad, w_in, b_in, attn, B, S, C, H, st);
  } else {
    return attention_tc<false>(a, nullptr, kpad, w_in, nullptr, b_in, attn, B, S, C, H, st);
  }
}

// Runs fn(T{}) with T the element type of dtype (0: float32, 1: bfloat16).
template <typename Fn>
inline int by_dtype(int dtype, Fn&& fn) {
  if (dtype == 0) return fn(float{});
  if (dtype == 1) return fn(bf16{});
  return cudaErrorInvalidValue;
}

}  // namespace mha
}  // namespace exo
