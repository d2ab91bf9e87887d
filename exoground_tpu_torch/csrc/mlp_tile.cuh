// The tile the fused-MLP family shares on the H100's tensor cores:
//   fused_mlp.cu       out = MLP(x)                       (prologue kPlain)
//   block_mlp.cu       out = x + MLP(LN_2(x))             (kLn)
//   fused_mlp_int8.cu  out = MLP(x), c_fc as int8         (kQuant)
//   block_mlp.cu       out = x + MLP(LN_2(x)), int8 c_fc  (kLnQuant)
// with MLP(a) = QuickGELU(a . c_fc^T + b_fc) . c_proj^T + b_proj. The TPU
// kernels share one tail the same way (exoground_tpu/ops/fused_mlp.py::
// _mlp_tail :133, under _mlp_kernel :128, _block_mlp_kernel :149,
// _block_mlp_kernel_int8 :159 and _mlp_kernel_int8 :177): only the prologue,
// the first product's operands and the residual differ.
//
// Design. The point of the kernels is that the (rows, 4C) hidden activation
// never reaches device memory. A CTA of 8 warps owns kBM = 64 rows and a slab
// of NS <= 512 output columns (the f32 accumulator of 64 x 512 is 128 floats
// a thread), and walks the hidden dimension in chunks of kHC = 128 columns:
//   h = QuickGELU(a_tile . c_fc[chunk]^T + b_fc) rounded to c_proj's type
//   acc += h . c_proj[slab, chunk]^T
// Warp (wm, wn) = (warp / 4, warp % 4) owns rows 32 wm.. and, in the second
// product, output columns wn * NS/4..: two m-tiles by NS/32 n-tiles of the
// mma C fragment, so every operand fragment it reads from shared memory
// feeds 2 (A) or NS/32 (B) products. In the first product the same warp
// computes the 32 x 32 block of the chunk at rows 32 wm.., hidden columns
// 32 wn..; its C fragments take the bias (after the dequantization in the
// int8 bodies), QuickGELU in f32 and the rounding to c_proj's type in
// registers, and the 64 x 128 chunk meets in shared memory, from where each
// warp reads its 32 rows of it as A fragments: the 64 x 512 f32 tile needs
// all 8 warps' registers, so the hidden crosses shared memory once, as the
// TPU kernel's crosses VMEM. Above C = 512 the output is cut into 512-column
// slabs, each CTA recomputing the hidden for its slab (ceil(C/512) times).
//
// Pipeline. The operands go through two-slot cp.async rings (16-byte copies,
// zero-filled past the data): a first-product step stages c_fc[chunk]
// (128 x KC) and, unless the x tile is resident, x (64 x KC); a
// second-product step stages c_proj[slab, HB hidden columns]. Each step
// prefetches the next one's operands while it computes. The x tile stays in
// shared memory for the whole walk where it fits (C <= 512: bf16, or int8).
//
// Prologues. The statistics are per whole row even where the output is cut
// into slabs, so every body but kPlain first takes them for its 64 rows: the
// LN mean and rstd (two passes, IEEE root and quotients), and the int8 scale
// absmax / 127 (of x, or of the f32 LN output). Where one slab holds the
// whole row (C <= 512), the CTA stages its x tile in shared memory (the LN
// body's resident tile, else the space of the rings, not yet in use) and a
// warp takes each row's statistics there, the row in its registers; above
// it, from device memory (common.cuh's helpers). Then:
//   kLn: LN_2(x) rounded to x's type, as the TPU kernel casts xn to c_fc's
//     type: the resident bf16 tile in place in the prologue; a streamed
//     chunk (f32, or C > 512) in place as it lands, before its first use;
//   kQuant, kLnQuant: x (or its f32 LN output) quantized with the whole-row
//     scales (IEEE quotient, round half to even, clip to +-127) into an int8
//     tile: resident (64 x C bytes) up to C = 512, written in the prologue;
//     above it each staged K chunk as it is staged (plain loads).
// Neither LN_2(x) nor its int8 form reaches device memory.
//
// Products. bf16: mma.sync m16n8k16 through ldmatrix, at row pitches of 16
// bytes more than the data (the 8 row addresses of an ldmatrix fall in 8
// distinct 4-bank groups). f32: 3xTF32 (tc.cuh), the fragments read from
// shared memory as 32-bit words at pitches of 4 floats more than the data,
// each B value split once and used for both m-tiles. int8 c_fc: mma.sync
// m16n8k32 .s8 (exact int32 sums) through the same ldmatrix, the int8 tiles
// seen as b16; the C fragments are dequantized as float(acc) * xs[row] *
// ws[col] + b_fc[col], each step rounded on its own, in the plain version's
// order. c_proj is exact in every body, as in the TPU kernels.
//
// Few rows. Where the row tiles and slabs alone launch fewer CTAs than the
// card has SMs, the wrapper's plan (ops/fused_mlp.py::mlp_launch_plan)
// splits the hidden chunks over `split` CTAs (gridDim.z): each writes its
// f32 partial of the c_proj product to a workspace, and a second kernel sums
// the partials in split order, adds b_proj once (and the residual x in the
// block bodies) and rounds once. No atomics: the result is deterministic.
// Without a split the epilogue does the same from the accumulators.
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "tc.cuh"

namespace exo {
namespace mlp {

using bf16 = __nv_bfloat16;

// what runs before the first product, by body
enum Prologue : int { kPlain = 0, kLn = 1, kQuant = 2, kLnQuant = 3 };
__host__ __device__ constexpr bool has_ln(int p) { return p == kLn || p == kLnQuant; }
__host__ __device__ constexpr bool is_int8(int p) { return p == kQuant || p == kLnQuant; }

constexpr int kThreads = 256;  // 8 warps: 2 row blocks of 32 x 4 column quarters
constexpr int kBM = 64;        // rows a CTA owns
constexpr int kHC = 128;       // hidden columns a chunk

// Tile shapes. T: the type of x, the biases, c_proj and the output; P: the
// prologue; NS: the slab's output columns (a multiple of 128 up to 512);
// XRES: the x tile resident in shared memory.
template <typename T, int P, int NS, bool XRES>
struct Cfg {
  static constexpr bool BF = std::is_same<T, bf16>::value;
  static constexpr bool Q = is_int8(P);
  using F = typename std::conditional<Q, int8_t, T>::type;  // first-product operands
  static constexpr int EF = 16 / sizeof(F);     // F elements a 16-byte copy (and row padding)
  static constexpr int KC = Q ? 128 : 64;       // K of a first-product step
  static constexpr int PA = KC + EF;
  static constexpr int E = 16 / sizeof(T);      // T elements a 16-byte copy
  static constexpr int PAD = E;                 // row padding, T elements
  static constexpr int HB = BF ? 32 : 16;       // hidden columns of a second-product step
  static constexpr int PB = HB + PAD;
  static constexpr int NB = kHC / HB;           // second-product steps a chunk
  static constexpr int PH = kHC + PAD;          // pitch of the hidden chunk
  static constexpr int NTW = NS / 32;           // n-tiles of 8 a warp owns
  static constexpr int A_STAGE = kHC * PA + (XRES ? 0 : kBM * PA);  // F elements
  static constexpr int B_STAGE = NS * PB;                            // T elements
  static constexpr int STATS = P == kPlain ? 0 : 3 * kBM;            // mean, rstd, scale
  // Where one slab holds the whole row (C == NS), the prologue stages the x
  // tile (T, pitch C + E) past ring_a's first slot (which takes step 0's
  // operands meanwhile), where the rings and the hidden chunk will be, to
  // take its statistics there; the LN body's resident tile is that tile.
  static constexpr bool SCRATCH = P != kPlain && !(P == kLn && XRES);
  // the LN body's resident tile leaves ring_a free: step 1 is staged in the
  // prologue too (a chunk has at least two first-product steps there)
  static constexpr bool PRE2 = P == kLn && XRES;
  static size_t bytes(int C) {
    const size_t slot = sizeof(F) * A_STAGE;
    const size_t rings = 2 * slot + sizeof(T) * (2 * B_STAGE + kBM * PH);
    const size_t scratch = SCRATCH && C == NS ? slot + sizeof(T) * kBM * (C + E) : 0;
    return sizeof(float) * STATS + sizeof(F) * (XRES ? size_t(kBM) * (C + EF) : 0) +
           (rings > scratch ? rings : scratch);
  }
};

// two neighbouring values of a row in shared memory, as f32, and back
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store_pair(bf16* p, float2 v) {
  *reinterpret_cast<uint32_t*>(p) = exo::tc::pack_bf16(v.x, v.y);
}

template <typename A, int M, int N>
__device__ __forceinline__ void zero(A (&a)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][j][e] = 0;
}

// One CTA of the tile: rows 64 blockIdx.x.., output columns NS blockIdx.y..,
// hidden chunks of share blockIdx.z of gridDim.z. lnw, lnb: the LayerNorm
// (has_ln); fcsc: c_fc's per-row scales (is_int8, wfc then int8); ws: the
// f32 workspace of gridDim.z x rows x C (gridDim.z > 1).
template <int P, typename T, int NS, bool XRES>
__device__ __forceinline__ void tile(const T* __restrict__ x, const T* __restrict__ lnw,
                                     const T* __restrict__ lnb,
                                     const typename Cfg<T, P, NS, XRES>::F* __restrict__ wfc,
                                     const float* __restrict__ fcsc, const T* __restrict__ bfc,
                                     const T* __restrict__ wpr, const T* __restrict__ bpr,
                                     T* __restrict__ out, float* __restrict__ ws, int rows,
                                     int C) {
  using L = Cfg<T, P, NS, XRES>;
  using F = typename L::F;
  using Acc = typename std::conditional<L::Q, int, float>::type;
  using exo::tc::a_col;
  using exo::tc::a_row;
  using exo::tc::b_col;
  using exo::tc::b_row;
  using exo::tc::ldsm_x4;
  using exo::tc::load_a_tf32;
  using exo::tc::load_b_tf32;
  using exo::tc::mma_3xtf32;
  using exo::tc::pack_bf16;
  using exo::tc::Tf32A;
  using exo::tc::Tf32B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int PX = XRES ? C + L::EF : L::PA;  // x row pitch, F elements
  float* mu = reinterpret_cast<float*>(smem_raw);  // [kBM] each (P != kPlain): mean, rstd,
  float* rs = mu + kBM;                            // int8 scale of the CTA's rows
  float* xsc = rs + kBM;
  F* xres = reinterpret_cast<F*>(mu + L::STATS);  // [kBM][PX] when resident
  F* ring_a = xres + (XRES ? kBM * PX : 0);  // [2][A_STAGE]: c_fc (then x) rows
  T* ring_b = reinterpret_cast<T*>(ring_a + 2 * L::A_STAGE);  // [2][B_STAGE]: c_proj rows
  T* hs = ring_b + 2 * L::B_STAGE;           // [kBM][PH]: the hidden chunk

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, c = 2 * (lane % 4);
  const int r0 = blockIdx.x * kBM, n0 = blockIdx.y * NS;
  const int HID = 4 * C;
  const int nchunk = HID / kHC / gridDim.z;  // chunks of this CTA
  const int j0 = blockIdx.z * nchunk;
  const int NA = C / L::KC;                  // first-product steps a chunk
  const int spc = NA + L::NB;                // steps a chunk
  const int total = nchunk * spc;
  const int ncol0 = wn * (NS / 4);           // the warp's first column in the slab

  // rows [r0, r0 + kBM) of x, columns [k0, k0 + width) into dst (pitch p)
  auto stage_x = [&](T* dst, int p, int k0, int width) {
    const int ch = width / L::E;
    for (int e = tid; e < kBM * ch; e += kThreads) {
      const int r = e / ch, cc = (e % ch) * L::E;
      const bool in = r0 + r < rows;
      exo::tc::cp_async16(dst + r * p + cc, in ? x + size_t(r0 + r) * C + k0 + cc : x, in);
    }
  };
  // the same columns quantized with the whole-row scales (of the f32 LN
  // output in kLnQuant) into the int8 tile dst (pitch p); rows past `rows` 0
  auto quant_x = [&](int8_t* dst, int p, int k0, int width) {
    const int words = width / 4;
    for (int e = tid; e < kBM * words; e += kThreads) {
      const int r = e / words, k = 4 * (e % words);
      int w = 0;
      if (r0 + r < rows) {
        const T* src = x + size_t(r0 + r) * C + k0 + k;
        if constexpr (P == kLnQuant) {
          w = exo::ln_quant_pack4(src, lnw + k0 + k, lnb + k0 + k, mu[r], rs[r], xsc[r]);
        } else {
          w = exo::quant_pack4(src, xsc[r]);
        }
      }
      *reinterpret_cast<int*>(dst + r * p + k) = w;
    }
  };
  // LN_2 in place over a staged K chunk of x (pitch PA), rounded to x's type;
  // the thread's column is tid % KC, its LN weight and bias gk, bk
  auto ln_chunk = [&](T* t, float gk, float bk) {
    const int k = tid % L::KC;
    for (int r = tid / L::KC; r < kBM; r += kThreads / L::KC) {
      T* v = t + r * L::PA + k;
      *v = exo::from_f<T>(exo::ln_apply(exo::to_f(*v), mu[r], rs[r], gk, bk));
    }
  };
  // The statistics of the CTA's rows from the x tile t (pitch p) in shared
  // memory, where one slab holds the whole row (C == NS), one warp a row,
  // each lane holding NS / 64 pairs of columns: the LN mean and rstd and the
  // int8 scale into mu, rs, xsc; with a resident tile, the row's first
  // operand: LN_2 rounded to x's type in place (kLn), or the int8 values.
  constexpr int NP = NS / 64;
  float2 gv[NP], bv[NP];  // the LN weight and bias of the lane's columns in row_pass
  auto row_pass = [&](T* t, int p) {
#pragma unroll 4
    for (int r = warp; r < kBM; r += kThreads / 32) {
      float2 v[NP];
#pragma unroll
      for (int j = 0; j < NP; ++j) v[j] = load_pair(t + r * p + 64 * j + 2 * lane);
      float m = 0.f, sd = 0.f, sc = 1.f;
      if constexpr (has_ln(P)) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) sum += v[j].x + v[j].y;
        m = exo::warp_sum(sum) / static_cast<float>(C);
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const float dx = v[j].x - m, dy = v[j].y - m;
          sq = fmaf(dy, dy, fmaf(dx, dx, sq));
        }
        sd = 1.f / sqrtf(exo::warp_sum(sq) / static_cast<float>(C) + exo::kLnEps);
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          v[j] = make_float2(exo::ln_apply(v[j].x, m, sd, gv[j].x, bv[j].x),
                             exo::ln_apply(v[j].y, m, sd, gv[j].y, bv[j].y));
        }
      }
      if constexpr (L::Q) {
        float am = 0.f;
#pragma unroll
        for (int j = 0; j < NP; ++j) am = fmaxf(am, fmaxf(fabsf(v[j].x), fabsf(v[j].y)));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
        sc = exo::row_scale(am);
        if constexpr (XRES) {
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            const int q0 = exo::quant_i8(v[j].x, sc), q1 = exo::quant_i8(v[j].y, sc);
            *reinterpret_cast<uint16_t*>(xres + r * PX + 64 * j + 2 * lane) =
                static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
          }
        }
      } else if constexpr (XRES) {
#pragma unroll
        for (int j = 0; j < NP; ++j) store_pair(t + r * p + 64 * j + 2 * lane, v[j]);
      }
      if (lane == 0) {
        mu[r] = m;
        rs[r] = sd;
        xsc[r] = sc;
      }
    }
  };
  auto stage_step = [&](int st) {
    const int jc = st / spc, i = st % spc, c0 = (j0 + jc) * kHC;
    if (i < NA) {  // c_fc[c0 .., k0 ..] (+ x[.., k0 ..])
      F* dst = ring_a + ((jc * NA + i) & 1) * L::A_STAGE;
      const int k0 = i * L::KC;
      constexpr int ch = L::KC / L::EF;
      for (int e = tid; e < kHC * ch; e += kThreads) {
        const int r = e / ch, cc = (e % ch) * L::EF;
        exo::tc::cp_async16(dst + r * L::PA + cc, wfc + size_t(c0 + r) * C + k0 + cc, true);
      }
      if constexpr (!XRES) {
        if constexpr (L::Q) {
          quant_x(dst + kHC * L::PA, L::PA, k0, L::KC);
        } else {
          stage_x(dst + kHC * L::PA, L::PA, k0, L::KC);
        }
      }
    } else {  // c_proj[n0 .., c0 + hb ..]
      T* dst = ring_b + ((jc * L::NB + i - NA) & 1) * L::B_STAGE;
      const int hb = c0 + (i - NA) * L::HB;
      constexpr int ch = L::HB / L::E;
      for (int e = tid; e < NS * ch; e += kThreads) {
        const int n = e / ch, cc = (e % ch) * L::E;
        const bool in = n0 + n < C;
        exo::tc::cp_async16(dst + n * L::PB + cc,
                            in ? wpr + size_t(n0 + n) * HID + hb + cc : wpr, in);
      }
    }
  };

  if constexpr (P != kPlain) {
    if (C == NS) {
      // one slab holds the whole row: stage the x tile (the resident tile
      // itself in kLn, else past ring_a's first slot) beside step 0's
      // operands, and take the statistics there
      T* t = reinterpret_cast<T*>(L::SCRATCH ? ring_a + L::A_STAGE : xres);
      stage_x(t, C + L::E, 0, C);
      stage_step(0);
      exo::tc::cp_async_commit();
      if constexpr (L::PRE2) {  // step 1's operands land during the row pass
        stage_step(1);
        exo::tc::cp_async_commit();
      }
      if constexpr (has_ln(P)) {  // loaded while x lands
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int col = 64 * j + 2 * lane;
          gv[j] = make_float2(exo::to_f(lnw[col]), exo::to_f(lnw[col + 1]));
          bv[j] = make_float2(exo::to_f(lnb[col]), exo::to_f(lnb[col + 1]));
        }
      }
      if constexpr (L::PRE2) {
        exo::tc::cp_async_wait<1>();
      } else {
        exo::tc::cp_async_wait<0>();
      }
      __syncthreads();
      row_pass(t, C + L::E);
      __syncthreads();
    } else {
      // whole-row statistics from device memory, one warp a row
      for (int r = warp; r < kBM; r += kThreads / 32) {
        float m = 0.f, sd = 0.f, am = 0.f;
        if (r0 + r < rows) {
          const T* row = x + size_t(r0 + r) * C;
          if constexpr (has_ln(P)) exo::warp_ln_stats(row, C, lane, m, sd);
          if constexpr (P == kQuant) am = exo::warp_absmax(row, C, lane);
          if constexpr (P == kLnQuant) am = exo::warp_ln_absmax(row, lnw, lnb, C, lane, m, sd);
        }
        if (lane == 0) {
          mu[r] = m;
          rs[r] = sd;
          xsc[r] = exo::row_scale(am);
        }
      }
      __syncthreads();
      stage_step(0);
      exo::tc::cp_async_commit();
    }
  } else {
    if constexpr (XRES) stage_x(xres, PX, 0, C);
    stage_step(0);
    exo::tc::cp_async_commit();
  }

  float acc[2][L::NTW][4];  // rows 32 wm + 16 mt.., columns ncol0 + 8 nt..
  zero(acc);
  Acc hacc[2][4][4];        // rows 32 wm + 16 mt.., hidden columns 32 wn + 8 nt..
  zero(hacc);

  for (int st = 0; st < total; ++st) {
    __syncthreads();  // every warp is done with the slot about to be refilled
    if (!(L::PRE2 && st == 0)) {
      if (st + 1 < total) stage_step(st + 1);
      exo::tc::cp_async_commit();
    }
    const int jc = st / spc, i = st % spc;
    float gk = 0.f, bk = 0.f;  // a streamed kLn chunk: this thread's column's LN weight, bias
    if constexpr (P == kLn && !XRES) {
      if (i < NA) {
        gk = exo::to_f(lnw[i * L::KC + tid % L::KC]);
        bk = exo::to_f(lnb[i * L::KC + tid % L::KC]);
      }
    }
    exo::tc::cp_async_wait<1>();  // step st's operands have landed
    __syncthreads();
    if (i < NA) {
      const F* sa = ring_a + ((jc * NA + i) & 1) * L::A_STAGE;
      if constexpr (P == kLn && !XRES) {  // normalize the x that just landed
        ln_chunk(const_cast<F*>(sa) + kHC * L::PA, gk, bk);
        __syncthreads();
      }
      // ---- h += a[rows 32 wm.., k0..] . c_fc[32 wn.., k0..]^T ----
      const F* xt = (XRES ? xres + i * L::KC : sa + kHC * L::PA) + 32 * wm * PX;
      const F* wt = sa + 32 * wn * L::PA;
      if constexpr (L::Q) {
        // the int8 tiles seen as b16 (two values each): half the columns
        const uint16_t* xt2 = reinterpret_cast<const uint16_t*>(xt);
        const uint16_t* wt2 = reinterpret_cast<const uint16_t*>(wt);
        const int PX2 = PX / 2;
        constexpr int PA2 = L::PA / 2;
#pragma unroll
        for (int kk = 0; kk < L::KC / 32; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(a[mt], xt2 + (16 * mt + a_row(lane)) * PX2 + kk * 16 + a_col(lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bb[4];
            ldsm_x4(bb, wt2 + (np * 16 + b_row(lane)) * PA2 + kk * 16 + b_col(lane));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              exo::tc::mma_s8(hacc[mt][2 * np], a[mt], bb[0], bb[1]);
              exo::tc::mma_s8(hacc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
            }
          }
        }
      } else if constexpr (L::BF) {
#pragma unroll
        for (int kk = 0; kk < L::KC / 16; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(a[mt], xt + (16 * mt + a_row(lane)) * PX + kk * 16 + a_col(lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bb[4];
            ldsm_x4(bb, wt + (np * 16 + b_row(lane)) * L::PA + kk * 16 + b_col(lane));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              exo::tc::mma(hacc[mt][2 * np], a[mt], bb[0], bb[1]);
              exo::tc::mma(hacc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < L::KC / 8; ++kk) {
          Tf32A a[2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            a[mt] = load_a_tf32(xt + 16 * mt * PX + kk * 8, PX, lane);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const Tf32B b = load_b_tf32(wt + nt * 8 * L::PA + kk * 8, L::PA, lane);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_3xtf32(hacc[mt][nt], a[mt], b);
          }
        }
      }
      if (i == NA - 1) {
        // (dequantized,) bias, QuickGELU in f32, rounded to c_proj's type, into hs
        const int c0 = (j0 + jc) * kHC;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = 32 * wn + nt * 8 + c;
          const float b_lo = exo::to_f(bfc[c0 + col]), b_hi = exo::to_f(bfc[c0 + col + 1]);
          float s_lo = 0.f, s_hi = 0.f;
          if constexpr (L::Q) {
            s_lo = fcsc[c0 + col];
            s_hi = fcsc[c0 + col + 1];
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = 32 * wm + 16 * mt + g + 8 * half;
              float h0, h1;
              if constexpr (L::Q) {
                h0 = exo::dequant(hacc[mt][nt][2 * half], xsc[row], s_lo, b_lo);
                h1 = exo::dequant(hacc[mt][nt][2 * half + 1], xsc[row], s_hi, b_hi);
              } else {
                h0 = hacc[mt][nt][2 * half] + b_lo;
                h1 = hacc[mt][nt][2 * half + 1] + b_hi;
              }
              // QuickGELU: h * sigmoid(1.702 h)
              h0 = h0 * __frcp_rn(1.f + __expf(-1.702f * h0));
              h1 = h1 * __frcp_rn(1.f + __expf(-1.702f * h1));
              T* dst = hs + row * L::PH + col;
              if constexpr (L::BF) {
                *reinterpret_cast<uint32_t*>(dst) = pack_bf16(h0, h1);
              } else {
                *reinterpret_cast<float2*>(dst) = make_float2(h0, h1);
              }
            }
        }
        zero(hacc);
      }
    } else {
      // ---- acc += h[rows 32 wm.., hb..] . c_proj[slab columns ncol0.., hb..]^T ----
      const int ib = i - NA;
      const T* sb = ring_b + ((jc * L::NB + ib) & 1) * L::B_STAGE;
      const T* ht = hs + 32 * wm * L::PH + ib * L::HB;
      if constexpr (L::BF) {
#pragma unroll
        for (int kk = 0; kk < L::HB / 16; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(a[mt], ht + (16 * mt + a_row(lane)) * L::PH + kk * 16 + a_col(lane));
#pragma unroll
          for (int np = 0; np < L::NTW / 2; ++np) {
            const int col = ncol0 + np * 16;
            if (n0 + col < C) {
              uint32_t bb[4];
              ldsm_x4(bb, sb + (col + b_row(lane)) * L::PB + kk * 16 + b_col(lane));
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                exo::tc::mma(acc[mt][2 * np], a[mt], bb[0], bb[1]);
                exo::tc::mma(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < L::HB / 8; ++kk) {
          Tf32A a[2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            a[mt] = load_a_tf32(ht + 16 * mt * L::PH + kk * 8, L::PH, lane);
#pragma unroll
          for (int nt = 0; nt < L::NTW; ++nt) {
            const int col = ncol0 + nt * 8;
            if (n0 + col < C) {
              const Tf32B b = load_b_tf32(sb + col * L::PB + kk * 8, L::PB, lane);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_3xtf32(acc[mt][nt], a[mt], b);
            }
          }
        }
      }
    }
  }

  // ---- out = acc + b_proj (+ x) (one CTA over the hidden), else the f32 partial ----
  const bool partial = gridDim.z > 1;
  float* wz = ws + size_t(blockIdx.z) * rows * C;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 32 * wm + 16 * mt + g + 8 * half;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < L::NTW; ++nt) {
        const int n = n0 + ncol0 + nt * 8 + c;
        if (n >= C) continue;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (partial) {
          *reinterpret_cast<float2*>(wz + size_t(r) * C + n) = make_float2(v0, v1);
        } else {
          float o0 = v0 + exo::to_f(bpr[n]), o1 = v1 + exo::to_f(bpr[n + 1]);
          if constexpr (has_ln(P)) {  // the block's residual, in f32 before the one rounding
            o0 += exo::to_f(x[size_t(r) * C + n]);
            o1 += exo::to_f(x[size_t(r) * C + n + 1]);
          }
          if constexpr (L::BF) {
            *reinterpret_cast<uint32_t*>(out + size_t(r) * C + n) = pack_bf16(o0, o1);
          } else {
            *reinterpret_cast<float2*>(out + size_t(r) * C + n) = make_float2(o0, o1);
          }
        }
      }
    }
}

// out = sum over z of ws[z] (in z order) + b_proj, rounded once to T
template <typename T>
__device__ __forceinline__ void reduce(const float* __restrict__ ws, const T* __restrict__ bpr,
                                       T* __restrict__ out, int rows, int C, int split) {
  const size_t n = size_t(rows) * C;
  for (size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += size_t(gridDim.x) * blockDim.x) {
    float s = ws[e];
    for (int z = 1; z < split; ++z) s += ws[size_t(z) * n + e];
    out[e] = exo::from_f<T>(s + exo::to_f(bpr[e % C]));
  }
}

// The grid of a tile launch, and that of its reduction (256 threads a block)
inline dim3 tile_grid(int rows, int C, int ns, int split) {
  return dim3((rows + kBM - 1) / kBM, (C + ns - 1) / ns, split);
}
inline int reduce_blocks(int rows, int C) {
  const size_t n = (size_t(rows) * C + 255) / 256;
  return static_cast<int>(n < 4096 ? n : 4096);
}

// fn(std::integral_constant<int, NS>()) for the slab widths the tile takes
template <typename Fn>
cudaError_t by_slab(int slab, Fn&& fn) {
  switch (slab) {
    case 128: return fn(std::integral_constant<int, 128>());
    case 256: return fn(std::integral_constant<int, 256>());
    case 384: return fn(std::integral_constant<int, 384>());
    case 512: return fn(std::integral_constant<int, 512>());
    default: return cudaErrorInvalidValue;
  }
}

// The arguments the C entry points check alike: C a positive multiple of 128,
// split a divisor of the 4C / 128 hidden chunks, a workspace where it splits.
inline bool plan_ok(int rows, int C, int split, const void* ws) {
  return rows >= 1 && C >= 128 && C % 128 == 0 && split >= 1 && (4 * C / kHC) % split == 0 &&
         (split == 1 || ws != nullptr);
}

}  // namespace mlp
}  // namespace exo
