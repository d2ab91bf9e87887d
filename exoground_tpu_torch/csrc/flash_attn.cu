// Blockwise (flash) attention with key padding: forward, dq and dk/dv.
//
// Replaces the TPU kernel exoground_tpu/ops/attention.py::_flash: the
// forward _flash_fwd_impl (pallas_call at :279, body _fwd_kernel :116) and
// the backward _flash_bwd_rule (dq pallas_call at :329, body _dq_kernel
// :174; dk/dv pallas_call at :347, body _dkv_kernel :207).
//
// Layout: q (BH, Sq, D) already multiplied by 1/sqrt(D) by the caller, k and
// v (BH, Sk, D), kpad (B, Sk) int32 nonzero at a PAD key, with b = bh / H.
// Per (bh, query row) with s = q . k^T over the valid keys:
//   forward: o = sum_k exp(s - m) v / l, lse = m + log l (online max m and
//            sum l over key tiles); a row with no valid key gives o = 0 and
//            lse = +1e30, so every backward exp(s - lse) is 0 there;
//   dq:      p = exp(s - lse), dp = do . v^T, ds = p (dp - delta),
//            dq = sum_k ds k, with delta = sum_d do o (from the caller);
//   dk/dv:   dv = sum_q p^T do, dk = sum_q ds^T q.
// p is masked explicitly at invalid keys in all three kernels (an all-PAD
// tile has s - m = 0 there), as the TPU bodies do (:152, :189, :226).
//
// What bounds it on an H100: operations. The forward does 4*BH*Sq*Sk*D
// FLOPs against (2*BH*Sq*D + 2*BH*Sk*D)*itemsize bytes: at B1 H8 S2048 D64,
// 8.6 GFLOP per 8.4 MB in f32 (~1000 FLOP/byte, far above the f32 balance
// point of ~20 and the bf16 one of ~295). dq does 3 tile products and dk/dv
// 4 against the forward's 2. Nothing but the tile products' rate matters:
// the tensor cores' for bf16 and, in 3xTF32 (3 x 8.6 GFLOP / 495 TFLOP/s =
// 0.052 ms against 8.6 / 67 = 0.128 on the CUDA cores), for f32 too.
//
// Six bodies, three directions in two types, all on the tensor cores
// (tc.cuh). The TPU kernel runs a sequential grid (bh, q block, k block)
// with 512 x 1024 blocks and carries m, l and the accumulator in VMEM from
// one key block to the next. Hopper blocks run in parallel and in no order,
// so each CTA owns 64 rows and loops over the other axis itself: the
// forward and dq own 64 query rows and walk the key tiles of 64; dk/dv own
// 64 key rows and walk the query tiles, so there are no atomics and the
// result does not vary from run to run. Every body has 4 warps of 16 owned
// rows each, and:
//   - the walked tiles (K and V; Q and dO in dk/dv) arrive by 16-byte
//     cp.async into a two-stage ring: tile j + 1 loads while tile j is used;
//   - s (and dp) stay in the product's f32 accumulator fragments; the
//     online max and sum run on them with quad shuffles, and p (ds) goes
//     from the C fragments into the A fragments of the next product in
//     registers, with no shared-memory round trip;
//   - rows past Sq or Sk are zero-filled by cp.async and masked; head sizes
//     that are multiples of 8 up to 128 run in a tile of 32, 48, 64 or 128
//     columns with the rest zero-filled, larger ones in slabs of 64
//     columns, one cluster of CTAs a tile (namespace cl, below);
//   - dk/dv take the walked query tile in 64 columns at head tiles <= 64 and
//     in two halves of 32 at 128, to keep s^T, dp^T and the two D-wide
//     accumulators within the register file.
//
// bfloat16 (namespace tcb): every product is mma.sync m16n8k16 (bf16
// operands, f32 accumulators); operands come from shared memory by
// ldmatrix, an operand stored k-major (V and dO and Q and K as the
// right-hand side of p.v, ds.k, p^T.do, ds^T.q) by ldmatrix.trans. Tiles
// keep bf16 in shared memory with a row pitch of D + 8 elements, so the 8
// rows an ldmatrix reads fall in distinct banks. p (ds) is rounded to bf16
// as it is repacked. 128 threads and 26-104 KB of shared memory a CTA, so
// three or four CTAs share an SM at D <= 64. The forward keeps q's fragments
// in registers for the whole walk.
//
// float32 (namespace tf): the same walks with every product in 3xTF32
// (m16n8k8 .tf32, each operand split into a TF32 hi half and the rest; plain
// TF32 would miss the f32 limit of 1e-4 of max|plain|, 3xTF32 keeps float32
// accuracy). Tiles stay f32 in shared memory at a row pitch of D + 4 floats
// (4 mod 8: conflict-free fragment reads, row g and column t for the A and
// B operands, rows 2t and 2t + 1 and column g for an operand read k-major).
// p and ds stay f32, as the f32 TPU bodies keep them, and go from the C
// fragments to the A fragments of the next product by reading k-column t as
// key (query) 2t and t + 4 as 2t + 1, with the k-major operand's rows read to
// match (tc::c_to_a_tf32, tc::load_bk_tf32). The owned tile's fragments stay
// in registers for the walk at head tiles <= 64 (the forward q's hi/lo
// halves; dq q's and do's, dk/dv k's and v's as they lie, split at each
// use: 32 registers a tile where the halves would take 64) and are read
// from shared memory at 128. 87 KB (forward) and 105 KB (dq, dk/dv) of
// shared memory a CTA at head tile 64, two CTAs an SM.
//
// Every body stages q, k, v (and do) by 16-byte cp.async, so they must be
// 16-byte aligned; the entry points return cudaErrorMisalignedAddress
// otherwise.
//
// Rounding follows the TPU kernel for bf16 inputs: p is rounded to v's type
// before p . v (:157), ds to k's type before ds . k (:198) and to q's type
// before ds^T . q (:239). Products of bf16 values are exact in f32, so s, dp
// and the products round where the TPU bodies do. The f32 bodies run p^T .
// do on the unrounded f32 p (:229); the bf16 body's tensor cores take p
// rounded to bf16 there, one more rounding of ~2^-9 per element, inside the
// bf16 limit of 1e-2 of max|plain|. flash_attention_plain keeps the TPU
// order. In f32 nothing is rounded between products.
#include <cstddef>
#include <math.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "tc.cuh"
#include "wide_window.cuh"

namespace {

constexpr int kT = 64;             // rows per tile, both axes
constexpr float kNegInf = -1e30f;  // the TPU kernel's finite NEG_INF
constexpr float kTiny = 1e-30f;
constexpr int kThreads = 128;      // 4 warps of 16 owned rows, in every body

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

constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))

// A 64-row bf16 tile of DP columns (the head size rounded up to 16, with
// zeros past D) at a row pitch of DP + 8 elements: 16 bytes more than the
// row, so the 8 row addresses of an ldmatrix fall in 8 distinct 4-bank groups.
template <int DP>
struct TcTile {
  static constexpr int P = DP + 8;
  static constexpr int ELEMS = kT * P;
  static constexpr int KS = DP / 16;  // k-steps over the head
  static constexpr int NT = DP / 8;   // n-tiles over the head
};

// s[0..2*NP) += A (16 x 16 k-step, in registers) . B^T where B's rows (the
// n axis) are rows n0.. of the tile t at k-step ks: NP pairs of n-tiles.
template <int NP, int P>
__device__ __forceinline__ void mma_rows(float (&s)[2 * NP][4], const uint32_t (&a)[4],
                                         const bf16* t, int ks, int lane) {
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    uint32_t b[4];
    ldsm_x4(b, t + (np * 16 + b_row(lane)) * P + ks * 16 + b_col(lane));
    mma(s[2 * np], a, b[0], b[1]);
    mma(s[2 * np + 1], a, b[2], b[3]);
  }
}

// acc += P . T where P (16 x 16 k-step kk of a row block, as C fragments of
// the n-tiles 2 kk and 2 kk + 1) is rounded to bf16 into an A fragment and T
// is rows kk*16.. (the k axis) of the tile t, all NT of its column n-tiles.
template <int NT, int P, int NS>
__device__ __forceinline__ void mma_ptile(float (&acc)[NT][4], const float (&p)[NS][4],
                                          int kk, const bf16* t, int lane) {
  const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                         pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                         pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                         pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
  for (int dp = 0; dp < NT / 2; ++dp) {
    uint32_t b[4];
    ldsm_x4_t(b, t + (kk * 16 + a_row(lane)) * P + dp * 16 + a_col(lane));
    mma(acc[2 * dp], a, b[0], b[1]);
    mma(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// Rows r0 + 16 w + g and + 8 (< S), columns < D of acc, in bf16.
template <int NT>
__device__ __forceinline__ void store_tc(const float (&acc)[NT][4], bf16* dst, int S, int D,
                                         int r0) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, g = lane / 4, c = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 16 * w + g + 8 * half;
    if (r >= S) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + c;
      if (col < D) {
        *reinterpret_cast<uint32_t*>(dst + size_t(r) * D + col) =
            pack_bf16(acc[nt][2 * half], acc[nt][2 * half + 1]);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_tc(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// K and V rows k0.. (tile `stage` of the ring) and their validity.
template <int DP>
__device__ __forceinline__ void load_kv_tc(bf16* ks, bf16* vs, int* valid, const bf16* k,
                                           const bf16* v, const int* pad, int Sk, int D, int k0,
                                           int stage) {
  using L = TcTile<DP>;
  exo::tc::cp_tile<kT, DP, kThreads>(ks + stage * L::ELEMS, L::P, k, D, k0, Sk, 0, D);
  exo::tc::cp_tile<kT, DP, kThreads>(vs + stage * L::ELEMS, L::P, v, D, k0, Sk, 0, D);
  if (threadIdx.x < kT) {
    const int j = k0 + threadIdx.x;
    valid[stage * kT + threadIdx.x] = j < Sk && pad[j] == 0;
  }
}

// ---------------------------------------------------------------- forward
// At D <= 64 the register cap of 4 CTAs an SM (128) costs no spill, and 4 x
// 132 CTAs hold the 512 of B1 H8 S4096 (and the 416 of the global path's
// longest joint tower) in one wave, where 3 an SM leave a second.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 4 : 1)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ kpad,
                      bf16* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                      int D) {
  using L = TcTile<DP>;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [ELEMS]
  bf16* ks = qs + L::ELEMS;                      // [2][ELEMS]
  bf16* vs = ks + 2 * L::ELEMS;                  // [2][ELEMS]
  int* valid = reinterpret_cast<int*>(vs + 2 * L::ELEMS);  // [2][kT]
  const int bh = blockIdx.y, q0 = blockIdx.x * kT;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = 2 * (lane % 4);
  q += size_t(bh) * Sq * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  const int* pad = kpad + size_t(bh / H) * Sk;

  exo::tc::cp_tile<kT, DP, kThreads>(qs, L::P, q, D, q0, Sq, 0, D);
  load_kv_tc<DP>(ks, vs, valid, k, v, pad, Sk, D, 0, 0);
  exo::tc::cp_async_commit();

  uint32_t qf[L::KS][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[L::NT][4];
  zero_tc(acc);
  const int nk = (Sk + kT - 1) / kT;
  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (j + 1 < nk) load_kv_tc<DP>(ks, vs, valid, k, v, pad, Sk, D, (j + 1) * kT, st ^ 1);
    exo::tc::cp_async_commit();
    exo::tc::cp_async_wait<1>();  // tile j (and q) have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < L::KS; ++kk)
        ldsm_x4(qf[kk], qs + (16 * w + a_row(lane)) * L::P + kk * 16 + a_col(lane));
    }
    // s = q . k^T, 16 rows x 64 keys per warp
    float s[8][4];
    zero_tc(s);
    const bf16* kt = ks + st * L::ELEMS;
#pragma unroll
    for (int kk = 0; kk < L::KS; ++kk) mma_rows<4, L::P>(s, qf[kk], kt, kk, lane);
    // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (e = 2, 3);
    // an invalid key gets -inf, so it adds nothing to the max and exp2
    // gives exactly 0 (m stays finite: it starts at the finite NEG_INF)
    const int* vld = valid + st * kT;
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!vld[nt * 8 + c + e]) {
          s[nt][e] = -INFINITY;
          s[nt][2 + e] = -INFINITY;
        }
        mt[0] = fmaxf(mt[0], s[nt][e]);
        mt[1] = fmaxf(mt[1], s[nt][2 + e]);
      }
    float alpha[2], ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mt[r]));
      alpha[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      ml[r] = m_new * kLog2e;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[nt][e], kLog2e, -ml[e / 2]));
        s[nt][e] = p;
        rs[e / 2] += p;  // l sums the unrounded p
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];  // this thread's columns
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // o += p . v, p rounded to bf16 in registers (TPU :157)
    const bf16* vt = vs + st * L::ELEMS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ptile<L::NT, L::P, 8>(acc, s, kk, vt, lane);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const float lm = fmaxf(l[r], kTiny);
    inv[r] = 1.f / lm;
    const int row = q0 + 16 * w + lane / 4 + 8 * r;
    if (lane % 4 == 0 && row < Sq)
      lse[size_t(bh) * Sq + row] = l[r] > 0.f ? m[r] + logf(lm) : -kNegInf;
  }
  // o = acc / l: a multiply by the IEEE reciprocal, then one rounding to bf16
#pragma unroll
  for (int nt = 0; nt < L::NT; ++nt) {
    acc[nt][0] = acc[nt][0] * inv[0];
    acc[nt][1] = acc[nt][1] * inv[0];
    acc[nt][2] = acc[nt][2] * inv[1];
    acc[nt][3] = acc[nt][3] * inv[1];
  }
  store_tc<L::NT>(acc, o + size_t(bh) * Sq * D, Sq, D, q0);
}

// ---------------------------------------------------------------- dq
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ kpad,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Sq,
                     int Sk, int D) {
  using L = TcTile<DP>;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [ELEMS]
  bf16* dos = qs + L::ELEMS;                     // [ELEMS]
  bf16* ks = dos + L::ELEMS;                     // [2][ELEMS]
  bf16* vs = ks + 2 * L::ELEMS;                  // [2][ELEMS]
  int* valid = reinterpret_cast<int*>(vs + 2 * L::ELEMS);  // [2][kT]
  const int bh = blockIdx.y, q0 = blockIdx.x * kT;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = 2 * (lane % 4);
  q += size_t(bh) * Sq * D;
  dout += size_t(bh) * Sq * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  const int* pad = kpad + size_t(bh / H) * Sk;

  exo::tc::cp_tile<kT, DP, kThreads>(qs, L::P, q, D, q0, Sq, 0, D);
  exo::tc::cp_tile<kT, DP, kThreads>(dos, L::P, dout, D, q0, Sq, 0, D);
  load_kv_tc<DP>(ks, vs, valid, k, v, pad, Sk, D, 0, 0);
  exo::tc::cp_async_commit();

  float lse_l[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * w + lane / 4 + 8 * r;
    lse_l[r] = row < Sq ? lse[size_t(bh) * Sq + row] * kLog2e : 0.f;
    delta_r[r] = row < Sq ? delta[size_t(bh) * Sq + row] : 0.f;
  }
  float acc[L::NT][4];
  zero_tc(acc);
  const int nk = (Sk + kT - 1) / kT;
  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    __syncthreads();
    if (j + 1 < nk) load_kv_tc<DP>(ks, vs, valid, k, v, pad, Sk, D, (j + 1) * kT, st ^ 1);
    exo::tc::cp_async_commit();
    exo::tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ks + st * L::ELEMS;
    const bf16* vt = vs + st * L::ELEMS;
    // s = q . k^T and dp = do . v^T, q and do read by ldmatrix per k-step
    float s[8][4], dp[8][4];
    zero_tc(s);
    zero_tc(dp);
#pragma unroll
    for (int kk = 0; kk < L::KS; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(qa, qs + (16 * w + a_row(lane)) * L::P + kk * 16 + a_col(lane));
      ldsm_x4(da, dos + (16 * w + a_row(lane)) * L::P + kk * 16 + a_col(lane));
      mma_rows<4, L::P>(s, qa, kt, kk, lane);
      mma_rows<4, L::P>(dp, da, vt, kk, lane);
    }
    // ds = p (dp - delta), p = exp(s - lse) at valid keys (TPU :189)
    const int* vld = valid + st * kT;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = vld[nt * 8 + c + (e & 1)] != 0;
        const float p = ok ? exp2f(fmaf(s[nt][e], kLog2e, -lse_l[e / 2])) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[e / 2]);
      }
    // dq += ds . k, ds rounded to k's type in registers (TPU :198)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ptile<L::NT, L::P, 8>(acc, s, kk, kt, lane);
  }
  store_tc<L::NT>(acc, dq + size_t(bh) * Sq * D, Sq, D, q0);
}

// ---------------------------------------------------------------- dk/dv
// Query columns handled at once: 64, or 32 at D > 64 to keep s^T, dp^T and
// the two D-wide accumulators within the register file.
template <int DP> struct DkvCols { static constexpr int NS = DP > 64 ? 32 : 64; };

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const int* __restrict__ kpad,
                      const bf16* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int Sq, int Sk, int D) {
  using L = TcTile<DP>;
  constexpr int NS = DkvCols<DP>::NS, NST = NS / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* ks = reinterpret_cast<bf16*>(smem_tc);  // [ELEMS], this CTA's keys
  bf16* vs = ks + L::ELEMS;                      // [ELEMS]
  bf16* qs = vs + L::ELEMS;                      // [2][ELEMS], the walked query tiles
  bf16* dos = qs + 2 * L::ELEMS;                 // [2][ELEMS]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * L::ELEMS);  // [2][kT], times log2(e)
  float* delta_s = lse_s + 2 * kT;                              // [2][kT]
  const int bh = blockIdx.y, k0 = blockIdx.x * kT;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = 2 * (lane % 4);
  q += size_t(bh) * Sq * D;
  dout += size_t(bh) * Sq * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  lse += size_t(bh) * Sq;
  delta += size_t(bh) * Sq;
  const int* pad = kpad + size_t(bh / H) * Sk;

  auto load_q = [&](int q0, int stage) {
    exo::tc::cp_tile<kT, DP, kThreads>(qs + stage * L::ELEMS, L::P, q, D, q0, Sq, 0, D);
    exo::tc::cp_tile<kT, DP, kThreads>(dos + stage * L::ELEMS, L::P, dout, D, q0, Sq, 0, D);
    if (threadIdx.x < kT) {
      const int i = q0 + threadIdx.x;
      lse_s[stage * kT + threadIdx.x] = i < Sq ? lse[i] * kLog2e : 0.f;
      delta_s[stage * kT + threadIdx.x] = i < Sq ? delta[i] : 0.f;
    }
  };
  exo::tc::cp_tile<kT, DP, kThreads>(ks, L::P, k, D, k0, Sk, 0, D);
  exo::tc::cp_tile<kT, DP, kThreads>(vs, L::P, v, D, k0, Sk, 0, D);
  load_q(0, 0);
  exo::tc::cp_async_commit();

  bool kv_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * w + lane / 4 + 8 * r;
    kv_ok[r] = key < Sk && pad[key] == 0;
  }
  float dk_acc[L::NT][4], dv_acc[L::NT][4];
  zero_tc(dk_acc);
  zero_tc(dv_acc);
  const int nq = (Sq + kT - 1) / kT;
  for (int i = 0; i < nq; ++i) {
    const int st = i & 1, q0 = i * kT;
    __syncthreads();
    if (i + 1 < nq) load_q(q0 + kT, st ^ 1);
    exo::tc::cp_async_commit();
    exo::tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* qt = qs + st * L::ELEMS;
    const bf16* dot = dos + st * L::ELEMS;
    // one column block at head tiles <= 64; at 128 the two blocks stay a
    // loop: unrolled, they do not fit the register file (ptxas spills)
#pragma unroll 1
    for (int h0 = 0; h0 < kT; h0 += NS) {
      // s^T = k . q^T and dp^T = v . do^T over query columns h0.. + NS
      float s[NST][4], dp[NST][4];
      zero_tc(s);
      zero_tc(dp);
#pragma unroll
      for (int kk = 0; kk < L::KS; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, ks + (16 * w + a_row(lane)) * L::P + kk * 16 + a_col(lane));
        ldsm_x4(va, vs + (16 * w + a_row(lane)) * L::P + kk * 16 + a_col(lane));
        mma_rows<NST / 2, L::P>(s, ka, qt + h0 * L::P, kk, lane);
        mma_rows<NST / 2, L::P>(dp, va, dot + h0 * L::P, kk, lane);
      }
      // p^T = exp(s^T - lse) at valid keys and queries (TPU :226); ds^T =
      // p^T (dp^T - delta) from the unrounded p
#pragma unroll
      for (int nt = 0; nt < NST; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = h0 + nt * 8 + c + (e & 1);
          const bool ok = kv_ok[e / 2] && q0 + col < Sq;
          const float p = ok ? exp2f(fmaf(s[nt][e], kLog2e, -lse_s[st * kT + col])) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - delta_s[st * kT + col]);
        }
      // dv += p^T . do with p^T rounded to bf16 (the f32 body and TPU :229
      // use the unrounded p); dk += ds^T . q, ds^T rounded to q's type (:239)
#pragma unroll
      for (int kk = 0; kk < NST / 2; ++kk) {
        mma_ptile<L::NT, L::P, NST>(dv_acc, s, kk, dot + h0 * L::P, lane);
        mma_ptile<L::NT, L::P, NST>(dk_acc, dp, kk, qt + h0 * L::P, lane);
      }
    }
  }
  store_tc<L::NT>(dk_acc, dk + size_t(bh) * Sk * D, Sk, D, k0);
  store_tc<L::NT>(dv_acc, dv + size_t(bh) * Sk * D, Sk, D, k0);
}

}  // namespace tcb

// ============================================================ float32: 3xTF32
namespace tf {

using exo::tc::load_a_tf32;
using exo::tc::load_b_tf32;
using exo::tc::load_bk_tf32;
using exo::tc::mma_3xtf32;
using exo::tc::quad_max;
using exo::tc::quad_sum;
using exo::tc::Tf32A;
using exo::tc::Tf32B;

using tcb::kLog2e;
using tcb::zero_tc;

// A 64-row f32 tile of DP columns (the head tile, zeros past D) at a row
// pitch of DP + 4 floats: 4 (mod 8), so the A and B fragment reads of q and
// k (row g, column t) and the k-major B reads of v (rows 2t, 2t + 1, column
// g) each touch 32 distinct banks. QREG: the owned tile's fragments stay in
// registers for the whole walk (the forward's q as hi/lo halves, 64
// registers at DP 64; the backward's two owned tiles as they lie, 32 each);
// at DP 128 they would take twice that, so they are read from shared memory
// at each k-step there.
template <int DP>
struct Tf32Tile {
  static constexpr int P = DP + 4;
  static constexpr int ELEMS = kT * P;
  static constexpr int KS = DP / 8;  // k-steps over the head (m16n8k8)
  static constexpr int NT = DP / 8;  // n-tiles over the head
  static constexpr bool QREG = DP <= 64;
};

// K and V rows k0.. (tile `stage` of the ring) and their validity.
template <int DP>
__device__ __forceinline__ void load_kv(float* ks, float* vs, int* valid, const float* k,
                                        const float* v, const int* pad, int Sk, int D, int k0,
                                        int stage) {
  using L = Tf32Tile<DP>;
  exo::tc::cp_tile<kT, DP, kThreads>(ks + stage * L::ELEMS, L::P, k, D, k0, Sk, 0, D);
  exo::tc::cp_tile<kT, DP, kThreads>(vs + stage * L::ELEMS, L::P, v, D, k0, Sk, 0, D);
  if (threadIdx.x < kT) {
    const int j = k0 + threadIdx.x;
    valid[stage * kT + threadIdx.x] = j < Sk && pad[j] == 0;
  }
}

// The bf16 forward's walk (64 query rows a CTA, key tiles of 64 in a
// two-stage cp.async ring, the online max and sum on the fragments) with
// every product in 3xTF32 and p kept in float32 (the f32 TPU body and
// flash_attention_plain do not round it): p goes from the score C fragments
// to the A fragments of o += p . v in registers (tc::c_to_a_tf32), v read
// k-major to match. Two CTAs an SM at DP <= 64 (87 KB of shared memory).
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ kpad,
                      float* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk,
                      int D) {
  using L = Tf32Tile<DP>;
  extern __shared__ __align__(16) unsigned char smem_tf[];
  float* qs = reinterpret_cast<float*>(smem_tf);  // [ELEMS]
  float* ks = qs + L::ELEMS;                        // [2][ELEMS]
  float* vs = ks + 2 * L::ELEMS;                    // [2][ELEMS]
  int* valid = reinterpret_cast<int*>(vs + 2 * L::ELEMS);  // [2][kT]
  const int bh = blockIdx.y, q0 = blockIdx.x * kT;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = 2 * (lane % 4);
  q += size_t(bh) * Sq * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  const int* pad = kpad + size_t(bh / H) * Sk;

  exo::tc::cp_tile<kT, DP, kThreads>(qs, L::P, q, D, q0, Sq, 0, D);
  load_kv<DP>(ks, vs, valid, k, v, pad, Sk, D, 0, 0);
  exo::tc::cp_async_commit();

  const float* qw = qs + 16 * w * L::P;  // this warp's 16 query rows
  Tf32A qf[L::QREG ? L::KS : 1];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[L::NT][4];
#pragma unroll
  for (int i = 0; i < L::NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int nk = (Sk + kT - 1) / kT;
  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (j + 1 < nk) load_kv<DP>(ks, vs, valid, k, v, pad, Sk, D, (j + 1) * kT, st ^ 1);
    exo::tc::cp_async_commit();
    exo::tc::cp_async_wait<1>();  // tile j (and q) have landed
    __syncthreads();
    if constexpr (L::QREG) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < L::KS; ++kk) qf[kk] = load_a_tf32(qw + kk * 8, L::P, lane);
      }
    }
    // s = q . k^T, 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
    const float* kt = ks + st * L::ELEMS;
#pragma unroll
    for (int kk = 0; kk < L::KS; ++kk) {
      Tf32A a;
      if constexpr (L::QREG) {
        a = qf[kk];
      } else {
        a = load_a_tf32(qw + kk * 8, L::P, lane);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const Tf32B b = load_b_tf32(kt + nt * 8 * L::P + kk * 8, L::P, lane);
        mma_3xtf32(s[nt], a, b);
      }
    }
    // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (e = 2, 3);
    // an invalid key gets -inf, so it adds nothing to the max and exp2
    // gives exactly 0 (m stays finite: it starts at the finite NEG_INF)
    const int* vld = valid + st * kT;
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!vld[nt * 8 + c + e]) {
          s[nt][e] = -INFINITY;
          s[nt][2 + e] = -INFINITY;
        }
        mt[0] = fmaxf(mt[0], s[nt][e]);
        mt[1] = fmaxf(mt[1], s[nt][2 + e]);
      }
    float alpha[2], ml[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mt[r]));
      alpha[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      ml[r] = m_new * kLog2e;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[nt][e], kLog2e, -ml[e / 2]));
        s[nt][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];  // this thread's columns
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // o += p . v, p in float32 from the score fragments
    const float* vt = vs + st * L::ELEMS;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const Tf32A a = exo::tc::c_to_a_tf32(s[kk]);
#pragma unroll
      for (int dn = 0; dn < L::NT; ++dn) {
        const Tf32B b = load_bk_tf32(vt + kk * 8 * L::P + dn * 8, L::P, lane);
        mma_3xtf32(acc[dn], a, b);
      }
    }
  }
  float lm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    lm[r] = fmaxf(l[r], kTiny);
    const int row = q0 + 16 * w + lane / 4 + 8 * r;
    if (lane % 4 == 0 && row < Sq)
      lse[size_t(bh) * Sq + row] = l[r] > 0.f ? m[r] + logf(lm[r]) : -kNegInf;
  }
  // o = acc / l (an empty row: 0 / 1e-30 = 0)
  float* ob = o + size_t(bh) * Sq * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + 16 * w + lane / 4 + 8 * half;
    if (r >= Sq) continue;
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt) {
      const int col = nt * 8 + c;
      if (col < D) {
        *reinterpret_cast<float2*>(ob + size_t(r) * D + col) =
            make_float2(acc[nt][2 * half] / lm[half], acc[nt][2 * half + 1] / lm[half]);
      }
    }
  }
}

// The A fragment of rows 0.. of a row-major f32 tile at pitch p as it lies
// (a0 = t[g][c], a1 = t[g + 8][c], a2 = t[g][c + 4], a3 = t[g + 8][c + 4]),
// split into TF32 halves at each use (split_a): the backward bodies hold
// their owned tiles' fragments in this form for the walk.
__device__ __forceinline__ void load_a_f32(float (&a)[4], const float* t, int p, int lane) {
  const int g = lane / 4, c = lane % 4;
  a[0] = t[g * p + c];
  a[1] = t[(g + 8) * p + c];
  a[2] = t[g * p + c + 4];
  a[3] = t[(g + 8) * p + c + 4];
}

__device__ __forceinline__ Tf32A split_a(const float (&x)[4]) {
  Tf32A a;
#pragma unroll
  for (int i = 0; i < 4; ++i) exo::tc::split_tf32(x[i], a.hi[i], a.lo[i]);
  return a;
}

// An owned tile's fragments held for the walk (one unused slot at DP 128).
template <int DP>
using Owned = float[Tf32Tile<DP>::QREG ? Tf32Tile<DP>::KS : 1][4];

// k-step kk of an owned tile's A operand: from the fragments held for the
// walk (head tiles <= 64) or from this warp's rows tw in shared memory (128).
template <int DP>
__device__ __forceinline__ Tf32A owned_a(const Owned<DP>& f, const float* tw, int kk, int lane) {
  if constexpr (Tf32Tile<DP>::QREG) {
    return split_a(f[kk]);
  } else {
    return load_a_tf32(tw + kk * 8, Tf32Tile<DP>::P, lane);
  }
}

// Rows r0 + 16 w + g and + 8 (< S), columns < D of acc, as float2 pairs.
template <int NT>
__device__ __forceinline__ void store_f32(const float (&acc)[NT][4], float* dst, int S, int D,
                                          int r0) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 16 * w + lane / 4 + 8 * half;
    if (r >= S) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + c;
      if (col < D) {
        *reinterpret_cast<float2*>(dst + size_t(r) * D + col) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- dq
// 64 query rows a CTA; key tiles of 64 walked in the forward's ring. Per
// tile s = q . k^T and dp = do . v^T (q and do the A operands, k and v read
// n-major), ds = p (dp - delta) on the fragments with p = exp(s - lse) at
// valid keys (TPU :189), then dq += ds . k with ds in float32 from the C
// fragments and k read k-major (TPU :198, unrounded in f32).
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
flash_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ kpad,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq, int H, int Sq,
                     int Sk, int D) {
  using L = Tf32Tile<DP>;
  extern __shared__ __align__(16) unsigned char smem_tf[];
  float* qs = reinterpret_cast<float*>(smem_tf);  // [ELEMS]
  float* dos = qs + L::ELEMS;                       // [ELEMS]
  float* ks = dos + L::ELEMS;                       // [2][ELEMS]
  float* vs = ks + 2 * L::ELEMS;                    // [2][ELEMS]
  int* valid = reinterpret_cast<int*>(vs + 2 * L::ELEMS);  // [2][kT]
  const int bh = blockIdx.y, q0 = blockIdx.x * kT;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = 2 * (lane % 4);
  q += size_t(bh) * Sq * D;
  dout += size_t(bh) * Sq * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  const int* pad = kpad + size_t(bh / H) * Sk;

  exo::tc::cp_tile<kT, DP, kThreads>(qs, L::P, q, D, q0, Sq, 0, D);
  exo::tc::cp_tile<kT, DP, kThreads>(dos, L::P, dout, D, q0, Sq, 0, D);
  load_kv<DP>(ks, vs, valid, k, v, pad, Sk, D, 0, 0);
  exo::tc::cp_async_commit();

  float lse_l[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * w + lane / 4 + 8 * r;
    lse_l[r] = row < Sq ? lse[size_t(bh) * Sq + row] * kLog2e : 0.f;
    delta_r[r] = row < Sq ? delta[size_t(bh) * Sq + row] : 0.f;
  }
  const float* qw = qs + 16 * w * L::P;  // this warp's 16 query rows
  const float* dw = dos + 16 * w * L::P;
  Owned<DP> qf, df;
  float acc[L::NT][4];
  zero_tc(acc);
  const int nk = (Sk + kT - 1) / kT;
  for (int j = 0; j < nk; ++j) {
    const int st = j & 1;
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (j + 1 < nk) load_kv<DP>(ks, vs, valid, k, v, pad, Sk, D, (j + 1) * kT, st ^ 1);
    exo::tc::cp_async_commit();
    exo::tc::cp_async_wait<1>();  // tile j (and q, do) have landed
    __syncthreads();
    if constexpr (L::QREG) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < L::KS; ++kk) {
          load_a_f32(qf[kk], qw + kk * 8, L::P, lane);
          load_a_f32(df[kk], dw + kk * 8, L::P, lane);
        }
      }
    }
    // s = q . k^T and dp = do . v^T, 16 rows x 64 keys per warp
    float s[8][4], dp[8][4];
    zero_tc(s);
    zero_tc(dp);
    const float* kt = ks + st * L::ELEMS;
    const float* vt = vs + st * L::ELEMS;
#pragma unroll
    for (int kk = 0; kk < L::KS; ++kk) {
      const Tf32A qa = owned_a<DP>(qf, qw, kk, lane);
      const Tf32A da = owned_a<DP>(df, dw, kk, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mma_3xtf32(s[nt], qa, load_b_tf32(kt + nt * 8 * L::P + kk * 8, L::P, lane));
        mma_3xtf32(dp[nt], da, load_b_tf32(vt + nt * 8 * L::P + kk * 8, L::P, lane));
      }
    }
    // ds = p (dp - delta), p = exp(s - lse) at valid keys, in float32
    const int* vld = valid + st * kT;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = vld[nt * 8 + c + (e & 1)] != 0;
        const float p = ok ? exp2f(fmaf(s[nt][e], kLog2e, -lse_l[e / 2])) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[e / 2]);
      }
    // dq += ds . k
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const Tf32A a = exo::tc::c_to_a_tf32(s[kk]);
#pragma unroll
      for (int dn = 0; dn < L::NT; ++dn)
        mma_3xtf32(acc[dn], a, load_bk_tf32(kt + kk * 8 * L::P + dn * 8, L::P, lane));
    }
  }
  store_f32<L::NT>(acc, dq + size_t(bh) * Sq * D, Sq, D, q0);
}

// ---------------------------------------------------------------- dk/dv
// 64 key rows a CTA; query tiles of 64 (with their lse and delta) walked in
// a two-stage ring, NS query columns at a time. Per column block s^T = k .
// q^T and dp^T = v . do^T (k and v the A operands, q and do read n-major),
// p^T = exp(s^T - lse) at valid keys and queries (TPU :226) and ds^T = p^T
// (dp^T - delta), both float32; then dv += p^T . do (the unrounded p, TPU
// :229) and dk += ds^T . q (:239), q and do read k-major.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
flash_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ kpad,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int H, int Sq, int Sk, int D) {
  using L = Tf32Tile<DP>;
  constexpr int NS = tcb::DkvCols<DP>::NS, NST = NS / 8;
  extern __shared__ __align__(16) unsigned char smem_tf[];
  float* ks = reinterpret_cast<float*>(smem_tf);  // [ELEMS], this CTA's keys
  float* vs = ks + L::ELEMS;                        // [ELEMS]
  float* qs = vs + L::ELEMS;                        // [2][ELEMS], the walked query tiles
  float* dos = qs + 2 * L::ELEMS;                   // [2][ELEMS]
  float* lse_s = dos + 2 * L::ELEMS;                // [2][kT], times log2(e)
  float* delta_s = lse_s + 2 * kT;                  // [2][kT]
  const int bh = blockIdx.y, k0 = blockIdx.x * kT;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = 2 * (lane % 4);
  q += size_t(bh) * Sq * D;
  dout += size_t(bh) * Sq * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  lse += size_t(bh) * Sq;
  delta += size_t(bh) * Sq;
  const int* pad = kpad + size_t(bh / H) * Sk;

  auto load_q = [&](int q0, int stage) {
    exo::tc::cp_tile<kT, DP, kThreads>(qs + stage * L::ELEMS, L::P, q, D, q0, Sq, 0, D);
    exo::tc::cp_tile<kT, DP, kThreads>(dos + stage * L::ELEMS, L::P, dout, D, q0, Sq, 0, D);
    if (threadIdx.x < kT) {
      const int i = q0 + threadIdx.x;
      lse_s[stage * kT + threadIdx.x] = i < Sq ? lse[i] * kLog2e : 0.f;
      delta_s[stage * kT + threadIdx.x] = i < Sq ? delta[i] : 0.f;
    }
  };
  exo::tc::cp_tile<kT, DP, kThreads>(ks, L::P, k, D, k0, Sk, 0, D);
  exo::tc::cp_tile<kT, DP, kThreads>(vs, L::P, v, D, k0, Sk, 0, D);
  load_q(0, 0);
  exo::tc::cp_async_commit();

  bool kv_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * w + lane / 4 + 8 * r;
    kv_ok[r] = key < Sk && pad[key] == 0;
  }
  const float* kw = ks + 16 * w * L::P;  // this warp's 16 keys
  const float* vw = vs + 16 * w * L::P;
  Owned<DP> kf, vf;
  float dk_acc[L::NT][4], dv_acc[L::NT][4];
  zero_tc(dk_acc);
  zero_tc(dv_acc);
  const int nq = (Sq + kT - 1) / kT;
  for (int i = 0; i < nq; ++i) {
    const int st = i & 1, q0 = i * kT;
    __syncthreads();
    if (i + 1 < nq) load_q(q0 + kT, st ^ 1);
    exo::tc::cp_async_commit();
    exo::tc::cp_async_wait<1>();
    __syncthreads();
    if constexpr (L::QREG) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < L::KS; ++kk) {
          load_a_f32(kf[kk], kw + kk * 8, L::P, lane);
          load_a_f32(vf[kk], vw + kk * 8, L::P, lane);
        }
      }
    }
    const float* qt = qs + st * L::ELEMS;
    const float* dot = dos + st * L::ELEMS;
    const float* ls = lse_s + st * kT;
    const float* dl = delta_s + st * kT;
    // one column block at head tiles <= 64; at 128 the two blocks stay a
    // loop: unrolled, they do not fit the register file (ptxas spills)
#pragma unroll 1
    for (int h0 = 0; h0 < kT; h0 += NS) {
      // s^T = k . q^T and dp^T = v . do^T over query columns h0.. + NS
      float s[NST][4], dp[NST][4];
      zero_tc(s);
      zero_tc(dp);
#pragma unroll
      for (int kk = 0; kk < L::KS; ++kk) {
        const Tf32A ka = owned_a<DP>(kf, kw, kk, lane);
        const Tf32A va = owned_a<DP>(vf, vw, kk, lane);
#pragma unroll
        for (int nt = 0; nt < NST; ++nt) {
          const int row = (h0 + nt * 8) * L::P + kk * 8;
          mma_3xtf32(s[nt], ka, load_b_tf32(qt + row, L::P, lane));
          mma_3xtf32(dp[nt], va, load_b_tf32(dot + row, L::P, lane));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NST; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = h0 + nt * 8 + c + (e & 1);
          const bool ok = kv_ok[e / 2] && q0 + col < Sq;
          const float p = ok ? exp2f(fmaf(s[nt][e], kLog2e, -ls[col])) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dl[col]);
        }
      // dv += p^T . do and dk += ds^T . q, both from the f32 fragments
#pragma unroll
      for (int kk = 0; kk < NST; ++kk) {
        const Tf32A pa = exo::tc::c_to_a_tf32(s[kk]);
        const Tf32A da = exo::tc::c_to_a_tf32(dp[kk]);
        const int row = (h0 + kk * 8) * L::P;
#pragma unroll
        for (int dn = 0; dn < L::NT; ++dn) {
          mma_3xtf32(dv_acc[dn], pa, load_bk_tf32(dot + row + dn * 8, L::P, lane));
          mma_3xtf32(dk_acc[dn], da, load_bk_tf32(qt + row + dn * 8, L::P, lane));
        }
      }
    }
  }
  store_f32<L::NT>(dk_acc, dk + size_t(bh) * Sk * D, Sk, D, k0);
  store_f32<L::NT>(dv_acc, dv + size_t(bh) * Sk * D, Sk, D, k0);
}

}  // namespace tf


// ============================================== wide heads (D > 128): clusters
// The fixed head tiles end at 128: at D 256 the f32 forward's q tile and its
// ring of k and v would take 333 KB of shared memory and o 128 registers a
// thread (dk/dv twice that). Above 128 the head is cut into slabs of 64
// columns (wide_window.cuh), and the CTAs that share one (64-row tile, bh)
// form a thread-block cluster along grid z, each owning a pair of
// consecutive slabs of every operand (ceil(D / 128) CTAs up to D 1024), or
// above D 1024, where that would pass 8 CTAs (the portable cluster limit),
// ceil(D / 1024) consecutive pairs (cta_pairs below). A CTA stages its own
// slabs only: the owned tile's (q in the forward; q and do in dq; k and v in
// dk/dv) once a pass, and each walked tile's (k and v; q and do in dk/dv)
// as the walk reaches it, by 16-byte cp.async.
// The products that reduce over the head (s = q . k^T, dp = do . v^T and
// their transposes) are sums over the slabs: each CTA computes its partial
// over its own slabs (16 KB of f32 fragments a 64 x 64 tile) and the cluster
// sums the partials in rank order through distributed shared memory
// (exchange() below), so that every CTA holds bit-identical scores, softmax
// statistics and p. The score work is done once (the recompute bodies before
// did it ceil(D / 64) times). The products that produce the output (p . v,
// ds . k, p^T . do, ds^T . q) read the CTA's own slabs of their right-hand
// operand, already staged. Rank 0 writes lse; no CTA leaves while a peer
// may still read its partials. 4 warps of 16 owned rows, as the fixed-tile
// bodies; products through the slab helpers (bf16 mma.sync m16n8k16, f32
// 3xTF32), the masking and rounding as the fixed-tile bodies.
// A CTA that owns np > 1 pairs walks them in turn, one pass of the whole
// walk a pair, with that pair's accumulators in registers and its slabs
// staged as above: shared memory and registers stay those of one pair at
// any head size. Its partial scores still span all its slabs: at each step
// of a pass it first stages its other pairs' slabs, a pair at a time,
// through the step's buffers and adds their products, then the pass pair's.
// So above D 1024 the scores are computed np times (once below), and the
// passes add a CTA's slabs in different orders: within a pass every CTA
// holds the same bits; two passes' outputs agree to rounding. Each body is
// built twice: kMulti false (one pair a CTA, D <= 1024) compiles the passes
// and the other pairs' loop away.
// Measured at B64 H8 S64 and S128, D 256 (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md §6): the CTAs are short (one or two walked tiles) and wait on
// loads and on the cluster, so their time follows how many share an SM and
// what the exchange costs, more than the products:
//   - two slabs a CTA (a cluster of 2 at D 256) against one (4): dq + dk/dv
//     0.72x / 0.93x the time in f32 / bf16, the forward 1.0x / 0.80x;
//   - the next walked tile staged when the current one is done, not in a
//     two-stage ring: the shared memory that buys (f32 forward at one slab
//     84 KB against 120 KB) let twice the CTAs share an SM, 0.58x the time;
//   - every CTA reads every rank's partial into its own registers, from one
//     buffer whose reuse a split cluster barrier guards (arrive once the
//     peers' partials are read, wait before the next write: by then the wait
//     is met); with a double buffer in its place dq + dk/dv took 1.6x as long
//     in bf16 (the exchange's 64 KB held dq and dk/dv at one CTA an SM).
namespace cl {

namespace cg = cooperative_groups;
using exo::wide::kDS;
using exo::wide::Pitch;
using exo::wide::slab_pv;
using exo::wide::slab_qk;
using exo::wide::stage_slab;
using exo::wide::store_slab;
using exo::wide::zero;
using tcb::kLog2e;

constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kNS = 2;               // slabs of a pair
constexpr int kPart = 8 * kThreads;  // float4s of one partial tile

// The pairs a CTA owns at head size D: one up to D 1024, above it the
// fewest that keep the cluster within kMaxCluster CTAs.
__host__ __device__ inline int cta_pairs(int D) {
  const int slabs = (D + kDS - 1) / kDS;
  return (slabs + kNS * kMaxCluster - 1) / (kNS * kMaxCluster);
}
// The cluster's CTAs: as few as hold every slab at cta_pairs(D) pairs each.
inline int cluster_ctas(int D) {
  const int slabs = (D + kDS - 1) / kDS, per = kNS * cta_pairs(D);
  return (slabs + per - 1) / per;
}
// The first column of pair p of rank r, at np pairs a CTA.
__device__ __forceinline__ int pair_col(int r, int np, int p) { return (r * np + p) * kNS * kDS; }

// This thread's 16 x 64 fragments (a warp's rows, s[nt] = n-tile nt) into a
// partial tile laid out [n-tile][thread] in float4s: a warp reads or writes
// 512 consecutive bytes.
__device__ __forceinline__ void put_part(float4* part, const float (&s)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    part[nt * kThreads + threadIdx.x] = make_float4(s[nt][0], s[nt][1], s[nt][2], s[nt][3]);
}

// The halves of a cluster barrier: arrive (release this thread's writes and
// reads of shared memory) and wait for every thread of the cluster to have
// arrived (acquire theirs). cluster.sync() is the two in a row.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// s[m] = the cluster's partials of tile m (M tiles: s, or s and dp) summed
// in rank order 0, 1, ..., nr - 1, in place, through buf (M partial tiles of
// this CTA's shared memory); j: the walk's step. Each CTA writes its
// partials, and after the barrier sums every rank's, read through
// distributed shared memory, in its own registers: the same additions in the
// same order in every CTA, so the same bits. It then arrives on a barrier
// that it waits for before writing the next step's partials, so that no
// peer still reads them (by then every peer has long arrived: the wait
// costs little where a second full barrier would not). finish_exchange()
// before the kernel ends. Called by every thread of every CTA.
template <int M>
__device__ __forceinline__ void exchange(float (&s)[M][8][4], cg::cluster_group& cluster,
                                         float4* buf, int j, int nr) {
  if (j > 0) cluster_wait();  // every peer has read step j - 1's partials
#pragma unroll
  for (int m = 0; m < M; ++m) put_part(buf + m * kPart, s[m]);
  cluster.sync();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    for (int r = 0; r < nr; ++r) {
      const float4* p = cluster.map_shared_rank(buf + m * kPart, r);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float4 x = p[nt * kThreads + threadIdx.x];
        if (r == 0) {
          s[m][nt][0] = x.x;
          s[m][nt][1] = x.y;
          s[m][nt][2] = x.z;
          s[m][nt][3] = x.w;
        } else {
          s[m][nt][0] += x.x;
          s[m][nt][1] += x.y;
          s[m][nt][2] += x.z;
          s[m][nt][3] += x.w;
        }
      }
    }
  }
  cluster_arrive();
}

// Before a CTA leaves: every peer is done reading its partials (the wait of
// the last step's arrive).
__device__ __forceinline__ void finish_exchange() { cluster_wait(); }

// Shared memory: `tiles` slab tiles of T, `words` 4-byte words, `parts`
// partial tiles (the exchange's buffer, last).
template <typename T>
constexpr size_t smem_bytes(int tiles, int words, int parts) {
  return sizeof(T) * size_t(tiles) * kT * Pitch<T>::P + 4 * size_t(words) +
         sizeof(float4) * size_t(parts) * kPart;
}

// Stage the kNS slabs of a pair (first column d0) of rows 0.. (nrows valid)
// of a (., D) matrix into kNS consecutive slab tiles.
template <typename T>
__device__ __forceinline__ void stage_own(T* dst, const T* src, int nrows, int d0, int D) {
#pragma unroll
  for (int i = 0; i < kNS; ++i)
    stage_slab(dst + i * kT * Pitch<T>::P, src, D, kT, nrows, d0 + i * kDS, D);
}

// One load of the walk's buffers: every warp done with the pass's last load
// (`after` says there was one; it is set here), then this one staged (the
// owned tiles with the pass's first, already issued).
template <typename Load>
__device__ __forceinline__ void walk_step(bool& after, Load load) {
  if (after) __syncthreads();
  after = true;
  load();
  exo::tc::cp_async_commit();
  exo::tc::cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------- forward
template <typename T, bool kMulti>
__global__ void __launch_bounds__(kThreads)
flash_fwd_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ kpad, T* __restrict__ o,
                         float* __restrict__ lse, int H, int Sq, int Sk, int D) {
  constexpr int P = Pitch<T>::P, TE = kT * P;
  extern __shared__ __align__(16) unsigned char smem_cl[];
  T* qs = reinterpret_cast<T*>(smem_cl);  // [kNS][TE]: q's slabs of the pass pair
  T* ks = qs + kNS * TE;                   // [kNS][TE]: k's slabs of the step
  T* vs = ks + kNS * TE;                   // [kNS][TE]: v's
  int* valid = reinterpret_cast<int*>(vs + kNS * TE);      // [kT]
  float4* buf = reinterpret_cast<float4*>(valid + kT);    // the exchange's
  cg::cluster_group cluster = cg::this_cluster();
  const int nr = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int np = kMulti ? cta_pairs(D) : 1, bh = blockIdx.y, q0 = blockIdx.x * kT;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = 2 * (lane % 4);
  q += (size_t(bh) * Sq + q0) * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  const int* pad = kpad + size_t(bh / H) * Sk;
  const int nk = (Sk + kT - 1) / kT;
  int x = 0;  // the exchanges so far
  for (int pp = 0; pp < np; ++pp) {
    const int d0 = pair_col(rank, np, pp);
    if (pp > 0) __syncthreads();  // every warp done with the last pass's tiles
    stage_own<T>(qs, q, Sq - q0, d0, D);
    bool after = false;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[kNS][kDS / 8][4];
#pragma unroll
    for (int i = 0; i < kNS; ++i) zero(acc[i]);
    for (int j = 0; j < nk; ++j) {
      const int k0 = j * kT;
      float s[1][8][4];
      zero(s[0]);
      // the partial scores over the CTA's other pairs (np > 1), staged
      // through the step's buffers: q's slabs into ks, k's into vs
      for (int po = 0; po < np; ++po) {
        if (po == pp) continue;
        const int d1 = pair_col(rank, np, po);
        walk_step(after, [&] {
          stage_own<T>(ks, q, Sq - q0, d1, D);
          stage_own<T>(vs, k + size_t(k0) * D, Sk - k0, d1, D);
        });
#pragma unroll
        for (int i = 0; i < kNS; ++i)
          slab_qk<8>(s[0], ks + i * TE + 16 * w * P, vs + i * TE, 8, D - d1 - i * kDS, lane);
      }
      walk_step(after, [&] {
        stage_own<T>(ks, k + size_t(k0) * D, Sk - k0, d0, D);
        stage_own<T>(vs, v + size_t(k0) * D, Sk - k0, d0, D);
      });
      if (threadIdx.x < kT) {
        const int t = k0 + threadIdx.x;
        valid[threadIdx.x] = t < Sk && pad[t] == 0;
      }
      // the partial scores over the pass pair, then the cluster's sum
#pragma unroll
      for (int i = 0; i < kNS; ++i)
        slab_qk<8>(s[0], qs + i * TE + 16 * w * P, ks + i * TE, 8, D - d0 - i * kDS, lane);
      exchange<1>(s, cluster, buf, x++, nr);
      // online softmax on the fragments, as the fixed-tile forwards
      float mt[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (!valid[nt * 8 + c + e]) {
            s[0][nt][e] = -INFINITY;
            s[0][nt][2 + e] = -INFINITY;
          }
          mt[0] = fmaxf(mt[0], s[0][nt][e]);
          mt[1] = fmaxf(mt[1], s[0][nt][2 + e]);
        }
      float alpha[2], ml[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], tcb::quad_max(mt[r]));
        alpha[r] = exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        ml[r] = m_new * kLog2e;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[0][nt][e], kLog2e, -ml[e / 2]));
          s[0][nt][e] = p;
          rs[e / 2] += p;  // l sums the unrounded p
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + rs[r];
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
#pragma unroll
        for (int nt = 0; nt < kDS / 8; ++nt) {
          acc[i][nt][0] *= alpha[0];
          acc[i][nt][1] *= alpha[0];
          acc[i][nt][2] *= alpha[1];
          acc[i][nt][3] *= alpha[1];
        }
        // o += p . v (bf16: p rounded, TPU :157)
        slab_pv<8, false>(acc[i], s[0], l, vs + i * TE, 8, lane);
      }
    }
    float lm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = tcb::quad_sum(l[r]);
      lm[r] = fmaxf(l[r], kTiny);
      const int row = q0 + 16 * w + lane / 4 + 8 * r;
      if (pp == 0 && rank == 0 && lane % 4 == 0 && row < Sq)
        lse[size_t(bh) * Sq + row] = l[r] > 0.f ? m[r] + logf(lm[r]) : -kNegInf;
    }
    // o = acc / l (an empty row: 0 / 1e-30 = 0)
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const int n0 = d0 + i * kDS;
      if (n0 < D)
        store_slab(acc[i], lm, o + (size_t(bh) * Sq + q0 + 16 * w) * D + n0, D,
                   Sq - q0 - 16 * w, D - n0, lane);
    }
  }
  finish_exchange();
}

// ---------------------------------------------------------------- dq
template <typename T, bool kMulti>
__global__ void __launch_bounds__(kThreads)
flash_dq_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const int* __restrict__ kpad, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, int H, int Sq, int Sk, int D) {
  constexpr int P = Pitch<T>::P, TE = kT * P;
  extern __shared__ __align__(16) unsigned char smem_cl[];
  T* qs = reinterpret_cast<T*>(smem_cl);  // [kNS][TE]: q's slabs of the pass pair
  T* dos = qs + kNS * TE;                  // [kNS][TE]: do's
  T* ks = dos + kNS * TE;                  // [kNS][TE]: k's slabs of the step
  T* vs = ks + kNS * TE;                   // [kNS][TE]: v's
  int* valid = reinterpret_cast<int*>(vs + kNS * TE);      // [kT]
  float4* buf = reinterpret_cast<float4*>(valid + kT);    // the exchange's (s, dp)
  cg::cluster_group cluster = cg::this_cluster();
  const int nr = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int np = kMulti ? cta_pairs(D) : 1, bh = blockIdx.y, q0 = blockIdx.x * kT;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = 2 * (lane % 4);
  q += (size_t(bh) * Sq + q0) * D;
  dout += (size_t(bh) * Sq + q0) * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  const int* pad = kpad + size_t(bh / H) * Sk;
  float lse_l[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * w + lane / 4 + 8 * r;
    lse_l[r] = row < Sq ? lse[size_t(bh) * Sq + row] * kLog2e : 0.f;
    delta_r[r] = row < Sq ? delta[size_t(bh) * Sq + row] : 0.f;
  }
  const float one[2] = {1.f, 1.f};
  const int nk = (Sk + kT - 1) / kT;
  int x = 0;  // the exchanges so far
  for (int pp = 0; pp < np; ++pp) {
    const int d0 = pair_col(rank, np, pp);
    if (pp > 0) __syncthreads();  // every warp done with the last pass's tiles
    stage_own<T>(qs, q, Sq - q0, d0, D);
    stage_own<T>(dos, dout, Sq - q0, d0, D);
    bool after = false;
    float acc[kNS][kDS / 8][4];
#pragma unroll
    for (int i = 0; i < kNS; ++i) zero(acc[i]);
    for (int j = 0; j < nk; ++j) {
      const int k0 = j * kT;
      float sd[2][8][4];
      zero(sd[0]);
      zero(sd[1]);
      // partial s and dp over the CTA's other pairs (np > 1), staged through
      // the step's buffers: q's and k's slabs, then do's and v's
      for (int po = 0; po < np; ++po) {
        if (po == pp) continue;
        const int d1 = pair_col(rank, np, po);
        walk_step(after, [&] {
          stage_own<T>(ks, q, Sq - q0, d1, D);
          stage_own<T>(vs, k + size_t(k0) * D, Sk - k0, d1, D);
        });
#pragma unroll
        for (int i = 0; i < kNS; ++i)
          slab_qk<8>(sd[0], ks + i * TE + 16 * w * P, vs + i * TE, 8, D - d1 - i * kDS, lane);
        walk_step(after, [&] {
          stage_own<T>(ks, dout, Sq - q0, d1, D);
          stage_own<T>(vs, v + size_t(k0) * D, Sk - k0, d1, D);
        });
#pragma unroll
        for (int i = 0; i < kNS; ++i)
          slab_qk<8>(sd[1], ks + i * TE + 16 * w * P, vs + i * TE, 8, D - d1 - i * kDS, lane);
      }
      walk_step(after, [&] {
        stage_own<T>(ks, k + size_t(k0) * D, Sk - k0, d0, D);
        stage_own<T>(vs, v + size_t(k0) * D, Sk - k0, d0, D);
      });
      if (threadIdx.x < kT) {
        const int t = k0 + threadIdx.x;
        valid[threadIdx.x] = t < Sk && pad[t] == 0;
      }
      // partial s = q . k^T and dp = do . v^T over the pass pair, then the sums
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        slab_qk<8>(sd[0], qs + i * TE + 16 * w * P, ks + i * TE, 8, D - d0 - i * kDS, lane);
        slab_qk<8>(sd[1], dos + i * TE + 16 * w * P, vs + i * TE, 8, D - d0 - i * kDS, lane);
      }
      exchange<2>(sd, cluster, buf, x++, nr);
      // ds = p (dp - delta), p = exp(s - lse) at valid keys (TPU :189)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = valid[nt * 8 + c + (e & 1)] != 0;
          const float p = ok ? exp2f(fmaf(sd[0][nt][e], kLog2e, -lse_l[e / 2])) : 0.f;
          sd[0][nt][e] = p * (sd[1][nt][e] - delta_r[e / 2]);
        }
      // dq += ds . k over the pass pair (bf16: ds rounded, TPU :198)
#pragma unroll
      for (int i = 0; i < kNS; ++i) slab_pv<8, false>(acc[i], sd[0], one, ks + i * TE, 8, lane);
    }
#pragma unroll
    for (int i = 0; i < kNS; ++i) {
      const int n0 = d0 + i * kDS;
      if (n0 < D)
        store_slab(acc[i], one, dq + (size_t(bh) * Sq + q0 + 16 * w) * D + n0, D,
                   Sq - q0 - 16 * w, D - n0, lane);
    }
  }
  finish_exchange();
}

// ---------------------------------------------------------------- dk/dv
template <typename T, bool kMulti>
__global__ void __launch_bounds__(kThreads)
flash_dkv_cluster_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ kpad,
                         const T* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                         int H, int Sq, int Sk, int D) {
  constexpr int P = Pitch<T>::P, TE = kT * P;
  extern __shared__ __align__(16) unsigned char smem_cl[];
  T* ks = reinterpret_cast<T*>(smem_cl);  // [kNS][TE]: k's slabs of the pass pair
  T* vs = ks + kNS * TE;                   // [kNS][TE]: v's
  T* qs = vs + kNS * TE;                   // [kNS][TE]: q's slabs of the step
  T* dos = qs + kNS * TE;                  // [kNS][TE]: do's
  float* lse_s = reinterpret_cast<float*>(dos + kNS * TE);  // [kT], times log2(e)
  float* delta_s = lse_s + kT;                             // [kT]
  float4* buf = reinterpret_cast<float4*>(delta_s + kT);   // the exchange's (s^T, dp^T)
  cg::cluster_group cluster = cg::this_cluster();
  const int nr = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int np = kMulti ? cta_pairs(D) : 1, bh = blockIdx.y, k0 = blockIdx.x * kT;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, c = 2 * (lane % 4);
  q += size_t(bh) * Sq * D;
  dout += size_t(bh) * Sq * D;
  k += (size_t(bh) * Sk + k0) * D;
  v += (size_t(bh) * Sk + k0) * D;
  lse += size_t(bh) * Sq;
  delta += size_t(bh) * Sq;
  const int* pad = kpad + size_t(bh / H) * Sk;
  bool kv_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * w + lane / 4 + 8 * r;
    kv_ok[r] = key < Sk && pad[key] == 0;
  }
  const float one[2] = {1.f, 1.f};
  const int nq = (Sq + kT - 1) / kT;
  int x = 0;  // the exchanges so far
  for (int pp = 0; pp < np; ++pp) {
    const int d0 = pair_col(rank, np, pp);
    if (pp > 0) __syncthreads();  // every warp done with the last pass's tiles
    stage_own<T>(ks, k, Sk - k0, d0, D);
    stage_own<T>(vs, v, Sk - k0, d0, D);
    bool after = false;
    float dk_acc[kNS][kDS / 8][4], dv_acc[kNS][kDS / 8][4];
#pragma unroll
    for (int sl = 0; sl < kNS; ++sl) {
      zero(dk_acc[sl]);
      zero(dv_acc[sl]);
    }
    for (int i = 0; i < nq; ++i) {
      const int q0 = i * kT;
      float sd[2][8][4];
      zero(sd[0]);
      zero(sd[1]);
      // partial s^T and dp^T over the CTA's other pairs (np > 1), staged
      // through the step's buffers: k's and q's slabs, then v's and do's
      for (int po = 0; po < np; ++po) {
        if (po == pp) continue;
        const int d1 = pair_col(rank, np, po);
        walk_step(after, [&] {
          stage_own<T>(qs, k, Sk - k0, d1, D);
          stage_own<T>(dos, q + size_t(q0) * D, Sq - q0, d1, D);
        });
#pragma unroll
        for (int sl = 0; sl < kNS; ++sl)
          slab_qk<8>(sd[0], qs + sl * TE + 16 * w * P, dos + sl * TE, 8, D - d1 - sl * kDS, lane);
        walk_step(after, [&] {
          stage_own<T>(qs, v, Sk - k0, d1, D);
          stage_own<T>(dos, dout + size_t(q0) * D, Sq - q0, d1, D);
        });
#pragma unroll
        for (int sl = 0; sl < kNS; ++sl)
          slab_qk<8>(sd[1], qs + sl * TE + 16 * w * P, dos + sl * TE, 8, D - d1 - sl * kDS, lane);
      }
      walk_step(after, [&] {
        stage_own<T>(qs, q + size_t(q0) * D, Sq - q0, d0, D);
        stage_own<T>(dos, dout + size_t(q0) * D, Sq - q0, d0, D);
      });
      if (threadIdx.x < kT) {
        const int t = q0 + threadIdx.x;
        lse_s[threadIdx.x] = t < Sq ? lse[t] * kLog2e : 0.f;
        delta_s[threadIdx.x] = t < Sq ? delta[t] : 0.f;
      }
      // partial s^T = k . q^T and dp^T = v . do^T over the pass pair, then the sums
#pragma unroll
      for (int sl = 0; sl < kNS; ++sl) {
        slab_qk<8>(sd[0], ks + sl * TE + 16 * w * P, qs + sl * TE, 8, D - d0 - sl * kDS, lane);
        slab_qk<8>(sd[1], vs + sl * TE + 16 * w * P, dos + sl * TE, 8, D - d0 - sl * kDS, lane);
      }
      exchange<2>(sd, cluster, buf, x++, nr);
      // p^T = exp(s^T - lse) at valid keys and queries (TPU :226); ds^T = p^T
      // (dp^T - delta) from the unrounded p
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + c + (e & 1);
          const bool ok = kv_ok[e / 2] && q0 + col < Sq;
          const float p = ok ? exp2f(fmaf(sd[0][nt][e], kLog2e, -lse_s[col])) : 0.f;
          sd[0][nt][e] = p;
          sd[1][nt][e] = p * (sd[1][nt][e] - delta_s[col]);
        }
      // dv += p^T . do (bf16: p^T rounded); dk += ds^T . q (bf16: rounded, :239)
#pragma unroll
      for (int sl = 0; sl < kNS; ++sl) {
        slab_pv<8, false>(dv_acc[sl], sd[0], one, dos + sl * TE, 8, lane);
        slab_pv<8, false>(dk_acc[sl], sd[1], one, qs + sl * TE, 8, lane);
      }
    }
    const size_t row0 = size_t(bh) * Sk + k0 + 16 * w;
#pragma unroll
    for (int sl = 0; sl < kNS; ++sl) {
      const int n0 = d0 + sl * kDS;
      if (n0 < D) {
        store_slab(dk_acc[sl], one, dk + row0 * D + n0, D, Sk - k0 - 16 * w, D - n0, lane);
        store_slab(dv_acc[sl], one, dv + row0 * D + n0, D, Sk - k0 - 16 * w, D - n0, lane);
      }
    }
  }
  finish_exchange();
}

}  // namespace cl

// ---------------------------------------------------------------- launch
struct Shape {
  int BH, H, Sq, Sk, D;
};

// The three bodies of one type at head tile DP, and the elements of one of
// their 64-row shared tiles.
template <typename T, int DP> struct Bodies;
template <int DP> struct Bodies<float, DP> {
  static constexpr int ELEMS = tf::Tf32Tile<DP>::ELEMS;
  static auto fwd() { return tf::flash_fwd_tf32_kernel<DP>; }
  static auto dq() { return tf::flash_dq_tf32_kernel<DP>; }
  static auto dkv() { return tf::flash_dkv_tf32_kernel<DP>; }
};
template <int DP> struct Bodies<tcb::bf16, DP> {
  static constexpr int ELEMS = tcb::TcTile<DP>::ELEMS;
  static auto fwd() { return tcb::flash_fwd_bf16_kernel<DP>; }
  static auto dq() { return tcb::flash_dq_bf16_kernel<DP>; }
  static auto dkv() { return tcb::flash_dkv_bf16_kernel<DP>; }
};

// Shared memory of a body: `tiles` 64-row tiles and `words` 4-byte words.
template <typename T, int DP>
constexpr size_t smem_bytes(int tiles, int words) {
  return sizeof(T) * size_t(tiles) * Bodies<T, DP>::ELEMS + 4 * size_t(words);
}

// The forward: q and the ring of k and v tiles, the ring's validity.
template <typename T, int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* kpad, void* o, void* lse,
                Shape sh, cudaStream_t st) {
  auto kernel = Bodies<T, DP>::fwd();
  constexpr size_t bytes = smem_bytes<T, DP>(5, 2 * kT);
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sh.Sq + kT - 1) / kT, sh.BH), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kpad), static_cast<T*>(o), static_cast<float*>(lse), sh.H, sh.Sq,
      sh.Sk, sh.D);
  return cudaGetLastError();
}

// dq: q and do, the ring of k and v tiles, the ring's validity.
template <typename T, int DP>
cudaError_t dq(const void* q, const void* k, const void* v, const void* kpad, const void* dout,
               const void* lse, const void* delta, void* dq_out, Shape sh, cudaStream_t st) {
  auto kernel = Bodies<T, DP>::dq();
  constexpr size_t bytes = smem_bytes<T, DP>(6, 2 * kT);
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sh.Sq + kT - 1) / kT, sh.BH), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kpad), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq_out), sh.H, sh.Sq, sh.Sk, sh.D);
  return cudaGetLastError();
}

// dk/dv: k and v, the ring of q and do tiles, the ring's lse and delta.
template <typename T, int DP>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* kpad, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, Shape sh,
                cudaStream_t st) {
  auto kernel = Bodies<T, DP>::dkv();
  constexpr size_t bytes = smem_bytes<T, DP>(6, 4 * kT);
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sh.Sk + kT - 1) / kT, sh.BH), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kpad), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), sh.H, sh.Sq, sh.Sk, sh.D);
  return cudaGetLastError();
}

// The cluster bodies (D > 128): grid (row tiles, BH, the CTAs of a
// cluster), launched by cudaLaunchKernelEx with a cluster of (1, 1, CTAs).
// A refused launch (cudaOccupancyMaxActiveClusters gives 0 where no GPC
// holds the cluster at this shared memory) returns its error; nothing
// falls back.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int rows, const Shape& sh, size_t smem,
                           cudaStream_t st, Args... args) {
  cudaError_t err = exo::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int ncta = cl::cluster_ctas(sh.D);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((rows + kT - 1) / kT, sh.BH, ncta);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ncta;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Shared memory: the owned tiles and the step's (forward 3 kNS slab tiles,
// dq and dk/dv 4 kNS), the key flags (lse and delta in dk/dv) and the
// exchange's partial tiles (1 or 2 a product).
template <typename T>
cudaError_t fwd_wide(const void* q, const void* k, const void* v, const void* kpad, void* o,
                     void* lse, Shape sh, cudaStream_t st) {
  const size_t bytes = cl::smem_bytes<T>(3 * cl::kNS, kT, 1);
  auto kernel = cl::cta_pairs(sh.D) > 1 ? cl::flash_fwd_cluster_kernel<T, true>
                                        : cl::flash_fwd_cluster_kernel<T, false>;
  return launch_cluster(kernel, sh.Sq, sh, bytes, st,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), static_cast<const int*>(kpad),
                        static_cast<T*>(o), static_cast<float*>(lse), sh.H, sh.Sq, sh.Sk, sh.D);
}

template <typename T>
cudaError_t dq_wide(const void* q, const void* k, const void* v, const void* kpad,
                    const void* dout, const void* lse, const void* delta, void* dq_out, Shape sh,
                    cudaStream_t st) {
  const size_t bytes = cl::smem_bytes<T>(4 * cl::kNS, kT, 2);
  auto kernel = cl::cta_pairs(sh.D) > 1 ? cl::flash_dq_cluster_kernel<T, true>
                                        : cl::flash_dq_cluster_kernel<T, false>;
  return launch_cluster(kernel, sh.Sq, sh, bytes, st,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), static_cast<const int*>(kpad),
                        static_cast<const T*>(dout), static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<T*>(dq_out), sh.H, sh.Sq,
                        sh.Sk, sh.D);
}

template <typename T>
cudaError_t dkv_wide(const void* q, const void* k, const void* v, const void* kpad,
                     const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                     Shape sh, cudaStream_t st) {
  const size_t bytes = cl::smem_bytes<T>(4 * cl::kNS, 2 * kT, 2);
  auto kernel = cl::cta_pairs(sh.D) > 1 ? cl::flash_dkv_cluster_kernel<T, true>
                                        : cl::flash_dkv_cluster_kernel<T, false>;
  return launch_cluster(kernel, sh.Sk, sh, bytes, st,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), static_cast<const int*>(kpad),
                        static_cast<const T*>(dout), static_cast<const float*>(lse),
                        static_cast<const float*>(delta), static_cast<T*>(dk),
                        static_cast<T*>(dv), sh.H, sh.Sq, sh.Sk, sh.D);
}

// Every body stages q, k, v and do by 16-byte cp.async.
bool aligned(const void* a, const void* b, const void* c, const void* d) {
  return exo::tc::aligned16(a) && exo::tc::aligned16(b) && exo::tc::aligned16(c) &&
         exo::tc::aligned16(d);
}

// D a multiple of 8: up to 128 in the head tile that holds it, above in
// the cluster bodies' slabs.
bool shape_ok(const Shape& sh) {
  return sh.H >= 1 && sh.BH >= 1 && sh.BH % sh.H == 0 && sh.BH <= 65535 && sh.Sq >= 1 &&
         sh.Sk >= 1 && sh.D >= 8 && sh.D % 8 == 0;
}

constexpr int kMaxTileD = 128;  // the largest fixed head tile

int head_tile(int D) { return D <= 32 ? 32 : D <= 48 ? 48 : D <= 64 ? 64 : 128; }

// Returns fn<T, DP>(args...) for the call's type (dtype 0: float32, 1:
// bfloat16) and the head tile DP that holds sh.D, or fn_wide<T>(args...)
// above the largest tile.
#define EXO_FLASH_TILE(fn, T, ...)                        \
  do {                                                    \
    if (sh.D > kMaxTileD) return fn##_wide<T>(__VA_ARGS__); \
    const int tt = head_tile(sh.D);                       \
    if (tt == 32) return fn<T, 32>(__VA_ARGS__);          \
    if (tt == 48) return fn<T, 48>(__VA_ARGS__);          \
    if (tt == 64) return fn<T, 64>(__VA_ARGS__);          \
    return fn<T, 128>(__VA_ARGS__);                       \
  } while (0)
#define EXO_FLASH_DISPATCH(fn, ...)                           \
  do {                                                        \
    if (dtype == 0) EXO_FLASH_TILE(fn, float, __VA_ARGS__);     \
    if (dtype == 1) EXO_FLASH_TILE(fn, tcb::bf16, __VA_ARGS__); \
    return cudaErrorInvalidValue;                             \
  } while (0)

}  // namespace

// q (BH, Sq, D) pre-scaled, k and v (BH, Sk, D) of one type (dtype 0:
// float32, 1: bfloat16), kpad (BH / H, Sk) int32; writes o (BH, Sq, D) in
// the input type and lse (BH, Sq) float32. All contiguous, q, k and v
// 16-byte aligned. D a multiple of 8. Returns the CUDA error of
// the launch, or 0.
extern "C" int flash_attn_forward(const void* q, const void* k, const void* v, const void* kpad,
                                  void* o, void* lse, int BH, int H, int Sq, int Sk, int D,
                                  int dtype, void* stream) {
  const Shape sh{BH, H, Sq, Sk, D};
  if (!shape_ok(sh)) return cudaErrorInvalidValue;
  if (!aligned(q, k, v, v)) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EXO_FLASH_DISPATCH(fwd, q, k, v, kpad, o, lse, sh, st);
}

// dq (BH, Sq, D) in the input type from the forward's inputs, the upstream
// grad dout (BH, Sq, D, input type, 16-byte aligned), the forward's lse and
// delta = sum_d dout * o (BH, Sq) float32.
extern "C" int flash_attn_dq(const void* q, const void* k, const void* v, const void* kpad,
                             const void* dout, const void* lse, const void* delta, void* dq_out,
                             int BH, int H, int Sq, int Sk, int D, int dtype, void* stream) {
  const Shape sh{BH, H, Sq, Sk, D};
  if (!shape_ok(sh)) return cudaErrorInvalidValue;
  if (!aligned(q, k, v, dout)) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EXO_FLASH_DISPATCH(dq, q, k, v, kpad, dout, lse, delta, dq_out, sh, st);
}

// dk and dv (BH, Sk, D) in the input type, from the same arguments as
// flash_attn_dq.
extern "C" int flash_attn_dkv(const void* q, const void* k, const void* v, const void* kpad,
                              const void* dout, const void* lse, const void* delta, void* dk,
                              void* dv, int BH, int H, int Sq, int Sk, int D, int dtype,
                              void* stream) {
  const Shape sh{BH, H, Sq, Sk, D};
  if (!shape_ok(sh)) return cudaErrorInvalidValue;
  if (!aligned(q, k, v, dout)) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EXO_FLASH_DISPATCH(dkv, q, k, v, kpad, dout, lse, delta, dk, dv, sh, st);
}
