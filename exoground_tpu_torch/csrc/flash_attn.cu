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
// point of ~20 and the bf16 one of ~295). The backward does 7 tile products
// against the forward's 2. Nothing but the tile products' rate matters: the
// tensor cores' for bf16 and, in 3xTF32 (3 x 8.6 GFLOP / 495 TFLOP/s = 0.052
// ms against 8.6 / 67 = 0.128 on the CUDA cores), for f32 too.
//
// Three bodies. The TPU kernel runs a sequential grid (bh, q block, k block)
// with 512 x 1024 blocks and carries m, l and the accumulator in VMEM from
// one key block to the next. Hopper blocks run in parallel and in no order,
// so each CTA owns 64 rows and loops over the other axis itself: the
// forward and dq own 64 query rows and walk the key tiles of 64; dk/dv own
// 64 key rows and walk the query tiles, so there are no atomics and the
// result does not vary from run to run.
//
// float32 dq and dk/dv: the first design, on the CUDA cores. The S x S
// scores stay out of device memory and the FMAs are fed from shared memory.
// 256 threads hold a 64 x 64 score tile as 4 x 4 per thread: thread (ty,
// tx) = (tid / 16, tid % 16) holds rows ty + 16 i and columns tx + 16 j, and
// the same thread owns output columns tx + 16 j of the same rows. Operand
// tiles are staged transposed, [d][row] with a pitch of 65 floats, so every
// product reads shared memory without bank conflicts. Rows past Sq or Sk
// are masked in place: no padding copies. The head size is a template
// constant (32, 40, 64, 128); a smaller D that is a multiple of 8 runs in
// the next tile up with zero-filled columns.
//
// float32 forward (flash_fwd_tf32_kernel): the bf16 forward's design below
// with every product in 3xTF32 (tc.cuh: m16n8k8 .tf32, each operand split
// into a TF32 hi half and the rest; plain TF32 would miss the f32 limit of
// 1e-4 of max|plain|, 3xTF32 keeps float32 accuracy). The tiles stay f32 in
// shared memory at a row pitch of D + 4 floats (4 mod 8: conflict-free
// fragment reads); q's hi/lo fragments stay in registers for the walk at
// head tiles <= 64 (from shared memory at 128, where they would take 128
// registers); p stays f32, as the f32 TPU body keeps it, and goes from the
// score C fragments to the A fragments of p . v in registers by reading
// k-column t as key 2t and t + 4 as key 2t + 1 (v's rows read to match).
// Head tiles 32, 48, 64, 128; 87 KB of shared memory at 64, two CTAs an SM.
//
// bfloat16: every tile product on the tensor cores (tc.cuh). The first body
// served bf16 too, on the CUDA cores: it converted every value to f32 as it
// staged it and fed 16 FMAs with 8 shared-memory loads, and reached 2% of the
// card's bf16 rate. The same CTA ownership (64 rows, the other axis walked
// in tiles of 64, no atomics), with 4 warps of 16 rows each:
//   - every product is mma.sync m16n8k16 (bf16 operands, f32 accumulators);
//     operands come from shared memory by ldmatrix, an operand stored
//     k-major (V and dO and Q and K as the right-hand side of p.v, ds.k,
//     p^T.do, ds^T.q) by ldmatrix.trans;
//   - the walked tiles (K and V; Q and dO in dk/dv) arrive by 16-byte
//     cp.async into a two-stage ring: tile j + 1 loads while tile j is
//     used. Tiles keep bf16 in shared memory with a row pitch of D + 8
//     elements, so the 8 rows an ldmatrix reads fall in distinct banks;
//   - s (and dp) stay in the product's f32 accumulator fragments; the
//     online max and sum run on them with quad shuffles, and p (ds) is
//     rounded to bf16 and repacked from the C fragments into the A fragments
//     of the next product in registers, with no shared-memory round trip.
//     The forward keeps q's fragments in registers for the whole walk.
//   - rows past Sq or Sk are zero-filled by cp.async and masked; head sizes
//     that are multiples of 8 up to 128 run in a tile of 32, 48, 64 or 128
//     columns with the rest zero-filled. 128 threads and 26-104 KB of shared
//     memory a CTA, so three or four CTAs share an SM at D <= 64.
// The tensor-core bodies (the forward in both types, dq and dk/dv in bf16)
// need q, k, v (and do) 16-byte aligned (cp.async); the entry points return
// cudaErrorMisalignedAddress otherwise.
//
// Rounding follows the TPU kernel for bf16 inputs: p is rounded to v's type
// before p . v (:157), ds to k's type before ds . k (:198) and to q's type
// before ds^T . q (:239). Products of bf16 values are exact in f32, so s, dp
// and the products round where the TPU bodies do. The f32 body runs p^T . do
// on the unrounded f32 p (:229); the bf16 body's tensor cores take p rounded
// to bf16 there, one more rounding of ~2^-9 per element, inside the bf16
// limit of 1e-2 of max|plain|. flash_attention_plain keeps the TPU order.
// In f32 nothing is rounded between products, in any body.
#include <cstddef>
#include <math.h>

#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int kT = 64;         // rows per tile, both axes
constexpr int kP = kT + 1;     // pitch of the shared tiles
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr float kNegInf = -1e30f;  // the TPU kernel's finite NEG_INF
constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

// Columns per thread of a D-wide output tile, and the tile's padded width.
template <int DT> struct Cols {
  static constexpr int NJ = (DT + 15) / 16;
  static constexpr int DP = 16 * NJ;
};

// Rows r0.. r0 + 63 of an (S, D) operand into dst[d * kP + r] as f32; rows
// past S and columns past D read 0 (DP >= D columns are written).
template <typename T, int DP>
__device__ __forceinline__ void load_t(const T* __restrict__ src, int S, int D, int r0,
                                       float* dst) {
  for (int e = threadIdx.x; e < kT * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    float x = 0.f;
    if (r0 + r < S && d < D) x = exo::to_f(src[size_t(r0 + r) * D + d]);
    dst[d * kP + r] = x;
  }
}

// acc[i][j] = sum_d a[d][ty + 16 i] * b[d][tx + 16 j]: a 64 x 64 tile of
// rows of a times rows of b, from two transposed tiles.
template <int DP>
__device__ __forceinline__ void rows_dot(const float* a, const float* b, float (&acc)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[d * kP + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[d * kP + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c w[ty + 16 i][c] * b[tx + 16 j][c]: a (64 x 64) tile w
// (row-major, pitch kP) times the 64 rows of a transposed operand tile b.
template <int NJ>
__device__ __forceinline__ void tile_times(const float* w, const float* b,
                                           float (&acc)[4][NJ]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int c = 0; c < kT; ++c) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = w[(ty + 16 * i) * kP + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float y = b[(tx + 16 * j) * kP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(x[i], y, acc[i][j]);
    }
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return exo::to_f(exo::from_f<T>(x));
}

// Store rows r0 + ty + 16 i (< S), columns tx + 16 j (< D) of acc.
template <typename T, int NJ>
__device__ __forceinline__ void store_rows(const float (&acc)[4][NJ], T* __restrict__ dst,
                                           int S, int D, int r0) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dst[size_t(r) * D + c] = exo::from_f<T>(acc[i][j]);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[4][NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// ---------------------------------------------------------------- dq
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const int* __restrict__ kpad, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int H, int Sq, int Sk, int D) {
  constexpr int NJ = Cols<DT>::NJ, DP = Cols<DT>::DP;
  extern __shared__ float smem[];
  float* qt = smem;           // [DP][kP]
  float* dot = qt + DP * kP;  // [DP][kP]
  float* kt = dot + DP * kP;  // [DP][kP]
  float* vt = kt + DP * kP;   // [DP][kP]
  float* dss = vt + DP * kP;  // [kT][kP]
  __shared__ int valid[kT];
  const int bh = blockIdx.y, q0 = blockIdx.x * kT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  q += size_t(bh) * Sq * D;
  dout += size_t(bh) * Sq * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  const int* pad = kpad + size_t(bh / H) * Sk;

  load_t<T, DP>(q, Sq, D, q0, qt);
  load_t<T, DP>(dout, Sq, D, q0, dot);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < Sq ? lse[size_t(bh) * Sq + r] : 0.f;
    delta_r[i] = r < Sq ? delta[size_t(bh) * Sq + r] : 0.f;
  }
  float acc[4][NJ];
  zero<NJ>(acc);
  for (int k0 = 0; k0 < Sk; k0 += kT) {
    __syncthreads();
    load_t<T, DP>(k, Sk, D, k0, kt);
    load_t<T, DP>(v, Sk, D, k0, vt);
    if (tid < kT) valid[tid] = k0 + tid < Sk && pad[k0 + tid] == 0;
    __syncthreads();
    float s[4][4], dp[4][4];
    rows_dot<DP>(qt, kt, s);
    rows_dot<DP>(dot, vt, dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = valid[tx + 16 * j] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ok ? expf(s[i][j] - lse_r[i]) : 0.f;
        dss[(ty + 16 * i) * kP + tx + 16 * j] = round_to<T>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncthreads();
    tile_times<NJ>(dss, kt, acc);
  }
  store_rows<T, NJ>(acc, dq + size_t(bh) * Sq * D, Sq, D, q0);
}

// ---------------------------------------------------------------- dk/dv
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kpad, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Sk, int D) {
  constexpr int NJ = Cols<DT>::NJ, DP = Cols<DT>::DP;
  extern __shared__ float smem[];
  float* kt = smem;           // [DP][kP], this CTA's keys
  float* vt = kt + DP * kP;   // [DP][kP]
  float* qt = vt + DP * kP;   // [DP][kP], the current query tile
  float* dot = qt + DP * kP;  // [DP][kP]
  float* pts = dot + DP * kP; // [kT][kP]: p^T, then ds^T
  __shared__ float lse_s[kT], delta_s[kT];
  const int bh = blockIdx.y, k0 = blockIdx.x * kT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  q += size_t(bh) * Sq * D;
  dout += size_t(bh) * Sq * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  const int* pad = kpad + size_t(bh / H) * Sk;

  load_t<T, DP>(k, Sk, D, k0, kt);
  load_t<T, DP>(v, Sk, D, k0, vt);
  bool kv_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    kv_ok[i] = r < Sk && pad[r] == 0;
  }
  float dk_acc[4][NJ], dv_acc[4][NJ];
  zero<NJ>(dk_acc);
  zero<NJ>(dv_acc);
  for (int q0 = 0; q0 < Sq; q0 += kT) {
    __syncthreads();
    load_t<T, DP>(q, Sq, D, q0, qt);
    load_t<T, DP>(dout, Sq, D, q0, dot);
    if (tid < kT) {
      const bool in = q0 + tid < Sq;
      lse_s[tid] = in ? lse[size_t(bh) * Sq + q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[size_t(bh) * Sq + q0 + tid] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    rows_dot<DP>(kt, qt, s);    // s^T: keys x queries
    rows_dot<DP>(vt, dot, dp);  // dp^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool q_in = q0 + c < Sq;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = (kv_ok[i] && q_in) ? expf(s[i][j] - lse_s[c]) : 0.f;
        pts[(ty + 16 * i) * kP + c] = p;
        dp[i][j] = p * (dp[i][j] - delta_s[c]);  // ds^T
      }
    }
    __syncthreads();
    tile_times<NJ>(pts, dot, dv_acc);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) pts[(ty + 16 * i) * kP + tx + 16 * j] = round_to<T>(dp[i][j]);
    __syncthreads();
    tile_times<NJ>(pts, qt, dk_acc);
  }
  store_rows<T, NJ>(dk_acc, dk + size_t(bh) * Sk * D, Sk, D, k0);
  store_rows<T, NJ>(dv_acc, dv + size_t(bh) * Sk * D, Sk, D, k0);
}

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

constexpr int kWarps = 4;               // 16 rows each
constexpr int kThreadsTc = 32 * kWarps;
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
  exo::tc::cp_tile<kT, DP, kThreadsTc>(ks + stage * L::ELEMS, L::P, k, D, k0, Sk, 0, D);
  exo::tc::cp_tile<kT, DP, kThreadsTc>(vs + stage * L::ELEMS, L::P, v, D, k0, Sk, 0, D);
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
__global__ void __launch_bounds__(kThreadsTc, DP <= 64 ? 4 : 1)
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

  exo::tc::cp_tile<kT, DP, kThreadsTc>(qs, L::P, q, D, q0, Sq, 0, D);
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
__global__ void __launch_bounds__(kThreadsTc)
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

  exo::tc::cp_tile<kT, DP, kThreadsTc>(qs, L::P, q, D, q0, Sq, 0, D);
  exo::tc::cp_tile<kT, DP, kThreadsTc>(dos, L::P, dout, D, q0, Sq, 0, D);
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
__global__ void __launch_bounds__(kThreadsTc)
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
    exo::tc::cp_tile<kT, DP, kThreadsTc>(qs + stage * L::ELEMS, L::P, q, D, q0, Sq, 0, D);
    exo::tc::cp_tile<kT, DP, kThreadsTc>(dos + stage * L::ELEMS, L::P, dout, D, q0, Sq, 0, D);
    if (threadIdx.x < kT) {
      const int i = q0 + threadIdx.x;
      lse_s[stage * kT + threadIdx.x] = i < Sq ? lse[i] * kLog2e : 0.f;
      delta_s[stage * kT + threadIdx.x] = i < Sq ? delta[i] : 0.f;
    }
  };
  exo::tc::cp_tile<kT, DP, kThreadsTc>(ks, L::P, k, D, k0, Sk, 0, D);
  exo::tc::cp_tile<kT, DP, kThreadsTc>(vs, L::P, v, D, k0, Sk, 0, D);
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
#pragma unroll
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

// Shared memory of a bf16 body: `tiles` 64-row tiles and `words` 4-byte words.
template <int DP>
constexpr size_t tc_bytes(int tiles, int words) {
  return sizeof(bf16) * size_t(tiles) * TcTile<DP>::ELEMS + 4 * size_t(words);
}

// The bf16 tile that holds D columns (a multiple of 8, <= 128).
int tc_head_tile(int D) { return D <= 32 ? 32 : D <= 48 ? 48 : D <= 64 ? 64 : 128; }

}  // namespace tcb

// ==================================================== float32: 3xTF32 forward
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

constexpr int kThreadsTf = 128;  // 4 warps of 16 query rows

// A 64-row f32 tile of DP columns (the head tile, zeros past D) at a row
// pitch of DP + 4 floats: 4 (mod 8), so the A and B fragment reads of q and
// k (row g, column t) and the k-major B reads of v (rows 2t, 2t + 1, column
// g) each touch 32 distinct banks. QREG: q's hi/lo fragments stay in
// registers for the whole walk (64 registers at DP 64); at DP 128 they
// would take 128, so q is read from shared memory each k-step there.
template <int DP>
struct Tf32Tile {
  static constexpr int P = DP + 4;
  static constexpr int ELEMS = kT * P;
  static constexpr int KS = DP / 8;  // k-steps over the head (m16n8k8)
  static constexpr int NT = DP / 8;  // n-tiles over the head
  static constexpr bool QREG = DP <= 64;
  static constexpr size_t bytes = sizeof(float) * 5 * ELEMS + sizeof(int) * 2 * kT;
};

// K and V rows k0.. (tile `stage` of the ring) and their validity.
template <int DP>
__device__ __forceinline__ void load_kv(float* ks, float* vs, int* valid, const float* k,
                                        const float* v, const int* pad, int Sk, int D, int k0,
                                        int stage) {
  using L = Tf32Tile<DP>;
  exo::tc::cp_tile<kT, DP, kThreadsTf>(ks + stage * L::ELEMS, L::P, k, D, k0, Sk, 0, D);
  exo::tc::cp_tile<kT, DP, kThreadsTf>(vs + stage * L::ELEMS, L::P, v, D, k0, Sk, 0, D);
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
__global__ void __launch_bounds__(kThreadsTf, DP <= 64 ? 2 : 1)
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

  exo::tc::cp_tile<kT, DP, kThreadsTf>(qs, L::P, q, D, q0, Sq, 0, D);
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

}  // namespace tf

// ---------------------------------------------------------------- launch
template <int DT>
constexpr size_t smem_bytes(int operand_tiles) {
  return sizeof(float) * size_t(operand_tiles * Cols<DT>::DP + kT) * kP;
}

struct Shape {
  int BH, H, Sq, Sk, D;
};

template <typename T, int DT>
cudaError_t dq(const void* q, const void* k, const void* v, const void* kpad, const void* dout,
               const void* lse, const void* delta, void* dq_out, Shape sh, cudaStream_t st) {
  auto kernel = flash_dq_kernel<T, DT>;
  constexpr size_t bytes = smem_bytes<DT>(4);
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sh.Sq + kT - 1) / kT, sh.BH), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kpad), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq_out), sh.H, sh.Sq, sh.Sk, sh.D);
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* kpad, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, Shape sh,
                cudaStream_t st) {
  auto kernel = flash_dkv_kernel<T, DT>;
  constexpr size_t bytes = smem_bytes<DT>(4);
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sh.Sk + kT - 1) / kT, sh.BH), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kpad), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), sh.H, sh.Sq, sh.Sk, sh.D);
  return cudaGetLastError();
}

// The f32 forward in 3xTF32, DP the head tile.
template <int DP>
cudaError_t fwd_tf32(const void* q, const void* k, const void* v, const void* kpad, void* o,
                     void* lse, Shape sh, cudaStream_t st) {
  auto kernel = tf::flash_fwd_tf32_kernel<DP>;
  constexpr size_t bytes = tf::Tf32Tile<DP>::bytes;
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sh.Sq + kT - 1) / kT, sh.BH), tf::kThreadsTf, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(kpad), static_cast<float*>(o), static_cast<float*>(lse), sh.H,
      sh.Sq, sh.Sk, sh.D);
  return cudaGetLastError();
}

// The bf16 bodies, on the tensor cores: the same arguments, DP the head tile.
template <int DP>
cudaError_t fwd_tc(const void* q, const void* k, const void* v, const void* kpad, void* o,
                   void* lse, Shape sh, cudaStream_t st) {
  using tcb::bf16;
  auto kernel = tcb::flash_fwd_bf16_kernel<DP>;
  constexpr size_t bytes = tcb::tc_bytes<DP>(5, 2 * kT);
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sh.Sq + kT - 1) / kT, sh.BH), tcb::kThreadsTc, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kpad), static_cast<bf16*>(o), static_cast<float*>(lse), sh.H,
      sh.Sq, sh.Sk, sh.D);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dq_tc(const void* q, const void* k, const void* v, const void* kpad,
                  const void* dout, const void* lse, const void* delta, void* dq_out, Shape sh,
                  cudaStream_t st) {
  using tcb::bf16;
  auto kernel = tcb::flash_dq_bf16_kernel<DP>;
  constexpr size_t bytes = tcb::tc_bytes<DP>(6, 2 * kT);
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sh.Sq + kT - 1) / kT, sh.BH), tcb::kThreadsTc, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kpad), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq_out), sh.H, sh.Sq, sh.Sk, sh.D);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkv_tc(const void* q, const void* k, const void* v, const void* kpad,
                   const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                   Shape sh, cudaStream_t st) {
  using tcb::bf16;
  auto kernel = tcb::flash_dkv_bf16_kernel<DP>;
  constexpr size_t bytes = tcb::tc_bytes<DP>(6, 4 * kT);
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sh.Sk + kT - 1) / kT, sh.BH), tcb::kThreadsTc, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(kpad), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sh.H, sh.Sq, sh.Sk, sh.D);
  return cudaGetLastError();
}

// The smallest instantiated head size that holds D (a multiple of 8, <= 128).
int head_tile(int D) {
  if (D < 8 || D > 128 || D % 8) return 0;
  return D <= 32 ? 32 : D <= 40 ? 40 : D <= 64 ? 64 : 128;
}

// The tensor-core bodies stage q, k, v and do by 16-byte cp.async.
bool aligned_tc(const void* a, const void* b, const void* c, const void* d) {
  return exo::tc::aligned16(a) && exo::tc::aligned16(b) && exo::tc::aligned16(c) &&
         exo::tc::aligned16(d);
}

bool shape_ok(const Shape& sh) {
  return sh.H >= 1 && sh.BH >= 1 && sh.BH % sh.H == 0 && sh.BH <= 65535 && sh.Sq >= 1 &&
         sh.Sk >= 1 && head_tile(sh.D) != 0;
}

// Returns fn<DP>(args...) for the tensor-core head tile DP that holds sh.D.
#define EXO_TC_TILE(fn, ...)                        \
  do {                                              \
    const int tt = tcb::tc_head_tile(sh.D);         \
    if (tt == 32) return fn<32>(__VA_ARGS__);       \
    if (tt == 48) return fn<48>(__VA_ARGS__);       \
    if (tt == 64) return fn<64>(__VA_ARGS__);       \
    return fn<128>(__VA_ARGS__);                    \
  } while (0)

// Returns fn<float, DT>(args...), the CUDA-core body, for float32 (dtype 0)
// and fn_tc<DP>(args...), the tensor-core body, for bfloat16 (dtype 1), by
// the call's head tile.
#define EXO_FLASH_DISPATCH(fn, ...)                                   \
  do {                                                                \
    const int dt = head_tile(sh.D);                                   \
    if (dtype == 0) {                                                 \
      if (dt == 32) return fn<float, 32>(__VA_ARGS__);                \
      if (dt == 40) return fn<float, 40>(__VA_ARGS__);                \
      if (dt == 64) return fn<float, 64>(__VA_ARGS__);                \
      return fn<float, 128>(__VA_ARGS__);                             \
    }                                                                 \
    if (dtype == 1) EXO_TC_TILE(fn##_tc, __VA_ARGS__);                \
    return cudaErrorInvalidValue;                                     \
  } while (0)

}  // namespace

// q (BH, Sq, D) pre-scaled, k and v (BH, Sk, D) of one type (dtype 0:
// float32, 1: bfloat16), kpad (BH / H, Sk) int32; writes o (BH, Sq, D) in
// the input type and lse (BH, Sq) float32. All contiguous, q, k and v
// 16-byte aligned. D a multiple of 8 up to 128. Returns the CUDA error of
// the launch, or 0.
extern "C" int flash_attn_forward(const void* q, const void* k, const void* v, const void* kpad,
                                  void* o, void* lse, int BH, int H, int Sq, int Sk, int D,
                                  int dtype, void* stream) {
  const Shape sh{BH, H, Sq, Sk, D};
  if (!shape_ok(sh)) return cudaErrorInvalidValue;
  if (!aligned_tc(q, k, v, v)) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) EXO_TC_TILE(fwd_tf32, q, k, v, kpad, o, lse, sh, st);
  if (dtype == 1) EXO_TC_TILE(fwd_tc, q, k, v, kpad, o, lse, sh, st);
  return cudaErrorInvalidValue;
}

// dq (BH, Sq, D) in the input type from the forward's inputs, the upstream
// grad dout (BH, Sq, D, input type), the forward's lse and delta = sum_d
// dout * o (BH, Sq) float32.
extern "C" int flash_attn_dq(const void* q, const void* k, const void* v, const void* kpad,
                             const void* dout, const void* lse, const void* delta, void* dq_out,
                             int BH, int H, int Sq, int Sk, int D, int dtype, void* stream) {
  const Shape sh{BH, H, Sq, Sk, D};
  if (!shape_ok(sh)) return cudaErrorInvalidValue;
  if (dtype == 1 && !aligned_tc(q, k, v, dout)) return cudaErrorMisalignedAddress;
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
  if (dtype == 1 && !aligned_tc(q, k, v, dout)) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EXO_FLASH_DISPATCH(dkv, q, k, v, kpad, dout, lse, delta, dk, dv, sh, st);
}
