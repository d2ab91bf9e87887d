// MIL-NCE contrastive-grid denominators, forward and backward.
//
// Replaces the TPU kernel exoground_tpu/ops/milnce_grid.py::_grid_lse2:
// forward _grid_lse2_fwd_impl (pallas_call at :184, body _fwd_kernel :59),
// backward _grid_lse2_bwd_rule (pallas_call at :231, body _bwd_kernel :108).
//
// Per stage s the grid is z = v_s . t_s^T * inv_temp over R video rows and
// Cc text columns, invalid columns filled with NEG_FILL = -6e4:
//   v_den[s, r] = logsumexp over columns of z[r, :]
//   t_den[s, c] = logsumexp over rows of z[:, c]   (an all-invalid column
//                 gives NEG_FILL + log R, as the TPU kernel and the plain
//                 composition do)
// Backward, with upstream g_v (S, R) and g_t (S, Cc):
//   dz = (exp(z - v_den) g_v + [c valid] exp(z - t_den) g_t) * inv_temp
//   dv = dz . t,  dt = dz^T . v   (dt summed over stages when St = 1)
// z and dz never reach device memory: every kernel recomputes its z tile,
// and no scratch grows with R x Cc.
//
// What bounds it on an H100: operations. The forward does 2*S*R*Cc*C FLOPs
// against (S*R + St*Cc)*C input values (B64: 19.3 GFLOP per 57 MB in f32,
// ~340 FLOP/byte); the backward three times that (z once, dv, dt). So only
// the tile products' rate matters: the tensor cores', bf16 mma.sync with f32
// sums, and for f32 inputs 3xTF32 (tc.cuh: m16n8k8 .tf32 with hi/lo operand
// splits, float32 accuracy at 3 x FLOPs / 495 TFLOP/s against FLOPs / 67 on
// the CUDA cores).
//
// Design. The grid is flash attention with a head size of C and no p . v in
// the forward. The TPU kernel runs one sequential grid per stage and keeps
// the whole column block and the online column statistics in VMEM across row
// blocks. Hopper blocks run in parallel and in no order, so each CTA (8
// warps) owns 64 fixed rows of one operand and walks 64-row tiles of the
// other; warp (wr, wc) = (w % 4, w / 4) holds the z tile's rows 16 wr.. and
// columns 32 wc.. as m16n8 C fragments. The depth C streams in K chunks by
// 16-byte cp.async with zero-fill past R or Cc (no padding copies). Tiles
// keep their type in shared memory, bf16 rows 16 bytes longer than the data
// (ldmatrix conflict-free), f32 rows at pitches that make each fragment read
// conflict-free (Lay). The scale and NEG_FILL are applied on the fragments,
// and every exp is one exp2 (fexp).
//   forward (grid: 64-row blocks x stages x 2 column splits): the ring (two
//     chunks in flight) carries a chunk of the CTA's v rows and one of the
//     current t column tile. The online row max / sum-exp stays in registers
//     (quad shuffles) and the two column-half warps of a row combine at the
//     end of a split. Per-column (max, sum-exp) over the CTA's real rows:
//     each warp reduces its 16 rows by shuffles and the four row warps
//     combine through shared memory. Both kinds of partials go to scratch
//     ((S, nR, Cc) and (2, S, R)), and grid_lse_reduce_kernel combines them
//     in a fixed order into t_den and v_den.
//   backward, one kernel body for dv (A = the CTA's 64 video rows, walking
//     the text column tiles: flash's dq pass) and dt (A = the CTA's 64 text
//     columns, walking its split of the (stage, row block) work list:
//     flash's dk/dv pass, z^T = t . v^T). A's chunks stream through the
//     ring; the walked tile is staged whole, one panel of up to 512 columns
//     deep, and serves twice: as the B operand of z (n-major, depth C) and
//     of the second product (k-major, depth its 64 rows). bf16 keeps two
//     such tiles, so the next tile loads during this one's second product;
//     f32 has room for one, so the next tile's A chunks load during the
//     product and its own chunks as each half of the product frees their
//     columns. dz is formed on the fragments (bf16 rounded, as the TPU
//     kernel casts it, :144), goes through shared memory once (64 x 64), and
//     every warp multiplies all 64 rows of it by the 16-column blocks w + 8 j
//     of the slab: an output slab of up to 512 columns is 128 f32
//     accumulators a thread, so z is computed once per tile at C 512. The
//     caller picks the slab (ops/milnce_grid.py::bwd_slab). Above 512
//     columns z sums the depth panels in the order that ends with the
//     slab's own, which then stays resident (the others' chunks pass
//     through the ring). dt: each split writes an f32 partial, and a last pass sums the
//     splits in a fixed order. No atomics: dv and dt are the same bytes from
//     run to run.
// Staged operands (v3, t3) need 16-byte alignment (the entry points return
// cudaErrorMisalignedAddress); the per-row and per-column values (cvalid,
// v_den, t_den, g_v, g_t) are read value by value at any offset.
#include <cstddef>
#include <cstdint>
#include <math.h>

#include "common.cuh"
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using exo::tc::a_col;
using exo::tc::a_row;
using exo::tc::b_col;
using exo::tc::b_row;
using exo::tc::cp_async_commit;
using exo::tc::cp_async_wait;
using exo::tc::ldsm_x4;
using exo::tc::ldsm_x4_t;
using exo::tc::mma;
using exo::tc::mma_3xtf32;
using exo::tc::pack_bf16;
using exo::tc::quad_max;
using exo::tc::quad_sum;
using exo::tc::Tf32A;
using exo::tc::Tf32B;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTile = 64;      // rows of a tile of either operand
constexpr int kStages = 3;     // ring stages of the forward: two chunks in flight
constexpr int kColSplits = 2;  // column splits of the forward
constexpr int kPanel = 512;    // depth of the backward's resident tile
constexpr float kNegFill = -6e4f;
constexpr float kNegInf = -1e30f;  // a finite start for running maxima
constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// exp(x) as exp2(x log2 e), one MUFU instruction: the z-tile loops take two
// per element; within ~1e-6 relative of expf at the grid's |x| <= ~60
__device__ __forceinline__ float fexp(float x) { return exp2f(x * kLog2e); }

// Shared-memory layout by type: a row's pad (elements) past its data in the
// backward (PAD) and the forward (FPAD), the pitch of dz, the resident tiles
// of the backward; the K chunk of the forward (KF), of the backward over one
// panel (KB, or KB2 where C is no multiple of KB) and over several (KM).
// f32 pitches: 8 (mod 32) floats where the backward reads its z operands in
// 8-byte pairs (load_a_pairs) and the tile k-major (load_bk), 4 (mod 8) for
// dz and the forward's single reads. Chunks as deep as shared memory allows:
// every chunk costs a barrier, and two deep chunks in flight beat three
// shallow ones.
template <typename T> struct Lay;
template <> struct Lay<float> {
  static constexpr int PAD = 8, FPAD = 4, DZP = 68, NBUF = 1, KF = 64, KB = 128, KB2 = 128,
                       KM = 64;
};
template <> struct Lay<bf16> {
  static constexpr int PAD = 8, FPAD = 8, DZP = 72, NBUF = 2, KF = 128, KB = 256, KB2 = 128,
                       KM = 128;
};

// Rows r0.. (n_rows valid) of an (n_rows, C) operand, columns k0.. + KC,
// into a chunk at `pitch`; rows past n_rows are zero-filled.
template <int KC, typename T>
__device__ __forceinline__ void load_chunk(T* dst, int pitch, const T* src, int C, int r0,
                                           int n_rows, int k0) {
  exo::tc::cp_tile<kTile, KC, kThreads>(dst, pitch, src, C, r0, n_rows, k0, C);
}

// The f32 z product's fragments with each k-step's columns read in pairs:
// k-column t of the m16n8k8 product is tile column 2t and t + 4 is 2t + 1,
// in A (rows g, g + 8) and in B (n-major, row g) alike, so each pair is one
// 8-byte read. At a row pitch of 8 (mod 32) floats a half-warp's reads fall
// in 16 distinct bank pairs.
__device__ __forceinline__ Tf32A load_a_pairs(const float* t, int p, int lane) {
  const float2 x = *reinterpret_cast<const float2*>(t + (lane / 4) * p + 2 * (lane % 4));
  const float2 y = *reinterpret_cast<const float2*>(t + (lane / 4 + 8) * p + 2 * (lane % 4));
  Tf32A a;
  exo::tc::split_tf32(x.x, a.hi[0], a.lo[0]);
  exo::tc::split_tf32(y.x, a.hi[1], a.lo[1]);
  exo::tc::split_tf32(x.y, a.hi[2], a.lo[2]);
  exo::tc::split_tf32(y.y, a.hi[3], a.lo[3]);
  return a;
}

__device__ __forceinline__ Tf32B load_b_pairs(const float* t, int p, int lane) {
  const float2 x = *reinterpret_cast<const float2*>(t + (lane / 4) * p + 2 * (lane % 4));
  Tf32B b;
  exo::tc::split_tf32(x.x, b.hi[0], b.lo[0]);
  exo::tc::split_tf32(x.y, b.hi[1], b.lo[1]);
  return b;
}

// acc (rows 16 wr.., columns 32 wc.. of the z tile) += A . B^T over one K
// chunk; A and B row-major (rows, K) at pitches ap and bp.
template <int KC, bool PAIRS = true>
__device__ __forceinline__ void z_chunk(float (&acc)[4][4], const float* a, int ap,
                                        const float* b, int bp, int wr, int wc, int lane) {
#pragma unroll
  for (int ks = 0; ks < KC / 8; ++ks) {
    const Tf32A fa = PAIRS ? load_a_pairs(a + 16 * wr * ap + ks * 8, ap, lane)
                           : exo::tc::load_a_tf32(a + 16 * wr * ap + ks * 8, ap, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const Tf32B fb = PAIRS ? load_b_pairs(b + (32 * wc + nt * 8) * bp + ks * 8, bp, lane)
                             : exo::tc::load_b_tf32(b + (32 * wc + nt * 8) * bp + ks * 8, bp, lane);
      mma_3xtf32(acc[nt], fa, fb);
    }
  }
}

// (PAIRS: the f32 form's fragment reads; ldmatrix serves bf16 either way)
template <int KC, bool PAIRS = true>
__device__ __forceinline__ void z_chunk(float (&acc)[4][4], const bf16* a, int ap,
                                        const bf16* b, int bp, int wr, int wc, int lane) {
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    uint32_t fa[4];
    ldsm_x4(fa, a + (16 * wr + a_row(lane)) * ap + ks * 16 + a_col(lane));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t fb[4];
      ldsm_x4(fb, b + (32 * wc + np * 16 + b_row(lane)) * bp + ks * 16 + b_col(lane));
      mma(acc[2 * np], fa, fb[0], fb[1]);
      mma(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// ---------------------------------------------------------------- forward
template <typename T>
constexpr size_t fwd_smem() {
  return sizeof(T) * size_t(kStages) * 2 * kTile * (Lay<T>::KF + Lay<T>::FPAD) +
         sizeof(float) * (4 * kTile * 2 + 4 * 16 * 2);
}

// Grid: 64-row blocks x stages x column splits (kColSplits where there are
// two column tiles or more: a B64 grid of 384 row-block CTAs fills 1.45
// waves of two CTAs an SM, 768 fill 2.9). Writes per-column partials
// part_m/part_l[s][rb][c] and per-row partials row_m/row_l[cs][s][r];
// grid_lse_reduce_kernel combines both in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
grid_fwd_kernel(const T* __restrict__ v3, const T* __restrict__ t3,
                const int* __restrict__ cvalid, float* __restrict__ part_m,
                float* __restrict__ part_l, float* __restrict__ row_m,
                float* __restrict__ row_l, int St, int R, int Cc, int C, float inv_temp) {
  constexpr int KC = Lay<T>::KF, CP = KC + Lay<T>::FPAD, CH = kTile * CP;
  extern __shared__ __align__(16) unsigned char smem_fwd[];
  T* ring = reinterpret_cast<T*>(smem_fwd);  // [kStages][v rows, t columns][CH]
  float* cpart = reinterpret_cast<float*>(ring + kStages * 2 * CH);  // [4][kTile][max, sum]
  float* rpart = cpart + 4 * kTile * 2;  // [4][16][max, sum]: the wc = 1 warps' rows
  const int s = blockIdx.y, rb = blockIdx.x, nR = gridDim.x, r0 = rb * kTile;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, wr = w % 4, wc = w / 4;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const T* v = v3 + size_t(s) * R * C;
  const T* t = t3 + (St == 1 ? size_t(0) : size_t(s) * Cc * C);
  const int nT = (Cc + kTile - 1) / kTile, cs = blockIdx.z, ncs = gridDim.z;
  const int j0 = cs * nT / ncs, nK = C / KC, total = ((cs + 1) * nT / ncs - j0) * nK;

  // chunk q: K chunk q % nK of the v rows and of column tile j0 + q / nK
  auto load = [&](int q) {
    T* slot = ring + (q % kStages) * 2 * CH;
    const int k0 = (q % nK) * KC;
    load_chunk<KC>(slot, CP, v, C, r0, R, k0);
    load_chunk<KC>(slot + CH, CP, t, C, (j0 + q / nK) * kTile, Cc, k0);
  };
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < total) load(q);
    cp_async_commit();
  }

  const bool rin[2] = {r0 + 16 * wr + g < R, r0 + 16 * wr + g + 8 < R};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8
  float acc[4][4];
  for (int q = 0; q < total; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk q has landed; every warp is done with chunk q - 1
    if (q + kStages - 1 < total) load(q + kStages - 1);
    cp_async_commit();
    const int kc = q % nK;
    if (kc == 0) zero(acc);
    const T* slot = ring + (q % kStages) * 2 * CH;
    z_chunk<KC, false>(acc, slot, CP, slot + CH, CP, wr, wc, lane);
    if (kc != nK - 1) continue;

    // column tile j complete: scale, NEG_FILL at invalid columns, -inf past
    // Cc (out of the row statistics)
    const int j = j0 + q / nK, cb = j * kTile + 32 * wc;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cb + nt * 8 + t2 + e;
        const bool cin = c < Cc;
        const bool cv = cin && __ldg(cvalid + c) != 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& z = acc[nt][2 * h + e];
          z = cin ? (cv ? z * inv_temp : kNegFill) : -INFINITY;
        }
      }
    // v_den: online row max and sum-exp over this warp's columns
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mt = fmaxf(mt, fmaxf(acc[nt][2 * h], acc[nt][2 * h + 1]));
      const float m_new = fmaxf(m[h], quad_max(mt));
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        rs += fexp(acc[nt][2 * h] - m_new) + fexp(acc[nt][2 * h + 1] - m_new);
      l[h] = l[h] * fexp(m[h] - m_new) + rs;  // this thread's columns; quad-summed at the end
      m[h] = m_new;
    }
    // t_den partials: column max and sum-exp over this warp's real rows
    // (a shuffle over the 8 row lanes), then over the four row warps
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float z0 = rin[0] ? acc[nt][e] : -INFINITY;
        const float z1 = rin[1] ? acc[nt][2 + e] : -INFINITY;
        float cm = fmaxf(z0, z1);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, o));
        const bool any = cm > -INFINITY;
        float cs = (any && rin[0] ? fexp(z0 - cm) : 0.f) + (any && rin[1] ? fexp(z1 - cm) : 0.f);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) cs += __shfl_xor_sync(kFull, cs, o);
        if (g == 0) {
          float* p = cpart + (wr * kTile + 32 * wc + nt * 8 + t2 + e) * 2;
          p[0] = cm;
          p[1] = cs;
        }
      }
    __syncthreads();
    if (tid < kTile && j * kTile + tid < Cc) {
      float mm = -INFINITY;
#pragma unroll
      for (int y = 0; y < 4; ++y) mm = fmaxf(mm, cpart[(y * kTile + tid) * 2]);
      float ll = 0.f;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const float my = cpart[(y * kTile + tid) * 2];
        if (my > -INFINITY) ll += cpart[(y * kTile + tid) * 2 + 1] * expf(my - mm);
      }
      const size_t o = (size_t(s) * nR + rb) * Cc + j * kTile + tid;
      part_m[o] = mm;
      part_l[o] = ll;
    }
    // cpart is written again only after the next tile's chunk barriers
  }

  // row partials: the two column-half warps of each row block combine
  float lq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) lq[h] = quad_sum(l[h]);
  if (wc == 1 && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rpart[(wr * 16 + g + 8 * h) * 2] = m[h];
      rpart[(wr * 16 + g + 8 * h) * 2 + 1] = lq[h];
    }
  }
  __syncthreads();
  if (wc == 0 && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * wr + g + 8 * h;
      if (row >= R) continue;
      const float m1 = rpart[(wr * 16 + g + 8 * h) * 2];
      const float l1 = rpart[(wr * 16 + g + 8 * h) * 2 + 1];
      const float mm = fmaxf(m[h], m1);
      const size_t o = (size_t(cs) * gridDim.y + s) * R + row;
      row_m[o] = mm;
      row_l[o] = lq[h] * expf(m[h] - mm) + l1 * expf(m1 - mm);
    }
  }
}

// logsumexp from n partial (max, sum-exp) pairs at stride `stride`, in order
__device__ __forceinline__ float lse_of(const float* pm, const float* pl, int n,
                                        size_t stride) {
  float m = -INFINITY;
  for (int i = 0; i < n; ++i) m = fmaxf(m, pm[i * stride]);
  float l = 0.f;
  for (int i = 0; i < n; ++i) l += pl[i * stride] * expf(pm[i * stride] - m);
  return m + logf(fmaxf(l, kTiny));
}

// blockIdx.z 0: t_den[s, c] over the nR row-block partials; 1: v_den[s, r]
// over the ncs column-split partials.
__global__ void grid_lse_reduce_kernel(const float* __restrict__ part_m,
                                       const float* __restrict__ part_l,
                                       const float* __restrict__ row_m,
                                       const float* __restrict__ row_l, float* __restrict__ tden,
                                       float* __restrict__ vden, int S, int R, int Cc, int nR,
                                       int ncs) {
  const int s = blockIdx.y, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.z == 0) {
    if (i < Cc) {
      const size_t o = size_t(s) * nR * Cc + i;
      tden[size_t(s) * Cc + i] = lse_of(part_m + o, part_l + o, nR, Cc);
    }
  } else if (i < R) {
    const size_t o = size_t(s) * R + i;
    vden[o] = lse_of(row_m + o, row_l + o, ncs, size_t(S) * R);
  }
}

// ---------------------------------------------------------------- backward
// The dz formula's values on one side of the grid: a video row (v_den, g_v)
// or a text column (t_den, g_t and its validity), for stage s.
struct Side {
  float den, grad;
  bool in, valid;
};

__device__ __forceinline__ Side video_side(int r, int s, int R, const float* __restrict__ vden,
                                           const float* __restrict__ gv) {
  const bool in = r < R;
  return {in ? __ldg(vden + size_t(s) * R + r) : 0.f, in ? __ldg(gv + size_t(s) * R + r) : 0.f,
          in, true};
}

__device__ __forceinline__ Side text_side(int c, int s, int Cc, const int* __restrict__ cvalid,
                                          const float* __restrict__ tden,
                                          const float* __restrict__ gt) {
  const bool in = c < Cc;
  return {in ? __ldg(tden + size_t(s) * Cc + c) : 0.f, in ? __ldg(gt + size_t(s) * Cc + c) : 0.f,
          in, in && __ldg(cvalid + c) != 0};
}

// dz of one z value (the TPU body :134-141, in its order)
__device__ __forceinline__ float dz_of(float z, const Side& vid, const Side& txt,
                                       float inv_temp) {
  if (!(vid.in && txt.in)) return 0.f;
  const float zz = txt.valid ? z * inv_temp : kNegFill;
  const float pr = fexp(zz - vid.den);
  const float pc = txt.valid ? fexp(zz - txt.den) : 0.f;
  return (pr * vid.grad + pc * txt.grad) * inv_temp;
}

// The second product, acc += dz . B: dz (64 x 64, from shared memory) times
// the resident tile's rows as k and its slab columns as n. Each warp w takes
// all 64 rows (4 m-tiles) of the 16-column blocks nb = w + 8 jb below nw,
// so a B fragment serves four products (fragment reads and TF32 splits are
// a quarter of a row-split layout's). acc[m][jb][h]: rows 16 m.., columns
// 16 nb + 8 h... The half HALF takes the blocks jb in [0, NJ/2) or [NJ/2,
// NJ), NJ = NS / 128: columns [0, NS/2) or [NS/2, NS) of the slab, so the
// first half's columns are free for the next tile while the second runs.
template <int NS>
using Acc2 = float[4][NS / 128][2][4];

template <int NS, int HALF>
__device__ __forceinline__ void second_product(Acc2<NS>& acc, const bf16* dzs, const bf16* bt,
                                               int bp, int nw, int w, int lane) {
  constexpr int NJ = NS / 128, J0 = HALF ? NJ / 2 : 0, J1 = HALF ? NJ : NJ / 2;
#pragma unroll
  for (int kk = 0; kk < (J0 < J1 ? kTile / 16 : 0); ++kk) {
    uint32_t fa[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      ldsm_x4(fa[m], dzs + (16 * m + a_row(lane)) * Lay<bf16>::DZP + kk * 16 + a_col(lane));
#pragma unroll
    for (int jb = J0; jb < J1; ++jb) {
      const int nb = w + 8 * jb;
      if (nb * 16 >= nw) continue;
      uint32_t fb[4];
      ldsm_x4_t(fb, bt + (kk * 16 + a_row(lane)) * bp + nb * 16 + a_col(lane));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        mma(acc[m][jb][0], fa[m], fb[0], fb[1]);
        mma(acc[m][jb][1], fa[m], fb[2], fb[3]);
      }
    }
  }
}

// The f32 form, fragments in the m16n8k8 layout: dz's A fragment
// (tc::load_a_tf32) at a pitch of 4 (mod 8) floats, the tile's rows as k
// (b0 = B[t][g], b1 = B[t + 4][g]) at its pitch of 8 (mod 32): both
// conflict-free.
__device__ __forceinline__ Tf32B load_bk(const float* t, int p, int lane) {
  const float* w = t + (lane % 4) * p + lane / 4;
  Tf32B b;
  exo::tc::split_tf32(w[0], b.hi[0], b.lo[0]);
  exo::tc::split_tf32(w[4 * p], b.hi[1], b.lo[1]);
  return b;
}

template <int NS, int HALF>
__device__ __forceinline__ void second_product(Acc2<NS>& acc, const float* dzs,
                                               const float* bt, int bp, int nw, int w,
                                               int lane) {
  constexpr int NJ = NS / 128, J0 = HALF ? NJ / 2 : 0, J1 = HALF ? NJ : NJ / 2;
#pragma unroll
  for (int kk = 0; kk < (J0 < J1 ? kTile / 8 : 0); ++kk) {
    Tf32A fa[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      fa[m] = exo::tc::load_a_tf32(dzs + 16 * m * Lay<float>::DZP + kk * 8, Lay<float>::DZP,
                                   lane);
#pragma unroll
    for (int jb = J0; jb < J1; ++jb) {
      const int nb = w + 8 * jb;
      if (nb * 16 >= nw) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Tf32B fb = load_bk(bt + kk * 8 * bp + nb * 16 + h * 8, bp, lane);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma_3xtf32(acc[m][jb][h], fa[m], fb);
      }
    }
  }
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Pitch of the resident tile: its panel width plus the type's pad.
template <typename T>
__host__ __device__ inline int res_pitch(int C) {
  return (C < kPanel ? C : kPanel) + Lay<T>::PAD;
}

// The backward's ring for K chunks of KC: stages (two where a chunk row
// holds 512 bytes or more, or C spans several panels, else three) and
// elements of a stage. A stage holds a chunk of A and, when C spans several panels
// (MULTI), one of the walked tile for the panels before the last (the last
// is resident).
template <typename T, bool MULTI, int KC_>
struct Ring {
  static constexpr int KC = KC_;
  static constexpr int NST = MULTI || KC * sizeof(T) >= 512 ? 2 : 3;
  static constexpr int CP = KC + Lay<T>::PAD, CH = kTile * CP, RS = MULTI ? 2 * CH : CH;
};

template <typename T, bool MULTI, int KC>
size_t bwd_smem(int C) {
  using L = Lay<T>;
  using G = Ring<T, MULTI, KC>;
  return sizeof(T) * (size_t(G::NST) * G::RS + size_t(L::NBUF) * kTile * res_pitch<T>(C) +
                      size_t(kTile) * L::DZP) +
         sizeof(Side) * kTile;
}

// TRANS false, the dv kernel (grid: 64-row blocks x stages x slabs): A = the
// video rows a0.. of stage s, walked tiles = the text column tiles, output
// dv rows in the input type. TRANS true, the dt kernel (grid: 64-column
// blocks x output stages x splits * slabs): A = the text columns a0.. of
// stage so, walked tiles = this split's items of the (stage, row block)
// list, output an f32 partial. Output slab: columns n0 = slab * NS.. of C.
template <typename T, int NS, bool TRANS, bool MULTI, int KC_>
__global__ void __launch_bounds__(kThreads, 1)
grid_bwd_kernel(const T* __restrict__ v3, const T* __restrict__ t3,
                const int* __restrict__ cvalid, const float* __restrict__ vden,
                const float* __restrict__ tden, const float* __restrict__ gv,
                const float* __restrict__ gt, T* __restrict__ dv, float* __restrict__ dt_part,
                int S, int St, int R, int Cc, int C, int nsplit, int nslab, float inv_temp) {
  using L = Lay<T>;
  using G = Ring<T, MULTI, KC_>;
  constexpr int KC = G::KC, CP = G::CP, CH = G::CH, rs = G::RS, nst = G::NST;
  const int bp = res_pitch<T>(C);
  extern __shared__ __align__(16) unsigned char smem_bwd[];
  T* ring = reinterpret_cast<T*>(smem_bwd);  // [nst][rs]: K chunks
  T* bres = ring + nst * rs;                 // [NBUF][kTile][bp]: the walked tile
  T* dzs = bres + L::NBUF * kTile * bp;      // [kTile][DZP]: dz (rows: A's)
  Side* bside_s = reinterpret_cast<Side*>(dzs + kTile * L::DZP);  // [kTile]: the walked rows
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32, wr = w % 4, wc = w / 4;
  const int g = lane / 4, t2 = 2 * (lane % 4);
  const int a0 = blockIdx.x * kTile;
  const int so = blockIdx.y;  // dv: the stage; dt: the output stage
  const int split = TRANS ? blockIdx.z / nslab : 0;
  const int slab = TRANS ? blockIdx.z % nslab : blockIdx.z;
  const int nRB = (R + kTile - 1) / kTile;
  int it0 = 0, it1 = (Cc + kTile - 1) / kTile;
  if (TRANS) {
    const int items = (St == 1 ? S : 1) * nRB;
    it0 = int((long long)split * items / nsplit);
    it1 = int((long long)(split + 1) * items / nsplit);
  }
  const T* A = TRANS ? t3 + size_t(so) * Cc * C : v3 + size_t(so) * R * C;
  const int nA = TRANS ? Cc : R, nB = TRANS ? R : Cc;
  // item -> its stage, the walked operand and its first row
  auto stage_of = [&](int it) { return TRANS ? (St == 1 ? it / nRB : so) : so; };
  auto walked = [&](int it) -> const T* {
    return TRANS ? v3 + size_t(stage_of(it)) * R * C
                 : t3 + (St == 1 ? size_t(0) : size_t(so) * Cc * C);
  };
  auto first_row = [&](int it) { return TRANS ? (it % nRB) * kTile : it * kTile; };

  // depth panels: z sums them in the order that ends with the slab's own
  const int n0 = slab * NS, nw = min(NS, C - n0);
  const int np = (C + kPanel - 1) / kPanel, ps = n0 / kPanel, nofs = n0 - ps * kPanel;
  const int nC = C / KC;  // chunks of an item
  // chunk q of an item: its panel, its depth offset and its place in the
  // panel; the walked tile's chunk goes to the resident tile in the slab's
  // panel, else to the ring beside A's (the resident tile still holds the
  // chunks being read when the next panel's loads start)
  auto chunk_of = [&](int q, int& p, int& k0, int& kc) {
    p = ps;
    k0 = 0;
    kc = q;
    for (int i = 1; i <= np; ++i) {
      p = (ps + i) % np;
      const int nk = min(kPanel, C - p * kPanel) / KC;
      if (kc < nk) {
        k0 = p * kPanel + kc * KC;
        return;
      }
      kc -= nk;
    }
  };
  auto walked_chunk = [&](int q, int p, int kc, int buf) -> T* {
    return p == ps ? bres + buf * kTile * bp + kc * KC : ring + (q % nst) * rs + CH;
  };
  // chunk q of item it: A's into the ring; the walked tile's, unless the
  // previous item's second product already released and loaded it
  auto load_a = [&](int q) {
    int p, k0, kc;
    chunk_of(q, p, k0, kc);
    load_chunk<KC>(ring + (q % nst) * rs, CP, A, C, a0, nA, k0);
  };
  auto load_b = [&](int it, int q, int buf) {
    int p, k0, kc;
    chunk_of(q, p, k0, kc);
    load_chunk<KC>(walked_chunk(q, p, kc, buf), p == ps ? bp : CP, walked(it), C,
                   first_row(it), nB, k0);
  };
  auto prologue = [&](int it, int buf, bool b_too) {
    for (int q = 0; q < nst - 1; ++q) {
      if (q < nC) {
        load_a(q);
        if (b_too) load_b(it, q, buf);
      }
      cp_async_commit();
    }
  };
  // One resident tile in one panel (f32): the next item's A chunks load
  // during the second product, and its walked chunks as each half of the
  // product frees their columns (releases: [0, nofs + 128 jmid), the rest).
  constexpr bool early = L::NBUF == 1 && !MULTI;
  const int cmid = nofs + 128 * ((NS / 128) / 2);
  auto release = [&](int it, int lo, int hi) {
    for (int q = lo / KC; q < hi / KC; ++q) load_b(it, q, 0);
    cp_async_commit();
  };

  Acc2<NS> acc2;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int jb = 0; jb < NS / 128; ++jb) zero(acc2[m][jb]);
  if (it0 < it1) prologue(it0, 0, true);
  for (int it = it0; it < it1; ++it) {
    const int buf = L::NBUF == 2 ? (it - it0) & 1 : 0;
    const bool b_loaded = early && it > it0;
    const T* bt = bres + buf * kTile * bp;
    // the dz formula's values: the A side in registers, the walked side in
    // shared memory (read after the z loop's barriers)
    const int s = stage_of(it), b0 = first_row(it);
    Side aside[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ai = a0 + 16 * wr + g + 8 * h;
      aside[h] = TRANS ? text_side(ai, s, Cc, cvalid, tden, gt) : video_side(ai, s, R, vden, gv);
    }
    if (tid < kTile) {
      const int bi = b0 + tid;
      bside_s[tid] =
          TRANS ? video_side(bi, s, R, vden, gv) : text_side(bi, s, Cc, cvalid, tden, gt);
    }
    float acc[4][4];
    zero(acc);
    for (int q = 0; q < nC; ++q) {
      // chunk q's group must have landed; the groups after it may not: the
      // next chunk's, or at q = 0 the second release (if chunk 0 is in the
      // first)
      if (b_loaded && q == 0) {
        if (cmid >= KC) {
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
      } else {
        cp_async_wait<nst - 2>();
      }
      __syncthreads();
      if (q + nst - 1 < nC) {
        load_a(q + nst - 1);
        if (!b_loaded) load_b(it, q + nst - 1, buf);
      }
      cp_async_commit();
      int p, k0, kc;
      chunk_of(q, p, k0, kc);
      z_chunk<KC>(acc, ring + (q % nst) * rs, CP, walked_chunk(q, p, kc, buf),
                  p == ps ? bp : CP, wr, wc, lane);
    }
    // dz on the fragments, into shared memory
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      Side bside[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) bside[e] = bside_s[32 * wc + nt * 8 + t2 + e];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const Side& vid = TRANS ? bside[e] : aside[h];
          const Side& txt = TRANS ? aside[h] : bside[e];
          d[e] = dz_of(acc[nt][2 * h + e], vid, txt, inv_temp);
        }
        store_pair(dzs + (16 * wr + g + 8 * h) * L::DZP + 32 * wc + nt * 8 + t2, d[0], d[1]);
      }
    }
    __syncthreads();
    const bool next = it + 1 < it1;
    if (next && (L::NBUF == 2 || early)) prologue(it + 1, buf ^ (L::NBUF - 1), L::NBUF == 2);
    second_product<NS, 0>(acc2, dzs, bt + nofs, bp, nw, w, lane);
    if (next && early) {
      __syncthreads();
      release(it + 1, 0, cmid);
    }
    second_product<NS, 1>(acc2, dzs, bt + nofs, bp, nw, w, lane);
    __syncthreads();  // dz and (one buffer) the tile are free
    if (next && early) release(it + 1, cmid, min(C, kPanel));
    if (next && L::NBUF == 1 && !early) prologue(it + 1, 0, true);
  }

  // rows a0 + 16 m + g (+ 8), columns n0 + 16 (w + 8 jb) + 8 h + t2 (+ 1)
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = a0 + 16 * m + g + 8 * hr;
      if (row >= nA) continue;
#pragma unroll
      for (int jb = 0; jb < NS / 128; ++jb) {
        const int nb = w + 8 * jb;
        if (nb * 16 >= nw) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + nb * 16 + h * 8 + t2;
          const float x = acc2[m][jb][h][2 * hr], y = acc2[m][jb][h][2 * hr + 1];
          if (TRANS) {
            store_pair(dt_part + ((size_t(split) * St + so) * Cc + row) * C + n, x, y);
          } else {
            store_pair(dv + (size_t(so) * R + row) * C + n, x, y);
          }
        }
      }
    }
}

template <typename T>
__global__ void grid_dt_sum_kernel(const float* __restrict__ dt_part, T* __restrict__ dt,
                                   size_t count, int nsplit) {
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float acc = 0.f;
  for (int k = 0; k < nsplit; ++k) acc += dt_part[size_t(k) * count + e];
  dt[e] = exo::from_f<T>(acc);
}

template <typename T>
cudaError_t forward(const void* v, const void* t, const void* cvalid, void* vden, void* tden,
                    void* part_m, void* part_l, int S, int St, int R, int Cc, int C, int nR,
                    float inv_temp, cudaStream_t st) {
  auto kernel = grid_fwd_kernel<T>;
  constexpr size_t bytes = fwd_smem<T>();
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int ncs = Cc > kTile ? kColSplits : 1;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* rm = pm + size_t(S) * nR * Cc;  // the row partials follow the column ones
  float* rl = pl + size_t(S) * nR * Cc;
  kernel<<<dim3(nR, S, ncs), kThreads, bytes, st>>>(
      static_cast<const T*>(v), static_cast<const T*>(t), static_cast<const int*>(cvalid), pm,
      pl, rm, rl, St, R, Cc, C, inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grid_lse_reduce_kernel<<<dim3(((Cc > R ? Cc : R) + 255) / 256, S, 2), 256, 0, st>>>(
      pm, pl, rm, rl, static_cast<float*>(tden), static_cast<float*>(vden), S, R, Cc, nR, ncs);
  return cudaGetLastError();
}

template <typename T, int NS, bool MULTI, int KC>
cudaError_t backward_ns(const void* v, const void* t, const void* cvalid, const void* vden,
                        const void* tden, const void* gv, const void* gt, void* dv, void* dt,
                        void* dt_part, int S, int St, int R, int Cc, int C, int nsplit,
                        float inv_temp, cudaStream_t st) {
  const int nslab = (C + NS - 1) / NS;
  const size_t bytes = bwd_smem<T, MULTI, KC>(C);
  const T* vp = static_cast<const T*>(v);
  const T* tp = static_cast<const T*>(t);
  const int* cv = static_cast<const int*>(cvalid);
  const float *vd = static_cast<const float*>(vden), *td = static_cast<const float*>(tden);
  const float *g_v = static_cast<const float*>(gv), *g_t = static_cast<const float*>(gt);
  float* part = static_cast<float*>(dt_part);

  auto dv_kernel = grid_bwd_kernel<T, NS, false, MULTI, KC>;
  cudaError_t err = exo::allow_smem(dv_kernel, bytes);
  if (err != cudaSuccess) return err;
  dv_kernel<<<dim3((R + kTile - 1) / kTile, S, nslab), kThreads, bytes, st>>>(
      vp, tp, cv, vd, td, g_v, g_t, static_cast<T*>(dv), part, S, St, R, Cc, C, nsplit, nslab,
      inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dt_kernel = grid_bwd_kernel<T, NS, true, MULTI, KC>;
  err = exo::allow_smem(dt_kernel, bytes);
  if (err != cudaSuccess) return err;
  dt_kernel<<<dim3((Cc + kTile - 1) / kTile, St, nsplit * nslab), kThreads, bytes, st>>>(
      vp, tp, cv, vd, td, g_v, g_t, static_cast<T*>(dv), part, S, St, R, Cc, C, nsplit, nslab,
      inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t count = size_t(St) * Cc * C;
  grid_dt_sum_kernel<T><<<unsigned((count + 255) / 256), 256, 0, st>>>(
      part, static_cast<T*>(dt), count, nsplit);
  return cudaGetLastError();
}

// The output slab's width comes from the caller: 128, 256 or 512 over one
// depth panel; over several, 256 in f32 (at 512 the panel bookkeeping
// spills) and 512 in bf16. Any other width has no instance.
template <typename T>
constexpr int multi_slab() { return sizeof(T) == 4 ? 256 : 512; }

template <typename T>
cudaError_t backward(int C, int slab, const void* v, const void* t, const void* cvalid,
                     const void* vden, const void* tden, const void* gv, const void* gt, void* dv,
                     void* dt, void* dt_part, int S, int St, int R, int Cc, int nsplit,
                     float inv_temp, cudaStream_t st) {
  using L = Lay<T>;
#define EXO_BWD(NS, MULTI, KC)                                                                 \
  backward_ns<T, NS, MULTI, KC>(v, t, cvalid, vden, tden, gv, gt, dv, dt, dt_part, S, St, R, Cc, \
                                C, nsplit, inv_temp, st)
  if (C > kPanel)
    return slab == multi_slab<T>() ? EXO_BWD(multi_slab<T>(), true, L::KM) : cudaErrorInvalidValue;
  const bool kb = C % L::KB == 0;
  if (slab == 128) return EXO_BWD(128, false, L::KB2);
  if (slab == 256) return kb ? EXO_BWD(256, false, L::KB) : EXO_BWD(256, false, L::KB2);
  if (slab == 512) return kb ? EXO_BWD(512, false, L::KB) : EXO_BWD(512, false, L::KB2);
  return cudaErrorInvalidValue;
#undef EXO_BWD
}

bool shapes_ok(int S, int St, int R, int Cc, int C) {
  return S >= 1 && S <= 65535 && (St == 1 || St == S) && R >= 1 && Cc >= 1 && C >= 128 &&
         C % 128 == 0;
}

}  // namespace

// video3 (S, R, C), text3 (St, Cc, C) of one type (dtype 0: float32, 1:
// bfloat16), St 1 or S, both 16-byte aligned; cvalid (Cc,) int32, nonzero
// at a valid column. Writes v_den (S, R) and t_den (S, Cc) float32;
// part_m/part_l are float32 scratch of S * nR * Cc + kColSplits * S * R
// values each, nR = ceil(R / 64). All contiguous. Returns the CUDA error of
// the launches, or 0.
extern "C" int milnce_grid_forward(const void* video3, const void* text3, const void* cvalid,
                                   void* vden, void* tden, void* part_m, void* part_l, int S,
                                   int St, int R, int Cc, int C, int nR, float inv_temp,
                                   int dtype, void* stream) {
  if (!shapes_ok(S, St, R, Cc, C) || nR != (R + kTile - 1) / kTile) return cudaErrorInvalidValue;
  if (!exo::tc::aligned16(video3) || !exo::tc::aligned16(text3))
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(video3, text3, cvalid, vden, tden, part_m, part_l, S, St, R, Cc, C,
                          nR, inv_temp, st);
  if (dtype == 1)
    return forward<bf16>(video3, text3, cvalid, vden, tden, part_m, part_l, S, St, R, Cc, C, nR,
                         inv_temp, st);
  return cudaErrorInvalidValue;
}

// Backward of milnce_grid_forward: g_v (S, R) and g_t (S, Cc) float32
// upstream grads; v_den/t_den the forward's outputs; slab the output slab's
// width (backward() above). Writes dv (S, R, C) and dt (St, Cc, C) in the
// input type; dt_part is float32 scratch of (nsplit, St, Cc, C). Returns the
// CUDA error of the launches, or 0.
extern "C" int milnce_grid_backward(const void* video3, const void* text3, const void* cvalid,
                                    const void* vden, const void* tden, const void* gv,
                                    const void* gt, void* dv, void* dt, void* dt_part, int S,
                                    int St, int R, int Cc, int C, int nsplit, int slab,
                                    float inv_temp, int dtype, void* stream) {
  if (!shapes_ok(S, St, R, Cc, C) || nsplit < 1) return cudaErrorInvalidValue;
  if (!exo::tc::aligned16(video3) || !exo::tc::aligned16(text3))
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(C, slab, video3, text3, cvalid, vden, tden, gv, gt, dv, dt, dt_part,
                           S, St, R, Cc, nsplit, inv_temp, st);
  if (dtype == 1)
    return backward<bf16>(C, slab, video3, text3, cvalid, vden, tden, gv, gt, dv, dt, dt_part,
                          S, St, R, Cc, nsplit, inv_temp, st);
  return cudaErrorInvalidValue;
}
