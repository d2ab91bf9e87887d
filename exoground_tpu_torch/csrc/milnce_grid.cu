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
// z never reaches device memory: every kernel recomputes its tile.
//
// What bounds it on an H100: operations. Forward 2*S*R*Cc*C FLOPs against
// (S*R + St*Cc)*C input values (B=16: 1.2 GFLOP per 15 MB in f32, ~80
// FLOP/byte, above the f32 balance point of ~20); backward three times the
// forward. This first version runs f32 math on the CUDA cores for f32 and
// bf16 inputs alike (no tensor cores).
//
// Design. The TPU kernel runs one sequential grid per stage and keeps the
// whole column block and the online column max/sum-exp resident in VMEM
// across row blocks; in backward it keeps dt resident across row blocks.
// Hopper blocks run in parallel and in no order, with 227 KB of shared
// memory, so:
//   forward pass 1 (grid: row blocks of 32 x stages): each CTA walks the
//     column tiles of 64, computes the z tile in registers (K chunks of 32
//     staged through shared memory), keeps an online row max/sum-exp in
//     registers (v_den is final inside the CTA) and writes per-column
//     partials (max, sum-exp over its rows) to an (S, nR, Cc) scratch;
//   forward pass 2: one thread per column reduces the partials into t_den;
//   dv kernel (grid: row blocks of 32 x stages x output slabs): recomputes
//     z per column tile, forms dz in shared memory and accumulates dv in
//     registers, as flash attention's dq pass does;
//   dt kernel (grid: column tiles of 32 x output stages x splits of the
//     (stage, row block) work list): recomputes z per row block, forms dz
//     and accumulates dt in registers; each split writes an f32 partial and
//     a last pass sums the splits in a fixed order. No atomics: the result
//     is the same from run to run.
// The ragged edges (rows past R, columns past Cc) are masked in the kernel:
// no padding copies. For bf16 inputs dz is rounded to bf16 before the two
// products, as the TPU kernel casts it to the input type (:144).
#include <cstddef>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;       // K chunk staged through shared memory
constexpr int kPC = 8;        // rows of the second product's operand per chunk
constexpr int kFwdRows = 32;  // rows per CTA in the forward and dv kernels
constexpr int kDtRows = 64;   // rows per z tile in the dt kernel
constexpr int kMaxNS = 512;   // output columns per CTA of the dv/dt products
constexpr float kNegFill = -6e4f;
constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

// z tile of (16*TR) rows x (16*TC) columns: thread (ty, tx) = (tid/16,
// tid%16) holds rows r0 + ty + 16*i and columns c0 + tx + 16*j. Rows past R
// and columns past Cc read zeros.
template <typename T, int TR, int TC>
__device__ __forceinline__ void z_tile(const T* __restrict__ v, const T* __restrict__ t,
                                       int R, int Cc, int C, int r0, int c0, float* vs,
                                       float* ts, float (&acc)[TR][TC]) {
  constexpr int BR = 16 * TR, BC = 16 * TC;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += kKC) {
    for (int e = tid; e < BR * kKC; e += kThreads) {
      const int r = e / kKC, kk = e % kKC;
      vs[kk * (BR + 1) + r] = r0 + r < R ? exo::to_f(v[size_t(r0 + r) * C + k0 + kk]) : 0.f;
    }
    for (int e = tid; e < BC * kKC; e += kThreads) {
      const int c = e / kKC, kk = e % kKC;
      ts[kk * (BC + 1) + c] = c0 + c < Cc ? exo::to_f(t[size_t(c0 + c) * C + k0 + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKC; ++kk) {
      float a[TR], b[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = vs[kk * (BR + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TC; ++j) b[j] = ts[kk * (BC + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// dz of a z tile (rows r0.., columns c0.. of stage s) into shared memory
// dzs[row][col] (pitch BC + 1); zero outside the grid.
template <typename T, int TR, int TC>
__device__ __forceinline__ void dz_tile(const float (&z)[TR][TC], int s, int R, int Cc,
                                        int r0, int c0, const int* __restrict__ cvalid,
                                        const float* __restrict__ vden,
                                        const float* __restrict__ tden,
                                        const float* __restrict__ gv,
                                        const float* __restrict__ gt, float inv_temp,
                                        float* dzs) {
  constexpr int BC = 16 * TC;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int c = c0 + tx + 16 * j;
    const bool cin = c < Cc;
    const bool cv = cin && cvalid[c] != 0;
    const float td = cin ? tden[size_t(s) * Cc + c] : 0.f;
    const float g_t = cin ? gt[size_t(s) * Cc + c] : 0.f;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = r0 + ty + 16 * i;
      const bool rin = r < R;
      const float vd = rin ? vden[size_t(s) * R + r] : 0.f;
      const float g_v = rin ? gv[size_t(s) * R + r] : 0.f;
      const float zz = cv ? z[i][j] * inv_temp : kNegFill;
      const float pr = expf(zz - vd);
      const float pc = cv ? expf(zz - td) : 0.f;
      float dz = (pr * g_v + pc * g_t) * inv_temp;
      dz = (rin && cin) ? dz : 0.f;
      dzs[(ty + 16 * i) * (BC + 1) + tx + 16 * j] = exo::to_f(exo::from_f<T>(dz));
    }
  }
}

// ---------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(kThreads)
grid_fwd_kernel(const T* __restrict__ v3, const T* __restrict__ t3,
                const int* __restrict__ cvalid, float* __restrict__ vden,
                float* __restrict__ part_m, float* __restrict__ part_l, int St, int R,
                int Cc, int C, float inv_temp) {
  constexpr int TR = 2, TC = 4, BR = 16 * TR, BC = 16 * TC;
  __shared__ float vs[kKC * (BR + 1)];
  __shared__ float ts[kKC * (BC + 1)];
  __shared__ float cpart[16][BC];  // per-ty column max, then column sum-exp
  __shared__ float colm[BC];
  const int s = blockIdx.y, rb = blockIdx.x, nR = gridDim.x;
  const int r0 = rb * BR;
  const T* v = v3 + size_t(s) * R * C;
  const T* t = t3 + (St == 1 ? size_t(0) : size_t(s) * Cc * C);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float m_run[TR], l_run[TR];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  for (int c0 = 0; c0 < Cc; c0 += BC) {
    float z[TR][TC];
    z_tile<T, TR, TC>(v, t, R, Cc, C, r0, c0, vs, ts, z);
    bool cin[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = c0 + tx + 16 * j;
      cin[j] = c < Cc;
      const bool valid = cin[j] && cvalid[c] != 0;
#pragma unroll
      for (int i = 0; i < TR; ++i) z[i][j] = valid ? z[i][j] * inv_temp : kNegFill;
    }
    // v_den: online row logsumexp; row ty + 16*i lives on the 16 lanes of
    // one half-warp, so shuffles with offsets 8..1 reduce it
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (cin[j]) mt = fmaxf(mt, z[i][j]);
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
      const float m_new = fmaxf(m_run[i], mt);
      float st = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (cin[j]) st += expf(z[i][j] - m_new);
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) st += __shfl_xor_sync(kFull, st, off);
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + st;
      m_run[i] = m_new;
    }
    // t_den partials: column max and sum-exp over this CTA's real rows
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      float mc = -INFINITY;
#pragma unroll
      for (int i = 0; i < TR; ++i)
        if (r0 + ty + 16 * i < R) mc = fmaxf(mc, z[i][j]);
      cpart[ty][tx + 16 * j] = mc;
    }
    __syncthreads();
    if (tid < BC) {
      float m = -INFINITY;
#pragma unroll
      for (int y = 0; y < 16; ++y) m = fmaxf(m, cpart[y][tid]);
      colm[tid] = m;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const float m = colm[tx + 16 * j];
      float sc = 0.f;
#pragma unroll
      for (int i = 0; i < TR; ++i)
        if (r0 + ty + 16 * i < R) sc += expf(z[i][j] - m);
      cpart[ty][tx + 16 * j] = sc;
    }
    __syncthreads();
    if (tid < BC && c0 + tid < Cc) {
      float l = 0.f;
#pragma unroll
      for (int y = 0; y < 16; ++y) l += cpart[y][tid];
      const size_t o = (size_t(s) * nR + rb) * Cc + c0 + tid;
      part_m[o] = colm[tid];
      part_l[o] = l;
    }
    __syncthreads();
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = r0 + ty + 16 * i;
      if (r < R) vden[size_t(s) * R + r] = m_run[i] + logf(fmaxf(l_run[i], kTiny));
    }
  }
}

__global__ void grid_tden_kernel(const float* __restrict__ part_m,
                                 const float* __restrict__ part_l, float* __restrict__ tden,
                                 int nR, int Cc) {
  const int s = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Cc) return;
  const float* pm = part_m + size_t(s) * nR * Cc + c;
  const float* pl = part_l + size_t(s) * nR * Cc + c;
  float m = -INFINITY;
  for (int rb = 0; rb < nR; ++rb) m = fmaxf(m, pm[size_t(rb) * Cc]);
  float l = 0.f;
  for (int rb = 0; rb < nR; ++rb) l += pl[size_t(rb) * Cc] * expf(pm[size_t(rb) * Cc] - m);
  tden[size_t(s) * Cc + c] = m + logf(fmaxf(l, kTiny));
}

// ---------------------------------------------------------------- backward
// acc[i][j] += sum_p A[row i][p] * B[p][n0 + wx + 32 j] over one tile, with
// A from dzs (pitch lda, row stride ars, column stride acs) and B the rows
// b0.. of a (nb, C) operand staged through shared memory in chunks of kPC.
template <typename T, int NJ>
__device__ __forceinline__ void tile_product(const float* dzs, int ars, int acs, int np,
                                             const T* __restrict__ b, int b0, int nb, int C,
                                             int n0, float* bs, float (&acc)[4][NJ]) {
  constexpr int NS = 32 * NJ;
  const int tid = threadIdx.x, wy = tid / 32, wx = tid % 32;
  for (int p0 = 0; p0 < np && b0 + p0 < nb; p0 += kPC) {
    for (int e = tid; e < kPC * NS; e += kThreads) {
      const int pp = e / NS, n = e % NS;
      const int row = b0 + p0 + pp;
      bs[pp * (NS + 1) + n] =
          (row < nb && n0 + n < C) ? exo::to_f(b[size_t(row) * C + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int pp = 0; pp < kPC; ++pp) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dzs[(wy + 8 * i) * ars + (p0 + pp) * acs];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float w = bs[pp * (NS + 1) + wx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], w, acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// dv[s, r0 + 32 rows, n0 + NS cols] = sum over column tiles of dz . t
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
grid_dv_kernel(const T* __restrict__ v3, const T* __restrict__ t3,
               const int* __restrict__ cvalid, const float* __restrict__ vden,
               const float* __restrict__ tden, const float* __restrict__ gv,
               const float* __restrict__ gt, T* __restrict__ dv, int St, int R, int Cc,
               int C, float inv_temp) {
  constexpr int TR = 2, TC = 4, BR = 16 * TR, BC = 16 * TC, NS = 32 * NJ;
  extern __shared__ float smem[];
  float* vs = smem;                   // [kKC][BR + 1]
  float* ts = vs + kKC * (BR + 1);    // [kKC][BC + 1]
  float* dzs = ts + kKC * (BC + 1);   // [BR][BC + 1]
  float* bs = dzs + BR * (BC + 1);    // [kPC][NS + 1]
  const int s = blockIdx.y, r0 = blockIdx.x * BR, n0 = blockIdx.z * NS;
  const T* v = v3 + size_t(s) * R * C;
  const T* t = t3 + (St == 1 ? size_t(0) : size_t(s) * Cc * C);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < Cc; c0 += BC) {
    float z[TR][TC];
    z_tile<T, TR, TC>(v, t, R, Cc, C, r0, c0, vs, ts, z);
    dz_tile<T, TR, TC>(z, s, R, Cc, r0, c0, cvalid, vden, tden, gv, gt, inv_temp, dzs);
    __syncthreads();
    // rows wy + 8*i of dzs, its columns p as the product's depth
    tile_product<T, NJ>(dzs, BC + 1, 1, BC, t, c0, Cc, C, n0, bs, acc);
  }
  const int tid = threadIdx.x, wy = tid / 32, wx = tid % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + wy + 8 * i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + wx + 32 * j;
      if (n < C) dv[(size_t(s) * R + r) * C + n] = exo::from_f<T>(acc[i][j]);
    }
  }
}

// One split's dt partial: columns c0 + 32 of output stage so, summed over
// the split's share of the (stage, row block) work list.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
grid_dt_kernel(const T* __restrict__ v3, const T* __restrict__ t3,
               const int* __restrict__ cvalid, const float* __restrict__ vden,
               const float* __restrict__ tden, const float* __restrict__ gv,
               const float* __restrict__ gt, float* __restrict__ dt_part, int S, int St,
               int R, int Cc, int C, int nsplit, int nslab, float inv_temp) {
  constexpr int TR = 4, TC = 2, BR = 16 * TR, BC = 16 * TC, NS = 32 * NJ;
  extern __shared__ float smem[];
  float* vs = smem;                   // [kKC][BR + 1]
  float* ts = vs + kKC * (BR + 1);    // [kKC][BC + 1]
  float* dzs = ts + kKC * (BC + 1);   // [BR][BC + 1]
  float* bs = dzs + BR * (BC + 1);    // [kPC][NS + 1]
  const int c0 = blockIdx.x * BC, so = blockIdx.y;
  const int split = blockIdx.z / nslab, n0 = (blockIdx.z % nslab) * NS;
  const int nRB = (R + BR - 1) / BR;
  const int items = (St == 1 ? S : 1) * nRB;
  const int it0 = int((long long)split * items / nsplit);
  const int it1 = int((long long)(split + 1) * items / nsplit);
  const T* t = t3 + size_t(so) * Cc * C;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int it = it0; it < it1; ++it) {
    const int s = St == 1 ? it / nRB : so;
    const int r0 = (it % nRB) * BR;
    const T* v = v3 + size_t(s) * R * C;
    float z[TR][TC];
    z_tile<T, TR, TC>(v, t, R, Cc, C, r0, c0, vs, ts, z);
    dz_tile<T, TR, TC>(z, s, R, Cc, r0, c0, cvalid, vden, tden, gv, gt, inv_temp, dzs);
    __syncthreads();
    // columns wy + 8*i of dzs, its rows p as the product's depth
    tile_product<T, NJ>(dzs, 1, BC + 1, BR, v, r0, R, C, n0, bs, acc);
  }
  const int tid = threadIdx.x, wy = tid / 32, wx = tid % 32;
  float* out = dt_part + (size_t(split) * St + so) * Cc * C;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + wy + 8 * i;
    if (c >= Cc) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + wx + 32 * j;
      if (n < C) out[size_t(c) * C + n] = acc[i][j];
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

template <int NJ, int BR, int BC>
constexpr size_t bwd_smem() {
  return sizeof(float) *
         (size_t(kKC) * (BR + 1) + kKC * (BC + 1) + BR * (BC + 1) + kPC * (32 * NJ + 1));
}

template <typename T>
cudaError_t forward(const void* v, const void* t, const void* cvalid, void* vden, void* tden,
                    void* part_m, void* part_l, int S, int St, int R, int Cc, int C, int nR,
                    float inv_temp, cudaStream_t st) {
  grid_fwd_kernel<T><<<dim3(nR, S), kThreads, 0, st>>>(
      static_cast<const T*>(v), static_cast<const T*>(t), static_cast<const int*>(cvalid),
      static_cast<float*>(vden), static_cast<float*>(part_m), static_cast<float*>(part_l), St,
      R, Cc, C, inv_temp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grid_tden_kernel<<<dim3((Cc + 255) / 256, S), 256, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<float*>(tden), nR, Cc);
  return cudaGetLastError();
}

template <typename T, int NJ>
cudaError_t backward_nj(const void* v, const void* t, const void* cvalid, const void* vden,
                        const void* tden, const void* gv, const void* gt, void* dv, void* dt,
                        void* dt_part, int S, int St, int R, int Cc, int C, int nsplit,
                        float inv_temp, cudaStream_t st) {
  constexpr int NS = 32 * NJ;
  const int nslab = (C + NS - 1) / NS;
  const T* vp = static_cast<const T*>(v);
  const T* tp = static_cast<const T*>(t);
  const int* cv = static_cast<const int*>(cvalid);
  const float *vd = static_cast<const float*>(vden), *td = static_cast<const float*>(tden);
  const float *g_v = static_cast<const float*>(gv), *g_t = static_cast<const float*>(gt);

  auto dv_kernel = grid_dv_kernel<T, NJ>;
  constexpr size_t dv_smem = bwd_smem<NJ, kFwdRows, 64>();
  cudaError_t err = exo::allow_smem(dv_kernel, dv_smem);
  if (err != cudaSuccess) return err;
  dv_kernel<<<dim3((R + kFwdRows - 1) / kFwdRows, S, nslab), kThreads, dv_smem, st>>>(
      vp, tp, cv, vd, td, g_v, g_t, static_cast<T*>(dv), St, R, Cc, C, inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dt_kernel = grid_dt_kernel<T, NJ>;
  constexpr size_t dt_smem = bwd_smem<NJ, kDtRows, 32>();
  err = exo::allow_smem(dt_kernel, dt_smem);
  if (err != cudaSuccess) return err;
  dt_kernel<<<dim3((Cc + 31) / 32, St, nsplit * nslab), kThreads, dt_smem, st>>>(
      vp, tp, cv, vd, td, g_v, g_t, static_cast<float*>(dt_part), S, St, R, Cc, C, nsplit,
      nslab, inv_temp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t count = size_t(St) * Cc * C;
  grid_dt_sum_kernel<T><<<unsigned((count + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dt_part), static_cast<T*>(dt), count, nsplit);
  return cudaGetLastError();
}

// output columns per thread: C/32 up to C=512 (one slab), 16 above (slabs of 512)
template <typename T>
cudaError_t backward(int C, const void* v, const void* t, const void* cvalid, const void* vden,
                     const void* tden, const void* gv, const void* gt, void* dv, void* dt,
                     void* dt_part, int S, int St, int R, int Cc, int nsplit, float inv_temp,
                     cudaStream_t st) {
#define EXO_BWD(NJ) \
  backward_nj<T, NJ>(v, t, cvalid, vden, tden, gv, gt, dv, dt, dt_part, S, St, R, Cc, C, \
                     nsplit, inv_temp, st)
  switch (C) {
    case 128: return EXO_BWD(4);
    case 256: return EXO_BWD(8);
    case 384: return EXO_BWD(12);
    default: return EXO_BWD(16);
  }
#undef EXO_BWD
}

bool shapes_ok(int S, int St, int R, int Cc, int C) {
  return S >= 1 && (St == 1 || St == S) && R >= 1 && Cc >= 1 && C >= 128 && C % 128 == 0;
}

}  // namespace

// video3 (S, R, C), text3 (St, Cc, C) of one type (dtype 0: float32, 1:
// bfloat16), St 1 or S; cvalid (Cc,) int32, nonzero at a valid column.
// Writes v_den (S, R) and t_den (S, Cc) float32; part_m/part_l are float32
// scratch of (S, nR, Cc) with nR = ceil(R / 32). All contiguous. Returns the
// CUDA error of the launches, or 0.
extern "C" int milnce_grid_forward(const void* video3, const void* text3, const void* cvalid,
                                   void* vden, void* tden, void* part_m, void* part_l, int S,
                                   int St, int R, int Cc, int C, int nR, float inv_temp,
                                   int dtype, void* stream) {
  if (!shapes_ok(S, St, R, Cc, C) || nR != (R + kFwdRows - 1) / kFwdRows)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float>(video3, text3, cvalid, vden, tden, part_m, part_l, S, St, R, Cc, C,
                          nR, inv_temp, st);
  if (dtype == 1)
    return forward<__nv_bfloat16>(video3, text3, cvalid, vden, tden, part_m, part_l, S, St,
                                  R, Cc, C, nR, inv_temp, st);
  return cudaErrorInvalidValue;
}

// Backward of milnce_grid_forward: g_v (S, R) and g_t (S, Cc) float32
// upstream grads; v_den/t_den the forward's outputs. Writes dv (S, R, C) and
// dt (St, Cc, C) in the input type; dt_part is float32 scratch of
// (nsplit, St, Cc, C). Returns the CUDA error of the launches, or 0.
extern "C" int milnce_grid_backward(const void* video3, const void* text3, const void* cvalid,
                                    const void* vden, const void* tden, const void* gv,
                                    const void* gt, void* dv, void* dt, void* dt_part, int S,
                                    int St, int R, int Cc, int C, int nsplit, float inv_temp,
                                    int dtype, void* stream) {
  if (!shapes_ok(S, St, R, Cc, C) || nsplit < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(C, video3, text3, cvalid, vden, tden, gv, gt, dv, dt, dt_part, S,
                           St, R, Cc, nsplit, inv_temp, st);
  if (dtype == 1)
    return backward<__nv_bfloat16>(C, video3, text3, cvalid, vden, tden, gv, gt, dv, dt,
                                   dt_part, S, St, R, Cc, nsplit, inv_temp, st);
  return cudaErrorInvalidValue;
}
