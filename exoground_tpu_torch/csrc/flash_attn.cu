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
// against the forward's 2. This first version runs f32 math on the CUDA
// cores for f32 and bf16 inputs alike (no tensor cores): the design keeps
// the S x S scores out of device memory and feeds the FMAs from shared
// memory; mma.sync/wgmma tiles come later.
//
// Design. The TPU kernel runs a sequential grid (bh, q block, k block) with
// 512 x 1024 blocks and carries m, l and the accumulator in VMEM from one
// key block to the next. Hopper blocks run in parallel and in no order, so
// each CTA owns 64 rows and loops over the other axis itself:
//   forward and dq: one CTA per (64 query rows, bh) walks the key tiles of
//     64; q (and do) stay in shared memory, K and V tiles are staged there,
//     the row statistics and the accumulator live in registers;
//   dk/dv: one CTA per (64 key rows, bh) walks the query tiles; each CTA
//     owns its dk/dv rows, so there are no atomics and the result does not
//     vary from run to run.
// 256 threads hold a 64 x 64 score tile as 4 x 4 per thread: thread (ty,
// tx) = (tid / 16, tid % 16) holds rows ty + 16 i and columns tx + 16 j, so
// a row lives on one half-warp and its max and sum are shuffle reductions.
// The same thread owns output columns tx + 16 j of the same rows. Operand
// tiles are staged transposed, [d][row] with a pitch of 65 floats, so every
// product reads shared memory without bank conflicts. Rows past Sq or Sk
// are masked in place: no padding copies. The head size is a template
// constant (32, 40, 64, 128); a smaller D that is a multiple of 8 runs in
// the next tile up with zero-filled columns.
//
// Rounding follows the TPU kernel for bf16 inputs: p is rounded to v's type
// before p . v (:157), ds to k's type before ds . k (:198) and to q's type
// before ds^T . q (:239); p^T . do runs on the unrounded f32 p (:229).
#include <cstddef>
#include <math.h>

#include "common.cuh"

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

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
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

// ---------------------------------------------------------------- forward
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kpad, T* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk, int D) {
  constexpr int NJ = Cols<DT>::NJ, DP = Cols<DT>::DP;
  extern __shared__ float smem[];
  float* qt = smem;          // [DP][kP]
  float* kt = qt + DP * kP;  // [DP][kP]
  float* vt = kt + DP * kP;  // [DP][kP]
  float* ps = vt + DP * kP;  // [kT][kP]
  __shared__ int valid[kT];
  const int bh = blockIdx.y, q0 = blockIdx.x * kT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  q += size_t(bh) * Sq * D;
  k += size_t(bh) * Sk * D;
  v += size_t(bh) * Sk * D;
  const int* pad = kpad + size_t(bh / H) * Sk;

  load_t<T, DP>(q, Sq, D, q0, qt);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero<NJ>(acc);
  for (int k0 = 0; k0 < Sk; k0 += kT) {
    __syncthreads();  // the previous tile's readers are done
    load_t<T, DP>(k, Sk, D, k0, kt);
    load_t<T, DP>(v, Sk, D, k0, vt);
    if (tid < kT) valid[tid] = k0 + tid < Sk && pad[k0 + tid] == 0;
    __syncthreads();
    float s[4][4];
    rows_dot<DP>(qt, kt, s);
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ok[j] = valid[tx + 16 * j] != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ok[j]) mt = fmaxf(mt, s[i][j]);
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      float st = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        st += p;
        ps[(ty + 16 * i) * kP + tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + half_warp_sum(st);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_times<NJ>(ps, vt, acc);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lm = fmaxf(l[i], kTiny);
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] /= lm;
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < Sq)
      lse[size_t(bh) * Sq + r] = l[i] > 0.f ? m[i] + logf(lm) : -kNegInf;
  }
  store_rows<T, NJ>(acc, o + size_t(bh) * Sq * D, Sq, D, q0);
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

// ---------------------------------------------------------------- launch
template <int DT>
constexpr size_t smem_bytes(int operand_tiles) {
  return sizeof(float) * size_t(operand_tiles * Cols<DT>::DP + kT) * kP;
}

struct Shape {
  int BH, H, Sq, Sk, D;
};

template <typename T, int DT>
cudaError_t fwd(const void* q, const void* k, const void* v, const void* kpad, void* o,
                void* lse, Shape sh, cudaStream_t st) {
  auto kernel = flash_fwd_kernel<T, DT>;
  constexpr size_t bytes = smem_bytes<DT>(3);
  cudaError_t err = exo::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sh.Sq + kT - 1) / kT, sh.BH), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kpad), static_cast<T*>(o), static_cast<float*>(lse), sh.H, sh.Sq,
      sh.Sk, sh.D);
  return cudaGetLastError();
}

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

// The smallest instantiated head size that holds D (a multiple of 8, <= 128).
int head_tile(int D) {
  if (D < 8 || D > 128 || D % 8) return 0;
  return D <= 32 ? 32 : D <= 40 ? 40 : D <= 64 ? 64 : 128;
}

bool shape_ok(const Shape& sh) {
  return sh.H >= 1 && sh.BH >= 1 && sh.BH % sh.H == 0 && sh.BH <= 65535 && sh.Sq >= 1 &&
         sh.Sk >= 1 && head_tile(sh.D) != 0;
}

// Returns fn<T, DT>(args...) for the call's dtype code and head tile.
#define EXO_FLASH_DISPATCH(fn, ...)                                   \
  do {                                                                \
    const int dt = head_tile(sh.D);                                   \
    if (dtype == 0) {                                                 \
      if (dt == 32) return fn<float, 32>(__VA_ARGS__);                \
      if (dt == 40) return fn<float, 40>(__VA_ARGS__);                \
      if (dt == 64) return fn<float, 64>(__VA_ARGS__);                \
      return fn<float, 128>(__VA_ARGS__);                             \
    }                                                                 \
    if (dtype == 1) {                                                 \
      if (dt == 32) return fn<__nv_bfloat16, 32>(__VA_ARGS__);        \
      if (dt == 40) return fn<__nv_bfloat16, 40>(__VA_ARGS__);        \
      if (dt == 64) return fn<__nv_bfloat16, 64>(__VA_ARGS__);        \
      return fn<__nv_bfloat16, 128>(__VA_ARGS__);                     \
    }                                                                 \
    return cudaErrorInvalidValue;                                     \
  } while (0)

}  // namespace

// q (BH, Sq, D) pre-scaled, k and v (BH, Sk, D) of one type (dtype 0:
// float32, 1: bfloat16), kpad (BH / H, Sk) int32; writes o (BH, Sq, D) in
// the input type and lse (BH, Sq) float32. All contiguous. D a multiple of
// 8 up to 128. Returns the CUDA error of the launch, or 0.
extern "C" int flash_attn_forward(const void* q, const void* k, const void* v, const void* kpad,
                                  void* o, void* lse, int BH, int H, int Sq, int Sk, int D,
                                  int dtype, void* stream) {
  const Shape sh{BH, H, Sq, Sk, D};
  if (!shape_ok(sh)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EXO_FLASH_DISPATCH(fwd, q, k, v, kpad, o, lse, sh, st);
}

// dq (BH, Sq, D) in the input type from the forward's inputs, the upstream
// grad dout (BH, Sq, D, input type), the forward's lse and delta = sum_d
// dout * o (BH, Sq) float32.
extern "C" int flash_attn_dq(const void* q, const void* k, const void* v, const void* kpad,
                             const void* dout, const void* lse, const void* delta, void* dq_out,
                             int BH, int H, int Sq, int Sk, int D, int dtype, void* stream) {
  const Shape sh{BH, H, Sq, Sk, D};
  if (!shape_ok(sh)) return cudaErrorInvalidValue;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EXO_FLASH_DISPATCH(dkv, q, k, v, kpad, dout, lse, delta, dk, dv, sh, st);
}
