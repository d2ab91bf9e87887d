// Fused transformer MLP: out = QuickGELU(x . c_fc^T + b_fc) . c_proj^T + b_proj.
//
// Replaces the TPU kernel exoground_tpu/ops/fused_mlp.py::_fused (pallas_call
// at :251, body _mlp_kernel + _mlp_tail). Weights arrive in torch layout:
// c_fc (4C, C), c_proj (C, 4C).
//
// What bounds it on an H100: operations. Per row it does 16*C^2 FLOPs against
// 2*C values in and out (C=512: 4.2 MFLOP per 4 KB of f32), far above the
// card's ~20 f32 FLOP/byte balance point; this first version runs on the CUDA
// cores in f32 (no tensor cores).
//
// Design. The point of the kernel is that the (rows, 4C) hidden activation
// never reaches device memory. The TPU kernel keeps a (256, 4C) f32 hidden and
// both weights in VMEM; on Hopper a block has 227 KB of shared memory, so one
// CTA owns 32 rows and a slab of up to 512 output columns, and walks the
// hidden dimension in chunks of 64 columns:
//   h = QuickGELU(x_tile . c_fc[chunk]^T + b)   -> shared memory (32 x 64 f32)
//   acc += h . c_proj[slab, chunk]^T            -> registers (32 x slab f32)
// Up to C=1024 the x tile (32 x C) stays in shared memory for the whole walk;
// above it x streams through in K chunks of 32 like c_fc, so the footprint
// stops growing with C and any width that is a multiple of 128 runs. c_fc and
// c_proj stream through shared memory in small chunks (each CTA reads both
// weights once, from L2 after the first CTAs). The accumulator is split over
// 256 threads: slab/8 floats each (64 at C=512). Up to C=512 one slab covers
// every column and nothing is computed twice; above it the hidden is recomputed once per 512-column slab
// (ceil(C/512) times), the price of keeping the accumulator in registers.
// Shared memory at C=512: ~99 KB, two CTAs per SM.
// Accumulation and the GELU are f32 for float32 and bfloat16 inputs; for
// bfloat16 the hidden is rounded to bfloat16 before the second product, as the
// TPU kernel casts it to c_proj's type.
#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // rows of x per CTA
constexpr int kHC = 64;    // hidden columns per chunk
constexpr int kKC = 32;    // K chunk of x and c_fc staged through shared memory
constexpr int kPC = 8;     // hidden sub-chunk of c_proj staged through shared memory
constexpr int kMaxResidentC = 1024;  // widths whose x tile stays in shared memory

// NJ: output columns per thread (32*NJ per CTA); XRES: x tile resident, else streamed
template <int NJ, bool XRES>
struct MlpLayout {
  static constexpr int NS = NJ * 32;  // output columns per CTA
  static size_t floats(int C) {
    return size_t(kRows) * (XRES ? C : kKC) + kKC * (kHC + 1) + kRows * (kHC + 1) +
           kPC * (NS + 1);
  }
};

// CF: the width when it is fixed at compile time (the common widths, whose
// loop bounds and index math then fold), else 0 and the width is c_arg.
template <typename T, int NJ, bool XRES, int CF>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ wfc,
                 const T* __restrict__ bfc, const T* __restrict__ wpr,
                 const T* __restrict__ bpr, T* __restrict__ out, int rows, int c_arg) {
  constexpr int NS = MlpLayout<NJ, XRES>::NS;
  const int C = CF ? CF : c_arg;
  const int HID = 4 * C;
  const int XW = XRES ? C : kKC;       // x row pitch in shared memory
  extern __shared__ float smem[];
  float* xs = smem;                    // [kRows][XW], x tile or x chunk
  float* ws = xs + kRows * XW;         // [kKC][kHC + 1], c_fc chunk transposed
  float* hs = ws + kKC * (kHC + 1);    // [kRows][kHC + 1], hidden chunk
  float* ps = hs + kRows * (kHC + 1);  // [kPC][NS + 1], c_proj chunk transposed

  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const size_t r0 = size_t(blockIdx.x) * kRows;
  const int n0 = blockIdx.y * NS;
  if (XRES) {
    for (int e = tid; e < kRows * C; e += kThreads) {
      const size_t r = r0 + e / C;
      xs[e] = r < size_t(rows) ? exo::to_f(x[r * C + e % C]) : 0.f;
    }
  }
  // thread (ty, tx) owns output rows ty + 8*i and columns n0 + tx + 32*j
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < HID; c0 += kHC) {
    // h = x . c_fc[c0 : c0 + kHC]^T; thread owns rows ty + 8*i, columns tx + 32*jj
    float hacc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int k0 = 0; k0 < C; k0 += kKC) {
      if (!XRES) {
        for (int e = tid; e < kRows * kKC; e += kThreads) {
          const size_t r = r0 + e / kKC;
          xs[e] = r < size_t(rows) ? exo::to_f(x[r * C + k0 + e % kKC]) : 0.f;
        }
      }
      const float* xk = XRES ? xs + k0 : xs;  // column k0 of the tile
      for (int e = tid; e < kHC * kKC; e += kThreads) {
        const int c = e / kKC, kk = e % kKC;
        ws[kk * (kHC + 1) + c] = exo::to_f(wfc[size_t(c0 + c) * C + k0 + kk]);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float w0 = ws[kk * (kHC + 1) + tx], w1 = ws[kk * (kHC + 1) + tx + 32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = xk[(ty + 8 * i) * XW + kk];
          hacc[i][0] = fmaf(a, w0, hacc[i][0]);
          hacc[i][1] = fmaf(a, w1, hacc[i][1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = tx + 32 * jj;
        float h = hacc[i][jj] + exo::to_f(bfc[c0 + c]);
        h = h / (1.f + expf(-1.702f * h));  // QuickGELU: h * sigmoid(1.702 h)
        hs[(ty + 8 * i) * (kHC + 1) + c] = exo::to_f(exo::from_f<T>(h));
      }
    __syncthreads();

    // acc += h . c_proj[n0 : n0 + NS, c0 : c0 + kHC]^T (columns past C read 0)
    for (int p0 = 0; p0 < kHC; p0 += kPC) {
      for (int e = tid; e < NS * kPC; e += kThreads) {
        const int n = e / kPC, pp = e % kPC;
        ps[pp * (NS + 1) + n] =
            n0 + n < C ? exo::to_f(wpr[size_t(n0 + n) * HID + c0 + p0 + pp]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int pp = 0; pp < kPC; ++pp) {
        float hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) hv[i] = hs[(ty + 8 * i) * (kHC + 1) + p0 + pp];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float w = ps[pp * (NS + 1) + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(hv[i], w, acc[i][j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = r0 + ty + 8 * i;
    if (r >= size_t(rows)) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = n0 + tx + 32 * j;
      if (n < C) out[r * C + n] = exo::from_f<T>(acc[i][j] + exo::to_f(bpr[n]));
    }
  }
}

template <typename T, int NJ, bool XRES, int CF = 0>
cudaError_t launch(const void* x, const void* wfc, const void* bfc, const void* wpr,
                   const void* bpr, void* out, int rows, int C, cudaStream_t st) {
  auto kernel = fused_mlp_kernel<T, NJ, XRES, CF>;
  const size_t smem = MlpLayout<NJ, XRES>::floats(C) * sizeof(float);
  cudaError_t err = exo::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int NS = MlpLayout<NJ, XRES>::NS;
  const dim3 grid((rows + kRows - 1) / kRows, (C + NS - 1) / NS);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wfc), static_cast<const T*>(bfc),
      static_cast<const T*>(wpr), static_cast<const T*>(bpr), static_cast<T*>(out), rows,
      C);
  return cudaGetLastError();
}

// The output slab: every column up to C=512 (one slab, no recompute),
// slabs of 512 above; x resident up to C=1024, streamed above. The widths
// 128..512 in steps of 128 get their own instantiation with C fixed.
template <typename T>
cudaError_t by_width(int C, const void* x, const void* wfc, const void* bfc,
                     const void* wpr, const void* bpr, void* out, int rows,
                     cudaStream_t st) {
  switch (C) {
    case 128: return launch<T, 4, true, 128>(x, wfc, bfc, wpr, bpr, out, rows, C, st);
    case 256: return launch<T, 8, true, 256>(x, wfc, bfc, wpr, bpr, out, rows, C, st);
    case 384: return launch<T, 12, true, 384>(x, wfc, bfc, wpr, bpr, out, rows, C, st);
    case 512: return launch<T, 16, true, 512>(x, wfc, bfc, wpr, bpr, out, rows, C, st);
    default: break;
  }
  if (C > kMaxResidentC) return launch<T, 16, false>(x, wfc, bfc, wpr, bpr, out, rows, C, st);
  return launch<T, 16, true>(x, wfc, bfc, wpr, bpr, out, rows, C, st);
}

}  // namespace

// x (rows, C), c_fc weight (4C, C) + bias (4C), c_proj weight (C, 4C) + bias
// (C), out (rows, C); all contiguous, of one type (dtype 0: float32,
// 1: bfloat16); C a positive multiple of 128. Returns the CUDA error of the
// launch, or 0.
extern "C" int fused_mlp_forward(const void* x, const void* wfc, const void* bfc,
                                 const void* wpr, const void* bpr, void* out, int rows,
                                 int C, int dtype, void* stream) {
  if (rows < 1 || C < 128 || C % 128 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_width<float>(C, x, wfc, bfc, wpr, bpr, out, rows, st);
  if (dtype == 1) return by_width<__nv_bfloat16>(C, x, wfc, bfc, wpr, bpr, out, rows, st);
  return cudaErrorInvalidValue;
}
