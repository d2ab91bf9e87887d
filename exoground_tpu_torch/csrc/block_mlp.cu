// The second half of a pre-LN residual block:
//   out = x + QuickGELU(LN_2(x) . c_fc^T + b_fc) . c_proj^T + b_proj,
// the LayerNorm in f32 (eps 1e-5) and the residual summed in f32, rounded once.
//
// Replaces the TPU kernels of exoground_tpu/ops/fused_mlp.py::_block_fused /
// fused_block_mlp (:336, :359; pallas_call in _block_mlp_pallas :314):
//   _block_mlp_kernel (:149): h = round_T(xn) . c_fc + b (f32 sums);
//   _block_mlp_kernel_int8 (:159): h = float(quant(xn) . c_fc_q) * xs * fcsc + b,
//     the unrounded f32 xn quantized per row (absmax / 127 over the row of C,
//     round half to even, clip to +-127), c_fc quantized per output row by the
//     wrapper's plain quantizer;
// then QuickGELU in f32, h rounded to c_proj's type, and the c_proj product
// with the bias and the residual x (_mlp_tail :133 with residual=True).
// Weights arrive in torch layout: c_fc (4C, C), c_proj (C, 4C).
//
// What bounds it on an H100: operations. Per row 16*C^2 FLOPs (the int8 body:
// 8*C^2 int8 operations and 8*C^2 FLOPs) against 2*C values in and out. This
// first version runs every product on the CUDA cores (f32 FMAs, __dp4a).
//
// Design: fused_mlp.cu's and fused_mlp_int8.cu's (one CTA owns 32 rows and a
// slab of up to 512 output columns, walks the hidden in chunks of 64 columns
// kept in shared memory and accumulates the output in registers; the c_proj
// half is mlp_tail.cuh's), with an LN prologue and a residual epilogue:
//   1. a first pass takes each of the CTA's rows' mean and rstd (one warp a
//      row, two passes over the row; the int8 body also the absmax of the f32
//      xn row, a third pass) into shared memory;
//   2. exact body: up to C = 1024 the x tile is normalized once into shared
//      memory (rounded to x's type, as the TPU kernel casts it to c_fc's
//      type); above it each K chunk is normalized as it is staged, from the
//      same statistics. int8 body: up to C = 4096 the f32 xn tile is
//      quantized once into shared memory (32 x C bytes); above it each K
//      chunk is quantized as it is staged, with the same whole-row scales;
//   3. mlp_store adds b_proj and the residual x in f32 and rounds once.
// The LayerNorm output never reaches device memory, nor does the hidden.
// The sources build without fast math (IEEE root, quotients and int8 scales).
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "mlp_tail.cuh"

namespace {

constexpr int kThreads = exo::kMlpThreads;
constexpr int kRows = exo::kMlpRows;
constexpr int kHC = exo::kMlpHC;
constexpr int kKC = 32;  // K chunk: 32 f32 values (exact) or 32 words of int8 (int8)
constexpr int kPC = exo::kMlpPC;
constexpr int kMaxResidentC = 1024;      // exact: widths whose xn tile stays in shared memory
constexpr int kMaxResidentInt8C = 4096;  // int8: widths whose int8 xn tile stays resident

// NJ: output columns per thread (32*NJ per CTA); XRES: xn tile resident.
// xn tile or chunk (f32 values or int8 words); the int8 row scales (int8
// body); c_fc chunk; hidden chunk; c_proj chunk; row mean and rstd (4-byte
// words).
template <int NJ, bool XRES, bool INT8>
struct BlockMlpLayout {
  static constexpr int NS = NJ * 32;  // output columns per CTA
  static size_t words(int C) {
    const int xw = XRES ? (INT8 ? C / 4 : C) : kKC;
    return size_t(kRows) * xw + (INT8 ? kRows : 0) + kKC * (kHC + 1) + kRows * (kHC + 1) +
           kPC * (NS + 1) + 2 * kRows;
  }
};

// The f32 LayerNorm output of x[r, k] (r the CTA row, its statistics in mu, rs)
template <typename T>
__device__ __forceinline__ float ln_at(const T* x, const T* lnw, const T* lnb,
                                       const float* mu, const float* rs, size_t gr, int r,
                                       int k, int C) {
  return exo::ln_apply(exo::to_f(x[gr * C + k]), mu[r], rs[r], exo::to_f(lnw[k]),
                       exo::to_f(lnb[k]));
}

// CF: the width when it is fixed at compile time, else 0 and it is c_arg.
template <typename T, int NJ, bool XRES, int CF>
__global__ void __launch_bounds__(kThreads)
block_mlp_kernel(const T* __restrict__ x, const T* __restrict__ lnw,
                 const T* __restrict__ lnb, const T* __restrict__ wfc,
                 const T* __restrict__ bfc, const T* __restrict__ wpr,
                 const T* __restrict__ bpr, T* __restrict__ out, int rows, int c_arg) {
  using L = BlockMlpLayout<NJ, XRES, false>;
  const int C = CF ? CF : c_arg;
  const int HID = 4 * C;
  const int XW = XRES ? C : kKC;       // xn row pitch in shared memory
  extern __shared__ float smem[];
  float* xs = smem;                    // [kRows][XW], xn tile or chunk
  float* ws = xs + kRows * XW;         // [kKC][kHC + 1], c_fc chunk transposed
  float* hs = ws + kKC * (kHC + 1);    // [kRows][kHC + 1], hidden chunk
  float* ps = hs + kRows * (kHC + 1);  // [kPC][NS + 1], c_proj chunk transposed
  float* mu = ps + kPC * (L::NS + 1);  // [kRows] row mean
  float* rs = mu + kRows;              // [kRows] row rstd

  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const size_t r0 = size_t(blockIdx.x) * kRows;
  const int n0 = blockIdx.y * L::NS;
  // ---- LN statistics of the CTA's rows, one warp a row ----
  for (int r = ty; r < kRows; r += kThreads / 32) {
    float m = 0.f, rstd = 0.f;
    if (r0 + r < size_t(rows)) exo::warp_ln_stats(x + (r0 + r) * C, C, tx, m, rstd);
    if (tx == 0) {
      mu[r] = m;
      rs[r] = rstd;
    }
  }
  __syncthreads();
  if (XRES) {
    for (int e = tid; e < kRows * C; e += kThreads) {
      const int r = e / C, k = e % C;
      const float v = r0 + r < size_t(rows) ? ln_at(x, lnw, lnb, mu, rs, r0 + r, r, k, C) : 0.f;
      xs[e] = exo::to_f(exo::from_f<T>(v));  // xn rounded to c_fc's type
    }
  }
  // thread (ty, tx) owns output rows ty + 8*i and columns n0 + tx + 32*j
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < HID; c0 += kHC) {
    // h = xn . c_fc[c0 : c0 + kHC]^T; thread owns rows ty + 8*i, columns tx + 32*jj
    float hacc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int k0 = 0; k0 < C; k0 += kKC) {
      if (!XRES) {
        for (int e = tid; e < kRows * kKC; e += kThreads) {
          const int r = e / kKC, k = k0 + e % kKC;
          const float v =
              r0 + r < size_t(rows) ? ln_at(x, lnw, lnb, mu, rs, r0 + r, r, k, C) : 0.f;
          xs[e] = exo::to_f(exo::from_f<T>(v));
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

    exo::mlp_c_proj_chunk<T, NJ>(hs, ps, wpr, acc, n0, c0, C);
  }
  exo::mlp_store<T, NJ>(acc, bpr, out, r0, rows, n0, C, x);
}

template <typename T, int NJ, bool XRES, int CF>
__global__ void __launch_bounds__(kThreads)
block_mlp_int8_kernel(const T* __restrict__ x, const T* __restrict__ lnw,
                      const T* __restrict__ lnb, const int* __restrict__ wfc,
                      const float* __restrict__ fcsc, const T* __restrict__ bfc,
                      const T* __restrict__ wpr, const T* __restrict__ bpr,
                      T* __restrict__ out, int rows, int c_arg) {
  using L = BlockMlpLayout<NJ, XRES, true>;
  const int C = CF ? CF : c_arg;
  const int HID = 4 * C;
  const int CW = C / 4;            // words of an int8 row
  const int XW = XRES ? CW : kKC;  // xn row pitch in shared memory, words
  extern __shared__ float smem[];
  int* xq = reinterpret_cast<int*>(smem);                      // [kRows][XW] int8 xn words
  float* xsc = smem + kRows * XW;                              // [kRows] row scales
  int* ws = reinterpret_cast<int*>(xsc + kRows);               // [kKC][kHC + 1] c_fc words
  float* hs = reinterpret_cast<float*>(ws + kKC * (kHC + 1));  // [kRows][kHC + 1]
  float* ps = hs + kRows * (kHC + 1);                          // [kPC][NS + 1]
  float* mu = ps + kPC * (L::NS + 1);                          // [kRows] row mean
  float* rs = mu + kRows;                                      // [kRows] row rstd

  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const size_t r0 = size_t(blockIdx.x) * kRows;
  const int n0 = blockIdx.y * L::NS;
  // ---- LN statistics and the int8 scale of each row's f32 xn ----
  for (int r = ty; r < kRows; r += kThreads / 32) {
    float m = 0.f, rstd = 0.f, am = 0.f;
    if (r0 + r < size_t(rows)) {
      const T* row = x + (r0 + r) * C;
      exo::warp_ln_stats(row, C, tx, m, rstd);
      am = exo::warp_ln_absmax(row, lnw, lnb, C, tx, m, rstd);
    }
    if (tx == 0) {
      mu[r] = m;
      rs[r] = rstd;
      xsc[r] = exo::row_scale(am);
    }
  }
  __syncthreads();
  if (XRES) {
    for (int e = tid; e < kRows * CW; e += kThreads) {
      const int r = e / CW, k = 4 * (e % CW);
      const size_t gr = r0 + r;
      xq[e] = gr < size_t(rows) ? exo::ln_quant_pack4(x + gr * C + k, lnw + k, lnb + k, mu[r],
                                                      rs[r], xsc[r])
                                : 0;
    }
  }
  // thread (ty, tx) owns output rows ty + 8*i and columns n0 + tx + 32*j
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < HID; c0 += kHC) {
    // int32 h = quant(xn) . c_fc_q[c0 : c0 + kHC]^T
    int hacc[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
    for (int k0 = 0; k0 < CW; k0 += kKC) {
      if (!XRES) {
        for (int e = tid; e < kRows * kKC; e += kThreads) {
          const int r = e / kKC, k = 4 * (k0 + e % kKC);
          const size_t gr = r0 + r;
          xq[e] = gr < size_t(rows) ? exo::ln_quant_pack4(x + gr * C + k, lnw + k, lnb + k,
                                                          mu[r], rs[r], xsc[r])
                                    : 0;
        }
      }
      const int* xk = XRES ? xq + k0 : xq;  // word k0 of the tile
      for (int e = tid; e < kHC * kKC; e += kThreads) {
        const int c = e / kKC, kw = e % kKC;
        ws[kw * (kHC + 1) + c] = wfc[size_t(c0 + c) * CW + k0 + kw];
      }
      __syncthreads();
#pragma unroll 8
      for (int kw = 0; kw < kKC; ++kw) {
        const int w0 = ws[kw * (kHC + 1) + tx], w1 = ws[kw * (kHC + 1) + tx + 32];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int a = xk[(ty + 8 * i) * XW + kw];
          hacc[i][0] = __dp4a(a, w0, hacc[i][0]);
          hacc[i][1] = __dp4a(a, w1, hacc[i][1]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = tx + 32 * jj, r = ty + 8 * i;
        float h = exo::dequant(hacc[i][jj], xsc[r], fcsc[c0 + c], exo::to_f(bfc[c0 + c]));
        h = h / (1.f + expf(-1.702f * h));  // QuickGELU: h * sigmoid(1.702 h)
        hs[r * (kHC + 1) + c] = exo::to_f(exo::from_f<T>(h));
      }
    __syncthreads();

    exo::mlp_c_proj_chunk<T, NJ>(hs, ps, wpr, acc, n0, c0, C);
  }
  exo::mlp_store<T, NJ>(acc, bpr, out, r0, rows, n0, C, x);
}

// The arguments of one launch: wfc is the T weight (exact body) or the int8
// weight with its per-row scales fcsc (int8 body).
struct BlockMlpArgs {
  const void *x, *lnw, *lnb, *wfc;
  const float* fcsc;
  const void *bfc, *wpr, *bpr;
  void* out;
  int rows, C;
};

template <typename T, bool INT8, int NJ, bool XRES, int CF = 0>
cudaError_t launch(const BlockMlpArgs& a, cudaStream_t st) {
  using L = BlockMlpLayout<NJ, XRES, INT8>;
  const size_t smem = L::words(a.C) * 4;
  const dim3 grid((a.rows + kRows - 1) / kRows, (a.C + L::NS - 1) / L::NS);
  const T* x = static_cast<const T*>(a.x);
  const T* lnw = static_cast<const T*>(a.lnw);
  const T* lnb = static_cast<const T*>(a.lnb);
  const T* bfc = static_cast<const T*>(a.bfc);
  const T* wpr = static_cast<const T*>(a.wpr);
  const T* bpr = static_cast<const T*>(a.bpr);
  T* out = static_cast<T*>(a.out);
  if constexpr (INT8) {
    auto kernel = block_mlp_int8_kernel<T, NJ, XRES, CF>;
    cudaError_t err = exo::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(x, lnw, lnb, static_cast<const int*>(a.wfc), a.fcsc,
                                         bfc, wpr, bpr, out, a.rows, a.C);
  } else {
    auto kernel = block_mlp_kernel<T, NJ, XRES, CF>;
    cudaError_t err = exo::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(x, lnw, lnb, static_cast<const T*>(a.wfc), bfc, wpr,
                                         bpr, out, a.rows, a.C);
  }
  return cudaGetLastError();
}

// The output slab: every column up to C = 512 (one slab, no recompute),
// slabs of 512 above; the xn tile resident up to C = 1024 (exact) or 4096
// (int8), streamed above. The widths 128..512 in steps of 128 get their own
// instantiation with C fixed.
template <typename T, bool INT8>
cudaError_t by_width(const BlockMlpArgs& a, cudaStream_t st) {
  switch (a.C) {
    case 128: return launch<T, INT8, 4, true, 128>(a, st);
    case 256: return launch<T, INT8, 8, true, 256>(a, st);
    case 384: return launch<T, INT8, 12, true, 384>(a, st);
    case 512: return launch<T, INT8, 16, true, 512>(a, st);
    default: break;
  }
  if (a.C > (INT8 ? kMaxResidentInt8C : kMaxResidentC)) return launch<T, INT8, 16, false>(a, st);
  return launch<T, INT8, 16, true>(a, st);
}

template <bool INT8>
int dispatch(const BlockMlpArgs& a, int dtype, void* stream) {
  if (a.rows < 1 || a.C < 128 || a.C % 128 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_width<float, INT8>(a, st);
  if (dtype == 1) return by_width<__nv_bfloat16, INT8>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (rows, C), ln_w and ln_b (C), c_fc weight (4C, C) + bias (4C), c_proj
// weight (C, 4C) + bias (C), out (rows, C); all contiguous, of one type
// (dtype 0: float32, 1: bfloat16); C a positive multiple of 128. Returns the
// CUDA error of the launch, or 0.
extern "C" int block_mlp_forward(const void* x, const void* ln_w, const void* ln_b,
                                 const void* wfc, const void* bfc, const void* wpr,
                                 const void* bpr, void* out, int rows, int C, int dtype,
                                 void* stream) {
  const BlockMlpArgs a{x, ln_w, ln_b, wfc, nullptr, bfc, wpr, bpr, out, rows, C};
  return dispatch<false>(a, dtype, stream);
}

// As block_mlp_forward, with c_fc quantized per row: wfc (4C, C) int8 and
// fcsc (4C) float32.
extern "C" int block_mlp_int8_forward(const void* x, const void* ln_w, const void* ln_b,
                                      const void* wfc, const void* fcsc, const void* bfc,
                                      const void* wpr, const void* bpr, void* out, int rows,
                                      int C, int dtype, void* stream) {
  const BlockMlpArgs a{x, ln_w, ln_b, wfc, static_cast<const float*>(fcsc), bfc, wpr, bpr,
                       out, rows, C};
  return dispatch<true>(a, dtype, stream);
}
