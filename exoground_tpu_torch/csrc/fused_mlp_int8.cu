// Fused transformer MLP with an int8 c_fc (the int8 serving mode):
//   xq, xs = per-row int8 quantization of x (absmax / 127 over the row of C,
//            round half to even, clip to +-127), inside the kernel;
//   h   = QuickGELU(float(xq . c_fc_q^T) * xs * fcsc + b_fc)   (int32 sums, f32 after);
//   out = h . c_proj^T + b_proj                                 (exact).
//
// Replaces the TPU kernel exoground_tpu/ops/fused_mlp.py::fused_mlp_int8
// (:200, pallas_call :212, body _mlp_kernel_int8 :177 with _quant_rows_f32
// :108). c_fc arrives quantized per output row (torch layout (4C, C) int8,
// scales (4C) float32) by the wrapper's plain quantizer; b_fc, c_proj (C, 4C)
// and b_proj are of the input type.
//
// What bounds it on an H100: operations. Per row the int8 product is 8*C^2
// operations (1,979 TOPS on int8 tensor cores) and c_proj 8*C^2 FLOPs (f32 at
// 67 TFLOP/s, bf16 at 989), against 2*C values in and out. This first version
// runs both on the CUDA cores: the int8 product as __dp4a (4 multiply-adds an
// instruction, exact int32 sums), c_proj in f32.
//
// Design: fused_mlp.cu's (one CTA owns 32 rows and a slab of up to 512 output
// columns, walks the hidden in chunks of 64 columns kept in shared memory,
// accumulates the output in registers; the c_proj half is mlp_tail.cuh's),
// with only the c_fc phase changed:
//   1. a first pass takes each of the CTA's rows' absmax over the whole row
//      (one warp a row) into shared memory;
//   2. up to C = 4096 the x tile is quantized once into shared memory as
//      int8 (32 x C bytes); above it each K chunk is quantized again as it is
//      staged, with the same whole-row scales;
//   3. c_fc's int8 rows stream through shared memory as they are, in K chunks
//      of 128 values, and the product accumulates in int32 with __dp4a;
//   4. the epilogue float(acc) * xs * fcsc + b in f32, QuickGELU in f32, h
//      rounded to the input type (as the TPU kernel casts it to c_proj's).
// Shared memory at C = 512: ~49 KB.
#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "mlp_tail.cuh"

namespace {

constexpr int kThreads = exo::kMlpThreads;
constexpr int kRows = exo::kMlpRows;
constexpr int kHC = exo::kMlpHC;
constexpr int kKW = 32;              // K chunk in 4-byte words of int8 (128 values)
constexpr int kPC = exo::kMlpPC;
constexpr int kMaxResidentC = 4096;  // widths whose int8 x tile stays in shared memory

// NJ: output columns per thread (32*NJ per CTA); XRES: int8 x tile resident
template <int NJ, bool XRES>
struct MlpInt8Layout {
  static constexpr int NS = NJ * 32;  // output columns per CTA
  // int8 x words; row scales; c_fc chunk; hidden chunk; c_proj chunk (4-byte words)
  static size_t words(int C) {
    return size_t(kRows) * (XRES ? C / 4 : kKW) + kRows + kKW * (kHC + 1) +
           kRows * (kHC + 1) + kPC * (NS + 1);
  }
};

// CF: the width when it is fixed at compile time, else 0 and it is c_arg.
template <typename T, int NJ, bool XRES, int CF>
__global__ void __launch_bounds__(kThreads)
fused_mlp_int8_kernel(const T* __restrict__ x, const int* __restrict__ wfc,
                      const float* __restrict__ fcsc, const T* __restrict__ bfc,
                      const T* __restrict__ wpr, const T* __restrict__ bpr,
                      T* __restrict__ out, int rows, int c_arg) {
  constexpr int NS = MlpInt8Layout<NJ, XRES>::NS;
  const int C = CF ? CF : c_arg;
  const int HID = 4 * C;
  const int CW = C / 4;                // words of an int8 row
  const int XW = XRES ? CW : kKW;      // x row pitch in shared memory, words
  extern __shared__ float smem[];
  int* xq = reinterpret_cast<int*>(smem);               // [kRows][XW] int8 x words
  float* xsc = smem + kRows * XW;                       // [kRows] row scales
  int* ws = reinterpret_cast<int*>(xsc + kRows);        // [kKW][kHC + 1] c_fc words
  float* hs = reinterpret_cast<float*>(ws + kKW * (kHC + 1));  // [kRows][kHC + 1]
  float* ps = hs + kRows * (kHC + 1);                   // [kPC][NS + 1]

  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const size_t r0 = size_t(blockIdx.x) * kRows;
  const int n0 = blockIdx.y * NS;
  // ---- the scale of each row: absmax over the whole row of C ----
  for (int r = ty; r < kRows; r += kThreads / 32) {
    const float m = r0 + r < size_t(rows) ? exo::warp_absmax(x + (r0 + r) * C, C, tx) : 0.f;
    if (tx == 0) xsc[r] = exo::row_scale(m);
  }
  __syncthreads();
  if (XRES) {
    for (int e = tid; e < kRows * CW; e += kThreads) {
      const int r = e / CW, kw = e % CW;
      const size_t gr = r0 + r;
      xq[e] = gr < size_t(rows) ? exo::quant_pack4(x + gr * C + 4 * kw, xsc[r]) : 0;
    }
  }
  // thread (ty, tx) owns output rows ty + 8*i and columns n0 + tx + 32*j
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < HID; c0 += kHC) {
    // int32 h = xq . c_fc_q[c0 : c0 + kHC]^T; thread owns rows ty + 8*i, columns tx + 32*jj
    int hacc[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};
    for (int k0 = 0; k0 < CW; k0 += kKW) {
      if (!XRES) {
        for (int e = tid; e < kRows * kKW; e += kThreads) {
          const int r = e / kKW, kw = e % kKW;
          const size_t gr = r0 + r;
          xq[e] = gr < size_t(rows) ? exo::quant_pack4(x + gr * C + 4 * (k0 + kw), xsc[r])
                                    : 0;
        }
      }
      const int* xk = XRES ? xq + k0 : xq;  // word k0 of the tile
      for (int e = tid; e < kHC * kKW; e += kThreads) {
        const int c = e / kKW, kw = e % kKW;
        ws[kw * (kHC + 1) + c] = wfc[size_t(c0 + c) * CW + k0 + kw];
      }
      __syncthreads();
#pragma unroll 8
      for (int kw = 0; kw < kKW; ++kw) {
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
  exo::mlp_store<T, NJ>(acc, bpr, out, r0, rows, n0, C);
}

template <typename T, int NJ, bool XRES, int CF = 0>
cudaError_t launch(const void* x, const void* wfc, const void* fcsc, const void* bfc,
                   const void* wpr, const void* bpr, void* out, int rows, int C,
                   cudaStream_t st) {
  auto kernel = fused_mlp_int8_kernel<T, NJ, XRES, CF>;
  const size_t smem = MlpInt8Layout<NJ, XRES>::words(C) * 4;
  cudaError_t err = exo::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int NS = MlpInt8Layout<NJ, XRES>::NS;
  const dim3 grid((rows + kRows - 1) / kRows, (C + NS - 1) / NS);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int*>(wfc),
      static_cast<const float*>(fcsc), static_cast<const T*>(bfc),
      static_cast<const T*>(wpr), static_cast<const T*>(bpr), static_cast<T*>(out), rows, C);
  return cudaGetLastError();
}

// The output slab: every column up to C = 512 (one slab, no recompute),
// slabs of 512 above; the int8 x tile resident up to C = 4096, streamed
// above. The widths 128..512 in steps of 128 get their own instantiation.
template <typename T>
cudaError_t by_width(int C, const void* x, const void* wfc, const void* fcsc,
                     const void* bfc, const void* wpr, const void* bpr, void* out, int rows,
                     cudaStream_t st) {
  switch (C) {
    case 128: return launch<T, 4, true, 128>(x, wfc, fcsc, bfc, wpr, bpr, out, rows, C, st);
    case 256: return launch<T, 8, true, 256>(x, wfc, fcsc, bfc, wpr, bpr, out, rows, C, st);
    case 384: return launch<T, 12, true, 384>(x, wfc, fcsc, bfc, wpr, bpr, out, rows, C, st);
    case 512: return launch<T, 16, true, 512>(x, wfc, fcsc, bfc, wpr, bpr, out, rows, C, st);
    default: break;
  }
  if (C > kMaxResidentC) {
    return launch<T, 16, false>(x, wfc, fcsc, bfc, wpr, bpr, out, rows, C, st);
  }
  return launch<T, 16, true>(x, wfc, fcsc, bfc, wpr, bpr, out, rows, C, st);
}

}  // namespace

// x (rows, C), c_fc quantized per row: wfc (4C, C) int8 + fcsc (4C) float32,
// b_fc (4C), c_proj weight (C, 4C) + bias (C), out (rows, C); all contiguous;
// x, b_fc, c_proj and out of one type (dtype 0: float32, 1: bfloat16); C a
// positive multiple of 128. Returns the CUDA error of the launch, or 0.
extern "C" int fused_mlp_int8_forward(const void* x, const void* wfc, const void* fcsc,
                                      const void* bfc, const void* wpr, const void* bpr,
                                      void* out, int rows, int C, int dtype, void* stream) {
  if (rows < 1 || C < 128 || C % 128 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_width<float>(C, x, wfc, fcsc, bfc, wpr, bpr, out, rows, st);
  if (dtype == 1) {
    return by_width<__nv_bfloat16>(C, x, wfc, fcsc, bfc, wpr, bpr, out, rows, st);
  }
  return cudaErrorInvalidValue;
}
