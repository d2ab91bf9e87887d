// Fused transformer MLP with an int8 c_fc (the int8 serving mode):
//   xq, xs = per-row int8 quantization of x (absmax / 127 over the row of C,
//            round half to even, clip to +-127), inside the kernel;
//   h   = QuickGELU(float(xq . c_fc_q^T) * xs * fcsc + b_fc)   (int32 sums, f32 after);
//   out = h . c_proj^T + b_proj                                 (exact).
//
// Replaces the TPU kernel exoground_tpu/ops/fused_mlp.py::fused_mlp_int8
// (:200, pallas_call :212, body _mlp_kernel_int8 :177 with _quant_rows_f32
// :108). c_fc arrives quantized per output row (torch layout (4C, C) int8,
// scales (4C) float32) by the wrapper's cached plain quantizer
// (ops/quant.py::quantized_weight); b_fc, c_proj (C, 4C) and b_proj are of
// the input type.
//
// What bounds it on an H100: operations. Per row the int8 product is 8*C^2
// operations (1,979 TOPS on the int8 tensor cores) and c_proj 8*C^2 FLOPs
// (bf16 at 989 TFLOP/s; f32 at 67 on the CUDA cores or 3 x FLOPs / 495 in
// 3xTF32), against 2*C values in and out.
//
// Design: mlp_tile.cuh's tile (the fused MLP's) with the kQuant
// prologue. Each CTA takes its 64 rows' absmax over the whole row, then
// quantizes x once into a resident 64 x C int8 tile (C <= 512; above it each
// staged K chunk, with the same whole-row scales). c_fc runs as mma.sync
// m16n8k32 .s8 (exact int32 sums) from ldmatrix on the int8 tiles; the C
// fragments are dequantized in the plain version's order, then QuickGELU in
// f32 and the rounding to c_proj's type, and c_proj runs exact (bf16
// mma.sync, f32 3xTF32). The sources build without fast math, so the scales
// are IEEE quotients and x quantizes bit for bit as quant._quant_last_axis.
#include <cstddef>
#include <cstdint>

#include "mlp_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using exo::mlp::kThreads;

template <typename T, int NS, bool XRES>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ wfc,
                      const float* __restrict__ fcsc, const T* __restrict__ bfc,
                      const T* __restrict__ wpr, const T* __restrict__ bpr, T* __restrict__ out,
                      float* __restrict__ ws, int rows, int C) {
  exo::mlp::tile<exo::mlp::kQuant, T, NS, XRES>(x, nullptr, nullptr, wfc, fcsc, bfc, wpr, bpr,
                                                out, ws, rows, C);
}

// out = sum over z of ws[z] (in z order) + b_proj, rounded once to T
template <typename T>
__global__ void fused_mlp_int8_reduce_kernel(const float* __restrict__ ws,
                                             const T* __restrict__ bpr, T* __restrict__ out,
                                             int rows, int C, int split) {
  exo::mlp::reduce<T>(ws, bpr, out, rows, C, split);
}

template <typename T, int NS, bool XRES>
cudaError_t launch(const void* x, const void* wfc, const void* fcsc, const void* bfc,
                   const void* wpr, const void* bpr, void* out, void* ws, int rows, int C,
                   int split, cudaStream_t st) {
  auto kernel = fused_mlp_int8_kernel<T, NS, XRES>;
  const size_t smem = exo::mlp::Cfg<T, exo::mlp::kQuant, NS, XRES>::bytes(C);
  cudaError_t err = exo::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<exo::mlp::tile_grid(rows, C, NS, split), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wfc),
      static_cast<const float*>(fcsc), static_cast<const T*>(bfc), static_cast<const T*>(wpr),
      static_cast<const T*>(bpr), static_cast<T*>(out), static_cast<float*>(ws), rows, C);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  fused_mlp_int8_reduce_kernel<T><<<exo::mlp::reduce_blocks(rows, C), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const T*>(bpr), static_cast<T*>(out), rows, C,
      split);
  return cudaGetLastError();
}

// The int8 x tile resident up to C = 512 (one slab of C columns), streamed
// above (slabs of 512).
template <typename T>
cudaError_t by_width(int slab, const void* x, const void* wfc, const void* fcsc,
                     const void* bfc, const void* wpr, const void* bpr, void* out, void* ws,
                     int rows, int C, int split, cudaStream_t st) {
  if (C <= 512) {
    return exo::mlp::by_slab(slab, [&](auto ns) {
      return launch<T, decltype(ns)::value, true>(x, wfc, fcsc, bfc, wpr, bpr, out, ws, rows, C,
                                                  split, st);
    });
  }
  if (slab != 512) return cudaErrorInvalidValue;
  return launch<T, 512, false>(x, wfc, fcsc, bfc, wpr, bpr, out, ws, rows, C, split, st);
}

}  // namespace

// x (rows, C), c_fc quantized per row: wfc (4C, C) int8 + fcsc (4C) float32,
// b_fc (4C), c_proj weight (C, 4C) + bias (C), out (rows, C); all contiguous;
// x, b_fc, c_proj and out of one type (dtype 0: float32, 1: bfloat16); wfc
// and c_proj 16-byte aligned; C a positive multiple of 128. The plan, as
// fused_mlp_forward's: slab (C up to 512, else 512) and split, with a float32
// workspace ws of split * rows * C where split > 1. Returns the CUDA error of
// the launches, or 0.
extern "C" int fused_mlp_int8_forward(const void* x, const void* wfc, const void* fcsc,
                                      const void* bfc, const void* wpr, const void* bpr,
                                      void* out, void* ws, int rows, int C, int slab, int split,
                                      int dtype, void* stream) {
  if (!exo::mlp::plan_ok(rows, C, split, ws)) return cudaErrorInvalidValue;
  if (!exo::tc::aligned16(wfc) || !exo::tc::aligned16(wpr)) return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return by_width<float>(slab, x, wfc, fcsc, bfc, wpr, bpr, out, ws, rows, C, split, st);
  }
  if (dtype == 1) {
    return by_width<bf16>(slab, x, wfc, fcsc, bfc, wpr, bpr, out, ws, rows, C, split, st);
  }
  return cudaErrorInvalidValue;
}
