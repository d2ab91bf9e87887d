// Fused transformer MLP: out = QuickGELU(x . c_fc^T + b_fc) . c_proj^T + b_proj.
//
// Replaces the TPU kernel exoground_tpu/ops/fused_mlp.py::_fused (pallas_call
// at :251, body _mlp_kernel + _mlp_tail). Weights arrive in torch layout:
// c_fc (4C, C), c_proj (C, 4C).
//
// What bounds it on an H100: operations. Per row it does 16*C^2 FLOPs against
// 2*C values in and out (C = 512: 4.2 MFLOP per 2 KB of bf16), far above the
// balance points of the tensor cores (~295 bf16 FLOP a byte) and the CUDA
// cores (~20 f32 FLOP a byte).
//
// Design: mlp_tile.cuh's tile with no prologue (kPlain), on the tensor
// cores: CTAs of 64 rows x <= 512 output columns, 8 warps of 32 x
// 128, the hidden in 128-column chunks through shared memory, two-slot
// cp.async rings, the x tile resident in bf16 at C <= 512; bfloat16 as
// mma.sync m16n8k16, float32 as 3xTF32 (float32 accuracy at 3 x FLOPs /
// 495 TFLOP/s rather than FLOPs / 67 on the CUDA cores). Accumulation, the
// bias and QuickGELU run in f32 for both types; for bfloat16 the hidden is
// rounded to bfloat16 before the second product, as the TPU kernel casts it
// to c_proj's type. Where the rows alone launch less than a wave, the
// wrapper's plan (ops/fused_mlp.py::mlp_launch_plan) splits the hidden over
// CTAs and fused_mlp_reduce_kernel sums their f32 partials in order.
#include <cstddef>
#include <cstdint>

#include "mlp_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using exo::mlp::kThreads;

template <typename T, int NS, bool XRES>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ wfc, const T* __restrict__ bfc,
                 const T* __restrict__ wpr, const T* __restrict__ bpr, T* __restrict__ out,
                 float* __restrict__ ws, int rows, int C) {
  exo::mlp::tile<exo::mlp::kPlain, T, NS, XRES>(x, nullptr, nullptr, wfc, nullptr, bfc, wpr,
                                                bpr, out, ws, rows, C);
}

// out = sum over z of ws[z] (in z order) + b_proj, rounded once to T
template <typename T>
__global__ void fused_mlp_reduce_kernel(const float* __restrict__ ws, const T* __restrict__ bpr,
                                        T* __restrict__ out, int rows, int C, int split) {
  exo::mlp::reduce<T>(ws, bpr, out, rows, C, split);
}

template <typename T, int NS, bool XRES>
cudaError_t launch(const void* x, const void* wfc, const void* bfc, const void* wpr,
                   const void* bpr, void* out, void* ws, int rows, int C, int split,
                   cudaStream_t st) {
  auto kernel = fused_mlp_kernel<T, NS, XRES>;
  const size_t smem = exo::mlp::Cfg<T, exo::mlp::kPlain, NS, XRES>::bytes(C);
  cudaError_t err = exo::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<exo::mlp::tile_grid(rows, C, NS, split), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wfc), static_cast<const T*>(bfc),
      static_cast<const T*>(wpr), static_cast<const T*>(bpr), static_cast<T*>(out),
      static_cast<float*>(ws), rows, C);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  fused_mlp_reduce_kernel<T><<<exo::mlp::reduce_blocks(rows, C), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const T*>(bpr), static_cast<T*>(out), rows, C,
      split);
  return cudaGetLastError();
}

template <typename T, bool XRES>
cudaError_t by_slab(int slab, const void* x, const void* wfc, const void* bfc, const void* wpr,
                    const void* bpr, void* out, void* ws, int rows, int C, int split,
                    cudaStream_t st) {
  return exo::mlp::by_slab(slab, [&](auto ns) {
    return launch<T, decltype(ns)::value, XRES>(x, wfc, bfc, wpr, bpr, out, ws, rows, C, split,
                                                st);
  });
}

}  // namespace

// x (rows, C), c_fc weight (4C, C) + bias (4C), c_proj weight (C, 4C) + bias
// (C), out (rows, C); all contiguous, of one type (dtype 0: float32,
// 1: bfloat16), x and both weights 16-byte aligned; C a positive multiple of
// 128. The plan: slab (output columns a CTA, 128, 256, 384 or 512) and
// split (CTAs over the hidden, a divisor of 4C / 128); with split > 1, ws is
// a float32 workspace of split * rows * C. Returns the CUDA error of the
// launches, or 0.
extern "C" int fused_mlp_forward(const void* x, const void* wfc, const void* bfc,
                                 const void* wpr, const void* bpr, void* out, void* ws,
                                 int rows, int C, int slab, int split, int dtype,
                                 void* stream) {
  if (!exo::mlp::plan_ok(rows, C, split, ws)) return cudaErrorInvalidValue;
  if (!exo::tc::aligned16(x) || !exo::tc::aligned16(wfc) || !exo::tc::aligned16(wpr)) {
    return cudaErrorMisalignedAddress;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return by_slab<float, false>(slab, x, wfc, bfc, wpr, bpr, out, ws, rows, C, split, st);
  }
  if (dtype == 1) {
    if (C <= 512) {
      return by_slab<bf16, true>(slab, x, wfc, bfc, wpr, bpr, out, ws, rows, C, split, st);
    }
    return by_slab<bf16, false>(slab, x, wfc, bfc, wpr, bpr, out, ws, rows, C, split, st);
  }
  return cudaErrorInvalidValue;
}
