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
//     wrapper's cached plain quantizer (ops/quant.py::quantized_weight);
// then QuickGELU in f32, h rounded to c_proj's type, and the c_proj product
// with the bias and the residual x (_mlp_tail :133 with residual=True).
// Weights arrive in torch layout: c_fc (4C, C), c_proj (C, 4C).
//
// What bounds it on an H100: operations. Per row 16*C^2 FLOPs (the int8 body:
// 8*C^2 int8 operations and 8*C^2 FLOPs) against 2*C values in and out.
//
// Design: mlp_tile.cuh's tile (the fused MLP's) with an LN prologue
// and the residual epilogue. Each CTA takes its 64 rows' LN mean and rstd
// over the whole row (and, in the int8 body, the absmax of the f32 xn), then:
//   exact body (kLn): x lands by cp.async and is normalized in place, rounded
//     to x's type: the resident bf16 tile once (C <= 512), else each staged K
//     chunk as it lands (f32 always streams x); c_fc as in the fused MLP
//     (bf16 mma.sync m16n8k16; f32 3xTF32);
//   int8 body (kLnQuant): the f32 xn is quantized with the whole-row scales
//     into a resident int8 tile (C <= 512; else each staged K chunk), c_fc as
//     mma.sync m16n8k32 .s8, dequantized in the plain version's order.
// c_proj runs exact in both (bf16 mma.sync, f32 3xTF32); b_proj and the
// residual x are added in f32 before the one rounding, in the kernel or, where
// the plan splits the hidden over CTAs, in block_mlp_reduce_kernel. The
// LayerNorm output never reaches device memory, nor does the hidden. The
// sources build without fast math (IEEE root, quotients and int8 scales).
#include <cstddef>
#include <cstdint>

#include "mlp_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using exo::mlp::kLn;
using exo::mlp::kLnQuant;
using exo::mlp::kThreads;

template <typename T, int NS, bool XRES>
__global__ void __launch_bounds__(kThreads, 1)
block_mlp_kernel(const T* __restrict__ x, const T* __restrict__ lnw, const T* __restrict__ lnb,
                 const T* __restrict__ wfc, const T* __restrict__ bfc,
                 const T* __restrict__ wpr, const T* __restrict__ bpr, T* __restrict__ out,
                 float* __restrict__ ws, int rows, int C) {
  exo::mlp::tile<kLn, T, NS, XRES>(x, lnw, lnb, wfc, nullptr, bfc, wpr, bpr, out, ws, rows, C);
}

template <typename T, int NS, bool XRES>
__global__ void __launch_bounds__(kThreads, 1)
block_mlp_int8_kernel(const T* __restrict__ x, const T* __restrict__ lnw,
                      const T* __restrict__ lnb, const int8_t* __restrict__ wfc,
                      const float* __restrict__ fcsc, const T* __restrict__ bfc,
                      const T* __restrict__ wpr, const T* __restrict__ bpr, T* __restrict__ out,
                      float* __restrict__ ws, int rows, int C) {
  exo::mlp::tile<kLnQuant, T, NS, XRES>(x, lnw, lnb, wfc, fcsc, bfc, wpr, bpr, out, ws, rows,
                                        C);
}

// four neighbouring values of x or out, as f32, and back (16-byte f32 and
// 8-byte bf16 accesses)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(exo::tc::pack_bf16(v.x, v.y), exo::tc::pack_bf16(v.z, v.w));
}

// out = sum over z of ws[z] (in z order) + b_proj + x, rounded once to T; four
// neighbouring values a thread, as vectors (C is a multiple of 128), since
// the residual makes this pass read a third stream
template <typename T>
__global__ void block_mlp_reduce_kernel(const float* __restrict__ ws, const T* __restrict__ bpr,
                                        const T* __restrict__ x, T* __restrict__ out, int rows,
                                        int C, int split) {
  const size_t n = size_t(rows) * C;
  for (size_t e = 4 * (size_t(blockIdx.x) * blockDim.x + threadIdx.x); e < n;
       e += 4 * size_t(gridDim.x) * blockDim.x) {
    float4 s = *reinterpret_cast<const float4*>(ws + e);
    for (int z = 1; z < split; ++z) {
      const float4 p = *reinterpret_cast<const float4*>(ws + size_t(z) * n + e);
      s = make_float4(s.x + p.x, s.y + p.y, s.z + p.z, s.w + p.w);
    }
    const T* b = bpr + e % C;
    const float4 r = load4(x + e);
    store4(out + e, make_float4(s.x + exo::to_f(b[0]) + r.x, s.y + exo::to_f(b[1]) + r.y,
                                s.z + exo::to_f(b[2]) + r.z, s.w + exo::to_f(b[3]) + r.w));
  }
}

// The arguments of one launch: wfc is the T weight (exact body) or the int8
// weight with its per-row scales fcsc (int8 body).
struct BlockMlpArgs {
  const void *x, *lnw, *lnb, *wfc;
  const float* fcsc;
  const void *bfc, *wpr, *bpr;
  void* out;
  float* ws;
  int rows, C, split;
};

template <typename T, bool INT8, int NS, bool XRES>
cudaError_t launch(const BlockMlpArgs& a, cudaStream_t st) {
  const T* x = static_cast<const T*>(a.x);
  const T* lnw = static_cast<const T*>(a.lnw);
  const T* lnb = static_cast<const T*>(a.lnb);
  const T* bfc = static_cast<const T*>(a.bfc);
  const T* wpr = static_cast<const T*>(a.wpr);
  const T* bpr = static_cast<const T*>(a.bpr);
  T* out = static_cast<T*>(a.out);
  const size_t smem = exo::mlp::Cfg<T, INT8 ? kLnQuant : kLn, NS, XRES>::bytes(a.C);
  const dim3 grid = exo::mlp::tile_grid(a.rows, a.C, NS, a.split);
  if constexpr (INT8) {
    auto kernel = block_mlp_int8_kernel<T, NS, XRES>;
    cudaError_t err = exo::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(x, lnw, lnb, static_cast<const int8_t*>(a.wfc), a.fcsc,
                                         bfc, wpr, bpr, out, a.ws, a.rows, a.C);
  } else {
    auto kernel = block_mlp_kernel<T, NS, XRES>;
    cudaError_t err = exo::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(x, lnw, lnb, static_cast<const T*>(a.wfc), bfc, wpr,
                                         bpr, out, a.ws, a.rows, a.C);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.split == 1) return err;
  block_mlp_reduce_kernel<T><<<exo::mlp::reduce_blocks(a.rows, a.C / 4), 256, 0, st>>>(
      a.ws, bpr, x, out, a.rows, a.C, a.split);
  return cudaGetLastError();
}

// The x tile resident up to C = 512 in bf16 and in the int8 body (one slab
// of C columns), streamed above (slabs of 512); the f32 exact body always
// streams it.
template <typename T, bool INT8>
cudaError_t by_width(int slab, const BlockMlpArgs& a, cudaStream_t st) {
  if constexpr (!INT8 && !std::is_same<T, bf16>::value) {
    return exo::mlp::by_slab(
        slab, [&](auto ns) { return launch<T, INT8, decltype(ns)::value, false>(a, st); });
  } else {
    if (a.C <= 512) {
      return exo::mlp::by_slab(
          slab, [&](auto ns) { return launch<T, INT8, decltype(ns)::value, true>(a, st); });
    }
    if (slab != 512) return cudaErrorInvalidValue;
    return launch<T, INT8, 512, false>(a, st);
  }
}

template <bool INT8>
int dispatch(const BlockMlpArgs& a, int slab, int dtype, void* stream) {
  if (!exo::mlp::plan_ok(a.rows, a.C, a.split, a.ws)) return cudaErrorInvalidValue;
  if (!exo::tc::aligned16(a.x) || !exo::tc::aligned16(a.wfc) || !exo::tc::aligned16(a.wpr)) {
    return cudaErrorMisalignedAddress;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_width<float, INT8>(slab, a, st);
  if (dtype == 1) return by_width<bf16, INT8>(slab, a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (rows, C), ln_w and ln_b (C), c_fc weight (4C, C) + bias (4C), c_proj
// weight (C, 4C) + bias (C), out (rows, C); all contiguous, of one type
// (dtype 0: float32, 1: bfloat16); x and both weights 16-byte aligned; C a
// positive multiple of 128. The plan, as fused_mlp_forward's: slab and
// split, with a float32 workspace ws of split * rows * C where split > 1.
// Returns the CUDA error of the launches, or 0.
extern "C" int block_mlp_forward(const void* x, const void* ln_w, const void* ln_b,
                                 const void* wfc, const void* bfc, const void* wpr,
                                 const void* bpr, void* out, void* ws, int rows, int C, int slab,
                                 int split, int dtype, void* stream) {
  const BlockMlpArgs a{x, ln_w, ln_b, wfc, nullptr, bfc, wpr, bpr, out,
                       static_cast<float*>(ws), rows, C, split};
  return dispatch<false>(a, slab, dtype, stream);
}

// As block_mlp_forward, with c_fc quantized per row: wfc (4C, C) int8 and
// fcsc (4C) float32.
extern "C" int block_mlp_int8_forward(const void* x, const void* ln_w, const void* ln_b,
                                      const void* wfc, const void* fcsc, const void* bfc,
                                      const void* wpr, const void* bpr, void* out, void* ws,
                                      int rows, int C, int slab, int split, int dtype,
                                      void* stream) {
  const BlockMlpArgs a{x, ln_w, ln_b, wfc, static_cast<const float*>(fcsc), bfc, wpr,
                       bpr, out, static_cast<float*>(ws), rows, C, split};
  return dispatch<true>(a, slab, dtype, stream);
}
