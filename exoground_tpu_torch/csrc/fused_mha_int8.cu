// Fused multi-head self-attention over windows of S <= 128 tokens with an
// int8 qkv projection (the int8 serving mode).
//
// Replaces the TPU kernel exoground_tpu/ops/attention.py::_fused_mha_int8
// (:777; pallas_call in _mha_pallas :736, body _mha_kernel_int8 :674 +
// _mha_attention_tail :575):
//   xq, xs = per-row int8 quantization of x as f32 (absmax / 127 over the row
//            of C, round half to even, clip to +-127);
//   qkv = float(xq . Wq^T) * xs * wsc + b_in   (int8 x int8 -> int32, then f32);
//   per head softmax(q k^T / sqrt(Dh), key padding) v;  out = o . W_out^T + b_out.
// W_in arrives quantized per output row (torch layout (3C, C) int8, packed
// [q | k | v], scales (3C) float32) by the wrapper's cached plain quantizer
// (ops/quant.py::quantized_weight); b_in, W_out, b_out are of the input
// type. Attention and the out-projection are exact, as in the TPU kernel.
//
// What bounds it on an H100: operations. At the main-path shapes (B = 304
// windows, S = 64 and 96, C = 512, H = 8) the int8 projection is 6*B*S*C^2
// operations (1,979 TOPS on the int8 tensor cores), the out-projection
// 2*B*S*C^2 and the attention 4*B*S^2*C FLOPs (bf16 at 989 TFLOP/s on the
// tensor cores, f32 at the lesser of 67 on the CUDA cores and 495 / 3 in
// 3xTF32); the inputs are a few tens of MB.
//
// Design: mha_tile.cuh's bodies with the kRowQuant prologue, which quantizes
// each row once into xq (B*S, C) int8 and xs (B*S) f32 (the wrapper's
// scratch). float32: int8_window_head_kernel, one CTA per (window, head),
// __dp4a over the xq words on the CUDA cores. bfloat16: mha_tc_kernel<DHP,
// true>, the fused MHA's tensor-core tile with the qkv product as mma.sync
// m16n8k32 .s8 (half the K steps of bf16) and q, k, v, p rounded to bf16 as
// fused MHA rounds them. Both dequantize in the plain version's order; the
// out-projection of mha_tail.cuh follows (f32: 3xTF32 on the tensor cores,
// shared with the exact body). The f32 (window, head) kernel keeps its
// CUDA-core design: only chip_smoke's f32 + int8 agreement check runs it.
// Above a head of 64, both types run mha_tile.cuh's wide-head body (2d)
// with the int8 qkv product as linear_s8_kernel (s8 mma.sync); the
// out-projection there is a wgmma GEMM of wgmma_linear.cuh (bf16, and f32
// in 3xTF32).
#include "mha_tile.cuh"

// x (B, S, C), kpad (B, S) int32 nonzero at padding, wq (3C, C) int8 and wsc
// (3C) float32 (W_in quantized per row), b_in (3C), w_out (C, C), b_out (C),
// xq (B*S, C) int8 and xs (B*S) float32 (the prologue's output), attn scratch
// (B*S, C), qkv scratch (B*S, 3C) for a head above 64 (the wide-head body;
// else null), out (B, S, C); all contiguous; x, b_in, w_out, b_out, attn, qkv
// and out of one type (dtype 0: float32, 1: bfloat16); S <= 128, C a
// multiple of 128, head size C/H a multiple of 8; w_out and attn 16-byte
// aligned (bfloat16: wq and xq too). Returns the first CUDA error of the
// launches, or 0.
extern "C" int fused_mha_int8_forward(const void* x, const void* kpad, const void* wq,
                                      const void* wsc, const void* b_in, const void* w_out,
                                      const void* b_out, void* xq, void* xs, void* attn,
                                      void* qkv, void* out, int B, int S, int C, int H,
                                      int dtype, void* stream) {
  if (!exo::mha::valid_shape(B, S, C, H, 128)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exo::mha::by_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    cudaError_t err = exo::mha::row_prologue<T, exo::mha::kRowQuant>(
        x, nullptr, nullptr, nullptr, xq, xs, B * S, C, st);
    if (err != cudaSuccess) return err;
    err = exo::mha::attention_int8<T>(xq, xs, kpad, wq, wsc, b_in, attn, qkv, B, S, C, H, st);
    if (err != cudaSuccess) return err;
    return exo::out_projection<T>(attn, w_out, b_out, out, B * S, C, st, nullptr,
                                   exo::mha::wide_head(C, H));
  });
}
