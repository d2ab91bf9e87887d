// Block attention, int8-qkv body: (x + MHA(LN_1(x)), LN_1(x)) over windows of
// S <= 128 tokens with the qkv product in int8.
//
// Replaces the TPU kernel of exoground_tpu/ops/attention.py::_block_attn /
// fused_block_attn (:891, :927; pallas_call in _block_attn_pallas :833),
// body _block_attn_kernel_int8 (:636): qkv = float(quant(xn) . Wq) * xs *
// wsc + b_in, the unrounded f32 xn quantized per row (absmax / 127 over the
// row of C, round half to even, clip to +-127), W_in quantized per output row
// by the wrapper's cached plain quantizer (ops/quant.py::quantized_weight);
// then the exact body's attention and out = o . W_out^T + b_out + x.
//
// What bounds it on an H100: operations, as the int8 fused MHA's (6*B*S*C^2
// int8 operations, 2*B*S*C^2 + 4*B*S^2*C FLOPs).
//
// Design: the TPU kernel is the int8 fused MHA on the quantized f32 xn, so
// this is the int8 fused MHA's (mha_tile.cuh) after the kRowLnQuant
// prologue: one warp a row takes the LN statistics once, writes xn in x's
// type into the x_norm output and quantizes the unrounded f32 xn into xq and
// xs (the wrapper's scratch); then the int8 attention body (f32: the
// (window, head) kernel on __dp4a; bf16: the tensor-core tile on m16n8k32
// .s8) and the out-projection of mha_tail.cuh with the residual x. Above a
// head of 64: the wide-head body (mha_tile.cuh 2d) with the int8 projection.
#include "mha_tile.cuh"

// As block_attn_forward (csrc/block_attn.cu), with W_in quantized per row
// (wq (3C, C) int8, wsc (3C) float32) and the prologue's xq (B*S, C) int8 and
// xs (B*S) float32; w_out and attn 16-byte aligned (bfloat16: wq and xq too).
extern "C" int block_attn_int8_forward(const void* x, const void* kpad, const void* ln_w,
                                       const void* ln_b, const void* wq, const void* wsc,
                                       const void* b_in, const void* w_out, const void* b_out,
                                       void* xq, void* xs, void* attn, void* qkv, void* out,
                                       void* x_norm, int B, int S, int C, int H, int dtype,
                                       void* stream) {
  if (!exo::mha::valid_shape(B, S, C, H, 128)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exo::mha::by_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    cudaError_t err = exo::mha::row_prologue<T, exo::mha::kRowLnQuant>(
        x, ln_w, ln_b, x_norm, xq, xs, B * S, C, st);
    if (err != cudaSuccess) return err;
    err = exo::mha::attention_int8<T>(xq, xs, kpad, wq, wsc, b_in, attn, qkv, B, S, C, H, st);
    if (err != cudaSuccess) return err;
    return exo::out_projection<T>(attn, w_out, b_out, out, B * S, C, st, x);
  });
}
