// Fused multi-head self-attention over windows of S <= 128 tokens.
//
// Replaces the TPU kernel exoground_tpu/ops/attention.py::_fused_mha
// (pallas_call in _mha_pallas, body _mha_kernel + _mha_attention_tail):
//   qkv = x . W_in^T + b_in; per head softmax(q k^T / sqrt(Dh), key padding) v;
//   out = concat_h(o_h) . W_out^T + b_out.
// Weights arrive in torch layout: W_in (3C, C) packed [q | k | v], W_out (C, C).
//
// What bounds it on an H100: operations. At the main-path shapes (B=304
// windows, S=64 and 64+Npad, C=512, H=8) the two projections are ~95% of the
// FLOPs (8*B*S*C^2) and the inputs are a few tens of MB, so the card's
// arithmetic rate decides: 989 TFLOP/s for bf16 on the tensor cores; for
// f32 the lesser of 67 on the CUDA cores and 495 / 3 on the tensor cores in
// 3xTF32 (0.26 ms at B304 S64 against 0.65).
//
// Design: mha_tile.cuh's bodies with no prologue. Both keep the (S, 3C) qkv
// and the S x S scores out of device memory, run every product on the tensor
// cores and end in the out-projection of mha_tail.cuh, a 128 x 128 tile
// summing the heads inside one dot product (no atomics). The TPU kernel
// keeps both weights (4 MB in f32) and a (128, 3C) qkv tile resident in
// VMEM, which does not fit a Hopper block's 227 KB of shared memory, so a
// CTA owns one head of a tile of packed windows and streams that head's
// W_in rows once for the whole tile.
// float32: mha_tf32_kernel<DHP>, 3xTF32 (mma.sync m16n8k8 .tf32 with hi/lo
// operand splits: plain TF32 misses the f32 limit of 1e-4 of max|plain|,
// 3xTF32 keeps float32 accuracy), windows packed at round16(S) rows into
// tiles of up to 128 (two at S 64, one 96-row tile at S 96); the
// out-projection in 3xTF32 too.
// bfloat16: mha_tc_kernel<DHP, false>, one CTA of 8 warps per (128-row tile,
// head), mma.sync m16n8k16, then the bf16 out-projection.
// Above a head of 64 (C 1024 at H 8): mha_tile.cuh's wide-head body (2d),
// the qkv as the tail's GEMM into a scratch, then attention in head slabs.
// x, W_in, W_out and the attn scratch must be 16-byte aligned (cp.async).
#include "mha_tile.cuh"

// x (B, S, C), kpad (B, S) int32 nonzero at padding, w_in (3C, C), b_in (3C),
// w_out (C, C), b_out (C), attn scratch (B*S, C), qkv scratch (B*S, 3C) for
// a head above 64 (the wide-head body; else null), out (B, S, C); all
// contiguous, of one type (dtype 0: float32, 1: bfloat16) apart from kpad;
// S <= 128, C a multiple of 32, head size C/H a multiple of 8; x, w_in, w_out
// and attn 16-byte aligned.
// Returns the first CUDA error of the launches, or 0.
extern "C" int fused_mha_forward(const void* x, const void* kpad, const void* w_in,
                                 const void* b_in, const void* w_out, const void* b_out,
                                 void* attn, void* qkv, void* out, int B, int S, int C,
                                 int H, int dtype, void* stream) {
  if (!exo::mha::valid_shape(B, S, C, H, exo::mha::kKCf)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exo::mha::by_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    cudaError_t err = exo::mha::attention_exact<T>(x, kpad, w_in, b_in, attn, qkv, B, S, C, H,
                                                     st);
    if (err != cudaSuccess) return err;
    return exo::out_projection<T>(attn, w_out, b_out, out, B * S, C, st);
  });
}
