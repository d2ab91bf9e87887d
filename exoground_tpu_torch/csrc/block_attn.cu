// Block attention, exact body: the first half of a pre-LN residual block over
// windows of S <= 128 tokens,
//   xn  = LayerNorm_1(x) in f32 (eps 1e-5), written out in x's type;
//   out = x + MHA(xn)  (the residual summed in f32, rounded once).
//
// Replaces the TPU kernel of exoground_tpu/ops/attention.py::_block_attn /
// fused_block_attn (:891, :927; pallas_call in _block_attn_pallas :833),
// body _block_attn_kernel (:616): xn = _layernorm_f32(x), qkv =
// round_T(xn) . W_in + b_in (f32 sums), then per head softmax(q k^T /
// sqrt(Dh), key padding) v and out = o . W_out^T + b_out + x, as
// _mha_attention_tail (:575) with x_res. Weights arrive in torch layout:
// W_in (3C, C) packed [q | k | v], W_out (C, C).
//
// What bounds it on an H100: operations, as fused MHA's (8*B*S*C^2 +
// 4*B*S^2*C FLOPs against a few tens of MB).
//
// Design: the TPU kernel is fused MHA's product on xn, so this is fused
// MHA's (mha_tile.cuh) after the kRowLn prologue: one warp a row takes the
// LN statistics once and writes xn in x's type into the x_norm output, which
// the attention kernel then reads as fused MHA reads x (f32: the 3xTF32
// tile; bf16: the bf16 tile, both on the tensor cores); the out-projection of
// mha_tail.cuh adds the residual x in f32 before its one rounding. The
// sources build without fast math: the LN root and quotients are IEEE
// operations, as in the plain version. Above a head of 64 the attention
// body is mha_tile.cuh's wide-head body (2d).
#include "mha_tile.cuh"

// x (B, S, C), kpad (B, S) int32 nonzero at padding, ln_w and ln_b (C), w_in
// (3C, C), b_in (3C), w_out (C, C), b_out (C), attn scratch (B*S, C), qkv
// scratch (B*S, 3C) for a head above 64 (the wide-head body; else null), out
// and x_norm (B, S, C); all contiguous, of one type (dtype 0: float32, 1:
// bfloat16) apart from kpad; S <= 128, C a multiple of 128, head size C/H a
// multiple of 8; w_in, w_out, attn and x_norm 16-byte aligned (x 8-byte
// aligned in f32, 4-byte in bf16). Returns the first CUDA error of
// the launches, or 0.
extern "C" int block_attn_forward(const void* x, const void* kpad, const void* ln_w,
                                  const void* ln_b, const void* w_in, const void* b_in,
                                  const void* w_out, const void* b_out, void* attn, void* qkv,
                                  void* out, void* x_norm, int B, int S, int C, int H,
                                  int dtype, void* stream) {
  if (!exo::mha::valid_shape(B, S, C, H, 128)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exo::mha::by_dtype(dtype, [&](auto tag) -> int {
    using T = decltype(tag);
    cudaError_t err = exo::mha::row_prologue<T, exo::mha::kRowLn>(
        x, ln_w, ln_b, x_norm, nullptr, nullptr, B * S, C, st);
    if (err != cudaSuccess) return err;
    err = exo::mha::attention_exact<T>(x_norm, kpad, w_in, b_in, attn, qkv, B, S, C, H, st);
    if (err != cudaSuccess) return err;
    return exo::out_projection<T>(attn, w_out, b_out, out, B * S, C, st, x);
  });
}
