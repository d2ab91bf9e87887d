// The parts the block-attention kernels share (csrc/block_attn.cu, the exact
// body, and csrc/block_attn_int8.cu, the int8-qkv body): the first half of a
// pre-LN residual block over windows of S <= 128 tokens,
//   xn  = LayerNorm_1(x) in f32 (eps 1e-5), written out in x's type;
//   out = x + MHA(xn)  (the residual summed in f32, rounded once).
// Counterpart of exoground_tpu/ops/attention.py::_block_attn_pallas (:833).
// Weights arrive in torch layout: W_in (3C, C) packed [q | k | v], W_out (C, C).
//
// What bounds it on an H100: operations. At the main-path shapes (B = 304
// windows, S = 64 and 96, C = 512, H = 8) the projections are 8*B*S*C^2 FLOPs
// (the int8 body: 6*B*S*C^2 int8 operations) and the attention 4*B*S^2*C,
// against a few tens of MB of inputs and outputs. The (window, head) kernel
// runs its products on the CUDA cores (f32 FMAs, __dp4a for the int8 qkv),
// far from the tensor-core bound; in bf16 the out-projection of mha_tail.cuh
// runs on the tensor cores.
//
// Design: fused_mha.cu's and fused_mha_int8.cu's, with an LN prologue and a
// residual epilogue; the LayerNorm and the residual add never reach device
// memory apart from the x_norm output the TAN stages need.
//   1. the body's kernel: one CTA per (window, head). A first pass takes each
//      of the window's S rows' mean and rstd (one warp a row, two passes over
//      the row; the int8 body also the absmax of the f32 xn row, a third pass)
//      into shared memory. Every one of the window's H CTAs recomputes them
//      from the same reads in the same order, so all form the same xn. The K
//      loop stages W_in's 3*Dh rows of this head and the normalized x chunk:
//      formed as it is staged (each thread keeps one column, so it reads the
//      LN weight and bias once a chunk), rounded to x's type (exact body) or
//      quantized with the whole row's scale and packed 4 to a word (int8
//      body). q, k, v land in shared memory in f32; each CTA writes its own Dh
//      columns of x_norm; the attention tail of mha_tail.cuh writes o_h to an
//      (B*S, C) scratch.
//   2. the tiled out-projection of mha_tail.cuh with x as its residual.
// Head sizes: multiples of 8 up to 64 (the shared-memory budget at S = 128:
// q/k/v and the scores take 164 KB at Dh = 64, the row statistics 2 KB more).
// The register tile is templated on the head size rounded up to 16 (DHP) and
// on ceil(S/16). Head size 64, every model's in the repo, is also a
// compile-time constant (DHC), which it needs to run as fast as fused MHA;
// the others pass it at run time (DHC = 0), so a body builds 80
// instantiations rather than 128. The sources build
// without fast math: the LN root and quotients and the int8 scales are IEEE
// operations, as in the plain versions.
#pragma once

#include <cstddef>

#include "common.cuh"
#include "mha_tail.cuh"

namespace exo {

constexpr int kBlockThreads = 256;
constexpr int kBlockKC = 32;     // K chunk: 32 f32 values (exact) or 32 words of int8 (int8)
constexpr int kBlockMaxDh = 64;  // largest head size served

// RT: register-tile rows / 16 (ceil(S/16)); DHP: the head size rounded up to 16.
template <int RT, int DHP>
struct BlockLayout {
  static constexpr int SP = RT * 16;      // rows covered by the register tile
  static constexpr int QP = DHP + 1;      // q/k/v row pitch (odd: conflict-free)
  static constexpr int XP = SP + 1;       // staged x chunk pitch, [kBlockKC][XP]
  static constexpr int WP = 3 * DHP + 1;  // staged W_in chunk pitch, [kBlockKC][WP]
  __host__ __device__ static int union_words(int S) {
    int stage = kBlockKC * (XP + WP);
    return stage > S * S ? stage : S * S;
  }
  // q, k, v; the staging area / scores; row mean, rstd, int8 scale; key padding
  __host__ __device__ static size_t bytes(int S) {
    return (size_t(3) * SP * QP + union_words(S) + 4 * SP) * 4;
  }
};

// The shared-memory carve-up both bodies use.
template <int RT, int DHP>
struct BlockSmem {
  float *qs, *ks, *vs, *uni, *mu, *rs, *sc;
  int* km;
  __device__ BlockSmem(float* smem, int S) {
    using L = BlockLayout<RT, DHP>;
    qs = smem;
    ks = qs + L::SP * L::QP;
    vs = ks + L::SP * L::QP;
    uni = vs + L::SP * L::QP;
    mu = uni + L::union_words(S);
    rs = mu + L::SP;
    sc = rs + L::SP;
    km = reinterpret_cast<int*>(sc + L::SP);
  }
};

// Each CTA of a window writes its own Dh columns of x_norm in x's type.
template <typename T>
__device__ __forceinline__ void write_x_norm(const T* xb, const T* lnw, const T* lnb,
                                             const float* mu, const float* rs, T* xnb, int S,
                                             int C, int h, int DH) {
  for (int e = threadIdx.x; e < S * DH; e += kBlockThreads) {
    const int s = e / DH, k = h * DH + e % DH;
    const size_t i = size_t(s) * C + k;
    xnb[i] = from_f<T>(ln_apply(to_f(xb[i]), mu[s], rs[s], to_f(lnw[k]), to_f(lnb[k])));
  }
}

// The arguments of one launch: w_in is the T weight (exact body) or the int8
// weight with its per-row scales wsc (int8 body).
struct BlockArgs {
  const void *x, *kpad, *lnw, *lnb, *w_in;
  const float* wsc;
  const void *b_in, *w_out, *b_out;
  void *attn, *out, *xn;
  int B, S, C, H;
};

// Body: a struct whose static template launch<T, RT, DHP, DHC>(args, stream)
// launches its kernel on B*H CTAs and returns cudaGetLastError().
template <typename Body, typename T, int DHP>
cudaError_t block_attention_by_rows(const BlockArgs& a, cudaStream_t st) {
  constexpr int kFixed = DHP == kBlockMaxDh ? DHP : 0;  // the one head size fixed at compile time
  const bool fixed = kFixed != 0 && a.C / a.H == kFixed;
#define EXO_RT(n)                                                         \
  case n:                                                                 \
    return fixed ? Body::template launch<T, n, DHP, kFixed>(a, st)        \
                 : Body::template launch<T, n, DHP, 0>(a, st);
  switch ((a.S + 15) / 16) {
    EXO_RT(1) EXO_RT(2) EXO_RT(3) EXO_RT(4) EXO_RT(5) EXO_RT(6) EXO_RT(7) EXO_RT(8)
    default: return cudaErrorInvalidValue;
  }
#undef EXO_RT
}

template <typename Body, typename T>
cudaError_t block_attn_launches(const BlockArgs& a, cudaStream_t st) {
  cudaError_t err;
  switch ((a.C / a.H + 15) / 16) {
    case 1: err = block_attention_by_rows<Body, T, 16>(a, st); break;
    case 2: err = block_attention_by_rows<Body, T, 32>(a, st); break;
    case 3: err = block_attention_by_rows<Body, T, 48>(a, st); break;
    case 4: err = block_attention_by_rows<Body, T, 64>(a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return out_projection<T>(a.attn, a.w_out, a.b_out, a.out, a.B * a.S, a.C, st, a.x);
}

// The entry points' checks and type dispatch; returns the first CUDA error of
// the launches, or 0.
template <typename Body>
int block_attn_dispatch(const BlockArgs& a, int dtype, void* stream) {
  if (a.B < 1 || a.S < 1 || a.S > 128 || a.H < 1 || a.C % a.H != 0 || a.C % 128 != 0) {
    return cudaErrorInvalidValue;
  }
  if (a.C / a.H > kBlockMaxDh || (a.C / a.H) % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return block_attn_launches<Body, float>(a, st);
  if (dtype == 1) return block_attn_launches<Body, __nv_bfloat16>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace exo
