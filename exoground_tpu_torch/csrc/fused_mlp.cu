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
// Design. The point of the kernel is that the (rows, 4C) hidden activation
// never reaches device memory. A CTA of 8 warps owns kBM = 64 rows and a slab
// of NS <= 512 output columns (the f32 accumulator of 64 x 512 is 128 floats
// a thread), and walks the hidden dimension in chunks of kHC = 128 columns:
//   h = QuickGELU(x_tile . c_fc[chunk]^T + b_fc) rounded to c_proj's type
//   acc += h . c_proj[slab, chunk]^T
// Warp (wm, wn) = (warp / 4, warp % 4) owns rows 32 wm.. and, in the second
// product, output columns wn * NS/4..: two m-tiles by NS/32 n-tiles of the
// mma C fragment, so every operand fragment it reads from shared memory
// feeds 2 (A) or NS/32 (B) products. In the first product the same warp
// computes the 32 x 32 block of the chunk at rows 32 wm.., hidden columns
// 32 wn..; its C fragments take the bias, QuickGELU in f32 and the rounding
// to c_proj's type in registers, and the 64 x 128 chunk meets in shared
// memory (17-34 KB), from where each warp reads its 32 rows of it as A
// fragments. The 64 x 512 f32 tile needs all 8 warps' registers, and a warp
// owning all the columns of its rows would need 256 registers a thread for
// the accumulator: that is why the hidden crosses shared memory once, as
// the TPU kernel's crosses VMEM. Above C = 512 the output is cut into
// 512-column slabs, each CTA recomputing the hidden for its slab
// (ceil(C/512) times).
//
// Pipeline. The operands go through two-slot cp.async rings (16-byte copies,
// zero-filled past the data): a first-product step stages c_fc[chunk]
// (128 x KC) and, unless the x tile is resident, x (64 x KC); a
// second-product step stages c_proj[slab, HB hidden columns]. Each step
// prefetches the next one's operands while it computes. The x tile stays in
// shared memory for the whole walk where it fits (bf16, C <= 512).
//
// Few rows. Where the row tiles and slabs alone launch fewer CTAs than the
// card has SMs (the global path's 2,048-3,322 rows, grounding's 4,096-8,192),
// the wrapper's plan (ops/fused_mlp.py::mlp_launch_plan) splits the hidden
// chunks over `split` CTAs: each writes its f32 partial of the c_proj
// product to a workspace, and fused_mlp_reduce_kernel sums the partials in split
// order and adds b_proj once. No atomics: the result is deterministic.
//
// bfloat16 body: mma.sync m16n8k16 (bf16 operands, f32 accumulators) through
// tc.cuh's ldmatrix, at row pitches of 16 bytes more than the data (the 8 row
// addresses of an ldmatrix fall in 8 distinct 4-bank groups).
//
// float32 body: 3xTF32 on the tensor cores. mma.sync m16n8k8 .tf32 with each
// operand split as a = a_hi + a_lo: a_hi is a with its low 13 mantissa bits
// cleared (a bit mask; the rounding conversion cost ~20% of the kernel's
// time), a_lo = a - a_hi exactly, which the tensor core truncates to TF32;
// then d += a_lo b_hi + a_hi b_lo + a_hi b_hi. The dropped a_lo b_lo term
// and the truncation of a_lo are each below 2^-20 of a product, so the body
// keeps float32 accuracy (plain TF32, ~2^-10, misses the 1e-4 limit) at
// 3 x FLOPs / 495 TFLOP/s rather than FLOPs / 67 on the CUDA cores. The
// fragments are read from shared memory as 32-bit words at row pitches of 4
// floats more than the data (conflict-free for the m16n8k8 layouts); each B
// value is split once and used for both m-tiles.
//
// Accumulation, the bias and QuickGELU run in f32 for both types; for
// bfloat16 the hidden is rounded to bfloat16 before the second product, as
// the TPU kernel casts it to c_proj's type. The int8 and block MLP kernels
// keep the CUDA-core design of mlp_tail.cuh; this kernel no longer uses it.
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
using exo::tc::a_col;
using exo::tc::a_row;
using exo::tc::b_col;
using exo::tc::b_row;
using exo::tc::ldsm_x4;
using exo::tc::pack_bf16;

constexpr int kThreads = 256;  // 8 warps: 2 row blocks of 32 x 4 column quarters
constexpr int kBM = 64;        // rows a CTA owns
constexpr int kHC = 128;       // hidden columns a chunk

// ---- TF32 pieces of the f32 body ----
// x = hi + lo: hi is x with its low 13 mantissa bits cleared, lo = x - hi
// exactly (the tensor core reads its top 19 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b, m16n8k8, TF32 operands, f32 accumulators. Fragments (g = lane /
// 4, t = lane % 4): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 =
// A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; C as m16n8k16's.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 8) and B fragment (8 x 8), each split into TF32 halves
struct Tf32A {
  uint32_t hi[4], lo[4];
};
struct Tf32B {
  uint32_t hi[2], lo[2];
};

// the A fragment of rows 0.. of a row-major f32 tile at pitch p
__device__ __forceinline__ Tf32A load_a_tf32(const float* t, int p, int lane) {
  const int g = lane / 4, c = lane % 4;
  Tf32A a;
  split_tf32(t[g * p + c], a.hi[0], a.lo[0]);
  split_tf32(t[(g + 8) * p + c], a.hi[1], a.lo[1]);
  split_tf32(t[g * p + c + 4], a.hi[2], a.lo[2]);
  split_tf32(t[(g + 8) * p + c + 4], a.hi[3], a.lo[3]);
  return a;
}

// the B fragment of an n-major f32 tile (rows n, columns k) at pitch p
__device__ __forceinline__ Tf32B load_b_tf32(const float* t, int p, int lane) {
  const float* w = t + (lane / 4) * p + lane % 4;
  Tf32B b;
  split_tf32(w[0], b.hi[0], b.lo[0]);
  split_tf32(w[4], b.hi[1], b.lo[1]);
  return b;
}

// d += a . b in 3xTF32, smaller terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Tf32A& a, const Tf32B& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// Tile shapes by type. NS: the slab's output columns (a multiple of 128 up
// to 512); XRES: the x tile resident (bf16 at C <= 512).
template <typename T, int NS, bool XRES>
struct Cfg {
  static constexpr bool BF = std::is_same<T, bf16>::value;
  static constexpr int E = 16 / sizeof(T);      // elements a 16-byte copy
  static constexpr int PAD = BF ? 8 : 4;        // row padding, elements
  static constexpr int KC = 64;                 // K of a first-product step
  static constexpr int PA = KC + PAD;
  static constexpr int HB = BF ? 32 : 16;       // hidden columns of a second-product step
  static constexpr int PB = HB + PAD;
  static constexpr int NB = kHC / HB;           // second-product steps a chunk
  static constexpr int PH = kHC + PAD;          // pitch of the hidden chunk
  static constexpr int NTW = NS / 32;           // n-tiles of 8 a warp owns
  static constexpr int A_STAGE = kHC * PA + (XRES ? 0 : kBM * PA);
  static constexpr int B_STAGE = NS * PB;
  static size_t bytes(int C) {
    return sizeof(T) *
           (size_t(XRES ? kBM * (C + PAD) : 0) + 2 * A_STAGE + 2 * B_STAGE + kBM * PH);
  }
};

template <int M, int N>
__device__ __forceinline__ void zero(float (&a)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[i][j][e] = 0.f;
}

template <typename T, int NS, bool XRES>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ wfc, const T* __restrict__ bfc,
                 const T* __restrict__ wpr, const T* __restrict__ bpr, T* __restrict__ out,
                 float* __restrict__ ws, int rows, int C) {
  using L = Cfg<T, NS, XRES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int PX = XRES ? C + L::PAD : L::PA;  // x row pitch
  T* xres = reinterpret_cast<T*>(smem_raw);  // [kBM][PX] when resident
  T* ring_a = xres + (XRES ? kBM * PX : 0);  // [2][A_STAGE]: c_fc (then x) rows
  T* ring_b = ring_a + 2 * L::A_STAGE;       // [2][B_STAGE]: c_proj rows
  T* hs = ring_b + 2 * L::B_STAGE;           // [kBM][PH]: the hidden chunk

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, c = 2 * (lane % 4);
  const int r0 = blockIdx.x * kBM, n0 = blockIdx.y * NS;
  const int HID = 4 * C;
  const int nchunk = HID / kHC / gridDim.z;  // chunks of this CTA
  const int j0 = blockIdx.z * nchunk;
  const int NA = C / L::KC;                  // first-product steps a chunk
  const int spc = NA + L::NB;                // steps a chunk
  const int total = nchunk * spc;
  const int ncol0 = wn * (NS / 4);           // the warp's first column in the slab

  // rows [r0, r0 + kBM) of x, columns [k0, k0 + width) into dst (pitch p)
  auto stage_x = [&](T* dst, int p, int k0, int width) {
    const int ch = width / L::E;
    for (int e = tid; e < kBM * ch; e += kThreads) {
      const int r = e / ch, cc = (e % ch) * L::E;
      const bool in = r0 + r < rows;
      exo::tc::cp_async16(dst + r * p + cc, in ? x + size_t(r0 + r) * C + k0 + cc : x, in);
    }
  };
  auto stage_step = [&](int st) {
    const int jc = st / spc, i = st % spc, c0 = (j0 + jc) * kHC;
    if (i < NA) {  // c_fc[c0 .., k0 ..] (+ x[.., k0 ..])
      T* dst = ring_a + ((jc * NA + i) & 1) * L::A_STAGE;
      const int k0 = i * L::KC;
      constexpr int ch = L::KC / L::E;
      for (int e = tid; e < kHC * ch; e += kThreads) {
        const int r = e / ch, cc = (e % ch) * L::E;
        exo::tc::cp_async16(dst + r * L::PA + cc, wfc + size_t(c0 + r) * C + k0 + cc, true);
      }
      if (!XRES) stage_x(dst + kHC * L::PA, L::PA, k0, L::KC);
    } else {  // c_proj[n0 .., c0 + hb ..]
      T* dst = ring_b + ((jc * L::NB + i - NA) & 1) * L::B_STAGE;
      const int hb = c0 + (i - NA) * L::HB;
      constexpr int ch = L::HB / L::E;
      for (int e = tid; e < NS * ch; e += kThreads) {
        const int n = e / ch, cc = (e % ch) * L::E;
        const bool in = n0 + n < C;
        exo::tc::cp_async16(dst + n * L::PB + cc,
                            in ? wpr + size_t(n0 + n) * HID + hb + cc : wpr, in);
      }
    }
  };

  float acc[2][L::NTW][4];  // rows 32 wm + 16 mt.., columns ncol0 + 8 nt..
  zero(acc);
  float hacc[2][4][4];      // rows 32 wm + 16 mt.., hidden columns 32 wn + 8 nt..
  zero(hacc);

  if (XRES) stage_x(xres, PX, 0, C);
  stage_step(0);
  exo::tc::cp_async_commit();
  for (int st = 0; st < total; ++st) {
    __syncthreads();  // every warp is done with the slot about to be refilled
    if (st + 1 < total) stage_step(st + 1);
    exo::tc::cp_async_commit();
    exo::tc::cp_async_wait<1>();  // step st's operands have landed
    __syncthreads();
    const int jc = st / spc, i = st % spc;
    if (i < NA) {
      // ---- h += x[rows 32 wm.., k0..] . c_fc[32 wn.., k0..]^T ----
      const T* sa = ring_a + ((jc * NA + i) & 1) * L::A_STAGE;
      const T* xt = (XRES ? xres + i * L::KC : sa + kHC * L::PA) + 32 * wm * PX;
      const T* wt = sa + 32 * wn * L::PA;
      if constexpr (L::BF) {
#pragma unroll
        for (int kk = 0; kk < L::KC / 16; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(a[mt], xt + (16 * mt + a_row(lane)) * PX + kk * 16 + a_col(lane));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bb[4];
            ldsm_x4(bb, wt + (np * 16 + b_row(lane)) * L::PA + kk * 16 + b_col(lane));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              exo::tc::mma(hacc[mt][2 * np], a[mt], bb[0], bb[1]);
              exo::tc::mma(hacc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < L::KC / 8; ++kk) {
          Tf32A a[2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) a[mt] = load_a_tf32(xt + 16 * mt * PX + kk * 8, PX, lane);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const Tf32B b = load_b_tf32(wt + nt * 8 * L::PA + kk * 8, L::PA, lane);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_3xtf32(hacc[mt][nt], a[mt], b);
          }
        }
      }
      if (i == NA - 1) {
        // bias, QuickGELU in f32, rounded to c_proj's type, into hs
        const int c0 = (j0 + jc) * kHC;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = 32 * wn + nt * 8 + c;
          const float b_lo = exo::to_f(bfc[c0 + col]), b_hi = exo::to_f(bfc[c0 + col + 1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float h0 = hacc[mt][nt][2 * half] + b_lo, h1 = hacc[mt][nt][2 * half + 1] + b_hi;
              // QuickGELU: h * sigmoid(1.702 h)
              h0 = h0 * __frcp_rn(1.f + __expf(-1.702f * h0));
              h1 = h1 * __frcp_rn(1.f + __expf(-1.702f * h1));
              T* dst = hs + (32 * wm + 16 * mt + g + 8 * half) * L::PH + col;
              if constexpr (L::BF) {
                *reinterpret_cast<uint32_t*>(dst) = pack_bf16(h0, h1);
              } else {
                *reinterpret_cast<float2*>(dst) = make_float2(h0, h1);
              }
            }
        }
        zero(hacc);
      }
    } else {
      // ---- acc += h[rows 32 wm.., hb..] . c_proj[slab columns ncol0.., hb..]^T ----
      const int ib = i - NA;
      const T* sb = ring_b + ((jc * L::NB + ib) & 1) * L::B_STAGE;
      const T* ht = hs + 32 * wm * L::PH + ib * L::HB;
      if constexpr (L::BF) {
#pragma unroll
        for (int kk = 0; kk < L::HB / 16; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(a[mt], ht + (16 * mt + a_row(lane)) * L::PH + kk * 16 + a_col(lane));
#pragma unroll
          for (int np = 0; np < L::NTW / 2; ++np) {
            const int col = ncol0 + np * 16;
            if (n0 + col < C) {
              uint32_t bb[4];
              ldsm_x4(bb, sb + (col + b_row(lane)) * L::PB + kk * 16 + b_col(lane));
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                exo::tc::mma(acc[mt][2 * np], a[mt], bb[0], bb[1]);
                exo::tc::mma(acc[mt][2 * np + 1], a[mt], bb[2], bb[3]);
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < L::HB / 8; ++kk) {
          Tf32A a[2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            a[mt] = load_a_tf32(ht + 16 * mt * L::PH + kk * 8, L::PH, lane);
#pragma unroll
          for (int nt = 0; nt < L::NTW; ++nt) {
            const int col = ncol0 + nt * 8;
            if (n0 + col < C) {
              const Tf32B b = load_b_tf32(sb + col * L::PB + kk * 8, L::PB, lane);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_3xtf32(acc[mt][nt], a[mt], b);
            }
          }
        }
      }
    }
  }

  // ---- out = acc + b_proj (one CTA over the hidden), else the f32 partial ----
  const bool partial = gridDim.z > 1;
  float* wz = ws + size_t(blockIdx.z) * rows * C;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 32 * wm + 16 * mt + g + 8 * half;
      if (r >= rows) continue;
#pragma unroll
      for (int nt = 0; nt < L::NTW; ++nt) {
        const int n = n0 + ncol0 + nt * 8 + c;
        if (n >= C) continue;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (partial) {
          *reinterpret_cast<float2*>(wz + size_t(r) * C + n) = make_float2(v0, v1);
        } else {
          const float o0 = v0 + exo::to_f(bpr[n]), o1 = v1 + exo::to_f(bpr[n + 1]);
          if constexpr (L::BF) {
            *reinterpret_cast<uint32_t*>(out + size_t(r) * C + n) = pack_bf16(o0, o1);
          } else {
            *reinterpret_cast<float2*>(out + size_t(r) * C + n) = make_float2(o0, o1);
          }
        }
      }
    }
}

// out = sum over z of ws[z] (in z order) + b_proj, rounded once to T
template <typename T>
__global__ void fused_mlp_reduce_kernel(const float* __restrict__ ws, const T* __restrict__ bpr,
                                  T* __restrict__ out, int rows, int C, int split) {
  const size_t n = size_t(rows) * C;
  for (size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x; e < n;
       e += size_t(gridDim.x) * blockDim.x) {
    float s = ws[e];
    for (int z = 1; z < split; ++z) s += ws[size_t(z) * n + e];
    out[e] = exo::from_f<T>(s + exo::to_f(bpr[e % C]));
  }
}

template <typename T, int NS, bool XRES>
cudaError_t launch(const void* x, const void* wfc, const void* bfc, const void* wpr,
                   const void* bpr, void* out, void* ws, int rows, int C, int split,
                   cudaStream_t st) {
  auto kernel = fused_mlp_kernel<T, NS, XRES>;
  const size_t smem = Cfg<T, NS, XRES>::bytes(C);
  cudaError_t err = exo::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + kBM - 1) / kBM, (C + NS - 1) / NS, split);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wfc), static_cast<const T*>(bfc),
      static_cast<const T*>(wpr), static_cast<const T*>(bpr), static_cast<T*>(out),
      static_cast<float*>(ws), rows, C);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return err;
  const size_t n = size_t(rows) * C;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  fused_mlp_reduce_kernel<T><<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                                static_cast<const T*>(bpr),
                                                static_cast<T*>(out), rows, C, split);
  return cudaGetLastError();
}

template <typename T, bool XRES>
cudaError_t by_slab(int slab, const void* x, const void* wfc, const void* bfc, const void* wpr,
                    const void* bpr, void* out, void* ws, int rows, int C, int split,
                    cudaStream_t st) {
  switch (slab) {
    case 128: return launch<T, 128, XRES>(x, wfc, bfc, wpr, bpr, out, ws, rows, C, split, st);
    case 256: return launch<T, 256, XRES>(x, wfc, bfc, wpr, bpr, out, ws, rows, C, split, st);
    case 384: return launch<T, 384, XRES>(x, wfc, bfc, wpr, bpr, out, ws, rows, C, split, st);
    case 512: return launch<T, 512, XRES>(x, wfc, bfc, wpr, bpr, out, ws, rows, C, split, st);
    default: return cudaErrorInvalidValue;
  }
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
  if (rows < 1 || C < 128 || C % 128 != 0 || split < 1 || (4 * C / kHC) % split != 0 ||
      (split > 1 && ws == nullptr)) {
    return cudaErrorInvalidValue;
  }
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
