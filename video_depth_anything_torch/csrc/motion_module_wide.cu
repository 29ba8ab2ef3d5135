// Kernel C wherever the resident kernels (csrc/motion_module.cuh,
// csrc/motion_module_f32.cu: 8 heads, two attention blocks, ff_mult 4, C in
// {64, 128, 192, 256, 384}) do not reach: one whole motion module
// (TemporalModule) as a short chain of hand-written launches, in bf16
// (vda_motion_module_wide) and in fp32 (vda_motion_module_wide_f32), from
// one source templated on the operand type, with C, the heads, the attention
// blocks and the feed-forward's hidden width run-time values.
// VDA_FUSED_MOTION=1 sends vitb m1 (C = 768) and vitl m0/m1 (C = 1024)
// here; so does every module of a motion config at 4 or 16 heads, at 1 or 3
// attention blocks or at another ff_mult (JAX's KV-cache test config: 4
// heads, one block), and every width the gate admits off the resident
// seven (C = 8 ... 1920).
//
// Replaces video_depth_anything_tpu/ops/pallas_motion.py:_motion_kernel
// (via fused_motion_module) there.  It computes the same module:
//   GroupNorm apply (statistics folded outside, as _gn_fold does) -> proj_in
//   -> n_attn x [LayerNorm, +APE, q/k/v, attention over the T frames per
//                (location, head), out proj, residual]
//   -> LayerNorm -> GEGLU feed-forward (ff_mult C hidden) -> residual
//   -> proj_out -> + x
// In bf16, values are rounded to bf16 where the bf16 Kernel C rounds them
// (h, y, q, k, v, p, the attention out, the FF activation, y after each
// residual, the output); in fp32 every value stays fp32 and every product
// is 3xTF32 on the tensor cores (as csrc/motion_module_f32.cu), with the
// erf GELU.
//
// Why a chain.  The resident plan of the narrower widths keeps four R x C
// activation buffers of R >= 64 rows (the wgmma M) in shared memory beside
// a weight ring: at C = 768 that is 384 KB and at 1024 512 KB in bf16
// (twice that in fp32), against the 227 KB a CTA can have; and its plan is
// built around 8 heads, two attention blocks and a 4 C hidden layer.  Every
// step of the module but the frame attention is row-wise, so the
// activations go through device memory between launches instead, and each
// launch is one kind of work:
//   rows<GN>       x -> h                       (one warp a row)
//   gemm<BIAS>     h . w_in + b_in -> y
//   n_attn x [rows<LN+APE> y -> h;  gemm h . [wq|wk|wv] -> qkv (M x 3C);
//             attention qkv -> h;   gemm<RESIDUAL> y += h . wo + bo]
//   rows<LN>       y -> h
//   gemm<GEGLU>    h . w1 -> act (M x F): each 128-wide tile holds 64
//                  hidden units' h columns and their 64 gate columns, so
//                  one thread holds both halves of each activation; F is
//                  ff_mult C rounded up to 64 (the host pads w1's columns,
//                  b1 and w2's rows with zeros: GEGLU gives 0 there)
//   gemm<RESIDUAL> y += act . w2 + b2
//   gemm<RESIDUAL> out = y . w_out + b_out + x
// 6 + 4 n_attn launches (14 at two blocks); rows are the tokens in (b, t,
// s) order, M = B T S, with no padding (rows past M in the last GEMM tile
// read as zero and are never stored).  The scratch rows are padded to a
// multiple of 8 elements (ldc = C rounded up, l3 = 3 C rounded up; the
// TMA's row stride must be a multiple of 16 bytes): y, h (M x ldc) and
// qkv / act (M x max(l3, F)), allocated by the caller
// (ops/motion_module.py, torch.empty); the kernels allocate nothing and
// never read the pad columns.  At C = 768 and 1024 with ff_mult 4 the
// layout is the unpadded one of 6 M C elements.
//
// Ragged edges.  A GEMM's k panels past K (C not a multiple of 64 inputs,
// or 32 in fp32) come from the TMA's zero fill: the activation's tensor map
// has K columns, the box one whole panel.  The weight tiles are zero-padded
// by the host to whole 128-column blocks and whole panels
// (ops/motion_module.wide_tiles); the epilogues store only columns < N.
//
// Plan and shared memory:
// - gemm: a CTA computes a 128 x 128 output tile: two consumer warpgroups
//   of 64 rows each (one wgmma M) and a producer warp.  The producer
//   streams, k panel after k panel, the A panel (128 rows x 128 bytes, a
//   TMA box of the activation's tensor map, 128-byte swizzle) and the
//   weight tile of the panel (host-laid, ops/motion_module.wide_tiles:
//   128 output columns x 128 bytes of inputs, the same swizzle; in fp32 a
//   hi tile and a lo tile) into a ring of 4 stages on full / empty
//   mbarriers.  bf16: wgmma m64n128k16, A and B from shared memory, stage
//   32 KB, ring 128 KB.  fp32: each thread loads its tf32 A fragments from
//   the stage, splits them (hi = rna(a), lo = rna(a - hi)) and issues
//   lo.hi, hi.lo, hi.hi (wgmma m64n64k8, two n64 halves), stage 48 KB,
//   ring 192 KB.  Both under the 227 KB opt-in limit; one CTA an SM.
// - attention: one CTA a location (b, s) and group of up to 8 heads, one
//   thread a (query frame t, head): TP = T padded up to 8, 16 or 32
//   threads a head, the head width d = C / heads a run-time value (read 8,
//   4, 2 or 1 elements at a time: the most that divide d).  Scores over the key
//   frames in registers (TP floats), q, k and v read from the qkv scratch
//   (each key row is read by all TP threads of its head: L1 broadcasts),
//   FFMA; key frames t >= T are masked (never read, p = 0), query threads t
//   >= T return at once (nothing stored).
// - rows: one warp a row, pairs of elements 64 apart a lane (NP pairs: 1, 2,
//   4, 8, 12, 16 or 32, the first at or above C / 64); fp32 statistics (mean and E[x^2] -
//   mean^2 clamped at 0, as ops/motion_module._ln).
//
// Bound on the H100: tensor-core FLOPs, (2 + 4 n_attn) C^2 + 6 ff_mult C^2
// + 4 n_attn T C a token (44 C^2 + 8 T C at two blocks, ff_mult 4): at vitl m0
// 518x924 (C = 1024, 78,144 tokens) 3.67 ms at 989 TFLOP/s in bf16, 3 x the
// FLOPs at 495 TFLOP/s in 3xTF32.  The chain also moves each activation
// through device memory (about 30 C bytes a token in bf16), and each GEMM
// CTA streams its weight column block from L2 once per 128 rows.
#include <math.h>

#include <algorithm>

#include "motion_module.cuh"  // mm::gelu_bf16, and common.cuh / hopper.cuh

namespace {

constexpr int kHeadsPerCta = 8;  // attention: heads a CTA
constexpr int BM = 128;  // rows of a GEMM tile: two consumer warpgroups of 64
constexpr int BN = 128;  // output columns of a GEMM tile
constexpr int NST = 4;   // ring stages
constexpr int kGemmThreads = 2 * 128 + 32;
constexpr int kRowThreads = 256;  // eight warps, one a row

template <typename T>
struct Op;
template <>
struct Op<bf16> {
  static constexpr int KW = 64;             // inputs of a k panel: 128 bytes a row
  static constexpr int A_BYTES = BM * 128;  // a 128-row A panel
  static constexpr int B_BYTES = BN * 128;  // a weight tile
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Op<float> {
  static constexpr int KW = 32;
  static constexpr int A_BYTES = BM * 128;
  static constexpr int B_BYTES = 2 * BN * 128;  // the hi tile, then the lo tile
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <typename T>
struct Ring {
  static constexpr int STAGE = Op<T>::A_BYTES + Op<T>::B_BYTES;
  static constexpr int SMEM = NST * STAGE + 2 * NST * 8 + 1024;
  static_assert(SMEM <= 232448, "shared memory over the opt-in limit");
};

enum Epi { kBias = 0, kResidual = 1, kGeglu = 2 };

struct GemmArgs {
  const void* w;      // this product's tiles: ceil(N / BN) column blocks x ceil(K / KW) panels
  const float* bias;  // nullptr: none
  const void* res;    // kResidual: added, (M, ldo), may be out itself
  void* out;          // (M, ldo); columns n < N stored
  int M, K, N, ldo;
};

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ float load1(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ void store1(bf16* p, float a) { *p = __float2bfloat16_rn(a); }
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }

// Elements i and i + 1 of a row of n (as a pair where `pairs`: i even and
// the row's start 2-aligned), those at or past n read as 0 and never
// written.
template <typename T>
__device__ __forceinline__ float2 get2(const T* row, int i, int n, bool pairs) {
  if (pairs && i + 1 < n) return load2(row + i);
  return make_float2(i < n ? load1(row + i) : 0.f, i + 1 < n ? load1(row + i + 1) : 0.f);
}
template <typename T>
__device__ __forceinline__ void put2(T* row, int i, int n, bool pairs, float a, float b) {
  if (pairs && i + 1 < n) {
    store2(row + i, a, b);
    return;
  }
  if (i < n) store1(row + i, a);
  if (i + 1 < n) store1(row + i + 1, b);
}

// eight consecutive elements as floats (16-byte aligned)
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// VEC consecutive elements as floats (VEC-element aligned)
template <int VEC, typename T>
__device__ __forceinline__ void loadv(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    load8(p, v);
  } else if constexpr (VEC == 4 && sizeof(T) == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const bf162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const bf162*>(&u.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else if constexpr (VEC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else if constexpr (VEC == 2) {
    const float2 a = load2(p);
    v[0] = a.x, v[1] = a.y;
  } else {
    v[0] = load1(p);
  }
}

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

// acc (m64n128: d[4t + 0..1] = (row g, cols 8t + 2c..), d[4t + 2..3] = (row
// g + 8, same)) += the warpgroup's 64 rows of A . the stage's weight tile^T
// over one k panel.  bf16: four k16 steps, A and B from shared memory.
__device__ __forceinline__ void panel(float (&acc)[64], const unsigned char* st, int wg, int first) {
  const uint64_t da = desc_sw128(st + wg * 64 * 128);
  const uint64_t db = desc_sw128(st + Op<bf16>::A_BYTES);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_ss_n128(acc, da + 2 * ks, db + 2 * ks, (first && ks == 0) ? 0 : 1);
  wgmma_commit();
}

// fp32: four k8 steps of 3xTF32, A from registers (each thread's tf32 A
// fragments: rows g and g + 8 of its warp's 16, inputs c and c + 4 of each
// k8 step; element (r, k) of the swizzled stage at r * 32 + ((k / 4) ^ (r %
// 8)) * 4 + k % 4), the weight tile's hi and lo halves from shared memory;
// two n64 products a step (columns 0..63, 64..127 of the tile).
__device__ __forceinline__ void panel_f32(float (&acc)[64], const unsigned char* st, int wg,
                                          int first) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int r = wg * 64 + warp * 16 + (lane >> 2), c = lane & 3;
  const float* A = reinterpret_cast<const float*>(st);
  const float* bh = reinterpret_cast<const float*>(st + Op<float>::A_BYTES);
  const float* bl = bh + BN * 32;
  auto at = [&](int row, int k) { return A[row * 32 + ((((k >> 2) ^ (row & 7))) << 2) + (k & 3)]; };
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const float a[4] = {at(r, 8 * kk + c), at(r + 8, 8 * kk + c), at(r, 8 * kk + c + 4),
                        at(r + 8, 8 * kk + c + 4)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float h, l;
      split_tf32(a[i], h, l);
      hi[kk][i] = __float_as_uint(h);
      lo[kk][i] = __float_as_uint(l);
    }
  }
  float(&d0)[32] = *reinterpret_cast<float(*)[32]>(acc);
  float(&d1)[32] = *reinterpret_cast<float(*)[32]>(acc + 32);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int sd = (first && kk == 0) ? 0 : 1;
    const uint64_t h0 = desc_sw128(bh) + 2 * kk, h1 = desc_sw128(bh + 64 * 32) + 2 * kk;
    const uint64_t l0 = desc_sw128(bl) + 2 * kk, l1 = desc_sw128(bl + 64 * 32) + 2 * kk;
    wgmma_tf32_rs_n64(d0, lo[kk], h0, sd);
    wgmma_tf32_rs_n64(d0, hi[kk], l0, 1);
    wgmma_tf32_rs_n64(d0, hi[kk], h0, 1);
    wgmma_tf32_rs_n64(d1, lo[kk], h1, sd);
    wgmma_tf32_rs_n64(d1, hi[kk], l1, 1);
    wgmma_tf32_rs_n64(d1, hi[kk], h1, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();  // the fragments are registers: keep them until the products are done
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(hi[kk][i]), "r"(lo[kk][i]));
}

// out tile (blockIdx.y: 128 rows from m0; blockIdx.x: 128 weight columns)
// = A . W with the epilogue EPI.  A is the tensor map's (M, K) activation.
template <typename T, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
    wide_gemm(const __grid_constant__ CUtensorMap amap, const GemmArgs g) {
  constexpr int STAGE = Ring<T>::STAGE, KW = Op<T>::KW, A_BYTES = Op<T>::A_BYTES;
  constexpr int B_BYTES = Op<T>::B_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + NST * STAGE);
  uint64_t* empty = full + NST;
  const int nb = blockIdx.x, m0 = blockIdx.y * BM, kpn = (g.K + KW - 1) / KW;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // both consumer warpgroups
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp: one thread streams the panels
    if (threadIdx.x == 256) {
      const unsigned char* wsrc =
          static_cast<const unsigned char*>(g.w) + (long long)nb * kpn * B_BYTES;
      for (int kp = 0; kp < kpn; ++kp) {
        const int s = kp % NST;
        if (kp >= NST) mbar_wait(&empty[s], (kp / NST - 1) & 1);
        mbar_arrive_expect_tx(&full[s], STAGE);
        tma_load_3d(base + s * STAGE, &amap, &full[s], kp * KW, m0, 0);
        bulk_load(base + s * STAGE + A_BYTES, wsrc + (long long)kp * B_BYTES, B_BYTES, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 127) == 0;
  float acc[64];
  for (int kp = 0; kp < kpn; ++kp) {
    const int s = kp % NST;
    mbar_wait(&full[s], (kp / NST) & 1);
    if constexpr (sizeof(T) == 2) {
      panel(acc, base + s * STAGE, wg, kp == 0);
      if (kp > 0) {
        wgmma_wait<1>();  // panel kp - 1's products are done with its stage
        if (leader) mbar_arrive(&empty[(kp - 1) % NST]);
      }
    } else {
      panel_f32(acc, base + s * STAGE, wg, kp == 0);
      if (leader) mbar_arrive(&empty[s]);
    }
  }
  if constexpr (sizeof(T) == 2) wgmma_wait<0>();
  fence_regs(acc);

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row0 = m0 + wg * 64 + warp * 16 + (lane >> 2), c2 = 2 * (lane & 3);
  T* out = static_cast<T*>(g.out);
  const T* res = static_cast<const T*>(g.res);
  const bool pairs = !(g.ldo & 1);  // every row start 2-aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= g.M) continue;
    const long long ro = (long long)row * g.ldo;
    if constexpr (EPI == kGeglu) {
      // columns 0..63 of the tile: hidden units 64 nb + j's h; 64..127 their
      // gate; F = ldo a multiple of 64: every unit stored
      const int ff = g.ldo;  // F: the gate biases follow the h biases
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int j = nb * 64 + 8 * t + c2;
        const float v0 = acc[4 * t + 2 * h], v1 = acc[4 * t + 2 * h + 1];
        const float g0 = acc[4 * (t + 8) + 2 * h], g1 = acc[4 * (t + 8) + 2 * h + 1];
        if constexpr (sizeof(T) == 2) {
          const float h0 = bf16_round(v0 + g.bias[j]), h1 = bf16_round(v1 + g.bias[j + 1]);
          store2(out + ro + j, h0 * mm::gelu_bf16(bf16_round(g0 + g.bias[ff + j])),
                 h1 * mm::gelu_bf16(bf16_round(g1 + g.bias[ff + j + 1])));
        } else {
          store2(out + ro + j, (v0 + g.bias[j]) * gelu_erf(g0 + g.bias[ff + j]),
                 (v1 + g.bias[j + 1]) * gelu_erf(g1 + g.bias[ff + j + 1]));
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int n = nb * BN + 8 * t + c2;
        if (n >= g.N) continue;  // past the product's columns: nothing stored
        const float v0 = acc[4 * t + 2 * h], v1 = acc[4 * t + 2 * h + 1];
        const float b0 = g.bias ? g.bias[n] : 0.f;
        const float b1 = g.bias && n + 1 < g.N ? g.bias[n + 1] : 0.f;
        if constexpr (EPI == kResidual) {
          const float2 y = get2(res + ro, n, g.N, pairs);
          if constexpr (sizeof(T) == 2)
            put2(out + ro, n, g.N, pairs, y.x + v0 + b0, y.y + v1 + b1);
          else
            put2(out + ro, n, g.N, pairs, y.x + (v0 + b0), y.y + (v1 + b1));
        } else {
          put2(out + ro, n, g.N, pairs, v0 + b0, v1 + b1);
        }
      }
    }
  }
}

// One warp a row of (M, C): src rows `sld` elements apart, dst rows `dld`.
// GroupNorm apply (LN = false): dst = x . a[bt] + b[bt] with the folded
// per-(b, t, c) scale a and shift b, bt = row / S.  LayerNorm (LN = true):
// dst = LN(src) . a + b (+ the APE row of the row's frame, t = (row / S) %
// T, where pe is given), rounded to bf16 before the APE is added and after,
// in bf16.  Lane l holds the pairs (64 j + 2 l, + 1), j < NP, those at or
// past C as zeros.  PAIRS: C and both strides even, every pair read and
// written as one (the loads issue back to back); else element by element
// (an odd C, at most 7: NP = 1).
// elements c, c + 1 of a row of n (as a pair where PAIRS: n even, the row
// 2-aligned), zeros past n; stored only below n
template <bool PAIRS, typename T>
__device__ __forceinline__ float2 row_get(const T* r, int c, int n) {
  if constexpr (PAIRS) return c < n ? load2(r + c) : make_float2(0.f, 0.f);
  else return get2(r, c, n, false);
}
template <bool PAIRS, typename T>
__device__ __forceinline__ void row_put(T* r, int c, int n, float u, float w) {
  if constexpr (PAIRS) {
    if (c < n) store2(r + c, u, w);
  } else {
    put2(r, c, n, false, u, w);
  }
}

template <typename T, int NP, bool LN, bool PAIRS>
__global__ void __launch_bounds__(kRowThreads)
    wide_rows(const T* __restrict__ src, T* __restrict__ dst, const float* __restrict__ a,
              const float* __restrict__ b, const T* __restrict__ pe, int M, int nT, int S, int C,
              int sld, int dld, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* x = src + (long long)row * sld;
  T* o = dst + (long long)row * dld;
  float2 v[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) v[j] = row_get<PAIRS>(x, 64 * j + 2 * lane, C);
  if constexpr (!LN) {
    const long long bt = row / S;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int c = 64 * j + 2 * lane;
      const float2 av = row_get<PAIRS>(a + bt * C, c, C), bv = row_get<PAIRS>(b + bt * C, c, C);
      row_put<PAIRS>(o, c, C, fmaf(v[j].x, av.x, bv.x), fmaf(v[j].y, av.y, bv.y));
    }
  } else {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      s1 += v[j].x + v[j].y;
      s2 = fmaf(v[j].x, v[j].x, fmaf(v[j].y, v[j].y, s2));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float inv_c = 1.f / C;
    const float mean = s1 * inv_c;
    const float inv = rsqrtf(fmaxf(s2 * inv_c - mean * mean, 0.f) + eps);
    const int t = (row / S) % nT;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const int c = 64 * j + 2 * lane;
      const float2 av = row_get<PAIRS>(a, c, C), bv = row_get<PAIRS>(b, c, C);
      float h0 = fmaf(v[j].x - mean, inv * av.x, bv.x);
      float h1 = fmaf(v[j].y - mean, inv * av.y, bv.y);
      if constexpr (sizeof(T) == 2) {
        h0 = bf16_round(h0);
        h1 = bf16_round(h1);
      }
      if (pe != nullptr) {
        const float2 p = row_get<PAIRS>(pe + (long long)t * C, c, C);
        h0 += p.x;
        h1 += p.y;
      }
      row_put<PAIRS>(o, c, C, h0, h1);
    }
  }
}

// The frame attention of one location (blockIdx.y = b, blockIdx.x = s) and
// head group (blockIdx.z: heads 8 z ...): thread (head, t) = (8 z +
// threadIdx.x / TP, threadIdx.x % TP) holds query frame t's scores over the
// key frames; q, k, v at columns 0, C, 2C of the (M, l3) qkv scratch, head
// h at h d; the out to dst (M, ldc).  VEC elements are read at a time (8, 4,
// 2 or 1: the most that divide d).  Key frames t >= T are masked (p = 0),
// query frames t >= T store nothing.  bf16: p = bf16(e / sum) as the bf16
// Kernel C rounds it, out rounded to bf16; fp32: the out scaled by 1 / sum
// after P.V (csrc/motion_module_f32.cu).
// (Four CTAs an SM at TP = 32: 64 registers a thread.  The loads of the key
// and value rows wait on L1, so the occupancy pays more than the few bytes
// it spills cost.)
template <typename T, int TP, int VEC>
__global__ void __launch_bounds__(TP * kHeadsPerCta, TP == 32 ? 4 : 1)
    wide_attention(const T* __restrict__ qkv, T* __restrict__ dst, int nT, int S, int C,
                   int heads, int l3, int ldc, float scale) {
  const int d = C / heads;
  const int hd = blockIdx.z * kHeadsPerCta + threadIdx.x / TP, t = threadIdx.x % TP;
  const int s = blockIdx.x, b = blockIdx.y;
  if (t >= nT || hd >= heads) return;
  // the head's columns of the location's frame 0; frame f is f * fs rows on
  const long long fs = (long long)S * l3;
  const T* base = qkv + ((long long)b * nT * S + s) * l3 + hd * d;
  const T* q = base + t * fs;
  float sc[TP];
#pragma unroll
  for (int f = 0; f < TP; ++f) sc[f] = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < d; c0 += VEC) {
    float qv[VEC];
    loadv<VEC>(q + c0, qv);
    const T* kp = base + C + c0;  // key frame f's columns, f * fs on
#pragma unroll
    for (int f = 0; f < TP; ++f, kp += fs) {
      if (f < nT) {
        float kv[VEC];
        loadv<VEC>(kp, kv);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dot = fmaf(qv[i], kv[i], dot);
        sc[f] += dot;
      }
    }
  }
  float mx = -INFINITY;
#pragma unroll
  for (int f = 0; f < TP; ++f) {
    sc[f] = f < nT ? sc[f] * scale : -INFINITY;
    mx = fmaxf(mx, sc[f]);
  }
  float sum = 0.f;
#pragma unroll
  for (int f = 0; f < TP; ++f) {
    sc[f] = f < nT ? (sizeof(T) == 2 ? __expf(sc[f] - mx) : expf(sc[f] - mx)) : 0.f;
    sum += sc[f];
  }
  const float inv = 1.f / sum;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int f = 0; f < TP; ++f) sc[f] = bf16_round(sc[f] * inv);
  }
  T* o = dst + (((long long)b * nT + t) * S + s) * ldc + hd * d;
  const float m = sizeof(T) == 2 ? 1.f : inv;
#pragma unroll 1
  for (int c0 = 0; c0 < d; c0 += VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    const T* vp = base + 2 * C + c0;
#pragma unroll
    for (int f = 0; f < TP; ++f, vp += fs) {
      if (f < nT) {
        float vv[VEC];
        loadv<VEC>(vp, vv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(sc[f], vv[i], acc[i]);
      }
    }
    if constexpr (VEC >= 2) {
#pragma unroll
      for (int i = 0; i < VEC; i += 2) store2(o + c0 + i, acc[i] * m, acc[i + 1] * m);
    } else {
      store1(o + c0, acc[0] * m);
    }
  }
}

struct Args {
  const void *x, *gna, *gnb, *pe, *w, *b_in, *ln_s, *ln_b, *bo, *b1, *b2, *b_out;
  void *out, *scratch;
  int B, T, S, C;
  float scale, ln_eps;
  int heads, n_attn, F;  // F: the hidden units, ff_mult C rounded up to 64
};

constexpr int round8(int n) { return (n + 7) / 8 * 8; }

template <typename T>
int set_smem() {
  const void* fns[3] = {reinterpret_cast<const void*>(wide_gemm<T, kBias>),
                        reinterpret_cast<const void*>(wide_gemm<T, kResidual>),
                        reinterpret_cast<const void*>(wide_gemm<T, kGeglu>)};
  for (const void* f : fns) {
    const cudaError_t e =
        cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<T>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// the (M, K) activation at `a`, rows `ld` elements apart (a multiple of 8),
// as the 3-D map (K, M, 1) whose box is one k panel of 128 rows (128-byte
// swizzle): a box at column kp KW is panel kp, columns past K and rows past
// M read as zeros
template <typename T>
bool panel_map(CUtensorMap* map, const void* a, int M, int K, int ld) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  constexpr int elem = sizeof(T);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M), 1};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ld) * elem,
                                 static_cast<cuuint64_t>(ld) * elem * M};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Op<T>::KW), static_cast<cuuint32_t>(BM), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return fn(map, Op<T>::kMap, 3, const_cast<void*>(a), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int EPI>
int gemm(const CUtensorMap& amap, const GemmArgs& g, cudaStream_t st) {
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM);
  wide_gemm<T, EPI><<<grid, kGemmThreads, Ring<T>::SMEM, st>>>(amap, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TP>
int attention_tp(const T* qkv, T* dst, const Args& a, int l3, int ldc, cudaStream_t st) {
  const dim3 grid(a.S, a.B, (a.heads + kHeadsPerCta - 1) / kHeadsPerCta);
  const int threads = TP * std::min(a.heads, kHeadsPerCta), d = a.C / a.heads;
  const auto go = [&](auto kern) {
    kern<<<grid, threads, 0, st>>>(qkv, dst, a.T, a.S, a.C, a.heads, l3, ldc, a.scale);
  };
  if (d % 8 == 0) go(wide_attention<T, TP, 8>);
  else if (d % 4 == 0) go(wide_attention<T, TP, 4>);
  else if (d % 2 == 0) go(wide_attention<T, TP, 2>);
  else go(wide_attention<T, TP, 1>);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int attention(const T* qkv, T* dst, const Args& a, int l3, int ldc, cudaStream_t st) {
  if (a.T <= 8) return attention_tp<T, 8>(qkv, dst, a, l3, ldc, st);
  if (a.T <= 16) return attention_tp<T, 16>(qkv, dst, a, l3, ldc, st);
  return attention_tp<T, 32>(qkv, dst, a, l3, ldc, st);
}

template <typename T, bool LN>
int rows(const T* src, T* dst, const float* sa, const float* sb, const T* pe, const Args& a,
         int M, int sld, int dld, float eps, cudaStream_t st) {
  const dim3 grid((M + kRowThreads / 32 - 1) / (kRowThreads / 32));
  const int np = (a.C + 63) / 64;
  const auto args = [&](auto kern) {
    kern<<<grid, kRowThreads, 0, st>>>(src, dst, sa, sb, pe, M, a.T, a.S, a.C, sld, dld, eps);
  };
  if ((a.C | sld | dld) & 1) {  // an odd C (the gate admits them at one head, C <= 7)
    if (np > 1) return static_cast<int>(cudaErrorInvalidValue);
    args(wide_rows<T, 1, LN, false>);
  } else if (np <= 1) args(wide_rows<T, 1, LN, true>);
  else if (np <= 2) args(wide_rows<T, 2, LN, true>);
  else if (np <= 4) args(wide_rows<T, 4, LN, true>);
  else if (np <= 8) args(wide_rows<T, 8, LN, true>);
  else if (np <= 12) args(wide_rows<T, 12, LN, true>);  // C = 768
  else if (np <= 16) args(wide_rows<T, 16, LN, true>);
  else args(wide_rows<T, 32, LN, true>);
  return static_cast<int>(cudaGetLastError());
}

// bytes of one product's tiles: K x N weights, zero-padded to whole panels
// and 128-column blocks
template <typename T>
constexpr long long tile_bytes(long long k, long long n) {
  return (n + BN - 1) / BN * ((k + Op<T>::KW - 1) / Op<T>::KW) * Op<T>::B_BYTES;
}

template <typename T>
int run(const Args& a, cudaStream_t st) {
  const int M = a.B * a.T * a.S, C = a.C, F = a.F;
  if (M == 0) return 0;
  int e = set_smem<T>();  // a runtime call before the maps: it makes the context current
  if (e) return e;
  const int ldc = round8(C), l3 = round8(3 * C);
  T* y = static_cast<T*>(a.scratch);
  T* h = y + (long long)M * ldc;
  T* big = h + (long long)M * ldc;  // q | k | v (M x l3), then the FF activation (M x F)
  CUtensorMap mh, my, mact;
  if (!panel_map<T>(&mh, h, M, C, ldc) || !panel_map<T>(&my, y, M, C, ldc) ||
      !panel_map<T>(&mact, big, M, F, F))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned char* w = static_cast<const unsigned char*>(a.w);
  const float* ln_s = static_cast<const float*>(a.ln_s);
  const float* ln_b = static_cast<const float*>(a.ln_b);
  const float* bo = static_cast<const float*>(a.bo);
  const T* pe = static_cast<const T*>(a.pe);
#define VDA_WIDE_CHECK(call) \
  if ((e = (call)) != 0) return e;
  VDA_WIDE_CHECK((rows<T, false>(static_cast<const T*>(a.x), h, static_cast<const float*>(a.gna),
                                 static_cast<const float*>(a.gnb), nullptr, a, M, C, ldc, 0.f, st)));
  VDA_WIDE_CHECK((gemm<T, kBias>(mh, GemmArgs{w, static_cast<const float*>(a.b_in), nullptr, y, M, C, C, ldc}, st)));
  w += tile_bytes<T>(C, C);
  for (int i = 0; i < a.n_attn; ++i) {
    VDA_WIDE_CHECK((rows<T, true>(y, h, ln_s + i * C, ln_b + i * C, pe, a, M, ldc, ldc, a.ln_eps, st)));
    VDA_WIDE_CHECK((gemm<T, kBias>(mh, GemmArgs{w, nullptr, nullptr, big, M, C, 3 * C, l3}, st)));
    w += tile_bytes<T>(C, 3 * C);
    VDA_WIDE_CHECK((attention<T>(big, h, a, l3, ldc, st)));
    VDA_WIDE_CHECK((gemm<T, kResidual>(mh, GemmArgs{w, bo + i * C, y, y, M, C, C, ldc}, st)));
    w += tile_bytes<T>(C, C);
  }
  VDA_WIDE_CHECK((rows<T, true>(y, h, ln_s + a.n_attn * C, ln_b + a.n_attn * C, nullptr, a, M, ldc,
                                ldc, a.ln_eps, st)));
  VDA_WIDE_CHECK((gemm<T, kGeglu>(mh, GemmArgs{w, static_cast<const float*>(a.b1), nullptr, big, M, C, 2 * F, F}, st)));
  w += tile_bytes<T>(C, 2 * F);
  VDA_WIDE_CHECK((gemm<T, kResidual>(mact, GemmArgs{w, static_cast<const float*>(a.b2), y, y, M, F, C, ldc}, st)));
  w += tile_bytes<T>(F, C);
  VDA_WIDE_CHECK((gemm<T, kResidual>(my, GemmArgs{w, static_cast<const float*>(a.b_out), a.x, a.out, M, C, C, C}, st)));
#undef VDA_WIDE_CHECK
  return 0;
}

template <typename T>
int dispatch(const Args& a, cudaStream_t st) {
  if (a.T < 8 || a.T > 32 || a.C < 1 || a.heads < 1 || a.C % a.heads || a.n_attn < 1 ||
      a.F < 64 || a.F % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  return run<T>(a, st);
}

}  // namespace

// x, out (B, T, S, C) contiguous, bf16 (vda_motion_module_wide) or fp32
// (_f32); gna/gnb (B, T, C) fp32; pe (T', C) in x's dtype, T' >= T; w the
// weight tiles (ops/motion_module.weight_blocks_wide for this module and
// dtype); b_in, b2, b_out (C,), ln_s/ln_b (n_attn + 1, C), bo (n_attn, C)
// fp32, b1 (2 F,) fp32: the h biases then the gate biases, zero past ff_mult
// C; scratch M (2 ldc + max(l3, F)) elements of x's dtype (M = B T S, ldc
// and l3 C and 3 C rounded up to multiples of 8).  8 <= T <= 32; heads
// divide C; F a multiple of 64.
#define VDA_WIDE_ARGS                                                                        \
  const void *x, const void *gna, const void *gnb, const void *pe, const void *w,            \
      const void *b_in, const void *ln_s, const void *ln_b, const void *bo, const void *b1,  \
      const void *b2, const void *b_out, void *out, int B, int T, int S, int C, float scale, \
      float ln_eps, void *stream, void *scratch, int heads, int n_attn, int F
#define VDA_WIDE_STRUCT                                                                      \
  Args{x, gna, gnb, pe, w, b_in, ln_s, ln_b, bo, b1, b2, b_out, out, scratch, B, T, S, C, scale, \
       ln_eps, heads, n_attn, F}

extern "C" int vda_motion_module_wide(VDA_WIDE_ARGS) {
  return dispatch<bf16>(VDA_WIDE_STRUCT, static_cast<cudaStream_t>(stream));
}

extern "C" int vda_motion_module_wide_f32(VDA_WIDE_ARGS) {
  return dispatch<float>(VDA_WIDE_STRUCT, static_cast<cudaStream_t>(stream));
}
